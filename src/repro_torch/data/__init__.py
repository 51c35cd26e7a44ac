from .pipeline import (RequestStream, ServeRequest, ShardedTokenPipeline,
                       spare_batch, spare_batch_rows)

__all__ = ["ShardedTokenPipeline", "spare_batch", "spare_batch_rows",
           "ServeRequest", "RequestStream"]
