"""Fault-tolerant serving tier: paged KV cache, continuous batching,
SPARe-masked replicas (PyTorch port of ``repro.serve``)."""
from .engine import ExecutableCache, FinishedRequest, ServeEngine
from .kvcache import (BlockAllocator, make_cache_writer, pages_needed,
                      pool_pages_for)
from .replicas import ReplicaEvent, ReplicaServer

__all__ = ["BlockAllocator", "pages_needed", "pool_pages_for",
           "make_cache_writer", "ExecutableCache", "FinishedRequest",
           "ServeEngine", "ReplicaEvent", "ReplicaServer"]
