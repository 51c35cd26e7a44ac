"""Distributed-communication substrate of the port: the §3.1 weighted
all-reduce, int8 error-feedback compression and the bucketed gradient
syncs over a ``torch.distributed`` group (see
:mod:`repro_torch.dist.collectives`), and the production sharding rule
table (:mod:`repro_torch.dist.sharding`)."""
from .collectives import (
    BucketedAllGather,
    BucketedAllReduce,
    BucketLayout,
    CompressedBucketSync,
    bucket_layout,
    collective,
    compress_grad_int8,
    decompress_grad_int8,
    flatten_grads,
    tree_leaves,
    unflatten_grads,
    weighted_all_reduce,
)

__all__ = [
    "BucketedAllGather",
    "BucketedAllReduce",
    "BucketLayout",
    "CompressedBucketSync",
    "bucket_layout",
    "collective",
    "compress_grad_int8",
    "decompress_grad_int8",
    "flatten_grads",
    "tree_leaves",
    "unflatten_grads",
    "weighted_all_reduce",
]
