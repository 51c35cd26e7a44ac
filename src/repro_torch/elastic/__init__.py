"""repro_torch.elastic — the elastic recovery tier between SPARe masking
and the wipe-out restart (the PyTorch counterpart of ``repro.elastic``).

Degraded-continue: shrink the data-parallel degree onto the surviving
ranks and keep training. See :mod:`repro_torch.elastic.executor` for the
mechanics, :mod:`repro_torch.elastic.reshard` for the state movement and
:mod:`repro_torch.elastic.policy` for the closed-form TTT decision (a
copy of the JAX package's jax-free module, which the adaptive scheme
consults).
"""
from repro_torch.elastic.executor import ElasticMeshExecutor
from repro_torch.elastic.policy import ttt_estimates
from repro_torch.elastic.reshard import (remap_ef_rows, reshard_tree,
                                         shrink_degree, survivor_group)

__all__ = ["ElasticMeshExecutor", "ttt_estimates", "shrink_degree",
           "survivor_group", "reshard_tree", "remap_ef_rows"]
