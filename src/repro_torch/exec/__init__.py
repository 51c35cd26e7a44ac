"""repro_torch.exec — the SPARe protocol on a ``(data, model)`` grid of
ranks: the :class:`MeshExecutor` runs the train step on every rank of a
``torch.distributed`` group with the §3.1 weighted sync on the wire (its
parameters replicated, or column-sharded on the model axis by
:func:`executor_param_specs`), and applies failure masking as pure
weight-table updates."""
from .equivalence import (SurvivorCheck, int8_sweep_tolerance,
                          recoverable_failure_sets, survivor_set_sweep,
                          tree_max_rel_err)
from .executor import MeshExecutor, executor_param_specs

__all__ = ["MeshExecutor", "executor_param_specs", "SurvivorCheck",
           "int8_sweep_tolerance", "recoverable_failure_sets",
           "survivor_set_sweep", "tree_max_rel_err"]
