"""repro_torch.exec — the SPARe protocol on a ``(data, model)`` grid of
ranks: the :class:`MeshExecutor` runs the train step on every rank of a
``torch.distributed`` group with the §3.1 weighted sync on the wire (its
parameters replicated, or column-sharded on the model axis by
:func:`executor_param_specs`), and applies failure masking as pure
weight-table updates."""
from .equivalence import int8_sweep_tolerance, tree_max_rel_err
from .executor import MeshExecutor, executor_param_specs

__all__ = ["MeshExecutor", "executor_param_specs", "int8_sweep_tolerance",
           "tree_max_rel_err"]
