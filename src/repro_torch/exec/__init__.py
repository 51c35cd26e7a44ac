"""repro_torch.exec — the SPARe protocol on data-parallel ranks: the
:class:`MeshExecutor` runs the train step on every rank of a
``torch.distributed`` group with the §3.1 weighted sync on the wire, and
applies failure masking as pure weight-table updates."""
from .equivalence import int8_sweep_tolerance, tree_max_rel_err
from .executor import MeshExecutor

__all__ = ["MeshExecutor", "int8_sweep_tolerance", "tree_max_rel_err"]
