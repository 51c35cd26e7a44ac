"""§3.1 gradient-equivalence helpers (the counterparts of the JAX
package's ``int8_sweep_tolerance`` and ``tree_max_rel_err`` in
``repro.exec.equivalence``; the survivor-set sweep waits)."""
from __future__ import annotations

import torch

from repro_torch.dist.collectives import tree_leaves

__all__ = ["int8_sweep_tolerance", "tree_max_rel_err"]


def int8_sweep_tolerance(dp_degree: int, kappa: float = 4.0) -> float:
    """Quantization-tolerance oracle for the §3.1 check under
    ``grad_compress="int8_ef"``.

    With zero EF residuals (the stateless ``sync_once``), one compressed
    step's elementwise error is bounded by the sum of the quantization
    steps: ``dp`` stage-1 scales (each ``<= kappa * max|g_total| / 127``,
    where ``kappa`` bounds the local-partial to total absmax ratio) plus
    one stage-2 scale, each contributing at most half a step. Relative to
    ``max|g_total|`` that is ``kappa * (dp + 1) / 254``.
    """
    return kappa * (dp_degree + 1) / 254.0


def tree_max_rel_err(got, ref) -> float:
    """``max |got - ref| / max(max |ref|, 1)`` over all leaves, fp32."""
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(tree_leaves(got), tree_leaves(ref)))
    scale = max(float(b.float().abs().max()) for b in tree_leaves(ref))
    return diff / max(scale, 1.0)
