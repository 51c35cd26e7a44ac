"""§3.1 gradient-equivalence verification: mesh vs host, every survivor
set (the counterpart of ``repro.exec.equivalence``).

The paper's core invariant says the supplier-weighted all-reduce collects
vanilla DP's exact batch gradient for *every* survivor set the recovery
controller can mask. :func:`survivor_set_sweep` checks it on the ranks:
for each recoverable failure set (:func:`recoverable_failure_sets`) it
re-plans the schedule with RECTLR, and compares the
:class:`~repro_torch.exec.MeshExecutor`'s gradient (``mesh_grads``,
computed by the ranks and synced over the wire) against the host-side
oracles of a reference :class:`~repro_torch.train.trainer.SpareTrainer`
built from the same seed (identical params, identical deterministic
batches). The schedule half of the certification (every such set runs
the healthy step's collectives) is
:func:`repro_torch.analysis.schedule_determinism_executor`.
"""
from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations

from repro_torch.core import Rectlr, SpareState
from repro_torch.dist.collectives import tree_leaves

__all__ = ["SurvivorCheck", "recoverable_failure_sets",
           "tree_max_rel_err", "survivor_set_sweep",
           "int8_sweep_tolerance"]


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


@dataclass
class SurvivorCheck:
    """One survivor set's verdict."""

    victims: tuple[int, ...]
    s_a: int
    mesh_vs_host: float       # max rel err, mesh grads vs host SPARe grads
    mesh_vs_vanilla: float    # max rel err, mesh grads vs vanilla-DP oracle

    def ok(self, tol: float) -> bool:
        return self.mesh_vs_host <= tol and self.mesh_vs_vanilla <= tol


def recoverable_failure_sets(n: int, r: int, max_failures: int | None = None):
    """Every failure set RECTLR can mask (wipe-outs excluded), as the
    state it recovers into. Yields ``(victims, recovered_state)``.

    The full enumeration is ``sum_k C(n, k)`` — fine for the test-scale
    grids (n <= 8); cap with ``max_failures`` for larger sweeps.
    """
    cap = n - 1 if max_failures is None else min(max_failures, n - 1)
    for k in range(1, cap + 1):
        for victims in combinations(range(n), k):
            state = SpareState(n, r)
            outcome = Rectlr().on_failures(state, list(victims))
            if outcome.wipeout:
                continue
            state.assert_invariants()
            yield victims, state


def tree_max_rel_err(got, ref) -> float:
    """``max |got - ref| / max(max |ref|, 1)`` over all leaves, fp32."""
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(tree_leaves(got), tree_leaves(ref)))
    scale = max(float(b.float().abs().max()) for b in tree_leaves(ref))
    return diff / max(scale, 1.0)


def survivor_set_sweep(executor, reference, *, step: int = 0,
                       max_failures: int | None = None
                       ) -> list[SurvivorCheck]:
    """Run the full survivor-set enumeration through the ranks.

    ``executor`` is a :class:`repro_torch.exec.MeshExecutor`;
    ``reference`` a :class:`~repro_torch.train.trainer.SpareTrainer`
    constructed with the same config and seed (so both hold
    bit-identical parameters). For every recoverable failure set the
    mesh gradient is checked against both the host-side SPARe gradient
    under the same schedule and the vanilla-DP oracle. Neither the
    executor's nor the reference's schedule changes.
    """
    n, r = executor.state.n, executor.state.r
    vanilla = _kept(reference.vanilla_reference_grads(step))
    checks = []
    for victims, state in recoverable_failure_sets(n, r, max_failures):
        mesh = _kept(executor.mesh_grads(step, state=state))
        saved = reference.state
        reference.state = state
        try:
            host = _kept(reference.spare_grads(step))
        finally:
            reference.state = saved
        checks.append(SurvivorCheck(
            victims=victims, s_a=state.s_a,
            mesh_vs_host=tree_max_rel_err(mesh, host),
            mesh_vs_vanilla=tree_max_rel_err(mesh, vanilla)))
    return checks


def _kept(tree) -> list:
    """The leaves of ``tree`` as fp32 copies on their device, safe from
    whatever the next call writes into its buffers."""
    return [t.detach().float().clone() for t in tree_leaves(tree)]
