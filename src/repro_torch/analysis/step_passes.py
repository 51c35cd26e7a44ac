"""Step passes over recorded steps (the counterpart of
``repro.analysis.hlo_passes``, rule for rule).

The JAX package reads its invariants off compiled HLO; the port runs a
step once under :func:`repro_torch.launch.steplog.record_step` and reads
them off its :class:`~repro_torch.launch.steplog.StepLog`
(:meth:`~repro_torch.train.trainer.SpareTrainer.step_log`,
:meth:`~repro_torch.serve.engine.ServeEngine.programs`):

``collective-schedule-determinism``
    Executor form (:func:`schedule_determinism_executor`): for every
    RECTLR-recoverable survivor set, the step's log on this rank equals
    the healthy step's at the same ``S_A`` (the schedules only, so
    recorded with ``watch=False``) — the lint runs it on every
    rank of the grid, since a schedule that differs on one rank hangs a
    real run. Cell form (:func:`schedule_determinism_cell`): two
    recordings of one state give one log and one loss, and the weight
    table reaches the step: another weight table at the same ``S_A``
    changes the loss and leaves the log as it was (the JAX package's
    "live entry parameter" check).

``donation-audit``
    Every parameter, moment and EF leaf the step takes is updated in
    place: the leaf it returns has the storage of the one it took, and no
    copy of it made in the step is alive after it (the torch form of
    "donated but not aliased").

``hot-path-purity``
    No host read, copy to the host, sync the card's debug mode sees,
    fp64 tensor of the step's data or draw on the default generator
    inside the step callable.

``wire-dtype-policy``
    No ``all_reduce`` or ``reduce_scatter`` over an integer type of 16
    bits or fewer, or over bool: the compressed sync's int8 payloads move
    by all-to-all and all-gather and accumulate in fp32. EF residual
    state stays fp32 (:func:`ef_state_policy`).
"""
from __future__ import annotations

import torch

from repro_torch.analysis.core import Violation
from repro_torch.core import SpareState
from repro_torch.exec.equivalence import recoverable_failure_sets

__all__ = ["STEP_PASSES", "donation_audit", "hot_path_purity",
           "schedule_determinism_cell", "schedule_determinism_executor",
           "wire_dtype_policy", "ef_state_policy"]

_REDUCING = ("all_reduce", "reduce_scatter", "reduce_scatter_tensor")
_NARROW = ("int8", "uint8", "int16", "uint16", "bool")


# ------------------------------------------------------------------ #
# donation audit                                                     #
# ------------------------------------------------------------------ #
def donation_audit(log, tag: str) -> list[Violation]:
    """The leaves ``log`` took to update in place must come back with
    their own storage, and no copy of one may outlive the step."""
    before, after = log.storage_before, log.storage_after
    if len(before) != len(after):
        return [Violation(tag, 0, "donation-audit",
                          f"the step took {len(before)} state leaves and "
                          f"returned {len(after)}")]
    names = log.leaf_names or tuple(f"leaf[{i}]" for i in range(len(before)))
    rebound = [names[i] for i, (a, b) in enumerate(zip(before, after))
               if a != b]
    found = []
    if rebound:
        shown = ", ".join(rebound[:6]) + ("..." if len(rebound) > 6 else "")
        found.append(Violation(
            tag, 0, "donation-audit",
            f"{len(rebound)} of {len(before)} state leaves come back in new "
            f"storage instead of being updated in place — each costs a "
            f"second copy ({shown})"))
    for op in sorted(set(log.copies_alive)):
        found.append(Violation(
            tag, 0, "donation-audit",
            f"a copy of a state leaf ({op}, "
            f"{log.copies_alive.count(op)}x) is alive after the step"))
    return found


# ------------------------------------------------------------------ #
# hot-path purity                                                    #
# ------------------------------------------------------------------ #
def hot_path_purity(log, tag: str) -> list[Violation]:
    found = []
    kinds = (("host_reads", "host read"), ("syncs", "host sync"),
             ("wide", "fp64/c128 output"),
             ("rng_draws", "draw on the default generator"))
    for name, what in kinds:
        seen = getattr(log, name)
        for item in sorted(set(seen)):
            found.append(Violation(
                tag, 0, "hot-path-purity",
                f"{what} {item} ({seen.count(item)}x) inside the step"))
    return found


# ------------------------------------------------------------------ #
# wire dtype policy                                                  #
# ------------------------------------------------------------------ #
def wire_dtype_policy(log, tag: str) -> list[Violation]:
    moved: dict[tuple[str, str], int] = {}
    for c in log.collectives:
        if c.op in _REDUCING and c.dtype in _NARROW:
            moved[(c.op, c.dtype)] = moved.get((c.op, c.dtype), 0) + c.moved
    return [Violation(
        tag, 0, "wire-dtype-policy",
        f"{op} over {dt} payload ({b} B) — compressed payloads must move "
        "via all-to-all/all-gather and accumulate in fp32 (overflow at "
        "high DP degree)") for (op, dt), b in sorted(moved.items())]


def ef_state_policy(executor, tag: str) -> list[Violation]:
    """EF residuals must stay fp32 — quantizing the *residual* compounds
    the quantization error instead of feeding it back."""
    state = getattr(executor, "_ef_state", None)
    if state is None:
        return []
    bad = sorted({str(t.dtype).removeprefix("torch.")
                  for fam in sorted(state) for t in state[fam]
                  if t.dtype != torch.float32})
    if bad:
        return [Violation(tag, 0, "wire-dtype-policy",
                          f"EF residual leaves carry dtypes {bad} — "
                          "residual state must stay fp32")]
    return []


# ------------------------------------------------------------------ #
# collective-schedule determinism                                    #
# ------------------------------------------------------------------ #
def schedule_determinism_executor(executor, tag: str,
                                  max_failures: int | None = None
                                  ) -> tuple[list[Violation], int]:
    """Certify masking-is-data over the FULL recoverable survivor space
    on this rank: for every failure set RECTLR can mask, the step's log
    under the recovered schedule must carry the collective schedule of
    the healthy step at the same ``S_A``. Returns (violations,
    n_certified)."""
    n, r = executor.state.n, executor.state.r
    healthy_sched: dict[int, tuple] = {}

    def healthy(s_a: int) -> tuple:
        if s_a not in healthy_sched:
            st = SpareState(n, r)
            st.s_a = s_a
            healthy_sched[s_a] = executor.step_log(
                st, watch=False).schedule()
        return healthy_sched[s_a]

    found: list[Violation] = []
    certified = 0
    for victims, state in recoverable_failure_sets(n, r, max_failures):
        got = executor.step_log(state, watch=False).schedule()
        want = healthy(state.s_a)
        certified += 1
        if got != want:
            found.append(Violation(
                tag, 0, "collective-schedule-determinism",
                f"survivor set (victims={list(victims)}, S_A={state.s_a}) "
                f"runs a different collective schedule than the healthy "
                f"step: {_first_difference(got, want)}"))
    return found, certified


def schedule_determinism_cell(executor, tag: str) -> list[Violation]:
    """Cell-level certification on this rank: two recordings of the
    healthy step give one log and the same loss, bit for bit, and the
    weight table is live: the first recoverable survivor set's schedule,
    run at the healthy table's ``S_A``, keeps the log and changes the
    loss (the loss is read after each recorded step, outside it)."""
    n, r = executor.state.n, executor.state.r
    victims, masked = next(recoverable_failure_sets(n, r))
    healthy = SpareState(n, r)
    healthy.s_a = masked.s_a
    a, b, c = (executor.step_log(st, watch=False)
               for st in (healthy, healthy, masked))
    found = []
    if a.schedule() != b.schedule() or a.loss != b.loss:
        found.append(Violation(
            tag, 0, "collective-schedule-determinism",
            "two recordings of one state disagree: "
            f"{_first_difference(a.schedule(), b.schedule())}, loss "
            f"{a.loss} vs {b.loss}"))
    if c.schedule() != a.schedule():
        found.append(Violation(
            tag, 0, "collective-schedule-determinism",
            f"another weight table (victims={list(victims)}) changes the "
            f"log: {_first_difference(c.schedule(), a.schedule())}"))
    if c.loss == a.loss:
        found.append(Violation(
            tag, 0, "collective-schedule-determinism",
            f"the SPARe weight table does not reach the step: masking "
            f"{list(victims)} left the loss at {a.loss}"))
    return found


def _first_difference(got: tuple, want: tuple) -> str:
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            return f"collective {i}: {g} != {w}"
    return f"{len(got)} collectives != {len(want)}"


STEP_PASSES = ("collective-schedule-determinism", "donation-audit",
               "hot-path-purity", "wire-dtype-policy")
