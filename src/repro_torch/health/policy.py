"""Closed-form throughput policy for degraded (fail-slow) groups.

Every gradient sync is a barrier, so a synchronous step takes

    step_time = sps * max(factor[g]  for g alive and in the barrier)

where ``factor[g]`` is group ``g``'s current slowdown (1.0 = healthy).
When the detector flags a straggler set ``candidates``, the run has
four ways to finish the remaining ``R`` steps:

* **tolerate** — keep everyone in the barrier and run at the
  straggler's pace::

      TTT_tolerate = R * sps * max_factor

* **demote** — SPARe-mask the candidates out of the weighted sync (a
  pure weight-table edit: zero recompiles once both stacking depths
  are warm, instantly reversible when the episode heals). Survivors
  cover the demoted types through redundant stacking, so per-step
  *work* is unchanged — the §3.1 invariant holds — and pace returns to
  the healthiest survivor's::

      TTT_demote = t_demote + R * sps * max_surviving_factor

  feasible only while RECTLR can re-cover the demoted set
  (``maskable``);

* **reshape** — shrink DP onto a survivor submesh excluding the
  stragglers, at full pace but ``dp_full / dp_new`` more steps for the
  same work (see :func:`repro.elastic.policy.ttt_estimates`);

* **restart** — swap the degraded hardware during a full restart
  outage and re-run from the last snapshot at full health.

Ties break toward the least disruptive action, in the order
tolerate > demote > reshape > restart (demote keeps all state warm;
reshape loses capacity; restart loses optimizer steps).
"""
from __future__ import annotations

import numpy as np

__all__ = ["degraded_ttt_estimates"]

#: tie-break preference, least disruptive first
_ACTION_ORDER = ("tolerate", "demote", "reshape", "restart")


def degraded_ttt_estimates(*, factors, candidates, remaining_steps: int,
                           seconds_per_step: float, dp_full: int,
                           dp_new: int = 0, maskable: bool = True,
                           alive=None, demoted=(), rollback_steps: int = 0,
                           t_restart: float, t_reshape: float,
                           t_demote: float = 0.0) -> dict:
    """All four candidates' time-to-train and the argmin ``action``.

    ``factors`` is the per-group slowdown vector (detector estimates or
    injector model); ``candidates`` the straggler set under decision;
    ``demoted`` the groups already masked out of the barrier;
    ``dp_new`` the degree an elastic reshape excluding the candidates
    would continue at (0 = reshape unavailable). ``maskable=False``
    (RECTLR cannot re-cover the candidate set) makes demote
    infeasible.
    """
    f = np.asarray(factors, dtype=np.float64)
    n = f.shape[0]
    live = (np.ones(n, dtype=bool) if alive is None
            else np.asarray(alive, dtype=bool))
    in_barrier = live.copy()
    for g in demoted:
        in_barrier[int(g)] = False
    cand = sorted(int(g) for g in candidates)

    def _pace(mask: np.ndarray) -> float:
        return float(f[mask].max()) if mask.any() else float("inf")

    sps = float(seconds_per_step)
    work = float(remaining_steps) * sps
    max_factor = _pace(in_barrier)
    after = in_barrier.copy()
    for g in cand:
        after[g] = False
    surviving_factor = _pace(after)

    tolerate_ttt = work * max_factor
    demote_ttt = (float(t_demote) + work * surviving_factor
                  if (maskable and cand and after.any()) else float("inf"))
    reshape_ttt = (float(t_reshape) + work * (float(dp_full) / dp_new)
                   if dp_new > 0 else float("inf"))
    restart_ttt = float(t_restart) + \
        (float(rollback_steps) + float(remaining_steps)) * sps

    ttts = {"tolerate": tolerate_ttt, "demote": demote_ttt,
            "reshape": reshape_ttt, "restart": restart_ttt}
    action = min(_ACTION_ORDER, key=lambda a: (ttts[a], _ACTION_ORDER.index(a)))
    return {
        "action": action,
        "tolerate_ttt": tolerate_ttt,
        "demote_ttt": demote_ttt,
        "reshape_ttt": reshape_ttt,
        "restart_ttt": restart_ttt,
        "max_factor": max_factor,
        "surviving_factor": surviving_factor,
        "candidates": cand,
        "maskable": bool(maskable),
        "dp_full": int(dp_full),
        "dp_new": int(dp_new),
        "remaining_steps": int(remaining_steps),
        "rollback_steps": int(rollback_steps),
        "seconds_per_step": sps,
        "t_restart": float(t_restart),
        "t_reshape": float(t_reshape),
        "t_demote": float(t_demote),
    }
