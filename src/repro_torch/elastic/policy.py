"""Closed-form TTT policy for unmaskable failure sets.

When RECTLR reports a wipe-out — some shard type lost every surviving
host — the run has two ways to reach the end of training:

* **restart**: pay the cluster restart outage ``t_restart``, roll back
  ``rollback_steps`` to the last snapshot, and re-run them plus the
  remaining steps at full DP speed;
* **reshape**: pay the online resharding outage ``t_reshape`` and finish
  the remaining steps degraded on a survivor submesh at DP degree
  ``dp_new`` < ``dp_full``.

Per-device load is constant across mesh shapes (each group computes the
same per-type microbatch), so a degraded step takes the same wall time
but covers only ``dp_new / dp_full`` of a full step's examples. Equal
*work* therefore costs ``dp_full / dp_new`` more degraded steps — the
paper's time-to-train trade-off reduced to one comparison:

    TTT_reshape = t_reshape + R * sps * (dp_full / dp_new)
    TTT_restart = t_restart + (rollback + R) * sps

with ``R`` remaining steps and ``sps`` seconds per (full) step. The
adaptive scheme (:meth:`repro.des.schemes.AdaptiveScheme
.decide_unmaskable`) and :class:`repro.elastic.ElasticMeshExecutor`'s
built-in fallback both evaluate exactly this estimate per event.
"""
from __future__ import annotations

__all__ = ["ttt_estimates"]


def ttt_estimates(*, dp_full: int, dp_new: int, remaining_steps: int,
                  seconds_per_step: float, rollback_steps: int = 0,
                  t_restart: float, t_reshape: float) -> dict:
    """Both candidates' time-to-train and the argmin ``action``.

    ``dp_full`` is the degree a restart comes back at (the full mesh);
    ``dp_new`` the degree the reshape would continue at (0 = cannot
    continue, forces restart). Ties go to reshape — it keeps the warm
    executable cache and loses no optimizer steps.
    """
    sps = float(seconds_per_step)
    work = float(remaining_steps) * sps
    reshape_ttt = (float(t_reshape) + work * (float(dp_full) / dp_new)
                   if dp_new > 0 else float("inf"))
    restart_ttt = float(t_restart) + \
        (float(rollback_steps) + float(remaining_steps)) * sps
    return {
        "action": "reshape" if reshape_ttt <= restart_ttt else "restart",
        "reshape_ttt": reshape_ttt,
        "restart_ttt": restart_ttt,
        "dp_full": int(dp_full),
        "dp_new": int(dp_new),
        "remaining_steps": int(remaining_steps),
        "rollback_steps": int(rollback_steps),
        "seconds_per_step": sps,
        "t_restart": float(t_restart),
        "t_reshape": float(t_reshape),
    }
