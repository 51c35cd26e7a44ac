"""DES system parameters (paper Table 1 — 600k H100 cluster)."""
from __future__ import annotations

from dataclasses import dataclass, replace

__all__ = ["DESParams"]

# Paper Table 1: T_a = 2, 6, 10 s at N = 200, 600, 1000 (ring all-reduce,
# linear in N for the 20 TB gradient at ~400 Gb/s per-GPU goodput).
_ALLREDUCE_BY_N = {200: 2.0, 600: 6.0, 1000: 10.0}


@dataclass(frozen=True)
class DESParams:
    """Table 1 defaults. All times in seconds."""

    n: int = 600                    # data-parallel degree (DP groups)
    mtbf: float = 300.0             # system MTBF on node failures
    weibull_shape: float = 0.78     # Schroeder & Gibson seminal shape k
    t_restart: float = 3600.0       # T_r — global restart latency
    t_comp: float = 64.0            # compute time per stack (256M tok, 4 acc)
    t_save: float = 60.0            # T_s — checkpoint save
    t_shrink: float = 0.1           # communicator shrink
    t_controller: float = 0.1       # RECTLR cost (conservative; measured <10ms)
    t_reconfig: float = 1.0         # adaptive policy-switch reshard cost
    steps: int = 10_000             # training horizon
    failed_allreduce_frac: float = 0.5   # failed all-reduce costs 0.5 * T_a
    jitter_std: float = 0.05        # event jitter ~ N(1, 0.05^2)
    scale_rate_with_survivors: bool = True  # failure rate ∝ #active GPUs
    failure_law: str = "weibull"    # "weibull" | "exponential"

    @property
    def t_allreduce(self) -> float:
        """T_a — gradient all-reduce time at this N (ring, linear in N)."""
        if self.n in _ALLREDUCE_BY_N:
            return _ALLREDUCE_BY_N[self.n]
        return 10.0 * self.n / 1000.0  # linear extrapolation of Table 1

    @property
    def t0(self) -> float:
        """No-failure baseline time-to-train: steps x (T_comp + T_a)."""
        return self.steps * (self.t_comp + self.t_allreduce)

    def with_(self, **kw) -> "DESParams":
        return replace(self, **kw)
