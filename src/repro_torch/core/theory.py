"""Closed-form SPARe theory (paper Sec. 4, Thms 4.1-4.3, Eqs. 1-2, 7-8).

Everything here is a pure function of ``(N, r)`` and the system timing
parameters — no simulation. The Monte-Carlo module and the DES validate
these formulas (paper App. C reports <= 1.13 % MAPE on ``mu`` and 0.60 %
on the average all-reduce stack; our tests reproduce those bands).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = [
    "mu",
    "mu_poisson_sum",
    "capacity",
    "patch_probability",
    "s_bar",
    "s_bar_lower",
    "tc_star",
    "availability_star",
    "SystemTimes",
    "j_normalized",
    "r_star",
    "replication_mu",
]


# --------------------------------------------------------------------- #
# Thm. 4.1 — endurable failure count                                    #
# --------------------------------------------------------------------- #
def mu(n: int, r: int) -> float:
    """Average failure count before first wipe-out (Eq. 3):
    ``mu(N, r) ~= Gamma(1/r)/r * N^(1 - 1/r)``."""
    if r < 1:
        raise ValueError("r >= 1 required")
    if r == 1:
        return 1.0  # a single failure wipes its only host
    return math.gamma(1.0 / r) / r * n ** (1.0 - 1.0 / r)


def mu_poisson_sum(n: int, r: int) -> float:
    """The pre-asymptotic Poisson sum (Eq. 4 middle form):
    ``sum_k exp(-N (k/N)^r)`` — tighter at small N, used by tests to bound
    the Gamma closed form."""
    return sum(math.exp(-n * (k / n) ** r) for k in range(n))


def replication_mu(n: int, r: int) -> float:
    """Endurable failures of *traditional replication* with the same layout
    statistics (Ferreira et al. 2011): identical asymptotics to Eq. 3 —
    SPARe matches replication's availability (paper Sec. 4.1)."""
    return mu(n, r)


# --------------------------------------------------------------------- #
# Thm. 4.2 — computation overhead                                        #
# --------------------------------------------------------------------- #
def capacity(k: int, n: int) -> int:
    """Capacity lower bound ``c(k) = ceil(N / (N - k))`` of the all-reduce
    stack at ``k`` failures."""
    if k >= n:
        raise ValueError("k < N required")
    return -(-n // (n - k))  # ceil division


def patch_probability(k: int, n: int) -> float:
    """``rho_k = max(0, 2N - n_k) / n_k`` with ``n_k = c(k)(N-k)``:
    first-order probability that a failure at count ``k`` hits a singleton
    type and forces a patch compute."""
    n_k = capacity(k, n) * (n - k)
    return max(0, 2 * n - n_k) / n_k


def s_bar(n: int, r: int) -> float:
    """Average computation overhead before first wipe-out (Eq. 5):
    ``(1/floor(mu)) * sum_{k<floor(mu)} (c(k) + rho_k)``."""
    m = int(mu(n, r))
    m = max(m, 1)
    return sum(capacity(k, n) + patch_probability(k, n) for k in range(m)) / m


def s_bar_lower(n: int, r: int) -> float:
    """Idealistic lower bound (Eq. 6) — no patch computes (early failure
    detection): ``(1/floor(mu)) * sum_k c(k)``."""
    m = int(mu(n, r))
    m = max(m, 1)
    return sum(capacity(k, n) for k in range(m)) / m


# --------------------------------------------------------------------- #
# Eqs. 1-2 — availability-optimal checkpointing (Saxena et al. 2024)    #
# --------------------------------------------------------------------- #
def tc_star(t_f: float, t_s: float, t_r: float) -> float:
    """Optimal checkpointing period (Eq. 1):
    ``T_c* = T_s + sqrt(T_s^2 + 2 T_s (T_f + T_r))``."""
    return t_s + math.sqrt(t_s * t_s + 2.0 * t_s * (t_f + t_r))


def availability_star(t_f: float, t_s: float, t_r: float) -> float:
    """Maximal availability at ``T_c*`` (Eq. 2)."""
    t_c = tc_star(t_f, t_s, t_r)
    return (t_f - t_f * t_s / t_c) / (t_f + t_c / 2.0 + t_r)


# --------------------------------------------------------------------- #
# Eq. 7 / Thm. 4.3 — joint optimization                                  #
# --------------------------------------------------------------------- #
@dataclass(frozen=True)
class SystemTimes:
    """Fixed timing parameters (paper Table 1 defaults for 600k H100)."""

    mtbf_node: float = 300.0     # m — system MTBF on *node* failures [s]
    t_save: float = 60.0         # T_s — checkpoint save time [s]
    t_restart: float = 3600.0    # T_r — global restart latency [s]


def j_normalized(r: int, n: int, times: SystemTimes = SystemTimes()) -> float:
    """Normalized time-to-train ``J(r) = S_bar(N,r) / A*(mu(N,r) m)`` (Eq. 7)."""
    t_f = mu(n, r) * times.mtbf_node
    a = availability_star(t_f, times.t_save, times.t_restart)
    return s_bar(n, r) / a


def r_star(n: int) -> int:
    """Optimal redundancy (Eq. 8): ``r* ~= floor(log2 N + 0.833)``."""
    return int(math.floor(math.log2(n) + 0.833))


def r_star_search(
    n: int, times: SystemTimes = SystemTimes(), r_max: int | None = None
) -> int:
    """Numerical argmin of J(r) — used to cross-check Eq. 8 and to pick the
    deployed redundancy for a concrete parameter set (the paper notes the
    closed form drifts by +-1-2 under Weibull failures)."""
    r_max = r_max or max(2, int(2 * math.log2(n)) + 4)
    best_r, best_j = 2, float("inf")
    for r in range(2, r_max + 1):
        if r * (r - 1) > n - 1:
            break  # no cyclic Golomb ruler can exist (pigeonhole)
        j = j_normalized(r, n, times)
        if j < best_j:
            best_r, best_j = r, j
    return best_r
