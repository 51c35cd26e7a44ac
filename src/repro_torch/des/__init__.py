"""Discrete-event simulation and the fault-tolerance scheme registry
(copies of the JAX package's jax-free ``repro.des`` modules).

The trainer resolves its recovery policy here:
``get_scheme("spare", r=...)`` is its default.
"""
from .engine import (FailureRecovery, FaultToleranceScheme, SimClock,
                     SimResult, run_scheme)
from .params import DESParams
from .schemes import (
    AdaptiveScheme,
    CkptOnlyScheme,
    ReplicationScheme,
    SpareScheme,
    get_scheme,
    list_schemes,
    register_scheme,
    simulate_ckpt_only,
    simulate_replication,
    simulate_spare,
)

__all__ = [
    "DESParams", "SimResult", "SimClock",
    "FaultToleranceScheme", "FailureRecovery", "run_scheme",
    "CkptOnlyScheme", "ReplicationScheme", "SpareScheme", "AdaptiveScheme",
    "register_scheme", "get_scheme", "list_schemes",
    "simulate_ckpt_only", "simulate_replication", "simulate_spare",
]
