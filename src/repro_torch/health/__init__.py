"""Gray-failure tier: the online straggler detector and the closed-form
degraded-TTT policy (copies of the JAX package's jax-free
``repro.health.detector`` and ``repro.health.policy``). The trainer's
health tick and the serving tier's health-weighted routing consume it."""
from .detector import HealthReport, StragglerDetector
from .policy import degraded_ttt_estimates

__all__ = ["StragglerDetector", "HealthReport", "degraded_ttt_estimates"]
