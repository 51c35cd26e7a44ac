"""SPARe core (copies of the JAX package's jax-free modules): cyclic
Golomb-ruler placement, matching, the Alg. 1 protocol state, the Alg. 2
reordering controller and the Sec. 4 closed forms."""
from .golomb import golomb_ruler, host_sets, type_sets, validate_placement
from .rectlr import Rectlr, RectlrOutcome
from .state import SpareState
from .theory import (
    SystemTimes,
    availability_star,
    capacity,
    j_normalized,
    mu,
    r_star,
    s_bar,
    s_bar_lower,
    tc_star,
)

__all__ = [
    "golomb_ruler", "host_sets", "type_sets", "validate_placement",
    "SpareState", "Rectlr", "RectlrOutcome",
    "mu", "s_bar", "s_bar_lower", "capacity", "tc_star",
    "availability_star", "j_normalized", "r_star", "SystemTimes",
]
