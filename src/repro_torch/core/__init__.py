"""SPARe core (copies of the JAX package's jax-free modules):
cyclic Golomb-ruler placement and the Alg. 1 protocol state."""
from .golomb import golomb_ruler, host_sets, type_sets, validate_placement
from .state import SpareState

__all__ = ["golomb_ruler", "host_sets", "type_sets", "validate_placement",
           "SpareState"]
