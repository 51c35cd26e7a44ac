"""Gray-failure tier: only its closed-form degraded-TTT policy (a copy of
the JAX package's jax-free ``repro.health.policy``), which the adaptive
scheme consults. The straggler detector waits for a later slice."""
