"""Elastic recovery tier: only its closed-form TTT policy (a copy of the
JAX package's jax-free ``repro.elastic.policy``), which the adaptive
scheme consults. The elastic executor waits for a later slice."""
