"""Failure models and cluster topology (copies of the JAX package's
jax-free ``repro.scenarios.models`` and ``repro.scenarios.topology``).

Only what the DES engine (:mod:`repro_torch.des.engine`) draws its
failures from is here: the campaign runner, the bundled traces and the
live ``ScenarioInjector`` bridge wait for a later slice of the port.
"""
