"""Failure models and cluster topology (copies of the JAX package's
jax-free ``repro.scenarios.models`` and ``repro.scenarios.topology``).

They feed the DES engine (:mod:`repro_torch.des.engine`) and the live
:class:`repro_torch.train.injection.ScenarioInjector` bridge; the three
bundled synthetic traces are copies of the JAX package's. The campaign
runner waits for a later slice of the port.
"""
