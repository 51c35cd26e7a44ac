"""Command-line entry points of the port (``python -m
repro_torch.launch.<name>``). Each runs the JAX launchers' smoke-size
configuration (:func:`repro_torch.configs.smoke_config`) on every
device."""
