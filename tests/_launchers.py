"""What the port's serve and train launchers build, caught before they
run: the configuration each hands on for an arch on a device. Helper of
``tests/test_torch_injection.py`` and ``tests/test_torch_deepseek.py``;
a CUDA device need not exist for it (the device is not resolved)."""
import pytest
import torch

from repro_torch import models
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli


class _Built(Exception):
    pass


def launcher_configs(arch: str, device: str, monkeypatch) -> list:
    """``[serve's config, train's config]`` for ``--arch arch --device
    device``; each launcher stops where it would build its model or
    start its trainer."""
    seen = []

    def catch(cfg, *args, **kwargs):
        seen.append(cfg)
        raise _Built

    monkeypatch.setattr(models, "build_model", catch)
    monkeypatch.setattr(models, "resolve_device", torch.device)
    monkeypatch.setattr(train_cli, "_run_here",
                        lambda args, cfg, *rest: catch(cfg))
    for main in (serve_cli.main, train_cli.main):
        with pytest.raises(_Built):
            main(["--arch", arch, "--device", device])
    return seen
