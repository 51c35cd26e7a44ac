"""Expert parallelism of the port (``moe_ffn`` on a model group) against
the JAX package's mesh ``moe_ffn``, on the CPU.

The port's expert-parallel body runs on 4 gloo ranks (spawned processes,
a (data 2, model 2) grid: two model groups of 2) and JAX's ``moe_ffn``
with a mesh on 4 emulated devices (one subprocess,
``tests/_tp_jax.py``), on ``(1, 2)`` and ``(2, 2)`` meshes: on ``(1,
2)`` each model group runs the whole batch, on ``(2, 2)`` data slice
``d`` its half. One fp32 MoE layer of smoke deepseek-v2-lite (8 experts
top-2, a shared expert, 4 a rank) and of smoke jamba (no shared expert),
drawn by JAX's ``_init_moe``, at capacity factors 1.25 and 0.5: the
static capacity, ``max(8, int(cf * t * k / E))`` of the slice's ``t``
tokens, drops slots at 0.5 (counted here through the port's own
dispatch) and fewer or none at 1.25. The rank takes the whole layer (and cuts its
experts and shared-expert slice itself) or its own part already
(``ep_shard``); the gradients of the whole leaves are summed over the
model group (and, on ``(2, 2)``, over the data group, since the layer
serves both slices).

Tolerances: the output, the input's gradient and each parameter's
gradient of ``sum(y * cot)`` within 1e-5 of the largest |JAX| element
of that tensor (fp32 summation order); a slot dropped on one side and
kept on the other would move an output row by O(1). The model built on
the group (smoke deepseek-v2-lite, fp32, a dense block then two MoE
blocks, on a ``(1, 2)`` mesh, as ``build_model(cfg, mesh=...)``): the
loss within 1e-6 relative and every parameter's gradient within 1e-5 of
its largest element.
"""
import os
import pickle
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tp_cases import (EP_ARCHS, EP_CAPACITY, EP_MESHES, EP_X, N,
                       ep_inputs, port_ep_rank)
from repro.configs import smoke_config as jax_smoke
from repro.models.model import _init_moe as jax_init_moe
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import params_from_numpy
from repro_torch.models.moe import _dispatch, ep_capacity, route_topk

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    inputs = {"moe": {a: _f32(jax_init_moe(jax.random.key(3),
                                           jax_smoke(a)))
                      for a in EP_ARCHS},
              "model": _f32(jax_build_model(jax_smoke(EP_ARCHS[0])).init(
                  jax.random.key(0)))}
    path = tmp / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    flags = os.environ.get("XLA_FLAGS", "")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS=f"{flags} --xla_force_host_platform_device_count="
                         f"{N}".strip())
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_tp_jax.py"), "ep",
         str(path), str(tmp / "jax.pkl")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port, _ = spawn_ranks(port_ep_rank, N, device="cpu",
                              args=(str(path),))
        log = proc.communicate(timeout=900)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, log[-4000:]
    with open(tmp / "jax.pkl", "rb") as f:
        theirs = pickle.load(f)
    return {"port": port, "jax": theirs, "inputs": inputs}


def _close(got, want, what) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), (what, err, np.abs(want).max())


def _drops(runs, arch: str, cf: float, mesh) -> int:
    """Slots the static capacity drops over the layer's ranks and data
    slices (the port's dispatch on the router's choices)."""
    cfg = smoke_config(arch)
    cfg = cfg.scaled(moe=replace(cfg.moe, capacity_factor=cf))
    p = params_from_numpy(runs["inputs"]["moe"][arch], "cpu")
    x, _ = ep_inputs(cfg.d_model)
    e_local = cfg.moe.n_experts // 2
    dropped = 0
    for rows in np.array_split(np.arange(EP_X[0]), mesh[0]):
        xf = torch.from_numpy(x[rows].reshape(-1, cfg.d_model))
        idx, _ = route_topk(xf, p["router"], cfg.moe.top_k)
        cap = ep_capacity(cfg, xf.shape[0])
        for m in range(2):
            _, keep = _dispatch(idx, m * e_local, e_local, cap)
            here = ((idx >= m * e_local) & (idx < (m + 1) * e_local))
            dropped += int((here.reshape(-1) & ~keep).sum())
    return dropped


@pytest.mark.parametrize("local", [False, True], ids=["whole", "ep_shard"])
@pytest.mark.parametrize("mesh", EP_MESHES, ids=["1x2", "2x2"])
@pytest.mark.parametrize("cf", EP_CAPACITY)
@pytest.mark.parametrize("arch", EP_ARCHS)
def test_moe_ffn_on_a_model_group_matches_jax(runs, arch, cf, mesh, local):
    want = runs["jax"][(arch, cf, mesh)]
    for rank in range(N):
        got = runs["port"][rank][(arch, cf, mesh, local)]
        rows = slice(None) if mesh[0] == 1 else \
            slice(rank // 2 * EP_X[0] // 2, (rank // 2 + 1) * EP_X[0] // 2)
        _close(got["y"], want["y"][rows], "y")
        _close(got["dx"], want["dx"][rows], "dx")
        assert len(got["grads"]) == len(want["grads"])
        for i, (a, b) in enumerate(zip(got["grads"], want["grads"])):
            _close(a, b, f"grad {i}")


@pytest.mark.parametrize("mesh", EP_MESHES, ids=["1x2", "2x2"])
@pytest.mark.parametrize("arch", EP_ARCHS)
def test_the_low_capacity_drops_slots(runs, arch, mesh):
    """At capacity factor 0.5 the static capacity bites (the cases above
    then hold the drops to JAX's); at 1.25 it drops fewer."""
    low = _drops(runs, arch, 0.5, mesh)
    assert low > 0 and low > _drops(runs, arch, 1.25, mesh)


def test_model_on_a_model_group_matches_jax(runs):
    want = runs["jax"]["model"]
    for rank in range(N):
        got = runs["port"][rank]["model"]
        assert abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
        assert len(got["grads"]) == len(want["grads"])
        for i, (a, b) in enumerate(zip(got["grads"], want["grads"])):
            _close(a, b, f"grad {i}")
