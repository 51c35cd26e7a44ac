"""The port's §3.1 certification (``repro_torch.exec.equivalence``, the
step log of ``repro_torch.launch.steplog``) against the JAX package's,
on the CPU, at the smoke qwen2.5-3b configuration in fp32.

* ``recoverable_failure_sets`` yields the JAX package's victims, ``S_A``
  and weight tables for every N <= 8 and r in {1, 2, 3} that has a
  cyclic Golomb placement.
* ``survivor_set_sweep`` at N 4, r 2 on a one-rank gloo group: the 4
  singles and every ``S_A`` 2 set; every check within 5e-3 (the JAX
  sweep's ``TOL``, ``tests/test_exec.py``), and within
  ``int8_sweep_tolerance(4)`` under ``int8_ef``. The mesh gradients of
  the healthy table at ``S_A`` 1 and 2 and of a masked set (every
  recoverable set at N 4, r 2 runs at ``S_A`` 2) within 1e-5 of the
  largest |JAX| element of JAX's ``SpareTrainer.spare_grads`` (fp32 in
  another summation order).
* A masked step and the healthy step at its ``S_A`` record the same
  collective schedule in both syncs on a fake grid of (data 4, model 2);
  the int8 EF step moves at most 0.3x the fp32 step's bytes.
* ``step_log`` leaves the executor bit for bit as it was.

Every test that brings a process group up takes it down again.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import smoke_config as jax_smoke
from repro.core import Rectlr as JaxRectlr
from repro.core import SpareState as JaxSpareState
from repro.exec.equivalence import \
    recoverable_failure_sets as jax_recoverable_failure_sets
from repro.train.trainer import SpareTrainer as JaxTrainer
from repro_torch.configs import smoke_config
from repro_torch.core import SpareState
from repro_torch.dist import tree_leaves
from repro_torch.exec import (MeshExecutor, int8_sweep_tolerance,
                              recoverable_failure_sets, survivor_set_sweep)
from repro_torch.launch.lint import EXECUTOR, fake_grid
from repro_torch.launch.mesh import close_data_group, init_data_group
from repro_torch.launch.steplog import (same_collective_schedule,
                                        wire_byte_ratio)
from repro_torch.models import cast_params
from repro_torch.optim import adamw_init
from repro_torch.train.trainer import SpareTrainer

ARCH = "qwen2.5-3b"
TOL = 5e-3
KW = dict(n_groups=4, redundancy=2, seq=16, per_type_batch=1,
          total_steps=50)


@pytest.fixture(autouse=True)
def one_thread():
    """The steps here are tiny: on a loaded host torch's thread pool
    costs more than it gives (the pytest workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _grids():
    """Every (N, r) with N <= 8, r in {1, 2, 3} that has a cyclic Golomb
    placement (r <= N and r(r - 1) distinct non-zero residues mod N)."""
    return [(n, r) for n in range(1, 9) for r in (1, 2, 3)
            if r <= n and r * (r - 1) <= n - 1]


@pytest.mark.parametrize("n,r", _grids())
def test_recoverable_failure_sets_equal_jax(n, r):
    got = list(recoverable_failure_sets(n, r))
    want = list(jax_recoverable_failure_sets(n, r))
    assert [v for v, _ in got] == [v for v, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.s_a == b.s_a
        for x, y in zip(a.device_schedule(), b.device_schedule()):
            np.testing.assert_array_equal(x, y)


@pytest.fixture
def one_rank():
    """A one-rank gloo group as the default group (whatever group an
    earlier test file left up is taken down first), taken down after."""
    close_data_group()
    init_data_group("cpu")
    try:
        yield
    finally:
        close_data_group()
    assert not dist.is_initialized()


def _fp32(obj):
    obj.params = cast_params(obj.params, dtype=torch.float32)
    obj.opt_state = adamw_init(obj.params)
    return obj


@pytest.mark.parametrize("compress", [None, "int8_ef"])
def test_survivor_set_sweep(one_rank, compress):
    cfg = smoke_config(ARCH).scaled(grad_accum=1)
    ex = _fp32(MeshExecutor(cfg, grad_compress=compress, device="cpu",
                            **KW))
    ref = _fp32(SpareTrainer(cfg, device="cpu", **KW))
    try:
        checks = survivor_set_sweep(ex, ref)
    finally:
        ex.close()
    singles = [c for c in checks if len(c.victims) == 1]
    assert [c.victims for c in singles] == [(0,), (1,), (2,), (3,)]
    assert any(c.s_a == 2 for c in checks)
    tol = int8_sweep_tolerance(4) if compress else TOL
    bad = [c for c in checks if not c.ok(tol)]
    assert bad == []
    # the schedules stayed as they were
    assert ex.state.s_a == ref.state.s_a == 1 and ex.state.alive.all()


def test_mesh_grads_match_jax_spare_grads(one_rank):
    cfg = smoke_config(ARCH).scaled(grad_accum=1)
    ex = _fp32(MeshExecutor(cfg, device="cpu", **KW))
    jt = JaxTrainer(jax_smoke(ARCH).scaled(grad_accum=1), **KW)
    # the port's fp32 params in JAX's tree (the same leaf order)
    jt.params = jax.tree.unflatten(
        jax.tree.structure(jt.params),
        [jnp.asarray(t.numpy()) for t in tree_leaves(ex.params)])
    victims, masked = next(recoverable_failure_sets(4, 2))
    jmasked = JaxSpareState(4, 2)
    JaxRectlr().on_failures(jmasked, list(victims))
    cases = []
    for s_a in (1, 2):
        st, jst = SpareState(4, 2), JaxSpareState(4, 2)
        st.s_a = jst.s_a = s_a
        cases.append((st, jst))
    cases.append((masked, jmasked))
    try:
        for st, jst in cases:
            got = [t.numpy() for t in tree_leaves(ex.mesh_grads(0, state=st))]
            jt.state = jst
            want = [np.asarray(t) for t in jax.tree.leaves(jt.spare_grads(0))]
            scale = max(np.abs(w).max() for w in want)
            for a, b in zip(got, want, strict=True):
                assert np.abs(a - b).max() <= 1e-5 * scale
    finally:
        ex.close()


def _logs(sync: str, compress=None, rank: int = 0):
    """(masked, healthy at the masked S_A) step logs of one rank of the
    fake (data 4, model 2) grid."""
    victims, masked = next(recoverable_failure_sets(4, 2))
    healthy = SpareState(4, 2)
    healthy.s_a = masked.s_a
    cfg = smoke_config(ARCH).scaled(grad_accum=1)
    world = EXECUTOR["n_groups"] * EXECUTOR["model_degree"]
    with fake_grid(rank, world) as group:
        ex = MeshExecutor(cfg, sync=sync, grad_compress=compress,
                          group=group, device="cpu", **EXECUTOR)
        try:
            logs = ex.step_log(masked), ex.step_log(healthy)
            # the sweep's unwatched recording keeps the schedule
            assert ex.step_log(masked, watch=False).schedule() == \
                logs[0].schedule()
            return logs
        finally:
            ex.close()


@pytest.mark.parametrize("sync", ["shard_map", "gspmd"])
def test_masked_step_keeps_the_healthy_schedule(sync):
    masked, healthy = _logs(sync)
    assert not dist.is_initialized()
    assert masked.collectives and same_collective_schedule(masked, healthy)
    assert masked.loss != healthy.loss      # the weight table is live


def test_int8_ef_wire_bytes_at_most_0_3_of_fp32():
    int8, _ = _logs("shard_map", "int8_ef")
    fp32, _ = _logs("shard_map")
    assert not dist.is_initialized()
    ratio = wire_byte_ratio(int8, fp32)
    assert 0.2 < ratio <= 0.3
    ops = {c.op for c in int8.collectives if c.dtype == "int8"}
    assert ops == {"all_to_all_single", "all_gather_into_tensor"}


def _snapshot(ex) -> dict:
    st = ex.state
    return {
        "state": [t.clone() for t in ex.state_leaves()],
        "ptrs": [t.untyped_storage().data_ptr() for t in ex.state_leaves()],
        "opt_step": ex.opt_state.step, "step": ex.step,
        "schedule": (st.stacks.copy(), st.alive.copy(), st.s_a,
                     st.supplier.copy(), ex._schedule_version),
        "rng": torch.get_rng_state(), "prefetch": ex._prefetch,
        "keys": ex.cache_keys, "recompiles": ex.total_recompiles,
    }


def test_step_log_leaves_the_executor_as_it_was(one_rank):
    cfg = smoke_config(ARCH).scaled(grad_accum=1)
    ex = MeshExecutor(cfg, grad_compress="int8_ef", device="cpu", **KW)
    try:
        ex.run(1)                       # moments and residuals
        ex._prefetch_next()             # the next step's rows queued
        before = _snapshot(ex)
        masked = next(recoverable_failure_sets(4, 2))[1]
        logs = [ex.step_log(), ex.step_log(masked)]
        after = _snapshot(ex)
        for a, b in zip(before["state"], after["state"], strict=True):
            assert torch.equal(a, b)
        for k in ("ptrs", "opt_step", "step", "keys", "recompiles"):
            assert before[k] == after[k], k
        for a, b in zip(before["schedule"], after["schedule"]):
            assert np.array_equal(a, b)
        assert torch.equal(before["rng"], after["rng"])
        assert after["prefetch"] is before["prefetch"]
        assert all(len(lg.storage_before) == len(before["state"])
                   for lg in logs)
    finally:
        ex.close()
