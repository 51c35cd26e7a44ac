"""The port's checkpoints (``repro_torch.ckpt``) against the JAX
package's (``repro.ckpt``), on the CPU.

* Format: with a fixed clock, both packages write byte-identical
  ``shard_0.npz`` and ``manifest.json`` for the same state (bf16 and fp32
  leaves and the int32 optimizer step), and each restores the other's
  checkpoint bit for bit. ``np.savez`` also stamps each zip entry with
  the time of the save (two-second resolution); the byte comparisons fix
  that time for both saves.
* Durability: the rules ``tests/test_ckpt.py`` holds the JAX manager to
  (crash leftovers and the parked ``.old_step_*`` copy, re-saving a step
  after a rollback, a failed background save re-raised, a retry that
  succeeds, ``due`` with an injected ``monotonic``, ``gc`` with
  ``keep``), and the port's own memory tier (one host copy, reused in
  place).
* Serving: a wipe-out reloads the params from the checkpoint the server
  wrote at construction; every request completes with the healthy run's
  tokens and the JAX server's on the same fp32 params.
* The trainer with ``ckpt_dir``: the port's ``SpareTrainer`` and
  ``MeshExecutor`` (one rank, gloo) against the JAX package's through a
  scripted mask and a wipe-out: the same events, the same ``ckpt_saves``
  and committed steps, losses within 1e-5 relative (the tolerance of
  ``test_spare_trainer_matches_jax_through_mask_and_wipeout``), and the
  last checkpoint of each restores in the other package: its params
  within 1e-5, its step exactly, its moments within ``MOMENT_TOL``.
"""
import itertools
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.ckpt.checkpoint as ckpt_mod
from _groups import data_group  # noqa: F401 (a fixture)
from repro.ckpt import restore_checkpoint as jax_restore
from repro.ckpt import save_checkpoint as jax_save
from repro.ckpt.checkpoint import _flatten_with_names as jax_names
from repro.configs import smoke_config as jax_smoke
from repro.core.theory import mu, tc_star
from repro.ckpt import CheckpointManager as JaxManager
from repro.des.params import DESParams as JaxDESParams
from repro.exec import MeshExecutor as JaxMeshExecutor
from repro.models import build_model as jax_build
from repro.models.model import Model as JaxModel
from repro.optim import AdamWState as JaxAdamWState
from repro.optim import adamw_init as jax_adamw_init
from repro.scenarios.topology import ClusterTopology as JaxTopology
from repro.serve import ReplicaServer as JaxReplicaServer
from repro.train.injection import ScenarioInjector as JaxInjector
from repro.train.injection import ScriptedInjector as JaxScripted
from repro.train.trainer import SpareTrainer as JaxTrainer
from repro_torch.ckpt import (CheckpointManager, restore_checkpoint,
                              save_checkpoint, sweep_stale_tmp)
from repro_torch.ckpt.checkpoint import _flatten_with_names
from repro_torch.configs import smoke_config
from repro_torch.data import RequestStream
from repro_torch.des.params import DESParams
from repro_torch.exec import MeshExecutor
from repro_torch.models import build_model, params_from_numpy
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.scenarios.topology import ClusterTopology
from repro_torch.serve import ReplicaServer, pool_pages_for
from repro_torch.train import ScenarioInjector, ScriptedInjector
from repro_torch.train.trainer import SpareTrainer

ARCH = "qwen2.5-3b"
TINY = dict(head_dim=64, grad_accum=1)
FIXED = 1726000000.0
SERVE_ENGINE = dict(n_slots=2, page_size=4, max_new=4, buckets=(8,),
                    n_pages=pool_pages_for(2, 8 + 4, 4))
SCRIPT = {1: [0], 3: [1, 3]}          # masked (S_A 1 -> 2), then wipe-out


def _bits(x) -> np.ndarray:
    """A leaf's raw bits (tensor or array) as an unsigned numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.numpy()
    a = np.asarray(x)
    return a.view(f"u{a.dtype.itemsize}") if a.dtype.itemsize > 1 else a


def _same_bits(a, b) -> bool:
    a, b = _bits(a), _bits(b)
    return a.shape == b.shape and np.array_equal(a, b)


@pytest.fixture(scope="module")
def jax_state():
    """A JAX training state: bf16 and fp32 params from the JAX init,
    fp32 moments drawn from a seed, the int32 step 7."""
    params = jax_build(jax_smoke(ARCH)).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    moment = lambda p: jnp.asarray(  # noqa: E731
        rng.standard_normal(p.shape).astype(np.float32))
    opt = JaxAdamWState(step=jnp.asarray(7, jnp.int32),
                        mu=jax.tree.map(moment, params),
                        nu=jax.tree.map(moment, params))
    return params, opt


def _port_state(jax_state):
    params, opt = jax.tree.map(np.asarray, jax_state)
    return (params_from_numpy(params, "cpu"),
            AdamWState(int(opt.step), params_from_numpy(opt.mu, "cpu"),
                       params_from_numpy(opt.nu, "cpu")))


def _small():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones((2, 2), dtype=torch.bfloat16),
                  "d": torch.zeros((5,), dtype=torch.int32)}}


def _plus(tree, k):
    return {"a": tree["a"] + k, "b": {"c": tree["b"]["c"] + k,
                                      "d": tree["b"]["d"] + k}}


def _assert_same(a, b):
    fa, fb = _flatten_with_names(a), _flatten_with_names(b)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (n, x), (_, y) in zip(fa, fb):
        assert _same_bits(x, y), n


def _manager(path, **kw):
    return CheckpointManager(path, n_groups=8, redundancy=3, mtbf=300,
                             t_save=60, t_restart=3600, **kw)


# ------------------------------------------------------------------ #
# format: both packages, both ways                                   #
# ------------------------------------------------------------------ #
def test_leaf_names_follow_the_jax_key_path(jax_state):
    port = _port_state(jax_state)
    want = jax_names(jax_state)
    got = _flatten_with_names(port)
    assert [n for n, _ in got] == [n for n, _ in want]
    assert "1/step" in [n for n, _ in got]
    assert {str(a.dtype) for _, a in want} == {"bfloat16", "float32",
                                               "int32"}


def test_saves_are_byte_identical_to_jax(jax_state, tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: FIXED)   # zip entry stamps
    a = jax_save(tmp_path / "jax", 5, jax_state, clock=lambda: FIXED)
    b = save_checkpoint(tmp_path / "port", 5, _port_state(jax_state),
                        clock=lambda: FIXED)
    for name in ("manifest.json", "shard_0.npz"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    man = json.loads((b / "manifest.json").read_text())
    assert man["format"] == "npz-v1" and man["time"] == FIXED
    assert "bfloat16" in man["dtypes"]


def test_each_package_restores_the_other_bit_for_bit(jax_state, tmp_path):
    port = _port_state(jax_state)
    jax_save(tmp_path / "jax", 3, jax_state)
    save_checkpoint(tmp_path / "port", 4, port)
    step, got = restore_checkpoint(tmp_path / "jax", port)
    assert step == 3 and isinstance(got[1].step, int) and got[1].step == 7
    _assert_same(got, port)
    assert {t.dtype for t in ckpt_mod.tree_tensors(got)} == {
        torch.bfloat16, torch.float32}
    step, want = jax_restore(tmp_path / "port", jax_state)
    assert step == 4
    for (n, x), (_, y) in zip(jax_names(want), jax_names(jax_state)):
        assert x.dtype == y.dtype and _same_bits(x, y), n


# ------------------------------------------------------------------ #
# durability rules (tests/test_ckpt.py, on the port)                 #
# ------------------------------------------------------------------ #
def test_save_restore_roundtrip_and_latest_of_many(tmp_path):
    t = _small()
    save_checkpoint(tmp_path / "one", 7, t)
    step, restored = restore_checkpoint(tmp_path / "one", t)
    assert step == 7
    _assert_same(restored, t)
    for s in (1, 5, 3):
        save_checkpoint(tmp_path / "many", s, _plus(t, s))
    step, restored = restore_checkpoint(tmp_path / "many", t)
    assert step == 5
    _assert_same(restored, _plus(t, 5))
    step, _ = restore_checkpoint(tmp_path / "many", t, step=3)
    assert step == 3
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "many", t, step=4)


@pytest.mark.parametrize("keep", [1, 2])
def test_async_manager_keeps_the_newest(tmp_path, keep):
    mgr = _manager(tmp_path, keep=keep)
    t = _small()
    for s in range(4):
        assert mgr.maybe_save(s, _plus(t, s), force=True, block=True)
    kept = sorted(p.name for p in tmp_path.glob("step_*"))
    assert kept == [f"step_{s:08d}" for s in range(4 - keep, 4)]
    assert mgr.saves == 4
    step, restored = mgr.restore_latest(t)
    assert step == 3
    _assert_same(restored, _plus(t, 3))


def test_interval_is_eq1_optimal(tmp_path):
    n, r, m, ts, tr = 600, 8, 300.0, 60.0, 3600.0
    mgr = CheckpointManager(tmp_path, n_groups=n, redundancy=r, mtbf=m,
                            t_save=ts, t_restart=tr)
    assert mgr.interval == tc_star(mu(n, r) * m, ts, tr)
    assert mgr.interval > 3 * tc_star(m, ts, tr)


def test_snapshot_is_a_real_copy_reused_in_place(tmp_path):
    """The memory tier holds host copies: updating the live tensors in
    place (as the optimizer does) leaves the snapshot as it was, and the
    next snapshot of the same shapes is written into the same host
    tensors, never a second copy."""
    mgr = _manager(tmp_path)
    x = {"w": torch.ones(4), "v": torch.zeros(2, dtype=torch.bfloat16)}
    mgr.snapshot(0, x)
    x["w"].mul_(2.0)
    step, tree = mgr.rollback()
    assert step == 0 and torch.equal(tree["w"], torch.ones(4))
    first = [t.data_ptr() for t in ckpt_mod.tree_tensors(tree)]
    mgr.snapshot(1, x)
    step, tree = mgr.rollback()
    assert step == 1 and torch.equal(tree["w"], torch.full((4,), 2.0))
    assert [t.data_ptr() for t in ckpt_mod.tree_tensors(tree)] == first
    # another shape: a fresh copy
    mgr.snapshot(2, {"w": torch.ones(3)})
    assert mgr.rollback()[1]["w"].shape == (3,)
    with pytest.raises(RuntimeError, match="no snapshot"):
        _manager(tmp_path / "other").rollback()


def test_saving_the_memory_tier_writes_it_without_a_copy(tmp_path,
                                                         monkeypatch):
    """``maybe_save`` of the memory tier's own tree hands that tree to
    the writer as it is; a later snapshot waits for the save before it
    overwrites the tensors the writer reads."""
    seen = []
    real = ckpt_mod.save_checkpoint

    def slow(directory, step, tree, *, clock):
        seen.append([t.data_ptr() for t in ckpt_mod.tree_tensors(tree)])
        time.sleep(0.2)
        return real(directory, step, tree, clock=clock)

    monkeypatch.setattr(ckpt_mod, "save_checkpoint", slow)
    mgr = _manager(tmp_path, retry_backoff=0.0)
    live = _small()
    mgr.snapshot(4, live)
    snap = mgr.last_snapshot[1]
    assert mgr.maybe_save(4, snap, force=True)
    assert seen[0] == [t.data_ptr() for t in ckpt_mod.tree_tensors(snap)]
    live["a"].add_(100.0)
    mgr.snapshot(5, live)            # waits for the step-4 save
    assert mgr.saves == 1
    _, got = restore_checkpoint(tmp_path, _small(), step=4)
    _assert_same(got, _small())
    # a live tree is copied first
    assert mgr.maybe_save(6, live, force=True, block=True)
    assert seen[1] != [t.data_ptr() for t in ckpt_mod.tree_tensors(live)]


def test_crash_leftovers_do_not_break_restore(tmp_path):
    """A crash mid-save leaves restore working: neither the legacy
    ``step_<n>.tmp`` nor a ``.tmp_step_*`` staging dir parses, and
    ``sweep_stale_tmp`` removes exactly the leftovers."""
    t = _small()
    save_checkpoint(tmp_path, 1, t)
    legacy = tmp_path / "step_00000100.tmp"
    legacy.mkdir()
    (legacy / "shard_0.npz").write_bytes(b"partial garbage")
    (tmp_path / ".tmp_step_00000002").mkdir()
    step, restored = restore_checkpoint(tmp_path, t)
    assert step == 1
    _assert_same(restored, t)
    removed = sorted(p.name for p in sweep_stale_tmp(tmp_path))
    assert removed == [".tmp_step_00000002", "step_00000100.tmp"]
    assert [p.name for p in tmp_path.iterdir()] == ["step_00000001"]


def test_manager_sweeps_stale_tmp_on_init(tmp_path):
    save_checkpoint(tmp_path, 3, _small())
    for name in (".tmp_step_00000004", "step_00000005.tmp",
                 ".old_step_00000003"):
        (tmp_path / name).mkdir()
    mgr = _manager(tmp_path)
    assert [p.name for p in tmp_path.iterdir()] == ["step_00000003"]
    step, _ = mgr.restore_latest(_small())
    assert step == 3


@pytest.mark.parametrize("older", [False, True],
                         ids=["only_step", "beside_an_older_step"])
def test_crash_inside_overwrite_commit_recovers_parked_copy(tmp_path,
                                                            older):
    """A crash between parking the old step dir and committing the new
    one loses nothing: restore reads the parked copy in place (and
    prefers it to an older step), and the next manager renames it back
    and clears the staging leftover."""
    t = _small()
    if older:
        save_checkpoint(tmp_path, 2, t)
    save_checkpoint(tmp_path, 9, _plus(t, 3))
    (tmp_path / "step_00000009").rename(tmp_path / ".old_step_00000009")
    (tmp_path / ".tmp_step_00000009").mkdir()
    for step_arg in (None, 9):
        step, restored = restore_checkpoint(tmp_path, t, step=step_arg)
        assert step == 9
        _assert_same(restored, _plus(t, 3))
    assert (tmp_path / ".old_step_00000009").is_dir()
    mgr = _manager(tmp_path)
    assert (tmp_path / "step_00000009").is_dir()
    assert not (tmp_path / ".old_step_00000009").exists()
    assert not (tmp_path / ".tmp_step_00000009").exists()
    step, restored = mgr.restore_latest(t)
    assert step == 9
    _assert_same(restored, _plus(t, 3))


@pytest.mark.parametrize("through", ["function", "manager"])
def test_resave_same_step_after_rollback(tmp_path, through):
    """Re-saving a step the directory holds (wipe-out, rollback,
    retrain) replaces it and leaves no staging or parked dir."""
    t = _small()
    if through == "function":
        save_checkpoint(tmp_path, 5, t)
        save_checkpoint(tmp_path, 5, _plus(t, 1))
    else:
        mgr = _manager(tmp_path)
        assert mgr.maybe_save(5, t, force=True, block=True)
        assert mgr.maybe_save(5, _plus(t, 1), force=True, block=True)
        assert mgr.saves == 2
    step, restored = restore_checkpoint(tmp_path, t)
    assert step == 5
    _assert_same(restored, _plus(t, 1))
    assert [p.name for p in tmp_path.iterdir()] == ["step_00000005"]


def test_universal_restore_across_dtypes(tmp_path):
    """Leaves restore into the target's dtype and shape: fp32 into bf16
    rounds to nearest even as the JAX package's ``np.asarray`` does, and
    bf16 into fp32 is exact."""
    w = torch.tensor([1.0, 1.00390625, 1.01171875, -3.0e-3])
    save_checkpoint(tmp_path, 1, {"w": w})
    _, got = restore_checkpoint(tmp_path, {"w": torch.zeros(4,
                                                            dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], w.to(torch.bfloat16))
    save_checkpoint(tmp_path, 2, {"w": got["w"]})
    _, back = restore_checkpoint(tmp_path, {"w": torch.zeros(2, 2)})
    assert torch.equal(back["w"], got["w"].float().reshape(2, 2))


def test_fixed_clock_resave_is_byte_identical(tmp_path, monkeypatch):
    t = _small()
    a = save_checkpoint(tmp_path / "a", 7, t, clock=lambda: FIXED)
    b = save_checkpoint(tmp_path / "b", 7, t, clock=lambda: FIXED)
    assert (a / "manifest.json").read_bytes() == \
        (b / "manifest.json").read_bytes()
    monkeypatch.setattr(time, "time", lambda: FIXED)   # zip entry stamps
    a = save_checkpoint(tmp_path / "c", 7, t, clock=lambda: FIXED)
    b = save_checkpoint(tmp_path / "d", 7, t, clock=lambda: FIXED)
    assert (a / "shard_0.npz").read_bytes() == \
        (b / "shard_0.npz").read_bytes()
    mgr = CheckpointManager(tmp_path / "m", n_groups=4, redundancy=2,
                            mtbf=300.0, t_save=1.0, t_restart=60.0,
                            clock=lambda: 42.0)
    mgr.maybe_save(3, t, block=True, force=True)
    man = json.loads((tmp_path / "m" / "step_00000003" /
                      "manifest.json").read_text())
    assert man["time"] == 42.0


class _FakeMonotonic:
    """Injectable interval clock: advances only when told to."""

    def __init__(self, start: float = 1000.0):
        self.now = start

    def __call__(self) -> float:
        return self.now


def test_due_is_deterministic_with_injected_monotonic(tmp_path):
    fake = _FakeMonotonic()
    mgr = _manager(tmp_path, monotonic=fake)
    assert not mgr.due()
    fake.now += mgr.interval - 1e-6
    assert not mgr.due()
    fake.now += 2e-6
    assert mgr.due()
    assert mgr.maybe_save(1, _small(), block=True)
    assert not mgr.due()
    fake.now += mgr.interval + 1.0
    assert mgr.due()
    assert not mgr.due(now=fake.now - mgr.interval)


def test_failed_background_save_is_captured_and_reraised(tmp_path,
                                                        monkeypatch):
    """A save that fails twice is not silent: ``saves`` stays put, the
    interval clock rewinds, and the error surfaces from the next
    ``wait()`` chained to the storage exception, once."""
    fake = _FakeMonotonic()
    mgr = _manager(tmp_path, monotonic=fake, retry_backoff=0.0)
    attempts = []

    def boom(directory, step, tree, *, clock=None):
        attempts.append(step)
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod, "save_checkpoint", boom)
    fake.now += mgr.interval + 1.0
    assert mgr.due()
    assert mgr.maybe_save(1, _small(), force=True)
    with pytest.raises(RuntimeError, match="background checkpoint save "
                                           "failed") as ei:
        mgr.wait()
    assert isinstance(ei.value.__cause__, OSError)
    assert attempts == [1, 1]
    assert mgr.saves == 0 and mgr.save_failures == 1
    assert mgr.due(), "a failed save must rewind the interval clock"
    monkeypatch.setattr(ckpt_mod, "save_checkpoint", save_checkpoint)
    assert mgr.maybe_save(2, _small(), force=True, block=True)
    assert mgr.saves == 1
    assert mgr.restore_latest(_small())[0] == 2


def test_failed_save_retry_succeeds_transparently(tmp_path, monkeypatch):
    calls = []

    def flaky(directory, step, tree, *, clock):
        calls.append(step)
        if len(calls) == 1:
            raise OSError("transient")
        return save_checkpoint(directory, step, tree, clock=clock)

    monkeypatch.setattr(ckpt_mod, "save_checkpoint", flaky)
    mgr = _manager(tmp_path, retry_backoff=0.0)
    assert mgr.maybe_save(4, _small(), force=True, block=True)
    mgr.wait()
    assert calls == [4, 4]
    assert mgr.saves == 1 and mgr.save_failures == 0
    assert mgr.restore_latest(_small())[0] == 4


def test_restore_refuses_a_tree_of_another_size(tmp_path):
    save_checkpoint(tmp_path, 1, _small())
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(tmp_path, {"a": torch.zeros(3, 4)})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "none", _small())


# ------------------------------------------------------------------ #
# the trainer with a checkpoint directory, against the JAX package   #
# ------------------------------------------------------------------ #
def _jax_params():
    model = build_model(smoke_config(ARCH).scaled(**TINY), device="cpu")
    return jax.tree.map(lambda t: t.float().numpy(), model.init(0))


def _fixed_clocks(trainer):
    """Every snapshot point is due (a fake monotonic clock that moves
    1e9 s a reading) and manifests carry a fixed time."""
    trainer.ckpt.monotonic = itertools.count(1e12, 1e9).__next__
    trainer.ckpt.clock = lambda: FIXED


COMMON = dict(n_groups=4, redundancy=2, seq=16, total_steps=50)
# the moments after 6 steps: 1e-4 of the largest moment with fp32 buckets
# (the 1e-5 gradient tolerance compounded over the run); one int8
# quantum (1/127 of the largest synced gradient) with the int8 EF sync,
# where a value at a .5 boundary may round the other way
MOMENT_TOL = {"trainer": 1e-4, "mesh": 1 / 127}


def _jax_run(kind, path):
    params = jax.tree.map(jnp.asarray, _jax_params())
    if kind == "trainer":
        tr = JaxTrainer(jax_smoke(ARCH).scaled(**TINY), per_type_batch=2,
                        ckpt_dir=str(path), **COMMON)
        tr.params = params
        tr.opt_state = jax_adamw_init(params)
    else:
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                                 ("data", "model"))
        tr = JaxMeshExecutor(jax_smoke(ARCH).scaled(**TINY), mesh=mesh,
                             per_type_batch=1, grad_compress="int8_ef",
                             bucket_mb=0.01, ckpt_dir=str(path), **COMMON)
        tr.params = jax.device_put(params, tr._pshard)
        tr.opt_state = jax.device_put(jax_adamw_init(tr.params), tr._oshard)
    _fixed_clocks(tr)
    rep = tr.run(6, injector=JaxScripted(SCRIPT), snapshot_every=2)
    return tr, rep


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    runs = {}
    for kind in ("trainer", "mesh"):
        path = tmp_path_factory.mktemp(f"jax_{kind}")
        runs[kind] = (path,) + _jax_run(kind, path)
    return runs


def _event_fields(rep):
    return [(e.step, e.victims, e.wipeout, e.reordered, e.patch_count,
             e.s_a_before, e.s_a_after, e.rollback_depth)
            for e in rep.events]


@pytest.mark.parametrize("kind", ["trainer", "mesh"])
def test_trainer_with_ckpt_dir_matches_jax(kind, jax_runs, tmp_path,
                                           data_group):
    jpath, jt, want = jax_runs[kind]
    if kind == "trainer":
        tt = SpareTrainer(smoke_config(ARCH).scaled(**TINY), device="cpu",
                          per_type_batch=2, ckpt_dir=str(tmp_path),
                          **COMMON)
    else:
        tt = MeshExecutor(smoke_config(ARCH).scaled(**TINY), device="cpu",
                          per_type_batch=1, grad_compress="int8_ef",
                          bucket_mb=0.01, ckpt_dir=str(tmp_path), **COMMON)
    tt.params = params_from_numpy(_jax_params(), "cpu")
    tt.opt_state = adamw_init(tt.params)
    _fixed_clocks(tt)
    got = tt.run(6, injector=ScriptedInjector(SCRIPT), snapshot_every=2)

    assert want.wipeouts == 1 and want.ckpt_saves == 3
    assert _event_fields(got) == _event_fields(want)
    assert got.ckpt_saves == want.ckpt_saves
    assert got.steps_done == want.steps_done
    assert len(got.losses) == len(want.losses)
    for a, b in zip(got.losses, want.losses):
        assert abs(a - b) <= 1e-5 * abs(b)
    names = lambda p: sorted(d.name for d in p.iterdir())  # noqa: E731
    assert names(tmp_path) == names(jpath) == [
        "step_00000002", "step_00000004", "step_00000006"]
    # each package reads the other's last checkpoint
    live = (tt.params, tt.opt_state)
    jlive = (jt.params, jt.opt_state)
    s_port, port_own = restore_checkpoint(tmp_path, live)
    s_jax, port_of_jax = restore_checkpoint(jpath, live)
    _, jax_of_port = jax_restore(tmp_path, jlive)
    assert s_port == s_jax == 6 and port_of_jax[1].step == 6
    # params within 1e-5 (the tolerance of the port's training tests); the
    # moments, running averages of gradients that differ in summation
    # order, within MOMENT_TOL of their tree's largest value
    scale = {}
    for n, b in _flatten_with_names(port_of_jax):
        part = n.split("/")[0] if n[0] == "0" else n[:4]
        scale[part] = max(scale.get(part, 0.0),
                          float(np.abs(np.asarray(b, np.float64)).max()))
    for (n, a), (_, b), (_, c) in zip(_flatten_with_names(port_own),
                                      _flatten_with_names(port_of_jax),
                                      jax_names(jax_of_port)):
        a, b, c = (np.asarray(x, np.float64) for x in (a, b, c))
        assert np.array_equal(a, c), n
        diff = np.abs(a - b).max()
        if n[0] == "0":
            assert diff <= 1e-5, n
        elif n != "1/step":
            assert diff <= MOMENT_TOL[kind] * scale[n[:4]], n
        else:
            assert a == b == 6


# ------------------------------------------------------------------ #
# serving: the wipe-out reloads the params from the checkpoint       #
# ------------------------------------------------------------------ #
class _JaxF32Caches(JaxModel):
    """The JAX model with fp32 dense caches, so its engine's per-bucket
    write takes an fp32 prefill's caches (see tests/test_torch_serve.py)."""

    def init_decode_state(self, batch, s_max):
        return jax.tree.map(lambda t: t.astype(jnp.float32),
                            super().init_decode_state(batch, s_max))


def _rack_burst(pkg):
    """Both replicas in one rack: the first burst is a wipe-out."""
    topo, injector, params = pkg
    return injector({"kind": "correlated", "scope": "rack",
                     "burst_prob": 1.0, "mtbf": 400.0},
                    topo(n_groups=2, hosts_per_group=1, hosts_per_rack=2),
                    n_groups=2, seconds_per_step=100.0,
                    params=params(n=2, mtbf=400.0), seed=3)


def _served(server, model, params, path, injector, requests):
    ckpt = None
    if path is not None:
        ckpt = (JaxManager if server is JaxReplicaServer
                else CheckpointManager)(path, n_groups=2, redundancy=1,
                                        mtbf=1e6, t_save=1.0, t_restart=1.0)
    srv = server(model, params, n_replicas=2, injector=injector, ckpt=ckpt,
                 engine_kwargs=SERVE_ENGINE)
    srv.warmup()
    frozen = srv.recompiles
    for r in requests:
        srv.submit(r)
    done = srv.run()
    assert srv.recompiles == frozen, "the wipe-out reload rebuilt"
    return srv, {d.req_id: np.asarray(d.tokens) for d in done}


def test_wipeout_reloads_from_checkpoint(tmp_path, monkeypatch):
    """Every replica in one rack: the first burst wipes the server out;
    it reloads the params from the checkpoint it wrote at construction,
    requeues everything and completes every request with the healthy
    run's tokens and the JAX server's on the same (fp32) params."""
    jcfg = jax_smoke(ARCH)
    jm = _JaxF32Caches(cfg=jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.key(0)))
    tm = build_model(smoke_config(ARCH), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    requests = list(RequestStream(tm.cfg, buckets=(8,), max_new=4,
                                  seed=13).requests(4))
    _, healthy = _served(ReplicaServer, tm, tp, None, None, requests)
    reloads = []
    real = CheckpointManager.restore_latest

    def counted(self, tree_like):
        reloads.append(1)
        return real(self, tree_like)

    monkeypatch.setattr(CheckpointManager, "restore_latest", counted)
    srv, got = _served(ReplicaServer, tm, tp, tmp_path / "port",
                       _rack_burst((ClusterTopology, ScenarioInjector,
                                    DESParams)), requests)
    _, want = _served(JaxReplicaServer, jm, jp, tmp_path / "jax",
                      _rack_burst((JaxTopology, JaxInjector, JaxDESParams)),
                      requests)
    assert any(e.kind == "wipeout" for e in srv.events) and reloads
    assert srv.dropped == 0
    assert (tmp_path / "port" / "step_00000000").is_dir()
    assert got.keys() == healthy.keys() == want.keys() and len(got) == 4
    for rid in healthy:
        np.testing.assert_array_equal(got[rid], healthy[rid])
        np.testing.assert_array_equal(got[rid], want[rid])
    # the reload put fresh tensors of the params' dtype on their device
    assert srv.params is not tp
    _assert_same(srv.params, tp)
