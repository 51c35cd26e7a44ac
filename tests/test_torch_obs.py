"""The port's train-path telemetry against the JAX package's, on the CPU.

* The trace analyzer (``python -m repro_torch.launch.obs``, a copy of
  the jax-free JAX CLI): a traced port run (a scripted masked kill and a
  wipe-out, through the trainer and through the mesh executor) passes
  ``--assert-coverage 0.95 --assert-recovery-markers``, and its
  attribution rows (step, kind, victims, rollback depth, S_A, modeled
  restart) equal the JAX trace's of the same scripted run, times aside;
  both CLIs print the same tables and exit with the same codes on the
  same trace.
* Wire gauges: a masked and a healthy schedule at the same ``S_A``
  publish identical ``sync.*`` gauges, for the fp32 and the int8 EF
  syncs; the int8 EF wire bytes are at most 0.3x the fp32 ones (the
  JAX package's gate on its HLO audit; here the sync's own count).
* Deep mode: the EF residual norms equal the residuals' norms, and the
  sync's spans cover every bucket of every step.
* The prefetch thread: the batches fed to the steps are bit-identical
  to the synchronous build across a masked kill and a rollback; hits
  count up, and ``close()`` releases the thread.
* The training CLI: ``--trace`` writes a trace the analyzer passes;
  ``--sweep-regimes --device cpu --steps N --trace DIR`` exits 0 and
  writes one trace (and metrics snapshot) per regime.
"""
import copy
import json

import jax
import numpy as np
import pytest
import torch

from _groups import data_group  # noqa: F401 (a fixture)
from repro.configs import smoke_config as jax_smoke
from repro.exec import MeshExecutor as JaxMeshExecutor
from repro.launch import obs as jax_obs_cli
from repro.obs import Telemetry as JaxTelemetry
from repro.train.injection import ScriptedInjector as JaxScripted
from repro.train.trainer import SpareTrainer as JaxTrainer
from repro_torch.configs import smoke_config
from repro_torch.core import Rectlr, SpareState
from repro_torch.data import spare_batch_rows
from repro_torch.des import get_scheme
from repro_torch.exec import MeshExecutor
from repro_torch.launch import obs as obs_cli
from repro_torch.launch import train as train_cli
from repro_torch.obs import Telemetry, load_trace
from repro_torch.train import ScriptedInjector
from repro_torch.train.trainer import SpareTrainer

ARCH = "qwen2.5-3b"
TINY = dict(head_dim=64, grad_accum=1)
COMMON = dict(n_groups=8, redundancy=2, seq=16, per_type_batch=1,
              total_steps=50)
STEPS = 8


def _script(n=8, r=2):
    """Group 0 at poll 2 (masked), then at poll 5 the first single
    group whose loss wipes the system out."""
    state = SpareState(n, r)
    assert not get_scheme("spare", r=r).recover(state, [0]).wipeout
    wiping = next(g for g in range(1, n) if get_scheme("spare", r=r).recover(
        copy.deepcopy(state), [g]).wipeout)
    return {2: [0], 5: [wiping]}


def _port_run(kind, path):
    tel = Telemetry()
    cls = MeshExecutor if kind == "mesh" else SpareTrainer
    tr = cls(smoke_config(ARCH).scaled(**TINY), device="cpu",
             telemetry=tel, **COMMON)
    rep = tr.run(STEPS, injector=ScriptedInjector(_script()),
                 snapshot_every=4)
    tel.dump_trace(path)
    return rep


def _jax_run(kind, path):
    tel = JaxTelemetry()
    if kind == "mesh":
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                                 ("data", "model"))
        tr = JaxMeshExecutor(jax_smoke(ARCH).scaled(**TINY), mesh=mesh,
                             telemetry=tel, **COMMON)
    else:
        tr = JaxTrainer(jax_smoke(ARCH).scaled(**TINY), telemetry=tel,
                        **COMMON)
    rep = tr.run(STEPS, injector=JaxScripted(_script()), snapshot_every=4)
    tel.dump_trace(path)
    return rep


def _rows(path):
    keep = ("step", "kind", "victims", "rollback_depth", "restart_s",
            "reshape_s", "dp", "s_a")
    return [{k: r[k] for k in keep}
            for r in obs_cli.attribution_table(load_trace(path))]


@pytest.mark.parametrize("kind", ["trainer", "mesh"])
def test_traced_run_passes_the_gates_and_matches_jax(kind, tmp_path,
                                                     capsys, data_group):
    ours, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    rep, jrep = _port_run(kind, ours), _jax_run(kind, theirs)
    assert (rep.failures, rep.wipeouts) == (jrep.failures, jrep.wipeouts)
    assert rep.failures == 2 and rep.wipeouts == 1
    assert obs_cli.main([str(ours), "--assert-coverage", "0.95",
                         "--assert-recovery-markers"]) == 0
    assert _rows(ours) == _rows(theirs)
    assert [r["kind"] for r in _rows(ours)] == ["mask", "restart"]
    ana, jana = (obs_cli.analyze(load_trace(p)) for p in (ours, theirs))
    assert ana["failure_markers"] == jana["failure_markers"] == 2
    assert ana["failure_tracks"] == jana["failure_tracks"]
    assert ana["coverage"] >= 0.95
    assert {p["phase"] for p in ana["phases"]} == \
        {p["phase"] for p in jana["phases"]}
    if kind == "mesh":      # the feeding thread's span, as in JAX
        assert "feed" in {p["phase"] for p in ana["phases"]}


@pytest.fixture(scope="module")
def jax_trace(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "jax.json"
    _jax_run("trainer", path)
    return path


@pytest.mark.parametrize("flags,rc", [
    ([], 0),
    (["--timeline", "5", "--assert-coverage", "0.95",
      "--assert-recovery-markers"], 0),
    (["--assert-coverage", "1.01"], 1)])
def test_both_clis_print_the_same_tables(flags, rc, jax_trace, tmp_path,
                                         capsys):
    """The port's analyzer reads a JAX trace as the JAX analyzer does,
    and a quiet trace fails ``--assert-recovery-markers`` in both."""
    path = jax_trace
    got = obs_cli.main([str(path), *flags])
    out = capsys.readouterr()
    want = jax_obs_cli.main([str(path), *flags])
    jout = capsys.readouterr()
    assert got == want == rc
    assert (out.out, out.err) == (jout.out, jout.err)
    quiet = Telemetry()
    with quiet.span("step"):
        pass
    quiet.dump_trace(tmp_path / "quiet.json")
    for cli in (obs_cli, jax_obs_cli):
        assert cli.main([str(tmp_path / "quiet.json"),
                         "--assert-recovery-markers"]) == 1


# ------------------------------------------------------------------ #
# the executor: wire gauges, deep mode, prefetch, the step cache     #
# ------------------------------------------------------------------ #
def _executor(tel=None, **kw):
    kw = {**COMMON, "n_groups": 4, **kw}
    return MeshExecutor(smoke_config(ARCH).scaled(**TINY), device="cpu",
                        telemetry=tel, bucket_mb=0.25, **kw)


def _wire(compress):
    """One step each at the same S_A: a masked schedule, then a healthy
    one."""
    tel = Telemetry(trace=False)
    ex = _executor(tel, grad_compress=compress)
    masked = SpareState(4, 2)
    Rectlr().on_failures(masked, [0])
    healthy = SpareState(4, 2)
    healthy.s_a = masked.s_a            # same depth => same batch shapes
    readings = {}
    for label, st in (("masked", masked), ("healthy", healthy)):
        ex.state = st
        ex.run(1)
        g = tel.snapshot()["gauges"]
        readings[label] = (g["sync.wire_bytes_per_step"],
                           g["sync.collectives_per_step"])
    total = tel.snapshot()["counters"]["sync.wire_bytes_total"]
    ex.close()
    return readings, total, ex._layout


@pytest.mark.parametrize("compress", [None, "int8_ef"])
def test_masked_and_healthy_publish_the_same_wire_gauges(compress,
                                                         data_group):
    readings, total, layout = _wire(compress)
    assert readings["masked"] == readings["healthy"]
    nbytes, count = readings["healthy"]
    assert total == 2 * nbytes
    if compress is None:        # one all-reduce a bucket, twice its bytes
        assert count == layout.n_buckets
        assert nbytes == 2 * 4 * layout.n_elems
    else:                       # all_to_all, then three all_gathers
        assert count == 4 * layout.n_buckets


def test_int8_ef_moves_at_most_three_tenths_of_fp32(data_group):
    fp32, _, _ = _wire(None)
    int8, _, _ = _wire("int8_ef")
    ratio = int8["healthy"][0] / fp32["healthy"][0]
    assert ratio <= 0.3
    assert ratio == pytest.approx(0.25, abs=0.01)


def test_deep_mode_norms_and_bucket_spans(tmp_path, data_group):
    tel = Telemetry(deep=True)
    ex = _executor(tel, grad_compress="int8_ef")
    ex.run(3)
    g = tel.snapshot()["gauges"]
    for fam in ("err1", "err2"):
        want = float(torch.sqrt(sum((b.double() ** 2).sum()
                                    for b in ex._ef_state[fam])))
        assert g[f"sync.ef_residual_norm.{fam}"] == \
            pytest.approx(want, rel=1e-6)
    # one rank: the stage-2 chunk is one rank's exact dequantization, so
    # only the stage-1 residual is non-zero
    assert g["sync.ef_residual_norm.err1"] > 0
    ex.close()
    tel.dump_trace(tmp_path / "deep.json")
    view = load_trace(tmp_path / "deep.json")
    assert len(view.track_spans("sync", depth=0)) == 3
    nb = ex._layout.n_buckets
    assert sorted(s.name for s in view.track_spans("sync", depth=1)) == \
        sorted([f"bucket/{i}" for i in range(nb)] * 3)
    # not deep: no sync spans, no norms
    tel = Telemetry()
    ex = _executor(tel, grad_compress="int8_ef")
    ex.run(1)
    ex.close()
    assert "sync.ef_residual_norm.err1" not in tel.snapshot()["gauges"]
    tel.dump_trace(tmp_path / "plain.json")
    assert not load_trace(tmp_path / "plain.json").track_spans("sync")


def test_prefetched_batches_equal_the_synchronous_build(data_group):
    """A masked kill (poll 2) and a wipe-out (poll 5) with snapshots
    every 4 steps: every batch a step got equals the rows built
    synchronously from that step's schedule, bit for bit; the prefetch
    hits on the quiet steps and misses after each recovery."""
    tel = Telemetry(trace=False)
    ex = _executor(tel, n_groups=8)
    fed = []
    step_fn = ex._step_fn

    def recording(params, opt_state, batch):
        fed.append((ex.step, ex.state.s_a, ex.state.device_schedule(),
                    {k: v.clone() for k, v in batch.items()}))
        return step_fn(params, opt_state, batch)

    ex._step_fn = recording
    rep = ex.run(STEPS, injector=ScriptedInjector(_script()),
                 snapshot_every=4)
    assert rep.wipeouts == 1 and len(fed) == rep.steps_done
    lo, hi = ex._rows()
    for step, s_a, schedule, batch in fed:
        want = spare_batch_rows(ex.pipeline, schedule, s_a, step, lo, hi)
        assert batch.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(batch[k], torch.from_numpy(v)), (step, k)
    counters = tel.snapshot()["counters"]
    # misses: the first step, the step after the mask and the replay
    assert counters["feed.prefetch_misses"] == 3
    assert counters["feed.prefetch_hits"] == rep.steps_done - 3
    assert ex._prefetch is None           # dropped at the end of the run
    ex.close()
    assert ex._feed_pool._shutdown
    assert not any(t.is_alive() for t in ex._feed_pool._threads)


def test_stale_prefetch_never_feeds_a_step(data_group):
    """A recovery between the prefetch and the next build: the slab
    prefetched for the old schedule is dropped."""
    tel = Telemetry(trace=False)
    ex = _executor(tel, n_groups=8)
    ex._prefetch_next()                   # for step 1, healthy schedule
    ex.step = 1
    ex.scheme.recover(ex.state, [0])
    ex._schedule_version += 1
    got = ex._device_batch()
    lo, hi = ex._rows()
    want = spare_batch_rows(ex.pipeline, ex.state.device_schedule(),
                            ex.state.s_a, 1, lo, hi)
    for k, v in want.items():
        assert torch.equal(got[k], torch.from_numpy(v))
    assert tel.snapshot()["counters"]["feed.prefetch_misses"] == 1
    ex.close()


def test_step_cache_keys_and_recompiles(data_group):
    """Keys ``(data, model, s_a)``; registering ahead counts toward
    ``total_recompiles`` only; a run counts the depths it meets."""
    ex = _executor(n_groups=8)
    ex.prewarm_depths([1])
    assert ex.cache_keys == [(1, 1, 1)] and ex.compiled_depths == [1]
    assert ex.total_recompiles == 1
    rep = ex.run(4, injector=ScriptedInjector({1: [0]}))
    assert ex.state.s_a == 2 and rep.recompiles == 1
    assert ex.cache_keys == [(1, 1, 1), (1, 1, 2)]
    assert ex.compiled_depths == [1, 2] and ex.total_recompiles == 2
    ex.close()


def test_the_trainer_keys_its_step_cache_by_depth():
    """The plain trainer shares the executor's cache logic with its own
    key, ``s_a``: a run registers each depth it meets once, counting it
    in ``report.recompiles`` and ``total_recompiles``."""
    trainer = SpareTrainer(smoke_config(ARCH).scaled(**TINY),
                           device="cpu", **COMMON)
    tel = Telemetry()
    trainer.telemetry = tel
    rep = trainer.run(4, injector=ScriptedInjector({1: [0]}))
    assert trainer.state.s_a == 2 and sorted(trainer._jitted) == [1, 2]
    assert rep.recompiles == 2 and trainer.total_recompiles == 2
    assert tel.snapshot()["counters"]["train.recompiles"] == 2


# ------------------------------------------------------------------ #
# the training CLI                                                   #
# ------------------------------------------------------------------ #
def test_train_cli_trace_passes_the_gates(tmp_path, capsys):
    path = str(tmp_path / "run.json")
    assert train_cli.main(["--device", "cpu", "--steps", "6",
                           "--n-groups", "6", "-r", "2", "--seq", "16",
                           "--mtbf-steps", "2", "--mesh", "--trace",
                           path]) == 0
    assert "[train] trace -> " in capsys.readouterr().out
    assert obs_cli.main([path, "--assert-coverage", "0.95",
                         "--assert-recovery-markers"]) == 0
    metrics = json.loads(open(path + ".metrics.json").read())
    assert metrics["gauges"]["sync.collectives_per_step"] > 0
    assert metrics["counters"]["feed.prefetch_hits"] > 0


def test_sweep_cli_writes_one_trace_per_regime(tmp_path, capsys):
    out = tmp_path / "traces"
    report = tmp_path / "rows.json"
    assert train_cli.main(["--sweep-regimes", "--device", "cpu", "--steps",
                           "6", "--trace", str(out), "--report-json",
                           str(report)]) == 0
    text = capsys.readouterr().out
    labels = ("weibull", "rack_burst", "trace_rackstorm")
    for label in labels:
        assert (out / f"{label}.trace.json").exists()
        assert (out / f"{label}.trace.json.metrics.json").exists()
        assert f"[sweep] {label}: steps=" in text
    assert "[sweep] total multi-group kill batches" in text
    rows = json.loads(report.read_text())
    assert [r["model"] for r in rows] == list(labels)
    assert all(r["steps_done"] >= 6 for r in rows)
