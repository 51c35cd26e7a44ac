"""The port's gray-failure tier against the JAX package's, on the CPU.

* The straggler detector (``repro_torch.health.StragglerDetector``, a
  copy of the jax-free JAX module): fed the same timing streams (the
  dwell, hysteresis, warm-up, dead-group, reset and noisy streams of
  ``tests/test_health.py``), every ``HealthReport`` is identical to the
  JAX detector's: flags exactly, smoothed timings, z-scores and factors
  bit for bit (both are numpy).
* The trainer's tier: the demote / bit-identical re-admit, tolerate,
  global-restart and stale-snapshot cases of ``tests/test_health.py``
  through both packages' trainers (the tiny fp32 configuration of
  ``tests/test_torch_train.py``, the same parameters): identical
  ``health_log`` and events, the weight table after a re-admit
  bit-identical to an always-healthy run's, losses within 1e-5
  relative.
* Serving: a ``StragglerDetector`` routes around a flagged replica.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _groups import data_group  # noqa: F401 (a fixture)
from repro.configs import smoke_config as jax_smoke
from repro.core.state import SpareState as JaxSpareState
from repro.health import StragglerDetector as JaxDetector
from repro.optim import adamw_init as jax_adamw_init
from repro.train.injection import ScriptedInjector as JaxScripted
from repro.train.trainer import SpareTrainer as JaxTrainer
from repro.train.trainer import TrainReport as JaxReport
from repro_torch.configs import smoke_config
from repro_torch.core.state import SpareState
from repro_torch.data import RequestStream
from repro_torch.health import StragglerDetector
from repro_torch.models import build_model, params_from_numpy
from repro_torch.optim import adamw_init
from repro_torch.serve import ReplicaServer, pool_pages_for
from repro_torch.train import ScriptedInjector
from repro_torch.train.trainer import SpareTrainer, TrainReport

ARCH = "qwen2.5-3b"
TINY = dict(head_dim=64, grad_accum=1)
REPORT = ("steps_done", "failures", "wipeouts", "demotes", "readmits",
          "reorders", "patches", "recompiles")


# ------------------------------------------------------------------ #
# the detector                                                       #
# ------------------------------------------------------------------ #
def _slow(n=8, group=None, factor=3.0, base=64.0):
    x = np.full(n, base)
    if group is not None:
        x[group] *= factor
    return x


def _streams():
    """name -> (detector kwargs, [(timings, alive or None), ...])."""
    rng = np.random.default_rng(0)
    noisy = 64.0 * (1.0 + 0.01 * rng.standard_normal((20, 8)))
    noisy[8:, 5] *= 2.5
    dead = np.ones(8, bool)
    dead[3] = False
    band = _slow(group=1, factor=1.35)
    return {
        "dwell": ({}, [(_slow(), None)] * 4 + [(_slow(group=2), None)] * 10),
        "hysteresis": (dict(ewma_alpha=1.0),
                       [(_slow(group=1), None)] * 6 + [(band, None)] * 6
                       + [(_slow(), None)] * 6),
        "warmup": (dict(warmup=4, min_dwell=1),
                   [(_slow(group=0, factor=5.0), None)] * 6),
        "dead_group": (dict(ewma_alpha=1.0),
                       [(_slow(group=3), None)] * 6 + [(_slow(), dead)] * 3),
        "noisy": ({}, [(x, None) for x in noisy]),
        "reset": (dict(ewma_alpha=1.0),
                  [(_slow(group=0), None)] * 6 + ["reset"]
                  + [(_slow(group=0), None)] * 4),
    }


@pytest.mark.parametrize("name", sorted(_streams()))
def test_detector_reports_match_jax(name):
    kw, stream = _streams()[name]
    ours, theirs = StragglerDetector(8, **kw), JaxDetector(8, **kw)
    flagged = []
    for item in stream:
        if item == "reset":
            ours.reset()
            theirs.reset()
            assert ours.observations == theirs.observations == 0
            continue
        x, alive = item
        a = ours.observe(x, alive=alive)
        b = theirs.observe(x, alive=alive)
        assert (a.step, a.flagged, a.newly_flagged, a.newly_cleared) == \
            (b.step, b.flagged, b.newly_flagged, b.newly_cleared)
        for f in ("smoothed", "zscores", "factors"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        flagged.append(a.flagged)
    assert ours.flagged == theirs.flagged
    assert any(flagged)
    assert len(ours.reports) == len(theirs.reports)


def test_detector_rejects_what_jax_rejects():
    for kw in (dict(ewma_alpha=0.0), dict(flag_z=2.0, clear_z=3.0),
               dict(min_dwell=0)):
        for cls in (StragglerDetector, JaxDetector):
            with pytest.raises(ValueError):
                cls(4, **kw)
    with pytest.raises(ValueError):
        StragglerDetector(4).observe(np.ones(5))


# ------------------------------------------------------------------ #
# the trainer's gray-failure tier, both packages                     #
# ------------------------------------------------------------------ #
_PARAMS: dict = {}


def _params():
    if not _PARAMS:
        model = build_model(smoke_config(ARCH).scaled(**TINY), device="cpu")
        _PARAMS["p"] = jax.tree.map(lambda t: t.float().numpy(),
                                    model.init(0))
    return _PARAMS["p"]


def _pair(n_groups, det_kw, total_steps=64):
    """(JAX trainer, port trainer) on the same parameters, each with
    its own detector built from ``det_kw``."""
    common = dict(n_groups=n_groups, redundancy=2, seq=16,
                  per_type_batch=1, total_steps=total_steps)
    jt = JaxTrainer(jax_smoke(ARCH).scaled(**TINY),
                    detector=JaxDetector(n_groups, **det_kw), **common)
    jt.params = jax.tree.map(jnp.asarray, _params())
    jt.opt_state = jax_adamw_init(jt.params)
    tt = SpareTrainer(smoke_config(ARCH).scaled(**TINY), device="cpu",
                      detector=StragglerDetector(n_groups, **det_kw),
                      **common)
    tt.params = params_from_numpy(_params(), "cpu")
    tt.opt_state = adamw_init(tt.params)
    return jt, tt


def _events(rep):
    return [(e.step, e.victims, e.wipeout, e.reordered, e.patch_count,
             e.s_a_before, e.s_a_after, e.rollback_depth, e.demote,
             e.readmit, e.slow_factor) for e in rep.events]


def _same_schedule(a, b):
    for f in ("stacks", "alive", "supplier"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert int(a.s_a) == int(b.s_a)
    for x, y in zip(a.device_schedule(), b.device_schedule()):
        assert np.array_equal(x, y)


CASES = {
    # the JAX round trip: a 3x straggler at polls 4..15, detector defaults
    "demote_readmit": dict(n=8, det={}, steps=32,
                           slow={4: [(0, 3.0, 16)]}),
    # every group slow: nobody stands out, the policy tolerates
    "tolerate": dict(n=4, det=dict(ewma_alpha=1.0, warmup=1, min_dwell=1,
                                   clear_dwell=1), steps=8,
                     slow={2: [(g, 3.0, None) for g in range(4)]}),
}


@pytest.fixture(scope="module")
def jax_gray_runs():
    out = {}
    for name, case in CASES.items():
        jt, _ = _pair(case["n"], case["det"])
        inj = JaxScripted({}, seconds_per_step=64.0,
                          slow_schedule=case["slow"], n_groups=case["n"])
        out[name] = (jt, jt.run(case["steps"], injector=inj), inj)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_gray_tier_matches_jax(name, jax_gray_runs):
    case = CASES[name]
    jt, want, jinj = jax_gray_runs[name]
    _, tt = _pair(case["n"], case["det"])
    inj = ScriptedInjector({}, seconds_per_step=64.0,
                           slow_schedule=case["slow"], n_groups=case["n"])
    got = tt.run(case["steps"], injector=inj)
    for f in REPORT:
        assert getattr(got, f) == getattr(want, f), f
    assert _events(got) == _events(want)
    assert tt.health_log == jt.health_log
    assert inj.window_log == jinj.window_log
    assert len(got.losses) == len(want.losses)
    for a, b in zip(got.losses, want.losses):
        assert abs(a - b) <= 1e-5 * abs(b)
    _same_schedule(tt.state, jt.state)
    if name == "demote_readmit":
        assert got.demotes == 1 and got.readmits == 1
        dem = next(e for e in got.events if e.demote)
        assert dem.victims == [0] and dem.s_a_after > dem.s_a_before
        assert tt.health_log[0]["action"] == "demote"
        assert not tt._demoted and tt._demote_snapshot is None
        # the re-admitted weight table is an always-healthy run's, bit
        # for bit
        _same_schedule(tt.state, SpareState(8, 2))
        assert sum(1 for w in inj.window_log if w > 64.0) < 12
    else:
        assert got.demotes == 0 and got.wipeouts == 0
        assert all(h["action"] == "tolerate" for h in tt.health_log)


def _flagged_detector(cls, group):
    det = cls(8, ewma_alpha=1.0)
    for _ in range(6):
        det.observe(_slow(group=group))
    return det


def test_global_restart_clears_gray_state_as_jax():
    jt, tt = _pair(8, dict(ewma_alpha=1.0))
    for tr, cls, rep in ((jt, JaxDetector, JaxReport),
                         (tt, StragglerDetector, TrainReport)):
        tr.detector = _flagged_detector(cls, 0)
        inj = (JaxScripted if tr is jt else ScriptedInjector)(
            {}, seconds_per_step=64.0, n_groups=8)
        tr._demote([0], tr.detector.reports[-1], inj, rep())
        assert tr._demoted == {0} and not tr.state.alive[0]
        ver = tr._schedule_version
        tr._global_restart()
        assert not tr._demoted and tr._demote_snapshot is None
        assert tr.state.alive.all() and int(tr.state.s_a) == 1
        assert tr.detector.observations == 0
        assert tr._schedule_version > ver
    _same_schedule(tt.state, jt.state)


def test_stale_snapshot_rebuilds_on_readmit_as_jax():
    """A failure while a group is demoted makes the demotion snapshot
    stale: the re-admit rebuilds from a clean reset and replays the
    still-dead set, in both packages alike."""
    jt, tt = _pair(8, dict(ewma_alpha=1.0))
    for tr, cls, rep in ((jt, JaxDetector, JaxReport),
                         (tt, StragglerDetector, TrainReport)):
        tr.detector = _flagged_detector(cls, 2)
        hr = tr.detector.reports[-1]
        inj = (JaxScripted if tr is jt else ScriptedInjector)(
            {}, seconds_per_step=64.0, n_groups=8)
        tr._demote([2], hr, inj, rep())
        tr.scheme.recover(tr.state, [5], step=0)
        tr._schedule_version += 1
        tr._readmit([2], hr, inj, rep())
        tr.state.assert_invariants()
        assert bool(tr.state.alive[2]) and not bool(tr.state.alive[5])
    _same_schedule(tt.state, jt.state)
    ref = SpareState(8, 2)
    tt.scheme.recover(ref, [5], step=0)
    _same_schedule(tt.state, ref)
    jref = JaxSpareState(8, 2)
    jt.scheme.recover(jref, [5], step=0)
    _same_schedule(ref, jref)


# ------------------------------------------------------------------ #
# serving: detector-weighted routing                                 #
# ------------------------------------------------------------------ #
def test_serve_routes_around_flagged_replica():
    cfg = smoke_config(ARCH)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    det = StragglerDetector(3, ewma_alpha=1.0, warmup=1, min_dwell=1,
                            clear_dwell=1)
    inj = ScriptedInjector({}, seconds_per_step=1.0,
                           slow_schedule={0: [(1, 4.0, None)]}, n_groups=3)
    srv = ReplicaServer(
        model, params, n_replicas=3, injector=inj, detector=det,
        engine_kwargs=dict(n_slots=2, page_size=4, max_new=4, buckets=(8,),
                           n_pages=pool_pages_for(2, 8 + 4, 4)))
    srv.warmup()
    for _ in range(3):
        srv.step()
    assert det.flagged == (1,)
    assert srv.weights[1] == 0.0
    assert srv.weights[0] > 0 and srv.weights[2] > 0
    assert any(e.kind == "slow" and e.victims == [1] for e in srv.events)
    for r in RequestStream(cfg, buckets=(8,), max_new=4,
                           seed=3).requests(6):
        srv.submit(r)
    assert srv.engines[1].pending + srv.engines[1].in_flight == 0
    done = srv.run()
    assert len(done) == 6 and srv.dropped == 0
    rep = srv.report()
    assert rep["flagged_slow"] == [1] and rep["health_factors"][1] > 2.0


def test_mesh_demote_roundtrip_zero_recompiles(data_group):
    """The MeshExecutor on a one-rank gloo group, both stack depths
    registered ahead of the run: detect, demote and re-admit are
    weight-table edits that count no recompile, and the run ends on an
    always-healthy run's weight table (the JAX package's spmd case)."""
    from repro_torch.exec import MeshExecutor
    from repro_torch.des import get_scheme

    ex = MeshExecutor(smoke_config(ARCH).scaled(**TINY), device="cpu",
                      n_groups=8, redundancy=2, seq=16, per_type_batch=1,
                      total_steps=16,
                      scheme=get_scheme("adaptive", r=2, initial="spare"),
                      detector=StragglerDetector(8, ewma_alpha=1.0, warmup=1,
                                                 min_dwell=1, clear_dwell=1))
    ex.prewarm_depths([1, 2])
    with pytest.raises(ValueError, match="outside"):
        ex.prewarm_depths([3])
    inj = ScriptedInjector({}, seconds_per_step=64.0,
                           slow_schedule={2: [(0, 3.0, 7)]}, n_groups=8)
    rep = ex.run(12, injector=inj, snapshot_every=10)
    assert rep.steps_done == 12
    assert rep.demotes == 1 and rep.readmits == 1
    assert rep.recompiles == 0
    _same_schedule(ex.state, SpareState(8, 2))
