"""The port's scenario bridge (``repro_torch.train.injection
.ScenarioInjector``) and the launchers' failure flags against the JAX
package's, on the CPU.

* Streams: for weibull arrivals, rack bursts, trace replay and a
  fail-slow model beside a kill stream, the same spec and seed give the
  same ``StepEvent`` stream (poll index, arrival time, victims), clock,
  window and ``group_step_seconds`` in both packages over 80 polls,
  through deaths and restarts.
* Trainer: one rack-burst regime through both packages' trainers (the
  tiny fp32 configuration of ``tests/test_torch_train.py``, the same
  parameters) gives identical reports and events, losses within 1e-5
  relative.
* Launchers: both CLIs with ``--failure-model``, ``--topology``,
  ``--seconds-per-step`` and ``--ckpt-dir`` on the CPU print the JAX
  launchers' report fields (failures, wipe-outs, events), apart from
  the losses and tokens of their own random initialisations.
"""
import json
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import smoke_config as jax_smoke
from repro.core.state import SpareState as JaxSpareState
from repro.des.params import DESParams as JaxDESParams
from repro.launch import serve as jax_serve_cli
from repro.launch import train as jax_train_cli
from repro.optim import adamw_init as jax_adamw_init
from repro.scenarios.topology import ClusterTopology as JaxTopology
from repro.train.injection import ScenarioInjector as JaxInjector
from repro.train.trainer import SpareTrainer as JaxTrainer
from repro_torch.configs import smoke_config
from repro_torch.core.state import SpareState
from repro_torch.des.params import DESParams
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model, params_from_numpy
from repro_torch.optim import adamw_init
from repro_torch.scenarios.topology import ClusterTopology
from repro_torch.train import ScenarioInjector, StepEvent
from repro_torch.train.trainer import SpareTrainer

ARCH = "qwen2.5-3b"
TINY = dict(head_dim=64, grad_accum=1)
#: 2 hosts a group, 4 a rack: every rack holds exactly 2 DP groups
TOPO = dict(n_groups=8, hosts_per_group=2, hosts_per_rack=4)
RACK_BURST = {"kind": "correlated", "scope": "rack", "burst_prob": 1.0,
              "mtbf": 400.0}
REGIMES = {
    "weibull": dict(model={"kind": "weibull", "mtbf": 400.0}),
    "rack_burst": dict(model=RACK_BURST),
    "trace_replay": dict(model={"kind": "trace",
                                "trace": "meta_hsdp_rackstorm",
                                "time_scale": 0.05}),
    "fail_slow": dict(model={"kind": "poisson", "mtbf": 2000.0},
                      slow_model={"kind": "fail_slow", "mtbs": 300.0}),
}


def _pair(regime, seed=11):
    kw = REGIMES[regime]
    ours = ScenarioInjector(kw["model"], ClusterTopology(**TOPO),
                            n_groups=8, params=DESParams(n=8, t_comp=64.0),
                            seed=seed, slow_model=kw.get("slow_model"))
    theirs = JaxInjector(kw["model"], JaxTopology(**TOPO), n_groups=8,
                         params=JaxDESParams(n=8, t_comp=64.0), seed=seed,
                         slow_model=kw.get("slow_model"))
    return ours, theirs


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_streams_match_jax(regime):
    ours, theirs = _pair(regime)
    st, jst = SpareState(8, 3), JaxSpareState(8, 3)
    events = 0
    for _ in range(80):
        a, b = ours.poll(st), theirs.poll(jst)
        assert [(e.step, e.time, e.victims) for e in a] == \
            [(e.step, e.time, e.victims) for e in b]
        assert all(isinstance(e, StepEvent) for e in a)
        assert ours.clock == theirs.clock
        assert ours.last_step_seconds == theirs.last_step_seconds
        assert np.array_equal(ours.group_step_seconds(),
                              theirs.group_step_seconds())
        for state in (st, jst):
            for e in a:
                state.alive[e.victims] = False
        events += len(a)
        if st.alive.sum() < 4:          # down: restart both sides
            for inj, state in ((ours, st), (theirs, jst)):
                inj.notify_outage(kind="restart")
                state.reset()
    assert events > 0
    assert ours.window_log == theirs.window_log
    for f in ("events_delivered", "victims_delivered",
              "slow_events_delivered", "outage_seconds", "step"):
        assert getattr(ours, f) == getattr(theirs, f), f
    if regime == "fail_slow":
        assert ours.slow_events_delivered > 0
    if regime in ("rack_burst", "trace_replay"):
        assert ours.victims_delivered > ours.events_delivered


def test_bridge_protocol_and_clock():
    inj = ScenarioInjector(RACK_BURST, ClusterTopology(**TOPO), n_groups=8,
                           seconds_per_step=100.0, seed=1)
    st = SpareState(8, 3)
    seen: set[int] = set()
    for _ in range(30):
        for ev in inj.poll(st):
            assert not set(ev.victims) & seen
            assert all(0 <= w < 8 for w in ev.victims)
            seen |= set(ev.victims)
            st.alive[ev.victims] = False
    assert inj.clock == pytest.approx(3000.0) and inj.step == 30
    # the plain protocol: one flattened victim list a call
    flat = ScenarioInjector(RACK_BURST, ClusterTopology(**TOPO), n_groups=8,
                            seconds_per_step=500.0, seed=1)
    got = [flat(SpareState(8, 3)) for _ in range(20)]
    assert all(isinstance(f, list) for f in got) and any(got)


def test_bridge_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="n_groups=16"):
        ScenarioInjector(RACK_BURST, ClusterTopology(n_groups=16),
                         n_groups=8)
    with pytest.raises(TypeError):
        ScenarioInjector({"kind": "poisson"}, None, n_groups=4,
                         slow_model={"kind": "poisson"})
    with pytest.raises(ValueError, match="positive"):
        ScenarioInjector({"kind": "poisson"}, None, n_groups=4,
                         seconds_per_step=0.0)


def test_notify_wipeout_rearms_past_the_outage():
    inj = ScenarioInjector({"kind": "poisson", "mtbf": 100.0}, n_groups=8,
                           seconds_per_step=64.0, seed=0)
    inj.clock = 640.0
    inj.notify_wipeout()
    assert inj.clock == pytest.approx(640.0 + inj.p.t_restart)
    assert inj._next_fail >= inj.clock
    inj.notify_outage(30.0, kind="reshape")
    assert inj.outage_seconds == pytest.approx(inj.p.t_restart + 30.0)


def test_slow_channel_does_not_perturb_kill_stream():
    """The slow model draws from its own generator (seed + 1): an idle
    slow stream leaves the kill stream's times and victims bit for bit."""
    def kills(slow_model):
        inj = ScenarioInjector({"kind": "poisson", "mtbf": 200.0},
                               ClusterTopology(n_groups=8, hosts_per_group=1,
                                               hosts_per_rack=2),
                               n_groups=8, seconds_per_step=64.0, seed=9,
                               slow_model=slow_model)
        st = SpareState(8, 2)
        return [(ev.time, tuple(ev.victims)) for _ in range(40)
                for ev in inj.poll(st)], inj

    plain, _ = kills(None)
    idle, inj = kills({"kind": "fail_slow", "mtbs": 1e9})
    assert plain and plain == idle and inj.slow_events_delivered == 0


# ------------------------------------------------------------------ #
# one regime through both trainers                                   #
# ------------------------------------------------------------------ #
def _params():
    model = build_model(smoke_config(ARCH).scaled(**TINY), device="cpu")
    return jax.tree.map(lambda t: t.float().numpy(), model.init(0))


def test_rack_burst_through_both_trainers():
    common = dict(n_groups=8, redundancy=3, seq=16, per_type_batch=1,
                  total_steps=50)
    params = _params()
    jt = JaxTrainer(jax_smoke(ARCH).scaled(**TINY), **common)
    jt.params = jax.tree.map(jnp.asarray, params)
    jt.opt_state = jax_adamw_init(jt.params)
    tt = SpareTrainer(smoke_config(ARCH).scaled(**TINY), device="cpu",
                      **common)
    tt.params = params_from_numpy(params, "cpu")
    tt.opt_state = adamw_init(tt.params)
    want = jt.run(12, injector=JaxInjector(
        RACK_BURST, JaxTopology(**TOPO), n_groups=8,
        params=JaxDESParams(n=8, t_comp=64.0), seed=3), snapshot_every=4)
    got = tt.run(12, injector=ScenarioInjector(
        RACK_BURST, ClusterTopology(**TOPO), n_groups=8,
        params=DESParams(n=8, t_comp=64.0), seed=3), snapshot_every=4)
    assert want.multi_group_events >= 1 and want.failures > 0
    for f in ("steps_done", "failures", "wipeouts", "reorders", "patches",
              "recompiles", "multi_group_events", "rollback_steps"):
        assert getattr(got, f) == getattr(want, f), f
    # every field but the measured controller and wall times
    fields = lambda r: [(e.step, e.victims, e.wipeout, e.reordered,  # noqa
                         e.patch_count, e.s_a_before, e.s_a_after,
                         e.rollback_depth, e.restart_seconds)
                        for e in r.events]
    assert fields(got) == fields(want)
    assert len(got.losses) == len(want.losses)
    for a, b in zip(got.losses, want.losses):
        assert abs(a - b) <= 1e-5 * abs(b)


# ------------------------------------------------------------------ #
# the launchers                                                      #
# ------------------------------------------------------------------ #
_FIELDS = re.compile(r"(failures|wipeouts|reshapes|reorders|patches|S_A|"
                     r"ckpts|events|multi_group|rollback_steps)=(\d+)")


def _train_fields(out: str) -> dict:
    return {k: int(v) for k, v in _FIELDS.findall(out)}


def _jax_main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    module.main()


@pytest.mark.parametrize("mesh", [False, True], ids=["emulated", "mesh"])
def test_train_cli_failure_flags_match_jax(mesh, tmp_path, capsys,
                                           monkeypatch):
    flags = ["--steps", "8", "--n-groups", "8", "-r", "3", "--seq", "16",
             "--per-type-batch", "1", "--failure-model",
             json.dumps(RACK_BURST), "--topology", json.dumps(TOPO),
             "--seconds-per-step", "64"]
    _jax_main(jax_train_cli, flags + ["--ckpt-dir", str(tmp_path / "j")],
              monkeypatch)
    want = capsys.readouterr().out
    port = flags + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "t")]
    if mesh:
        port += ["--mesh", "--grad-compress", "int8_ef"]
    assert train_cli.main(port) == 0
    got = capsys.readouterr().out
    assert "[train] done: " in got and "on cpu" in got
    assert _train_fields(want)["failures"] > 0
    assert _train_fields(got) == _train_fields(want)


def test_serve_cli_failure_flags_match_jax(tmp_path, capsys, monkeypatch):
    model = {"kind": "correlated", "scope": "rack", "burst_prob": 1.0,
             "mtbf": 400.0}
    flags = ["--arch", ARCH, "--replicas", "2", "--requests", "4",
             "--failure-model", json.dumps(model), "--topology",
             json.dumps(dict(n_groups=2, hosts_per_group=1,
                             hosts_per_rack=2)),
             "--seconds-per-step", "100"]
    _jax_main(jax_serve_cli, flags + ["--ckpt-dir", str(tmp_path / "j")],
              monkeypatch)
    want = json.loads(capsys.readouterr().out)
    # the failure model takes priority over --kill, as in the JAX CLI
    serve_cli.main(flags + ["--device", "cpu", "--ckpt-dir",
                            str(tmp_path / "t"), "--kill", "1:0"])
    got = json.loads(capsys.readouterr().out)
    assert any(e[1] == "wipeout" for e in want["events"])
    for f in ("events", "completed_requests", "alive", "replicas",
              "recompiles", "steps", "admitted", "completed"):
        assert got[f] == want[f], f
    assert (tmp_path / "t" / "step_00000000").is_dir()


def test_launch_config_widens_the_head_dim_only_on_the_card(monkeypatch):
    """The launchers run the JAX launchers' smoke configuration on every
    device: on a CUDA device the serve and train launchers build the same
    configuration as on the CPU, ``smoke_config(arch)`` (the train
    launcher's with one microbatch a stack slot), attention head dim 16
    (which K2 takes) included; an SSM config the same way."""
    from _launchers import launcher_configs

    for arch in (ARCH, "mamba2-1.3b"):
        want = [smoke_config(arch), smoke_config(arch).scaled(grad_accum=1)]
        assert launcher_configs(arch, "cuda", monkeypatch) == want
        assert launcher_configs(arch, "cpu", monkeypatch) == want
    assert smoke_config(ARCH).resolved_head_dim == 16
