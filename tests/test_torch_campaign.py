"""The port's campaign runner (``repro_torch.scenarios.campaign``,
``repro_torch.launch.campaign``) and Monte-Carlo validation
(``repro_torch.core.montecarlo``) against the JAX package's, on the CPU.

* DES grids: the ``smoke`` preset's CSV and JSON artifacts are
  byte-identical to the JAX package's, and the port's are byte-identical
  at one and two (spawned) workers; every preset expands to the JAX
  package's cell keys and seeds; the CLIs print the same lines.
* Monte-Carlo: ``run_montecarlo`` equals the JAX package's field for
  field (exact: the same numpy draws), uniform and through correlated
  failure models over a topology.
* Live cells: one trainer cell through both packages, each runner's
  trainer started from the same parameters (the test swaps each
  package's ``SpareTrainer`` for a subclass that carries them in), gives
  the same event counts and its first and last losses within 1e-5
  relative; both gray arms through both packages' mesh
  executors give every row field equal but ``elapsed_s`` and the losses.
  The JAX executor runs on a one-device ``(data, model)`` mesh: the test
  swaps the reference module's ``make_emulated_mesh`` for one that makes
  it (nothing in the JAX package is edited).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.exec.executor as jax_executor_mod
import repro.train.trainer as jax_trainer_mod
import repro_torch.train.trainer as trainer_mod
from repro.core.montecarlo import run_montecarlo as jax_montecarlo
from repro.launch import campaign as jax_campaign_cli
from repro.optim import adamw_init as jax_adamw_init
from repro.scenarios import campaign as jax_campaign
from repro_torch.configs import smoke_config
from repro_torch.core import run_montecarlo
from repro_torch.exec import MeshExecutor
from repro_torch.launch import campaign as campaign_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model, params_from_numpy
from repro_torch.optim import adamw_init
from repro_torch.scenarios import campaign
from repro_torch.scenarios.topology import ClusterTopology

ARCH = "qwen2.5-3b"


# ------------------------------------------------------------------ #
# DES grids                                                          #
# ------------------------------------------------------------------ #
def _artifacts(mod, results, outdir):
    return [p.read_bytes() for p in mod.save_artifacts("grid", results,
                                                       outdir=outdir)]


def test_artifacts_default_to_the_ports_own_directory(tmp_path,
                                                      monkeypatch):
    """Without ``outdir`` the port writes under the checkout's
    ``results/campaign/``, never into the JAX package's
    ``benchmarks/results/``."""
    from pathlib import Path

    root = Path(campaign.__file__).resolve().parents[3]
    assert campaign.ARTIFACTS_DIR == root / "results" / "campaign"
    monkeypatch.setattr(campaign, "ARTIFACTS_DIR", tmp_path / "default")
    paths = campaign.save_artifacts("grid", [])
    assert paths == (tmp_path / "default" / "grid.csv",
                     tmp_path / "default" / "grid.json")
    assert all(p.is_file() for p in paths)


@pytest.fixture(scope="module")
def smoke_results():
    cells = campaign.CAMPAIGN_PRESETS["smoke"].cells()
    return campaign.run_campaign(cells, jobs=1)


def test_smoke_artifacts_are_the_jax_packages_bytes(smoke_results,
                                                    tmp_path):
    """Exact bytes: the same cells, seeds, DES and formatting."""
    want = jax_campaign.run_campaign(
        jax_campaign.CAMPAIGN_PRESETS["smoke"].cells(), jobs=1)
    assert _artifacts(campaign, smoke_results, tmp_path / "port") == \
        _artifacts(jax_campaign, want, tmp_path / "jax")


def test_artifacts_do_not_depend_on_the_pool(smoke_results, tmp_path):
    """Two spawned workers give the one-process run's bytes."""
    cells = campaign.CAMPAIGN_PRESETS["smoke"].cells()
    pooled = campaign.run_campaign(cells, jobs=2)
    assert _artifacts(campaign, pooled, tmp_path / "two") == \
        _artifacts(campaign, smoke_results, tmp_path / "one")
    assert [r["key"] for r in pooled] == sorted(r["key"] for r in pooled)


@pytest.mark.parametrize("preset", sorted(jax_campaign.CAMPAIGN_PRESETS))
@pytest.mark.parametrize("base_seed", [0, 7])
def test_presets_expand_to_the_jax_cells_and_seeds(preset, base_seed):
    spec = campaign.CAMPAIGN_PRESETS[preset]
    jspec = jax_campaign.CAMPAIGN_PRESETS[preset]
    assert spec.name == jspec.name
    cells, jcells = spec.cells(), jspec.cells()
    assert [campaign.cell_key(c) for c in cells] == \
        [jax_campaign.cell_key(c) for c in jcells]
    assert [campaign.cell_seed(c, base_seed) for c in cells] == \
        [jax_campaign.cell_seed(c, base_seed) for c in jcells]


def test_spec_from_json_and_parallel_map(tmp_path):
    path = tmp_path / "mine.json"
    path.write_text('{"schemes": ["spare", ["replication", {"r": 2}]], '
                    '"ns": [100], "rs": [3], "steps": 50}')
    cells = campaign.CampaignSpec.from_json(path).cells()
    assert cells == jax_campaign.CampaignSpec.from_json(path).cells()
    assert campaign.CampaignSpec.from_json(path).name == "mine"
    args = [(20, 2, 5, s) for s in range(3)]
    one = campaign.parallel_map(run_montecarlo, args, jobs=1)
    two = campaign.parallel_map(run_montecarlo, args, jobs=2)
    assert [vars(a) for a in one] == [vars(b) for b in two]


@pytest.mark.parametrize("argv", [["--list"],
                                  ["--preset", "smoke", "--seeds", "1",
                                   "--steps", "120"]])
def test_campaign_cli_prints_the_jax_clis_lines(argv, tmp_path, capsys):
    outdir = ["--outdir", str(tmp_path / "port")] if "--list" not in argv \
        else []
    campaign_cli.main(argv + outdir)
    ours = capsys.readouterr().out
    joutdir = ["--outdir", str(tmp_path / "jax")] if outdir else []
    jax_campaign_cli.main(argv + joutdir)
    theirs = capsys.readouterr().out
    assert ours == theirs and ours
    if outdir:
        for name in ("campaign_smoke.csv", "campaign_smoke.json"):
            assert (tmp_path / "port" / name).read_bytes() == \
                (tmp_path / "jax" / name).read_bytes()


# ------------------------------------------------------------------ #
# Monte-Carlo (paper App. C)                                         #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("n,r,trials,seed,model", [
    (20, 2, 30, 0, None),
    (40, 3, 20, 5, None),
    (7, 3, 10, 1, None),                   # a perfect difference set
    (32, 3, 20, 2, {"kind": "correlated", "scope": "rack",
                    "burst_prob": 0.5}),
    (32, 2, 10, 3, "weibull"),
])
def test_montecarlo_matches_jax(n, r, trials, seed, model):
    topo = None
    if model is not None:
        topo = ClusterTopology(n_groups=n, hosts_per_group=2,
                               hosts_per_rack=4)
    ours = run_montecarlo(n, r, trials=trials, seed=seed,
                          failure_model=model, topology=topo)
    jtopo = None
    if topo is not None:
        from repro.scenarios.topology import ClusterTopology as JaxTopology
        jtopo = JaxTopology(n_groups=n, hosts_per_group=2, hosts_per_rack=4)
    theirs = jax_montecarlo(n, r, trials=trials, seed=seed,
                            failure_model=model, topology=jtopo)
    a, b = vars(ours), vars(theirs)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], float) and np.isnan(a[k]):
            assert np.isnan(b[k]), k
        else:
            assert a[k] == b[k], k


# ------------------------------------------------------------------ #
# live cells                                                         #
# ------------------------------------------------------------------ #
#: what a trainer cell's report must share across packages
COUNTS = ("model", "n", "r", "steps_done", "failures", "wipeouts",
          "reorders", "patches", "recovery_events", "multi_group_events",
          "rollback_steps", "final_s_a", "key")


def _carried(cls, params, init, opt_init):
    """``cls`` whose parameters, once built, are ``params`` (numpy, as
    ``init`` makes them the package's), with fresh AdamW state."""
    class Carried(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.params = init(params)
            self.opt_state = opt_init(self.params)
    return Carried


def test_trainer_cell_matches_jax(monkeypatch):
    """The rack-burst regime, 12 steps: a masked multi-group event, the
    §3.1 check after each (error within the trainer's 1e-2). Both
    runners start from the same parameters (carried into each package's
    trainer with ``params_from_numpy`` and ``jnp.asarray``): the first
    and last losses agree within 1e-5 relative."""
    cfg = smoke_config(ARCH).scaled(grad_accum=1)
    params = jax.tree.map(lambda t: t.float().numpy(),
                          build_model(cfg, device="cpu").init(0))
    monkeypatch.setattr(trainer_mod, "SpareTrainer", _carried(
        trainer_mod.SpareTrainer, params,
        lambda p: params_from_numpy(p, "cpu"), adamw_init))
    monkeypatch.setattr(jax_trainer_mod, "SpareTrainer", _carried(
        jax_trainer_mod.SpareTrainer, params,
        lambda p: jax.tree.map(jnp.asarray, p), jax_adamw_init))
    cell = campaign.trainer_regime_cells(steps=12)[1]
    assert cell == jax_campaign.trainer_regime_cells(steps=12)[1]
    ours = campaign.run_trainer_cell(cell, device="cpu")
    theirs = jax_campaign.run_trainer_cell(cell)
    assert ours.keys() == theirs.keys()
    assert {k: ours[k] for k in COUNTS} == {k: theirs[k] for k in COUNTS}
    assert ours["multi_group_events"] >= 1 and ours["wipeouts"] == 0
    assert 0 < ours["max_grad_check_err"] <= 1e-2
    for k in ("loss_first", "loss_last"):
        assert ours[k] == pytest.approx(theirs[k], rel=1e-5)


def _one_device_mesh(n_groups, model_degree):
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


GRAY = dict(steps=16, slow_step=1, heal_step=5)


def test_gray_arms_match_jax(monkeypatch):
    """Tolerate and demote (flagged and demoted at step 4, re-admitted
    bit for bit at 14, no run recompile); every row field equal but the
    wall time and the losses."""
    monkeypatch.setattr(jax_executor_mod, "make_emulated_mesh",
                        _one_device_mesh)
    cells = campaign.gray_regime_cells(**GRAY)
    assert cells == jax_campaign.gray_regime_cells(**GRAY)
    rows = {}
    for cell in cells:
        ours = campaign.run_gray_cell(cell, device="cpu")
        theirs = jax_campaign.run_gray_cell(cell)
        assert ours.keys() == theirs.keys()
        skip = ("elapsed_s", "loss_first", "loss_last")
        assert {k: v for k, v in ours.items() if k not in skip} == \
            {k: v for k, v in theirs.items() if k not in skip}
        rows[cell["arm"]] = ours
    dm, tol = rows["demote"], rows["tolerate"]
    assert dm["demotes"] == dm["readmits"] == 1 and dm["readmit_identical"]
    assert dm["recompiles"] == 0 and dm["total_recompiles"] == 2
    assert dm["ttt_s"] < tol["ttt_s"]


@pytest.mark.parametrize("model_degree", [1, 2])
def test_elastic_cells_are_the_jax_cells_and_do_not_run(tmp_path,
                                                        model_degree):
    """The cells are the JAX package's, on one rank a group and on a
    grid of two ranks a group; they run on the port's ranks
    (tests/test_torch_elastic.py, tests/test_torch_elastic_grid.py), and
    not without a card on the default device."""
    kw = dict(trace_dir=str(tmp_path), model_degree=model_degree)
    cells = campaign.elastic_regime_cells(**kw)
    assert cells == jax_campaign.elastic_regime_cells(**kw)
    assert [c["arm"] for c in cells] == ["mask", "reshape", "restart"]
    assert [c["elastic"] for c in cells] == [True, True, False]
    assert {c["model_degree"] for c in cells} == {model_degree}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            campaign.run_elastic_cell(cells[1])


def test_live_cells_run_on_the_card_by_default():
    """No live cell falls back to the CPU: without a card the default
    device raises, in the runners and in the training CLI's sweep."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        campaign.run_trainer_cell(campaign.trainer_regime_cells()[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        campaign.run_gray_cell(campaign.gray_regime_cells()[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        campaign.run_elastic_cell(campaign.elastic_regime_cells()[1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--sweep-regimes", "--steps", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--mesh", "--elastic", "--steps", "2"])


def test_executor_takes_model_degree_one_only():
    """On one rank the executor's grid has model degree 1 only; the
    campaign's live cells at ``model_degree`` 2 run on a grid of spawned
    ranks instead (a gray cell on one data row of two ranks, an elastic
    cell on two rows of two)."""
    cfg = smoke_config(ARCH).scaled(head_dim=64, grad_accum=1)
    with pytest.raises(ValueError, match="do not tile a grid"):
        MeshExecutor(cfg, n_groups=4, redundancy=2, model_degree=2,
                     device="cpu")
    gray = campaign.gray_regime_cells(model_degree=2, n=4, steps=4,
                                      slow_step=1, heal_step=3)[0]
    row = campaign.run_gray_cell(gray, device="cpu", cfg=cfg)
    assert row["steps_done"] == 4 and row["n"] == 4
    cell = campaign.elastic_regime_cells(n=2, r=1, model_degree=2,
                                         steps=4, fail_step=2)[2]
    row = campaign.run_elastic_cell(cell, device="cpu", cfg=cfg)
    assert (row["failures"], row["wipeouts"], row["dp_final"]) == (2, 1, 2)
    assert len(row["run"]["per_rank"]) == 4
    assert {tuple(k[:2]) for k in row["run"]["cache_keys"]} == {(2, 2)}
