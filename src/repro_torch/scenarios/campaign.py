"""Campaign runner: declarative scenario grids, process-parallel, deterministic
(the PyTorch port's counterpart of ``repro.scenarios.campaign``).

A *campaign* sweeps scheme x scale x redundancy x failure-regime x seed
and aggregates every cell's :class:`repro_torch.des.SimResult` into
byte-stable CSV/JSON artifacts, byte-identical to the JAX package's for
the same grid:

* grids are declarative (:class:`CampaignSpec` or JSON files — see
  ``python -m repro_torch.launch.campaign``);
* cells fan out across a ``ProcessPoolExecutor`` whose workers are
  *spawned*, not forked (a fork of a process that has initialised CUDA
  is unsafe); each cell derives its RNG seed from a SHA-256 of its own
  key (:func:`cell_seed`) and results are sorted by key, so a 4-worker
  run is byte-identical to a 1-worker run of the same grid;
* wall-clock timings are reported separately (stderr / ``timing`` keys)
  and never enter the deterministic artifacts.

The live half drives the port's trainer through the same cells as the
JAX package: :func:`run_trainer_cell` (the injection-bridge sweep over
:class:`repro_torch.train.trainer.SpareTrainer`),
:func:`run_elastic_cell` (mask vs reshape vs restart, one rank per SPARe
group) and :func:`run_gray_cell` (tolerate vs demote on the
:class:`repro_torch.exec.MeshExecutor`), on ``cuda`` unless asked for
the CPU.

Cells are plain dicts (picklable, JSON-serializable); the worker entry
point :func:`run_cell` is module-level so the pool can import it.
"""
from __future__ import annotations

import csv
import dataclasses
import hashlib
import io
import json
import multiprocessing
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

from ..des import DESParams, get_scheme
from ..des.engine import run_scheme
from .models import model_from_spec
from .topology import topology_from_spec

__all__ = [
    "ScenarioCell", "CampaignSpec", "CAMPAIGN_PRESETS",
    "cell_seed", "run_cell", "run_campaign", "parallel_map",
    "aggregate", "ranking_by_regime", "save_artifacts",
    "TRAINER_REGIME_MODELS", "trainer_regime_cells", "run_trainer_cell",
    "elastic_regime_cells", "run_elastic_cell", "run_elastic_cells",
    "gray_regime_cells", "run_gray_cell",
]

#: SimResult fields copied into each cell's result row (all deterministic)
RESULT_FIELDS = ("wall", "committed", "t0", "steps_done", "node_failures",
                 "wipeouts", "ckpt_count", "total_stacks", "patches",
                 "mode_switches")
DERIVED_FIELDS = ("ttt_norm", "availability", "avg_stacks")

#: cells without per-scheme redundancy (the r grid does not apply)
_R_FREE_SCHEMES = ("ckpt_only",)


# ------------------------------------------------------------------ #
# cells                                                              #
# ------------------------------------------------------------------ #
def _canon(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def cell_key(cell: dict) -> str:
    """Canonical identity of a cell: every field that affects its
    simulation, in sorted-key JSON (stable across processes/platforms).
    ``base_seed`` is excluded — it salts the seed hash separately, so a
    raw ``spec.cells()`` dict and the same cell inside ``run_campaign``
    hash identically."""
    ident = {k: cell[k] for k in sorted(cell)
             if k not in ("label", "base_seed")}
    return _canon(ident)


def cell_seed(cell: dict, base_seed: int = 0) -> int:
    """Deterministic per-cell RNG seed: SHA-256 of the cell key, folded
    with the grid's seed axis. Independent of worker count, execution
    order, and ``PYTHONHASHSEED``."""
    digest = hashlib.sha256(
        f"{cell_key(cell)}|{base_seed}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & 0x7FFF_FFFF


@dataclass
class ScenarioCell:
    """One point of the grid (kept as a dataclass for discoverability;
    the pool ships the ``as_dict`` form)."""

    scheme: str
    n: int
    model: dict
    seed: int
    steps: int
    r: int | None = None
    scheme_kwargs: dict = field(default_factory=dict)
    mtbf: float | None = None
    topology: object = None
    t_c: float | None = None
    max_wall: float | None = None

    def as_dict(self) -> dict:
        d = {"scheme": self.scheme, "n": self.n, "model": self.model,
             "seed": self.seed, "steps": self.steps}
        if self.r is not None:
            d["r"] = self.r
        if self.scheme_kwargs:
            d["scheme_kwargs"] = dict(self.scheme_kwargs)
        if self.mtbf is not None:
            d["mtbf"] = self.mtbf
        if self.topology is not None:
            topo = self.topology
            if dataclasses.is_dataclass(topo) and not isinstance(topo, type):
                topo = dataclasses.asdict(topo)   # JSON/key-stable form
            d["topology"] = topo
        if self.t_c is not None:
            d["t_c"] = self.t_c
        if self.max_wall is not None:
            d["max_wall"] = self.max_wall
        return d


@dataclass
class CampaignSpec:
    """Declarative grid: the cross product of every axis, with the ``r``
    axis skipped for redundancy-free schemes (``ckpt_only``).

    ``schemes`` entries are names or ``(name, kwargs)`` pairs; ``models``
    entries are ``{"kind": ..., "label": ..., **kwargs}`` specs
    (``label`` names the regime in artifacts and rankings).
    """

    name: str
    schemes: list = field(default_factory=lambda: ["spare"])
    ns: list[int] = field(default_factory=lambda: [200])
    rs: list[int] = field(default_factory=lambda: [9])
    models: list = field(default_factory=lambda: [{"kind": "weibull"}])
    seeds: list[int] = field(default_factory=lambda: [0])
    steps: int = 400
    mtbf: float | None = None
    topology: object = None
    base_seed: int = 0

    def cells(self) -> list[dict]:
        out = []
        for scheme in self.schemes:
            if isinstance(scheme, (tuple, list)):
                sname, skw = scheme[0], dict(scheme[1])
            else:
                sname, skw = scheme, {}
            if "r" in skw:                  # pinned r beats the r axis
                rs = [skw.pop("r")]
            elif sname in _R_FREE_SCHEMES:
                rs = [None]
            else:
                rs = self.rs
            for n in self.ns:
                for model in self.models:
                    spec = model if isinstance(model, dict) \
                        else {"kind": model}
                    for r in rs:
                        for seed in self.seeds:
                            cell = ScenarioCell(
                                scheme=sname, n=n, model=dict(spec),
                                seed=seed, steps=self.steps, r=r,
                                scheme_kwargs=skw, mtbf=self.mtbf,
                                topology=self.topology).as_dict()
                            cell["base_seed"] = self.base_seed
                            out.append(cell)
        return out

    @classmethod
    def from_json(cls, path: str | Path) -> "CampaignSpec":
        data = json.loads(Path(path).read_text())
        data.setdefault("name", Path(path).stem)
        return cls(**data)


# ------------------------------------------------------------------ #
# execution                                                          #
# ------------------------------------------------------------------ #
def run_cell(cell: dict) -> dict:
    """Worker entry point: simulate one cell, return a flat result dict.

    The only nondeterministic key is ``elapsed_s`` (wall-clock), which
    :func:`aggregate` strips from the artifacts.
    """
    params_kw = {"n": cell["n"], "steps": cell["steps"]}
    if cell.get("mtbf") is not None:
        params_kw["mtbf"] = cell["mtbf"]
    p = DESParams(**params_kw)
    topo = topology_from_spec(cell.get("topology"), n_groups=cell["n"]) \
        if cell.get("topology") is not None else None
    model = model_from_spec(cell["model"])
    skw = dict(cell.get("scheme_kwargs") or {})
    if cell.get("r") is not None:
        skw.setdefault("r", cell["r"])
    scheme = get_scheme(cell["scheme"], **skw)

    seed = cell_seed(cell, base_seed=cell.get("base_seed", 0))
    t0 = time.perf_counter()
    res = run_scheme(scheme, p, seed=seed, t_c=cell.get("t_c"),
                     max_wall=cell.get("max_wall"),
                     failure_model=model, topology=topo)
    elapsed = time.perf_counter() - t0

    row = {
        "key": cell_key(cell),
        "scheme": cell["scheme"],
        "n": cell["n"],
        "r": cell.get("r"),
        "model": cell["model"].get("label", cell["model"]["kind"]),
        "seed": cell["seed"],
        "cell_seed": seed,
    }
    for f in RESULT_FIELDS:
        row[f] = getattr(res, f)
    for f in DERIVED_FIELDS:
        row[f] = getattr(res, f)
    row["elapsed_s"] = elapsed
    return row


def _pool(jobs: int) -> ProcessPoolExecutor:
    """A pool of ``jobs`` spawned workers: a forked child of a process
    that has initialised CUDA is unsafe, and the cells need nothing the
    parent holds (each rebuilds its inputs from the cell dict)."""
    return ProcessPoolExecutor(
        max_workers=jobs, mp_context=multiprocessing.get_context("spawn"))


def run_campaign(cells: list[dict], jobs: int = 1,
                 base_seed: int | None = None) -> list[dict]:
    """Run every cell, serially (``jobs <= 1``) or across a pool of
    spawned processes. Results are ordered by cell key, so the output is
    independent of worker count and completion order. ``base_seed``
    overrides each cell's own salt when given; ``None`` keeps what the
    grid set."""
    if base_seed is not None:
        cells = [dict(c, base_seed=base_seed) for c in cells]
    if jobs <= 1:
        results = [run_cell(c) for c in cells]
    else:
        with _pool(jobs) as ex:
            results = list(ex.map(run_cell, cells, chunksize=1))
    results.sort(key=lambda r: r["key"])
    return results


def parallel_map(fn, argtuples: list[tuple], jobs: int = 1) -> list:
    """Order-preserving (possibly process-parallel) starmap for
    non-campaign workloads — e.g. the Monte-Carlo benchmark cells.
    ``fn`` must be importable by name (the workers are spawned)."""
    if jobs <= 1:
        return [fn(*args) for args in argtuples]
    with _pool(jobs) as ex:
        futs = [ex.submit(fn, *args) for args in argtuples]
        return [f.result() for f in futs]


# ------------------------------------------------------------------ #
# aggregation / artifacts                                            #
# ------------------------------------------------------------------ #
_CSV_COLUMNS = ("scheme", "n", "r", "model", "seed", "cell_seed",
                *RESULT_FIELDS, *DERIVED_FIELDS)


def _fmt(v) -> str:
    if isinstance(v, float):
        return repr(v)              # full precision, deterministic
    if v is None:
        return ""
    return str(v)


def aggregate(results: list[dict]) -> tuple[str, dict]:
    """Deterministic artifacts: ``(csv_text, json_obj)``. Timings are
    excluded — identical grids give identical bytes at any ``--jobs``."""
    buf = io.StringIO()
    w = csv.writer(buf, lineterminator="\n")
    w.writerow(_CSV_COLUMNS)
    for row in results:
        w.writerow([_fmt(row[c]) for c in _CSV_COLUMNS])
    clean = [{k: v for k, v in row.items() if k != "elapsed_s"}
             for row in results]
    obj = {
        "cells": clean,
        "ranking": ranking_by_regime(results),
    }
    return buf.getvalue(), obj


def ranking_by_regime(results: list[dict]) -> dict:
    """Per ``(n, model)`` regime: schemes ranked by mean normalized
    time-to-train over seeds (and r points) — the regime-dependent
    policy ordering the adaptive scheme must track."""
    groups: dict[tuple, dict[str, list[float]]] = {}
    for row in results:
        regime = (row["n"], row["model"])
        groups.setdefault(regime, {}).setdefault(
            row["scheme"], []).append(row["ttt_norm"])
    out = {}
    for (n, model), by_scheme in sorted(groups.items()):
        scored = sorted(
            ((sum(v) / len(v), s) for s, v in by_scheme.items()))
        out[f"n={n}/{model}"] = [
            {"scheme": s, "mean_ttt_norm": score} for score, s in scored]
    return out


#: where :func:`save_artifacts` writes by default: the checkout's
#: ``results/campaign/``, the port's own (the JAX package writes
#: ``benchmarks/results/``)
ARTIFACTS_DIR = Path(__file__).resolve().parents[3] / "results" / "campaign"


def save_artifacts(name: str, results: list[dict],
                   outdir: str | Path | None = None) -> tuple[Path, Path]:
    """Write ``<name>.csv`` + ``<name>.json`` under ``outdir`` (default:
    :data:`ARTIFACTS_DIR`). Returns the two paths."""
    outdir = Path(ARTIFACTS_DIR if outdir is None else outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    csv_text, obj = aggregate(results)
    csv_path = outdir / f"{name}.csv"
    json_path = outdir / f"{name}.json"
    csv_path.write_text(csv_text)
    json_path.write_text(_canon(obj) + "\n")
    return csv_path, json_path


# ------------------------------------------------------------------ #
# live-trainer cells (the injection-bridge sweep)                    #
# ------------------------------------------------------------------ #
#: the three scenario-engine regimes at trainer scale: MTBFs sized so a tiny
#: (~40-step, ~64 s/step) run sees several events, including
#: multi-group rack bursts; the trace regime replays the HSDP-style
#: storm log compressed to the same horizon
TRAINER_REGIME_MODELS = [
    {"kind": "weibull", "label": "weibull", "mtbf": 350.0},
    {"kind": "correlated", "label": "rack_burst", "scope": "rack",
     "burst_prob": 0.5, "mtbf": 450.0},
    {"kind": "trace", "label": "trace_rackstorm",
     "trace": "meta_hsdp_rackstorm", "time_scale": 0.1},
]


def trainer_regime_cells(arch: str = "qwen2.5-3b", n: int = 8, r: int = 3,
                         steps: int = 40, seq: int = 32,
                         per_type_batch: int = 1,
                         models: list | None = None, topology=None,
                         seconds_per_step: float | None = None,
                         base_seed: int = 0,
                         trace_dir: str | None = None) -> list[dict]:
    """The live-trainer campaign preset: one cell per failure regime,
    tiny config, rack-dominated topology (2 hosts/group, 4 hosts/rack =>
    2 groups per rack, so rack kills are genuine multi-group batches).
    ``topology`` may be a preset name or a spec dict. ``trace_dir``
    turns telemetry on per cell (one Perfetto trace per regime)."""
    if topology is None:
        topology = {"n_groups": n, "hosts_per_group": 2,
                    "hosts_per_rack": 4}
    cells = []
    for model in (models if models is not None else TRAINER_REGIME_MODELS):
        cell = {
            "kind": "trainer", "arch": arch, "n": n, "r": r,
            "steps": steps, "seq": seq, "per_type_batch": per_type_batch,
            "model": dict(model),
            "topology": (dict(topology) if isinstance(topology, dict)
                         else topology),
            "seed": 0, "base_seed": base_seed,
        }
        if seconds_per_step is not None:
            cell["seconds_per_step"] = seconds_per_step
        if trace_dir is not None:
            label = model.get("label", model["kind"])
            cell["trace"] = str(Path(trace_dir) / f"{label}.trace.json")
        cells.append(cell)
    return cells


def _live_setup(cell: dict, device, cfg):
    """The device and model configuration of a live cell: ``cfg`` as
    given, else the JAX runners' smoke configuration with one
    microbatch per stack slot, on every device. Neither enters the cell,
    so :func:`cell_key` is the JAX package's. Raises on ``cuda``
    without a card: nothing falls back to the CPU."""
    from ..configs import smoke_config
    from ..models import resolve_device

    dev = resolve_device(device)
    if cfg is None:
        cfg = smoke_config(cell.get("arch", "qwen2.5-3b")).scaled(
            grad_accum=1)
    return dev, cfg


def _model_degree(cell: dict) -> int:
    """The cell's ``model_degree`` key (default 1): the model axis of
    the grid of ranks a live cell runs on, ``n`` (elastic) or one
    (gray) data rows of that many ranks."""
    return int(cell.get("model_degree", 1))


def _cell_telemetry(cell: dict):
    """Telemetry for a cell with a ``trace`` path, else ``None``."""
    if not cell.get("trace"):
        return None
    from ..obs import Telemetry
    return Telemetry()


def _dump_telemetry(tel, cell: dict) -> None:
    """The cell's Perfetto trace at ``cell["trace"]`` and its metrics
    snapshot beside it at ``<trace>.metrics.json``."""
    if tel is not None:
        tel.dump_trace(cell["trace"])
        tel.metrics.dump(str(cell["trace"]) + ".metrics.json")


def run_trainer_cell(cell: dict, *, device="cuda", cfg=None) -> dict:
    """Worker entry point for live-trainer cells: drive the port's
    :class:`repro_torch.train.trainer.SpareTrainer` on ``device``
    through the cell's failure regime via the injection bridge,
    verifying the §3.1 gradient invariant after every successful
    recovery. ``cfg`` overrides the model configuration (the card runs
    full width through it). ``cell["trace"]`` (a path) turns telemetry
    on and dumps the run's Perfetto trace there (metrics snapshot
    alongside at ``<trace>.metrics.json``). The row has the JAX
    runner's fields."""
    from ..train.injection import ScenarioInjector
    from ..train.trainer import SpareTrainer

    dev, cfg = _live_setup(cell, device, cfg)
    seed = cell_seed(cell, base_seed=cell.get("base_seed", 0))
    topo = topology_from_spec(cell.get("topology"), n_groups=cell["n"])
    injector = ScenarioInjector(
        cell["model"], topo, n_groups=cell["n"],
        seconds_per_step=cell.get("seconds_per_step"), seed=seed)
    tel = _cell_telemetry(cell)
    trainer = SpareTrainer(
        cfg, n_groups=cell["n"], redundancy=cell["r"],
        seq=cell.get("seq", 32),
        per_type_batch=cell.get("per_type_batch", 1), seed=seed,
        total_steps=cell["steps"], telemetry=tel, device=dev)
    t0 = time.perf_counter()
    rep = trainer.run(cell["steps"], injector=injector,
                      verify_equivalence=cell.get("verify", True))
    elapsed = time.perf_counter() - t0
    _dump_telemetry(tel, cell)
    return {
        "key": cell_key(cell),
        "model": cell["model"].get("label", cell["model"]["kind"]),
        "n": cell["n"], "r": cell["r"],
        "steps_done": rep.steps_done,
        "failures": rep.failures,
        "wipeouts": rep.wipeouts,
        "reorders": rep.reorders,
        "patches": rep.patches,
        "recovery_events": len(rep.events),
        "multi_group_events": rep.multi_group_events,
        "rollback_steps": rep.rollback_steps,
        "max_grad_check_err": rep.max_grad_check_err,
        "final_s_a": int(trainer.state.s_a),
        "loss_first": rep.losses[0] if rep.losses else None,
        "loss_last": rep.losses[-1] if rep.losses else None,
        "elapsed_s": elapsed,
    }


# ------------------------------------------------------------------ #
# elastic cells (mask vs reshape vs restart on the live mesh)        #
# ------------------------------------------------------------------ #
def elastic_regime_cells(arch: str = "qwen2.5-3b", n: int = 8, r: int = 2,
                         steps: int = 24, fail_step: int = 8,
                         seq: int = 32, per_type_batch: int = 2,
                         model_degree: int = 1,
                         seconds_per_step: float = 64.0,
                         t_reshape: float = 60.0,
                         t_restart: float = 3600.0,
                         snapshot_every: int = 10,
                         grad_compress: str | None = "int8_ef",
                         trace_dir: str | None = None) -> list[dict]:
    """The third-regime campaign: the SAME deterministic failure clock
    hits three recovery tiers on the live data-parallel group
    (:func:`run_elastic_cell`).

    * ``mask`` — a single-group kill at ``fail_step``: RECTLR masks it,
      training continues at full DP (the free tier);
    * ``reshape`` — an adjacent-pair kill (unmaskable at r=2, every
      adjacent pair is a wiping set) on the elastic executor: the TTT
      policy continues degraded on a survivor submesh;
    * ``restart`` — the identical unmaskable kill on the plain executor:
      wipe-out rollback + modeled cluster restart, the only pre-elastic
      option.

    All arms run the adaptive scheme (pinned to SPARe masking) so the
    reshape decision flows through
    :meth:`~repro_torch.des.schemes.AdaptiveScheme.decide_unmaskable`.
    """
    arms = [
        ("mask", [0], True),
        ("reshape", [0, 1], True),
        ("restart", [0, 1], False),
    ]
    cells = []
    for arm, victims, elastic in arms:
        cell = {
            "kind": "elastic", "arm": arm, "arch": arch, "n": n, "r": r,
            "steps": steps, "fail_step": fail_step, "victims": victims,
            "elastic": elastic, "seq": seq,
            "per_type_batch": per_type_batch,
            "model_degree": model_degree,
            "seconds_per_step": seconds_per_step,
            "t_reshape": t_reshape, "t_restart": t_restart,
            "snapshot_every": snapshot_every,
            "grad_compress": grad_compress,
        }
        if trace_dir is not None:
            cell["trace"] = str(Path(trace_dir) / f"{arm}.trace.json")
        cells.append(cell)
    return cells


def run_elastic_cell(cell: dict, *, device="cuda", cfg=None) -> dict:
    """Worker entry point for elastic cells: one deterministic failure
    burst through one recovery tier, with the work-normalized TTT the
    arms are compared on.

    The cell runs on a grid of ``cell["n"]`` data rows, one per SPARe
    group, of ``cell["model_degree"]`` ranks each, every rank a process
    of its own on ``device`` (:func:`repro_torch.launch.mesh
    .spawn_ranks`; ranks that share a card do so over gloo): the
    :class:`~repro_torch.elastic.ElasticMeshExecutor` for the elastic
    arms, the plain :class:`~repro_torch.exec.MeshExecutor` for the
    restart arm. ``cfg`` as in :func:`run_trainer_cell`; a cell with a
    ``trace`` is traced on every rank and written by the one that ends
    at (logical row 0, model 0).

    ``work_units`` counts committed FULL-batch step equivalents: a step
    at DP degree d contributes ``d / n`` (degraded steps cover fewer
    examples), wiped-out steps contribute nothing. ``ttt_s`` is the
    modeled time to ``steps`` work units: the injector clock (outages
    included) plus the remaining deficit at the end-state rate.

    The row has the JAX runner's fields, plus ``run`` (which the
    comparison with the JAX package skips): the group's backend, every
    loss of the run, the step-cache keys and, per rank, its kernels'
    launch counts, peak device memory (on a card) and its host resident
    set at the end of the run."""
    return run_elastic_cells([cell], device=device, cfg=cfg)[0]


def run_elastic_cells(cells: list, *, device="cuda", cfg=None) -> list:
    """:func:`run_elastic_cell` for several cells of one grid, ``n``
    rows of ``model_degree`` ranks, in turn on one set of ranks, spawned
    once: a rank's process pays its start (imports, the CUDA context,
    the kernels' first launches) once for all of them. The rows, in the
    cells' order."""
    from ..launch.mesh import spawn_ranks

    if len({(c["n"], _model_degree(c)) for c in cells}) != 1:
        raise ValueError("the cells of one spawn need one size n and one "
                         "model degree")
    dev, cfg = _live_setup(cells[0], device, cfg)
    world = cells[0]["n"] * _model_degree(cells[0])
    rows, backend = spawn_ranks(elastic_cells_on_ranks, world,
                                device=dev, args=(cells, cfg, str(dev)))
    for row in rows:
        row["run"]["backend"] = backend
    return rows


def rss_gib() -> float:
    """This process's resident set now, GiB (``VmRSS``: ``ru_maxrss``
    may carry the peak of the parent a rank was forked from, and not
    every kernel reports ``VmHWM``)."""
    with open("/proc/self/status") as f:
        kib = next(int(line.split()[1]) for line in f
                   if line.startswith("VmRSS"))
    return kib / (1 << 20)


def elastic_cells_on_ranks(rank: int, world: int, cells: list, cfg,
                           device: str) -> list:
    """What each rank of :func:`run_elastic_cells` runs: the cells in
    turn over the default group, of ``cell["n"] * cell["model_degree"]``
    ranks, already up (for a caller that brings its own ranks, as under
    :func:`repro_torch.launch.mesh.spawn_ranks`). Every rank returns the
    rows, without the backend; ``cfg`` must be given."""
    import gc

    rows = []
    for cell in cells:
        gc.collect()        # the previous cell's executor and snapshot
        rows.append(_elastic_cell_rank(world, cell, cfg, device))
    return rows


def _elastic_cell_rank(world: int, cell: dict, cfg, device: str) -> dict:
    """One cell on this rank (the process's earlier cells freed)."""
    import torch
    import torch.distributed as dist

    from ..elastic import ElasticMeshExecutor
    from ..exec import MeshExecutor
    from ..kernels import ops
    from ..train.injection import ScriptedInjector

    tel = _cell_telemetry(cell)
    n, steps = cell["n"], cell["steps"]
    sps = cell["seconds_per_step"]
    kw = dict(n_groups=n, redundancy=cell["r"],
              model_degree=_model_degree(cell),
              seq=cell.get("seq", 32),
              per_type_batch=cell.get("per_type_batch", 2),
              total_steps=steps, t_restart=cell.get("t_restart", 3600.0),
              grad_compress=cell.get("grad_compress"),
              scheme=get_scheme("adaptive", r=cell["r"], initial="spare"),
              telemetry=tel, device=device)
    ops.reset_launches()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    if cell["elastic"]:
        ex = ElasticMeshExecutor(cfg, t_reshape=cell["t_reshape"], **kw)
    else:
        ex = MeshExecutor(cfg, **kw)
    try:
        inj = ScriptedInjector({cell["fail_step"]: list(cell["victims"])},
                               seconds_per_step=sps)
        t0 = time.perf_counter()
        rep = ex.run(steps, injector=inj,
                     snapshot_every=cell.get("snapshot_every", 10))
        elapsed = time.perf_counter() - t0

        # committed work: degraded steps pro-rated, wiped steps discounted
        work = float(rep.steps_done)
        for e in rep.events:
            if e.reshape:
                work -= (steps - e.step) * (1.0 - e.dp_after / n)
            if e.wipeout:
                work -= e.rollback_depth
        dp_end = int(ex.state.n)
        deficit = max(float(steps) - work, 0.0)
        ttt = inj.clock + deficit * sps * (n / dp_end)

        if ex.rank == 0 and ex.model_rank == 0:
            _dump_telemetry(tel, cell)
        row = {
            "key": cell_key(cell),
            "arm": cell["arm"],
            "n": n, "r": cell["r"],
            "dp_final": dp_end,
            "steps_done": rep.steps_done,
            "failures": rep.failures,
            "wipeouts": rep.wipeouts,
            "reshapes": rep.reshapes,
            "recompiles": rep.recompiles,
            "compiled_entries": len(ex.cache_keys),
            "rollback_steps": rep.rollback_steps,
            "outage_s": inj.outage_seconds,
            "elapsed_model_s": inj.clock,
            "work_units": work,
            "ttt_s": ttt,
            "policy": (ex.policy_log[-1] if getattr(ex, "policy_log", None)
                       else None),
            "loss_first": rep.losses[0] if rep.losses else None,
            "loss_last": rep.losses[-1] if rep.losses else None,
            "elapsed_s": elapsed,
        }
        keys = [list(k) for k in ex.cache_keys]
        # before the executor goes: its snapshot and gloo's staging held
        rss = rss_gib()
    finally:
        ex.close()
    mine = {"launches": dict(ops.launches),
            "peak_gib": (torch.cuda.max_memory_allocated() / (1 << 30)
                         if on_card else None),
            "rss_gib": rss}
    every = [None] * world
    dist.all_gather_object(every, mine)
    row["run"] = {"losses": list(rep.losses), "per_rank": every,
                  "cache_keys": keys}
    return row


# ------------------------------------------------------------------ #
# gray-failure cells (tolerate vs demote under the same fail-slow)   #
# ------------------------------------------------------------------ #
def gray_regime_cells(arch: str = "qwen2.5-3b", n: int = 8, r: int = 2,
                      steps: int = 32, slow_group: int = 0,
                      slow_factor: float = 3.0, slow_step: int = 4,
                      heal_step: int = 16, seq: int = 32,
                      per_type_batch: int = 2, model_degree: int = 1,
                      seconds_per_step: float = 64.0,
                      t_restart: float = 3600.0,
                      snapshot_every: int = 10,
                      trace_dir: str | None = None) -> list[dict]:
    """The gray-failure campaign: the SAME scripted fail-slow episode
    (one DP group degraded ``slow_factor`` x for poll windows
    ``[slow_step, heal_step)``) through two mitigation arms on the live
    mesh executor.

    * ``tolerate`` — no detector: every synchronous step stretches to
      the straggler's pace (the barrier makes one slow group everyone's
      problem);
    * ``demote`` — a :class:`repro_torch.health.StragglerDetector` flags the
      group, the adaptive scheme's ``decide_degraded`` picks proactive
      SPARe demotion (a pure weight-table edit), and the group is
      re-admitted bit-identically once the episode heals.

    Both arms run the adaptive scheme pinned to SPARe masking; no group
    ever actually dies, so any TTT gap is pure gray-failure handling.
    """
    arms = [("tolerate", False), ("demote", True)]
    cells = []
    for arm, detect in arms:
        cell = {
            "kind": "gray", "arm": arm, "arch": arch, "n": n, "r": r,
            "steps": steps, "detect": detect,
            "slow_group": slow_group, "slow_factor": slow_factor,
            "slow_step": slow_step, "heal_step": heal_step,
            "seq": seq, "per_type_batch": per_type_batch,
            "model_degree": model_degree,
            "seconds_per_step": seconds_per_step,
            "t_restart": t_restart, "snapshot_every": snapshot_every,
        }
        if trace_dir is not None:
            cell["trace"] = str(Path(trace_dir) / f"{arm}.trace.json")
        cells.append(cell)
    return cells


def run_gray_cell(cell: dict, *, device="cuda", cfg=None) -> dict:
    """Worker entry point for gray cells: one scripted fail-slow episode
    through one mitigation arm on the port's
    :class:`repro_torch.exec.MeshExecutor` on ``device``: over the
    default process group where one is up that tiles a grid of model
    degree ``cell["model_degree"]`` (the caller's ranks), else on one
    data row of ``model_degree`` ranks carrying the cell's ``n`` groups
    (one rank in this process at degree 1; spawned ranks above,
    :func:`repro_torch.launch.mesh.spawn_ranks`, whose rank 0's row is
    returned),
    returning everything the acceptance gates check — flag/demote/
    re-admit step indices, the post-demotion step windows (throughput
    restoration), run-attributed recompiles with both stacking depths
    pre-warmed (demotion at r=2 flips S_A 1 -> 2, and the gate freezes
    recompiles at zero), and whether the re-admitted weight table is
    bit-identical to a never-demoted one. ``cfg`` as in
    :func:`run_trainer_cell`; the row has the JAX runner's fields.

    ``ttt_s`` is the injector clock at run end plus any residual work
    deficit at the healthy rate — with no kills in the script it is
    exactly the sum of the (inflation-stretched) step windows.
    """
    import torch.distributed as dist

    dev, cfg = _live_setup(cell, device, cfg)
    degree = _model_degree(cell)
    # a group left up by a model degree 1 run in this process is one
    # rank: it tiles no grid above 1
    if degree > 1 and (not dist.is_initialized()
                       or dist.get_world_size() % degree):
        from ..launch.mesh import spawn_ranks
        row, _ = spawn_ranks(gray_cell_on_ranks, degree, device=dev,
                             args=(cell, cfg, str(dev)))
        return row
    return gray_cell_on_ranks(0, 1, cell, cfg, dev)


def gray_cell_on_ranks(rank: int, world: int, cell: dict, cfg,
                       device) -> dict:
    """The body of :func:`run_gray_cell` on one rank of the default
    group (initialised here with one rank where none is up); every rank
    returns the row."""
    import numpy as np

    from ..core.state import SpareState
    from ..des import get_scheme
    from ..exec import MeshExecutor
    from ..train.injection import ScriptedInjector

    tel = _cell_telemetry(cell)
    n, steps = cell["n"], cell["steps"]
    sps = cell["seconds_per_step"]
    det = None
    if cell["detect"]:
        from ..health import StragglerDetector
        det = StragglerDetector(n)
    ex = MeshExecutor(
        cfg, n_groups=n, redundancy=cell["r"],
        model_degree=_model_degree(cell),
        seq=cell.get("seq", 32),
        per_type_batch=cell.get("per_type_batch", 2),
        total_steps=steps, t_restart=cell.get("t_restart", 3600.0),
        scheme=get_scheme("adaptive", r=cell["r"], initial="spare"),
        telemetry=tel, detector=det, device=device)
    try:
        # warm every stacking depth a demotion can reach BEFORE the run:
        # run-attributed recompiles must stay frozen at zero through the
        # demote -> re-admit round trip (the no-recompile acceptance gate)
        ex.prewarm_depths(range(1, cell["r"] + 1))
        inj = ScriptedInjector(
            {}, seconds_per_step=sps,
            slow_schedule={cell["slow_step"]: [
                (cell["slow_group"], cell["slow_factor"],
                 cell["heal_step"])]},
            n_groups=n)
        t0 = time.perf_counter()
        rep = ex.run(steps, injector=inj,
                     snapshot_every=cell.get("snapshot_every", 10))
        elapsed = time.perf_counter() - t0

        demote_steps = [e.step for e in rep.events if e.demote]
        readmit_steps = [e.step for e in rep.events if e.readmit]
        flag_step = None
        if det is not None:
            flag_step = next((r.step for r in det.reports
                              if len(r.flagged)), None)
        # step windows while demoted-but-still-slow: demotion lands in
        # the health tick after `demote_step` completes, so the first
        # window it can deflate is the next poll
        post = []
        if demote_steps:
            post = inj.window_log[demote_steps[0] + 1:cell["heal_step"]]
        # re-admitted weight table vs a never-demoted run: SPARe
        # recovery is pure state, so bit-identical state => bit-identical
        # schedule
        ref = SpareState(n, cell["r"])
        readmit_identical = bool(
            np.array_equal(ex.state.stacks, ref.stacks)
            and np.array_equal(ex.state.alive, ref.alive)
            and int(ex.state.s_a) == int(ref.s_a)
            and np.array_equal(ex.state.supplier, ref.supplier))

        work = float(rep.steps_done)
        for e in rep.events:
            if e.wipeout:
                work -= e.rollback_depth
        deficit = max(float(steps) - work, 0.0)
        ttt = inj.clock + deficit * sps

        if ex.rank == 0 and ex.model_rank == 0:
            _dump_telemetry(tel, cell)
        return {
            "key": cell_key(cell),
            "arm": cell["arm"],
            "n": n, "r": cell["r"],
            "steps_done": rep.steps_done,
            "demotes": rep.demotes,
            "readmits": rep.readmits,
            "flag_step": flag_step,
            "demote_step": demote_steps[0] if demote_steps else None,
            "readmit_step": readmit_steps[0] if readmit_steps else None,
            "post_demote_window_max": max(post) if post else None,
            "healthy_window_s": sps,
            "recompiles": rep.recompiles,
            "total_recompiles": ex.total_recompiles,
            "compiled_entries": len(ex.cache_keys),
            "readmit_identical": readmit_identical,
            "wipeouts": rep.wipeouts,
            "ttt_s": ttt,
            "health_actions": [h["action"] for h in ex.health_log
                               if h["action"] != "tolerate"],
            "loss_first": rep.losses[0] if rep.losses else None,
            "loss_last": rep.losses[-1] if rep.losses else None,
            "elapsed_s": elapsed,
        }
    finally:
        ex.close()


# ------------------------------------------------------------------ #
# presets                                                            #
# ------------------------------------------------------------------ #
#: three failure regimes of the acceptance sweep: a quiet memoryless
#: cluster, a bursty Weibull storm, and spatially-correlated rack kills
REGIME_MODELS = [
    {"kind": "poisson", "label": "quiet_poisson", "mtbf": 30_000.0},
    {"kind": "weibull", "label": "bursty_weibull", "shape": 0.55,
     "mtbf": 300.0},
    {"kind": "correlated", "label": "rack_kill", "scope": "rack",
     "burst_prob": 0.25, "mtbf": 600.0},
]

CAMPAIGN_PRESETS: dict[str, CampaignSpec] = {
    # 2x2 CI smoke: two schemes x two regimes
    "smoke": CampaignSpec(
        name="campaign_smoke",
        schemes=["spare", "replication"],
        ns=[200], rs=[4],
        models=[{"kind": "weibull", "label": "weibull"},
                {"kind": "correlated", "label": "rack_kill",
                 "burst_prob": 0.25}],
        seeds=[0], steps=250,
    ),
    # balanced 16-cell grid for the parallel-speedup check
    "quick": CampaignSpec(
        name="campaign_quick",
        schemes=["spare", "replication"],
        ns=[200], rs=[4, 9],
        models=[{"kind": "weibull", "label": "weibull"},
                {"kind": "correlated", "label": "rack_kill",
                 "burst_prob": 0.25}],
        seeds=[0, 1], steps=600,
    ),
    # the adaptive acceptance sweep: every scheme across three regimes
    "regimes": CampaignSpec(
        name="campaign_regimes",
        schemes=["ckpt_only", ("replication", {"r": 2}), "spare",
                 "adaptive"],
        ns=[200], rs=[9],
        models=REGIME_MODELS,
        seeds=[0, 1, 2], steps=600,
    ),
    # paper-scale sweep (hours on CPU): Table-1 N points, full horizons
    "paper": CampaignSpec(
        name="campaign_paper",
        schemes=["ckpt_only", ("replication", {"r": 2}), "spare",
                 "adaptive"],
        ns=[200, 600, 1000], rs=[4, 9, 12],
        models=REGIME_MODELS + [
            {"kind": "trace", "label": "meta_hsdp_rackstorm",
             "trace": "meta_hsdp_rackstorm"},
            {"kind": "diurnal", "label": "diurnal_maintenance",
             "maintenance_start": 10_800.0},
        ],
        seeds=[0, 1, 2], steps=10_000,
    ),
}
