"""The port's static analysis: ``python -m repro_torch.launch.lint`` (the
counterpart of ``repro.launch.lint``).

One command runs every :mod:`repro_torch.analysis` pass and renders one
deterministic report:

* **AST passes** (always, in-process): the determinism lint and the
  thread-shared-state audit over the port's files (``src/repro_torch``,
  ``chip_smoke.py``, ``tests/test_torch_*.py``).
* **step passes** (``--steps``, the JAX lint's ``--hlo``, and
  ``--assert-clean``): donation audit, hot-path purity, wire-dtype policy
  and collective-schedule determinism over recorded steps of the JAX
  lint's own target set, at its sizes, in one child process
  (``--certify-executors``): the :class:`~repro_torch.exec.MeshExecutor`
  in its three variants over the FULL RECTLR-recoverable survivor space,
  the :class:`~repro_torch.elastic.ElasticMeshExecutor` after a
  degraded-continue shrink, the demoted set of a gray-failure demotion
  (and the re-admission's restored table), the
  :class:`~repro_torch.train.trainer.SpareTrainer`'s step and every
  callable of a warmed :class:`~repro_torch.serve.engine.ServeEngine`.

The grid's ranks are emulated one after another in the child, each on
torch's fake process group (:func:`fake_grid`): its collectives move
nothing, so the values are wrong but every rank's schedule is its own,
as the JAX lint's emulated devices give it.

* **the dry-run cells** (``--steps``; one child each, ``--cell ARCH
  SHAPE [--multi-pod]``, beside the executors' child): the step passes
  over the traced FSDP x TP step of the JAX lint's ``MATRIX_CELLS``
  (:mod:`repro_torch.launch.dryrun`, rank 0 of the fake production
  grid, storage-free tensors) at ``S_A`` 1 and 2: wire dtypes, purity,
  the storage audit (a storage-free tensor's storage is its object) and
  the schedule's determinism (two recordings under different §3.1
  weight tables give one schedule; on storage-free tensors no value can
  steer a collective, so that the weight table is live is left to the
  executors' cell form). The dense cells are ported (qwen2.5-3b
  ``train_4k`` and musicgen-medium ``prefill_32k`` multi-pod); the other
  three (deepseek-v2-lite MoE, mamba2, jamba) wait on the FSDP x TP
  program's families (``ROADMAP.md`` §1) and are noted as not yet
  ported.

Exit status: 0 unless ``--assert-clean`` is given and any unsuppressed
violation survives. ``--json`` prints the machine report (byte-identical
across runs); ``--out FILE`` writes it as the CI artifact. The step
passes run on the card (``--device cuda``, the default; it raises
without one), or on ``--device cpu``: there the sync debug mode is off
and a ``.tolist()`` or ``.numpy()`` of a CPU tensor reaches no
dispatcher, so a step that reads its data back that way passes on the
CPU and fails on the card.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys
import tempfile
from pathlib import Path

from repro_torch.analysis import Report, Violation, run_ast_passes

#: the JAX lint's executor sizes (``repro.launch.lint.certify_executors``)
EXECUTOR = dict(n_groups=4, redundancy=2, model_degree=2, seq=32,
                per_type_batch=2, total_steps=50)
ELASTIC = dict(EXECUTOR, n_groups=8, model_degree=1)
VARIANTS = (("shard_map", None), ("gspmd", None), ("shard_map", "int8_ef"))
SERVE = dict(n_slots=2, page_size=4, max_new=4, buckets=(8,))
#: the JAX lint's dry-run matrix (one cell per model family)
MATRIX_CELLS = (
    ("qwen2.5-3b", "train_4k", False),
    ("deepseek-v2-lite-16b", "train_4k", False),
    ("mamba2-1.3b", "long_500k", False),
    ("jamba-v0.1-52b", "decode_32k", True),
    ("musicgen-medium", "prefill_32k", True),
)
#: the cells whose program the port traces (the dense GQA families)
PORTED_CELLS = (MATRIX_CELLS[0], MATRIX_CELLS[4])


@contextlib.contextmanager
def fake_grid(rank: int, world: int):
    """The default process group as torch's fake group of ``world`` ranks,
    seen from ``rank``; torn down on the way out, whatever happens. Its
    collectives return at once and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already up")
    # init_process_group wraps sys.excepthook to prefix the rank: one
    # wrapper a group, so put it back
    hook = sys.excepthook
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()
        sys.excepthook = hook


def audit_executor(report: Report, ex, tag: str, *, sweep: bool = True):
    """The four step passes on one rank's executor: the donation audit,
    hot-path purity and wire-dtype policy of its current step, the EF
    state policy, and (``sweep``) the survivor sweep of the schedule.
    Returns the counts for the target's line and the step's log."""
    from repro_torch.analysis import (donation_audit, hot_path_purity,
                                      schedule_determinism_executor,
                                      wire_dtype_policy)
    from repro_torch.analysis.step_passes import ef_state_policy

    log = ex.step_log()
    found = (donation_audit(log, tag) + hot_path_purity(log, tag)
             + wire_dtype_policy(log, tag) + ef_state_policy(ex, tag))
    certified = 0
    if sweep:
        swept, certified = schedule_determinism_executor(ex, tag)
        found += swept
    report.extend(found)
    return _counts(log, found, certified), log


def _counts(log, found: list, survivor_sets: int = 0) -> dict:
    """One recorded program's line of a target."""
    return {"survivor_sets": survivor_sets, "programs": 1,
            "leaves_in_place": len(log.storage_before),
            "host_syncs": len(log.syncs),
            "collectives": len(log.collectives),
            "violations": len(found)}


def _note(report: Report, target: str, counts: dict) -> None:
    report.note("collective-schedule-determinism",
                survivor_sets_certified=counts["survivor_sets"])
    report.note("donation-audit",
                donated_leaves_audited=counts["leaves_in_place"])
    report.note(f"target:{target}", **counts)


def certify_executors(device: str, progress=lambda msg: None) -> Report:
    """Every target of the JAX lint's ``certify_executors``, on
    ``device`` (``"cuda"``, or ``"cpu"``, which sees neither the card's
    synchronising calls nor a ``.tolist()``/``.numpy()`` of a CPU
    tensor), each rank of a grid on the fake group in turn."""
    import numpy as np

    from repro_torch.analysis import (donation_audit, hot_path_purity,
                                      schedule_determinism_cell,
                                      wire_dtype_policy)
    from repro_torch.configs import smoke_config
    from repro_torch.elastic import ElasticMeshExecutor
    from repro_torch.exec import MeshExecutor
    from repro_torch.health.detector import HealthReport
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.kvcache import pool_pages_for
    from repro_torch.train.injection import ScriptedInjector
    from repro_torch.train.trainer import SpareTrainer, TrainReport

    report = Report()
    cfg = smoke_config("qwen2.5-3b").scaled(grad_accum=1)
    world = EXECUTOR["n_groups"] * EXECUTOR["model_degree"]

    # every sync variant of the production step, on every rank of the
    # (data 4, model 2) grid, swept over the FULL recoverable survivor
    # space (n=4, r=2), and the cell form on rank 0
    for sync, compress in VARIANTS:
        tag = f"executor:{sync}" + (f"+{compress}" if compress else "")
        progress(f"[lint] {tag} ...")
        counts: dict = {}
        for rank in range(world):
            with fake_grid(rank, world) as group:
                ex = MeshExecutor(cfg, sync=sync, grad_compress=compress,
                                  group=group, device=device, **EXECUTOR)
                try:
                    _add(counts, audit_executor(report, ex,
                                                f"{tag}@rank{rank}")[0])
                    if rank == 0:
                        cell = schedule_determinism_cell(ex, tag)
                        report.extend(cell)
                        counts["violations"] += len(cell)
                        counts["programs"] += 1
                finally:
                    ex.close()
        counts["ranks"] = world
        _note(report, tag, counts)

    # the elastic tier's degraded shape: 8 data rows shrink past the
    # unmaskable pair [0, 1] onto 4 survivors; the retired rows run no
    # step
    for compress in (None, "int8_ef"):
        tag = "executor:elastic-reshaped" + (f"+{compress}" if compress
                                             else "")
        progress(f"[lint] {tag} ...")
        n = ELASTIC["n_groups"]
        counts = {}
        retired = 0
        for rank in range(n):
            with fake_grid(rank, n) as group:
                elx = ElasticMeshExecutor(cfg, sync="shard_map",
                                          grad_compress=compress,
                                          group=group, device=device,
                                          **ELASTIC)
                try:
                    elx.reshape([0, 1])
                    if elx.rank is None:
                        retired += 1
                        continue
                    _add(counts, audit_executor(report, elx,
                                                f"{tag}@rank{rank}")[0])
                finally:
                    elx.close()
        counts.update(ranks=n - retired, retired_ranks=retired)
        _note(report, tag, counts)

    # the gray tier's demoted set, through the real demote path, then the
    # re-admission's restored weight table
    tag = "executor:demoted"
    progress(f"[lint] {tag} ...")
    counts, restored = {}, 0
    n = EXECUTOR["n_groups"]
    factors = np.ones(n)
    factors[0] = 3.0
    hr = HealthReport(step=0, smoothed=factors * 64.0, zscores=factors,
                      factors=factors, flagged=(0,), newly_flagged=(0,))
    for rank in range(world):
        with fake_grid(rank, world) as group:
            dex = MeshExecutor(cfg, sync="shard_map", group=group,
                               device=device, **EXECUTOR)
            try:
                healthy = (dex.state.stacks.copy(), dex.state.supplier.copy())
                dinj = ScriptedInjector({}, seconds_per_step=64.0,
                                        n_groups=n)
                dex._demote([0], hr, dinj, TrainReport())
                _add(counts, audit_executor(report, dex,
                                            f"{tag}@rank{rank}")[0])
                dex._readmit([0], hr, dinj, TrainReport())
                restored += int(bool(dex.state.alive.all())
                                and int(dex.state.s_a) == 1
                                and np.array_equal(dex.state.stacks,
                                                   healthy[0])
                                and np.array_equal(dex.state.supplier,
                                                   healthy[1]))
            finally:
                dex.close()
    counts.update(ranks=world, readmit_schedule_restored=restored)
    _note(report, tag, counts)
    if restored != world:
        report.extend([Violation(
            tag, 0, "collective-schedule-determinism",
            f"the re-admission restored the healthy weight table on "
            f"{restored} of {world} ranks")])

    # the emulation trainer's step (no group)
    tag = "trainer:spare"
    progress(f"[lint] {tag} ...")
    tr = SpareTrainer(cfg, n_groups=4, redundancy=2, seq=32,
                      per_type_batch=2, total_steps=50, device=device)
    log = tr.step_log()
    found = donation_audit(log, tag) + hot_path_purity(log, tag)
    report.extend(found)
    _note(report, tag, _counts(log, found))

    # every callable a warmed ServeEngine can ever run
    progress("[lint] serve ...")
    scfg = smoke_config("qwen2.5-3b")
    model = build_model(scfg, device=device)
    engine = ServeEngine(
        model, model.init(0), n_slots=SERVE["n_slots"],
        n_pages=pool_pages_for(SERVE["n_slots"],
                               max(SERVE["buckets"]) + SERVE["max_new"],
                               SERVE["page_size"]),
        page_size=SERVE["page_size"], max_new=SERVE["max_new"],
        buckets=SERVE["buckets"])
    engine.warmup()
    for key, log in engine.programs():
        tag = "serve:" + "/".join(str(k) for k in key)
        found = (donation_audit(log, tag) + hot_path_purity(log, tag)
                 + wire_dtype_policy(log, tag))
        report.extend(found)
        _note(report, tag, _counts(log, found))
    report.note("cells", serve_programs_certified=len(engine.cache.keys))
    return report


def run_cell_passes(arch: str, shape: str, multi_pod: bool) -> Report:
    """The step passes over one dry-run cell (see the module doc); a
    train cell at ``S_A`` 1 and 2."""
    import torch

    from repro_torch.analysis import (donation_audit, hot_path_purity,
                                      wire_dtype_policy)
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import record_cell
    from repro_torch.launch.steplog import same_collective_schedule

    report = Report()
    mesh = "2x16x16" if multi_pod else "16x16"
    depths = (1, 2) if SHAPES[shape].kind == "train" else (1,)
    for s_a in depths:
        tag = f"cell:{arch}/{shape}/{mesh}@S_A={s_a}"
        cell, meta = record_cell(arch, shape, multi_pod, s_a=s_a,
                                 watch=True)
        if cell is None:
            report.note("dryrun-cells",
                        **{f"{tag} skipped": meta["reason"]})
            continue
        log = cell.log
        found = (donation_audit(log, tag) + hot_path_purity(log, tag)
                 + wire_dtype_policy(log, tag))
        if s_a == depths[0] and meta["weights_shape"] is not None:
            # another weight table: the same schedule
            accum = get_config(arch).grad_accum
            other, _ = record_cell(arch, shape, multi_pod, s_a=s_a,
                                   weights=torch.empty(
                                       (s_a * accum,
                                        SHAPES[shape].global_batch // accum),
                                       device="meta"))
            if not same_collective_schedule(log, other.log):
                found.append(Violation(
                    tag, 0, "collective-schedule-determinism",
                    "another weight table records another collective "
                    "schedule"))
        report.extend(found)
        _note(report, tag, _counts(log, found))
        report.note("dryrun-cells", programs_certified=1)
    return report


def _add(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


# ------------------------------------------------------------------ #
# the parent process                                                 #
# ------------------------------------------------------------------ #
def run_step_passes(report: Report, device: str,
                    progress=lambda msg: None) -> None:
    """The certification children, each its own process (so that no fake
    group outlives it), run at once: the executors' and one a ported
    dry-run cell's; the cells not yet ported are noted."""
    with tempfile.TemporaryDirectory(prefix="repro-torch-lint-") as td:
        jobs = [(["--certify-executors", "--device", device],
                 Path(td) / "executors.json", "certify-executors")]
        for i, (arch, shape, multi_pod) in enumerate(PORTED_CELLS):
            jobs.append((["--cell", arch, shape]
                         + (["--multi-pod"] if multi_pod else []),
                         Path(td) / f"cell{i}.json", f"cell:{arch}/{shape}"))
        procs = []
        for extra, out, label in jobs:
            progress(f"[lint] {label} ...")
            cmd = [sys.executable, "-m", "repro_torch.launch.lint", *extra,
                   "--child-out", str(out)]
            procs.append((subprocess.Popen(
                cmd, env=dict(os.environ), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True), out, label))
        for proc, out, label in procs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0 or not out.exists():
                tail = (stderr or stdout or "")[-2000:]
                report.extend([Violation(
                    label, 0, "analysis-child",
                    f"child {label} failed (exit {proc.returncode}): "
                    f"{tail}")])
            else:
                report.merge_json(out.read_text())
    for arch, shape, multi_pod in (c for c in MATRIX_CELLS
                                   if c not in PORTED_CELLS):
        mesh = "2x16x16" if multi_pod else "16x16"
        report.note("dryrun-cells", **{f"cell:{arch}/{shape}/{mesh}":
                                        "not yet ported"})


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.lint",
        description="SPARe static analysis of the port: determinism lint "
                    "+ recorded-step invariant verification")
    ap.add_argument("--root", default=".",
                    help="repo root for the AST walk (default: cwd)")
    ap.add_argument("--steps", action="store_true",
                    help="also certify recorded steps (a child process "
                         "over the live executors, trainer and engine)")
    ap.add_argument("--assert-clean", action="store_true",
                    help="exit 1 on any violation (with --steps, of the "
                         "step passes too)")
    ap.add_argument("--json", action="store_true",
                    help="print the machine report instead of text")
    ap.add_argument("--out", help="also write the JSON report here")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="where the step passes run: cuda (default; "
                         "raises without a card) or cpu (sees neither "
                         "the card's synchronising calls nor a host read "
                         "of a CPU tensor by .tolist()/.numpy())")
    ap.add_argument("--cell", nargs=2, metavar=("ARCH", "SHAPE"),
                    help="run the step passes over one dry-run cell only "
                         "(storage-free tensors; no card needed; no AST "
                         "passes); --json, --out and --assert-clean as "
                         "for the whole lint")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --cell: the 2x16x16 grid")
    # internal child mode
    ap.add_argument("--certify-executors", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--child-out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.cell:
        report = run_cell_passes(args.cell[0], args.cell[1], args.multi_pod)
        if args.child_out:
            Path(args.child_out).write_text(report.to_json())
            return 0
        return _finish(report, args)
    if args.certify_executors:
        if args.device == "cpu":
            import torch
            # the steps are tiny: threads cost more than they give
            torch.set_num_threads(1)
        payload = certify_executors(
            args.device,
            progress=lambda m: print(m, file=sys.stderr)).to_json()
        if args.child_out:
            Path(args.child_out).write_text(payload)
        else:
            print(payload)
        return 0

    if args.steps:
        from repro_torch.models.model import resolve_device
        resolve_device(args.device)     # no card: raise before any work
    report = Report()
    run_ast_passes(args.root, report)
    if args.steps:
        run_step_passes(report, args.device,
                        progress=lambda m: print(m, file=sys.stderr))

    return _finish(report, args)


def _finish(report: Report, args) -> int:
    """Write, print and judge ``report`` as the flags ask."""
    if args.out:
        Path(args.out).write_text(report.to_json())
    print(report.to_json() if args.json else report.render_text())
    if args.assert_clean and not report.clean:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
