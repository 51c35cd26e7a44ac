#!/usr/bin/env python3
"""Device time of each kernel that K1 (RMSNorm forward), K1-bwd (its
backward), K4 (the SSD chunk scan) and K4-bwd (its backward) launch, at
the main paths' shapes, by kernel name; and one mamba2-1.3b training
step, profiled as ``chip_smoke.py --phase profile`` profiles it.

    PYTHONPATH=src python tools/kernel_times.py [--only CASE ...] [--variants]

Needs one CUDA card. The kernels are reached through the port's public
wrappers (``repro_torch.kernels.ops``), so the same script times any tree
of the port: put that tree's ``src`` first on ``PYTHONPATH`` to time its
kernels, and compare two trees in one call, in turns (parent, change,
change, parent). Each case runs 3 warm calls, then ``ITERS`` calls under
``torch.profiler``; it prints one JSON line per case: the device time per
call of each kernel name, its launches per call, and the card's name and
power limit. K1 runs at the decode step (8 rows of 2,048), the longest
prompt (512 rows of 2,048, and of 4,096 for the mamba2-1.3b gated norm)
and one training microbatch (2,048 rows of 2,048), bf16, under
``no_grad``; its lines also give ``queued``: the device ms per call of
``QUEUED`` calls queued back to back behind a spin kernel (CUDA events)
and the host's ms per call to queue them (medians of ``REPEATS`` runs),
with the same for an empty kernel (``torch.cuda._sleep(0)``), the launch
floor; at 8 rows also ``host_parts``, the host's ms per call of each
part of the ctypes launch path, where the tree has it. K1-bwd runs at one
qwen2.5-3b training microbatch (2,048 rows of 2,048, bf16), K4 at the
mamba2-1.3b prefill of 512 tokens (H 64, P 64, N 128, G 1, chunks of
256, bf16), K4-bwd at the mamba2-1.3b training microbatch (B 8, S 512,
the same widths, bf16, no d_final: the training path's final state is
unused) through ``ssd_scan_bwd_cuda``. ``ssm_train_step`` builds the tree's
own mamba2-1.3b training executor (48 layers, 4,096 tokens a microbatch,
int8 EF) with the tree's ``chip_smoke.py`` and prints what its
``profile_calls`` measures for one ``S_A = 1`` step: host and device ms,
the device's busy share and the top kernels.

``--only`` keeps the named cases (``rmsnorm``, ``rmsnorm_bwd``,
``ssd_scan``, ``ssd_scan_bwd``, ``ssm_train_step``). ``--variants`` also
times K1-bwd with other values of the module's tuning constants
(``PROGRAMS_PER_SM``, ``DW_ROWS``, ``DW_COLS``), and K4-bwd's bf16 route
with each count of heads a block walks (``heads_per_block`` 1, 2, 4),
where the tree has them.
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import subprocess
import time
from pathlib import Path

import torch

ITERS = 20
QUEUED = 200
REPEATS = 5
SPIN_CYCLES = 200_000_000        # ~0.1 s of the SM clock; grown if short
#: K1's (rows, D) cases
RMSNORM_SHAPES = ((8, 2048), (512, 2048), (512, 4096), (2048, 2048))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def by_kernel(fn, tries: int = 3) -> dict:
    """Device ms per call and launches per call of each kernel ``fn``
    runs. A profile that records no device time at all (one of K1's came
    back empty once) is taken again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0:
                out[e.key[:60]] = {
                    "ms": e.self_device_time_total / 1e3 / ITERS,
                    "launches": e.count / ITERS}
        if out:
            return out
    raise AssertionError(f"the profiler saw no device time in {tries} "
                         f"profiles")


def _queued_once(fn) -> tuple[float, float]:
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    cycles = SPIN_CYCLES
    for _ in range(4):
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(QUEUED):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / QUEUED, host_ms / QUEUED
        cycles *= 4
    raise AssertionError("the host could not queue the calls within the "
                         "spin")


def queued(fn) -> dict:
    """Device ms per call of ``QUEUED`` calls of ``fn`` queued back to
    back while a spin kernel holds the stream (CUDA events around them),
    and the host's ms per call to queue them: the medians of
    ``REPEATS`` such runs, with every run's host ms (the host's clock
    spreads far more than the device's)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    runs = sorted(_queued_once(fn) for _ in range(REPEATS))
    hosts = [h for _, h in runs]
    return {"ms": runs[REPEATS // 2][0],
            "host_ms": sorted(hosts)[REPEATS // 2], "host_ms_runs": hosts}


def host_parts(rows: int, d: int) -> dict:
    """Host ms per call of each part of K1's launch path (a tree with
    the ctypes binding only): batches of ``QUEUED`` calls, a synchronize
    after each batch (not timed), the median of ``REPEATS`` batches."""
    from repro_torch.kernels import ops, rmsnorm

    if not hasattr(rmsnorm, "rmsnorm_cuda"):
        return {}
    x = torch.randn((rows, d), device="cuda").to(torch.bfloat16)
    w = torch.rand((d,), device="cuda") + 0.5
    y = torch.empty_like(x)
    dev = x.device
    fn = rmsnorm._fn()
    args = (x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d,
            rmsnorm.DTYPES[x.dtype], 0, 1e-5,
            torch.cuda.current_stream(dev).cuda_stream)
    parts = {
        "ops.rmsnorm": lambda: ops.rmsnorm(x, w),
        "rmsnorm_cuda": lambda: rmsnorm.rmsnorm_cuda(x, w, 1e-5),
        "C call (launch)": lambda: fn(*args),
        "torch.empty_like": lambda: torch.empty_like(x),
        "current_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "x.device": lambda: x.device,
        "rmsnorm_route": lambda: rmsnorm.rmsnorm_route(*args[:3], d, 2),
    }
    out = {}
    with torch.no_grad():
        for name, part in parts.items():
            runs = []
            for _ in range(REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(QUEUED):
                    part()
                runs.append((time.perf_counter() - t0) * 1e3 / QUEUED)
            out[name] = sorted(runs)[REPEATS // 2]
    torch.cuda.synchronize()
    return out


def rmsnorm_case(rows: int, d: int):
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(rows + d)
    x = torch.randn((rows, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    w = torch.rand((d,), generator=gen, device="cuda") + 0.5

    def call():
        with torch.no_grad():
            ops.rmsnorm(x, w)
    return call


def rmsnorm_bwd_case():
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(5)
    x = (torch.randn((2048, 2048), generator=gen, device="cuda") * 2).to(
        torch.bfloat16).requires_grad_()
    w = (torch.rand((2048,), generator=gen, device="cuda")
         + 0.5).requires_grad_()
    dy = torch.randn((2048, 2048), generator=gen, device="cuda").to(
        torch.bfloat16)
    y = ops.rmsnorm(x, w)
    # the forward's launch is recorded once, outside the timed calls
    return lambda: torch.autograd.grad(y, (x, w), dy, retain_graph=True)


def ssd_scan_case():
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(8)
    b, s, h, p, n, g = 1, 512, 64, 64, 128, 1
    x = torch.randn((b, s, h, p), generator=gen, device="cuda").to(
        torch.bfloat16).transpose(1, 2)
    dt = (torch.rand((b, s, h), generator=gen, device="cuda") * 0.099
          + 0.001).transpose(1, 2)
    a_log = torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                   device="cuda"))
    bb, cc = (torch.randn((b, s, g, n), generator=gen, device="cuda").to(
        torch.bfloat16).transpose(1, 2) for _ in range(2))
    return lambda: ops.ssd_scan(x, dt, a_log, bb, cc, chunk=256)


def ssd_scan_bwd_case(heads_per_block=None):
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda

    gen = torch.Generator(device="cuda").manual_seed(9)
    b, s, h, p, n, g, q = 8, 512, 64, 64, 128, 1, 256

    def act(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16).transpose(1, 2)
    x, bb, cc, dy = act(b, s, h, p), act(b, s, g, n), act(b, s, g, n), \
        act(b, s, h, p)
    dt = torch.nn.functional.softplus(torch.randn(
        (b, s, h), generator=gen, device="cuda") * 0.5 - 4.6).transpose(1, 2)
    a_log = torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                   device="cuda"))
    kw = {} if heads_per_block is None else \
        {"heads_per_block": heads_per_block}
    return lambda: ssd_scan_bwd_cuda(x, dt, a_log, bb, cc, dy, None, q, **kw)


def walks_heads() -> bool:
    """Whether the tree's K4-bwd takes ``heads_per_block``."""
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda
    return "heads_per_block" in inspect.signature(
        ssd_scan_bwd_cuda).parameters


def ssm_train_step() -> dict:
    """One mamba2-1.3b training step of the tree's own ssm train phase
    set-up, through the tree's ``chip_smoke.profile_calls``."""
    import gc

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import close_data_group
    from repro_torch.train.trainer import TrainReport

    root = Path(repro_torch.__file__).resolve().parents[2]
    spec = importlib.util.spec_from_file_location("tree_chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    st, cfg = cs.SSM_TRAIN, get_config(cs.SSM_ARCH)
    ex = cs._executor(cfg.scaled(n_layers=st["depths"][0], grad_accum=1),
                      "cuda", n_groups=st["n_groups"], r=st["r"],
                      seq=st["seq"], per_type_batch=st["per_type_batch"],
                      seed=st["seed"], grad_compress="int8_ef",
                      bucket_mb=st["bucket_mb"])
    report = TrainReport()
    try:
        out = cs.profile_calls(
            [("ssm_train_step",
              lambda: float(ex._dispatch(report)[2]["loss"]))],
            iters=2)["ssm_train_step"]
    finally:
        del ex
        gc.collect()
        torch.cuda.empty_cache()
        close_data_group()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    every = ("rmsnorm", "rmsnorm_bwd", "ssd_scan", "ssd_scan_bwd",
             "ssm_train_step")
    ap.add_argument("--only", nargs="+", choices=every, default=every)
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA card")
    import repro_torch
    from repro_torch.kernels import rmsnorm

    where = repro_torch.__file__
    name = card()
    floor = queued(lambda: torch.cuda._sleep(0))
    for rows, d in RMSNORM_SHAPES if "rmsnorm" in args.only else ():
        fn = rmsnorm_case(rows, d)
        print(json.dumps({"case": "rmsnorm", "shape": [rows, d],
                          "tree": where, "kernels": by_kernel(fn),
                          "queued": queued(fn), "floor": floor,
                          "host_parts": host_parts(rows, d) if rows == 8
                          else {}, "card": name}), flush=True)
    cases = [(c, {}) for c in ("rmsnorm_bwd", "ssd_scan", "ssd_scan_bwd")
             if c in args.only]
    knobs = ("PROGRAMS_PER_SM", "DW_ROWS", "DW_COLS")
    if args.variants and all(hasattr(rmsnorm, k) for k in knobs) \
            and "rmsnorm_bwd" in args.only:
        for v in ((1, 64, 32), (4, 64, 32), (2, 32, 64), (2, 128, 16),
                  (2, 256, 16), (2, 64, 16), (2, 128, 8), (1, 128, 16)):
            cases.append(("rmsnorm_bwd", dict(zip(knobs, v))))
    if args.variants and "ssd_scan_bwd" in args.only and walks_heads():
        cases += [("ssd_scan_bwd", {"heads_per_block": hw})
                  for hw in (1, 2, 4)]
    for case, knob in cases:
        if case == "ssd_scan_bwd":
            fn = ssd_scan_bwd_case(**knob)
        else:
            saved = {k: getattr(rmsnorm, k) for k in knob}
            for k, v in knob.items():
                setattr(rmsnorm, k, v)
            fn = (rmsnorm_bwd_case if case == "rmsnorm_bwd"
                  else ssd_scan_case)()
        print(json.dumps({"case": case, "knobs": knob, "tree": where,
                          "kernels": by_kernel(fn), "card": name}),
              flush=True)
        if case != "ssd_scan_bwd":
            for k, v in saved.items():
                setattr(rmsnorm, k, v)
    if "ssm_train_step" in args.only:
        print(json.dumps({"case": "ssm_train_step", "tree": where,
                          "profile": ssm_train_step(), "card": name}),
              flush=True)


if __name__ == "__main__":
    main()
