#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py            # every phase; needs one card

Phases, in order; any failure exits non-zero:

1. **device** — the card's name and power limit (``nvidia-smi``).
2. **build** — compiles every kernel from the sources in this checkout:
   one ``nvcc`` per CUDA source, all started together, then the Triton
   kernels' (K1-bwd's) first launches; then reads the libraries' SASS with
   ``cuobjdump`` and fails unless each bf16 K2 and K2-bwd product kernel
   and the bf16 K4 kernel hold tensor-core instructions
   (``HGMMA``/``HMMA``), printing the count per kernel.
3. **kernels** — each kernel at the main paths' shapes against its plain
   PyTorch version on the same inputs, with the tolerance stated: K1 and
   K2 forward at the qwen2.5-3b serving shapes (K1 also at the
   mamba2-1.3b gated norm's width, 4096, and at one training
   microbatch, with its host cost per call and the launch floor beside
   its device time) and, beside K1-bwd and K2-bwd,
   at the training shapes as the training path calls them (K1-bwd also
   at one row, at a ragged last program and at width 4096, its row pass
   and its dw pass also timed apart); K3a and K3b
   at the largest bucket of the full-width gradient layout and at a
   ragged length; K4 (the SSD chunk scan) at the mamba2-1.3b prefill
   shapes (S 512 in chunks of 256, S 128), in fp32, at a ragged single
   chunk of 159 and with G > 1 and N = 16. K1, K1-bwd and K4 must give
   the same bits on a second call. Times the kernel, the plain
   version and, as a yardstick only, the one PyTorch call that computes
   the same function where there is one (device time, with the stream
   held busy while the host queues the calls; the host's own cost per
   call beside it); computes the bound from the bytes and flops of the
   inputs. K2, K2-bwd and K4 take one route per dtype (bf16 on the
   tensor cores, fp32 on the CUDA cores), named in each of their rows; K2's
   forward is also timed at the training shape, as the training path
   calls it, beside K2-bwd. K1-bwd (with K1's training forward), K2 and
   K2-bwd are also checked at each microbatch the campaign's live cells
   run (phase 12: N x per-type batch rows of seq tokens), with the same
   tolerances.
4. **reference** — a small qwen configuration with head_dim 128 served
   in fp32 on the card (kernels) and on the CPU (plain versions):
   greedy tokens identical, prefill logits within 1e-4.
5. **train reference** — a small configuration with head_dim 128,
   three training steps through the ``MeshExecutor`` in fp32 on the
   card (kernels) and on the CPU (plain versions): with fp32 buckets,
   losses within 1e-5 relative and params within 1e-5; with int8 EF,
   each step from the card's state, losses within 1e-5 relative, the
   synced gradients within one int8 quantum of their bucket (codes
   within 1, scales within 1e-5), the residuals within one quantum, and
   the card's residuals carried from step to step bit for bit.
6. **slice** — the serving path: full-width qwen2.5-3b (36 layers,
   random weights from a seed, bf16) behind a ``ReplicaServer`` with two
   replicas; one healthy run, one where a ``ScriptedInjector`` kills
   replica 0 mid-run. Every request completes in both with zero drops,
   nothing is rebuilt after warmup, the burst run's tokens equal the
   healthy run's, logits are finite, the kernels' launch counters (set
   to 0 just before, read just after) match the prefills and decode
   steps run, and a prefill of a generated continuation agrees with the
   decode's greedy choices. Then the step builders' default spellings,
   counted from 0 on their own: ``make_prefill(model)`` against the
   cache-filling prefill's last position (one bf16 ulp per row), and
   ``make_serve_step(model)``, the dense step at a scalar position, over
   caches filled from that prefill, against the paged engine's tokens
   (the same 0.25 logit gap). Then a third serving run, **wipeout**:
   the same set-up with a ``CheckpointManager`` (the params saved at
   construction under ``chiprun_out/``, removed after) and both
   replicas killed at ``kill_step``; the wipe-out reloads the params
   from the checkpoint onto the card. Every request completes with the
   healthy run's tokens, nothing is dropped or rebuilt, the reloaded
   params equal the originals bit for bit, and the launch counters (set
   to 0 just before, read just after) match; the reload's seconds are
   printed.
7. **ssm reference** — a small mamba2 configuration (2 layers, d_model
   256, head_dim 64, d_state 128, chunk 64) served in fp32 on the card
   (K4) and on the CPU (plain versions): prefill logits of a 128-token
   prompt (two chunks) within 1e-4, greedy tokens identical.
8. **ssm slice** — the same serving path and gates on full-width
   mamba2-1.3b (48 layers, no cut): every prefill runs K4 once per
   layer; the decode-vs-prefill check uses a request of the 128 bucket.
9. **train** — the training path (Alg. 1): full-width qwen2.5-3b, random
   bf16 weights from a seed, through the ``MeshExecutor`` on a one-rank
   NCCL group with the int8 error-feedback sync; a ``ScriptedInjector``
   kills a group (masked, ``S_A`` rises) and later a set that wipes the
   system out (rollback to the snapshot). Every loss is finite; the
   report matches the script; after the rollback, params, optimizer
   state and EF residuals equal the snapshot bit for bit (checksums);
   the first replayed step's loss equals that step's first execution
   bit for bit; the launch counters (set to 0 just before, read just
   after) equal the counts the code implies. Depth is 36 layers unless
   peak device memory passes ``TRAIN["mem_limit_gib"]``; then the
   largest of 24, 18, 12 that fits, with both readings printed.
10. **failure tiers** — the training path with every failure tier on
   (``FAILURE``): full-width qwen2.5-3b at the train phase's depth
   through the int8-EF ``MeshExecutor`` with a checkpoint directory
   under ``chiprun_out/`` (removed at the end; the Eq.-1 interval due
   at every snapshot point, one checkpoint kept), a
   ``StragglerDetector`` with its defaults and a ``ScriptedInjector``:
   a 3x straggler that is flagged, demoted and, once it heals,
   re-admitted, then a masked kill and a kill that wipes the system out.
   Gates: finite losses; the events and ``health_log`` equal a tiny CPU
   run of the same script; the re-admitted weight table equals an
   always-healthy run's bit for bit, with no rebuild; at least two saves
   commit and the latest restores onto the card to the state recorded
   at its step, bit for bit; the rollback restores the snapshot and the
   first replayed step's loss its first execution's, bit for bit; exact
   launch counts. Prints the host copy's, the disk write's and the
   restore's seconds, the step time with and without a save in flight,
   and the peak host RSS against ``MemTotal``. A smaller depth (24, 18,
   12) only if the two checkpoints it writes exceed the disk's free
   space or the phase's write budget, or ``MemTotal`` is below the host
   snapshot; the readings are printed.
11. **cli** — both launchers as subprocesses on the card at the smoke
   configuration with ``--failure-model``, ``--topology`` and
   ``--ckpt-dir`` (the train launcher through ``--mesh --grad-compress
   int8_ef``): exit code 0 and the report parsed.
12. **campaign** — the campaign runner (``CAMPAIGN``): (a) the DES
   ``smoke`` preset at jobs 1 and 2 (spawned workers), artifacts
   byte-identical, rankings printed; (b) the three live trainer cells
   of the JAX preset (weibull, rack burst, trace replay: N 8, r 3, 40
   steps, seq 32) through ``run_trainer_cell`` on the card at the full
   width of qwen2.5-3b, each against the same cell at smoke size on the
   CPU: the report's counts equal, every loss finite, the §3.1 error at
   most 1e-2, at least one multi-group event; (c) the gray arms
   (tolerate, demote) through ``run_gray_cell`` on the one-rank NCCL
   ``MeshExecutor`` at the same width, against the CPU: flag, demote
   and re-admit steps, health actions and modeled TTT equal, the
   re-admitted table bit-identical, no run recompile, demote's TTT
   below tolerate's; (d) ``python -m repro_torch.launch.obs`` exits 0
   on every trace of (b) with ``--assert-coverage 0.95
   --assert-recovery-markers`` and on the demote arm's with
   ``--assert-coverage 0.95`` (a gray episode kills nobody, so it has
   no failure marker), whose attribution rows must be a demote and a
   re-admit. K1, K1-bwd, K2 and K2-bwd must launch on both live paths.
   The depth is the deepest of 36, 24, 18, 12 whose training state
   (params, AdamW moments, the accumulator and the two gradient trees
   of the §3.1 check, reckoned from the leaves) fits 75 GiB; the
   reckoning is printed. Prints per cell the seconds, step seconds by
   ``S_A``, peak device memory, the process's peak RSS so far and the
   seconds of the host snapshots the cell's trace spans
   (``ckpt_save``).

Prints the kernel table as one JSON line, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. Details
go to ``chiprun_out/chip_smoke.json``. ``--phase kernels`` stops after
the kernel phase; ``--phase train`` runs the build, the train phase and
the failure tiers only; ``--phase campaign`` the build and the campaign
phase only; ``--phase profile`` only profiles a serving decode step and
prefill of both full-width models and one training step of qwen2.5-3b
(``chiprun_out/chip_profile.json``).
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the training state fills most of the card: let the caching allocator
# grow segments instead of fragmenting (read when torch first allocates)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor-core peak
FP32_FLOPS_PER_S = 67e12         # fp32 outside the tensor cores
SPIN_CYCLES = 200_000_000        # ~0.1 s of the SM clock; grown if short
ARCH = "qwen2.5-3b"
SSM_ARCH = "mamba2-1.3b"
SERVE = dict(replicas=2, slots=8, page_size=16, buckets=(128, 512),
             max_new=32, requests=16, kill_step=10, seed=0)
# the training path: 8 groups x 1 example x 256 tokens = 2048 tokens per
# microbatch; a group dies at poll 2 (masked), a set that wipes the
# system out at poll 5 (rollback to the snapshot taken at step 0)
TRAIN = dict(n_groups=8, r=2, per_type_batch=1, seq=256, steps=8,
             kill_poll=2, wipe_poll=5, seed=0, depths=(36, 24, 18, 12),
             mem_limit_gib=75.0, bucket_mb=32.0)
# the failure tiers: group 3 at 3x over polls 0-2 (flagged, demoted,
# re-admitted once it heals), group 0 killed at poll 13 (masked), at
# poll 14 a group that wipes the system out (rollback to the snapshot of
# step 12); snapshots every 6 steps, each written to disk (the Eq.-1
# interval with t_save 1e-12 s is ~1e-4 s); keep 1 checkpoint on disk.
# The phase writes two checkpoints; write_budget_gib caps what it may
# write in one run (deleted files included), below the disk's free space
FAILURE = dict(steps=15, snapshot_every=6, slow_group=3, slow_factor=3.0,
               slow_from=0, slow_until=3, kill_poll=13, wipe_poll=14,
               mtbf=300.0, t_save=1e-12, t_restart=3600.0, keep=1,
               depths=(24, 18, 12), write_budget_gib=36.0)
GIB = float(1 << 30)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed(fn, iters: int = 50, warmup: int = 3) -> tuple[float, float]:
    """``(device ms, host ms)`` per call of ``fn()``.

    A spin kernel holds the stream while the host queues all ``iters``
    calls, so the CUDA events around them time the device's work alone,
    back to back, not the host's launch rate; the host clock around the
    queueing gives the host's cost per call. Raises if the host could not
    queue everything before the spin ended.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    cycles = SPIN_CYCLES
    for _ in range(4):
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / iters, host_ms / iters
        cycles *= 4
    raise AssertionError("the host could not queue the calls within the "
                         "spin; device time not measured")


def cuda_ms(fn) -> float:
    """Device time of ``fn()`` in ms (see :func:`timed`)."""
    return timed(fn)[0]


def bound(nbytes: float, flops: float,
          peak: float) -> tuple[float, str]:
    """Least time in ms: bytes over the memory rate or operations over
    ``peak`` (the card's rate for their type), whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ #
# build                                                              #
# ------------------------------------------------------------------ #
#: per CUDA source, the bf16 kernels that must run their products on the
#: tensor cores, and the template values each is built for: K2 and
#: K2-bwd's two product passes per head dim, K4 per state dim
TENSOR_CORE_KERNELS = {
    "flash_attention": (("fa_fwd_bf16", "fa_bwd_dkdv_bf16", "fa_bwd_dq_bf16"),
                        (64, 128)),
    "ssd_scan": (("ssd_scan_bf16",), (16, 32, 64, 128))}


def cuobjdump() -> str:
    """``cuobjdump``: on ``PATH``, else in the CUDA toolkit's ``bin``,
    else under Triton's ``backends/nvidia/bin``."""
    import importlib.util
    import shutil

    from repro_torch.kernels import _build

    found = shutil.which("cuobjdump")
    if found:
        return found
    toolkit = Path(_build._nvcc()).parent / "cuobjdump"
    if toolkit.exists():
        return str(toolkit)
    spec = importlib.util.find_spec("triton")
    for loc in (spec.submodule_search_locations or []) if spec else []:
        path = Path(loc) / "backends" / "nvidia" / "bin" / "cuobjdump"
        if path.exists():
            return str(path)
    raise AssertionError("cuobjdump not found on PATH, in the CUDA "
                         "toolkit or in Triton's package")


def tensor_core_sass() -> dict:
    """Count the tensor-core instructions (``HGMMA`` or ``HMMA``) in the
    SASS of each bf16 kernel of ``TENSOR_CORE_KERNELS``, per template
    value, in the built libraries; fail unless every one of them has
    some."""
    import re

    from repro_torch.kernels import _build

    counts, want = {}, []
    for lib, (kernels, values) in TENSOR_CORE_KERNELS.items():
        want += [f"{k}<{v}>" for k in kernels for v in values]
        sass = subprocess.run(
            [cuobjdump(), "-sass", str(_build.build(lib))],
            capture_output=True, text=True, check=True, timeout=300).stdout
        name = None
        for line in sass.splitlines():
            fn = re.search(r"Function : \S*?(\w+_bf16)ILi(\d+)E", line)
            if fn and fn.group(1).endswith(kernels):
                base = next(k for k in kernels if fn.group(1).endswith(k))
                name = f"{base}<{fn.group(2)}>"
                counts[name] = 0
            elif "Function : " in line:
                name = None
            elif name and re.search(r"\bHG?MMA\.", line):
                counts[name] += 1
    missing = [k for k in want if not counts.get(k)]
    if missing:
        raise AssertionError(f"no HGMMA/HMMA in the SASS of {missing} "
                             f"(counts {counts})")
    return counts


def build_kernels() -> dict:
    import torch

    from repro_torch.kernels import _build, ops

    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
    # Triton compiles on first launch: K1-bwd
    x = torch.ones((2, 64), dtype=torch.bfloat16, device="cuda",
                   requires_grad=True)
    w = torch.ones(64, device="cuda", requires_grad=True)
    ops.rmsnorm(x, w).sum().backward()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ptxas = {name: _build.ptxas_log(name) for name in _build.SOURCES}
    for name, text in ptxas.items():
        log(f"[build] {name}: {text.strip()}")
    log(f"[build] kernels built in {secs:.1f} s")
    sass = tensor_core_sass()
    print(f"[sass] tensor-core instructions (HGMMA/HMMA) per bf16 flash "
          f"attention and SSD scan kernel: {json.dumps(sass)}", flush=True)
    return {"seconds": secs, "ptxas": ptxas, "tensor_core_sass": sass}


def bf16_ulps(out, ref) -> float:
    """The largest error of a row of ``out`` against ``ref`` (the last
    axis is the row), in bf16 ulps at that row's largest ``|ref|``
    (2**-7 of it). Two fp32 results that differ only by summation order
    land at most one ulp apart once rounded to bf16, so a kernel is
    within tolerance at <= 1 in every row, whatever the row's scale."""
    o, r = out.float(), ref.float()
    err = (o - r).abs().amax(-1)
    ulp = 2.0 ** -7 * r.abs().amax(-1)
    return (err / ulp.clamp_min(1e-30)).max().item()


def same_bits(a, b) -> bool:
    """Bit-identical fp32 tensors, a NaN equal to a NaN in the same place
    (the payload of a NaN is not part of the contract)."""
    import torch

    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(
        a.masked_fill(nan, 0).view(torch.int32),
        b.masked_fill(nan, 0).view(torch.int32))


# ------------------------------------------------------------------ #
# kernel phase                                                       #
# ------------------------------------------------------------------ #
def check_rmsnorm(cfg, row_shapes) -> dict:
    """K1 at each (rows, D) of ``row_shapes``; the main shape is the
    longest prompt bucket at ``cfg``'s width. Beside each device time,
    the host's cost per call and the launch floor (the device time of an
    empty kernel, timed the same way); a second call must give the same
    bits."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.rmsnorm import rmsnorm_ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    floor_ms, floor_host_ms = timed(lambda: torch.cuda._sleep(0))
    shapes, worst = [], 0.0
    for rows, d in row_shapes:
        x = torch.randn((rows, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = torch.rand((d,), generator=gen, device="cuda") + 0.5
        y = ops.rmsnorm(x, w, eps=cfg.norm_eps)
        ref = rmsnorm_ref(x, w, cfg.norm_eps)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        # one bf16 ulp at each row's largest output: the kernel's rsqrt
        # and sum order may move a value across a bf16 rounding boundary
        ulps = bf16_ulps(y, ref)
        if not ulps <= 1.0 or not torch.isfinite(y).all():
            raise AssertionError(f"rmsnorm ({rows}, {d}): {ulps} bf16 ulps "
                                 f"(max err {err}) > 1")
        if not torch.equal(y.view(torch.int16), ops.rmsnorm(
                x, w, eps=cfg.norm_eps).view(torch.int16)):
            raise AssertionError(f"rmsnorm ({rows}, {d}): a second call "
                                 f"gave other bits")
        wb = w.to(torch.bfloat16)
        nbytes = 2 * rows * d * 2 + d * 4
        # the math is fp32 whatever x's dtype
        b_ms, b_by = bound(nbytes, 4 * rows * d, FP32_FLOPS_PER_S)
        ms, host_ms = timed(lambda: ops.rmsnorm(x, w, eps=cfg.norm_eps))
        shapes.append({
            "shape": [rows, d], "tokens": rows, "dtype": "bfloat16",
            "main": (rows, d) == (max(SERVE["buckets"]), cfg.d_model),
            "max_abs_err": err, "max_row_ulps": ulps,
            "tol": "1 bf16 ulp per row", "ms": ms, "host_ms": host_ms,
            "plain_ms": cuda_ms(lambda: rmsnorm_ref(x, w, cfg.norm_eps)),
            # yardstick: F.rms_norm takes the weight in x's dtype
            "library_ms": cuda_ms(
                lambda: F.rms_norm(x, (d,), wb, cfg.norm_eps)),
            "bound_ms": b_ms, "bound_by": b_by,
            "launch_floor_ms": floor_ms,
            "launch_floor_host_ms": floor_host_ms})
        worst = max(worst, err)
    return {"name": "rmsnorm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm.py:44",
            "max_abs_err": worst, "shapes": shapes}


#: the route each dtype takes through K2 and K2-bwd on the card
FLASH_ROUTES = {"bfloat16": "tensor cores (wgmma bf16 -> fp32, cp.async "
                            "tiles)",
                "float32": "CUDA cores (fp32 fmaf)"}
#: the route each dtype takes through K4 on the card
SSD_ROUTES = {"bfloat16": "tensor cores (wgmma bf16 -> fp32, cp.async "
                          "tiles; fp32 operands as bf16 parts)",
              "float32": "CUDA cores (fp32 fmaf)"}


def check_flash(cfg, cases) -> dict:
    """K2's forward at each ``(batch, seq, dtype)`` of ``cases``; the
    main shape is the longest prompt bucket, one sequence, in bf16."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_ref

    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes, worst = [], 0.0
    for b, s, dtype in cases:
        # the model's (B, S, H, dh) activations, passed transposed
        q = torch.randn((b, s, h, dh), generator=gen, device="cuda").to(
            dtype).transpose(1, 2)
        k = torch.randn((b, s, kv, dh), generator=gen, device="cuda").to(
            dtype).transpose(1, 2)
        v = torch.randn((b, s, kv, dh), generator=gen, device="cuda").to(
            dtype).transpose(1, 2)
        out = ops.flash_attention(q, k, v)
        ref = flash_attention_ref(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        # bf16: fp32 math in another summation order, then one rounding,
        # so one bf16 ulp at each (head, position) row's largest output
        # (late rows average many values and are small: an absolute
        # tolerance would not see them); fp32: summation order only
        if dtype == torch.bfloat16:
            ulps, tol = bf16_ulps(out, ref), "1 bf16 ulp per row"
            ok = ulps <= 1.0
        else:
            ulps, tol = None, 1e-5
            ok = err <= tol
        if not ok or not torch.isfinite(out).all():
            raise AssertionError(f"flash_attention B={b} S={s} {dtype}: "
                                 f"max err "
                                 f"{err}, {ulps} bf16 ulps; tol {tol}")
        esize = q.element_size()
        nbytes = b * (2 * s * h * dh + 2 * s * kv * dh) * esize
        flops = b * 4 * h * dh * s * (s + 1) / 2
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S
                           if dtype == torch.bfloat16 else FP32_FLOPS_PER_S)
        ms, host_ms = timed(lambda: ops.flash_attention(q, k, v))
        dname = str(dtype).replace("torch.", "")
        shapes.append({
            "shape": {"B": b, "S": s, "H": h, "KV": kv, "D": dh},
            "tokens": b * s,
            "main": (b, s) == (1, max(SERVE["buckets"]))
            and dtype == torch.bfloat16,
            "dtype": dname, "dtype_route": FLASH_ROUTES[dname],
            "max_abs_err": err, "max_row_ulps": ulps, "tol": tol,
            "ms": ms, "host_ms": host_ms,
            "plain_ms": cuda_ms(lambda: flash_attention_ref(q, k, v)),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by})
        worst = max(worst, err)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:98",
            "dtype_routes": FLASH_ROUTES, "max_abs_err": worst,
            "shapes": shapes}


def grad_timer(outputs, inputs, grad_out):
    """A call that runs autograd's backward of an already built graph
    (kept with ``retain_graph``): the plain version's and the library's
    backward, timed alone."""
    import torch

    return lambda: torch.autograd.grad(outputs, inputs, grad_out,
                                       retain_graph=True)


def check_rmsnorm_bwd(cfg, rows: int, more_rows) -> dict:
    """K1-bwd at the training shape (one microbatch's rows), at one row,
    at one row short of the training shape (a ragged last program), at
    the mamba2 gated norm's width (4096) and at each row count of
    ``more_rows`` (the campaign's microbatches) at the model's width:
    dx within one bf16 ulp of each row's largest |ref|, dw within 1e-5
    of max|dw_ref|, against autograd through the plain version; and K1's
    forward at each shape, as the training path calls it, within one
    bf16 ulp per row. At every shape a second call gives the same bits;
    at the training shape the row pass and the dw pass are also timed
    apart."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_dw,
                                             rmsnorm_bwd_rows,
                                             rmsnorm_bwd_triton, rmsnorm_ref)

    d, eps = cfg.d_model, cfg.norm_eps
    gen = torch.Generator(device="cuda").manual_seed(5)
    shapes, worst = [], 0.0
    for n, width in ((rows, d), (1, d), (rows - 1, d), (rows, 2 * d),
                     *((m, d) for m in more_rows)):
        x0 = (torch.randn((n, width), generator=gen, device="cuda") * 2).to(
            torch.bfloat16)
        w0 = torch.rand((width,), generator=gen, device="cuda") + 0.5
        dy = torch.randn((n, width), generator=gen, device="cuda").to(
            torch.bfloat16)
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        y = ops.rmsnorm(x, w, eps=eps)
        y.backward(dy)
        xr, wr = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        yr = rmsnorm_ref(xr, wr, eps)
        dx_ref, dw_ref = torch.autograd.grad(yr, (xr, wr), dy,
                                             retain_graph=True)
        torch.cuda.synchronize()
        fwd_ulps = bf16_ulps(y, yr)
        ulps = bf16_ulps(x.grad, dx_ref)
        dw_rel = ((w.grad - dw_ref).abs().max()
                  / dw_ref.abs().max()).item()
        err = (x.grad.float() - dx_ref.float()).abs().max().item()
        if not (fwd_ulps <= 1.0 and torch.isfinite(y).all()):
            raise AssertionError(f"rmsnorm (training forward) ({n}, "
                                 f"{width}): {fwd_ulps} bf16 ulps (> 1)")
        if not (ulps <= 1.0 and dw_rel <= 1e-5
                and torch.isfinite(x.grad).all()):
            raise AssertionError(f"rmsnorm_bwd ({n}, {width}): dx {ulps} "
                                 f"bf16 ulps (> 1) or dw rel err {dw_rel} "
                                 f"(> 1e-5)")
        main = (n, width) == (rows, d)
        again = rmsnorm_bwd_triton(x0, w0, dy, eps)
        same = (torch.equal(again[0].view(torch.int16),
                            x.grad.view(torch.int16))
                and torch.equal(again[1].view(torch.int32),
                                w.grad.view(torch.int32)))
        if not same:
            raise AssertionError(f"rmsnorm_bwd ({n}, {width}): a second "
                                 f"call gave other bits")
        # read x, dy; write dx; read w, write dw (and its per-program
        # partials are the kernel's own traffic, not the function's)
        nbytes = 3 * n * width * 2 + 2 * width * 4
        b_ms, b_by = bound(nbytes, 10 * n * width, FP32_FLOPS_PER_S)
        ms, host_ms = timed(lambda: rmsnorm_bwd_triton(x0, w0, dy, eps))
        xl = x0.clone().requires_grad_()
        wl = w0.to(torch.bfloat16).requires_grad_()
        yl = F.rms_norm(xl, (width,), wl, eps)
        shape = {"shape": [n, width], "tokens": n, "dtype": "bfloat16",
                 "main": main, "max_abs_err": err, "max_row_ulps": ulps,
                 "dw_rel_err": dw_rel, "forward_max_row_ulps": fwd_ulps,
                 "same_bits_again": same,
                 "tol": "dx 1 bf16 ulp per row; dw 1e-5 relative; forward "
                        "1 bf16 ulp per row; a second call the same bits",
                 "ms": ms, "host_ms": host_ms,
                 "plain_ms": cuda_ms(grad_timer(yr, (xr, wr), dy)),
                 "library_ms": cuda_ms(grad_timer(yl, (xl, wl), dy)),
                 "library": "autograd backward of F.rms_norm",
                 "bound_ms": b_ms, "bound_by": b_by}
        if main:
            _, partial = rmsnorm_bwd_rows(x0, w0, dy, eps)
            shape["rows_pass_ms"] = cuda_ms(
                lambda: rmsnorm_bwd_rows(x0, w0, dy, eps))
            shape["dw_pass_ms"] = cuda_ms(lambda: rmsnorm_bwd_dw(partial))
            shape["partial_rows"] = partial.shape[0]
            log(f"[kernels] rmsnorm_bwd ({n}, {width}): row pass "
                f"{shape['rows_pass_ms']:.5f} ms, dw pass "
                f"{shape['dw_pass_ms']:.5f} ms ({partial.shape[0]} partial "
                f"rows)")
        shapes.append(shape)
        worst = max(worst, err)
        del x, w, y, xr, wr, yr, xl, wl, yl, again
    return {"name": "rmsnorm_bwd", "route": "triton",
            "source": "src/repro_torch/kernels/rmsnorm.py",
            "replaces": "src/repro/kernels/rmsnorm.py:44",
            "max_abs_err": worst, "shapes": shapes}


def check_flash_bwd(cfg, cases) -> dict:
    """K2-bwd at each ``(batch, seq)`` of ``cases`` (the first is the
    training shape, the main one), bf16 and fp32, against autograd
    through the plain version: fp32 dq/dk/dv within 1e-4 x max|ref| per
    tensor; bf16 within 2 bf16 ulps of each row's largest |ref| (fp32
    math in another order, then one rounding). The forward at each shape,
    as the training path calls it (it also writes the LSE and the fp32
    output for the backward), within 1 bf16 ulp per row in bf16 and
    1e-5 in fp32."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda, flash_attention_ref)

    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(6)
    shapes, worst = [], 0.0
    for (batch, seq), dtype in ((c, dt) for c in cases
                                for dt in (torch.bfloat16, torch.float32)):
        # the model's (B, S, H, D) activations, passed transposed
        base = [torch.randn((batch, seq, n, dh), generator=gen,
                            device="cuda").to(dtype) for n in (h, kv, kv)]
        dout = torch.randn((batch, seq, h, dh), generator=gen,
                           device="cuda").to(dtype).transpose(1, 2)
        leaves = [t.clone().requires_grad_() for t in base]
        out = ops.flash_attention(*(t.transpose(1, 2) for t in leaves))
        out.backward(dout)
        ref_leaves = [t.clone().requires_grad_() for t in base]
        ref_in = [t.transpose(1, 2) for t in ref_leaves]
        ref_out = flash_attention_ref(*ref_in)
        refs = torch.autograd.grad(ref_out, ref_in, dout, retain_graph=True)
        torch.cuda.synchronize()
        fwd_err = (out.float() - ref_out.float()).abs().max().item()
        if dtype == torch.bfloat16:
            fwd_ulps = bf16_ulps(out, ref_out)
            fwd_ok, fwd_tol = fwd_ulps <= 1.0, "1 bf16 ulp per row"
        else:
            fwd_ulps, fwd_ok, fwd_tol = None, fwd_err <= 1e-5, 1e-5
        if not (fwd_ok and torch.isfinite(out).all()):
            raise AssertionError(
                f"flash_attention (training forward) B={batch} S={seq} "
                f"{dtype}: max err {fwd_err}, {fwd_ulps} bf16 ulps; tol "
                f"{fwd_tol}")
        errs, ulps = [], []
        for t, r in zip(leaves, refs):
            got = t.grad.transpose(1, 2)
            errs.append((got.float() - r.float()).abs().max().item())
            if dtype == torch.bfloat16:
                ulps.append(bf16_ulps(got, r))
            else:
                ulps.append(errs[-1] / r.float().abs().max().item())
        if dtype == torch.bfloat16:
            ok, tol = max(ulps) <= 2.0, "2 bf16 ulps per row"
        else:
            ok, tol = max(ulps) <= 1e-4, "1e-4 x max|ref| per tensor"
        if not ok or not all(torch.isfinite(t.grad).all() for t in leaves):
            raise AssertionError(f"flash_attention_bwd B={batch} S={seq} "
                                 f"{dtype}: dq/dk/dv {ulps} against {tol}")
        q, k, v = (t.transpose(1, 2) for t in base)
        _, lse, o32 = flash_attention_cuda(q, k, v, for_backward=True)
        esize = q.element_size()
        # the forward as the training path calls it: it also writes the
        # fp32 output and the LSE for the backward
        fwd_bytes = (2 * batch * seq * h * dh + 2 * batch * seq * kv * dh) \
            * esize + batch * seq * h * dh * 4 + batch * h * seq * 4
        fwd_flops = batch * 4 * h * dh * seq * (seq + 1) / 2
        fwd_b_ms, fwd_b_by = bound(fwd_bytes, fwd_flops, BF16_FLOPS_PER_S
                                   if dtype == torch.bfloat16
                                   else FP32_FLOPS_PER_S)
        fwd_ms, fwd_host_ms = timed(lambda: flash_attention_cuda(
            q, k, v, for_backward=True))
        with torch.no_grad():
            fwd_lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
        # read q, k, v, dO, the fp32 output and LSE; write dq, dk, dv
        nbytes = (3 * batch * seq * h * dh + 4 * batch * seq * kv * dh) \
            * esize + batch * seq * h * dh * 4 + batch * h * seq * 4
        # recomputed scores, dP, dV, dK, dQ: five products over the
        # causal triangle
        flops = batch * 5 * 2 * h * dh * seq * (seq + 1) / 2
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S
                           if dtype == torch.bfloat16 else FP32_FLOPS_PER_S)
        ms, host_ms = timed(lambda: flash_attention_bwd_cuda(q, k, v, o32,
                                                             dout, lse))
        lib_leaves = [t.clone().requires_grad_() for t in base]
        lib_in = [t.transpose(1, 2) for t in lib_leaves]
        lib_out = F.scaled_dot_product_attention(*lib_in, is_causal=True,
                                                 enable_gqa=True)
        dname = str(dtype).replace("torch.", "")
        shapes.append({
            "shape": {"B": batch, "S": seq, "H": h, "KV": kv, "D": dh},
            "tokens": batch * seq, "dtype": dname,
            "dtype_route": FLASH_ROUTES[dname],
            "main": (batch, seq) == tuple(cases[0])
            and dtype == torch.bfloat16,
            "max_abs_err": max(errs), "dq_dk_dv_errs": errs,
            "max_row_ulps" if dtype == torch.bfloat16 else "rel_errs": ulps,
            "tol": tol, "forward_max_abs_err": fwd_err,
            "forward_max_row_ulps": fwd_ulps, "forward_tol": fwd_tol,
            "ms": ms, "host_ms": host_ms,
            "plain_ms": cuda_ms(grad_timer(ref_out, ref_in, dout)),
            "library_ms": cuda_ms(grad_timer(lib_out, lib_in, dout)),
            "library": "autograd backward of scaled_dot_product_attention "
                       "(enable_gqa)",
            "bound_ms": b_ms, "bound_by": b_by,
            "forward": {"ms": fwd_ms, "host_ms": fwd_host_ms,
                        "library_ms": fwd_lib_ms,
                        "library": "scaled_dot_product_attention "
                                   "(enable_gqa), forward",
                        "bound_ms": fwd_b_ms, "bound_by": fwd_b_by,
                        "what": "flash_attention_cuda(for_backward=True): "
                                "the output, its fp32 copy and the LSE"}})
        worst = max(worst, max(errs))
        del out, leaves, ref_leaves, lib_leaves, ref_out, lib_out, refs
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:98",
            "dtype_routes": FLASH_ROUTES, "max_abs_err": worst,
            "shapes": shapes}


def check_ssd_scan(cfg) -> dict:
    """K4 at the mamba2-1.3b prefill shapes (the model's (B, S, H, P) and
    (B, S, G, N) activations, passed transposed, dt as the model's
    softplus makes it, a_log = log(1..H) as the init makes it) against
    the plain version on the same inputs. y: in bf16 within one bf16 ulp
    of each (head, position) row's largest |ref| (fp32 accumulation of
    products whose fp32 operands enter the tensor cores as bf16 parts,
    then one rounding); in fp32 within 1e-5 of it (summation order of the
    dot products; cum is summed in fp64 by both, so the decays agree to
    the last bit or two of ``exp``). The final state (fp32 in both) within
    1e-5 of its largest |ref|. A second call gives the same bits."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_scan_ref

    s = cfg.ssm
    h, p, n, g = s.n_heads(cfg.d_model), s.head_dim, s.d_state, s.n_groups
    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [(1, h, g, 512, p, n, bf16),     # the 512 bucket: 2 chunks
             (1, h, g, 128, p, n, bf16),     # the 128 bucket: 1 chunk
             (1, h, g, 512, p, n, fp32),
             (1, h, g, 159, p, n, bf16),     # ragged: one chunk of 159
             (2, h, 4, 256, p, 16, bf16)]    # G > 1, N 16
    gen = torch.Generator(device="cuda").manual_seed(8)
    shapes, worst = [], 0.0
    for b, h_, g_, seq, p_, n_, dtype in cases:
        x = torch.randn((b, seq, h_, p_), generator=gen, device="cuda").to(
            dtype).transpose(1, 2)
        dt = (torch.rand((b, seq, h_), generator=gen, device="cuda")
              * 0.099 + 0.001).transpose(1, 2)
        a_log = torch.log(torch.arange(1, h_ + 1, dtype=fp32,
                                       device="cuda"))
        bb, cc = (torch.randn((b, seq, g_, n_), generator=gen,
                              device="cuda").to(dtype).transpose(1, 2)
                  for _ in range(2))
        q = min(s.chunk, seq)
        a = -torch.exp(a_log)
        y, st = ops.ssd_scan(x, dt, a_log, bb, cc, chunk=s.chunk)
        y_ref, st_ref = ssd_scan_ref(x, dt, a, bb, cc, q)
        torch.cuda.synchronize()
        err = (y.float() - y_ref.float()).abs().max().item()
        st_rel = ((st - st_ref).abs().max() / st_ref.abs().max()).item()
        # bf16_ulps is the row's error over 2**-7 of its largest |ref|
        ulps = bf16_ulps(y, y_ref)
        if dtype == bf16:
            ok, tol = ulps <= 1.0, "y 1 bf16 ulp per row; state 1e-5"
        else:
            ok, tol = ulps * 2 ** -7 <= 1e-5, "y 1e-5 per row; state 1e-5"
        y2, st2 = ops.ssd_scan(x, dt, a_log, bb, cc, chunk=s.chunk)
        ibits = torch.int16 if dtype == bf16 else torch.int32
        same = (torch.equal(y2.view(ibits), y.view(ibits))
                and torch.equal(st2.view(torch.int32), st.view(torch.int32)))
        if not (ok and st_rel <= 1e-5 and same and torch.isfinite(y).all()
                and torch.isfinite(st).all()):
            raise AssertionError(
                f"ssd_scan B={b} H={h_} G={g_} S={seq} N={n_} {dtype}: y "
                f"{ulps} bf16 ulps per row (max err {err}), state rel err "
                f"{st_rel}, a second call the same bits {same}; tol {tol}")
        esize = x.element_size()
        # read x, dt, b, c, a; write y and the fp32 final state
        nbytes = (2 * b * h_ * seq * p_ + 2 * b * g_ * seq * n_) * esize \
            + b * h_ * seq * 4 + h_ * 4 + b * h_ * p_ * n_ * 4
        # per (batch, head, chunk): C B^T and W X over the causal
        # triangle, C S and X^T (B u) in full
        flops = b * h_ * (seq // q) * (q * (q + 1) * (n_ + p_)
                                       + 4 * q * n_ * p_)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S
                           if dtype == bf16 else FP32_FLOPS_PER_S)
        ms, host_ms = timed(lambda: ops.ssd_scan(x, dt, a_log, bb, cc,
                                                 chunk=s.chunk))
        shapes.append({
            "shape": {"B": b, "H": h_, "G": g_, "S": seq, "Q": q, "P": p_,
                      "N": n_},
            "tokens": b * seq, "dtype": str(dtype).replace("torch.", ""),
            "dtype_route": SSD_ROUTES[str(dtype).replace("torch.", "")],
            "main": seq == max(SERVE["buckets"]) and dtype == bf16,
            "max_abs_err": err, "max_row_ulps": ulps,
            "state_rel_err": st_rel, "same_bits_again": same,
            "tol": tol + "; a second call the same bits", "ms": ms,
            "host_ms": host_ms,
            # ~50 launches a call: 10 calls stay within the card's queue
            # of pending launches, so the spin still covers the queueing
            "plain_ms": timed(lambda: ssd_scan_ref(x, dt, a, bb, cc, q),
                              iters=10)[0],
            "library_ms": None,
            "library": "none: no PyTorch call computes it",
            "bound_ms": b_ms, "bound_by": b_by})
        worst = max(worst, err)
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:98",
            "dtype_routes": SSD_ROUTES, "max_abs_err": worst,
            "shapes": shapes}


def train_layout(cfg):
    """The full-width gradient layout of the train phase, built from
    storage-free (meta) parameters."""
    import torch

    from repro_torch.dist import bucket_layout
    from repro_torch.models.model import Model
    from repro_torch.train.step import accumulator_specs

    params = Model(cfg, torch.device("meta")).init(torch.Generator())
    return bucket_layout(accumulator_specs(params), max_bucket_elems=int(
        TRAIN["bucket_mb"] * (1 << 20) // 4))


def check_int8_ef(cfg) -> list[dict]:
    """K3a and K3b at the largest bucket of the full-width layout and at a
    ragged 1,000,003 elements, bf16 and fp32 grads, an all-zero input and
    one with a NaN and an infinity: q, scale and the residual
    bit-identical to the plain version (NaN where it has NaN)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.int8_ef import (int8_ef_absmax_cuda,
                                             int8_ef_absmax_ref,
                                             int8_ef_quantize_cuda,
                                             int8_ef_quantize_ref,
                                             int8_ef_ref)

    largest = max(train_layout(cfg).bucket_sizes)
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = [(largest, torch.float32, None), (largest, torch.bfloat16, None),
             (1_000_003, torch.float32, None),
             (1_000_003, torch.bfloat16, None),
             (1_000_003, torch.float32, "zero"),
             (1_000_003, torch.float32, "nan")]
    rows = {"int8_ef_absmax": [], "int8_ef_quantize": []}
    for n, dtype, special in cases:
        if special == "zero":
            g = torch.zeros(n, dtype=dtype, device="cuda")
            e = torch.zeros(n, device="cuda")
        else:
            g = (torch.randn(n, generator=gen, device="cuda") * 1e-3).to(
                dtype)
            e = torch.randn(n, generator=gen, device="cuda") * 1e-5
        if special == "nan":
            g[[17, n // 2]] = torch.tensor([float("nan"), float("inf")],
                                           dtype=dtype, device="cuda")
        q, scale, err = ops.int8_ef_quantize(g, e)
        q_ref, scale_ref, err_ref = int8_ef_ref(g, e)
        torch.cuda.synchronize()
        same = (torch.equal(q, q_ref) and same_bits(scale, scale_ref)
                and same_bits(err, err_ref))
        if special == "nan":
            same = same and bool(scale.isnan()) and bool(err.isnan().all())
        err_abs = (err - err_ref).abs().max().item()
        if not same:
            raise AssertionError(
                f"int8_ef n={n} {dtype} {special}: not bit-identical "
                f"(q equal {torch.equal(q, q_ref)}, scale {scale.item()} vs "
                f"{scale_ref.item()}, residual max diff {err_abs})")
        del q, err, q_ref, err_ref
        gsize = g.element_size()
        common = {"n": n, "dtype": str(dtype).replace("torch.", ""),
                  "input": special or "random", "bit_identical": True,
                  "max_abs_err": 0.0, "tol": "bit-identical",
                  "main": n == largest and dtype == torch.float32,
                  "tokens": n, "shape": [n], "library_ms": None,
                  "library": "none: no PyTorch call computes it"}
        amax = int8_ef_absmax_cuda(g, e)
        amax_ref = int8_ef_absmax_ref(g, e)
        b_ms, b_by = bound(n * (gsize + 4) + 4, 3 * n, FP32_FLOPS_PER_S)
        ms, host_ms = timed(lambda: int8_ef_absmax_cuda(g, e), iters=20)
        rows["int8_ef_absmax"].append(dict(
            common, ms=ms, host_ms=host_ms, bound_ms=b_ms, bound_by=b_by,
            plain_ms=timed(lambda: int8_ef_absmax_ref(g, e), iters=20)[0]))
        b_ms, b_by = bound(n * (gsize + 4) + n * (1 + 4) + 8, 7 * n,
                           FP32_FLOPS_PER_S)
        ms, host_ms = timed(lambda: int8_ef_quantize_cuda(g, e, amax),
                            iters=20)
        rows["int8_ef_quantize"].append(dict(
            common, ms=ms, host_ms=host_ms, bound_ms=b_ms, bound_by=b_by,
            plain_ms=timed(lambda: int8_ef_quantize_ref(g, e, amax_ref),
                           iters=20)[0]))
        del g, e, amax, amax_ref
        torch.cuda.empty_cache()
    return [{"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/int8_ef.cu",
             "replaces": "src/repro/kernels/int8_ef.py:" + line,
             "max_abs_err": 0.0, "shapes": rows[name]}
            for name, line in (("int8_ef_absmax", "89"),
                               ("int8_ef_quantize", "101"))]


def kernel_phase(cfg, cfg_ssm) -> list[dict]:
    import torch

    micro_rows = TRAIN["n_groups"] * TRAIN["per_type_batch"]
    rows = [(r, cfg.d_model) for r in (SERVE["slots"], *SERVE["buckets"])]
    # the mamba2 gated norm's width (d_inner) at the longest prompt, and
    # one training microbatch
    rows.append((max(SERVE["buckets"]), cfg_ssm.ssm.d_inner(
        cfg_ssm.d_model)))
    rows.append((micro_rows * TRAIN["seq"], cfg.d_model))
    seqs = [(1, s, torch.bfloat16) for s in SERVE["buckets"]]
    seqs += [(1, 200, torch.bfloat16),
             (1, SERVE["buckets"][-1], torch.float32)]
    # the campaign's live cells (phase 12) at their own microbatches
    campaign = campaign_microbatches()
    seqs += [(b, s, torch.bfloat16) for b, s in campaign]
    out = [check_rmsnorm(cfg, rows), check_flash(cfg, seqs),
           check_rmsnorm_bwd(cfg, micro_rows * TRAIN["seq"],
                             [b * s for b, s in campaign]),
           check_flash_bwd(cfg, [(micro_rows, TRAIN["seq"]), *campaign]),
           *check_int8_ef(cfg), check_ssd_scan(cfg_ssm)]
    for k in out:
        for sh in k["shapes"]:
            lib = sh["library_ms"]
            route = f" [{sh['dtype_route']}]" if "dtype_route" in sh else ""
            log(f"[kernels] {k['name']} {sh['shape']} {sh['dtype']}{route}: "
                f"err {sh['max_abs_err']:.3g} "
                f"({sh.get('max_row_ulps')} ulps) ms {sh['ms']:.5f} (host "
                f"{sh['host_ms']:.4f}) plain {sh['plain_ms']:.5f} library "
                f"{'none' if lib is None else f'{lib:.5f}'} "
                f"bound {sh['bound_ms']:.5f} ({sh['bound_by']})")
            if "launch_floor_ms" in sh:
                log(f"[kernels]   launch floor (an empty kernel): ms "
                    f"{sh['launch_floor_ms']:.5f} (host "
                    f"{sh['launch_floor_host_ms']:.4f})")
            if "forward" in sh:
                f = sh["forward"]
                log(f"[kernels]   its forward at that shape: ms "
                    f"{f['ms']:.5f} library {f['library_ms']:.5f} bound "
                    f"{f['bound_ms']:.5f} ({f['bound_by']})")
    return out


# ------------------------------------------------------------------ #
# reference phase: card (kernels) vs CPU (plain versions), fp32       #
# ------------------------------------------------------------------ #
def serve_tokens(model, params, cfg, n_requests, **kw):
    from repro_torch.data import RequestStream
    from repro_torch.serve import ServeEngine, pool_pages_for

    buckets, max_new, ps = kw["buckets"], kw["max_new"], kw["page_size"]
    eng = ServeEngine(model, params, n_slots=kw["slots"], page_size=ps,
                      max_new=max_new, buckets=buckets,
                      n_pages=pool_pages_for(kw["slots"],
                                             max(buckets) + max_new, ps))
    eng.warmup()
    for r in RequestStream(cfg, buckets=buckets, max_new=max_new,
                           seed=3).requests(n_requests):
        eng.submit(r)
    return {d.req_id: d.tokens for d in eng.run()}


def serve_reference(cfg, prompt_len: int, buckets, tag: str) -> dict:
    """``cfg`` in fp32 on the card (kernels) and on the CPU (plain
    versions), from the same parameters: the prefill logits of a
    ``prompt_len`` prompt within 1e-4 (summation order through two
    layers and the tied head), and the greedy tokens of 5 requests
    identical."""
    import numpy as np
    import torch

    from repro_torch.models import build_model, cast_params

    cpu = build_model(cfg, device="cpu")
    cuda = build_model(cfg, device="cuda")
    params_cpu = cast_params(cpu.init(0), dtype=torch.float32)
    params_gpu = cast_params(params_cpu, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (1, prompt_len)))
    with torch.no_grad():
        l_cpu, _ = cpu.prefill(params_cpu, toks)
        l_gpu, _ = cuda.prefill(params_gpu, toks.to("cuda"))
    err = (l_gpu.cpu() - l_cpu).abs().max().item()
    if not err <= 1e-4:
        raise AssertionError(f"{tag}: fp32 prefill logits differ by "
                             f"{err} > 1e-4")
    kw = dict(slots=2, page_size=16, buckets=buckets, max_new=6)
    t_cpu = serve_tokens(cpu, params_cpu, cfg, 5, **kw)
    t_gpu = serve_tokens(cuda, params_gpu, cfg, 5, **kw)
    same = all(np.array_equal(t_cpu[r], t_gpu[r]) for r in t_cpu)
    if t_cpu.keys() != t_gpu.keys() or not same:
        raise AssertionError(f"{tag}: greedy tokens on the card differ "
                             f"from the CPU's")
    log(f"[{tag}] fp32 logits max err {err:.3g}; tokens identical over "
        f"{len(t_cpu)} requests")
    return {"prefill_logits_max_abs_err": err, "tol": 1e-4,
            "prompt_len": prompt_len, "buckets": list(buckets),
            "requests": len(t_cpu), "tokens_identical": True}


def reference_phase(cfg_full) -> dict:
    cfg = cfg_full.scaled(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                          head_dim=128, d_ff=512, vocab=1000)
    return serve_reference(cfg, 96, (32, 80), "reference")


def ssm_reference_phase(cfg_full) -> dict:
    """Full-width heads (head_dim 64, d_state 128) in chunks of 64, so
    the 128-token prompt carries the state across a chunk boundary."""
    from dataclasses import replace

    cfg = cfg_full.scaled(n_layers=2, d_model=256, vocab=1000,
                          ssm=replace(cfg_full.ssm, chunk=64))
    return serve_reference(cfg, 128, (64, 128), "ssm reference")


# ------------------------------------------------------------------ #
# slice phase: the main path                                         #
# ------------------------------------------------------------------ #
def run_server(model, params, cfg, kill: str | None, ckpt_dir=None):
    """Build the server through the launcher's ``build_server`` (``kill``
    a ``STEP:R[,R]`` script or None; ``ckpt_dir`` enables the wipe-out
    reload, after a blocking save of the params at construction), warm
    it up and drain the request set. The reloads are timed."""
    import torch

    from repro_torch.data import RequestStream
    from repro_torch.launch.serve import build_server, serve_and_measure
    from repro_torch.obs import Telemetry

    args = argparse.Namespace(
        replicas=SERVE["replicas"], slots=SERVE["slots"],
        page_size=SERVE["page_size"], max_new=SERVE["max_new"],
        buckets=",".join(str(b) for b in SERVE["buckets"]), kill=kill,
        failure_model=None, ckpt_dir=ckpt_dir)
    tel = Telemetry(trace=False)
    t0 = time.perf_counter()
    srv = build_server(args, model, params, telemetry=tel)
    build_s = time.perf_counter() - t0
    reload_s: list[float] = []
    if srv.ckpt is not None:
        restore = srv.ckpt.restore_latest

        def timed_restore(tree_like):
            t0 = time.perf_counter()
            out = restore(tree_like)
            torch.cuda.synchronize()
            reload_s.append(time.perf_counter() - t0)
            return out
        srv.ckpt.restore_latest = timed_restore
    srv.warmup()
    frozen = srv.recompiles
    stream = RequestStream(cfg, buckets=SERVE["buckets"],
                           max_new=SERVE["max_new"], seed=SERVE["seed"])
    done, wall = serve_and_measure(srv, stream.requests(SERVE["requests"]))
    torch.cuda.synchronize()
    hist = tel.snapshot()["histograms"]
    calls = {"prefills": hist["serve.prefill_latency_s"]["count"],
             "decode_steps": hist["serve.token_latency_s"]["count"]}
    return {"srv": srv, "done": done, "wall": wall, "frozen": frozen,
            "calls": calls, "build_s": build_s, "reload_s": reload_s}


def serve_run_record(run) -> dict:
    """What a serving run reports, for its gates and the JSON."""
    from repro_torch.obs.metrics import latency_stats

    srv, done, wall = run["srv"], run["done"], run["wall"]
    stats = latency_stats(done)
    return {**run["calls"], "completed": len(done), "dropped": srv.dropped,
            "requests": SERVE["requests"],
            "misses_after_warmup": srv.recompiles - run["frozen"],
            "events": srv.report()["events"], "wall_s": wall,
            "tokens_per_s": stats["tokens"] / wall, **stats,
            "n_tokens": stats["tokens"],
            "tokens": {d.req_id: d.tokens for d in done}}


def serve_launches_want(launches, runs, cfg) -> dict:
    """The launch counts the serving runs imply: every prefill runs 2
    RMSNorms per layer (ln1 + ln2, or ln1 + the gated norm) + the final
    one and one mixer kernel per layer; every decode step the same
    RMSNorms; serving runs no backward and no gradient sync."""
    mixer = "ssd_scan" if cfg.family == "ssm" else "flash_attention"
    prefills = sum(r["prefills"] for r in runs)
    steps = sum(r["decode_steps"] for r in runs)
    want = dict.fromkeys(launches, 0)
    want.update({"rmsnorm": (prefills + steps) * (2 * cfg.n_layers + 1),
                 mixer: prefills * cfg.n_layers})
    return want


def wipeout_run(model, params, cfg, healthy: dict, tag: str) -> dict:
    """The third serving run: the same set-up with a
    ``CheckpointManager`` (the params saved at construction under
    ``chiprun_out/``, removed after) and a ``ScriptedInjector`` that
    kills both replicas at ``kill_step``: the wipe-out reloads the
    params from the checkpoint onto the card and rebuilds the engines.
    Every request completes with the healthy run's tokens, nothing is
    dropped or rebuilt, the reload restores the params' bits, and the
    launch counters (set to 0 just before, read just after) match the
    prefills and decode steps run."""
    import shutil

    import numpy as np

    from repro_torch.dist import tree_leaves
    from repro_torch.kernels import ops

    ckpt_dir = ROOT / "chiprun_out" / "serve_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    victims = ",".join(str(r) for r in range(SERVE["replicas"]))
    try:
        ops.reset_launches()
        run = run_server(model, params, cfg, f"{SERVE['kill_step']}:"
                         f"{victims}", ckpt_dir=str(ckpt_dir))
        launches = dict(ops.launches)
        ckpt_gib = sum(f.stat().st_size for f in ckpt_dir.rglob("*")
                       if f.is_file()) / GIB
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    rec = serve_run_record(run)
    srv = run["srv"]
    if rec["completed"] != SERVE["requests"] or rec["dropped"]:
        raise AssertionError(f"{tag} wipeout: {rec['completed']} of "
                             f"{SERVE['requests']} completed, "
                             f"{rec['dropped']} dropped")
    if rec["misses_after_warmup"]:
        raise AssertionError(f"{tag} wipeout: rebuilt after warmup")
    if not any(e[1] == "wipeout" for e in rec["events"]) \
            or len(run["reload_s"]) != 1:
        raise AssertionError(f"{tag} wipeout: events {rec['events']}, "
                             f"{len(run['reload_s'])} reloads")
    for rid, toks in healthy.items():
        if not np.array_equal(toks, rec["tokens"][rid]):
            raise AssertionError(f"{tag} wipeout: request {rid}'s tokens "
                                 f"differ from the healthy run's")
    if checksums(tree_leaves(srv.params)) != checksums(tree_leaves(params)):
        raise AssertionError(f"{tag} wipeout: the reloaded params differ")
    want = serve_launches_want(launches, [rec], cfg)
    if launches != want:
        raise AssertionError(f"{tag} wipeout: launches {launches} != "
                             f"{want}")
    log(f"[{tag}] wipeout: both replicas killed at server step "
        f"{SERVE['kill_step']}; {rec['completed']}/{SERVE['requests']} "
        f"requests, tokens identical to the healthy run's; params "
        f"({ckpt_gib:.2f} GiB on disk) saved at construction, server "
        f"built in {run['build_s']:.2f} s; reload from the checkpoint "
        f"{run['reload_s'][0]:.2f} s; {rec['tokens_per_s']:.1f} tok/s")
    rec.update(reload_s=run["reload_s"][0], build_s=run["build_s"],
               ckpt_gib=ckpt_gib, launches=launches)
    return rec


def slice_phase(cfg, tag: str = "slice") -> dict:
    """The serving main path on ``cfg`` at full width, with its gates
    (see the module doc). An attention model launches K2 once per layer
    per prefill, an SSM model K4; both launch K1 twice per layer and once
    at the head, per prefill and per decode step."""
    import numpy as np
    import torch

    from repro_torch.data import RequestStream
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    params = model.init(SERVE["seed"])
    torch.cuda.synchronize()
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, init {time.perf_counter() - t0:.1f} s")

    ops.reset_launches()
    runs = {}
    for name, kill in (("healthy", None),
                       ("burst", f"{SERVE['kill_step']}:0")):
        r = runs[name] = serve_run_record(run_server(model, params, cfg,
                                                     kill))
        log(f"[{tag}] {name}: {r['completed']}/{SERVE['requests']} "
            f"requests, {r['n_tokens']} tokens in {r['wall_s']:.2f} s = "
            f"{r['tokens_per_s']:.1f} tok/s, p50 {r['p50_ms']} ms, "
            f"p99 {r['p99_ms']} ms, events {r['events']}")
    launches = dict(ops.launches)

    for name, r in runs.items():
        if r["completed"] != SERVE["requests"] or r["dropped"]:
            raise AssertionError(f"{name}: {r['completed']} of "
                                 f"{SERVE['requests']} completed, "
                                 f"{r['dropped']} dropped")
        if r["misses_after_warmup"]:
            raise AssertionError(f"{name}: rebuilt after warmup")
    if not any(e[1] == "kill" for e in runs["burst"]["events"]):
        raise AssertionError("burst run delivered no kill")
    for rid, toks in runs["healthy"]["tokens"].items():
        if not np.array_equal(toks, runs["burst"]["tokens"][rid]):
            raise AssertionError(f"request {rid}: burst tokens differ")
    mixer = "ssd_scan" if cfg.family == "ssm" else "flash_attention"
    for name in ("rmsnorm", mixer):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"serving path")
    want = serve_launches_want(launches, runs.values(), cfg)
    if launches != want:
        raise AssertionError(f"launches {launches} != {want} for "
                             f"{sum(r['prefills'] for r in runs.values())} "
                             f"prefills, "
                             f"{sum(r['decode_steps'] for r in runs.values())}"
                             f" decode steps")

    # output sanity on the main path's model: finite logits of the
    # expected shape, and the paged decode agreeing with the prefill on
    # the generated continuation. An SSM prefill takes a length that its
    # chunk divides: a request of the 128 bucket (128 + 31 = 159 tokens,
    # one chunk), not of the 512 bucket (543 tokens)
    rid = 0
    if cfg.family == "ssm":
        stream = RequestStream(cfg, buckets=SERVE["buckets"],
                               max_new=SERVE["max_new"], seed=SERVE["seed"])
        rid = next(i for i in range(SERVE["requests"])
                   if stream.request(i).prompt_len == min(SERVE["buckets"]))
    check = decode_vs_prefill(model, params, cfg, rid,
                              runs["healthy"]["tokens"][rid], tag)
    dense = wipeout = None
    if cfg.family != "ssm":
        dense = default_spellings(model, params, cfg, rid,
                                  runs["healthy"]["tokens"][rid], tag)
        wipeout = runs["wipeout"] = wipeout_run(
            model, params, cfg, runs["healthy"]["tokens"], tag)
    for r in runs.values():
        r["tokens"] = {k: v.tolist() for k, v in r["tokens"].items()}
    config = {"arch": cfg.name, "n_layers": cfg.n_layers,
              "d_model": cfg.d_model, "vocab": cfg.vocab,
              "dtype": "bfloat16"}
    if cfg.family == "ssm":
        from dataclasses import asdict

        config["ssm"] = asdict(cfg.ssm)
    else:
        config.update(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                      d_ff=cfg.d_ff)
    return {"config": config,
            "serve": dict(SERVE, buckets=list(SERVE["buckets"])),
            "launches": launches, "runs": runs, "check": check,
            "default_spellings": dense,
            "wipeout_launches": None if wipeout is None
            else wipeout.pop("launches")}


def default_spellings(model, params, cfg, rid, generated,
                      tag="slice") -> dict:
    """The builders' default spellings at full width, on request
    ``rid``'s prompt, with the launch counters set to 0 just before and
    read just after: ``make_prefill(model)`` (last-position logits of
    the training forward) against the last position of the cache-filling
    prefill, within one bf16 ulp per row (both run the same kernels, so
    the same bits are expected); then ``make_serve_step(model)`` (the
    dense step at a scalar position) over dense caches filled from that
    prefill, fed the paged engine's tokens: at each position the paged
    engine's next token must be within 0.25 of the dense step's best
    logit, the gap :func:`decode_vs_prefill` allows."""
    import numpy as np
    import torch

    from repro_torch.data import RequestStream
    from repro_torch.kernels import ops
    from repro_torch.train import make_prefill, make_serve_step

    req = RequestStream(cfg, buckets=SERVE["buckets"],
                        max_new=SERVE["max_new"],
                        seed=SERVE["seed"]).request(rid)
    prompt = torch.from_numpy(req.tokens.astype(np.int64))[None].cuda()
    s, n = prompt.shape[1], len(generated)
    ops.reset_launches()
    last = make_prefill(model)(params, prompt)
    full, cache = make_prefill(model, return_cache=True)(params, prompt)
    state = model.init_decode_state(1, s + n)
    for big, small in zip(_leaves(state), _leaves(cache)):
        big[:, :, :small.shape[2]].copy_(small)
    step = make_serve_step(model)
    logits = [last]
    for i in range(n - 1):
        tok = torch.tensor([[int(generated[i])]], device="cuda")
        out, state = step(params, state, s + i, tok)
        logits.append(out)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    want = dict.fromkeys(launches, 0)
    want.update({"rmsnorm": (2 + n - 1) * (2 * cfg.n_layers + 1),
                 "flash_attention": 2 * cfg.n_layers})
    if launches != want:
        raise AssertionError(f"{tag} default spellings: launches "
                             f"{launches} != {want}")
    ulps = bf16_ulps(last, full[:, -1, :])
    same = torch.equal(last.view(torch.int16),
                       full[:, -1, :].contiguous().view(torch.int16))
    if tuple(last.shape) != (1, cfg.padded_vocab) or not ulps <= 1.0:
        raise AssertionError(f"{tag}: make_prefill(model) {tuple(last.shape)}"
                             f", {ulps} bf16 ulps from the cached prefill")
    lg = torch.cat(logits)[:, :cfg.vocab].float()
    if not torch.isfinite(lg).all():
        raise AssertionError(f"{tag}: dense step logits not finite")
    chosen = torch.from_numpy(np.asarray(generated, np.int64)).cuda()
    agree = (lg.argmax(-1) == chosen).float().mean().item()
    gap = (lg.max(-1).values - lg.gather(1, chosen[:, None])[:, 0]).max(
        ).item()
    log(f"[{tag}] make_prefill(model): {ulps} bf16 ulps from the cached "
        f"prefill's last position (bit-identical: {same}); "
        f"make_serve_step(model) over {n - 1} dense steps: greedy "
        f"agreement with the paged engine {agree:.3f}, largest logit gap "
        f"{gap:.4f}")
    if not gap <= 0.25:
        raise AssertionError(f"{tag}: the paged engine chose a token {gap} "
                             f"below the dense step's best")
    return {"request": rid, "prompt_len": s, "prefill_max_row_ulps": ulps,
            "prefill_bit_identical": same, "dense_steps": n - 1,
            "greedy_agreement": agree, "max_logit_gap": gap, "tol": 0.25,
            "launches": launches}


def _leaves(tree) -> list:
    """The tensors of a tree of lists and tuples, in order."""
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _leaves(sub)]
    return [tree]


# ------------------------------------------------------------------ #
# training: reference (card vs CPU) and the main path                #
# ------------------------------------------------------------------ #
def _executor(cfg, device, **kw):
    from repro_torch.exec import MeshExecutor

    return MeshExecutor(cfg, n_groups=kw.pop("n_groups", 4),
                        redundancy=kw.pop("r", 2), device=device,
                        total_steps=50, **kw)


def record_sync(ex, out: list) -> None:
    """Record every bucket the executor's int8 EF sync handles: checksums
    of the residuals it reads, and host copies of the synced bucket and
    of the residuals it leaves."""
    inner = ex._grad_sync._sync_bucket

    def recorded(buf, e1, e2):
        read = checksums([e1, e2])
        inner(buf, e1, e2)
        out.append({"read": read, "synced": buf.detach().to("cpu", copy=True),
                    "err1": e1.to("cpu", copy=True),
                    "err2": e2.to("cpu", copy=True)})

    ex._grad_sync._sync_bucket = recorded


def train_reference_phase(cfg_full) -> dict:
    """Three MeshExecutor steps of a small fp32 configuration on the card
    (kernels) and on the CPU (plain versions), from the same parameters
    and batches. With fp32 buckets, losses within 1e-5 relative and
    params within 1e-5. With int8 EF, each step starts the CPU from the
    card's params, moments and EF residuals, so that the two differ by
    summation order only and a code that rounds the other way at one
    step does not carry into the next; at every step the losses are
    within 1e-5 relative, the synced gradients within one int8 quantum
    (max|g| / 127) of their bucket (codes of that quantum within 1,
    scales within 1e-5) and the residuals within one quantum (each is at
    most half of its own); and the card's sync reads, bit for bit, the
    residuals it wrote at the step before (zero at the first step,
    not zero after it)."""
    import copy

    import torch

    from repro_torch.dist import tree_leaves
    from repro_torch.models import cast_params
    from repro_torch.optim import adamw_init
    from repro_torch.ckpt.checkpoint import copy_into

    cfg = cfg_full.scaled(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                          head_dim=128, d_ff=512, vocab=1000, grad_accum=1)
    out = {}
    for compress in (None, "int8_ef"):
        kw = dict(seq=64, per_type_batch=1, grad_compress=compress,
                  bucket_mb=0.25)
        cpu, gpu = _executor(cfg, "cpu", **kw), _executor(cfg, "cuda", **kw)
        params = cast_params(cpu.params, dtype=torch.float32)
        for ex in (cpu, gpu):
            # each its own copy: the step updates params in place
            ex.params = cast_params(copy.deepcopy(params), device=ex.device)
            ex.opt_state = adamw_init(ex.params)
        if compress is None:
            rc, rg = cpu.run(3), gpu.run(3)
            rel = max(abs(a - b) / abs(a)
                      for a, b in zip(rc.losses, rg.losses))
            perr = max((a - b.cpu()).abs().max().item() for a, b in zip(
                tree_leaves(cpu.params), tree_leaves(gpu.params)))
            if not (rel <= 1e-5 and perr <= 1e-5):
                raise AssertionError(f"train reference fp32: losses rel "
                                     f"{rel}, params {perr} (> 1e-5)")
            out["fp32"] = {"steps": 3, "losses_cpu": rc.losses,
                           "losses_card": rg.losses, "loss_rel_err": rel,
                           "param_max_abs_err": perr, "tol": 1e-5}
            log(f"[reference] train fp32: losses rel err {rel:.3g}, params "
                f"{perr:.3g} over 3 steps")
            continue
        rec_c, rec_g = [], []
        record_sync(cpu, rec_c)
        record_sync(gpu, rec_g)
        losses_c, losses_g, worst = [], [], dict.fromkeys(
            ("loss", "codes", "scales", "residual_quanta", "flipped"), 0.0)
        wrote = None          # the card's residuals after the step before
        for t in range(3):
            copy_into((cpu.params, cpu.opt_state, cpu._ef_state),
                      (gpu.params, gpu.opt_state, gpu._ef_state))
            rec_c.clear()
            rec_g.clear()
            losses_c += cpu.run(1).losses
            losses_g += gpu.run(1).losses
            worst["loss"] = max(worst["loss"], abs(losses_c[-1] - losses_g[-1])
                                / abs(losses_c[-1]))
            read = [r["read"] for r in rec_g]
            want = ([[0, 0]] * len(rec_g) if wrote is None else
                    [checksums([r["err1"], r["err2"]]) for r in wrote])
            carried = (read == want and [r["read"] for r in rec_c] == read
                       and (t == 0 or any(r["err1"].any() for r in wrote)))
            if not carried:
                raise AssertionError(
                    f"train reference int8_ef step {t}: the card's sync "
                    f"did not read the residuals it wrote at the step "
                    f"before (or the CPU did not start from them)")
            wrote = rec_g[:]
            # each bucket comes back as int8 codes times one scale (max|g|
            # / 127): the codes within one quantum, the scales within fp32
            # summation noise (the two gradients differ by summation order)
            for a, b in zip(rec_c, rec_g):
                ga, gb = a["synced"], b["synced"]
                sa, sb = ga.abs().max() / 127.0, gb.abs().max() / 127.0
                if sa == 0 or sb == 0:
                    worst["codes"] = max(worst["codes"], float(sa != sb) * 128)
                    continue
                diff = ((ga / sa).round() - (gb / sb).round()).abs()
                worst["codes"] = max(worst["codes"], diff.max().item())
                worst["flipped"] += int(diff.count_nonzero())
                worst["scales"] = max(worst["scales"], abs(sa / sb - 1).item())
                quantum = max(sa, sb).item()
                for key in ("err1", "err2"):
                    worst["residual_quanta"] = max(
                        worst["residual_quanta"],
                        (a[key] - b[key]).abs().max().item() / quantum)
            if not (worst["loss"] <= 1e-5 and worst["codes"] <= 1.0
                    and worst["scales"] <= 1e-5
                    and worst["residual_quanta"] <= 1.0 + 1e-5):
                raise AssertionError(f"train reference int8_ef step {t}: "
                                     f"{worst} (loss, scales > 1e-5; codes, "
                                     f"residuals > 1 quantum)")
        out["int8_ef"] = {
            "steps": 3, "buckets": len(rec_g), "losses_cpu": losses_c,
            "losses_card": losses_g, "loss_rel_err": worst["loss"],
            "max_code_diff": worst["codes"],
            "codes_flipped": int(worst["flipped"]),
            "max_scale_rel_diff": worst["scales"],
            "max_residual_diff_quanta": worst["residual_quanta"],
            "residuals_carried": True,
            "tol": "each step from the card's state: losses 1e-5 relative; "
                   "codes within 1 int8 quantum per element; scales 1e-5 "
                   "relative; residuals within 1 quantum; the card's "
                   "residuals carried bit for bit"}
        log(f"[reference] train int8_ef: 3 steps, losses rel err "
            f"{worst['loss']:.3g}, synced codes within {worst['codes']:g} "
            f"({int(worst['flipped'])} flipped), scales within "
            f"{worst['scales']:.3g}, residuals within "
            f"{worst['residual_quanta']:.3g} quanta over {len(rec_g)} "
            f"buckets; residuals carried")
    return out


def checksums(tensors) -> list[int]:
    """Bitwise checksums: the int64 sum of each tensor's bits."""
    import torch

    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return [int(t.view(ints[t.element_size()]).sum(dtype=torch.int64))
            for t in tensors]


def _state_tensors(ex) -> list:
    from repro_torch.dist import tree_leaves

    return (tree_leaves(ex.params) + tree_leaves(ex.opt_state.mu)
            + tree_leaves(ex.opt_state.nu)
            + list(ex._ef_state["err1"]) + list(ex._ef_state["err2"]))


def instrument(ex, rec: dict, tag: str = "train") -> None:
    """Record, per executed step, its schedule, loss, host time, the
    sync's device time (CUDA events around each bucket) and whether a
    background checkpoint save ran through the whole step; time the
    snapshot and checksum the live state at the snapshot and just after
    the rollback."""
    import torch

    def saving() -> bool:
        t = None if ex.ckpt is None else ex.ckpt._thread
        return t is not None and t.is_alive()

    rec["waits"] = []           # waits for an in-flight background save
    if ex.ckpt is not None:
        join = ex.ckpt._join

        def timed_join():
            busy, t0 = saving(), time.perf_counter()
            join()
            if busy:
                rec["waits"].append(time.perf_counter() - t0)
        ex.ckpt._join = timed_join

    dispatch, snap, roll = ex._dispatch, ex._snapshot_now, ex._rollback
    sync_bucket = ex._grad_sync._sync_bucket
    events: list = []

    def timed_bucket(buf, e1, e2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        sync_bucket(buf, e1, e2)
        ev[1].record()
        events.append(ev)

    def timed_dispatch(report):
        events.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step, s_a, before = ex.step, ex.state.s_a, saving()
        out = dispatch(report)
        loss = float(out[2]["loss"])          # synchronises
        secs = time.perf_counter() - t0
        rec["steps"].append({
            "step": step, "s_a": s_a, "loss": loss, "seconds": secs,
            "sync_ms": sum(a.elapsed_time(b) for a, b in events),
            "save_in_flight": before and saving()})
        log(f"[{tag}] step {step} S_A={s_a}: loss {loss:.6f}, {secs:.3f} "
            f"s, sync {rec['steps'][-1]['sync_ms']:.1f} ms"
            + (", a save in flight" if rec["steps"][-1]["save_in_flight"]
               else ""))
        return out

    def timed_snapshot():
        torch.cuda.synchronize()
        waits, t0 = len(rec["waits"]), time.perf_counter()
        snap()
        secs = time.perf_counter() - t0
        wait = sum(rec["waits"][waits:])
        nbytes = sum(t.numel() * t.element_size()
                     for t in _state_tensors(ex))
        rec["snapshots"].append({"step": ex.step, "seconds": secs - wait,
                                 "wait_s": wait, "bytes": nbytes,
                                 "opt_step": ex.opt_state.step,
                                 "checksums": checksums(_state_tensors(ex))})
        log(f"[{tag}] snapshot at step {ex.step}: {nbytes / GIB:.2f} GiB "
            f"to the host in {secs - wait:.2f} s"
            + (f", after waiting {wait:.2f} s for the save in flight"
               if wait else ""))

    def checked_rollback():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = roll()
        torch.cuda.synchronize()
        rec["rollbacks"].append({"step": out[0],
                                 "seconds": time.perf_counter() - t0,
                                 "checksums": checksums(_state_tensors(ex))})
        return out

    ex._dispatch, ex._snapshot_now = timed_dispatch, timed_snapshot
    ex._rollback = checked_rollback
    ex._grad_sync._sync_bucket = timed_bucket


def train_script(n: int, r: int):
    """The scripted failures: group 0 at ``kill_poll`` (maskable), then
    the first single group whose loss (with group 0 dead) wipes the
    system out, at ``wipe_poll``; and the recovery events the report
    must show, from the same scheme run on the host alone."""
    import copy

    from repro_torch.core import SpareState
    from repro_torch.des import get_scheme

    state = SpareState(n, r)
    first = get_scheme("spare", r=r).recover(state, [0])
    if first.wipeout:
        raise AssertionError("killing group 0 alone wipes the system out")
    for g in range(1, n):
        wipe = get_scheme("spare", r=r).recover(copy.deepcopy(state), [g])
        if wipe.wipeout:
            break
    else:
        raise AssertionError("no single kill wipes the system out")
    kill, wp = TRAIN["kill_poll"], TRAIN["wipe_poll"]
    events = [([0], False, first.s_a_after, 0),
              ([g], True, wipe.s_a_after, wp)]
    return {kill: [0], wp: [g]}, {"s_a_masked": first.s_a_after,
                                  "events": events}


def train_run(cfg, depth: int) -> dict:
    """One run of the training path at ``depth`` layers."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.train import ScriptedInjector

    cfg = cfg.scaled(n_layers=depth, grad_accum=1)
    # the state fills most of the card: start from an empty cache, or the
    # blocks earlier phases left make the allocator free and re-map
    # memory (a device-wide synchronise) on every large allocation
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    t0 = time.perf_counter()
    ex = _executor(cfg, "cuda", n_groups=TRAIN["n_groups"], r=TRAIN["r"],
                   seq=TRAIN["seq"], per_type_batch=TRAIN["per_type_batch"],
                   seed=TRAIN["seed"], grad_compress="int8_ef",
                   bucket_mb=TRAIN["bucket_mb"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"[train] {cfg.name}: {depth} layers, {ex._layout.n_buckets} "
        f"buckets, set up in {init_s:.1f} s, "
        f"{torch.cuda.memory_allocated() / GIB:.2f} GiB allocated")
    script, expect = train_script(TRAIN["n_groups"], TRAIN["r"])
    rec = {"steps": [], "snapshots": [], "rollbacks": []}
    instrument(ex, rec)
    ops.reset_launches()
    t0 = time.perf_counter()
    report = ex.run(TRAIN["steps"], injector=ScriptedInjector(script))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries0
    return {"ex": ex, "cfg": cfg, "report": report, "rec": rec,
            "launches": launches, "peak_bytes": peak, "wall_s": wall,
            "init_s": init_s, "script": script, "expect": expect,
            "alloc_retries": retries,
            "peak_reserved_bytes": torch.cuda.max_memory_reserved()}


def train_phase(cfg_full) -> dict:
    """The training main path, with its gates (see the module doc)."""
    import math

    import torch

    readings = []
    run = None
    for depth in TRAIN["depths"]:
        try:
            run = train_run(cfg_full, depth)
        except torch.OutOfMemoryError as exc:
            readings.append({"depth": depth, "oom": str(exc)[:200],
                             "peak_gib": torch.cuda.max_memory_allocated()
                             / GIB})
            log(f"[train] depth {depth}: out of memory")
        else:
            readings.append({"depth": depth,
                             "peak_gib": run["peak_bytes"] / GIB})
            if run["peak_bytes"] / GIB <= TRAIN["mem_limit_gib"]:
                break
            log(f"[train] depth {depth}: peak "
                f"{run['peak_bytes'] / GIB:.2f} GiB over the limit")
        run = None
        gc.collect()
        torch.cuda.empty_cache()
    if run is None:
        raise AssertionError(f"no depth fits: {readings}")
    ex, cfg, rep, rec = run["ex"], run["cfg"], run["report"], run["rec"]
    expect, L = run["expect"], cfg.n_layers

    # gates
    losses = [s["loss"] for s in rec["steps"]]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: a loss is not finite: {losses}")
    kill, wipe = TRAIN["kill_poll"], TRAIN["wipe_poll"]
    want_sa = ([1] * kill + [expect["s_a_masked"]] * (wipe - kill)
               + [1] * TRAIN["steps"])
    got_sa = [s["s_a"] for s in rec["steps"]]
    events = [(e.victims, e.wipeout, e.s_a_after, e.rollback_depth)
              for e in rep.events]
    want_events = expect["events"]
    if (rep.failures != 2 or rep.wipeouts != 1 or got_sa != want_sa
            or events != want_events or rep.steps_done != len(want_sa)):
        raise AssertionError(
            f"train report off script: failures {rep.failures}, wipeouts "
            f"{rep.wipeouts}, S_A {got_sa} (want {want_sa}), events "
            f"{events} (want {want_events})")
    if rec["snapshots"][0]["checksums"] != rec["rollbacks"][0]["checksums"]:
        raise AssertionError("train: the state after the rollback differs "
                             "from the snapshot")
    replay = rec["steps"][wipe]
    if replay["step"] != 0 or replay["loss"] != rec["steps"][0]["loss"]:
        raise AssertionError(f"train: replayed step 0 loss {replay} != "
                             f"first execution {rec['steps'][0]}")
    micro = sum(got_sa)
    executed = len(got_sa)
    nb = ex._layout.n_buckets
    # every other counter (K4: the dense model has no SSD) stays at 0
    want = dict.fromkeys(run["launches"], 0)
    want.update({"rmsnorm": micro * (4 * L + 1),
                 "rmsnorm_bwd": micro * (2 * L + 1),
                 "flash_attention": micro * 2 * L,
                 "flash_attention_bwd": micro * L,
                 "int8_ef_absmax": executed * 2 * nb,
                 "int8_ef_quantize": executed * 2 * nb})
    if run["launches"] != want:
        raise AssertionError(f"train launches {run['launches']} != {want}")

    # measurements: the replayed steps at S_A = 1 after the first (warm)
    steady = [s for s in rec["steps"][wipe + 1:]]
    step_s = sorted(s["seconds"] for s in steady)[len(steady) // 2]
    tokens = TRAIN["n_groups"] * TRAIN["per_type_batch"] * TRAIN["seq"]
    sync_share = sorted(s["sync_ms"] / 1e3 / s["seconds"]
                        for s in steady)[len(steady) // 2]
    snap = rec["snapshots"][0]
    mem_total = next(int(line.split()[1]) * 1024 for line in
                     open("/proc/meminfo") if line.startswith("MemTotal"))
    out = {"config": {"arch": cfg.name, "n_layers": L,
                      "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                      "n_kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff,
                      "vocab": cfg.vocab, "padded_vocab": cfg.padded_vocab,
                      "dtype": "bfloat16", **TRAIN,
                      "depths": list(TRAIN["depths"])},
           "depth_readings": readings, "script": {str(k): v for k, v in
                                                  run["script"].items()},
           "buckets": nb, "steps": rec["steps"], "launches": run["launches"],
           "launches_want": want, "failures": rep.failures,
           "wipeouts": rep.wipeouts, "recompiles": rep.recompiles,
           "rollback_depth": wipe, "peak_gib": run["peak_bytes"] / GIB,
           "peak_reserved_gib": run["peak_reserved_bytes"] / GIB,
           "alloc_retries": run["alloc_retries"],
           "step_s_median": step_s, "tokens_per_step": tokens,
           "tokens_per_s": tokens / step_s, "sync_share_median": sync_share,
           "snapshot_gib": snap["bytes"] / GIB,
           "snapshot_s": snap["seconds"],
           "rollback_s": rec["rollbacks"][0]["seconds"],
           "host_mem_total_gib": mem_total / GIB, "init_s": run["init_s"],
           "wall_s": run["wall_s"]}
    del ex, run
    return out


# ------------------------------------------------------------------ #
# the failure tiers: disk checkpoints, the straggler tier, a wipe-out #
# ------------------------------------------------------------------ #
def state_bytes(cfg) -> tuple[int, int]:
    """Bytes of the training state of the dense family at ``cfg``: the
    checkpoint (bf16 params with fp32 norms and QKV biases, fp32 AdamW
    moments, the int32 step) and the host snapshot (the checkpoint plus
    the int8 EF sync's two fp32 residual families, each of the
    gradient's size at one rank)."""
    n = cfg.param_count() + (cfg.padded_vocab - cfg.vocab) * cfg.d_model
    bias = ((cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.resolved_head_dim
            if cfg.qkv_bias else 0)
    f32 = cfg.d_model + cfg.n_layers * (2 * cfg.d_model + bias)
    ckpt = 2 * n + 2 * f32 + 8 * n + 4
    return ckpt, ckpt + 8 * n


def _peak_rss() -> int:
    """The process's largest resident set so far, bytes (Linux counts
    ``ru_maxrss`` in KiB)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def mem_total() -> int:
    return next(int(line.split()[1]) * 1024 for line in
                open("/proc/meminfo") if line.startswith("MemTotal"))


def failure_script(n: int, r: int):
    """The failure tiers' script: group ``slow_group`` at
    ``slow_factor``x over polls ``[slow_from, slow_until)`` (flagged,
    demoted and, once the episode ends, re-admitted), then group 0
    killed at ``kill_poll`` (masked) and, at ``wipe_poll``, the first
    single group whose loss then wipes the system out."""
    kill, _ = train_script(n, r)
    masked, wiping = list(kill.values())
    f = FAILURE
    script = {f["kill_poll"]: masked, f["wipe_poll"]: wiping}
    slow = {f["slow_from"]: [(f["slow_group"], f["slow_factor"],
                              f["slow_until"])]}
    return script, slow


def failure_executor(cfg, device, ckpt_dir, **kw):
    """The MeshExecutor of the failure tiers: int8 EF, a checkpoint
    directory whose Eq.-1 interval is due at every snapshot point, a
    StragglerDetector with its defaults, both stack depths registered."""
    from repro_torch.health import StragglerDetector

    ex = _executor(cfg, device, n_groups=TRAIN["n_groups"], r=TRAIN["r"],
                   per_type_batch=TRAIN["per_type_batch"],
                   seed=TRAIN["seed"], grad_compress="int8_ef",
                   ckpt_dir=str(ckpt_dir), mtbf=FAILURE["mtbf"],
                   t_save=FAILURE["t_save"], t_restart=FAILURE["t_restart"],
                   detector=StragglerDetector(TRAIN["n_groups"]), **kw)
    ex.ckpt.keep = FAILURE["keep"]
    ex.prewarm_depths(range(1, TRAIN["r"] + 1))
    return ex


def failure_events(rep) -> list:
    return [(e.step, e.victims, e.wipeout, e.reordered, e.patch_count,
             e.s_a_before, e.s_a_after, e.rollback_depth, e.demote,
             e.readmit, e.slow_factor) for e in rep.events]


def failure_cpu_run(cfg_full, ckpt_dir) -> dict:
    """The same script on a tiny configuration on the CPU: the events,
    ``health_log`` and saves the card's run must reproduce."""
    from repro_torch.train import ScriptedInjector

    cfg = cfg_full.scaled(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                          head_dim=128, d_ff=512, vocab=1000, grad_accum=1)
    ex = failure_executor(cfg, "cpu", ckpt_dir, seq=64, bucket_mb=0.25)
    script, slow = failure_script(TRAIN["n_groups"], TRAIN["r"])
    rep = ex.run(FAILURE["steps"], injector=ScriptedInjector(
        script, slow_schedule=slow, n_groups=TRAIN["n_groups"]),
        snapshot_every=FAILURE["snapshot_every"])
    return {"events": failure_events(rep), "health_log": ex.health_log,
            "ckpt_saves": rep.ckpt_saves,
            "committed": sorted(p.name for p in ckpt_dir.glob("step_*"))}


def _shape_like(tree):
    """``tree`` with each tensor replaced by a one-element tensor of its
    dtype and device expanded to its shape: what a restore reads of the
    tree it restores into, without the memory."""
    import torch

    from repro_torch.optim import AdamWState

    if isinstance(tree, dict):
        return {k: _shape_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_shape_like(v) for v in tree)
    if isinstance(tree, AdamWState):
        return AdamWState(tree.step, _shape_like(tree.mu),
                          _shape_like(tree.nu))
    return torch.empty((), dtype=tree.dtype,
                       device=tree.device).expand(tree.shape)


def pick_failure_depth(cfg_full, train_depth: int, ckpt_dir) -> tuple:
    """The train phase's depth, unless the two checkpoints the phase
    writes (with ``keep`` 1 both are on disk at once while the second is
    staged) exceed the disk's free space under the checkpoint directory
    or ``FAILURE["write_budget_gib"]``, or ``MemTotal`` is below the
    host snapshot; then the largest of 24, 18, 12 that fits. The
    readings are printed."""
    import shutil

    free, total = shutil.disk_usage(ckpt_dir.parent).free, mem_total()
    budget = min(free, FAILURE["write_budget_gib"] * GIB)
    readings = []
    for depth in [train_depth] + [d for d in FAILURE["depths"]
                                  if d < train_depth]:
        ckpt_b, snap_b = state_bytes(cfg_full.scaled(n_layers=depth))
        fits = 2 * ckpt_b <= budget and total >= snap_b
        readings.append({"depth": depth, "ckpt_gib": ckpt_b / GIB,
                         "snapshot_gib": snap_b / GIB, "fits": fits})
        log(f"[failure tiers] depth {depth}: checkpoint {ckpt_b / GIB:.2f} "
            f"GiB (written twice), host snapshot {snap_b / GIB:.2f} GiB; "
            f"disk free {free / GIB:.2f} GiB, write budget "
            f"{FAILURE['write_budget_gib']:.1f} GiB, MemTotal "
            f"{total / GIB:.2f} GiB: " + ("fits" if fits else "cut"))
        if fits:
            return depth, readings, free, total
    raise AssertionError(f"failure tiers: no depth fits: {readings}")


def failure_tiers_phase(cfg_full, train_depth: int) -> dict:
    """Full-width qwen2.5-3b through the ``MeshExecutor`` (one-rank NCCL
    group, int8 EF, the train phase's groups, tokens and buckets) with a
    checkpoint directory under ``chiprun_out/`` (removed at the end), a
    ``StragglerDetector`` with its defaults and a ``ScriptedInjector``
    holding a slow schedule and two kills (:func:`failure_script`).
    Gates: every loss finite; the events and ``health_log`` equal a tiny
    CPU run of the same script; a demote and a re-admit whose weight
    table equals an always-healthy run's bit for bit, with no rebuild;
    at least two saves commit, and the latest restores onto the card
    to the state recorded at its step, bit for bit; after the wipe-out
    the state equals the snapshot and the first replayed step's loss
    its first execution's, bit for bit; exact launch counts. Measures
    the host copy, the disk write, the restore, the step time while a
    save is in flight and the peak host RSS."""
    import math
    import shutil

    import numpy as np
    import torch

    import repro_torch.ckpt.checkpoint as ckpt_mod
    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.core import SpareState
    from repro_torch.dist import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.train import ScriptedInjector

    base = ROOT / "chiprun_out" / "failure_tiers"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    ckpt_dir = base / "card"
    real_save = ckpt_mod.save_checkpoint
    try:
        cpu = failure_cpu_run(cfg_full, base / "cpu")
        log(f"[failure tiers] tiny CPU run: events {cpu['events']}, "
            f"health_log {cpu['health_log']}, saves {cpu['ckpt_saves']}")
        depth, readings, free, total = pick_failure_depth(
            cfg_full, train_depth, ckpt_dir)
        cfg = cfg_full.scaled(n_layers=depth, grad_accum=1)
        log(f"[failure tiers] Eq.-1 interval from mtbf {FAILURE['mtbf']} "
            f"s, t_save {FAILURE['t_save']} s, t_restart "
            f"{FAILURE['t_restart']} s: due at every snapshot point")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ex = failure_executor(cfg, "cuda", ckpt_dir, seq=TRAIN["seq"],
                              bucket_mb=TRAIN["bucket_mb"])
        torch.cuda.synchronize()
        log(f"[failure tiers] {cfg.name}: {depth} layers, set up in "
            f"{time.perf_counter() - t0:.1f} s, Eq.-1 interval "
            f"{ex.ckpt.interval:.3g} s")
        rec = {"steps": [], "snapshots": [], "rollbacks": [], "saves": [],
               "readmits": []}
        instrument(ex, rec, tag="failure tiers")
        run_t0 = time.perf_counter()

        def timed_save(directory, step, tree, *, clock):
            t0 = time.perf_counter()
            d = real_save(directory, step, tree, clock=clock)
            rec["saves"].append({
                "step": step, "seconds": time.perf_counter() - t0,
                "start_s": t0 - run_t0,
                "bytes": sum(f.stat().st_size for f in d.iterdir())})
            return d
        ckpt_mod.save_checkpoint = timed_save
        readmit = ex._readmit

        def checked_readmit(groups, hr, injector, report):
            readmit(groups, hr, injector, report)
            fresh = SpareState(TRAIN["n_groups"], TRAIN["r"])
            rec["readmits"].append(int(ex.state.s_a) == int(fresh.s_a) and all(
                np.array_equal(getattr(ex.state, f), getattr(fresh, f))
                for f in ("stacks", "alive", "supplier")))
        ex._readmit = checked_readmit

        script, slow = failure_script(TRAIN["n_groups"], TRAIN["r"])
        ops.reset_launches()
        rep = ex.run(FAILURE["steps"], injector=ScriptedInjector(
            script, slow_schedule=slow, n_groups=TRAIN["n_groups"]),
            snapshot_every=FAILURE["snapshot_every"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - run_t0
        launches = dict(ops.launches)
        events, health_log = failure_events(rep), ex.health_log
        committed = sorted(p.name for p in ckpt_dir.glob("step_*"))
        fs = subprocess.run(["stat", "-f", "-c", "%T", str(ckpt_dir)],
                            capture_output=True, text=True,
                            timeout=60).stdout.strip()
        n_ckpt = (len(tree_leaves(ex.params)) + len(tree_leaves(
            ex.opt_state.mu)) + len(tree_leaves(ex.opt_state.nu)))
        like = _shape_like((ex.params, ex.opt_state))
        nb, interval = ex._layout.n_buckets, ex.ckpt.interval
        del ex
        gc.collect()
        torch.cuda.empty_cache()
        # the latest checkpoint, restored onto the card
        t0 = time.perf_counter()
        step, (params, opt) = restore_checkpoint(ckpt_dir, like)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restored = checksums(tree_leaves(params) + tree_leaves(opt.mu)
                             + tree_leaves(opt.nu))
        restored_step = opt.step
        del params, opt, like
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        ckpt_mod.save_checkpoint = real_save
        shutil.rmtree(base, ignore_errors=True)
    peak_rss = _peak_rss()

    # gates
    L = depth
    losses = [s["loss"] for s in rec["steps"]]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"failure tiers: a loss is not finite: {losses}")
    if events != cpu["events"] or health_log != cpu["health_log"]:
        raise AssertionError(f"failure tiers: events {events}, health_log "
                             f"{health_log} differ from the tiny CPU run's "
                             f"{cpu['events']}, {cpu['health_log']}")
    if (rep.demotes != 1 or rep.readmits != 1 or rec["readmits"] != [True]
            or rep.recompiles != 0 or rep.wipeouts != 1
            or rep.failures != 2):
        raise AssertionError(
            f"failure tiers: demotes {rep.demotes}, readmits "
            f"{rep.readmits} (healthy table {rec['readmits']}), rebuilds "
            f"{rep.recompiles}, wipeouts {rep.wipeouts}, failures "
            f"{rep.failures}")
    saved = [sv["step"] for sv in rec["saves"]]
    if (rep.ckpt_saves < 2 or rep.ckpt_saves != cpu["ckpt_saves"]
            or committed != cpu["committed"]
            or committed != [f"step_{saved[-1]:08d}"]):
        raise AssertionError(f"failure tiers: saves {rep.ckpt_saves} "
                             f"(CPU {cpu['ckpt_saves']}), steps saved "
                             f"{saved}, committed {committed} (CPU "
                             f"{cpu['committed']})")
    snap = {sn["step"]: sn for sn in rec["snapshots"]}
    at_save = snap[step]
    if (step != saved[-1] or restored_step != at_save["opt_step"]
            or restored != at_save["checksums"][:n_ckpt]):
        raise AssertionError(f"failure tiers: the checkpoint of step "
                             f"{step} does not restore to the state "
                             f"recorded at its step")
    roll = rec["rollbacks"][0]
    if roll["checksums"] != snap[roll["step"]]["checksums"]:
        raise AssertionError("failure tiers: the state after the rollback "
                             "differs from the snapshot")
    first = {}
    for st in rec["steps"]:
        first.setdefault(st["step"], st)
    wipe_at = next(i for i, st in enumerate(rec["steps"])
                   if i and st["step"] <= rec["steps"][i - 1]["step"])
    replay = rec["steps"][wipe_at]
    if (replay["step"] != roll["step"]
            or replay["loss"] != first[roll["step"]]["loss"]
            or first[roll["step"]]["s_a"] != replay["s_a"]):
        raise AssertionError(f"failure tiers: replayed step {replay} != "
                             f"first execution {first[roll['step']]}")
    micro = sum(st["s_a"] for st in rec["steps"])
    executed = len(rec["steps"])
    want = dict.fromkeys(launches, 0)
    want.update({"rmsnorm": micro * (4 * L + 1),
                 "rmsnorm_bwd": micro * (2 * L + 1),
                 "flash_attention": micro * 2 * L,
                 "flash_attention_bwd": micro * L,
                 "int8_ef_absmax": executed * 2 * nb,
                 "int8_ef_quantize": executed * 2 * nb})
    if launches != want:
        raise AssertionError(f"failure tiers: launches {launches} != {want}")

    # measurements
    def median(xs):
        return sorted(xs)[len(xs) // 2] if xs else None
    # step times by stack depth (a step at S_A = 2 runs two
    # microbatches), with and without a save in flight; the first step
    # is a warm-up
    by_sa: dict = {}
    for st in rec["steps"][1:]:
        d = by_sa.setdefault(str(st["s_a"]), {"save_in_flight": [],
                                              "no_save": []})
        d["save_in_flight" if st["save_in_flight"] else "no_save"].append(
            st["seconds"])
    step_s = {sa: {k: {"median": median(v), "n": len(v)}
                   for k, v in d.items()} for sa, d in by_sa.items()}
    busy = by_sa.get("1", {}).get("save_in_flight", [])
    quiet = by_sa.get("1", {}).get("no_save", [])
    replayed = [st["seconds"] for st in rec["steps"][wipe_at:]
                if st["s_a"] == 1]
    last = rec["saves"][-1]
    out = {"config": {"arch": cfg.name, "n_layers": depth,
                      "dtype": "bfloat16", **FAILURE,
                      "depths": list(FAILURE["depths"]),
                      "script": {str(k): v for k, v in script.items()},
                      "slow_schedule": {str(k): v for k, v in slow.items()}},
           "depth_readings": readings, "disk_free_gib": free / GIB,
           "host_mem_total_gib": total / GIB, "filesystem": fs,
           "interval_s": interval, "events": events,
           "health_log": health_log, "cpu": cpu, "ckpt_saves": rep.ckpt_saves,
           "committed": committed, "steps": rec["steps"],
           "snapshots": [{k: v for k, v in sn.items() if k != "checksums"}
                         for sn in rec["snapshots"]],
           "save_waits_s": rec["waits"], "saves": rec["saves"],
           "rollback_s": roll["seconds"], "restore_s": restore_s,
           "restore_gb_per_s": last["bytes"] / 1e9 / restore_s,
           "save_s": last["seconds"], "save_gib": last["bytes"] / GIB,
           "save_gb_per_s": last["bytes"] / 1e9 / last["seconds"],
           "step_s_by_s_a": step_s,
           "step_s_save_in_flight_median": median(busy),
           "step_s_no_save_median": median(quiet),
           "step_s_replayed_median": median(replayed),
           "steps_save_in_flight": len(busy), "steps_no_save": len(quiet),
           "peak_rss_gib": peak_rss / GIB, "launches": launches,
           "launches_want": want, "wall_s": wall}
    log(f"[failure tiers] {depth} layers on {fs}: {rep.ckpt_saves} saves "
        f"committed ({committed}); checkpoint {last['bytes'] / GIB:.2f} "
        f"GiB written in {last['seconds']:.2f} s = "
        f"{out['save_gb_per_s']:.3f} GB/s; restored onto the card in "
        f"{restore_s:.2f} s; host copies "
        f"{[round(sn['seconds'], 2) for sn in rec['snapshots']]} s (waits "
        f"for a save in flight {[round(w, 2) for w in rec['waits']]} s); "
        f"rollback "
        f"{roll['seconds']:.2f} s; step seconds by S_A with and without "
        f"a save in flight {step_s}, replayed {median(replayed)} s; peak RSS "
        f"{peak_rss / GIB:.2f} of {total / GIB:.2f} GiB")
    return out


# ------------------------------------------------------------------ #
# the launchers as a user runs them                                  #
# ------------------------------------------------------------------ #
CLI_FAILURE = {"kind": "correlated", "scope": "rack", "burst_prob": 1.0,
               "mtbf": 400.0}


def cli_phase() -> dict:
    """Both launchers as subprocesses on the card at the smoke
    configuration, with ``--failure-model``, ``--topology`` and
    ``--ckpt-dir`` (under ``chiprun_out/``, removed after); the train
    launcher through ``--mesh --grad-compress int8_ef``. Gates: exit
    code 0 and the report parsed."""
    import re
    import shutil

    base = ROOT / "chiprun_out" / "cli"
    shutil.rmtree(base, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = {
        "train": [sys.executable, "-m", "repro_torch.launch.train",
                  "--arch", ARCH, "--steps", "8", "--n-groups", "8", "-r",
                  "2", "--seq", "64", "--per-type-batch", "1", "--mesh",
                  "--grad-compress", "int8_ef", "--failure-model",
                  json.dumps(CLI_FAILURE), "--topology",
                  json.dumps({"n_groups": 8, "hosts_per_group": 2,
                              "hosts_per_rack": 4}),
                  "--seconds-per-step", "64", "--ckpt-dir",
                  str(base / "train")],
        "serve": [sys.executable, "-m", "repro_torch.launch.serve",
                  "--arch", ARCH, "--replicas", "2", "--requests", "8",
                  "--failure-model", json.dumps(CLI_FAILURE), "--topology",
                  json.dumps({"n_groups": 2, "hosts_per_group": 1,
                              "hosts_per_rack": 2}),
                  "--ckpt-dir", str(base / "serve")]}
    out = {}
    try:
        for name, cmd in runs.items():
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  env=env, cwd=ROOT, timeout=600)
            secs = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"cli {name}: exit {proc.returncode}: "
                                     f"{proc.stderr[-2000:]}")
            if name == "train":
                done = re.search(r"\[train\] done: (\d+) steps .* on (.+)",
                                 proc.stdout)
                lines = "\n".join(
                    line for line in proc.stdout.splitlines()
                    if line.startswith(("[train] loss", "[train] recovery")))
                fields = dict(re.findall(r"(\w+)=(\d+)", lines))
                if done is None or "failures" not in fields:
                    raise AssertionError(f"cli train: no report line in "
                                         f"{proc.stdout[-2000:]}")
                report = {"steps": int(done.group(1)),
                          "device": done.group(2).strip(),
                          **{k: int(v) for k, v in fields.items()}}
            else:
                rep = json.loads(proc.stdout)
                if rep["completed_requests"] != rep["requests"]:
                    raise AssertionError(f"cli serve: {rep}")
                report = {k: rep[k] for k in (
                    "device", "completed_requests", "requests", "events",
                    "recompiles", "tokens_per_s")}
            out[name] = {"seconds": secs, "report": report}
            log(f"[cli] {name}: exit 0 in {secs:.1f} s; {report}")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return out


# ------------------------------------------------------------------ #
# the campaign runner: DES grid, live trainer sweep, gray arms        #
# ------------------------------------------------------------------ #
#: the live cells as the JAX package's presets make them (N 8, r 3, 40
#: steps, seq 32, one example a type, the rack-dominated topology; the
#: gray arms: N 8, r 2, 32 steps, group 0 at 3x over polls 4-15), at
#: the full width of qwen2.5-3b and the deepest of ``depths`` whose
#: training state (below) fits ``mem_limit_gib``
CAMPAIGN = dict(preset="smoke", jobs=(1, 2), n=8, r=3, steps=40, seq=32,
                per_type_batch=1, gray_steps=32, depths=(36, 24, 18, 12),
                mem_limit_gib=75.0, coverage=0.95, equivalence_tol=1e-2)
#: the counts a trainer cell's report must share with the same cell at
#: smoke size on the CPU (the injector and the scheme are host-side)
TRAINER_COUNTS = ("steps_done", "failures", "wipeouts", "reorders",
                  "patches", "recovery_events", "multi_group_events",
                  "rollback_steps", "final_s_a")
GRAY_SAME = ("flag_step", "demote_step", "readmit_step", "health_actions",
             "ttt_s")


def campaign_cells(trace_dir: str | None = None) -> tuple[list, list]:
    """The live trainer cells and the gray arms, as the JAX package's
    presets make them with ``CAMPAIGN``'s sizes."""
    from repro_torch.scenarios.campaign import (gray_regime_cells,
                                                trainer_regime_cells)

    c = CAMPAIGN
    cells = trainer_regime_cells(n=c["n"], r=c["r"], steps=c["steps"],
                                 seq=c["seq"],
                                 per_type_batch=c["per_type_batch"],
                                 trace_dir=trace_dir)
    return cells, gray_regime_cells(steps=c["gray_steps"],
                                    trace_dir=trace_dir)


def campaign_microbatches() -> list[tuple[int, int]]:
    """The ``(examples, seq)`` of one microbatch on the campaign's live
    paths: every group's per-type batch, stacked (N x per-type batch
    rows of seq tokens; the §3.1 check's two gradients take the same
    batch)."""
    cells, gray = campaign_cells()
    return sorted({(x["n"] * x["per_type_batch"], x["seq"])
                   for x in (*cells, *gray)})


def campaign_bytes(cfg) -> dict:
    """What a live trainer cell holds on the card at ``cfg``, from the
    leaves (as :func:`state_bytes`): the params (bf16, fp32 norms and
    QKV biases), the AdamW moments (fp32), the step's fp32 accumulator
    and the two fp32 gradient trees that the §3.1 check holds at once
    (``spare_grads`` and ``vanilla_reference_grads``)."""
    n = cfg.param_count() + (cfg.padded_vocab - cfg.vocab) * cfg.d_model
    ckpt, _ = state_bytes(cfg)
    moments = 8 * n
    out = {"params": ckpt - moments - 4, "moments": moments,
           "accumulator": 4 * n, "two_grad_trees": 8 * n}
    out["total"] = sum(out.values())
    return out


def pick_campaign_depth(cfg_full) -> tuple[int, list]:
    """The deepest of ``CAMPAIGN["depths"]`` whose :func:`campaign_bytes`
    total fits ``mem_limit_gib``; the reckoning is printed for every
    depth."""
    readings, pick = [], None
    for depth in CAMPAIGN["depths"]:
        b = campaign_bytes(cfg_full.scaled(n_layers=depth))
        fits = b["total"] <= CAMPAIGN["mem_limit_gib"] * GIB
        readings.append({"depth": depth, "fits_memory": fits,
                         **{k: v / GIB for k, v in b.items()}})
        log(f"[campaign] depth {depth}: params {b['params'] / GIB:.2f} + "
            f"AdamW moments {b['moments'] / GIB:.2f} + accumulator "
            f"{b['accumulator'] / GIB:.2f} + two gradient trees "
            f"{b['two_grad_trees'] / GIB:.2f} = {b['total'] / GIB:.2f} GiB "
            f"against {CAMPAIGN['mem_limit_gib']:.0f}: "
            + ("fits" if fits else "over"))
        if pick is None and fits:
            pick = depth
    if pick is None:
        raise AssertionError(f"campaign: no depth fits: {readings}")
    log(f"[campaign] depth {pick}")
    return pick, readings


def des_grid() -> dict:
    """(a) The ``smoke`` preset through the port's campaign runner at
    each of ``CAMPAIGN["jobs"]`` (several: spawned workers): artifacts
    byte-identical; rankings printed."""
    import shutil

    from repro_torch.scenarios import (CAMPAIGN_PRESETS, ranking_by_regime,
                                       run_campaign, save_artifacts)

    spec = CAMPAIGN_PRESETS[CAMPAIGN["preset"]]
    base = ROOT / "chiprun_out" / "campaign" / "des"
    shutil.rmtree(base, ignore_errors=True)
    runs = {}
    for jobs in CAMPAIGN["jobs"]:
        t0 = time.perf_counter()
        results = run_campaign(spec.cells(), jobs=jobs)
        secs = time.perf_counter() - t0
        paths = save_artifacts(f"{spec.name}_jobs{jobs}", results,
                               outdir=base)
        runs[jobs] = {"seconds": secs,
                      "bytes": [p.read_bytes() for p in paths],
                      "ranking": ranking_by_regime(results)}
        log(f"[campaign] DES grid {spec.name}: {len(results)} cells at "
            f"jobs {jobs} in {secs:.2f} s")
    first = runs[CAMPAIGN["jobs"][0]]
    for jobs, run in runs.items():
        if run["bytes"] != first["bytes"]:
            raise AssertionError(f"campaign: the DES artifacts at jobs "
                                 f"{jobs} differ from jobs "
                                 f"{CAMPAIGN['jobs'][0]}")
    for regime, ranking in first["ranking"].items():
        log(f"[campaign] {regime}: " + " > ".join(
            f"{e['scheme']}({e['mean_ttt_norm']:.2f})" for e in ranking))
    return {"preset": spec.name, "cells": len(spec.cells()),
            "seconds": {str(j): r["seconds"] for j, r in runs.items()},
            "csv_bytes": len(first["bytes"][0]),
            "json_bytes": len(first["bytes"][1]),
            "identical": True, "ranking": first["ranking"]}


class _Losses:
    """While active, keeps every trainer run's losses (``runs``, one list
    a run): a cell's row carries only the first and the last."""

    def __enter__(self):
        from repro_torch.train.trainer import SpareTrainer

        self.runs, self._cls, run = [], SpareTrainer, SpareTrainer.run
        self._run = run

        def recorded_run(trainer, *a, **kw):
            rep = run(trainer, *a, **kw)
            self.runs.append(list(rep.losses))
            return rep

        SpareTrainer.run = recorded_run
        return self

    def __exit__(self, *exc):
        self._cls.run = self._run
        return False


def _trace_seconds(trace_path) -> tuple[dict, list]:
    """From a cell's trace: the seconds of each step's ``compute`` span
    (dispatch through the loss read, which synchronises) by the step's
    ``S_A``, the first step of the run left out (warm-up); and the
    seconds of each ``ckpt_save`` span (a host snapshot, in place)."""
    from repro_torch.obs import load_trace

    view = load_trace(trace_path)
    computes = view.named("compute")
    by_sa: dict = {}
    for s in view.named("step")[1:]:
        inner = [c.dur for c in computes if s.ts <= c.ts and c.end <= s.end]
        by_sa.setdefault(str(s.args["s_a"]), []).extend(
            d / 1e6 for d in inner)
    return by_sa, [c.dur / 1e6 for c in view.named("ckpt_save")]


def _median(xs):
    return sorted(xs)[len(xs) // 2] if xs else None


def _live_cell(run, cell, cfg, losses: _Losses, tag: str) -> dict:
    """One live cell on the card: launch counts from 0 just before and
    read just after, seconds, peak device memory, the process's peak
    RSS so far, the run's losses, and step and snapshot seconds from
    its trace; then everything it held is freed."""
    import torch

    from repro_torch.kernels import ops

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    row = run(cell, device="cuda", cfg=cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(ops.launches)
    gc.collect()
    torch.cuda.empty_cache()
    steps, snaps = _trace_seconds(cell["trace"])
    out = {"row": row, "seconds": secs, "launches": launches,
           "losses": losses.runs[-1], "snapshot_s": snaps,
           "peak_gib": torch.cuda.max_memory_allocated() / GIB,
           "peak_rss_gib": _peak_rss() / GIB,
           "step_s_by_s_a": {sa: {"median": _median(v), "n": len(v)}
                             for sa, v in steps.items()}}
    log(f"[campaign] {tag} on the card: {secs:.1f} s, peak "
        f"{out['peak_gib']:.2f} GiB, peak RSS {out['peak_rss_gib']:.2f} GiB, "
        f"snapshots {[round(s, 2) for s in out['snapshot_s']]} s, step s "
        f"by S_A {out['step_s_by_s_a']}; {row}")
    return out


def _obs_gate(trace, *flags) -> dict:
    """The port's trace analyzer on ``trace``, as a user runs it; its
    report is printed and parsed, and a non-zero exit fails."""
    out_json = Path(str(trace) + ".obs.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.obs", str(trace),
           "--json", str(out_json), *flags]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                          cwd=ROOT)
    log(f"[campaign] python -m repro_torch.launch.obs {Path(trace).name} "
        f"{' '.join(flags)}: exit {proc.returncode}\n{proc.stdout}"
        f"{proc.stderr}")
    if proc.returncode != 0:
        raise AssertionError(f"campaign: launch.obs {flags} failed on "
                             f"{trace}: {proc.stderr[-1000:]}")
    return json.loads(out_json.read_text())


def campaign_phase(cfg_full) -> dict:
    """The campaign runner (see the module doc, phase 12): (a) the DES
    grid; (b) the three live trainer cells at full width, against the
    same cells at smoke size on the CPU; (c) the gray arms the same way;
    (d) ``launch.obs`` over their traces."""
    import shutil

    out = {"des": des_grid()}
    depth, readings = pick_campaign_depth(cfg_full)
    cfg = cfg_full.scaled(n_layers=depth, grad_accum=1)
    # the trace path is part of a cell's key, so of its seed: relative to
    # the checkout's root, the cells are the same wherever it lies
    traces = Path("chiprun_out") / "campaign" / "traces"
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        shutil.rmtree(traces, ignore_errors=True)
        traces.mkdir(parents=True)
        return {**out, **_campaign_live(cfg, depth, readings, traces)}
    finally:
        os.chdir(cwd)


def _campaign_live(cfg, depth: int, readings: list, traces: Path) -> dict:
    """Phase 12 (b)-(d), from the checkout's root."""
    import math

    from repro_torch.scenarios.campaign import (run_gray_cell,
                                                run_trainer_cell)

    c = CAMPAIGN
    cells, gray = campaign_cells(str(traces))
    trainer, arms = {}, {}
    with _Losses() as losses:
        # the CPU runs first: each writes the trace its card run then
        # overwrites (the trace path is part of the cell, so of its seed)
        for cell in cells:
            label = cell["model"]["label"]
            t0 = time.perf_counter()
            cpu = run_trainer_cell(cell, device="cpu")
            log(f"[campaign] {label} at smoke size on the CPU in "
                f"{time.perf_counter() - t0:.1f} s: {cpu}")
            trainer[label] = {"cpu": cpu, **_live_cell(
                run_trainer_cell, cell, cfg, losses, label)}
        for cell in gray:
            cpu = run_gray_cell(cell, device="cpu")
            log(f"[campaign] gray {cell['arm']} on the CPU: {cpu}")
            arms[cell["arm"]] = {"cpu": cpu, **_live_cell(
                run_gray_cell, cell, cfg, losses, f"gray {cell['arm']}")}

    # gates: (b) the trainer cells
    for label, t in trainer.items():
        row, cpu = t["row"], t["cpu"]
        counts = {k: row[k] for k in TRAINER_COUNTS}
        if counts != {k: cpu[k] for k in TRAINER_COUNTS}:
            raise AssertionError(f"campaign {label}: counts {counts} "
                                 f"differ from the CPU run's {cpu}")
        if not (t["losses"] and all(math.isfinite(x) for x in t["losses"])):
            raise AssertionError(f"campaign {label}: a loss is not finite")
        if not row["max_grad_check_err"] <= c["equivalence_tol"]:
            raise AssertionError(f"campaign {label}: §3.1 error "
                                 f"{row['max_grad_check_err']}")
    multi = sum(t["row"]["multi_group_events"] for t in trainer.values())
    if multi < 1:
        raise AssertionError("campaign: no multi-group event in the sweep")
    # (c) the gray arms
    for arm, a in arms.items():
        row, cpu = a["row"], a["cpu"]
        same = {k: row[k] for k in GRAY_SAME}
        if same != {k: cpu[k] for k in GRAY_SAME}:
            raise AssertionError(f"campaign gray {arm}: {same} differ from "
                                 f"the CPU run's {cpu}")
        if not row["readmit_identical"] or row["recompiles"] != 0:
            raise AssertionError(f"campaign gray {arm}: {row}")
        if not all(math.isfinite(x) for x in a["losses"]):
            raise AssertionError(f"campaign gray {arm}: a loss is not "
                                 f"finite")
    if not arms["demote"]["row"]["ttt_s"] < arms["tolerate"]["row"]["ttt_s"]:
        raise AssertionError("campaign: demotion did not beat tolerating")
    # kernels on the campaign path
    by_path = {"campaign_trainer": {}, "campaign_gray": {}}
    for path, runs in (("campaign_trainer", trainer), ("campaign_gray",
                                                      arms)):
        for r in runs.values():
            for k, v in r["launches"].items():
                by_path[path][k] = by_path[path].get(k, 0) + v
    for k in ("rmsnorm", "rmsnorm_bwd", "flash_attention",
              "flash_attention_bwd"):
        if not all(p[k] > 0 for p in by_path.values()):
            raise AssertionError(f"campaign: {k} never launched: {by_path}")
    # (d) the trace gates
    flags = ("--assert-coverage", str(c["coverage"]))
    obs = {}
    for cell in cells:
        obs[cell["model"]["label"]] = _obs_gate(
            cell["trace"], *flags, "--assert-recovery-markers")
    # a gray episode kills nobody, so its trace carries straggler
    # markers and demote/readmit recoveries but no failure marker:
    # coverage is gated, and the attribution rows must show both edits
    demote = _obs_gate(gray[1]["trace"], *flags)
    kinds = [r["kind"] for r in demote["recovery_events"]]
    if kinds != ["demote", "readmit"]:
        raise AssertionError(f"campaign: the demote arm's attribution "
                             f"rows are {kinds}")
    obs["gray_demote"] = demote
    gauges = json.loads(Path(gray[1]["trace"] + ".metrics.json")
                        .read_text())
    wire = {k: v for sec in ("gauges", "counters")
            for k, v in gauges.get(sec, {}).items() if k.startswith("sync.")}
    log(f"[campaign] wire gauges of the demote arm (one rank, fp32 "
        f"buckets): {wire}")
    return {"depth": depth, "depth_readings": readings,
            "config": {"arch": cfg.name, "n_layers": depth,
                       "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                       "n_kv_heads": cfg.n_kv_heads,
                       "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
                       "padded_vocab": cfg.padded_vocab, **c,
                       "jobs": list(c["jobs"]), "depths": list(c["depths"])},
            "trainer": trainer, "gray": arms, "launches": by_path,
            "multi_group_events": multi, "wire": wire,
            "obs": {k: {"coverage": v["coverage"],
                        "failure_markers": v["failure_markers"],
                        "recovery_events": [
                            {f: e[f] for f in ("step", "kind", "victims",
                                               "rollback_depth")}
                            for e in v["recovery_events"]]}
                    for k, v in obs.items()},
            "peak_rss_gib": max(r["peak_rss_gib"] for r in
                                [*trainer.values(), *arms.values()])}


def profile_calls(calls, iters: int) -> dict:
    """For each ``(name, fn)``: host time per call (host clock around
    calls that end in a synchronize), device time per call and the
    kernels that take it (``torch.profiler``), and the device's busy
    share of the host's time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in calls:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / iters
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type.name == "CUDA"]
        dev_us = lambda e: e.self_device_time_total  # noqa: E731
        dev_ms = sum(dev_us(e) for e in kernels) / 1e3 / iters
        if not dev_ms > 0:
            raise AssertionError(f"{name}: the profiler saw no device time")
        top = sorted(kernels, key=dev_us, reverse=True)[:10]
        out[name] = {
            "host_ms": host_ms, "device_ms": dev_ms,
            "device_busy_share": dev_ms / host_ms,
            "kernel_launches": sum(e.count for e in kernels) // iters,
            "top_kernels": [{"name": e.key[:80],
                             "ms": dev_us(e) / 1e3 / iters,
                             "calls": e.count // iters} for e in top]}
        log(f"[profile] {name}: host {host_ms:.3f} ms, device "
            f"{dev_ms:.3f} ms per call ({dev_ms / host_ms:.1%} busy), "
            f"{out[name]['kernel_launches']} kernel launches")
        for k in out[name]["top_kernels"]:
            log(f"[profile]   {k['ms']:.4f} ms x{k['calls']} {k['name']}")
    return out


def profile_phase(cfg, cfg_ssm) -> dict:
    """Where the time goes on the main paths' models: for qwen2.5-3b and
    mamba2-1.3b, a serving decode step (all slots active, each at the
    longest bucket's length) and a prefill of the longest bucket; then
    one training step of the train phase's executor at ``S_A = 1`` (full
    depth, int8 EF)."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.serve import pages_needed
    from repro_torch.train import make_prefill, make_serve_step
    from repro_torch.train.trainer import TrainReport

    out = {}
    for c, prefix in ((cfg, ""), (cfg_ssm, "ssm_")):
        model = build_model(c, device="cuda")
        params = model.init(SERVE["seed"])
        slots, ps = SERVE["slots"], SERVE["page_size"]
        longest = max(SERVE["buckets"])
        m = pages_needed(longest + SERVE["max_new"], ps)
        pools = model.init_paged_state(slots, slots * m + 1, ps)
        table = (1 + torch.arange(slots * m, device="cuda")).reshape(slots,
                                                                     m)
        pos = torch.full((slots,), longest, device="cuda")
        toks = torch.ones((slots, 1), dtype=torch.long, device="cuda")
        step = make_serve_step(model, paged=True)
        prefill = make_prefill(model, return_cache=True)
        prompt = torch.ones((1, longest), dtype=torch.long, device="cuda")
        out.update(profile_calls(
            [(f"{prefix}decode_step",
              lambda: step(params, pools, table, pos, toks)),
             (f"{prefix}prefill_{longest}",
              lambda: prefill(params, prompt))], iters=5))
        del model, params, pools, step, prefill
        gc.collect()
        torch.cuda.empty_cache()

    ex = _executor(cfg.scaled(n_layers=TRAIN["depths"][0], grad_accum=1),
                   "cuda", n_groups=TRAIN["n_groups"], r=TRAIN["r"],
                   seq=TRAIN["seq"], per_type_batch=TRAIN["per_type_batch"],
                   seed=TRAIN["seed"], grad_compress="int8_ef",
                   bucket_mb=TRAIN["bucket_mb"])
    report = TrainReport()
    out["train_step"] = profile_calls(
        [("train_step", lambda: float(ex._dispatch(report)[2]["loss"]))],
        iters=2)["train_step"]
    return out


def decode_vs_prefill(model, params, cfg, rid, generated,
                      tag="slice") -> dict:
    """Prefill the prompt of request ``rid`` plus its generated tokens (a
    length off the buckets: the flash kernel's ragged tile, or K4's
    ragged chunk) and compare, at each generated position, the prefill's
    logits with the greedy choice the decode made there. The two paths
    round differently in bf16 (the fused prefill kernels keep fp32 where
    the plain decode rounds to bf16), so a near-tie may flip; the chosen
    token's prefill logit must then still be within 0.25 of the
    prefill's maximum (logits here have a spread of about 1)."""
    import numpy as np
    import torch

    from repro_torch.data import RequestStream

    req = RequestStream(cfg, buckets=SERVE["buckets"],
                        max_new=SERVE["max_new"],
                        seed=SERVE["seed"]).request(rid)
    seq = np.concatenate([req.tokens, generated[:-1]]).astype(np.int64)
    with torch.no_grad():
        logits, _ = model.prefill(params, torch.from_numpy(seq)[None].cuda())
    logits = logits[0, req.prompt_len - 1:, :cfg.vocab].float()
    if tuple(logits.shape) != (len(generated), cfg.vocab) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits: shape "
                             f"{tuple(logits.shape)} or not finite")
    chosen = torch.from_numpy(np.asarray(generated, np.int64)).cuda()
    agree = (logits.argmax(-1) == chosen).float().mean().item()
    gap = (logits.max(-1).values
           - logits.gather(1, chosen[:, None])[:, 0]).max().item()
    log(f"[{tag}] decode vs prefill (request {rid}, {len(seq)} tokens): "
        f"greedy agreement {agree:.3f}, largest logit gap {gap:.4f} over "
        f"{len(generated)} tokens (logit std {logits.std().item():.3f})")
    if not gap <= 0.25:
        raise AssertionError(f"decode chose a token {gap} below the "
                             f"prefill's best")
    return {"request": rid, "prefill_tokens": len(seq),
            "greedy_agreement": agree, "max_logit_gap": gap, "tol": 0.25,
            "logit_std": logits.std().item(), "positions": len(generated)}


def kernel_table(kernels: list[dict], by_path: dict) -> dict:
    """One row per kernel; its times are those at the shape its main path
    runs most (the longest prompt bucket in bf16 for the forwards, one
    training microbatch in bf16 for the backwards, the largest fp32
    gradient bucket for K3; the other shapes stay under ``shapes``).
    ``launches`` sums the paths run, each counted from 0 just before it
    and read just after (``launches_by_path``)."""
    rows = []
    for k in kernels:
        head = next(sh for sh in k["shapes"] if sh["main"])
        per = {path: n[k["name"]] for path, n in by_path.items()}
        rows.append({
            "name": k["name"], "route": k["route"], "source": k["source"],
            "replaces": k["replaces"],
            "launches": sum(per.values()) if per else None,
            "launches_by_path": per,
            "max_abs_err": k["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "at": head["shape"], "dtype_routes": k.get("dtype_routes"),
            "shapes": k["shapes"]})
    return {"kernels": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", choices=("all", "kernels", "train",
                                        "campaign", "profile"),
                    default="all")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import close_data_group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_main = time.perf_counter()

    def mark(name: str) -> None:
        log(f"[time] {name} at {time.perf_counter() - t_main:.1f} s")

    card = card_line()
    log(f"[device] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    result = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    result["build"] = build_kernels()
    cfg, cfg_ssm = get_config(ARCH), get_config(SSM_ARCH)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    if args.phase == "profile":
        try:
            result["profile"] = profile_phase(cfg, cfg_ssm)
        finally:
            close_data_group()
        (out / "chip_profile.json").write_text(json.dumps(result, indent=1))
        return 0
    try:
        kernels, by_path = [], {}
        if args.phase in ("all", "kernels"):
            mark("kernels")
            kernels = kernel_phase(cfg, cfg_ssm)
        if args.phase == "all":
            mark("reference")
            result["reference"] = reference_phase(cfg)
            result["train_reference"] = train_reference_phase(cfg)
            mark("slice")
            result["slice"] = slice_phase(cfg)
            by_path["serve"] = result["slice"]["launches"]
            by_path["serve_default_spellings"] = \
                result["slice"]["default_spellings"]["launches"]
            mark("ssm")
            result["ssm_reference"] = ssm_reference_phase(cfg_ssm)
            result["ssm_slice"] = slice_phase(cfg_ssm, tag="ssm slice")
            by_path["ssm_serve"] = result["ssm_slice"]["launches"]
            gc.collect()
            torch.cuda.empty_cache()
        if args.phase in ("all", "train"):
            mark("train")
            result["train"] = train_phase(cfg)
            by_path["train"] = result["train"]["launches"]
            gc.collect()
            torch.cuda.empty_cache()
            mark("failure tiers")
            result["failure_tiers"] = failure_tiers_phase(
                cfg, result["train"]["config"]["n_layers"])
            by_path["train_failure_tiers"] = \
                result["failure_tiers"]["launches"]
        if args.phase == "all":
            by_path["serve_wipeout"] = result["slice"]["wipeout_launches"]
            mark("cli")
            result["cli"] = cli_phase()
        if args.phase in ("all", "campaign"):
            gc.collect()
            torch.cuda.empty_cache()
            mark("campaign")
            t0 = time.perf_counter()
            result["campaign"] = campaign_phase(cfg)
            result["campaign"]["seconds"] = time.perf_counter() - t0
            by_path.update(result["campaign"]["launches"])
    finally:
        close_data_group()
    mark("end")
    table = kernel_table(kernels, by_path)
    result["kernels"] = table["kernels"]
    result["seconds"] = time.perf_counter() - t_main
    (out / "chip_smoke.json").write_text(json.dumps(result, indent=1))

    print(json.dumps({"kernels": [{k: v for k, v in row.items()
                                   if k != "shapes"}
                                  for row in table["kernels"]]}))
    if args.phase == "all":
        for phase, tag in (("slice", "slice"), ("ssm_slice", "ssm slice")):
            for name in ("healthy", "burst"):
                r = result[phase]["runs"][name]
                print(f"[{tag}] {result[phase]['config']['arch']} {name}: "
                      f"{r['tokens_per_s']:.2f} tok/s, p50 {r['p50_ms']} "
                      f"ms, p99 {r['p99_ms']} ms per token ({card})")
    if args.phase == "all":
        w = result["slice"]["runs"]["wipeout"]
        print(f"[slice] {result['slice']['config']['arch']} wipeout: "
              f"{w['tokens_per_s']:.2f} tok/s, reload from the checkpoint "
              f"{w['reload_s']:.2f} s, tokens identical ({card})")
    if "failure_tiers" in result:
        f = result["failure_tiers"]
        print(f"[failure tiers] {f['config']['n_layers']} layers: "
              f"{f['ckpt_saves']} saves, checkpoint {f['save_gib']:.2f} GiB "
              f"in {f['save_s']:.2f} s = {f['save_gb_per_s']:.3f} GB/s to "
              f"{f['filesystem']}, restore {f['restore_s']:.2f} s; step "
              f"{f['step_s_save_in_flight_median']} s with a save in "
              f"flight vs {f['step_s_no_save_median']} s; peak RSS "
              f"{f['peak_rss_gib']:.2f} of {f['host_mem_total_gib']:.2f} "
              f"GiB ({card})")
    if "campaign" in result:
        cp = result["campaign"]
        for name, runs in (("trainer", cp["trainer"]), ("gray", cp["gray"])):
            for label, r in runs.items():
                print(f"[campaign] {name} {label}, {cp['depth']} layers: "
                      f"{r['seconds']:.1f} s, step s by S_A "
                      f"{ {sa: v['median'] for sa, v in r['step_s_by_s_a'].items()} }"
                      f", peak {r['peak_gib']:.2f} GiB, peak RSS "
                      f"{r['peak_rss_gib']:.2f} GiB, snapshots "
                      f"{[round(x, 2) for x in r['snapshot_s']]} s ({card})")
        print(f"[campaign] phase {cp['seconds']:.1f} s; DES grid "
              f"{cp['des']['seconds']} s; counts equal to the CPU runs', "
              f"{cp['multi_group_events']} multi-group events, launch.obs "
              f"gates passed ({card})")
    if "train" in result:
        t = result["train"]
        print(f"[train] {t['config']['n_layers']} layers: step "
              f"{t['step_s_median']:.3f} s (median of the replayed S_A=1 "
              f"steps), {t['tokens_per_s']:.1f} tokens/s, sync "
              f"{t['sync_share_median']:.1%} of a step ({card})")
        print(f"[train] peak device memory {t['peak_gib']:.2f} GiB "
              f"allocated, {t['peak_reserved_gib']:.2f} GiB reserved, "
              f"{t['alloc_retries']} allocator retries "
              f"(readings {t['depth_readings']}); snapshot "
              f"{t['snapshot_gib']:.2f} GiB in {t['snapshot_s']:.2f} s; host "
              f"MemTotal {t['host_mem_total_gib']:.1f} GiB ({card})")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
