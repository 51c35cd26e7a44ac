#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py            # every phase; needs one card

Phases, in order; any failure exits non-zero:

1. **device** — the card's name and power limit (``nvidia-smi``).
2. **build** — compiles every kernel from the sources in this checkout:
   ``nvcc`` for the CUDA source, then the Triton kernel's first launch.
3. **kernels** — each kernel at the main path's shapes (qwen2.5-3b at
   full width) against its plain PyTorch version on the same inputs,
   with the tolerance stated; times the kernel, the plain version and,
   as a yardstick only, the one PyTorch call that computes the same
   function (device time, with the stream held busy while the host
   queues the calls; the host's own cost per call beside it); computes
   the bound from the bytes and flops of the inputs.
4. **reference** — a small configuration with head_dim 128 served in
   fp32 on the card (kernels) and on the CPU (plain versions): greedy
   tokens identical, prefill logits within 1e-4.
5. **slice** — the main path: full-width qwen2.5-3b (36 layers, random
   weights from a seed, bf16) behind a ``ReplicaServer`` with two
   replicas; one healthy run, one where a ``ScriptedInjector`` kills
   replica 0 mid-run. Every request completes in both with zero drops,
   nothing is rebuilt after warmup, the burst run's tokens equal the
   healthy run's, logits are finite, and both kernels' launch counters
   (set to 0 just before, read just after) match the prefills and
   decode steps run, and a prefill of a generated continuation agrees
   with the decode's greedy choices.

Prints the kernel table as one JSON line, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. Details
go to ``chiprun_out/chip_smoke.json``. ``--phase kernels`` stops after
the kernel phase; ``--phase profile`` only profiles a decode step and a
prefill of the main path's model (``chiprun_out/chip_profile.json``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor-core peak
FP32_FLOPS_PER_S = 67e12         # fp32 outside the tensor cores
SPIN_CYCLES = 200_000_000        # ~0.1 s of the SM clock; grown if short
ARCH = "qwen2.5-3b"
SERVE = dict(replicas=2, slots=8, page_size=16, buckets=(128, 512),
             max_new=32, requests=16, kill_step=10, seed=0)


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
def build_kernels() -> dict:
    import torch

    from repro_torch.kernels import _build, ops

    t0 = time.perf_counter()
    _build.load("flash_attention")
    # Triton compiles on first launch
    x = torch.ones((2, 64), dtype=torch.bfloat16, device="cuda")
    ops.rmsnorm(x, torch.ones(64, device="cuda"))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ptxas = _build.ptxas_log("flash_attention")
    log(f"[build] flash_attention: {ptxas.strip()}")
    log(f"[build] kernels built in {secs:.1f} s")
    return {"seconds": secs, "ptxas": {"flash_attention": ptxas}}


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


# ------------------------------------------------------------------ #
# kernel phase                                                       #
# ------------------------------------------------------------------ #
def check_rmsnorm(cfg, rows_list) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.rmsnorm import rmsnorm_ref

    d = cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes, worst = [], 0.0
    for rows in rows_list:
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
            raise AssertionError(f"rmsnorm rows={rows}: {ulps} bf16 ulps "
                                 f"(max err {err}) > 1")
        wb = w.to(torch.bfloat16)
        nbytes = 2 * rows * d * 2 + d * 4
        # the math is fp32 whatever x's dtype
        b_ms, b_by = bound(nbytes, 4 * rows * d, FP32_FLOPS_PER_S)
        ms, host_ms = timed(lambda: ops.rmsnorm(x, w, eps=cfg.norm_eps))
        shapes.append({
            "shape": [rows, d], "tokens": rows, "dtype": "bfloat16",
            "max_abs_err": err, "max_row_ulps": ulps,
            "tol": "1 bf16 ulp per row", "ms": ms, "host_ms": host_ms,
            "plain_ms": cuda_ms(lambda: rmsnorm_ref(x, w, cfg.norm_eps)),
            # yardstick: F.rms_norm takes the weight in x's dtype
            "library_ms": cuda_ms(
                lambda: F.rms_norm(x, (d,), wb, cfg.norm_eps)),
            "bound_ms": b_ms, "bound_by": b_by})
        worst = max(worst, err)
    return {"name": "rmsnorm", "route": "triton",
            "source": "src/repro_torch/kernels/rmsnorm.py",
            "replaces": "src/repro/kernels/rmsnorm.py:44",
            "max_abs_err": worst, "shapes": shapes}


def check_flash(cfg, seqs) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_ref

    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes, worst = [], 0.0
    for s, dtype in seqs:
        # the model's (B, S, H, dh) activations, passed transposed
        q = torch.randn((1, s, h, dh), generator=gen, device="cuda").to(
            dtype).transpose(1, 2)
        k = torch.randn((1, s, kv, dh), generator=gen, device="cuda").to(
            dtype).transpose(1, 2)
        v = torch.randn((1, s, kv, dh), generator=gen, device="cuda").to(
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
            raise AssertionError(f"flash_attention S={s} {dtype}: max err "
                                 f"{err}, {ulps} bf16 ulps; tol {tol}")
        esize = q.element_size()
        nbytes = (2 * s * h * dh + 2 * s * kv * dh) * esize
        flops = 4 * h * dh * s * (s + 1) / 2
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S
                           if dtype == torch.bfloat16 else FP32_FLOPS_PER_S)
        ms, host_ms = timed(lambda: ops.flash_attention(q, k, v))
        shapes.append({
            "shape": {"B": 1, "S": s, "H": h, "KV": kv, "D": dh},
            "tokens": s,
            "dtype": str(dtype).replace("torch.", ""),
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
            "max_abs_err": worst, "shapes": shapes}


def kernel_phase(cfg) -> list[dict]:
    import torch

    rows = [SERVE["slots"], *SERVE["buckets"]]
    seqs = [(s, torch.bfloat16) for s in SERVE["buckets"]]
    seqs += [(200, torch.bfloat16), (SERVE["buckets"][-1], torch.float32)]
    out = [check_rmsnorm(cfg, rows), check_flash(cfg, seqs)]
    for k in out:
        for sh in k["shapes"]:
            log(f"[kernels] {k['name']} {sh['shape']} {sh['dtype']}: "
                f"err {sh['max_abs_err']:.3g} ({sh['max_row_ulps']} ulps) ms {sh['ms']:.4f} (host "
                f"{sh['host_ms']:.4f}) plain "
                f"{sh['plain_ms']:.4f} library {sh['library_ms']:.4f} "
                f"bound {sh['bound_ms']:.5f} ({sh['bound_by']})")
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


def reference_phase(cfg_full) -> dict:
    import numpy as np
    import torch

    from repro_torch.models import build_model, cast_params

    cfg = cfg_full.scaled(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                          head_dim=128, d_ff=512, vocab=1000)
    cpu = build_model(cfg, device="cpu")
    cuda = build_model(cfg, device="cuda")
    params_cpu = cast_params(cpu.init(0), dtype=torch.float32)
    params_gpu = cast_params(params_cpu, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (1, 96)))
    with torch.no_grad():
        l_cpu, _ = cpu.prefill(params_cpu, toks)
        l_gpu, _ = cuda.prefill(params_gpu, toks.to("cuda"))
    err = (l_gpu.cpu() - l_cpu).abs().max().item()
    if not err <= 1e-4:
        raise AssertionError(f"reference: fp32 prefill logits differ by "
                             f"{err} > 1e-4")
    kw = dict(slots=2, page_size=16, buckets=(32, 80), max_new=6)
    t_cpu = serve_tokens(cpu, params_cpu, cfg, 5, **kw)
    t_gpu = serve_tokens(cuda, params_gpu, cfg, 5, **kw)
    same = all(np.array_equal(t_cpu[r], t_gpu[r]) for r in t_cpu)
    if t_cpu.keys() != t_gpu.keys() or not same:
        raise AssertionError("reference: greedy tokens on the card differ "
                             "from the CPU's")
    log(f"[reference] fp32 logits max err {err:.3g}; tokens identical over "
        f"{len(t_cpu)} requests")
    return {"prefill_logits_max_abs_err": err, "tol": 1e-4,
            "requests": len(t_cpu), "tokens_identical": True}


# ------------------------------------------------------------------ #
# slice phase: the main path                                         #
# ------------------------------------------------------------------ #
def run_server(model, params, cfg, kill: bool):
    import torch

    from repro_torch.data import RequestStream
    from repro_torch.launch.serve import build_server, serve_and_measure
    from repro_torch.obs import Telemetry

    args = argparse.Namespace(
        replicas=SERVE["replicas"], slots=SERVE["slots"],
        page_size=SERVE["page_size"], max_new=SERVE["max_new"],
        buckets=",".join(str(b) for b in SERVE["buckets"]),
        kill=f"{SERVE['kill_step']}:0" if kill else None)
    tel = Telemetry(trace=False)
    srv = build_server(args, model, params, telemetry=tel)
    srv.warmup()
    frozen = srv.recompiles
    stream = RequestStream(cfg, buckets=SERVE["buckets"],
                           max_new=SERVE["max_new"], seed=SERVE["seed"])
    done, wall = serve_and_measure(srv, stream.requests(SERVE["requests"]))
    torch.cuda.synchronize()
    hist = tel.snapshot()["histograms"]
    calls = {"prefills": hist["serve.prefill_latency_s"]["count"],
             "decode_steps": hist["serve.token_latency_s"]["count"]}
    return srv, done, wall, frozen, calls


def slice_phase(cfg) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.obs.metrics import latency_stats

    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    params = model.init(SERVE["seed"])
    torch.cuda.synchronize()
    log(f"[slice] {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, init {time.perf_counter() - t0:.1f} s")

    ops.reset_launches()
    runs = {}
    for name, kill in (("healthy", False), ("burst", True)):
        srv, done, wall, frozen, calls = run_server(model, params, cfg, kill)
        stats = latency_stats(done)
        tokens = {d.req_id: d.tokens for d in done}
        runs[name] = {
            **calls, "completed": len(done), "dropped": srv.dropped,
            "requests": SERVE["requests"],
            "misses_after_warmup": srv.recompiles - frozen,
            "events": srv.report()["events"], "wall_s": wall,
            "tokens_per_s": stats["tokens"] / wall, **stats,
            "tokens": tokens}
        log(f"[slice] {name}: {len(done)}/{SERVE['requests']} requests, "
            f"{stats['tokens']} tokens in {wall:.2f} s = "
            f"{stats['tokens'] / wall:.1f} tok/s, p50 {stats['p50_ms']} ms, "
            f"p99 {stats['p99_ms']} ms, events {srv.report()['events']}")
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
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"main path")
    # every prefill runs 2 RMSNorms per layer + the final one and one
    # flash attention per layer; every decode step the same RMSNorms
    prefills = sum(r["prefills"] for r in runs.values())
    steps = sum(r["decode_steps"] for r in runs.values())
    want = {"rmsnorm": (prefills + steps) * (2 * cfg.n_layers + 1),
            "flash_attention": prefills * cfg.n_layers}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want} for "
                             f"{prefills} prefills, {steps} decode steps")

    # output sanity on the main path's model: finite logits of the
    # expected shape, and the paged decode (plain attention) agreeing
    # with the prefill (flash kernel) on the generated continuation
    check = decode_vs_prefill(model, params, cfg,
                              runs["healthy"]["tokens"][0])
    for r in runs.values():
        r["tokens"] = {k: v.tolist() for k, v in r["tokens"].items()}
    return {"config": {"arch": cfg.name, "n_layers": cfg.n_layers,
                       "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                       "n_kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff,
                       "vocab": cfg.vocab, "dtype": "bfloat16"},
            "serve": dict(SERVE, buckets=list(SERVE["buckets"])),
            "launches": launches, "runs": runs, "check": check}


def profile_phase(cfg) -> dict:
    """Where a decode step's and a prefill's time goes, on the main
    path's model: host time per call (host clock around calls that end
    in a synchronize), device time per call and the kernels that take it
    (``torch.profiler``), and the device's busy share of the host's time.
    The decode step has all slots active, each at the longest bucket's
    length; the prefill is one prompt of the longest bucket."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import build_model
    from repro_torch.serve import pages_needed
    from repro_torch.train import make_prefill, make_serve_step

    model = build_model(cfg, device="cuda")
    params = model.init(SERVE["seed"])
    slots, ps = SERVE["slots"], SERVE["page_size"]
    longest = max(SERVE["buckets"])
    m = pages_needed(longest + SERVE["max_new"], ps)
    pools = model.init_paged_state(slots, slots * m + 1, ps)
    table = (1 + torch.arange(slots * m, device="cuda")).reshape(slots, m)
    pos = torch.full((slots,), longest, device="cuda")
    toks = torch.ones((slots, 1), dtype=torch.long, device="cuda")
    step = make_serve_step(model, paged=True)
    prefill = make_prefill(model, return_cache=True)
    prompt = torch.ones((1, longest), dtype=torch.long, device="cuda")
    out, iters = {}, 5
    for name, fn in (("decode_step", lambda: step(params, pools, table, pos,
                                                  toks)),
                     (f"prefill_{longest}", lambda: prefill(params,
                                                            prompt))):
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
        top = sorted(kernels, key=dev_us, reverse=True)[:8]
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


def decode_vs_prefill(model, params, cfg, generated) -> dict:
    """Prefill the prompt of request 0 plus its generated tokens (a
    length off the buckets: the flash kernel's ragged tile) and compare,
    at each generated position, the prefill's logits with the greedy
    choice the decode made there. The two paths round differently in
    bf16 (fp32 flash softmax vs the decode's bf16 probabilities), so a
    near-tie may flip; the chosen token's prefill logit must then still
    be within 0.25 of the prefill's maximum (logits here have a spread
    of about 1)."""
    import numpy as np
    import torch

    from repro_torch.data import RequestStream

    req = RequestStream(cfg, buckets=SERVE["buckets"],
                        max_new=SERVE["max_new"],
                        seed=SERVE["seed"]).request(0)
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
    log(f"[slice] decode vs prefill: greedy agreement {agree:.3f}, "
        f"largest logit gap {gap:.4f} over {len(generated)} tokens "
        f"(logit std {logits.std().item():.3f})")
    if not gap <= 0.25:
        raise AssertionError(f"decode chose a token {gap} below the "
                             f"prefill's best")
    return {"greedy_agreement": agree, "max_logit_gap": gap, "tol": 0.25,
            "logit_std": logits.std().item(), "positions": len(generated)}


def kernel_table(kernels: list[dict], launches: dict) -> dict:
    """One row per kernel; its times are those at the longest prompt
    bucket in bf16 (the other shapes stay under ``shapes``)."""
    longest = max(SERVE["buckets"])
    rows = []
    for k in kernels:
        head = next(sh for sh in k["shapes"] if sh["dtype"] == "bfloat16"
                    and sh["tokens"] == longest)
        rows.append({
            "name": k["name"], "route": k["route"], "source": k["source"],
            "replaces": k["replaces"], "launches": launches.get(k["name"]),
            "max_abs_err": k["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "at": head["shape"], "shapes": k["shapes"]})
    return {"kernels": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", choices=("all", "kernels", "profile"),
                    default="all")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    from repro_torch.configs import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[device] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    result = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    result["build"] = build_kernels()
    cfg = get_config(ARCH)
    if args.phase == "profile":
        result["profile"] = profile_phase(cfg)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_profile.json").write_text(json.dumps(result, indent=1))
        return 0
    kernels = kernel_phase(cfg)
    launches = {}
    if args.phase == "all":
        result["reference"] = reference_phase(cfg)
        result["slice"] = slice_phase(cfg)
        launches = result["slice"]["launches"]
    table = kernel_table(kernels, launches)
    result["kernels"] = table["kernels"]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(result, indent=1))

    print(json.dumps({"kernels": [{k: v for k, v in row.items()
                                   if k != "shapes"}
                                  for row in table["kernels"]]}))
    if args.phase == "all":
        for name in ("healthy", "burst"):
            r = result["slice"]["runs"][name]
            print(f"[slice] {name}: {r['tokens_per_s']:.2f} tok/s, p50 "
                  f"{r['p50_ms']} ms, p99 {r['p99_ms']} ms per token "
                  f"({card})")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
