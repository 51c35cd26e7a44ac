#!/usr/bin/env python3
"""Time variants of K4's bf16 route on the card without touching its
source, and trace where one block's time goes.

    PYTHONPATH=src python tools/ssd_variants.py [NAME ...]

Needs one CUDA card and ``nvcc``. Each variant is a list of text edits to
``src/repro_torch/kernels/csrc/ssd_scan.cu``; the edited copy (with the
shared ``hopper.cuh``) is compiled with the port's own flags into
``build/variants/<name>/``, loaded in place of the built library (the
wrapper's C entry point is the same), and timed through
``ops.ssd_scan`` at the mamba2-1.3b prefill of 512 tokens (B 1, H 64,
P 64, N 128, G 1, chunks of 256, bf16): device time per call with the
stream held by a spin while the host queues 50 calls, and y's largest
error in bf16 ulps of its row against the plain version. The variants
run in turns, the unchanged source first and last.

``trace`` records ``clock64()`` in block (0, 0, 0) where each of its
warpgroups (y, state) arrives at each barrier, and in the y warpgroup
around its products, and every block's entry and exit time
(``%globaltimer``); it prints each mark's cycles from the block's first
mark beside the line of code before it. The ``no_*`` variants give
wrong results and serve only to time what a part of the kernel costs.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from repro_torch.kernels import _build, ops, ssd_scan

OUT = _build.BUILD_DIR.parent / "variants"

#: per variant, (old, new, count) edits applied to the tensor-core part
#: of the source (the text from ``namespace tc {`` on)
TRACE = [
    ("  const int tid = threadIdx.x;\n",
     "  const int tid = threadIdx.x;\n  int mark_n = 0;\n", 1),
    ("__syncthreads();", "SSD_MARK(); __syncthreads();", 4),
    ("          fence_regs(s);\n",
     "          fence_regs(s);\n          SSD_MARK();\n", 1),
    ("          gmma_fence();\n#pragma unroll\n          for (int m = 0; m < 4;",
     "          SSD_MARK();\n          gmma_fence();\n#pragma unroll\n"
     "          for (int m = 0; m < 4;", 1),
    ("          fence_regs(y);\n          if (diag)",
     "          fence_regs(y);\n          SSD_MARK();\n          if (diag)", 1),
    ("""  if (tiles[0] < 0) return;  // a one-tile chunk: block 0 takes it all
""", """  const int blk = blockIdx.x + 2 * (blockIdx.y + gridDim.y * blockIdx.z);
  if (threadIdx.x == 0 && blk < 4095) g_blk[blk][0] = ssd_ns();
  if (threadIdx.x == 0 && blk == 0) g_blk[4095][0] = clock64();
  if (tiles[0] < 0) return;  // a one-tile chunk: block 0 takes it all
""", 1),
    ("""    ssd_role<N, true>(p);
}""", """    ssd_role<N, true>(p);
  __syncthreads();
  if (threadIdx.x == 0 && blk < 4095) g_blk[blk][1] = ssd_ns();
}""", 1),
]
TRACE_HEAD = """
__device__ long long g_clk[3][256];
__device__ int g_kind[3][256];
__device__ unsigned long long g_blk[4096][2];  // per block: entry, exit (ns)
__device__ __forceinline__ unsigned long long ssd_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define SSD_MARK()                                                        \\
  do {                                                                    \\
    if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&          \\
        threadIdx.x % NT == 0 && mark_n < 256) {                          \\
      g_kind[threadIdx.x / NT][mark_n] = __LINE__;                        \\
      g_clk[threadIdx.x / NT][mark_n++] = clock64();                      \\
    }                                                                     \\
  } while (0)
"""
TRACE_TAIL = """
extern "C" int ssd_read_trace(long long* clk, int* kind,
                              unsigned long long* blk) {
  cudaError_t e = cudaMemcpyFromSymbol(clk, tc::g_clk, sizeof(tc::g_clk));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(kind, tc::g_kind, sizeof(tc::g_kind));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(blk, tc::g_blk, sizeof(tc::g_blk));
  return (int)e;
}
"""

VARIANTS = {
    "main": [],
    "trace": TRACE,
    # the next step's copies issued after this step's tiles have arrived
    # and the barrier, not before the wait
    "late_issue": [
        ("""      if (j + 1 < steps) {
        load_step(ch, j + 1, stage ^ 1);
        cp_commit();
        cp_wait<1>();
      } else if (ch + 1 < nch) {
        load_header(ch + 1, hb ^ 1);
        load_step(ch + 1, 0, stage ^ 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      fence_proxy_async();
      __syncthreads();
""", """      cp_wait<0>();
      fence_proxy_async();
      __syncthreads();
      if (j + 1 < steps) {
        load_step(ch, j + 1, stage ^ 1);
      } else if (ch + 1 < nch) {
        load_header(ch + 1, hb ^ 1);
        load_step(ch + 1, 0, stage ^ 1);
      }
      cp_commit();
""", 1)],
    # timing only, wrong results: the state warpgroup does no products
    "no_state": [("} else if (need_state) {", "} else if (false) {", 1)],
    # the decays of W as __expf (ex2.approx) instead of expf
    "fast_exp": [("] * expf(gj", "] * __expf(gj", 4),
                 ("= expf(cm", "= __expf(cm", 2),
                 ("rf0 = expf(ci0 - cm), rf1 = expf(ci1 - cm)",
                  "rf0 = __expf(ci0 - cm), rf1 = __expf(ci1 - cm)", 1)],
    # x u in the state update in two bf16 parts, not three
    "xu_two_parts": [("for (int part = 0; part < 3; ++part)",
                      "for (int part = 0; part < 2; ++part)", 1)],
    # timing only, wrong results: the state warpgroup builds no A
    # fragments (its products read constants)
    "no_frags": [("""            const float v0 = __bfloat162float(sx[gmma_off<TILE>(jl, pc) + pe])
                             * s_u[j * TILE + jl];
            const float v1 =
                __bfloat162float(sx[gmma_off<TILE>(jl + 1, pc) + pe])
                * s_u[j * TILE + jl + 1];""", """            const float v0 = 0.5f * pp, v1 = 0.25f * jl;""", 1)],
    # timing only, wrong results: the state warpgroup builds its A
    # fragments but issues no products
    "no_state_mma": [("            if constexpr (NB == 128)\n              wgmma_rs_n128",
                      "            if constexpr (NB == 0)\n              wgmma_rs_n128", 1),
                     ("            else\n              wgmma_rs_n64(sa, xa",
                      "            else if (xa[m][part][0] == 1234567u)\n"
                      "              wgmma_rs_n64(sa, xa", 1)],
}


def source(name: str) -> Path:
    text = (_build.CSRC / "ssd_scan.cu").read_text()
    cut = text.index("namespace tc {")
    head, tail = text[:cut], text[cut:]
    for old, new, count in VARIANTS[name]:
        if tail.count(old) != count:
            raise AssertionError(f"{name}: {old!r} found {tail.count(old)} "
                                 f"times, not {count}")
        tail = tail.replace(old, new)
    if name == "trace":
        tail = tail.replace("namespace tc {", "namespace tc {\n" + TRACE_HEAD,
                            1) + TRACE_TAIL
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for h in _build.CSRC.glob("*.cuh"):
        (d / h.name).write_text(h.read_text())
    (d / "ssd_scan.cu").write_text(head + tail)
    return d / "ssd_scan.cu"


def build(names) -> dict:
    procs = {}
    for name in names:
        src = source(name)
        lib = src.with_suffix(".so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def device_ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    cycles = 200_000_000
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
            return ev[1].elapsed_time(ev[2]) / iters
        cycles *= 4
    raise AssertionError("the host could not queue the calls in the spin")


def main(names) -> None:
    names = names or list(VARIANTS)
    libs = build(names)
    gen = torch.Generator(device="cuda").manual_seed(8)
    b, s, h, p, n = 1, 512, 64, 64, 128
    x = torch.randn((b, s, h, p), generator=gen, device="cuda").to(
        torch.bfloat16).transpose(1, 2)
    dt = (torch.rand((b, s, h), generator=gen, device="cuda") * 0.099
          + 0.001).transpose(1, 2)
    a_log = torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                   device="cuda"))
    bb, cc = (torch.randn((b, s, 1, n), generator=gen, device="cuda").to(
        torch.bfloat16).transpose(1, 2) for _ in range(2))
    y_ref, _ = ssd_scan.ssd_scan_ref(x, dt, -torch.exp(a_log), bb, cc, 256)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    for name in names + names[::-1]:
        fn = libs[name].ssd_scan_fwd
        fn.argtypes = ssd_scan._fn().argtypes
        fn.restype = ctypes.c_int
        ssd_scan._FN = fn
        call = lambda: ops.ssd_scan(x, dt, a_log, bb, cc, chunk=256)  # noqa: E731
        y, _ = call()
        err = (y.float() - y_ref).abs().amax(-1)
        ulps = (err / (2.0 ** -7 * y_ref.abs().amax(-1))).max().item()
        print(json.dumps({"variant": name, "ms": device_ms(call),
                          "y_row_ulps": ulps, "card": card}), flush=True)
    ssd_scan._FN = None
    if "trace" in libs:
        print_trace(libs["trace"], 2 * h * b)


def print_trace(lib, n_blocks: int) -> None:
    clk = (ctypes.c_longlong * (3 * 256))()
    kind = (ctypes.c_int * (3 * 256))()
    blk = (ctypes.c_ulonglong * (2 * 4096))()
    lib.ssd_read_trace(clk, kind, blk)
    enter = sorted(blk[2 * i] for i in range(n_blocks))
    leave = sorted(blk[2 * i + 1] for i in range(n_blocks))
    t0 = enter[0]
    print(f"blocks (ns from the first entry): last entry {enter[-1] - t0}; "
          f"exits first {leave[0] - t0}, median {leave[n_blocks // 2] - t0}, "
          f"last {leave[-1] - t0}; block (0, 0, 0) took "
          f"{blk[1] - blk[0]}", flush=True)
    lines = (OUT / "trace" / "ssd_scan.cu").read_text().split("\n")
    first = min(c for c in clk if c)
    print(f"block (0, 0, 0): first mark {first - blk[2 * 4095]} cycles after "
          f"its entry", flush=True)
    for wg in range(3):
        marks = [(clk[256 * wg + i], kind[256 * wg + i]) for i in range(256)
                 if clk[256 * wg + i]]
        if marks:
            print(f"warpgroup {wg}, cycles from the block's first mark:")
        for c, line in marks:
            code = lines[line - 1].replace("SSD_MARK();", "").strip() \
                or lines[line - 2].strip()
            print(f"  {c - first:8d}  L{line}  {code[:48]}", flush=True)

if __name__ == "__main__":
    main(sys.argv[1:])
