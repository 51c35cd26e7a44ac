#!/usr/bin/env python3
"""Time variants of K4-bwd's bf16 route on the card without touching its
source.

    PYTHONPATH=src python tools/ssd_bwd_variants.py [NAME ...]

Needs one CUDA card and ``nvcc``. Each variant is a list of text edits to
the tensor-core part of ``src/repro_torch/kernels/csrc/ssd_scan_bwd.cu``
(the text from ``namespace tc {`` on); the edited copy (with the shared
``hopper.cuh``) is compiled with the port's own flags into
``build/variants_bwd/<name>/``, loaded in place of the built library (the
C entry point is the same), and timed through ``ssd_scan_bwd_cuda`` at
the mamba2-1.3b training microbatch (B 8, S 512, H 64, P 64, N 128, G 1,
chunks of 256, bf16, no d_final), by kernel name (``torch.profiler``,
20 calls after 3 warm ones), with each output's distance from the plain
backward in gate units (bf16 ulps of the row's largest |ref| for dx, db,
dc; 1e-5 of the largest |ref| for ddt and da_log). The variants run in
turns, the first named (by default the unchanged source) first and last.
The ``no_*`` variants give wrong results and serve only to time what a
part of the kernel costs.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build, ssd_scan

OUT = _build.BUILD_DIR.parent / "variants_bwd"
ITERS = 20

#: per variant, (old, new, count) edits to the tensor-core part
VARIANTS = {
    "main": [],
    # no shuffles for those column sums
    "no_col_shfl": [("        col_sums(cols, s_red + ((s & 1) * 4 + warp) * TILE, cq,"
                     " lane);\n", "", 1)],
    # no elementwise step between the dx/db pass's products
    "no_pair_terms": [("        if (it == jt)\n          pair_terms<true>",
                       "        if (false)\n          pair_terms<true>", 1),
                      ("        else\n          pair_terms<false>",
                       "        else if (false)\n          pair_terms<false>",
                       1)],
    # no state-term products in the dx/db pass
    "no_state": [("        for (int part = 0; part < 3; ++part)\n#pragma unroll\n"
                  "          for (int kk = 0; kk < KN; ++kk)\n",
                  "        for (int part = 0; part < 0; ++part)\n#pragma unroll\n"
                  "          for (int kk = 0; kk < KN; ++kk)\n", 1),
                 ("        for (int part = 0; part < 3; ++part)\n#pragma unroll\n"
                  "          for (int kk = 0; kk < KP; ++kk)\n"
                  "            ss_mn<NB>(xds",
                  "        for (int part = 0; part < 0; ++part)\n#pragma unroll\n"
                  "          for (int kk = 0; kk < KP; ++kk)\n"
                  "            ss_mn<NB>(xds", 1)],
    # no elementwise step between the dc pass's products
    "no_dcb_terms": [("        if (s == it)\n          dcb_terms<true>",
                      "        if (false)\n          dcb_terms<true>", 1),
                     ("        else\n          dcb_terms<false>",
                      "        else if (false)\n          dcb_terms<false>",
                      1)],
    # the fast approximate exponential
    "fast_exp": [("expf(", "__expf(", None)],
    "trace": "TRACE",
}

#: ``trace``: clock64() marks of thread 0 of the dx/db pass's block (0, 0,
#: 0) after each part of its loop, and every block's entry and exit time
TRACE_HEAD = """
__device__ long long g_mark[4096];
__device__ int g_kind[4096];
__device__ unsigned long long g_blk[2][8192];
__device__ __forceinline__ unsigned long long bwd_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define BWD_MARK(k)                                                     \\
  do {                                                                  \\
    if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&        \\
        threadIdx.x == 0 && mark_n < 4096) {                            \\
      g_mark[mark_n] = clock64();                                       \\
      g_kind[mark_n++] = (k);                                           \\
    }                                                                   \\
  } while (0)
"""
TRACE_TAIL = """
extern "C" int bwd_read_trace(long long* m, int* k, unsigned long long* b) {
  cudaMemcpyFromSymbol(m, tc::g_mark, sizeof(tc::g_mark));
  cudaMemcpyFromSymbol(k, tc::g_kind, sizeof(tc::g_kind));
  return (int)cudaMemcpyFromSymbol(b, tc::g_blk, sizeof(tc::g_blk));
}
"""
#: what each mark follows
MARKS = {0: "start", 1: "state tiles in", 2: "B_j dS^T", 3: "X_j dS",
         4: "step barrier", 5: "B_j C_i^T, X_j dY_i^T",
         6: "elementwise", 7: "dx += W^T dY, db += dCB^T C", 8: "end"}
TRACE = [
    ("  for (int e = tid; e < hw * MAX_Q; e += NT) s_dcum[e] = 0.0;\n",
     "  int mark_n = 0;\n  const int blk = blockIdx.x + gridDim.x * (blockIdx.y"
     " + gridDim.y * blockIdx.z);\n  if (threadIdx.x == 0 && blk < 8192) "
     "g_blk[0][blk] = bwd_ns();\n  BWD_MARK(0);\n"
     "  for (int e = tid; e < hw * MAX_Q; e += NT) s_dcum[e] = 0.0;\n", 1),
    ("      load_parts<NB>(s_rg, reinterpret_cast<const bf16*>(p.ws_ds) + unit,"
     " tid);\n      cp_commit();\n      cp_wait<0>();\n      fence_proxy_async();"
     "\n      __syncthreads();\n",
     "      load_parts<NB>(s_rg, reinterpret_cast<const bf16*>(p.ws_ds) + unit,"
     " tid);\n      cp_commit();\n      cp_wait<0>();\n      fence_proxy_async();"
     "\n      __syncthreads();\n      BWD_MARK(1);\n", 1),
    ("        fence_regs(dsb);\n", "        fence_regs(dsb);\n        BWD_MARK(2);\n", 1),
    ("        fence_regs(xds);\n", "        fence_regs(xds);\n        BWD_MARK(3);\n", 1),
    ("        if (s > 0) add_cols(jt + s - 1);\n",
     "        if (s > 0) add_cols(jt + s - 1);\n        BWD_MARK(4);\n", 1),
    ("        fence_regs(cbt);\n        fence_regs(gt);\n",
     "        fence_regs(cbt);\n        fence_regs(gt);\n        BWD_MARK(5);\n", 1),
    ("                            ghi, glo, ks, kd, cols);\n",
     "                            ghi, glo, ks, kd, cols);\n        BWD_MARK(6);\n", 1),
    ("        fence_regs(dx);\n        fence_regs(db);\n      }\n",
     "        fence_regs(dx);\n        fence_regs(db);\n        BWD_MARK(7);\n      }\n", 1),
    ("              make_float2(db[4 * n + 2 * e2], db[4 * n + 2 * e2 + 1]);\n"
     "      }\n  }\n}\n",
     "              make_float2(db[4 * n + 2 * e2], db[4 * n + 2 * e2 + 1]);\n"
     "      }\n  }\n  BWD_MARK(8);\n  if (threadIdx.x == 0 && blk < 8192) "
     "g_blk[1][blk] = bwd_ns();\n}\n", 1),
]


def source(name: str) -> Path:
    text = (_build.CSRC / "ssd_scan_bwd.cu").read_text()
    cut = text.index("namespace tc {")
    head, tail = text[:cut], text[cut:]
    edits = TRACE if VARIANTS[name] == "TRACE" else VARIANTS[name]
    for old, new, count in edits:
        if count is not None and tail.count(old) != count:
            raise AssertionError(f"{name}: {old!r} found {tail.count(old)} "
                                 f"times, not {count}")
        tail = tail.replace(old, new)
    if edits is TRACE:
        tail = tail.replace("namespace tc {", "namespace tc {\n" + TRACE_HEAD,
                            1) + TRACE_TAIL
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for h in _build.CSRC.glob("*.cuh"):
        (d / h.name).write_text(h.read_text())
    (d / "ssd_scan_bwd.cu").write_text(head + tail)
    return d / "ssd_scan_bwd.cu"


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
        lines = log.splitlines()
        spills = [f"{m.group(1)}: {lines[i + 1].strip()}; "
                  f"{lines[i + 2].split(':')[-1].strip()}"
                  for i, ln in enumerate(lines[:-2])
                  if (m := re.search(r"properties for \w*tc\d+(\w+_bf16I\w+?)E",
                                     ln))]
        libs[name] = (ctypes.CDLL(str(lib)), spills)
    return libs


def by_kernel(fn) -> dict:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and e.self_device_time_total > 0:
            name = re.search(r"(\w+)(<\d+>)?\(\(anon", e.key)
            out[name.group(1) if name else e.key[:40]] = \
                e.self_device_time_total / 1e3 / ITERS
    return out


def units(got, want) -> dict:
    out = {}
    for name, g, w in zip(("dx", "ddt", "da_log", "db", "dc"), got, want):
        g, w = g.float(), w.float()
        if name in ("ddt", "da_log"):
            out[name] = ((g - w).abs().max() / (1e-5 * w.abs().max())).item()
        else:
            out[name] = ((g - w).abs().amax(-1)
                         / (2.0 ** -7 * w.abs().amax(-1)).clamp_min(1e-30)
                         ).max().item()
    return out


def main(names) -> None:
    names = names or list(VARIANTS)
    libs = build(names)
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
    args = (x, dt, a_log, bb, cc, dy, None, q)
    spec = ssd_scan.ssd_scan_bwd_ref(*args)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    argtypes = ssd_scan._bwd().argtypes
    for name in names + names[::-1]:
        lib, spills = libs[name]
        fn = lib.ssd_scan_bwd
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        ssd_scan._BWD = fn
        call = lambda: ssd_scan.ssd_scan_bwd_cuda(*args)  # noqa: E731
        kernels = by_kernel(call)
        print(json.dumps({"variant": name, "ms": sum(kernels.values()),
                          "kernels": kernels, "gate_units": units(call(), spec),
                          "ptxas": spills, "card": card}), flush=True)
    ssd_scan._BWD = None
    if "trace" in libs:
        print_trace(libs["trace"][0], (s // q) * (h // ssd_scan.bwd_heads_per_block(
            torch.bfloat16, b, h, g, s, q)) * b)


def print_trace(lib, n_blocks: int) -> None:
    """Cycles of block (0, 0, 0) of the dx/db pass in each part of its
    loop (summed over its visits, from the previous mark), and when the
    pass's blocks enter and leave (ns from the first entry)."""
    marks = (ctypes.c_longlong * 4096)()
    kinds = (ctypes.c_int * 4096)()
    blk = (ctypes.c_ulonglong * (2 * 8192))()
    lib.bwd_read_trace(marks, kinds, blk)
    seq = [(marks[i], kinds[i]) for i in range(4096) if marks[i]]
    parts: dict = {}
    for (c0, _), (c1, k1) in zip(seq, seq[1:]):
        name = MARKS[k1]
        parts[name] = parts.get(name, 0) + c1 - c0
    enter = sorted(blk[i] for i in range(n_blocks))
    leave = sorted(blk[8192 + i] for i in range(n_blocks))
    took = sorted(blk[8192 + i] - blk[i] for i in range(n_blocks))
    t0 = enter[0]
    print(json.dumps({
        "block0_cycles": seq[-1][0] - seq[0][0], "block0_parts": parts,
        "marks": len(seq), "blocks": n_blocks,
        "enter_last_ns": enter[-1] - t0, "leave_first_ns": leave[0] - t0,
        "leave_last_ns": leave[-1] - t0,
        "block_ns_min_median_max": [took[0], took[n_blocks // 2],
                                    took[-1]]}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
