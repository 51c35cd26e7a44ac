#!/usr/bin/env python3
"""Where the multi-threaded fp32 ``torch.tanh`` fault on the CPU comes from.

    PYTHONPATH=src python tools/mkl_tanh_race.py [--runs 150] [--jobs 4]

On an x86 CPU build of PyTorch that links Intel MKL, ``torch.tanh`` on
fp32 goes through MKL's vector math (``vmsTanh``, asked for its high
accuracy mode), one chunk of the tensor per OpenMP thread. The first such
call in a fresh process has been seen to return one thread's whole chunk
about 1,500 ulps from the correctly rounded value.

Each run is a fresh process on the same 131,072 inputs (the fp32 gelu's
tanh argument over the values the families tests draw), split by 8
threads in chunks of 16,384: one parallel multiply (so the thread pool
exists), then ``torch.tanh``, as the port's ``gelu`` calls it. A run
counts as a fault when an element is more than 2 ulps from the float64
tanh rounded to fp32. For the first fault, fresh processes limited by
``MKL_ENABLE_INSTRUCTIONS`` to AVX2 and to AVX-512 call ``vmsTanh`` from
the library torch links on the faulty chunk, on one thread, in each
accuracy mode (LA, HA, EP); the script prints how many elements of each
differ from the faulty chunk. Zero names the code path the faulty
thread ran. CPU only; needs torch (not the card).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

CHUNK, THREADS = 16_384, 8
#: MKL's accuracy modes, each with denormals kept and errors ignored, as
#: torch passes them
MODES = {"LA": 0x1, "HA": 0x2, "EP": 0x3}
FLAGS = 0x140000 | 0x100


def _inputs() -> np.ndarray:
    rng = np.random.default_rng(1)
    x = rng.standard_normal(CHUNK * THREADS).astype(np.float32) * 3.0
    x[: x.size // 16] = rng.uniform(-12.0, 12.0, x.size // 16)
    c, k = np.float32(np.sqrt(2 / np.pi)), np.float32(0.044715)
    return c * (x + k * (x * x * x))


def torch_run() -> dict:
    import torch

    torch.set_num_threads(THREADS)
    u = _inputs()
    torch.from_numpy(u) * torch.from_numpy(u)
    out = torch.tanh(torch.from_numpy(u)).numpy()
    want = np.tanh(u.astype(np.float64)).astype(np.float32)
    ulps = np.abs(out.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    chunks = sorted({int(i) // CHUNK for i in np.nonzero(ulps > 2)[0]})
    return {"chunks": chunks, "max_ulps": int(ulps.max()),
            "bits": {c: out[c * CHUNK:(c + 1) * CHUNK].view(np.int32)
                     .tolist() for c in chunks}}


def mkl_modes(chunk: int) -> dict:
    import torch

    lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib",
                                   "libtorch_cpu.so"))
    fn = lib.vmsTanh
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong]
    u = np.ascontiguousarray(_inputs()[chunk * CHUNK:(chunk + 1) * CHUNK])
    out = {}
    for name, mode in MODES.items():
        o = np.zeros(CHUNK, np.float32)
        fn(CHUNK, u.ctypes.data, o.ctypes.data, mode | FLAGS)
        out[name] = o.view(np.int32).tolist()
    return out


def _child(args: list[str], env: dict | None = None) -> dict:
    out = subprocess.run([sys.executable, __file__, *args],
                         capture_output=True, text=True, check=True,
                         env=env)
    return json.loads(out.stdout.splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=150,
                    help="fresh processes")
    ap.add_argument("--jobs", type=int, default=4,
                    help="processes at a time")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child == "torch":
        print(json.dumps(torch_run()))
        return 0
    if args.child:
        print(json.dumps(mkl_modes(int(args.child))))
        return 0

    with ThreadPoolExecutor(args.jobs) as pool:
        runs = list(pool.map(lambda _: _child(["--child", "torch"]),
                             range(args.runs)))
    hits = [r for r in runs if r["chunks"]]
    print(f"torch.tanh: {len(hits)} of {len(runs)} fresh processes with a "
          f"faulty chunk" + "".join(f"; chunks {r['chunks']}, "
                                    f"{r['max_ulps']} ulps" for r in hits))
    if not hits:
        return 0
    chunk, bits = next(iter(hits[0]["bits"].items()))
    bits = np.asarray(bits)
    for isa in ("AVX2", "AVX512"):
        env = dict(os.environ, MKL_ENABLE_INSTRUCTIONS=isa)
        modes = _child(["--child", str(chunk)], env)
        print(f"MKL {isa}: " + ", ".join(
            f"{name} differs from the faulty chunk {chunk} in "
            f"{int((np.asarray(v) != bits).sum())} of {CHUNK} elements"
            for name, v in modes.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
