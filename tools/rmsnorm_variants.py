#!/usr/bin/env python3
"""Time variants of K1 (the RMSNorm forward) on the card without
touching its source.

    PYTHONPATH=src python tools/rmsnorm_variants.py [NAME ...]

Needs one CUDA card and ``nvcc``. Each variant is a list of text edits to
``src/repro_torch/kernels/csrc/rmsnorm.cu``; the edited copy is compiled
with the port's own flags into ``build/variants/rmsnorm_<name>/``, loaded
in place of the built library (the C entry point is the same), and timed
through ``ops.rmsnorm`` on bf16 rows at K1's main shapes: device ms per
call with the stream held by a spin while the host queues 200 calls, the
bits against the first variant's output, and the largest error in bf16
ulps of its row against the plain version. The variants run in turns,
the unchanged source first and last.

* ``main``: the source as it is (a block per row, two chunks of 16
  bytes a thread up to 2,048 chunks, four beyond);
* ``cpt1``: one chunk a thread where a row fits in 1,024 threads (twice
  the threads a row);
* ``cpt4``: four chunks a thread on every row (half the threads).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time

import torch

from repro_torch.kernels import _build, ops, rmsnorm

OUT = _build.BUILD_DIR.parent / "variants"
SHAPES = ((8, 2048), (512, 2048), (512, 4096), (2048, 2048))
ITERS = 200

_TWO = "  if (nchunks <= 2 * MAX_THREADS)\n"

#: per variant, (old, new, count) edits to the source
VARIANTS = {
    "main": [],
    "cpt1": [(_TWO, "  if (nchunks <= MAX_THREADS)\n    launch_vector<T, 1>"
                    "(x, w, y, rows, d, nchunks, eps, st);\n  else "
                    + _TWO.lstrip(), 1)],
    "cpt4": [(_TWO, "  if (false)\n", 1)],
}


def build(names) -> dict:
    text = (_build.CSRC / "rmsnorm.cu").read_text()
    procs = {}
    for name in names:
        src = text
        for old, new, count in VARIANTS[name]:
            if src.count(old) != count:
                raise AssertionError(f"{name}: {old!r} found "
                                     f"{src.count(old)} times, not {count}")
            src = src.replace(old, new)
        d = OUT / f"rmsnorm_{name}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "rmsnorm.cu").write_text(src)
        lib = d / "librmsnorm.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(d / "rmsnorm.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(json.dumps({"variant": name, "ptxas": regs[:20]}), flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def device_ms(fn) -> float:
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
        for _ in range(ITERS):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / ITERS
        cycles *= 4
    raise AssertionError("the host could not queue the calls in the spin")


def main(names) -> None:
    names = names or list(VARIANTS)
    libs = build(names)
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = []
    for rows, d in SHAPES:
        x = torch.randn((rows, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = torch.rand((d,), generator=gen, device="cuda") + 0.5
        cases.append((x, w, rmsnorm.rmsnorm_ref(x, w)))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    first = {}
    for name in names + names[::-1]:
        fn = libs[name].rmsnorm_fwd
        fn.argtypes = rmsnorm._fn().argtypes
        fn.restype = ctypes.c_int
        rmsnorm._FN = fn
        row = {"variant": name, "card": card, "shapes": []}
        for (x, w, ref), shape in zip(cases, SHAPES):
            with torch.no_grad():
                y = ops.rmsnorm(x, w)
                ms = device_ms(lambda: ops.rmsnorm(x, w))  # noqa: B023
            err = (y.float() - ref.float()).abs().amax(-1)
            ulps = (err / (2.0 ** -7 * ref.float().abs().amax(-1))).max()
            base = first.setdefault(shape, y)
            row["shapes"].append({
                "shape": list(shape), "ms": ms, "row_ulps": ulps.item(),
                "same_bits_as_first": torch.equal(
                    y.view(torch.int16), base.view(torch.int16))})
        print(json.dumps(row), flush=True)
    rmsnorm._FN = None


if __name__ == "__main__":
    main(sys.argv[1:])
