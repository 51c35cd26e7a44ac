"""Build the port's CUDA kernels from the sources in this checkout.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into a shared library, loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). Libraries go to
``build/kernels/`` at the repository root (``.gitignore`` lists
``build/``) and are named by a hash of their source, every shared header
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and an unchanged one is loaded as it is.

:func:`load` builds on first use; :func:`build_all` starts one ``nvcc``
per source, all at once, and waits for them together. Nothing here runs
at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["build", "build_all", "load", "ptxas_log", "SOURCES"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}

#: every CUDA source of the port (``csrc/<name>.cu``)
SOURCES = ("flash_attention", "int8_ef", "rmsnorm", "ssd_scan", "ssd_scan_bwd")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def ptxas_log(name: str) -> str:
    """What ``nvcc -Xptxas -v`` said when ``name`` was built (registers,
    shared memory, spills per kernel); empty if it was built earlier."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every ``csrc/<name>.cu`` of ``names`` that is not built
    already, one ``nvcc`` per source, all started together. Raises with
    the compiler's output if any build fails."""
    out = {name: _lib_path(name) for name in names}
    todo = [name for name, path in out.items() if not path.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = out[name].with_name(f"{out[name].name}.{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (exit "
                          f"{proc.returncode}):\n{log}")
            continue
        out[name].with_suffix(".log").write_text(log)
        os.replace(tmp, out[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless it is built already."""
    return build_all((name,))[name]


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
    return lib
