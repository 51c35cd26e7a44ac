"""The PyTorch port stands alone: it imports neither ``jax`` nor the JAX
package ``repro`` nor ``ml_dtypes`` (which comes with jax: the port must
run where none of the three is installed), passes the repo's determinism
lint, and refuses to fall back quietly to the CPU."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.analysis import lint_source

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


FORBIDDEN = ("jax", "repro", "ml_dtypes")


def _forbidden(name: str | None) -> bool:
    return name is not None and (name in FORBIDDEN or name.startswith(
        tuple(f"{m}." for m in FORBIDDEN)))


def test_import_leaves_jax_and_repro_out():
    """Importing the port and every one of its modules, in a fresh
    interpreter, loads neither jax nor any ``repro`` module nor
    ``ml_dtypes``."""
    import repro_torch

    mods = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    for mod in ("serve.replicas", "train.trainer", "exec.executor",
                "dist.collectives", "optim.adamw", "kernels.int8_ef",
                "launch.train", "launch.mesh", "des.schemes",
                "core.rectlr", "scenarios.models", "models.ssm",
                "kernels.ssd_scan", "ckpt.checkpoint", "health.detector",
                "train.injection", "core.montecarlo", "scenarios.campaign",
                "launch.campaign", "launch.obs"):
        assert f"repro_torch.{mod}" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            f"forbidden = {FORBIDDEN!r}\n"
            "bad = sorted(k for k in sys.modules if k in forbidden "
            "or k.startswith(tuple(m + '.' for m in forbidden)))\n"
            "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env=env)
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (
            f"{path.name}:{node.lineno} imports {names}")


def test_port_passes_determinism_lint():
    """The repo's AST passes (wall clock, unseeded randomness, set
    iteration, builtin hash, mutable defaults, thread-shared state) find
    nothing in the port."""
    found = []
    for path in _port_files():
        kept, _ = lint_source(str(path.relative_to(ROOT)), path.read_text())
        found += kept
    assert found == []


def test_cuda_entry_points_refuse_the_cpu_without_a_card():
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model, resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(smoke_config("qwen2.5-3b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_a_card(tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result where there
    is no card, and where only the script is present."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = (ROOT / "chip_smoke.py").read_text()
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(script)
    for where in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, str(where / "chip_smoke.py")],
                             capture_output=True, text=True, cwd=where)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
