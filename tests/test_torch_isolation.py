"""The PyTorch port stands alone: no module of ``audiocaption_tpu_torch``
(nor ``chip_smoke.py``, nor the test files that also run where JAX is
absent: the card-only kernel tests and the log-mel kernel's host-side
tests) imports ``jax``, ``flax`` or ``audiocaption_tpu``, not even a
module of the JAX package that is itself free of JAX."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "audiocaption_tpu_torch"
BLOCKED = ("jax", "flax", "audiocaption_tpu")
SOURCES = sorted(PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py",
    ROOT / "tests" / "test_torch_logmel_fft.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(BLOCKED))
    assert not bad, f"{path.name} imports {bad}"


def test_every_module_imports_with_jax_blocked():
    """Import every module of the package in a fresh interpreter in which
    jax, flax and audiocaption_tpu cannot be imported."""
    code = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None          # any import of these now fails
import audiocaption_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    audiocaption_tpu_torch.__path__, "audiocaption_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = [m for m in sys.modules
          if m.split(".")[0] in {BLOCKED!r} and sys.modules[m] is not None]
assert not leaked, leaked
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 14
