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
for name in ("audiocaption_tpu_torch.native",
             "audiocaption_tpu_torch.training.scst",
             "audiocaption_tpu_torch.training.distill",
             "audiocaption_tpu_torch.losses.kd",
             "audiocaption_tpu_torch.data.kd_dataset",
             "audiocaption_tpu_torch.models.encoders_extra",
             "audiocaption_tpu_torch.cli.inference",
             "audiocaption_tpu_torch.cli.eval_tools",
             "audiocaption_tpu_torch.decoding.ensemble",
             "audiocaption_tpu_torch.decoding.select",
             "audiocaption_tpu_torch.metrics.bleu",
             "audiocaption_tpu_torch.metrics.rouge",
             "audiocaption_tpu_torch.metrics.porter",
             "audiocaption_tpu_torch.metrics.meteor",
             "audiocaption_tpu_torch.metrics.spice",
             "audiocaption_tpu_torch.metrics.eval",
             "audiocaption_tpu_torch.metrics.diversity",
             "audiocaption_tpu_torch.metrics.extra",
             "audiocaption_tpu_torch.metrics.tools",
             "audiocaption_tpu_torch.cli.synthetic_corpus",
             "audiocaption_tpu_torch.cli.recipes",
             "audiocaption_tpu_torch.data.condition_dataset",
             "audiocaption_tpu_torch.training.sed_trainer",
             "audiocaption_tpu_torch.ops.specaug",
             "audiocaption_tpu_torch.data.augment",
             "audiocaption_tpu_torch.losses.wrappers",
             "audiocaption_tpu_torch.training.aug_runner",
             "audiocaption_tpu_torch.cli.data_tools",
             "audiocaption_tpu_torch.models.hm_classifier",
             "audiocaption_tpu_torch.models.rnn_decoder",
             "audiocaption_tpu_torch.models.cnn14",
             "audiocaption_tpu_torch.losses.loss",
             "audiocaption_tpu_torch.models.m2",
             "audiocaption_tpu_torch.data.device_bank",
             "audiocaption_tpu_torch.data.prefetch",
             "audiocaption_tpu_torch.cli.prepare_features",
             "audiocaption_tpu_torch.models.mobilenet_v3",
             "audiocaption_tpu_torch.models.htsat",
             "audiocaption_tpu_torch.models.uit",
             "audiocaption_tpu_torch.models.resnext",
             "audiocaption_tpu_torch.models.panns"):
    assert name in names, name
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 14


def test_native_scorer_is_the_ports_own():
    """The port builds its own copy of the C++ scorer, from inside its
    package, into the repository's build directory."""
    from audiocaption_tpu_torch import native
    assert native.SOURCE.is_file()
    assert native.SOURCE.parent == PKG / "native"
    assert native.BUILD_DIR == ROOT / "build" / "native"
    assert "audiocaption_tpu/" not in native.SOURCE.read_text()
