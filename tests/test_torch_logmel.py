"""The port's fused log-mel (``ops/fused_logmel.py``) against the JAX
package, and the frontend's dispatch to it.

``fused_logmel_plain`` (the kernel's plain PyTorch version) is held
against the JAX Pallas kernel ``pallas_logmel`` run in interpret mode, as
``tests/test_pallas_logmel.py`` runs it, at 32 kHz on one tile (1 s, 101
frames) and several (3 s, 301 frames): atol 2e-4 dB, the JAX package's
own tolerance between its kernel and its conv path.  The port's frontend,
which runs the plain version off the kernel's path, is held against the
JAX conv path at 2e-3 dB, as in ``tests/test_torch_frontend.py``.  The CUDA kernel itself runs only on
the card (``tests/test_torch_cuda.py``)."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from audiocaption_tpu.ops import frontend as JF
from audiocaption_tpu_torch import cuda_build
from audiocaption_tpu_torch.ops import frontend as TF
from audiocaption_tpu_torch.ops import fused_logmel as FL

torch.set_num_threads(1)


@pytest.fixture()
def interpreted_pallas(monkeypatch):
    import audiocaption_tpu.ops.pallas_logmel as P
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(P.pl, "pallas_call", patched)
    P.pallas_logmel._clear_cache()
    yield P
    P.pallas_logmel._clear_cache()


def _tables(preset):
    front = TF.LogMelFrontend(getattr(TF, preset))
    return front.basis, front.mel_fb, front.config


def _wave(seconds, sr, seed, batch=2):
    rng = np.random.RandomState(seed)
    wav = (rng.randn(batch, int(seconds * sr)) * 0.1).astype(np.float32)
    wav[-1, wav.shape[1] // 2:] = 0.0     # bucket padding in the last clip
    return wav


@pytest.mark.parametrize("seconds,frames", [(1, 101), (3, 301)],
                         ids=["one_tile", "multi_tile"])
def test_plain_matches_pallas_interpret(interpreted_pallas, seconds, frames):
    cfg = JF.CNN14_MEL_32K
    wav = _wave(seconds, cfg.sample_rate, seed=seconds)
    want = np.asarray(interpreted_pallas.pallas_logmel(jnp.asarray(wav), cfg))
    got = FL.fused_logmel_plain(torch.from_numpy(wav),
                                *_tables("CNN14_MEL_32K"))
    assert got.shape == want.shape == (2, frames, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)


@pytest.mark.parametrize("preset", ["CNN14_MEL_32K", "EFFB2_MEL_16K"])
def test_plain_and_conv_path_match_jax_conv_path(preset):
    """The plain version is config-general (top_db included), agrees with
    the JAX conv path, and is what the port's frontend runs on the CPU."""
    cfg = getattr(JF, preset)
    wav = torch.from_numpy(_wave(1.5, cfg.sample_rate, seed=4))
    want = np.asarray(JF.LogMelFrontend(cfg, use_pallas=False)(
        jnp.asarray(wav.numpy())))
    plain = FL.fused_logmel_plain(wav, *_tables(preset))
    np.testing.assert_allclose(plain.numpy(), want, atol=2e-3, rtol=0)
    front = TF.LogMelFrontend(getattr(TF, preset))
    np.testing.assert_array_equal(front(wav).numpy(), plain.numpy())


def test_cpu_tensor_never_reaches_the_kernel(monkeypatch):
    def no_build(name, signatures):
        raise AssertionError(f"kernel {name} loaded for a CPU tensor")

    monkeypatch.setattr(cuda_build, "load", no_build)
    wav = torch.from_numpy(_wave(1, 32000, seed=5))
    n0 = FL.fused_logmel.launches
    front = TF.LogMelFrontend(TF.CNN14_MEL_32K)
    assert not front.uses_kernel(wav)
    lms = front(wav)
    # the wrapper itself runs the plain version for a CPU tensor
    tables = _tables("CNN14_MEL_32K")
    np.testing.assert_array_equal(FL.fused_logmel(wav, *tables).numpy(),
                                  FL.fused_logmel_plain(wav, *tables).numpy())
    assert FL.fused_logmel.launches == n0
    assert lms.shape == (2, 101, 64)


def test_dispatch_rule_mirrors_jax():
    """A CUDA waveform at 32 kHz takes the kernel; 16 kHz presets and the
    CPU take its plain version (JAX ``_resolve_pallas``)."""
    cuda = types.SimpleNamespace(device=torch.device("cuda"))
    cpu = types.SimpleNamespace(device=torch.device("cpu"))
    for preset, on_cuda in (("CNN14_MEL_32K", True), ("CNN14_MEL_16K", False),
                            ("EFFB2_MEL_16K", False)):
        front = TF.LogMelFrontend(getattr(TF, preset))
        assert front.uses_kernel(cuda) is on_cuda
        assert front.uses_kernel(cpu) is False


def test_wrapper_rejects_what_the_kernel_does_not_take():
    tables = _tables("CNN14_MEL_32K")
    with pytest.raises(ValueError, match="unsupported device"):
        FL.fused_logmel(torch.zeros(1, 32000, device="meta"), *tables)
    with pytest.raises(ValueError, match=r"\[B, T\]"):
        FL.fused_logmel(torch.zeros(32000), *tables)
    with pytest.raises(ValueError, match="too short"):
        FL.fused_logmel(torch.zeros(1, 100), *tables)
