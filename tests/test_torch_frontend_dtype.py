"""Item 9 of the JAX frontend: the DFT input type of the log-mel
frontend (``LogMelFrontend(compute_dtype=...)``,
``ops/fused_logmel.py::fused_logmel_plain(compute_dtype=...)``) against
JAX's ``LogMelFrontend(compute_dtype=jnp.bfloat16)`` on the CPU.

bf16 is held by ``test_torch_bf16.py::floor_check`` at both presets that
have a kernel or a conv-DFT path of their own (the flagship's 16 kHz
EffB2 preset with its top_db floor, the 32 kHz Cnn14 preset): the port
no further from JAX's bf16 log-mel than JAX's bf16 log-mel is from its
float32 one.  Both round the reflect-padded wave and the windowed basis
to bf16 and sum their products in float32; the order of the sums
differs.  Float32 is the default and stays as it was: equal to the
frontend built without the option, and within test_torch_frontend.py's
2e-3 dB of JAX."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiocaption_tpu.ops import frontend as JF
from audiocaption_tpu_torch.ops import frontend as TF
from audiocaption_tpu_torch.ops import fused_logmel as FL

from test_torch_bf16 import floor_check

PRESETS = ["EFFB2_MEL_16K", "CNN14_MEL_32K"]


def _wave(cfg, seconds=1.5):
    rng = np.random.RandomState(7)
    n = int(seconds * cfg.sample_rate)
    wav = (rng.randn(2, n) * 0.1).astype(np.float32)
    wav[1, n // 2:] = 0.0
    return wav


@pytest.mark.parametrize("preset", PRESETS)
def test_bf16_dft_input_by_floor_check(preset):
    cfg = getattr(JF, preset)
    wav = _wave(cfg)
    jb = JF.LogMelFrontend(cfg, compute_dtype=jnp.bfloat16,
                           use_pallas=False)(jnp.asarray(wav))
    jf = JF.LogMelFrontend(cfg, use_pallas=False)(jnp.asarray(wav))
    front = TF.LogMelFrontend(getattr(TF, preset),
                              compute_dtype=torch.bfloat16)
    got = front(torch.from_numpy(wav))
    assert got.dtype == torch.float32
    floor_check(f"log-mel {preset} bf16 DFT input", got.numpy(),
                np.asarray(jb), np.asarray(jf))
    plain = FL.fused_logmel_plain(torch.from_numpy(wav), front.basis,
                                  front.mel_fb, front.config, torch.bfloat16)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("preset", PRESETS)
def test_float32_is_the_default_and_unchanged(preset):
    cfg = getattr(TF, preset)
    wav = torch.from_numpy(_wave(cfg))
    default = TF.LogMelFrontend(cfg)
    assert default.compute_dtype == torch.float32
    got = TF.LogMelFrontend(cfg, compute_dtype=torch.float32)(wav)
    assert torch.equal(got, default(wav))
    assert torch.equal(got, FL.fused_logmel_plain(
        wav, default.basis, default.mel_fb, cfg))
    want = JF.LogMelFrontend(getattr(JF, preset), use_pallas=False)(
        jnp.asarray(wav.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3,
                               rtol=0)
