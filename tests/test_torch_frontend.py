"""Log-mel frontend and masking of the PyTorch port against the JAX
package, on the same numpy inputs.  Tolerance: log-mel within 2e-3 dB
(float32 DFT sums in another order: unfold + matmul against the JAX
convolution); filterbank tables exact
(both are the same float64 numpy arithmetic)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiocaption_tpu.ops import frontend as JF
from audiocaption_tpu.ops import masking as JM
from audiocaption_tpu_torch.ops import frontend as TF
from audiocaption_tpu_torch.ops import masking as TM

torch.set_num_threads(1)

PRESETS = ["EFFB2_MEL_16K", "CNN14_MEL_16K", "CNN14_MEL_32K"]


@pytest.mark.parametrize("preset", PRESETS)
def test_tables_equal_jax(preset):
    cfg = getattr(JF, preset)
    tcfg = getattr(TF, preset)
    assert dataclass_fields(cfg) == dataclass_fields(tcfg)
    assert (tcfg.n_fft, tcfg.hop) == (cfg.n_fft, cfg.hop)
    np.testing.assert_array_equal(TF.hann_window(cfg.n_fft),
                                  JF.hann_window(cfg.n_fft))
    np.testing.assert_array_equal(
        TF._dft_basis(cfg.n_fft, TF.hann_window(cfg.n_fft)),
        JF._dft_basis(cfg.n_fft, JF.hann_window(cfg.n_fft)))
    args = dict(n_freqs=cfg.n_fft // 2 + 1, f_min=cfg.f_min,
                f_max=cfg.effective_f_max, n_mels=cfg.n_mels,
                sample_rate=cfg.sample_rate, norm=cfg.norm,
                mel_scale=cfg.mel_scale)
    np.testing.assert_array_equal(TF.mel_filterbank(**args),
                                  JF.mel_filterbank(**args))


def dataclass_fields(cfg):
    import dataclasses
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("preset", PRESETS)
def test_logmel_matches_jax(preset):
    cfg = getattr(JF, preset)
    rng = np.random.RandomState(0)
    n = int(1.5 * cfg.sample_rate)
    wav = (rng.randn(2, n) * 0.1).astype(np.float32)
    wav[1, n // 2:] = 0.0      # bucket padding: the top_db floor is per clip
    want = np.asarray(JF.LogMelFrontend(cfg, use_pallas=False)(
        jnp.asarray(wav)))
    got = TF.LogMelFrontend(getattr(TF, preset))(torch.from_numpy(wav))
    assert got.shape == want.shape == (2, n // cfg.hop + 1, cfg.n_mels)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=0)


def test_top_db_floor_is_per_clip():
    wav = torch.zeros(2, 16000)
    wav[0] = torch.sin(torch.arange(16000) * 0.3)
    wav[1] = 1e-3 * torch.sin(torch.arange(16000) * 0.3)
    lms = TF.LogMelFrontend(TF.EFFB2_MEL_16K)(wav)
    for b in range(2):
        assert lms[b].max() - lms[b].min() <= 120.0 + 1e-3


def test_feat_len_matches_jax():
    lens = np.asarray([0, 159, 160, 16000, 15999], np.int64)
    got = TF.EFFB2_MEL_16K.feat_len(torch.from_numpy(lens))
    want = np.asarray(JF.EFFB2_MEL_16K.feat_len(jnp.asarray(lens)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_masking_matches_jax():
    rng = np.random.RandomState(1)
    feats = rng.randn(3, 7, 5).astype(np.float32)
    lens = np.asarray([7, 3, 1])
    np.testing.assert_array_equal(
        TM.length_mask(torch.from_numpy(lens), 7).numpy(),
        np.asarray(JM.length_mask(jnp.asarray(lens), 7)))
    np.testing.assert_allclose(
        TM.mean_with_lens(torch.from_numpy(feats), torch.from_numpy(lens))
        .numpy(),
        np.asarray(JM.mean_with_lens(jnp.asarray(feats), jnp.asarray(lens))),
        rtol=1e-6, atol=1e-7)
