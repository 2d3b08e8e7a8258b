"""The host side of the FFT log-mel kernel (``ops/fused_logmel.py``), on
the CPU: its tables, its reflect rule, and ``fft_twin``, the kernel's
algorithm in PyTorch, against the plain version.

``fused_logmel_plain`` is itself held against the JAX Pallas kernel in
``tests/test_torch_logmel.py``.  Tolerances: the bands reproduce the
dense mel product to float64 rounding (1e-12 relative); the Stockham
stages compute the DFT to float64 rounding; the twin agrees with the
plain version within 1e-3 dB, the kernel's own limit on the card (the
twin, as the kernel, computes in float64, the plain version's dense basis
product in float32), and on quiet mel bands it stays within 1e-5 dB of a
float64 log-mel where the plain version does not.  This file imports
torch only, so it also runs where JAX is absent."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audiocaption_tpu_torch.ops import frontend as TF
from audiocaption_tpu_torch.ops import fused_logmel as FL

torch.set_num_threads(1)
PRESETS = ["CNN14_MEL_32K", "CNN14_MEL_16K", "EFFB2_MEL_16K"]


@pytest.mark.parametrize("preset", PRESETS)
def test_bands_reproduce_the_mel_product(preset):
    front = TF.LogMelFrontend(getattr(TF, preset))
    fb = front.mel_fb
    t = FL.logmel_tables(fb, front.config.n_fft)
    rebuilt = torch.zeros_like(fb)
    for m, (lo, n, off) in enumerate(t.bands.t().tolist()):
        rebuilt[lo:lo + n, m] = t.band_w[off:off + n]
        assert n > 0 and t.k_min <= lo and lo + n <= t.k_max
    assert torch.equal(rebuilt, fb)              # nothing outside a band
    assert not fb[:t.k_min].any() and not fb[t.k_max:].any()
    power = torch.rand(7, fb.shape[0], dtype=torch.float64,
                       generator=torch.Generator().manual_seed(0))
    banded = torch.stack([
        power[:, lo:lo + n] @ t.band_w[off:off + n].double()
        for lo, n, off in t.bands.t().tolist()], -1)
    np.testing.assert_allclose(banded.numpy(), (power @ fb.double()).numpy(),
                               rtol=1e-12, atol=0)


def test_bins_with_mel_weight_at_32k():
    """446 bins carry weight at 32 kHz (``chip_smoke.py::logmel_work``)."""
    t = FL.logmel_tables(TF.LogMelFrontend(TF.CNN14_MEL_32K).mel_fb, 1024)
    assert (t.k_min, t.k_max) == (2, 448)


def test_an_empty_filter_gets_an_empty_band():
    fb = torch.zeros(129, 3)
    fb[10:14, 0] = 1.0
    fb[20:23, 2] = 0.5
    t = FL.logmel_tables(fb, 256)
    assert t.bands[1].tolist() == [4, 0, 3] and (t.k_min, t.k_max) == (10, 23)


@pytest.mark.parametrize("T,pad", [(700, 128), (1001, 512), (513, 512),
                                   (2053, 256)])
def test_reflect_rule_matches_f_pad(T, pad):
    wav = torch.randn(2, T, generator=torch.Generator().manual_seed(T))
    want = F.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
    pos = torch.arange(T + 2 * pad + 37)             # past the end: a ragged tile
    idx = FL.reflect_index(pos, T, pad)
    assert bool((idx[T + 2 * pad:] == -1).all())
    assert int(idx[:T + 2 * pad].min()) >= 0 and int(idx.max()) < T
    torch.testing.assert_close(wav[:, idx[:T + 2 * pad]], want, rtol=0,
                               atol=0)


@pytest.mark.parametrize("M,radices", [
    (128, [4, 4, 4, 2]), (256, [8, 8, 4]), (512, [8, 8, 8]),
    (1024, [8, 8, 8, 2])])
def test_stockham_stages_compute_the_dft(M, radices):
    """The kernel's stage plan (radix 8, radix 4 below 256 points, then
    the rest), in natural order: the DFT, in float64."""
    assert FL.fft_radices(M) == radices and math.prod(radices) == M
    gen = torch.Generator().manual_seed(M)
    x = torch.complex(torch.randn(3, M, dtype=torch.float64, generator=gen),
                      torch.randn(3, M, dtype=torch.float64, generator=gen))
    angle = -2.0 * math.pi * torch.arange(M, dtype=torch.float64) / M
    tw = torch.stack([angle.cos(), angle.sin()], 1)
    z, Ns = (x.real, x.imag), 1
    for R in radices:
        z, Ns = FL._stockham_stage(z, Ns, R, tw), Ns * R
    want = torch.fft.fft(x)
    got = torch.complex(*z)
    assert float((got - want).abs().max()) <= 1e-10 * float(want.abs().max())


def test_tables_are_unit_roots_and_the_window():
    t = FL.logmel_tables(TF.LogMelFrontend(TF.CNN14_MEL_32K).mel_fb, 1024)
    k = torch.arange(513, dtype=torch.float64)
    want = torch.exp(-2j * math.pi * k / 1024)
    np.testing.assert_allclose(t.split[:, 0].double(), want.real, atol=1e-7)
    np.testing.assert_allclose(t.split[:, 1].double(), want.imag, atol=1e-7)
    assert t.tw.shape == (512, 2)
    np.testing.assert_allclose(t.tw[:257].double(), t.split[0::2].double(),
                               atol=1e-7)
    assert t.tw.dtype == t.split.dtype == t.window.dtype == torch.float64
    n = np.arange(1024, dtype=np.float64)
    np.testing.assert_array_equal(t.window.numpy(),
                                  0.5 - 0.5 * np.cos(2.0 * math.pi * n / 1024))
    np.testing.assert_array_equal(t.window.float().numpy(),
                                  TF.hann_window(1024))


@pytest.mark.parametrize("preset,seconds", [
    ("CNN14_MEL_32K", 1.0), ("CNN14_MEL_32K", 2.3), ("EFFB2_MEL_16K", 1.7),
    ("CNN14_MEL_16K", 0.61)],
    ids=["32k_1s", "32k_ragged_tile", "16k_top_db", "16k_short"])
def test_twin_matches_plain(preset, seconds):
    """A ragged last tile (n_frames not a multiple of 16) and a half-silent
    clip (the 1e-10 floor; top_db at 16 kHz)."""
    cfg = getattr(TF, preset)
    front = TF.LogMelFrontend(cfg)
    rng = np.random.RandomState(3)
    wav = torch.from_numpy(
        (rng.randn(3, int(seconds * cfg.sample_rate)) * 0.1).astype(np.float32))
    wav[2, wav.shape[1] // 2:] = 0.0
    got = FL.fft_twin(wav, front.mel_fb, cfg)
    want = FL.fused_logmel_plain(wav, front.basis, front.mel_fb, cfg)
    assert got.shape == want.shape == (3, wav.shape[1] // cfg.hop + 1,
                                       cfg.n_mels)
    assert float((got - want).abs().max()) <= 1e-3


def test_device_tables_are_built_once_per_table():
    """The wrapper's table cache: one build per mel_fb tensor and n_fft,
    a rebuild after an in-place change, and nothing kept past the tensor."""
    fb = TF.LogMelFrontend(TF.CNN14_MEL_32K).mel_fb.clone()
    first = FL._device_tables(fb, 1024)
    assert FL._device_tables(fb, 1024) is first
    assert FL._device_tables(fb.clone(), 1024) is not first
    fb[5, 0] += 1.0
    again = FL._device_tables(fb, 1024)
    assert again is not first and FL._device_tables(fb, 1024) is again
    key = (id(fb), 1024)
    del fb
    assert key not in FL._TABLES


def _float64_logmel(wav, front):
    """The log-mel in float64 (``torch.fft.rfft`` of the reflect-padded,
    windowed frames), as ``chip_smoke.py::float64_logmel``."""
    cfg = front.config
    frames = F.pad(wav.double()[:, None], (cfg.n_fft // 2,) * 2,
                   mode="reflect")[:, 0].unfold(1, cfg.n_fft, cfg.hop)
    frames = frames * torch.hann_window(cfg.n_fft, dtype=torch.float64)
    power = torch.fft.rfft(frames, dim=-1).abs() ** 2
    return FL.amplitude_to_db(power @ front.mel_fb.double(), cfg.top_db)


@pytest.mark.parametrize("noise", [1e-3, 1e-4])
def test_twin_holds_quiet_bands_to_float64(noise):
    """ROADMAP Queue 3 M's mechanism: a mel band far below its frame (here
    a loud 5 kHz tone over noise 54 or 74 dB down) carries the FFT's
    rounding, ~eps * |frame| a bin, which a float32 FFT turns into 1e-3
    dB and more (the float32 plain version: 9e-4 and 8.5e-3 dB from the
    float64 log-mel).  The kernel's algorithm, in float64 as the kernel
    computes since, stays within 1e-5 dB of it (measured 2.7e-6 and
    3.8e-6), far nearer than the plain version."""
    front = TF.LogMelFrontend(TF.CNN14_MEL_32K)
    rng = np.random.RandomState(0)
    t = np.arange(2 * 32000) / 32000
    wav = torch.from_numpy((0.5 * np.sin(2 * np.pi * 5000 * t)
                            + noise * rng.randn(len(t))).astype(np.float32))
    ref = _float64_logmel(wav[None], front)
    twin = FL.fft_twin(wav[None], front.mel_fb, front.config).double()
    plain = FL.fused_logmel_plain(wav[None], front.basis, front.mel_fb,
                                  front.config).double()
    assert float((twin - ref).abs().max()) <= 1e-5
    assert float((plain - ref).abs().max()) >= 50 * float(
        (twin - ref).abs().max())
