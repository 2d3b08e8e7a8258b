"""Log-mel spectrogram frontend (counterpart of
``audiocaption_tpu/ops/frontend.py``).

Semantics match torchaudio's ``MelSpectrogram`` + ``AmplitudeToDB`` as
the reference encoders use them:

  * center=True with reflect padding of n_fft//2;
  * periodic Hann window, power=2.0 spectrogram;
  * mel filterbanks in "htk" or "slaney" scale, optional slaney norm;
  * 10*log10(clamp(x, 1e-10)) with an optional ``top_db`` floor taken
    per clip over all frames and mel bins (bucket padding included).

Two paths, chosen as the JAX package chooses between its conv-DFT path
and its Pallas kernel (``LogMelFrontend._resolve_pallas``): a CUDA
waveform of a 32 kHz preset goes through the hand-written kernel
(``ops/fused_logmel.py``); every other case, the 16 kHz presets on the
card and everything on the CPU, takes the kernel's plain version there
(``unfold`` framing, a matmul with the windowed cos / -sin basis, power,
the mel matmul).  Both read this module's tables.  All math is float32.
Frame count: ``feat_len = wav_len // hop + 1``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from audiocaption_tpu_torch.ops.fused_logmel import (
    fused_logmel, fused_logmel_plain)


def _hz_to_mel(freq, mel_scale: str) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    if mel_scale != "slaney":
        raise ValueError(f"unknown mel_scale: {mel_scale}")
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz)
                    / logstep,
                    mels)


def _mel_to_hz(mels, mel_scale: str) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    freqs)


def mel_filterbank(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                   sample_rate: int, norm: Optional[str] = None,
                   mel_scale: str = "htk") -> np.ndarray:
    """Triangular mel filterbank [n_freqs, n_mels], torchaudio-compatible."""
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel(f_min, mel_scale),
                        _hz_to_mel(f_max, mel_scale), n_mels + 2)
    f_pts = _mel_to_hz(m_pts, mel_scale)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down_slopes = -slopes[:, :-2] / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    if norm == "slaney":
        fb = fb * (2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels]))[None, :]
    elif norm is not None:
        raise ValueError(f"unknown mel norm: {norm}")
    return fb.astype(np.float32)


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window default)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * math.pi * n / win_length)).astype(
        np.float32)


def _dft_basis(n_fft: int, window: np.ndarray) -> np.ndarray:
    """Windowed real-DFT basis [n_fft, 2 * (n_fft // 2 + 1)] (cos | -sin)."""
    n_freqs = n_fft // 2 + 1
    t = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_freqs, dtype=np.float64)[None, :]
    angle = 2.0 * math.pi * t * k / n_fft
    basis = np.concatenate([np.cos(angle), -np.sin(angle)], axis=1)
    return (window[:, None] * basis).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """torchaudio-MelSpectrogram-compatible configuration."""
    sample_rate: int = 32000
    win_ms: int = 32
    hop_ms: int = 10
    n_mels: int = 64
    f_min: float = 50.0
    f_max: Optional[float] = 14000.0   # None -> sample_rate / 2
    norm: Optional[str] = "slaney"     # None | "slaney"
    mel_scale: str = "slaney"          # "htk" | "slaney"
    top_db: Optional[float] = None

    @property
    def n_fft(self) -> int:
        return self.win_ms * self.sample_rate // 1000

    @property
    def hop(self) -> int:
        return self.hop_ms * self.sample_rate // 1000

    @property
    def effective_f_max(self) -> float:
        return self.f_max if self.f_max is not None else self.sample_rate / 2.0

    def feat_len(self, wav_len: torch.Tensor) -> torch.Tensor:
        """Frame count for valid samples: wav_len // hop + 1."""
        return torch.div(wav_len, self.hop, rounding_mode="floor") + 1


CNN14_MEL_32K = MelConfig(sample_rate=32000, f_min=50.0, f_max=14000.0,
                          norm="slaney", mel_scale="slaney", top_db=None)
CNN14_MEL_16K = MelConfig(sample_rate=16000, f_min=50.0, f_max=8000.0,
                          norm="slaney", mel_scale="slaney", top_db=None)
# EfficientNet-B2: torchaudio defaults (htk scale, no norm, f_min 0,
# f_max sr/2) and AmplitudeToDB(top_db=120).
EFFB2_MEL_16K = MelConfig(sample_rate=16000, f_min=0.0, f_max=None,
                          norm=None, mel_scale="htk", top_db=120.0)


class LogMelFrontend(torch.nn.Module):
    """Waveform [B, T] -> log-mel [B, T // hop + 1, n_mels], float32:
    the fused kernel for a CUDA waveform of a 32 kHz preset, its plain
    version otherwise.  Buffers: ``basis`` [n_fft, 2 * n_freqs] and
    ``mel_fb`` [n_freqs, n_mels]."""

    def __init__(self, config: MelConfig):
        super().__init__()
        self.config = config
        self.register_buffer(
            "basis", torch.from_numpy(
                _dft_basis(config.n_fft, hann_window(config.n_fft))),
            persistent=False)
        self.register_buffer(
            "mel_fb", torch.from_numpy(mel_filterbank(
                n_freqs=config.n_fft // 2 + 1, f_min=config.f_min,
                f_max=config.effective_f_max, n_mels=config.n_mels,
                sample_rate=config.sample_rate, norm=config.norm,
                mel_scale=config.mel_scale)),
            persistent=False)

    def uses_kernel(self, wav: torch.Tensor) -> bool:
        return wav.device.type == "cuda" and self.config.sample_rate == 32000

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        if self.uses_kernel(wav):
            return fused_logmel(wav, self.basis, self.mel_fb, self.config)
        return fused_logmel_plain(wav, self.basis, self.mel_fb, self.config)
