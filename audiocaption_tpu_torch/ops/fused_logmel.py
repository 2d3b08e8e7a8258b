"""Fused log-mel spectrogram: the CUDA kernel ``csrc/fused_logmel.cu`` and
its plain PyTorch version, the port's one plain log-mel.

Replaces the TPU kernel ``audiocaption_tpu/ops/pallas_logmel.py``
(``_logmel_kernel`` :44-77, wrapper ``pallas_logmel`` :80-147): framing of
the center reflect-padded wave, windowed real DFT, power, mel projection
and ``10 * log10(max(., 1e-10))`` in one launch, for any ``MelConfig``;
``top_db`` (EffB2 preset) is applied outside the kernel, as there.

Both functions take the tables a ``LogMelFrontend`` holds as buffers:
``basis`` [n_fft, 2 * n_freqs] (windowed cos | -sin columns) and
``mel_fb`` [n_freqs, n_mels].  ``fused_logmel`` launches the kernel for a
CUDA tensor and runs ``fused_logmel_plain`` (framing by ``unfold``, two
matmuls) only for a CPU tensor.  ``LogMelFrontend`` sends every CUDA
waveform of a 32 kHz preset to the wrapper and every other waveform to
the plain version.

Like the TPU kernel, this one computes the DFT as a dense product with the
basis: 2.1 GFLOP per 10 s clip at 32 kHz, about 80x what a real FFT needs.
The function itself is bound by its bytes (the wave in, the log-mel out):
~0.03 ms for 64 clips of 10 s on an H100 (``chip_smoke.py::logmel_work``
counts it).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from audiocaption_tpu_torch import cuda_build


def db_floor(db: torch.Tensor, top_db: Optional[float]) -> torch.Tensor:
    """Floor each sample at its own max - ``top_db``, the max taken over
    all non-batch axes (no floor for ``None``)."""
    if top_db is None:
        return db
    peak = db.reshape(db.shape[0], -1).amax(dim=1)
    return torch.maximum(db, (peak - top_db).reshape(
        (-1,) + (1,) * (db.ndim - 1)))


def amplitude_to_db(power: torch.Tensor, top_db: Optional[float] = None,
                    amin: float = 1e-10) -> torch.Tensor:
    """Power -> dB, then :func:`db_floor`."""
    return db_floor(10.0 * torch.log10(torch.clamp(power, min=amin)), top_db)


def _reflect_pad(wav: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(wav.float()[:, None, :], (pad, pad), mode="reflect")[:, 0]


def fused_logmel_plain(wav: torch.Tensor, basis: torch.Tensor,
                       mel_fb: torch.Tensor, config) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [B, T] -> log-mel
    [B, T // hop + 1, n_mels] float32 (``top_db`` applied per clip)."""
    n_freqs = mel_fb.shape[0]
    frames = _reflect_pad(wav, config.n_fft // 2).unfold(
        1, config.n_fft, config.hop)                 # [B, n_frames, n_fft]
    proj = torch.matmul(frames, basis)               # [B, n_frames, 2F]
    re, im = proj[..., :n_freqs], proj[..., n_freqs:]
    return amplitude_to_db(torch.matmul(re * re + im * im, mel_fb),
                           config.top_db)


_SIGNATURES = {
    "fused_logmel_smem_bytes": ([ctypes.c_int] * 3, ctypes.c_long),
    "fused_logmel_tile_frames": ([], ctypes.c_int),
    "fused_logmel_launch": (
        [ctypes.c_void_p] + [ctypes.c_int] * 5
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
           ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int),
}


def fused_logmel(wav: torch.Tensor, basis: torch.Tensor, mel_fb: torch.Tensor,
                 config) -> torch.Tensor:
    """[B, T] waveform -> log-mel [B, T // hop + 1, n_mels] float32.
    CUDA tensors launch ``csrc/fused_logmel.cu``; CPU tensors run
    :func:`fused_logmel_plain`."""
    if wav.ndim != 2:
        raise ValueError(f"wav must be [B, T], got {tuple(wav.shape)}")
    n_fft, hop = config.n_fft, config.hop
    if wav.shape[1] <= n_fft // 2:
        raise ValueError(f"{wav.shape[1]} samples is too short for the "
                         f"reflect padding of n_fft // 2 = {n_fft // 2}")
    if wav.device.type == "cpu":
        return fused_logmel_plain(wav, basis, mel_fb, config)
    if wav.device.type != "cuda":
        raise ValueError(f"unsupported device {wav.device}")
    n_freqs, n_mels = mel_fb.shape
    if basis.shape != (n_fft, 2 * n_freqs) or not all(
            t.device == wav.device and t.dtype == torch.float32
            and t.is_contiguous() for t in (basis, mel_fb)):
        raise ValueError("basis and mel_fb must be contiguous float32 tables "
                         "of this config on the wave's device")
    lib = cuda_build.load("fused_logmel", _SIGNATURES)
    if lib.fused_logmel_smem_bytes(n_fft, hop, n_freqs) == 0:
        raise ValueError("the log-mel kernel needs n_fft and hop multiples "
                         f"of 4 (got {n_fft}, {hop})")
    tile = lib.fused_logmel_tile_frames()
    B, T = wav.shape
    n_frames = T // hop + 1
    n_tiles = -(-n_frames // tile)
    x = _reflect_pad(wav, n_fft // 2)
    need = (n_tiles * tile - 1) * hop + n_fft      # the last tile's window
    x = F.pad(x, (0, max(0, need - x.shape[1]))).contiguous()
    out = torch.empty(B, n_frames, n_mels, dtype=torch.float32,
                      device=wav.device)
    err = lib.fused_logmel_launch(
        x.data_ptr(), x.shape[1], B, n_frames, n_fft, hop, basis.data_ptr(),
        n_freqs, mel_fb.data_ptr(), n_mels, out.data_ptr(),
        torch.cuda.current_stream(wav.device).cuda_stream)
    cuda_build.check(err, "fused_logmel")
    fused_logmel.launches += 1
    return db_floor(out, config.top_db)


fused_logmel.launches = 0
