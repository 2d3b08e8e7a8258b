"""Fused log-mel spectrogram: the CUDA kernel ``csrc/fused_logmel.cu`` and
its plain PyTorch version, the port's one plain log-mel.

Replaces the TPU kernel ``audiocaption_tpu/ops/pallas_logmel.py``
(``_logmel_kernel`` :44-77, wrapper ``pallas_logmel`` :80-147): framing of
the center reflect-padded wave, windowed real DFT, power, mel projection
and ``10 * log10(max(., 1e-10))`` in one launch, for any ``MelConfig``
whose ``n_fft`` is a power of two from 256 to 2048; ``top_db`` (EffB2
preset) is applied outside the kernel, as there.

Both functions take the tables a ``LogMelFrontend`` holds as buffers:
``basis`` [n_fft, 2 * n_freqs] (windowed cos | -sin columns, read by the
plain version only) and ``mel_fb`` [n_freqs, n_mels].  ``fused_logmel``
launches the kernel for a CUDA tensor and runs ``fused_logmel_plain``
(framing by ``unfold``, two matmuls) only for a CPU tensor.
``LogMelFrontend`` sends every CUDA waveform of a 32 kHz preset to the
wrapper and every other waveform to the plain version.  The plain
version's ``compute_dtype`` (item 9 of the JAX frontend,
``audiocaption_tpu/ops/frontend.py:200-217, 253-266``) rounds the frames
and the basis to that type and sums their products in float32; the
kernel has no such option, as the TPU kernel has none.

The kernel computes an FFT of each frame in shared memory (the real frame
packed as n_fft / 2 complex values, Stockham stages of radix 8 as far as
they go, ``fft_radices``, the real split) and a banded mel product, all
in float64 from the float32 wave to the float32 dB value (see the source's
header for why).  Its host side lives here and is tested
on the CPU: ``logmel_tables`` (twiddles, real-split twiddles, window, one
contiguous band of packed weights per mel), ``reflect_index`` (the
kernel's in-place reflect padding) and ``fft_twin``, the kernel's
algorithm in PyTorch.  In float64 the kernel is bound by its operations:
~0.056 ms for 64 clips of 10 s on an H100, where its bytes (the wave in,
the log-mel out) take ~0.029 ms (``chip_smoke.py::logmel_work``).
"""

from __future__ import annotations

import ctypes
import math
import weakref
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
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
                       mel_fb: torch.Tensor, config,
                       compute_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [B, T] -> log-mel
    [B, T // hop + 1, n_mels] float32 (``top_db`` applied per clip).
    ``compute_dtype`` rounds the wave (before its reflect padding) and
    the basis to that type; their products are summed in float32, as the
    JAX frontend's DFT with ``preferred_element_type=jnp.float32``.  The
    power, the mel product and the dB stay float32."""
    n_freqs = mel_fb.shape[0]
    frames = _reflect_pad(wav.to(compute_dtype), config.n_fft // 2).unfold(
        1, config.n_fft, config.hop)                 # [B, n_frames, n_fft]
    proj = torch.matmul(frames, basis.to(compute_dtype).float())
    # proj: [B, n_frames, 2F]
    re, im = proj[..., :n_freqs], proj[..., n_freqs:]
    return amplitude_to_db(torch.matmul(re * re + im * im, mel_fb),
                           config.top_db)


def reflect_index(pos: torch.Tensor, T: int, pad: int) -> torch.Tensor:
    """The kernel's reflect rule: the index into an unpadded wave of T
    samples of position ``pos`` of the wave reflect-padded by ``pad`` on
    each side (``F.pad(..., mode="reflect")``), and -1 past the padded end
    (read as zero: a ragged last tile).  Needs T > pad."""
    s = pos - pad
    s = torch.where(s < 0, -s, s)
    s = torch.where(s >= T, 2 * (T - 1) - s, s)
    return torch.where(pos < T + 2 * pad, s, torch.full_like(s, -1))


class LogmelTables(NamedTuple):
    """What the kernel reads besides the wave, for one n_fft and mel_fb."""
    tw: torch.Tensor        # [M, 2] float64, exp(-2 pi i t / M), M = n_fft / 2
    split: torch.Tensor     # [M + 1, 2] float64, exp(-2 pi i k / n_fft)
    window: torch.Tensor    # [n_fft] float64, periodic Hann
    bands: torch.Tensor     # [3, n_mels] int32: band start, length, offset
    band_w: torch.Tensor    # [sum of lengths] float32, packed filter weights
    k_min: int              # bins [k_min, k_max) carry mel weight
    k_max: int


def _unit_roots(count: int, period: int) -> torch.Tensor:
    angle = -2.0 * math.pi * np.arange(count, dtype=np.float64) / period
    return torch.from_numpy(np.stack([np.cos(angle), np.sin(angle)], 1))


def logmel_tables(mel_fb: torch.Tensor, n_fft: int) -> LogmelTables:
    """The kernel's tables, on the CPU: twiddles and the window in
    float64, and one contiguous band [lo, lo + len) of ``mel_fb``'s column
    per mel from its first to its last nonzero weight, packed in mel
    order (an all-zero column has length 0)."""
    M = n_fft // 2
    fb = mel_fb.detach().cpu().float().numpy()
    n_mels = fb.shape[1]
    lo = np.zeros(n_mels, np.int64)
    length = np.zeros(n_mels, np.int64)
    weights = []
    for m in range(n_mels):
        nz = np.flatnonzero(fb[:, m])
        if len(nz):
            lo[m], length[m] = nz[0], nz[-1] + 1 - nz[0]
            weights.append(fb[lo[m]:lo[m] + length[m], m])
    used = length > 0
    k_min = int(lo[used].min()) if used.any() else 0
    k_max = int((lo + length)[used].max()) if used.any() else 0
    lo[~used] = k_min
    offset = np.concatenate([[0], np.cumsum(length)[:-1]])
    band_w = (np.concatenate(weights) if weights
              else np.zeros(0, np.float32)).astype(np.float32)
    n = np.arange(n_fft, dtype=np.float64)
    window = 0.5 - 0.5 * np.cos(2.0 * math.pi * n / n_fft)
    return LogmelTables(
        _unit_roots(M, M), _unit_roots(M + 1, n_fft),
        torch.from_numpy(window),
        torch.from_numpy(np.stack([lo, length, offset]).astype(np.int32)),
        torch.from_numpy(band_w), k_min, k_max)


def _cmul(a, b):
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def fft_radices(M: int) -> list:
    """The kernel's stage plan for an M-point complex FFT: radix 8 (radix
    4 when M < 256, so that every lane has a butterfly) as long as it
    divides what is left, then one stage for the rest (2 or 4)."""
    r0 = 8 if M >= 256 else 4
    radices, n = [], 1
    while n * r0 <= M:
        radices.append(r0)
        n *= r0
    if n < M:
        radices.append(M // n)
    return radices


def _dft4(x):
    a0 = (x[0][0] + x[2][0], x[0][1] + x[2][1])
    a1 = (x[0][0] - x[2][0], x[0][1] - x[2][1])
    a2 = (x[1][0] + x[3][0], x[1][1] + x[3][1])
    a3 = (x[1][1] - x[3][1], -(x[1][0] - x[3][0]))      # -i (x1 - x3)
    return [(a0[0] + a2[0], a0[1] + a2[1]), (a1[0] + a3[0], a1[1] + a3[1]),
            (a0[0] - a2[0], a0[1] - a2[1]), (a1[0] - a3[0], a1[1] - a3[1])]


def _stockham_stage(z, Ns: int, R: int, tw: torch.Tensor):
    """One radix-R Stockham stage on (re, im) [..., M], as the kernel's
    ``stage``: butterfly j reads j + r M / R, twiddles its input r by
    W_M^(r (j mod Ns) M / (Ns R)), writes (j - j mod Ns) R + j mod Ns + r Ns.
    Radix 8 splits into sums and W_8-twiddled differences of inputs r and
    r + 4, then a 4-point DFT of each (outputs 2m and 2m + 1)."""
    M = z[0].shape[-1]
    j = torch.arange(M // R)
    jm = j & (Ns - 1)
    v = [(z[0][..., j + r * (M // R)], z[1][..., j + r * (M // R)])
         for r in range(R)]
    if Ns > 1:
        for r in range(1, R):
            t = jm * r * (M // (Ns * R))
            v[r] = _cmul(v[r], (tw[t, 0], tw[t, 1]))
    if R == 8:
        h = 0.70710678118654752
        a = [(v[r][0] + v[r + 4][0], v[r][1] + v[r + 4][1]) for r in range(4)]
        c = [(v[r][0] - v[r + 4][0], v[r][1] - v[r + 4][1]) for r in range(4)]
        c[1] = (h * (c[1][0] + c[1][1]), h * (c[1][1] - c[1][0]))
        c[2] = (c[2][1], -c[2][0])
        c[3] = (h * (c[3][1] - c[3][0]), -h * (c[3][0] + c[3][1]))
        y = [p for pair in zip(_dft4(a), _dft4(c)) for p in pair]
    elif R == 4:
        y = _dft4(v)
    else:
        y = [(v[0][0] + v[1][0], v[0][1] + v[1][1]),
             (v[0][0] - v[1][0], v[0][1] - v[1][1])]
    dst = (j - jm) * R + jm
    out = (torch.empty_like(z[0]), torch.empty_like(z[1]))
    for r in range(R):
        out[0][..., dst + r * Ns] = y[r][0]
        out[1][..., dst + r * Ns] = y[r][1]
    return out


def fft_twin(wav: torch.Tensor, mel_fb: torch.Tensor, config) -> torch.Tensor:
    """The kernel's algorithm in PyTorch, float64 as the kernel's (for
    the CPU tests): the reflect rule, the packed frame, the same Stockham
    stages (``fft_radices``) and tables, the real split over [k_min,
    k_max), the banded mel product, dB rounded to float32, and
    ``top_db``.  [B, T] -> [B, T // hop + 1, n_mels] float32."""
    n_fft, hop = config.n_fft, config.hop
    M = n_fft // 2
    t = logmel_tables(mel_fb, n_fft)
    B, T = wav.shape
    n_frames = T // hop + 1
    pos = torch.arange(n_frames)[:, None] * hop + torch.arange(n_fft)[None]
    idx = reflect_index(pos, T, M)
    x = wav.float().double()[:, idx.clamp(min=0)] * (idx >= 0)
    z = (x[..., 0::2] * t.window[0::2], x[..., 1::2] * t.window[1::2])
    Ns = 1
    for R in fft_radices(M):
        z = _stockham_stage(z, Ns, R, t.tw)
        Ns *= R
    k = torch.arange(t.k_min, t.k_max)
    a = (z[0][..., k % M], z[1][..., k % M])
    c = (z[0][..., (M - k) % M], z[1][..., (M - k) % M])
    xe = (0.5 * (a[0] + c[0]), 0.5 * (a[1] - c[1]))
    xo = (0.5 * (a[1] + c[1]), -(0.5 * (a[0] - c[0])))     # -i (a - conj c) / 2
    wx = _cmul((t.split[k, 0], t.split[k, 1]), xo)
    power = (xe[0] + wx[0]) ** 2 + (xe[1] + wx[1]) ** 2     # [B, F, k_max - k_min]
    mel = torch.stack([power[..., lo - t.k_min:lo - t.k_min + n]
                       @ t.band_w[off:off + n].double()
                       for lo, n, off in t.bands.t().tolist()], -1)
    db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    return db_floor(db.float(), config.top_db)


_SIGNATURES = {
    "fused_logmel_smem_bytes": ([ctypes.c_int] * 2, ctypes.c_long),
    "fused_logmel_launch": (
        [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2, ctypes.c_int),
}

# (id(mel_fb), n_fft) -> (weak reference to mel_fb, its version, tables)
_TABLES: Dict[Tuple[int, int], Tuple[weakref.ref, int, LogmelTables]] = {}


def _device_tables(mel_fb: torch.Tensor, n_fft: int) -> LogmelTables:
    """``logmel_tables`` on ``mel_fb``'s device, built once per table
    tensor and n_fft, and again after ``mel_fb`` is changed in place; an
    entry goes when its tensor does."""
    key = (id(mel_fb), n_fft)
    hit = _TABLES.get(key)
    if hit is None or hit[0]() is not mel_fb or hit[1] != mel_fb._version:
        t = logmel_tables(mel_fb, n_fft)
        t = t._replace(**{f: getattr(t, f).to(mel_fb.device).contiguous()
                          for f in ("tw", "split", "window", "bands",
                                    "band_w")})
        if hit is None or hit[0]() is not mel_fb:
            weakref.finalize(mel_fb, _TABLES.pop, key, None)
        hit = (weakref.ref(mel_fb), mel_fb._version, t)
        _TABLES[key] = hit
    return hit[2]


def fused_logmel(wav: torch.Tensor, basis: torch.Tensor, mel_fb: torch.Tensor,
                 config) -> torch.Tensor:
    """[B, T] waveform -> log-mel [B, T // hop + 1, n_mels] float32.
    CUDA tensors launch ``csrc/fused_logmel.cu`` (which reads ``mel_fb``'s
    bands, not ``basis``); CPU tensors run :func:`fused_logmel_plain`."""
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
    if n_fft not in (256, 512, 1024, 2048):
        raise ValueError("the log-mel kernel takes a power-of-two n_fft from "
                         f"256 to 2048, got {n_fft}")
    n_freqs, n_mels = mel_fb.shape
    if n_freqs != n_fft // 2 + 1 or mel_fb.device != wav.device:
        raise ValueError("mel_fb must be [n_fft // 2 + 1, n_mels] on the "
                         "wave's device")
    lib = cuda_build.load("fused_logmel", _SIGNATURES)
    if lib.fused_logmel_smem_bytes(n_fft, hop) > 232448:
        raise ValueError(f"hop {hop} needs more shared memory than a block has")
    t = _device_tables(mel_fb, n_fft)
    x = wav.float().contiguous()
    B, T = x.shape
    n_frames = T // hop + 1
    out = torch.empty(B, n_frames, n_mels, dtype=torch.float32,
                      device=wav.device)
    err = lib.fused_logmel_launch(
        x.data_ptr(), B, T, n_frames, n_fft, hop, t.tw.data_ptr(),
        t.split.data_ptr(), t.window.data_ptr(), t.bands.data_ptr(),
        t.band_w.data_ptr(), t.k_min, t.k_max, n_mels, out.data_ptr(),
        torch.cuda.current_stream(wav.device).cuda_stream)
    cuda_build.check(err, "fused_logmel")
    fused_logmel.launches += 1
    return db_floor(out, config.top_db)


fused_logmel.launches = 0
