"""ESResNeXt-FBSP audio encoder (counterpart of
``audiocaption_tpu/models/resnext.py``).

A ResNeXt-50 (32 groups, width 4) over a 3-band spectrogram image:

  waveform in the int16 value range --scale--> [-1, 1]
    --frames (the window applied, centred zero padding to n_fft)-->
    --LinearFBSP: a learned frequency B-spline filterbank, complex
      filters built from three parameters a bin (m, fb, fc)-->
    --power of 3 frequency bands, each bilinearly resized (align
      corners) to 224 x 224--> --10 log10--> [B, 3, 224, 224] dB image
    --ResNeXt-50 with Attention2d gates after each stage-->

:class:`ESResNeXtFBSPEncoder` turns the trunk's last feature map into the
captioning contract: averaged over frequency, ``attn_emb`` [B, 7, 2048]
(the image has a fixed width, so every clip fills all 7 steps),
``fc_emb`` their mean.  The frontend is the encoder's own: its captioner
takes the waveform (``input_mode="raw_wav"``).  ``stft_realimag``
(torch.stft's centred, reflect-padded, one-sided transform by a DFT
product) and ``fbsp_norm_loss`` (the filter-norm regulariser of the
reference's loss, wired into no training, as in the JAX package) are kept
beside it.

Module names are the reference checkpoint keys that the JAX
``convert_esresnext`` reads: ``conv1``, ``bn1``, ``layer{s}.{i}.{conv1,
bn1, conv2, bn2, conv3, bn3, downsample.0, downsample.1}``,
``att{1..5}.{conv_depth, conv_point, bn}``, ``fc``, ``fbsp.{m, fb,
fc}``.  BN is torch's default (momentum 0.1, eps 1e-5).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiocaption_tpu_torch.models.layers import device_table


def scale_value_range(x: torch.Tensor, old_min: float, old_max: float,
                      new_min: float, new_max: float) -> torch.Tensor:
    return new_min + (x - old_min) * (new_max - new_min) / (old_max - old_min)


def frame_signal(signal: torch.Tensor, frame_length: int, hop_length: int,
                 window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N, T] -> [N, frames, frame_length]: 1 frame when T <= frame_length,
    else 1 + ceil((T - frame_length) / hop), the signal zero-padded on both
    sides (the odd sample on the right) to fill them; times ``window``."""
    T = signal.shape[1]
    n = 1 if T <= frame_length else \
        1 + int(math.ceil((T - frame_length) / hop_length))
    extra = (n - 1) * hop_length + frame_length - T
    if extra > 0:
        signal = F.pad(signal, (extra // 2, extra - extra // 2))
    frames = signal.unfold(1, frame_length, hop_length)
    return frames if window is None else frames * window


def stft_realimag(x: torch.Tensor, n_fft: int, hop_length: int,
                  win_length: int, window: np.ndarray,
                  normalized: bool = False) -> torch.Tensor:
    """torch.stft(center=True, pad_mode="reflect", onesided) as framing and
    a DFT product: [N, T] -> [N, n_fft // 2 + 1, frames, 2]."""
    x = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    if win_length < n_fft:
        pad = n_fft - win_length
        window = np.pad(window, (pad // 2, pad - pad // 2))
    frames = x.unfold(1, n_fft, hop_length) * torch.as_tensor(
        window, dtype=x.dtype, device=x.device)
    ang = 2.0 * np.pi * np.outer(np.arange(n_fft), np.arange(n_fft // 2 + 1)
                                 ) / n_fft
    cos_b = torch.as_tensor(np.cos(ang), dtype=x.dtype, device=x.device)
    sin_b = torch.as_tensor(-np.sin(ang), dtype=x.dtype, device=x.device)
    re, im = frames @ cos_b, frames @ sin_b
    if normalized:
        re, im = re / math.sqrt(n_fft), im / math.sqrt(n_fft)
    return torch.stack([re, im], dim=-1).transpose(1, 2)


def _align_corners_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] linear-interpolation weights with aligned corners."""
    src = (np.zeros(n_out) if n_out == 1 or n_in == 1
           else np.arange(n_out) * (n_in - 1) / (n_out - 1))
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    w_hi = src - lo
    m = np.zeros((n_in, n_out), np.float32)
    m[lo, np.arange(n_out)] += 1.0 - w_hi
    m[hi, np.arange(n_out)] += w_hi
    return m


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int
                                  ) -> torch.Tensor:
    """``F.interpolate(mode="bilinear", align_corners=True)`` over the last
    two axes of [..., H, W], as two weight products (the JAX order)."""
    mh, mw = (device_table(_align_corners_matrix, (n, o), x.device, x.dtype)
              for n, o in ((x.shape[-2], out_h), (x.shape[-1], out_w)))
    x = torch.einsum("...hw,hi->...iw", x, mh)
    return torch.einsum("...iw,wj->...ij", x, mw)


def _linspace_pm1(n: int, device) -> torch.Tensor:
    """``jnp.linspace(-1, 1, n)`` in float32, bit for bit: -1 * (1 - s) +
    s for s = i / (n - 1), the last point 1."""
    s = torch.arange(n - 1, dtype=torch.float32, device=device) / (n - 1)
    return torch.cat([-(1 - s) + s, torch.ones(1, device=device)])


class LinearFBSP(nn.Module):
    """The learned frequency B-spline filterbank: ``out_features`` complex
    filters over a frame of L samples, filter k from its order ``m[k]``,
    bandwidth ``fb[k]`` and centre ``fc[k]``: sqrt(fb) sinc(fb t / m)^m
    e^(-i fc t) at t = pi * linspace(-1, 1, L) (+ eps), divided by
    sqrt(L) when ``normalized``."""

    def __init__(self, out_features: int, normalized: bool = False,
                 eps: float = 1e-8):
        super().__init__()
        self.normalized, self.eps = normalized, eps
        self.m = nn.Parameter(torch.zeros(out_features))
        self.fb = nn.Parameter(torch.ones(out_features))
        self.fc = nn.Parameter(torch.arange(out_features, dtype=torch.float32))

    @staticmethod
    def _complex_power(x_re, x_im, p_re):
        """x^p for complex x and real p, by magnitude and phase."""
        mag_out = (x_re ** 2 + x_im ** 2) ** (0.5 * p_re)
        ang = p_re * torch.atan2(x_im, x_re)
        return mag_out * torch.cos(ang), mag_out * torch.sin(ang)

    def materialize_weights(self, in_features: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (W_re, W_im), each [out_features, in_features]."""
        t = np.pi * _linspace_pm1(in_features, self.m.device)[None] + self.eps
        m, fb, fc = self.m[:, None], self.fb[:, None], self.fc[:, None]
        kern_re, kern_im = torch.cos(fc * t), -torch.sin(fc * t)
        z = fb * t / (m + self.eps)
        win = torch.where(z == 0, torch.ones_like(z), torch.sin(z) / z)
        win_re, win_im = self._complex_power(win, torch.zeros_like(win), m)
        scale = torch.sqrt(fb)
        w_re = scale * (win_re * kern_re - win_im * kern_im)
        w_im = scale * (win_re * kern_im + win_im * kern_re)
        if self.normalized:
            w_re = w_re / math.sqrt(in_features)
            w_im = w_im / math.sqrt(in_features)
        return w_re, w_im

    def forward(self, frames: torch.Tensor):
        """frames [N, Fr, L] -> (spec [N, Fr, out, 2], (W_re, W_im))."""
        w_re, w_im = self.materialize_weights(frames.shape[-1])
        spec = torch.stack([frames @ w_re.T, frames @ w_im.T], dim=-1)
        return spec, (w_re, w_im)


def fbsp_norm_loss(w_re: torch.Tensor, w_im: torch.Tensor, n_fft: int,
                   normalized: bool = False) -> torch.Tensor:
    """Mean squared gap between each filter's norm and its target (1, or
    sqrt(n_fft) unnormalised)."""
    norm = torch.sqrt(torch.sum(w_re ** 2 + w_im ** 2, dim=-1))
    target = 1.0 if normalized else math.sqrt(n_fft)
    return torch.mean((norm - target) ** 2)


def conv_bn(cin: int, cout: int, stride: int = 1) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride=stride, bias=False),
                         nn.BatchNorm2d(cout))


class Bottleneck(nn.Module):
    """torchvision's Bottleneck (expansion 4): 1x1 -> 3x3 (grouped,
    strided) -> 1x1, each with BN, ReLU between, the (downsampled) input
    added before the last ReLU."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 groups: int = 1, base_width: int = 64,
                 downsample: bool = False):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1,
                               groups=groups, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = (conv_bn(inplanes, planes * 4, stride)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Attention2d(nn.Module):
    """A gate: max pool to the gated map's size -> depthwise conv ->
    pointwise conv (both with bias) -> BN -> sigmoid."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int], padding: Tuple[int, int]):
        super().__init__()
        self.conv_depth = nn.Conv2d(in_channels, in_channels, kernel_size,
                                    padding=padding, groups=in_channels)
        self.conv_point = nn.Conv2d(in_channels, out_channels, 1)
        self.bn = nn.BatchNorm2d(out_channels)

    def forward(self, x: torch.Tensor, out_hw: Tuple[int, int]
                ) -> torch.Tensor:
        H, W = x.shape[2:]
        if H % out_hw[0] or W % out_hw[1]:
            raise ValueError(f"the gate pools {(H, W)} evenly only: not to "
                             f"{tuple(out_hw)}")
        k = (H // out_hw[0], W // out_hw[1])
        x = F.max_pool2d(x, k, k)
        return torch.sigmoid(self.bn(self.conv_point(self.conv_depth(x))))


_ATTENTION = {"att1": (64, 256, (3, 1), (1, 0)),
              "att2": (256, 512, (1, 5), (0, 2)),
              "att3": (512, 1024, (3, 1), (1, 0)),
              "att4": (1024, 2048, (1, 5), (0, 2)),
              "att5": (2048, 2048, (3, 5), (1, 2))}


class ESResNeXtFBSP(nn.Module):
    """The ESResNeXt-FBSP classifier: waveform in the int16 value range
    [B, T] -> logits [B, num_classes].  The defaults are the reference
    constructor's (n_fft 256, hop n_fft // 4, window length n_fft, boxcar,
    unnormalised); the public AudioSet checkpoints use n_fft 2048, hop 561,
    window 1654 blackmanharris, normalised, with attention.  ``layers``
    (the blocks of each stage) is the trunk's depth.  ``classifier``
    False leaves out what only the classifier uses (``att5`` and ``fc``):
    the captioning encoder has neither, as the JAX encoder has no
    variables for them."""

    def __init__(self, n_fft: int = 256, hop_length: Optional[int] = None,
                 win_length: Optional[int] = None, window: str = "boxcar",
                 normalized: bool = False, onesided: bool = True,
                 spec_height: int = 224, spec_width: int = 224,
                 num_classes: int = 1000, apply_attention: bool = False,
                 log10_eps: float = 1e-18,
                 layers: Sequence[int] = (3, 4, 6, 3),
                 classifier: bool = True):
        super().__init__()
        import scipy.signal as sps
        self.n_fft = n_fft
        self.hop = hop_length if hop_length is not None else n_fft // 4
        self.win_len = win_length if win_length is not None else n_fft
        self.spec_hw = (spec_height, spec_width)
        self.log10_eps = log10_eps
        self.apply_attention, self.classifier = apply_attention, classifier
        self.register_buffer("window", torch.from_numpy(sps.get_window(
            window, self.win_len, fftbins=True).astype(np.float32)),
            persistent=False)
        self.fbsp = LinearFBSP(n_fft // 2 + 1 if onesided else n_fft,
                               normalized)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for s, (planes, n, stride) in enumerate(
                zip((64, 128, 256, 512), layers, (1, 2, 2, 2)), 1):
            blocks = []
            for i in range(n):
                st = stride if i == 0 else 1
                blocks.append(Bottleneck(
                    inplanes, planes, st, groups=32, base_width=4,
                    downsample=i == 0 and (st != 1 or inplanes != planes * 4)))
                inplanes = planes * 4
            setattr(self, f"layer{s}", nn.ModuleList(blocks))
        if apply_attention:
            for name, args in _ATTENTION.items():
                if classifier or name != "att5":
                    setattr(self, name, Attention2d(*args))
        if classifier:
            self.fc = nn.Linear(2048, num_classes)

    def spectrogram(self, x: torch.Tensor):
        """The FBSP spectrogram: windowed frames zero-padded (centred) to
        n_fft -> (spec [N, F, Fr, 2], the filters)."""
        frames = frame_signal(x, self.win_len, self.hop, self.window)
        pad = self.n_fft - self.win_len
        if pad > 0:
            frames = F.pad(frames, (pad // 2, pad - pad // 2))
        spec, w = self.fbsp(frames)
        return spec.transpose(1, 2), w

    def db_image(self, wav: torch.Tensor):
        """Waveform (int16 range) -> ([B, 3, H, W] dB image, the filters)."""
        x = scale_value_range(wav, -32768.0, 32767.0, -1.0, 1.0)
        spec, w = self.spectrogram(x)                     # [B, F, Fr, 2]
        B, n_f = spec.shape[:2]
        F3 = n_f // 3 * 3
        spec = spec[:, :F3].reshape(B, 3, F3 // 3, spec.shape[2], 2)
        power = resize_bilinear_align_corners(
            spec[..., 0] ** 2 + spec[..., 1] ** 2, *self.spec_hw)
        power = torch.where(power > 0.0, power,
                            torch.full_like(power, self.log10_eps))
        return 10.0 * torch.log10(power), w

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The dB image [B, 3, H, W] -> the last stage's map [B, 2048, H /
        32, W / 32]."""
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, padding=1)
        for s in range(1, 5):
            x_in = x
            for blk in getattr(self, f"layer{s}"):
                x = blk(x)
            if self.apply_attention:
                x = x * getattr(self, f"att{s}")(x_in, x.shape[2:])
        return x

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        if not self.classifier:
            raise RuntimeError("built without the classifier (att5, fc)")
        x = self.features(self.db_image(wav)[0])
        pooled = x.mean(dim=(2, 3), keepdim=True)
        if self.apply_attention:
            pooled = pooled * self.att5(x, (1, 1))
        return self.fc(pooled[:, :, 0, 0])


class ESResNeXtFBSPEncoder(nn.Module):
    """An ESResNeXt-FBSP trunk as a captioning encoder over the waveform
    in [-1, 1] (times 32767 into the int16 range): the last feature map
    averaged over frequency -> {attn_emb [B, W / 32, 2048], fc_emb its
    mean, attn_emb_len W / 32 for every clip}."""

    def __init__(self, fbsp_model: ESResNeXtFBSP):
        super().__init__()
        self.fbsp_model = fbsp_model
        self.fc_emb_size = self.attn_emb_size = 2048

    def forward(self, wav: torch.Tensor, wav_len: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        m = self.fbsp_model
        img, _ = m.db_image(wav * 32767.0)
        attn_emb = m.features(img).mean(dim=2).transpose(1, 2)
        return {"fc_emb": attn_emb.mean(dim=1), "attn_emb": attn_emb,
                "attn_emb_len": torch.full(
                    (wav.shape[0],), attn_emb.shape[1], dtype=torch.long,
                    device=wav.device)}
