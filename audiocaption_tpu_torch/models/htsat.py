"""HTS-AT Swin-Transformer audio encoder (counterpart of
``audiocaption_tpu/models/htsat.py``).

32 kHz log-mel [B, T, 64] -> ``bn0`` over the mel bins -> the time axis
brought to ``spec_size * freq_ratio`` frames (1024: a cubic resize when
shorter, a crop when longer) -> the "wav2img" re-layout into a [B, 1,
256, 256] image (time cut into ``freq_ratio`` chunks stacked along
frequency) -> 4x4 patch embedding + LayerNorm -> Swin stages (window
attention with relative position bias, shifted windows on odd blocks,
patch merging between stages) -> LayerNorm -> the token grid's frequency
regrouped and averaged -> ``attn_emb`` [B, 32, 768] at the latent
resolution, ``attn_emb_len = feat_len // 32`` (at most 32), ``fc_emb``
the masked mean.  No dropout anywhere: ``train()`` changes only ``bn0``.

The time resize is JAX's ``jax.image.resize(..., "cubic")``: Keys' cubic
(a = -0.5) with the weights of each output frame renormalised over the
input frames it reaches.  ``torch.nn.functional.interpolate(mode=
"bicubic")`` uses a = -0.75 and clamps the border instead, so the weight
matrix is built in numpy (:func:`cubic_resize_matrix`) and applied as a
product.

Module names are the reference HTSAT_Swin_Transformer's checkpoint keys,
as the JAX ``convert_htsat`` reads them: ``bn0``, ``patch_embed.{proj,
norm}``, ``layers.{s}.blocks.{b}.{norm1, attn.{qkv, proj,
relative_position_bias_table}, norm2, mlp.{fc1, fc2}}``,
``layers.{s}.downsample.{reduction, norm}``, ``norm``.  LayerNorms use
eps 1e-5 (the JAX ``layers.LayerNorm``); GELU is exact.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiocaption_tpu_torch.models.layers import (
    batch_norm_mels, device_table)
from audiocaption_tpu_torch.ops.masking import mean_with_lens


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nW, w * w, C], windows batch-major, then by
    row and column."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, C)


def window_reverse(windows: torch.Tensor, w: int, H: int, W: int
                   ) -> torch.Tensor:
    B = windows.shape[0] // (H * W // w // w)
    x = windows.reshape(B, H // w, W // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, -1)


def relative_position_index(w: int) -> np.ndarray:
    """Swin relative position index [w*w, w*w] into the (2w-1)^2 table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w),
                                  indexing="ij"))          # [2, w, w]
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]              # [2, ww, ww]
    rel = rel.transpose(1, 2, 0) + (w - 1)
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)


def shift_mask(H: int, W: int, w: int, shift: int) -> np.ndarray:
    """Additive mask of the shifted windows [nW, w*w, w*w]: -100 between
    positions of different regions of the rolled image, else 0."""
    img = np.zeros((H, W))
    cnt = 0
    slices = (slice(0, -w), slice(-w, -shift), slice(-shift, None))
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    mw = (img.reshape(H // w, w, W // w, w).transpose(0, 2, 1, 3)
             .reshape(-1, w * w))
    mask = mw[:, None, :] - mw[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """The [n_in, n_out] weights of ``jax.image.resize(method="cubic")``
    along one axis (scale n_out / n_in, no translation, antialiasing,
    which widens the kernel only when shrinking): Keys' cubic kernel
    (a = -0.5) at each output sample's distance from every input sample,
    each column divided by its sum, a column zeroed where the sample
    falls outside the input."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kernel_scale = max(inv, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = np.where(x >= 2.0, 0.0, w)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """Swin window multi-head attention with a learned relative position
    bias (``relative_position_bias_table`` [(2w-1)^2, heads])."""

    def __init__(self, dim: int, window: int, num_heads: int):
        super().__init__()
        self.dim, self.window, self.num_heads = dim, window, num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        nn.init.normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(window)).long(), persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """x [nW * B, N, C]; mask [nW, N, N] additive or None."""
        Bn, N, C = x.shape
        H = self.num_heads
        dh = C // H
        qkv = self.qkv(x).reshape(Bn, N, 3, H, dh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                  # [Bn, H, N, dh]
        attn = (q @ k.transpose(-2, -1)) * (dh ** -0.5)
        bias = self.relative_position_bias_table[
            self.relative_position_index.reshape(-1)].reshape(N, N, H)
        attn = attn + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.reshape(Bn // nW, nW, H, N, N) + mask[None, :, None]
            attn = attn.reshape(Bn, H, N, N)
        attn = torch.softmax(attn, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(Bn, N, C)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """norm1 -> (rolled by -shift) window attention (rolled back) ->
    residual; norm2 -> MLP (exact GELU) -> residual."""

    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        H, W = hw
        B, N, C = x.shape
        s, w = self.shift, self.window
        h = self.norm1(x).reshape(B, H, W, C)
        mask = None
        if s > 0:
            h = torch.roll(h, (-s, -s), dims=(1, 2))
            mask = device_table(shift_mask, (H, W, w, s), x.device,
                                torch.float32)
        h = window_reverse(self.attn(window_partition(h, w), mask), w, H, W)
        if s > 0:
            h = torch.roll(h, (s, s), dims=(1, 2))
        x = x + h.reshape(B, N, C)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """2x2 neighbours concatenated ([0::2, 0::2], [1::2, 0::2], [0::2,
    1::2], [1::2, 1::2]) -> LayerNorm -> linear 4C -> 2C (no bias)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        H, W = hw
        B, N, C = x.shape
        x = x.reshape(B, H, W, C)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x.reshape(B, (H // 2) * (W // 2),
                                                  4 * C)))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(1, embed_dim, patch, stride=patch)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)


class SwinStage(nn.Module):
    def __init__(self, blocks: Sequence[SwinBlock],
                 downsample: Optional[PatchMerging]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class HtsatEncoder(nn.Module):
    """HTS-AT over a 32 kHz log-mel [B, T, 64] and its frame counts ->
    {fc_emb [B, C], attn_emb [B, 32, C], attn_emb_len}, C = embed_dim *
    2^(stages - 1) (768).  The defaults are the reference's HTS-AT base;
    ``spec_size`` (a multiple of 64) sets the image, ``freq_ratio =
    spec_size // 64`` and the frames taken, ``spec_size * freq_ratio``."""

    def __init__(self, spec_size: int = 256, patch_stride: int = 4,
                 embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32), window: int = 8,
                 mlp_ratio: float = 4.0, n_mels: int = 64):
        super().__init__()
        self.spec_size, self.patch_stride = spec_size, patch_stride
        self.freq_ratio = spec_size // 64
        self.bn0 = nn.BatchNorm2d(n_mels)
        self.patch_embed = PatchEmbed(patch_stride, embed_dim)
        H = W = spec_size // patch_stride
        dim = embed_dim
        stages = []
        for s, (depth, heads) in enumerate(zip(depths, num_heads)):
            # one window when the grid is no larger than the window: no
            # shift, the window clamped to the grid
            win = min(window, H, W)
            blocks = [SwinBlock(dim, heads, win,
                                0 if b % 2 == 0 or min(H, W) <= window
                                else win // 2, mlp_ratio)
                      for b in range(depth)]
            last = s == len(depths) - 1
            stages.append(SwinStage(blocks,
                                    None if last else PatchMerging(dim)))
            if not last:
                H, W, dim = H // 2, W // 2, dim * 2
        self.layers = nn.ModuleList(stages)
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fc_emb_size = self.attn_emb_size = dim
        self.downsample_ratio = 2 ** (len(depths) - 1) * patch_stride

    def wav2img(self, lms: torch.Tensor) -> torch.Tensor:
        """[B, T, 64] -> [B, 1, spec_size, spec_size]: T resized (cubic)
        or cut to spec_size * freq_ratio frames, then each of the
        freq_ratio time chunks stacked along frequency."""
        B, T, Fm = lms.shape
        target = self.spec_size * self.freq_ratio
        if T < target:
            m = device_table(cubic_resize_matrix, (T, target), lms.device,
                             lms.dtype)
            lms = torch.einsum("btf,ti->bif", lms, m)
        else:
            lms = lms[:, :target]
        fr = self.freq_ratio
        x = lms.transpose(1, 2).reshape(B, Fm, fr, target // fr)
        x = x.permute(0, 2, 1, 3).reshape(B, fr * Fm, target // fr)
        return x[:, None]

    def forward(self, lms: torch.Tensor, feat_len: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        x = batch_norm_mels(self.bn0, lms)[:, 0]             # [B, T, 64]
        x = self.patch_embed.proj(self.wav2img(x))         # [B, C, H, W]
        B, C, H, W = x.shape
        x = self.patch_embed.norm(x.permute(0, 2, 3, 1).reshape(B, H * W, C))
        for stage in self.layers:
            for blk in stage.blocks:
                x = blk(x, (H, W))
            if stage.downsample is not None:
                x = stage.downsample(x, (H, W))
                H, W = H // 2, W // 2
        x = self.norm(x)
        dim = x.shape[-1]
        # token grid [B, SF, ST, C] -> frequency regroup -> latent time
        SF = ST = self.spec_size // self.downsample_ratio
        cfb = SF // self.freq_ratio
        x = x.reshape(B, SF // cfb, cfb, ST, dim).transpose(1, 2)
        attn_emb = x.reshape(B, cfb, (SF // cfb) * ST, dim).mean(dim=1)
        out_len = torch.clamp(torch.div(feat_len, self.downsample_ratio,
                                        rounding_mode="floor"),
                              max=attn_emb.shape[1])
        fc_emb = mean_with_lens(attn_emb, torch.clamp(out_len, min=1))
        return {"fc_emb": fc_emb, "attn_emb": attn_emb,
                "attn_emb_len": out_len}
