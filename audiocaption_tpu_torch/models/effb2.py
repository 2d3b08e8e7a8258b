"""EfficientNet-B2 audio encoder, inference only (counterpart of
``audiocaption_tpu/models/effb2.py``).

Spectrograms enter as one-channel images with mel bins on H and time on
W ('b t f -> b 1 f t').  The backbone is EfficientNet (width 1.1,
depth 1.2, head 1408, swish, SE 0.25) with static TF-SAME padding
computed from the nominal 260x260 image, tracked block by block, not
from the input size: efficientnet_pytorch bakes its padding that way.

Module names follow efficientnet_pytorch (``_conv_stem``, ``_bn0``,
``_blocks.{i}._expand_conv`` ...), so the encoder part of a reference
checkpoint loads with a plain ``load_state_dict``.

Output: {fc_emb [B, 1408], attn_emb [B, T // 32, 1408], attn_emb_len [B]}
with ``attn_emb`` the mean over the frequency axis and ``fc_emb`` the
length-masked mean of ``attn_emb``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from audiocaption_tpu_torch.models.layers import Conv2dSame
from audiocaption_tpu_torch.ops.masking import mean_with_lens

# EfficientNet-B0 block args: (repeats, kernel, stride, expand, in, out)
_B0_BLOCKS = [
    (1, 3, 1, 1, 32, 16),
    (2, 3, 2, 6, 16, 24),
    (2, 5, 2, 6, 24, 40),
    (3, 3, 2, 6, 40, 80),
    (3, 5, 1, 6, 80, 112),
    (4, 5, 2, 6, 112, 192),
    (1, 3, 1, 6, 192, 320),
]
_SE_RATIO = 0.25
_BN_EPS = 1e-3


def round_filters(filters: float, width: float, divisor: int = 8) -> int:
    """efficientnet_pytorch round_filters."""
    filters *= width
    new_f = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * filters:
        new_f += divisor
    return int(new_f)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def tf_same_padding(image_size: int, kernel: int, stride: int
                    ) -> Tuple[int, int, int, int]:
    """Static TF-SAME padding (top, bottom, left, right) for a square
    nominal image (efficientnet_pytorch Conv2dStaticSamePadding)."""
    oh = math.ceil(image_size / stride)
    pad = max((oh - 1) * stride + kernel - image_size, 0)
    lo, hi = pad // 2, pad - pad // 2
    return (lo, hi, lo, hi)


def b2_block_plan(width: float = 1.1, depth: float = 1.2,
                  image_size: int = 260) -> List[Dict]:
    """Per-block build plan for B2, tracking the nominal image size."""
    plan = []
    size = math.ceil(image_size / 2)  # after the stride-2 stem
    for (r, k, s, e, i, o) in _B0_BLOCKS:
        i_r, o_r = round_filters(i, width), round_filters(o, width)
        for rep in range(round_repeats(r, depth)):
            stride = s if rep == 0 else 1
            plan.append(dict(in_filters=i_r if rep == 0 else o_r,
                             out_filters=o_r, kernel=k, stride=stride,
                             nominal_size=size, expand_ratio=e))
            if stride > 1:
                size = math.ceil(size / stride)
    return plan


class MBConvBlock(nn.Module):
    """Inverted-residual block with squeeze-and-excitation and swish."""

    def __init__(self, in_filters: int, out_filters: int, kernel: int,
                 stride: int, expand_ratio: int, nominal_size: int):
        super().__init__()
        oup = in_filters * expand_ratio
        self.has_expand = expand_ratio != 1
        self.has_skip = stride == 1 and in_filters == out_filters
        if self.has_expand:
            self._expand_conv = Conv2dSame(in_filters, oup, 1)
            self._bn0 = nn.BatchNorm2d(oup, eps=_BN_EPS)
        self._depthwise_conv = Conv2dSame(
            oup, oup, kernel, stride=stride, groups=oup,
            padding4=tf_same_padding(nominal_size, kernel, stride))
        self._bn1 = nn.BatchNorm2d(oup, eps=_BN_EPS)
        # SE channel count comes from the block's *input* filters
        n_squeeze = max(1, int(in_filters * _SE_RATIO))
        self._se_reduce = Conv2dSame(oup, n_squeeze, 1, bias=True)
        self._se_expand = Conv2dSame(n_squeeze, oup, 1, bias=True)
        self._project_conv = Conv2dSame(oup, out_filters, 1)
        self._bn2 = nn.BatchNorm2d(out_filters, eps=_BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inputs = x
        if self.has_expand:
            x = F.silu(self._bn0(self._expand_conv(x)))
        x = F.silu(self._bn1(self._depthwise_conv(x)))
        # SE mean over the whole padded map (not length-masked)
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self._se_expand(F.silu(self._se_reduce(s)))
        x = torch.sigmoid(s) * x
        x = self._bn2(self._project_conv(x))
        if self.has_skip:
            x = x + inputs
        return x


class EfficientNetB2(nn.Module):
    """EfficientNet-B2 feature extractor, one input channel, no top."""

    downsample_ratio = 32

    def __init__(self):
        super().__init__()
        stem = round_filters(32, 1.1)
        self._conv_stem = Conv2dSame(1, stem, 3, stride=2,
                                     padding4=tf_same_padding(260, 3, 2))
        self._bn0 = nn.BatchNorm2d(stem, eps=_BN_EPS)
        self._blocks = nn.ModuleList(MBConvBlock(**a) for a in b2_block_plan())
        head = round_filters(1280, 1.1)
        self._conv_head = Conv2dSame(self._blocks[-1]._project_conv.out_channels,
                                     head, 1)
        self._bn1 = nn.BatchNorm2d(head, eps=_BN_EPS)
        self.fc_emb_size = head

    def forward(self, lms: torch.Tensor, feat_len: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        """lms [B, T, n_mels], feat_len [B] -> encoder outputs."""
        x = lms.transpose(1, 2)[:, None]                  # [B, 1, F, T]
        x = F.silu(self._bn0(self._conv_stem(x)))
        for block in self._blocks:
            x = block(x)
        x = F.silu(self._bn1(self._conv_head(x)))
        attn_emb = x.mean(dim=2).transpose(1, 2)          # [B, T', C]
        out_len = torch.div(feat_len, self.downsample_ratio,
                            rounding_mode="floor")
        return {"fc_emb": mean_with_lens(attn_emb, out_len),
                "attn_emb": attn_emb, "attn_emb_len": out_len}
