"""EfficientAT MobileNetV3 ("mn") audio encoders (counterpart of
``audiocaption_tpu/models/mobilenet_v3.py``).

A width-scaled MobileNetV3-Large backbone (ReLU / hard-swish stages,
squeeze-excitation with a hard sigmoid, BN eps 1e-3 and flax momentum
0.99, torch 0.01) over the 32 kHz log-mel, downsampling 32, then the
captioning poolings: "mean_max_fc" (masked max + mean over
``feat_len // 32`` frames -> ``fc1`` 512 -> ReLU) or "mean".

Module names are the EfficientAT / torchvision checkpoint keys that the
JAX ``convert_mobilenet_v3`` reads: ``features.0.{0,1}`` (stem conv and
BN), ``features.{i}.block.{j}.{0,1}`` (each conv and its BN),
``features.{i}.block.{k}.conc_se_layers.0.{fc1,fc2}`` (the SE linears),
``features.16.{0,1}`` (the last 1x1 conv).  The input BN over the mel
bins (``bn0``) and the captioning head (``fc1``) are the JAX package's
own and keep its names.  ``compute_dtype`` follows the JAX rules: ``bn0``
in float32, the convolutions, norms, activations and ``fc1`` in the
compute dtype, ``attn_emb`` and ``fc_emb`` float32.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from audiocaption_tpu_torch.models.cnn14 import pooled_fc
from audiocaption_tpu_torch.models.layers import (
    BatchNorm2d, Conv2dSame, Linear, as_compute, batch_norm_mels,
    check_compute_dtype, narrow, widen)
from audiocaption_tpu_torch.ops.masking import mean_with_lens

NAME_TO_WIDTH = {
    "mn01": 0.1, "mn02": 0.2, "mn04": 0.4, "mn05": 0.5, "mn06": 0.6,
    "mn08": 0.8, "mn10": 1.0, "mn12": 1.2, "mn14": 1.4, "mn16": 1.6,
    "mn20": 2.0, "mn30": 3.0, "mn40": 4.0,
}


def make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


# (in, kernel, expanded, out, use_se, activation, stride)
_V3_LARGE = [
    (16, 3, 16, 16, False, "RE", 1),
    (16, 3, 64, 24, False, "RE", 2),
    (24, 3, 72, 24, False, "RE", 1),
    (24, 5, 72, 40, True, "RE", 2),
    (40, 5, 120, 40, True, "RE", 1),
    (40, 5, 120, 40, True, "RE", 1),
    (40, 3, 240, 80, False, "HS", 2),
    (80, 3, 200, 80, False, "HS", 1),
    (80, 3, 184, 80, False, "HS", 1),
    (80, 3, 184, 80, False, "HS", 1),
    (80, 3, 480, 112, True, "HS", 1),
    (112, 3, 672, 112, True, "HS", 1),
    (112, 5, 672, 160, True, "HS", 2),
    (160, 5, 960, 160, True, "HS", 1),
    (160, 5, 960, 160, True, "HS", 1),
]


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    """x * relu6(x + 3) / 6, each op in ``x``'s dtype (bf16 rounds op by
    op, as the JAX expression does)."""
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def conv_bn(cin: int, cout: int, kernel: int, stride: int = 1,
            groups: int = 1, compute_dtype: torch.dtype = torch.float32
            ) -> nn.Sequential:
    """``{0: conv, 1: BN}`` (torchvision's ConvNormActivation keys): a
    bias-free conv with symmetric padding (k - 1) // 2, BN eps 1e-3."""
    p = (kernel - 1) // 2
    return nn.Sequential(
        Conv2dSame(cin, cout, kernel, stride=stride, groups=groups,
                   padding4=(p, p, p, p), compute_dtype=compute_dtype),
        BatchNorm2d(cout, eps=1e-3, momentum=0.01,
                    compute_dtype=compute_dtype))


class SeLinear(nn.Linear):
    """A squeeze-excitation linear in ``compute_dtype`` with the JAX 1x1
    conv's bias rule: the rounded product plus the float32 bias, rounded
    once."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = check_compute_dtype(compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        if cd == torch.float32:
            return F.linear(x, self.weight, self.bias)
        y = F.linear(narrow(x, cd), as_compute(self.weight, cd))
        return (y.float() + self.bias).to(cd)


class SqueezeExcite(nn.Module):
    """mean over (H, W) -> ``fc1`` -> ReLU -> ``fc2`` -> hard sigmoid,
    times the input."""

    def __init__(self, channels: int, squeeze: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = SeLinear(channels, squeeze, compute_dtype)
        self.fc2 = SeLinear(squeeze, channels, compute_dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        s = self.fc2(F.relu(self.fc1(h.mean(dim=(2, 3)))))
        return hard_sigmoid(s)[:, :, None, None] * h


class ConcurrentSE(nn.Module):
    """EfficientAT's SE wrapper (one SE layer: ``conc_se_layers.0``)."""

    def __init__(self, channels: int, squeeze: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conc_se_layers = nn.ModuleList(
            [SqueezeExcite(channels, squeeze, compute_dtype)])

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.conc_se_layers[0](h)


class V3InvertedResidual(nn.Module):
    """[1x1 expand -> BN -> act] -> depthwise k x k (stride) -> BN -> act
    -> [SE] -> 1x1 project -> BN, plus the input at stride 1 when the
    widths agree.  ``block`` holds the parts in the checkpoint's order."""

    def __init__(self, inp: int, kernel: int, expanded: int, out: int,
                 use_se: bool, use_hs: bool, stride: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cd = compute_dtype
        self.act = hard_swish if use_hs else F.relu
        self.has_expand = expanded != inp
        self.residual = stride == 1 and inp == out
        parts = []
        if self.has_expand:
            parts.append(conv_bn(inp, expanded, 1, compute_dtype=cd))
        parts.append(conv_bn(expanded, expanded, kernel, stride,
                             groups=expanded, compute_dtype=cd))
        if use_se:
            parts.append(ConcurrentSE(
                expanded, make_divisible(expanded // 4), cd))
        parts.append(conv_bn(expanded, out, 1, compute_dtype=cd))
        self.block = nn.ModuleList(parts)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for part in self.block[:-1]:
            if isinstance(part, ConcurrentSE):
                h = part(h)
            else:
                h = self.act(part[1](part[0](h)))
        proj = self.block[-1]
        h = proj[1](proj[0](h))
        return h + x if self.residual else h


class MobileNetV3Encoder(nn.Module):
    """EfficientAT MobileNetV3 encoder: log-mel [B, T, 64] and its frame
    counts -> {attn_emb [B, T', C_last] float32, fc_emb, attn_emb_len =
    feat_len // 32}.  ``model_name`` ("mn01" .. "mn40") sets the width
    multiplier (:data:`NAME_TO_WIDTH`); dropout 0.5 around ``fc1`` in
    ``train()``."""

    downsample_ratio = 32

    def __init__(self, model_name: str = "mn10",
                 pooling: str = "mean_max_fc", n_mels: int = 64,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if pooling not in ("mean_max_fc", "mean"):
            raise ValueError(f"pooling must be 'mean_max_fc' or 'mean', not "
                             f"{pooling!r}")
        cd = self.compute_dtype = check_compute_dtype(compute_dtype)
        self.pooling = pooling
        w = NAME_TO_WIDTH[model_name[:4]]

        def adj(c):
            return make_divisible(c * w)
        self.bn0 = nn.BatchNorm2d(n_mels)
        feats = [conv_bn(1, adj(16), 3, 2, compute_dtype=cd)]
        for ci, k, ce, co, se, a, s in _V3_LARGE:
            feats.append(V3InvertedResidual(adj(ci), k, adj(ce), adj(co), se,
                                            a == "HS", s, cd))
        self.last_channels = make_divisible(make_divisible(160 * w) * 6)
        feats.append(conv_bn(adj(160), self.last_channels, 1,
                             compute_dtype=cd))
        self.features = nn.ModuleList(feats)
        self.attn_emb_size = self.last_channels
        if pooling == "mean_max_fc":
            self.fc1 = Linear(self.last_channels, 512, compute_dtype=cd)
            self.fc_emb_size = 512
        else:
            self.fc_emb_size = self.last_channels

    def forward(self, lms: torch.Tensor, feat_len: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        x = batch_norm_mels(self.bn0, lms, self.compute_dtype)
        stem, last = self.features[0], self.features[-1]
        x = hard_swish(stem[1](stem[0](x)))
        for block in self.features[1:-1]:
            x = block(x)
        x = hard_swish(last[1](last[0](x)))
        attn_emb = widen(x.mean(dim=3).transpose(1, 2))
        out_len = torch.div(feat_len, self.downsample_ratio,
                            rounding_mode="floor")
        if self.pooling == "mean_max_fc":
            fc_emb = pooled_fc(attn_emb, out_len, self.fc1, self.training)
        else:
            fc_emb = mean_with_lens(attn_emb, out_len)
        return {"fc_emb": fc_emb, "attn_emb": attn_emb,
                "attn_emb_len": out_len}
