"""The extended encoder zoo (counterpart of
``audiocaption_tpu/models/encoders_extra.py``): the PANNs Cnn6 / Cnn10
and MobileNetV2 waveform encoders, the audio transformer encoder with a
CLS token, the Cdur5 / Cdur8 CRNN encoders and the Cnn14 -> transformer
composition.

Each consumes a log-mel ``lms`` [B, T, 64] and its frame counts
``feat_len`` (the audio transformer: features [B, T, D] and their
lengths); the image is NCHW [B, C, T, mel] (the JAX package runs NHWC).
Module names follow the JAX tree, which for Cnn6 / Cnn10 is the
reference's own key space (the JAX ``convert_panns_small``: ``bn0``,
``conv_block{i}.conv1`` / ``bn1`` [/ ``conv2`` / ``bn2``], ``fc1``); the
other encoders have no reference converter in the JAX package, so their
keys are the JAX names (``stem``, ``block{i}.depthwise``, ``init_bn``,
``embedding``, ``gru``, ``attn_proj_dense``, ``cls_token``,
``layer{i}.self_attn`` ...; ``models.convert.jax_tree_state_dict``).

Dropout is the JAX package's, active in ``train()`` only.
``compute_dtype`` (float32 or bfloat16) exists where the JAX class has
the knob (Cnn6, Cnn10, MobileNetV2, Cnn14Transformer's Cnn14), with the
Cnn14's rules: ``bn0`` in float32, the blocks and ``fc1`` in the compute
dtype, ``attn_emb`` and ``fc_emb`` float32.  Cdur5, Cdur8 and the audio
transformer run in float32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from audiocaption_tpu_torch.models.cnn14 import Cnn14Encoder, pooled_fc
from audiocaption_tpu_torch.models.layers import (
    GRU, BatchNorm2d, Conv2dSame, ConvBlock, LayerNorm, Linear,
    MultiheadAttention, batch_norm_mels, pool_2d, widen)
from audiocaption_tpu_torch.models.rnn_encoder import embedding_pooling
from audiocaption_tpu_torch.ops.masking import length_mask


class Block2D(nn.Module):
    """BN -> conv3x3 (pad 1, no bias) -> LeakyReLU(0.1).  The BN's torch
    momentum 0.1 is flax's 0.9 (``layers.BatchNorm2d``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.bn = BatchNorm2d(in_channels, momentum=0.1)
        self.conv = Conv2dSame(in_channels, out_channels, 3,
                               padding4=(1, 1, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.conv(self.bn(x)), negative_slope=0.1)


def lp_pool(x: torch.Tensor, window: Tuple[int, int], p: float = 4.0
            ) -> torch.Tensor:
    """(sum of |x|^p over each window)^(1/p) of NCHW ``x``, the stride the
    window and the sizes floored, as the JAX expression.  The sum is the
    window's mean times its area (``nn.LPPool2d`` signs its sum
    differently)."""
    area = window[0] * window[1]
    return (F.avg_pool2d(x.abs() ** p, window) * area) ** (1.0 / p)


class Cdur5Encoder(nn.Module):
    """CRNN SED encoder: Block2D(1 -> 32), LP pool (2, 4), Block2D x 2
    (-> 128), LP pool (2, 4), Block2D x 2, LP pool (1, 4), dropout in
    ``train()``, then a BiGRU(128) over the whole pooled length (not the
    clips' lengths, as in the JAX package).  -> {attn_emb [B, T // 4,
    256], fc_emb (``pooling`` over the first ``feat_len // 4`` frames),
    attn_emb_len = feat_len // 4}."""

    downsample_ratio = 4

    def __init__(self, pooling: str = "mean", dropout: float = 0.3):
        super().__init__()
        chans = ((1, 32), (32, 128), (128, 128), (128, 128), (128, 128))
        for i, (cin, cout) in enumerate(chans):
            setattr(self, f"b{i + 1}", Block2D(cin, cout))
        self.gru = GRU(128, 128, bidirectional=True)
        self.pooling, self.dropout = pooling, dropout
        self.fc_emb_size = 256

    def forward(self, lms: torch.Tensor, feat_len: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        x = lms[:, None]                                  # [B, 1, T, M]
        x = lp_pool(self.b1(x), (2, 4))
        x = lp_pool(self.b3(self.b2(x)), (2, 4))
        x = lp_pool(self.b5(self.b4(x)), (1, 4))
        x = F.dropout(x, self.dropout, self.training)
        B, C, T, W = x.shape
        x = x.permute(0, 2, 1, 3).reshape(B, T, C * W)
        out_len = torch.div(feat_len, self.downsample_ratio,
                            rounding_mode="floor")
        x = self.gru(x)
        return {"attn_emb": x,
                "fc_emb": embedding_pooling(x, out_len, self.pooling),
                "attn_emb_len": out_len}


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(F.relu(x), max=6.0)


class ConvBlock5x5(nn.Module):
    """conv5x5 (pad 2, no bias) -> BN -> ReLU, in ``compute_dtype``."""

    def __init__(self, in_channels: int, out_channels: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2dSame(in_channels, out_channels, 5,
                                padding4=(2, 2, 2, 2),
                                compute_dtype=compute_dtype)
        self.bn1 = BatchNorm2d(out_channels, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn1(self.conv1(x)))


class _PannsCnnBase(nn.Module):
    """bn0 over the mel bins -> 4 conv blocks (64 -> 512), each followed
    by 2x2 average pooling and dropout 0.2 -> mean over the mel axis ->
    ``attn_emb``; masked max + mean over ``feat_len // 16`` frames ->
    ``fc1`` (512) -> ``fc_emb``."""

    channels = (64, 128, 256, 512)
    double_conv = True
    downsample_ratio = 16

    def __init__(self, n_mels: int = 64, fc_emb_size: int = 512,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cd = self.compute_dtype = compute_dtype
        self.bn0 = nn.BatchNorm2d(n_mels)
        block = ConvBlock if self.double_conv else ConvBlock5x5
        ins = (1,) + self.channels[:-1]
        for i, (cin, cout) in enumerate(zip(ins, self.channels)):
            setattr(self, f"conv_block{i + 1}", block(cin, cout, cd))
        self.fc1 = Linear(self.channels[-1], fc_emb_size, compute_dtype=cd)
        self.fc_emb_size = fc_emb_size
        self.attn_emb_size = self.channels[-1]

    def forward(self, lms: torch.Tensor, feat_len: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        x = batch_norm_mels(self.bn0, lms, self.compute_dtype)
        for i in range(len(self.channels)):
            x = getattr(self, f"conv_block{i + 1}")(x)
            x = F.dropout(pool_2d(x, (2, 2), "avg"), 0.2, self.training)
        attn_emb = widen(x.mean(dim=3).transpose(1, 2))
        out_len = torch.div(feat_len, self.downsample_ratio,
                            rounding_mode="floor")
        return {"fc_emb": pooled_fc(attn_emb, out_len, self.fc1,
                                     self.training),
                "attn_emb": attn_emb, "attn_emb_len": out_len}


class Cnn6Encoder(_PannsCnnBase):
    """PANNs Cnn6: single 5x5 conv blocks."""
    double_conv = False


class Cnn10Encoder(_PannsCnnBase):
    """PANNs Cnn10: double 3x3 conv blocks."""
    double_conv = True


class TransformerEncoderLayerTorch(nn.Module):
    """torch ``nn.TransformerEncoderLayer`` (post-norm, ReLU): self-attn
    -> add & norm -> FFN -> add & norm; in ``train()`` dropout on the
    attention probabilities, both residual branches and the FFN's inner
    activation."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 dropout: float = 0.2):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiheadAttention(d_model, num_heads,
                                            dropout=dropout)
        self.norm1 = LayerNorm(d_model)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm2 = LayerNorm(d_model)

    def _drop(self, x: torch.Tensor) -> torch.Tensor:
        return F.dropout(x, self.dropout, self.training)

    def forward(self, x: torch.Tensor,
                src_key_padding_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x = self.norm1(x + self._drop(self.self_attn(
            x, x, x, src_key_padding_mask)))
        h = self.linear2(self._drop(F.relu(self.linear1(x))))
        return self.norm2(x + self._drop(h))


class AudioTransformerEncoder(nn.Module):
    """relu(Linear) -> dropout -> LayerNorm over the input features, a
    learned CLS token prepended, then ``nlayers`` post-norm encoder
    layers (``nhead`` d_model // 64 and an FFN of 4 * d_model unless
    given) -> {attn_emb [B, T + 1, d_model], fc_emb (the CLS position),
    attn_emb_len + 1}."""

    def __init__(self, in_dim: int, d_model: int, nlayers: int = 2,
                 nhead: Optional[int] = None,
                 dim_feedforward: Optional[int] = None,
                 dropout: float = 0.2):
        super().__init__()
        nhead = nhead or d_model // 64
        ff = dim_feedforward or d_model * 4
        self.dropout, self.nlayers = dropout, nlayers
        self.attn_proj_dense = Linear(in_dim, d_model)
        self.attn_proj_norm = LayerNorm(d_model)
        self.cls_token = nn.Parameter(torch.empty(1, d_model))
        bound = math.sqrt(6.0 / (1 + d_model))
        nn.init.uniform_(self.cls_token, -bound, bound)
        for i in range(nlayers):
            setattr(self, f"layer{i}", TransformerEncoderLayerTorch(
                d_model, nhead, ff, dropout))
        self.fc_emb_size = self.attn_emb_size = d_model

    def forward(self, attn: torch.Tensor, attn_len: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        h = F.relu(self.attn_proj_dense(attn))
        h = self.attn_proj_norm(F.dropout(h, self.dropout, self.training))
        cls = self.cls_token[None].expand(h.shape[0], 1, -1)
        h = torch.cat([cls, h], dim=1)
        out_len = attn_len + 1
        kpm = ~length_mask(out_len, h.shape[1])
        for i in range(self.nlayers):
            h = getattr(self, f"layer{i}")(h, kpm)
        return {"attn_emb": h, "fc_emb": h[:, 0], "attn_emb_len": out_len}


class Cdur8Encoder(nn.Module):
    """``init_bn`` over the mel bins -> 4 PANNs double-conv blocks
    (64 -> 512), each followed by an "avg+max" pool ((2, 2), (2, 2),
    (1, 2), (1, 2)) and dropout 0.2 -> mean over the mel axis, dropout
    0.5 -> ``relu(embedding)`` (512) -> a BiGRU(256) over the whole
    pooled length with no length mask, as in the JAX package ->
    {attn_emb [B, T // 4, 512], fc_emb (``pooling`` over
    ``feat_len // 4`` frames), attn_emb_len = feat_len // 4}."""

    downsample_ratio = 4
    pools = ((2, 2), (2, 2), (1, 2), (1, 2))

    def __init__(self, n_mels: int = 64, pooling: str = "mean"):
        super().__init__()
        self.init_bn = nn.BatchNorm2d(n_mels)
        chans = (1, 64, 128, 256, 512)
        for i in range(4):
            setattr(self, f"conv_block{i + 1}", ConvBlock(chans[i],
                                                          chans[i + 1]))
        self.embedding = nn.Linear(512, 512)
        self.gru = GRU(512, 256, bidirectional=True)
        self.pooling = pooling
        self.fc_emb_size = self.attn_emb_size = 512

    def forward(self, spec: torch.Tensor, spec_len: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        x = batch_norm_mels(self.init_bn, spec)
        for i, pool in enumerate(self.pools):
            x = getattr(self, f"conv_block{i + 1}")(x)
            x = F.dropout(pool_2d(x, pool, "avg+max"), 0.2, self.training)
        x = F.dropout(x.mean(dim=3).transpose(1, 2), 0.5, self.training)
        x = self.gru(F.relu(self.embedding(x)))
        out_len = torch.div(spec_len, self.downsample_ratio,
                            rounding_mode="floor")
        return {"attn_emb": x,
                "fc_emb": embedding_pooling(x, out_len, self.pooling),
                "attn_emb_len": out_len}


class InvertedResidual(nn.Module):
    """The PANNs MobileNetV2 block: [1x1 expand -> BN -> ReLU6] ->
    depthwise 3x3 at stride 1, then ``AvgPool(stride)`` (PANNs pools
    where MobileNetV2 strides) -> BN -> ReLU6 -> 1x1 project -> BN, plus
    the input when the shape holds."""

    def __init__(self, inp: int, oup: int, stride: int, expand_ratio: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cd = compute_dtype
        hidden = round(inp * expand_ratio)
        self.stride, self.residual = stride, stride == 1 and inp == oup
        self.has_expand = expand_ratio != 1
        if self.has_expand:
            self.expand = Conv2dSame(inp, hidden, 1, compute_dtype=cd)
            self.bn_expand = BatchNorm2d(hidden, compute_dtype=cd)
        self.depthwise = Conv2dSame(hidden, hidden, 3, groups=hidden,
                                    padding4=(1, 1, 1, 1), compute_dtype=cd)
        self.bn_dw = BatchNorm2d(hidden, compute_dtype=cd)
        self.project = Conv2dSame(hidden, oup, 1, compute_dtype=cd)
        self.bn_proj = BatchNorm2d(oup, compute_dtype=cd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = relu6(self.bn_expand(self.expand(x))) if self.has_expand else x
        h = self.depthwise(h)
        if self.stride > 1:
            h = pool_2d(h, (self.stride, self.stride), "avg")
        h = self.bn_proj(self.project(relu6(self.bn_dw(h))))
        return h + x if self.residual else h


# t (expansion), c (channels), n (blocks), s (stride of the first)
MOBILENETV2_SETTINGS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                        (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                        (6, 320, 1, 1))


class MobileNetV2Encoder(nn.Module):
    """The PANNs MobileNetV2: bn0 over the mel bins, a 3x3 stem with
    2x2 average pooling, BN, ReLU6, 17 inverted residual blocks, a 1x1
    head of 1280 with BN and ReLU6, the mean over the mel axis ->
    ``attn_emb`` [B, T // 32, 1280]; masked max + mean over
    ``feat_len // 32`` frames -> ``fc1`` (1024) -> ``fc_emb``."""

    downsample_ratio = 32

    def __init__(self, n_mels: int = 64, fc_emb_size: int = 1024,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cd = self.compute_dtype = compute_dtype
        self.bn0 = nn.BatchNorm2d(n_mels)
        self.stem = Conv2dSame(1, 32, 3, padding4=(1, 1, 1, 1),
                               compute_dtype=cd)
        self.bn_stem = BatchNorm2d(32, compute_dtype=cd)
        inp, idx = 32, 0
        for t, c, n, s in MOBILENETV2_SETTINGS:
            for i in range(n):
                setattr(self, f"block{idx}", InvertedResidual(
                    inp, c, s if i == 0 else 1, t, cd))
                inp, idx = c, idx + 1
        self.n_blocks = idx
        self.head = Conv2dSame(inp, 1280, 1, compute_dtype=cd)
        self.bn_head = BatchNorm2d(1280, compute_dtype=cd)
        self.fc1 = Linear(1280, fc_emb_size, compute_dtype=cd)
        self.fc_emb_size, self.attn_emb_size = fc_emb_size, 1280

    def forward(self, lms: torch.Tensor, feat_len: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        x = batch_norm_mels(self.bn0, lms, self.compute_dtype)
        x = relu6(self.bn_stem(pool_2d(self.stem(x), (2, 2), "avg")))
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
        x = relu6(self.bn_head(self.head(x)))
        attn_emb = widen(x.mean(dim=3).transpose(1, 2))
        out_len = torch.div(feat_len, self.downsample_ratio,
                            rounding_mode="floor")
        return {"fc_emb": pooled_fc(attn_emb, out_len, self.fc1,
                                     self.training),
                "attn_emb": attn_emb, "attn_emb_len": out_len}


class Cnn14TransformerEncoder(nn.Module):
    """Cnn14 (``cnn``) -> ``AudioTransformerEncoder`` (``trm``) over its
    2048-wide ``attn_emb``.  ``freeze_cnn`` detaches the CNN's output;
    ``freeze_cnn_bn`` keeps the CNN in ``eval()`` while the encoder
    trains (the JAX encoder runs it with ``train=False``)."""

    def __init__(self, d_model: int = 512, nlayers: int = 2,
                 dropout: float = 0.2, freeze_cnn: bool = False,
                 freeze_cnn_bn: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cnn = Cnn14Encoder(compute_dtype=compute_dtype)
        self.trm = AudioTransformerEncoder(self.cnn.fc_emb_size, d_model,
                                           nlayers, dropout=dropout)
        self.freeze_cnn, self.freeze_cnn_bn = freeze_cnn, freeze_cnn_bn
        self.fc_emb_size = self.attn_emb_size = d_model

    def train(self, mode: bool = True) -> "Cnn14TransformerEncoder":
        super().train(mode)
        if self.freeze_cnn_bn:
            self.cnn.train(False)
        return self

    def forward(self, lms: torch.Tensor, feat_len: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        cnn_out = self.cnn(lms, feat_len)
        attn = cnn_out["attn_emb"]
        if self.freeze_cnn:
            attn = attn.detach()
        return self.trm(attn, cnn_out["attn_emb_len"])
