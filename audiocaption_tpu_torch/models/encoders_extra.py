"""The Cdur5 CRNN encoder of the KD student (counterpart of
``Block2D``, ``lp_pool`` and ``Cdur5Encoder`` in
``audiocaption_tpu/models/encoders_extra.py``).

Consumes a log-mel ``lms`` [B, T, 64] and its frame counts ``feat_len``;
the image is NCHW [B, C, T, mel] (the JAX package runs NHWC).  Module
names follow the JAX tree (``b1`` .. ``b5``, each ``bn`` and ``conv``,
and ``gru``): neither package has the reference's own Cdur5 key names,
so the key space is ``encoder.b1.bn.*``, ``encoder.gru.*``
(``models.convert.cdur5_trm_state_dict_from_jax``).

The JAX file's other encoders (Cdur8, Cnn6 / Cnn10, the audio
transformer, MobileNetV2) are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from audiocaption_tpu_torch.models.layers import GRU, BatchNorm2d, Conv2dSame
from audiocaption_tpu_torch.models.rnn_encoder import embedding_pooling


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
