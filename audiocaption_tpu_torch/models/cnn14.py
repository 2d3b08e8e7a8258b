"""PANNs Cnn14 audio encoder (counterpart of ``audiocaption_tpu/models/cnn14.py``).

Consumes a log-mel ``lms`` [B, T, 64] and its frame counts ``feat_len``
and returns {attn_emb [B, T // 32, 2048], attn_emb_len = feat_len // 32,
fc_emb [B, 2048]}.  Inside, the image is NCHW [B, C, T, mel] as in the
reference (the JAX package runs NHWC).  Parameter names follow the
reference (``bn0``, ``conv_block{1..6}``, ``fc1``).

``compute_dtype`` (float32 or bfloat16) is the conv blocks' and fc1's,
as in the JAX package: ``bn0`` stays float32, its output is cast, the
mel mean is taken in the compute dtype and ``attn_emb`` / ``fc_emb``
are float32.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from audiocaption_tpu_torch.models.layers import (
    ConvBlock, Linear, batch_norm_mels, pool_2d, widen)
from audiocaption_tpu_torch.ops.masking import max_with_lens, mean_with_lens

CHANNELS = (64, 128, 256, 512, 1024, 2048)


class Cnn14Encoder(nn.Module):
    """bn0 over the mel bins, 6 double-conv blocks 1 -> 2048 with 2x2
    average pooling (none after the last), mean over the mel axis."""

    downsample_ratio = 32

    def __init__(self, n_mels: int = 64, fc_emb_size: int = 2048,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cd = self.compute_dtype = compute_dtype
        self.bn0 = nn.BatchNorm2d(n_mels)
        ins = (1,) + CHANNELS[:-1]
        for i, (cin, cout) in enumerate(zip(ins, CHANNELS)):
            setattr(self, f"conv_block{i + 1}", ConvBlock(cin, cout, cd))
        # fc_emb is part of the reference's key space (and of a Cnn14's
        # own output), though Cnn14RnnEncoder discards it
        self.fc1 = Linear(CHANNELS[-1], fc_emb_size, compute_dtype=cd)
        self.fc_emb_size = fc_emb_size

    def forward(self, lms: torch.Tensor, feat_len: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        x = batch_norm_mels(self.bn0, lms, self.compute_dtype)  # [B,1,T,M]
        for i in range(len(CHANNELS)):
            x = getattr(self, f"conv_block{i + 1}")(x)
            x = pool_2d(x, (1, 1) if i == len(CHANNELS) - 1 else (2, 2),
                        "avg")
        attn_emb = widen(x.mean(dim=3).transpose(1, 2))   # [B, T', 2048]
        out_len = torch.div(feat_len, self.downsample_ratio,
                            rounding_mode="floor")
        pooled = max_with_lens(attn_emb, out_len) + mean_with_lens(
            attn_emb, out_len)
        return {"fc_emb": widen(F.relu(self.fc1(pooled))),
                "attn_emb": attn_emb,
                "attn_emb_len": out_len}
