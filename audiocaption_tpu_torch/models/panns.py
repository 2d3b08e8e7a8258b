"""The original PANNs AudioSet classifiers (counterpart of
``audiocaption_tpu/models/panns.py``): ``Cnn10`` and
``Wavegram_Logmel_Cnn14``, the taggers that ``cli/prepare_features.py
--encoder panns_cnn10|panns_wavegram`` extracts features and clip
probabilities from.

Each returns {clipwise_output (sigmoid), logits, fc_feat [B, C],
attn_feat [B, T', C]}: the last feature map averaged over the mel axis is
``attn_feat``, its max plus mean over time goes through ``fc1`` (ReLU) to
``fc_feat`` and ``fc_audioset`` to the logits.  Dropout (0.2 between the
blocks, 0.5 in the head) acts in ``train()`` only.  Module names are the
reference checkpoint keys that the JAX ``convert_cnn10_classifier`` /
``convert_wavegram_cnn14`` read (``bn0``, ``conv_block{i}``,
``pre_conv0``, ``pre_bn0``, ``pre_block{i}``, ``fc1``, ``fc_audioset``).
Float32 only, as the JAX classifiers.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from audiocaption_tpu_torch.models.layers import (
    ConvBlock, batch_norm_mels, pool_2d)


class ConvPreWavBlock(nn.Module):
    """The wavegram pre-block: 1-D conv k3 (pad 1) -> BN -> ReLU -> 1-D
    conv k3 dilated 2 (pad 2) -> BN -> ReLU -> max pool over time (the
    length floored), on [B, C, T]."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv1d(in_channels, out_channels, 3, padding=1,
                               bias=False)
        self.conv2 = nn.Conv1d(out_channels, out_channels, 3, padding=2,
                               dilation=2, bias=False)
        self.bn1 = nn.BatchNorm1d(out_channels)
        self.bn2 = nn.BatchNorm1d(out_channels)

    def forward(self, x: torch.Tensor, pool_size: int) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        return F.max_pool1d(x, pool_size)


class _PannsHead(nn.Module):
    """The classifiers' shared head (``fc1`` and ``fc_audioset`` sit on
    the classifier itself, as in the reference)."""

    def head(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: the NCHW feature map [B, C, T', M']."""
        attn_feat = x.mean(dim=3).transpose(1, 2)          # [B, T', C]
        pooled = attn_feat.amax(dim=1) + attn_feat.mean(dim=1)
        emb = F.relu(self.fc1(F.dropout(pooled, 0.5, self.training)))
        logits = self.fc_audioset(F.dropout(emb, 0.5, self.training))
        return {"clipwise_output": torch.sigmoid(logits), "logits": logits,
                "fc_feat": emb, "attn_feat": attn_feat}


class Cnn10(_PannsHead):
    """PANNs Cnn10 tagger over a log-mel [B, T, 64]: bn0, four double-conv
    blocks (64 -> 512) each followed by 2x2 average pooling."""

    def __init__(self, classes_num: int = 527, n_mels: int = 64):
        super().__init__()
        self.bn0 = nn.BatchNorm2d(n_mels)
        chans = (1, 64, 128, 256, 512)
        for i in range(4):
            setattr(self, f"conv_block{i + 1}",
                    ConvBlock(chans[i], chans[i + 1]))
        self.fc1 = nn.Linear(512, 512)
        self.fc_audioset = nn.Linear(512, classes_num)

    def forward(self, lms: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = batch_norm_mels(self.bn0, lms)
        for i in range(1, 5):
            x = getattr(self, f"conv_block{i}")(x)
            x = F.dropout(pool_2d(x, (2, 2), "avg"), 0.2, self.training)
        return self.head(x)


class Wavegram_Logmel_Cnn14(_PannsHead):
    """Wavegram + log-mel Cnn14: a learned waveform front (a strided 1-D
    conv and three pre-blocks, its 128 channels regrouped into a [4, T',
    32] image and a conv block) concatenated on the channels with the
    log-mel branch after its first block (both cut to the shorter time),
    then Cnn14's blocks 2-6 (128 -> 2048)."""

    def __init__(self, classes_num: int = 527, n_mels: int = 64):
        super().__init__()
        self.pre_conv0 = nn.Conv1d(1, 64, 11, stride=5, padding=5,
                                   bias=False)
        self.pre_bn0 = nn.BatchNorm1d(64)
        self.pre_block1 = ConvPreWavBlock(64, 64)
        self.pre_block2 = ConvPreWavBlock(64, 128)
        self.pre_block3 = ConvPreWavBlock(128, 128)
        self.pre_block4 = ConvBlock(4, 64)
        self.bn0 = nn.BatchNorm2d(n_mels)
        self.conv_block1 = ConvBlock(1, 64)
        chans = (128, 128, 256, 512, 1024, 2048)     # block 2 takes both
        for i in range(2, 7):
            setattr(self, f"conv_block{i}", ConvBlock(chans[i - 2],
                                                      chans[i - 1]))
        self.fc1 = nn.Linear(2048, 2048)
        self.fc_audioset = nn.Linear(2048, classes_num)

    def forward(self, wav: torch.Tensor, lms: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        """wav [B, T] and its log-mel [B, Tm, 64]."""
        a = F.relu(self.pre_bn0(self.pre_conv0(wav[:, None])))
        for i in range(1, 4):
            a = getattr(self, f"pre_block{i}")(a, 4)
        B, C, T = a.shape                                  # C = 4 * 32
        a = a.reshape(B, 4, C // 4, T).transpose(2, 3)     # [B, 4, T, 32]
        a = pool_2d(self.pre_block4(a), (2, 1), "avg")

        x = pool_2d(self.conv_block1(batch_norm_mels(self.bn0, lms)), (2, 2),
                    "avg")
        t = min(x.shape[2], a.shape[2])
        x = torch.cat([x[:, :, :t], a[:, :, :t]], dim=1)
        for i in range(2, 6):
            x = getattr(self, f"conv_block{i}")(F.dropout(x, 0.2,
                                                          self.training))
            x = pool_2d(x, (2, 2), "avg")
        x = self.conv_block6(F.dropout(x, 0.2, self.training))
        return self.head(F.dropout(x, 0.2, self.training))
