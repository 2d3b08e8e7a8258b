"""Cnn8-RNN sound-event detection and temporal-tag extraction (counterpart
of ``audiocaption_tpu/models/sed.py``).

The network runs on the device; thresholding and the tag logic are small,
data-dependent numpy on the host, as in the reference (a copy of the JAX
package's numpy functions, which this package does not import).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiocaption_tpu_torch.models.layers import (
    GRU, ConvBlock, Linear, batch_norm_mels, pool_2d, widen)

POOLS = ((2, 2), (2, 2), (1, 2), (1, 2))
CHANNELS = (64, 128, 256, 512)


class Cnn8RnnSedModel(nn.Module):
    """4 double-conv blocks with "avg+max" pooling -> mel mean -> fc1 +
    ReLU -> BiGRU(256) over the whole padded length -> sigmoid framewise
    probabilities, time downsample 4 undone by repetition.  In ``train()``
    (``training/sed_trainer.py``) dropout 0.2 follows each block's pooling
    and 0.5 the mel mean, as in the JAX model.

    ``compute_dtype`` (float32 or bfloat16) is the conv blocks', the
    pooling's and fc1's, as in the JAX package; ``bn0`` stays float32,
    and the GRU and the classifier run in float32 on fc1's output cast
    back."""

    def __init__(self, classes_num: int = 447, n_mels: int = 64,
                 interpolate_ratio: int = 4,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cd = self.compute_dtype = compute_dtype
        self.bn0 = nn.BatchNorm2d(n_mels)
        ins = (1,) + CHANNELS[:-1]
        for i, (cin, cout) in enumerate(zip(ins, CHANNELS)):
            setattr(self, f"conv_block{i + 1}", ConvBlock(cin, cout, cd))
        self.fc1 = Linear(CHANNELS[-1], 512, compute_dtype=cd)
        self.rnn = GRU(512, 256, bidirectional=True)
        self.fc_audioset = nn.Linear(512, classes_num)
        self.interpolate_ratio = interpolate_ratio

    def forward(self, lms: torch.Tensor) -> Dict[str, torch.Tensor]:
        """lms [B, T, 64] -> {segmentwise_output [B, T', C],
        framewise_output [B, T, C]}."""
        frames_num = lms.shape[1]
        x = batch_norm_mels(self.bn0, lms, self.compute_dtype)
        for i, pool in enumerate(POOLS):
            x = pool_2d(getattr(self, f"conv_block{i + 1}")(x), pool,
                        "avg+max")
            x = F.dropout(x, 0.2, self.training)
        x = F.dropout(x.mean(dim=3).transpose(1, 2), 0.5, self.training)
        x = self.fc1(x)                                      # [B, T/4, 512]
        x = widen(F.relu(x))
        seg = torch.clamp(torch.sigmoid(self.fc_audioset(self.rnn(x))),
                          1e-7, 1.0)
        frame = torch.repeat_interleave(seg, self.interpolate_ratio, dim=1)
        pad_n = frames_num - frame.shape[1]
        if pad_n > 0:   # repeat the last frame up to frames_num
            frame = torch.cat([frame, frame[:, -1:].expand(-1, pad_n, -1)], 1)
        return {"segmentwise_output": seg,
                "framewise_output": frame[:, :frames_num]}


# --------------------------------------------------------------------------
# Host-side tag extraction (numpy)
# --------------------------------------------------------------------------

def find_contiguous_regions(activity: np.ndarray) -> np.ndarray:
    """Boolean [T] -> [n, 2] array of [onset, offset) index pairs."""
    activity = np.asarray(activity, bool)
    change = np.logical_xor(activity[1:], activity[:-1]).nonzero()[0] + 1
    if activity.size == 0:
        return np.zeros((0, 2), int)
    if activity[0]:
        change = np.r_[0, change]
    if activity[-1]:
        change = np.r_[change, activity.size]
    return change.reshape((-1, 2))


def _connect(pairs: List[Tuple[int, int]], n: int = 1):
    """Merge clusters whose gap is <= n."""
    if not pairs:
        return []
    merged = [list(pairs[0])]
    for start, end in pairs[1:]:
        if start - merged[-1][1] <= n:
            merged[-1][1] = end
        else:
            merged.append([start, end])
    return [tuple(p) for p in merged]


def double_threshold_1d(x: np.ndarray, high: float, low: float,
                        n_connect: int = 1) -> np.ndarray:
    """Hysteresis thresholding: keep low-threshold regions containing at
    least one sample above the high threshold."""
    high_locations = np.where(x > high)[0]
    regions = find_contiguous_regions(x > low)
    kept = [tuple(p) for p in regions
            if ((p[0] <= high_locations) & (high_locations <= p[1])).any()]
    kept = _connect(kept, n_connect)
    out = np.zeros_like(x, dtype=int)
    for s, e in kept:
        out[s:e] = 1
    return out


def double_threshold(x: np.ndarray, high: float, low: float,
                     n_connect: int = 1) -> np.ndarray:
    """x: [B, T, C], [T, C] or [T]; thresholds over time."""
    axis = 1 if x.ndim == 3 else 0
    return np.apply_along_axis(
        lambda v: double_threshold_1d(v, high, low, n_connect), axis, x)


def segments_to_temporal_tag(segments, thre: float = 0.5) -> int:
    """[(class, onset, offset)] -> tag: 0 single event, +1 simultaneous,
    +2 sequential."""
    after_flag, while_flag = 0, 0
    for j in range(len(segments)):
        for k in range(len(segments)):
            if segments[j][0] == segments[k][0]:
                continue
            min_duration = min(segments[j][2] - segments[j][1],
                               segments[k][2] - segments[k][1])
            overlap = segments[j][2] - segments[k][1]
            if overlap < thre * min_duration:
                after_flag = 2
            if segments[j][1] < segments[k][1] and \
                    overlap > thre * min_duration:
                while_flag = 1
    return after_flag + while_flag


def framewise_to_temporal_tags(framewise: np.ndarray,
                               time_resolution: float = 0.01,
                               high: float = 0.75,
                               low: float = 0.25) -> np.ndarray:
    """Framewise probabilities [B, T, C] -> temporal tag per sample [B]."""
    thresholded = double_threshold(framewise, high, low)
    tags = []
    for lab in thresholded:
        segments = []
        for cls, column in enumerate(lab.T):
            for onset, offset in find_contiguous_regions(column):
                segments.append((cls, onset * time_resolution,
                                 offset * time_resolution))
        tags.append(segments_to_temporal_tag(segments))
    return np.asarray(tags, np.int32)
