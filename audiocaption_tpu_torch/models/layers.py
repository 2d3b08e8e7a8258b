"""Neural building blocks the captioners need (counterpart of the
matching subset of ``audiocaption_tpu/models/layers.py``).

Parameter names follow torch's own modules (``nn.Conv2d``,
``nn.MultiheadAttention``'s packed ``in_proj_weight``,
``nn.TransformerDecoderLayer``, ``nn.GRU``'s ``weight_ih_l{k}[_reverse]``)
so reference checkpoints load with a plain ``load_state_dict``.  Layouts
follow PyTorch habit: NCHW convs, [out, in] linear weights, [3H, in] GRU
weights with gate order r, z, n (the JAX package keeps the transpose).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

NEG_MASK = float(torch.finfo(torch.float32).min)


class Conv2dSame(nn.Conv2d):
    """``nn.Conv2d`` with a static explicit zero padding.

    ``padding4`` is (top, bottom, left, right), the TF-SAME padding that
    EfficientNet bakes at construction from its nominal image size (the
    pad can be asymmetric)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, groups: int = 1, bias: bool = False,
                 padding4: Sequence[int] = (0, 0, 0, 0)):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=0, groups=groups, bias=bias)
        top, bottom, left, right = padding4
        self.pad = (left, right, top, bottom)   # F.pad order: W then H

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if any(self.pad):
            x = F.pad(x, self.pad)
        return super().forward(x)


def sinusoidal_positions(max_len: int, d_model: int) -> np.ndarray:
    """Sinusoidal table [max_len, d_model]: sin on even dims, cos on odd."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                      * (-math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


def causal_mask(length: int, device=None) -> torch.Tensor:
    """Additive causal mask: 0 on/below the diagonal, -inf above."""
    return torch.triu(torch.full((length, length), float("-inf"),
                                 device=device), diagonal=1)


class MultiheadAttention(nn.Module):
    """torch ``nn.MultiheadAttention`` parameters and semantics.

    ``forward`` is full-sequence attention; ``project_kv`` plus
    ``attend_step`` are the KV-cached single-token decode path.  A
    key-padding mask fills with float32's lowest value (not -inf), so a
    row whose keys are all masked attends uniformly, as in the JAX
    package."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def _proj(self, x: torch.Tensor, i: int) -> torch.Tensor:
        E = self.embed_dim
        return F.linear(x, self.in_proj_weight[i * E:(i + 1) * E],
                        self.in_proj_bias[i * E:(i + 1) * E])

    def _attend(self, q, k, v, key_padding_mask: Optional[torch.Tensor],
                attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
        E, H = self.embed_dim, self.num_heads
        Dh = E // H
        B, Tq, Tk = q.shape[0], q.shape[1], k.shape[1]
        q = q.reshape(B, Tq, H, Dh).transpose(1, 2)
        k = k.reshape(B, Tk, H, Dh).transpose(1, 2)
        v = v.reshape(B, Tk, H, Dh).transpose(1, 2)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(Dh)
        if attn_mask is not None:
            scores = scores + attn_mask[None, None]
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                        NEG_MASK)
        probs = torch.softmax(scores, dim=-1)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(B, Tq, E)
        return self.out_proj(out)

    def forward(self, query, key, value, key_padding_mask=None,
                attn_mask=None) -> torch.Tensor:
        return self._attend(self._proj(query, 0), self._proj(key, 1),
                            self._proj(value, 2), key_padding_mask, attn_mask)

    def project_kv(self, key, value) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._proj(key, 1), self._proj(value, 2)

    def attend_step(self, q_t, k, v, key_padding_mask) -> torch.Tensor:
        """q_t [B, E]; k/v [B, S, E]; key_padding_mask [B, S] True=masked."""
        q = self._proj(q_t[:, None, :], 0)
        return self._attend(q, k, v, key_padding_mask, None)[:, 0]


class TransformerDecoderLayer(nn.Module):
    """torch ``nn.TransformerDecoderLayer`` (post-norm, ReLU), inference:
    self-attn -> add&norm -> cross-attn -> add&norm -> FFN -> add&norm."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.multihead_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def _ffn(self, x):
        return self.linear2(F.relu(self.linear1(x)))

    def forward(self, x, memory, tgt_mask=None, tgt_key_padding_mask=None,
                memory_key_padding_mask=None) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x, x, x, tgt_key_padding_mask,
                                          tgt_mask))
        x = self.norm2(x + self.multihead_attn(x, memory, memory,
                                               memory_key_padding_mask))
        return self.norm3(x + self._ffn(x))

    def precompute_memory(self, memory):
        """Project the cross-attention K/V once per decoded sequence."""
        return self.multihead_attn.project_kv(memory, memory)

    def step(self, x_t, t: int, self_k, self_v, self_kpm, mem_k, mem_v,
             memory_key_padding_mask):
        """One decode step at position ``t``.  Writes this step's K/V into
        row ``t`` of the caches in place; the caller keeps ``self_kpm``
        masking positions > t and pad tokens."""
        k_t, v_t = self.self_attn.project_kv(x_t, x_t)
        self_k[:, t] = k_t
        self_v[:, t] = v_t
        x = self.norm1(x_t + self.self_attn.attend_step(x_t, self_k, self_v,
                                                        self_kpm))
        x = self.norm2(x + self.multihead_attn.attend_step(
            x, mem_k, mem_v, memory_key_padding_mask))
        return self.norm3(x + self._ffn(x))


class ConvBlock(nn.Module):
    """PANNs double-conv block: conv3x3 (pad 1, no bias) -> BN (eps 1e-5)
    -> ReLU, twice.  Pooling is the caller's (:func:`pool_2d`)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1,
                               bias=False)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(out_channels)
        self.bn2 = nn.BatchNorm2d(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


def pool_2d(x: torch.Tensor, window: Tuple[int, int],
            pool_type: str) -> torch.Tensor:
    """Non-overlapping "avg" / "max" / "avg+max" (the sum) pooling of NCHW
    ``x`` over (H, W); odd sizes are floored.  A (1, 1) window is the
    identity for each pool, so "avg+max" then gives 2 * x."""
    def avg(v):
        return v if tuple(window) == (1, 1) else F.avg_pool2d(v, window)

    def max_(v):
        return v if tuple(window) == (1, 1) else F.max_pool2d(v, window)

    if pool_type == "avg":
        return avg(x)
    if pool_type == "max":
        return max_(x)
    if pool_type == "avg+max":
        return avg(x) + max_(x)
    raise ValueError(f"unknown pool type {pool_type!r}")


def batch_norm_mels(bn: nn.BatchNorm2d, lms: torch.Tensor) -> torch.Tensor:
    """BatchNorm over the mel bins of ``lms`` [B, T, M] (the M bins are
    the features), returned as the NCHW image [B, 1, T, M]."""
    x = bn(lms.transpose(1, 2)[..., None])           # [B, M, T, 1]
    return x[..., 0].transpose(1, 2)[:, None]


class GRU(nn.GRU):
    """``nn.GRU`` (batch first) whose ``forward(x, lens)`` has the
    pack-padded semantics of the reference encoders: each row runs over its
    first ``lens[b]`` steps only (the backward direction from its own last
    valid step), state is frozen and output zero past its length.  A row
    of length 0 gives zeros, as the JAX package's masked scan does
    (``pack_padded_sequence`` itself refuses a length of 0).  Without
    ``lens`` every row runs over the whole padded length."""

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, bidirectional: bool = False):
        super().__init__(input_size, hidden_size, num_layers=num_layers,
                         bidirectional=bidirectional, batch_first=True)

    def forward(self, x: torch.Tensor, lens: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """x [B, T, I] -> out [B, T, H * directions]."""
        if lens is None:
            return super().forward(x)[0]
        T = x.shape[1]
        lens_cpu = lens.detach().to("cpu", torch.int64).clamp(max=T)
        packed = pack_padded_sequence(x, lens_cpu.clamp(min=1),
                                      batch_first=True, enforce_sorted=False)
        out, _ = pad_packed_sequence(super().forward(packed)[0],
                                     batch_first=True, total_length=T)
        if bool((lens_cpu <= 0).any()):
            out = out * (lens_cpu > 0).to(out.device, out.dtype)[:, None, None]
        return out
