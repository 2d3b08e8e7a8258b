"""Neural building blocks the captioners need (counterpart of the
matching subset of ``audiocaption_tpu/models/layers.py``).

Parameter names follow torch's own modules (``nn.Conv2d``,
``nn.MultiheadAttention``'s packed ``in_proj_weight``,
``nn.TransformerDecoderLayer``, ``nn.GRU``'s ``weight_ih_l{k}[_reverse]``)
so reference checkpoints load with a plain ``load_state_dict``.  Layouts
follow PyTorch habit: NCHW convs, [out, in] linear weights, [3H, in] GRU
weights with gate order r, z, n (the JAX package keeps the transpose).

Precision (the JAX package's ``compute_dtype`` rules): parameters and
normalisation statistics stay float32 in the state dict.  With
``compute_dtype=torch.bfloat16`` a conv or linear layer rounds its input
and weight to bf16, sums in float32 and rounds its output to bf16 (a
conv's bias is added in float32 before that rounding, a linear's bias is
rounded to bf16 first, as flax's ``Dense(dtype=bf16)``); batch and layer
norms compute in float32 and round their output; attention scores are a
float32 sum of bf16 operands, softmax float32, probabilities and values
rounded to bf16 for the second product.  The bf16 copy of a weight is
made once per version of the parameter (:func:`as_compute`).
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
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def check_compute_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be torch.float32 or "
                         f"torch.bfloat16, not {dtype}")
    return dtype


def narrow(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to the compute dtype ``dtype``.  The float32 mode
    leaves ``x`` as it is, so a module moved to float64 runs in float64."""
    return x if dtype == torch.float32 else x.to(dtype)


def widen(x: torch.Tensor) -> torch.Tensor:
    """A bf16 ``x`` back in float32; any other ``x`` as it is."""
    return x.float() if x.dtype == torch.bfloat16 else x


def as_compute(w: Optional[torch.Tensor], dtype: torch.dtype
               ) -> Optional[torch.Tensor]:
    """Parameter ``w`` in the compute dtype ``dtype`` (as it is in the
    float32 mode).  The rounded copy is kept on the parameter and made
    again only when the parameter changes (its version, storage or
    device), so a bf16 layer rounds its weights once, not at every call;
    the parameter itself stays float32."""
    if w is None or dtype == torch.float32 or w.dtype == dtype:
        return w
    key = (dtype, w.device, w.data_ptr(), w._version)
    hit = getattr(w, "_compute_copy", None)
    if hit is None or hit[0] != key:
        hit = (key, w.detach().to(dtype))
        w._compute_copy = hit
    return hit[1]


class Conv2dSame(nn.Conv2d):
    """``nn.Conv2d`` with a static explicit zero padding, in
    ``compute_dtype``.

    ``padding4`` is (top, bottom, left, right), the TF-SAME padding that
    EfficientNet bakes at construction from its nominal image size (the
    pad can be asymmetric; a symmetric one is the conv's own padding)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, groups: int = 1, bias: bool = False,
                 padding4: Sequence[int] = (0, 0, 0, 0),
                 compute_dtype: torch.dtype = torch.float32):
        top, bottom, left, right = padding4
        symmetric = top == bottom and left == right
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=(top, left) if symmetric else 0,
                         groups=groups, bias=bias)
        # F.pad order: W then H
        self.pad = None if symmetric else (left, right, top, bottom)
        self.compute_dtype = check_compute_dtype(compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        x = narrow(x, cd)
        if self.pad is not None:
            x = F.pad(x, self.pad)
        if cd == torch.float32:
            return self._conv_forward(x, self.weight, self.bias)
        y = self._conv_forward(x, as_compute(self.weight, cd), None)
        if self.bias is None:
            return y
        return (y.float() + self.bias[:, None, None]).to(cd)


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
          dtype: torch.dtype) -> torch.Tensor:
    """``F.linear`` in the compute dtype.  In bf16 as flax's
    ``Dense(dtype=bf16)``: the product of the rounded input and weight is
    rounded, then the rounded bias is added in bf16."""
    if dtype == torch.float32:
        return F.linear(x, w, b)
    y = F.linear(x.to(dtype), as_compute(w, dtype))
    return y if b is None else y + as_compute(b, dtype)


class Linear(nn.Linear):
    """``nn.Linear`` in ``compute_dtype`` (flax ``Dense(dtype=...)``):
    input, weight and bias rounded to it, float32 sums."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = check_compute_dtype(compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias, self.compute_dtype)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computed in float32, output in ``compute_dtype``."""

    def __init__(self, normalized_shape: int, eps: float = 1e-5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(normalized_shape, eps=eps)
        self.compute_dtype = check_compute_dtype(compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # CUDA's layer_norm takes no bf16 input with float32 parameters
        return narrow(super().forward(widen(x)), self.compute_dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (inference) computed in float32 from float32
    statistics, output in ``compute_dtype``."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(num_features, eps=eps)
        self.compute_dtype = check_compute_dtype(compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # a bf16 x with the float32 parameters is one mixed-dtype call,
        # computed in float32 and rounded once
        return narrow(super().forward(x), self.compute_dtype)


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
    package.  Projections run in ``compute_dtype``; scores and softmax in
    float32; with bf16, probabilities and values are rounded to bf16 for
    the float32-summed context product."""

    def __init__(self, embed_dim: int, num_heads: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.compute_dtype = check_compute_dtype(compute_dtype)
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim,
                               compute_dtype=compute_dtype)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def _proj(self, x: torch.Tensor, i: int) -> torch.Tensor:
        E, cd = self.embed_dim, self.compute_dtype
        w = as_compute(self.in_proj_weight, cd)
        b = as_compute(self.in_proj_bias, cd)
        return dense(x, w[i * E:(i + 1) * E], b[i * E:(i + 1) * E], cd)

    def _attend(self, q, k, v, key_padding_mask: Optional[torch.Tensor],
                attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
        E, H, cd = self.embed_dim, self.num_heads, self.compute_dtype
        Dh = E // H
        B, Tq, Tk = q.shape[0], q.shape[1], k.shape[1]
        q = widen(q.reshape(B, Tq, H, Dh).transpose(1, 2))
        k = widen(k.reshape(B, Tk, H, Dh).transpose(1, 2))
        v = widen(narrow(v.reshape(B, Tk, H, Dh).transpose(1, 2), cd))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(Dh)
        if attn_mask is not None:
            scores = scores + attn_mask[None, None]
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                        NEG_MASK)
        probs = widen(narrow(torch.softmax(scores, dim=-1), cd))
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
    self-attn -> add&norm -> cross-attn -> add&norm -> FFN -> add&norm,
    in ``compute_dtype`` (residual sums in it too)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cd = compute_dtype
        self.self_attn = MultiheadAttention(d_model, nhead, cd)
        self.multihead_attn = MultiheadAttention(d_model, nhead, cd)
        self.linear1 = Linear(d_model, dim_feedforward, compute_dtype=cd)
        self.linear2 = Linear(dim_feedforward, d_model, compute_dtype=cd)
        self.norm1 = LayerNorm(d_model, eps=1e-5, compute_dtype=cd)
        self.norm2 = LayerNorm(d_model, eps=1e-5, compute_dtype=cd)
        self.norm3 = LayerNorm(d_model, eps=1e-5, compute_dtype=cd)

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
    -> ReLU, twice, in ``compute_dtype``.  Pooling is the caller's
    (:func:`pool_2d`)."""

    def __init__(self, in_channels: int, out_channels: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cd, pad = compute_dtype, (1, 1, 1, 1)
        self.conv1 = Conv2dSame(in_channels, out_channels, 3, padding4=pad,
                                compute_dtype=cd)
        self.conv2 = Conv2dSame(out_channels, out_channels, 3, padding4=pad,
                                compute_dtype=cd)
        self.bn1 = BatchNorm2d(out_channels, compute_dtype=cd)
        self.bn2 = BatchNorm2d(out_channels, compute_dtype=cd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``torch.sigmoid``; for bf16 ``x`` as the JAX package computes it
    there, 1 / (1 + exp(-x)) with every op rounded to bf16."""
    if x.dtype != torch.bfloat16:
        return torch.sigmoid(x)
    return torch.reciprocal(1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``F.silu``; for bf16 ``x`` as in the JAX package, x * sigmoid(x)
    rounded to bf16 after each op."""
    return F.silu(x) if x.dtype != torch.bfloat16 else x * sigmoid(x)


def _avg_pool_bf16(x: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """Average pooling as the JAX package's bf16 ``avg_pool``: the
    window's values summed in bf16 in row-major order, then divided."""
    wh, ww = window
    H, W = x.shape[2] // wh * wh, x.shape[3] // ww * ww
    acc = x[:, :, 0:H:wh, 0:W:ww]
    for i in range(wh):
        for j in range(ww):
            if i or j:
                acc = acc + x[:, :, i:H:wh, j:W:ww]
    return acc / (wh * ww)


def pool_2d(x: torch.Tensor, window: Tuple[int, int],
            pool_type: str) -> torch.Tensor:
    """Non-overlapping "avg" / "max" / "avg+max" (the sum) pooling of NCHW
    ``x`` over (H, W); odd sizes are floored.  A (1, 1) window is the
    identity for each pool, so "avg+max" then gives 2 * x."""
    def avg(v):
        if tuple(window) == (1, 1):
            return v
        if v.dtype == torch.bfloat16:
            return _avg_pool_bf16(v, tuple(window))
        return F.avg_pool2d(v, window)

    def max_(v):
        return v if tuple(window) == (1, 1) else F.max_pool2d(v, window)

    if pool_type == "avg":
        return avg(x)
    if pool_type == "max":
        return max_(x)
    if pool_type == "avg+max":
        return avg(x) + max_(x)
    raise ValueError(f"unknown pool type {pool_type!r}")


def batch_norm_mels(bn: nn.BatchNorm2d, lms: torch.Tensor,
                    compute_dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """BatchNorm over the mel bins of ``lms`` [B, T, M] (the M bins are
    the features; the norm itself in float32), returned as the NCHW image
    [B, 1, T, M] in ``compute_dtype``."""
    x = bn(lms.transpose(1, 2)[..., None])           # [B, M, T, 1]
    return narrow(x[..., 0].transpose(1, 2)[:, None], compute_dtype)


class GRU(nn.GRU):
    """``nn.GRU`` (batch first) whose ``forward(x, lens)`` has the
    pack-padded semantics of the reference encoders: each row runs over its
    first ``lens[b]`` steps only (the backward direction from its own last
    valid step), state is frozen and output zero past its length.  A row
    of length 0 gives zeros, as the JAX package's masked scan does
    (``pack_padded_sequence`` itself refuses a length of 0).  Without
    ``lens`` every row runs over the whole padded length.

    Its dtype is its input's, as in the JAX package (``h0`` takes
    ``x.dtype`` and ``x @ w_ih`` promotes to the float32 weights).  Both
    callers hand it float32 (the Cnn14 casts ``attn_emb`` to float32, the
    SED casts its fc1 output), so with ``compute_dtype=torch.bfloat16``
    every GRU of the port still runs in float32."""

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
