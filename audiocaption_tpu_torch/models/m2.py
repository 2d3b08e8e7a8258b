"""Meshed-memory (M2) transformer encoder and decoder (counterpart of
``audiocaption_tpu/models/m2.py``; Cornia et al., "Meshed-Memory
Transformer for Image Captioning", CVPR 2020, which the reference wraps
from the ``m2transformer`` package).

  * :class:`M2Attention`: projections, scaled dot product over the keys
    and ``n_memory`` learned, unmasked memory slots (``m_k`` drawn from
    N(0, (1/d_k)^2), ``m_v`` from N(0, (1/m)^2), rescaled by sqrt(d_k) /
    sqrt(m) where they are used), the output projection, dropout, and
    the post-LN residual on the queries: ``LN(q + dropout(out))``;
  * :class:`M2FeedForward`: ``LN(x + dropout(fc2(dropout(relu(fc1(x))))))``;
  * :class:`M2TransformerEncoder`: over precomputed features
    ``[B, T, D]``: relu(Linear) -> dropout -> LayerNorm, then ``nlayers``
    memory-augmented layers; ``attn_emb`` stacks every layer's output,
    ``[B, nlayers, T, d]``, and ``fc_emb`` is its (unmasked) mean over T;
  * :class:`M2TransformerDecoder`: each layer self-attends over the
    caption prefix, cross-attends to every encoder level through one
    shared attention block, and sums the levels' contexts under sigmoid
    gates ``alpha_j = sigmoid(W_j [self; ctx_j] + b_j)``, one gate per
    level (``n_enc_levels``), divided by sqrt(n_levels); positions are
    1-based, pads on the zeroed row 0 of the sinusoid table.

The decoder keeps the :class:`TransformerDecoder` protocol (``forward``
for teacher forcing, ``init_cache`` / ``step_hidden`` / ``step`` /
``logits`` for the engine and the scheduled-sampling loop), so greedy,
beam and DBS run on the port's torch engine.  It is a subclass of
``TransformerDecoder`` with parameters of its own; the fused decode
kernels take ``type(decoder) is TransformerDecoder`` only
(``decoding/select.py``), so M2 never reaches them.

Padding of the features comes from ``attn_len`` (an additive -1e9 on the
padded keys), as in the JAX package.  Module names follow the JAX tree
(``layer{i}_attn``, ``layer{i}_alpha{j}``, ``pe`` ...), so its variables
convert by ``models/convert.py::jax_tree_state_dict``.  Linear weights
are drawn Xavier-uniform with zero biases, as the JAX modules draw them
(``xavier_init``, read by ``zoo.random_init``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from audiocaption_tpu_torch.models.layers import (
    LayerNorm, Linear, check_compute_dtype, narrow, put_row,
    sinusoidal_positions, widen)
from audiocaption_tpu_torch.models.transformer_decoder import (
    TransformerDecoder)
from audiocaption_tpu_torch.ops.masking import length_mask

NEG_BIAS = -1e9


def _xavier_linear(d_in: int, d_out: int, cd: torch.dtype) -> Linear:
    lin = Linear(d_in, d_out, compute_dtype=cd)
    lin.xavier_init = True
    nn.init.xavier_uniform_(lin.weight)
    nn.init.zeros_(lin.bias)
    return lin


def _split_heads(x: torch.Tensor, nhead: int) -> torch.Tensor:
    """[B, T, d] -> [B, h, T, d_h]."""
    B, T, d = x.shape
    return x.reshape(B, T, nhead, d // nhead).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, h, T, d_h] -> [B, T, d]."""
    B, h, T, dh = x.shape
    return x.transpose(1, 2).reshape(B, T, h * dh)


def _bias(ok: torch.Tensor) -> torch.Tensor:
    """A boolean key mask -> the additive float32 bias (0 / NEG_BIAS)."""
    return torch.where(ok, 0.0, NEG_BIAS).float()


class M2Attention(nn.Module):
    """The package's ``MultiHeadAttention`` with optional memory slots."""

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.1,
                 n_memory: int = 0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cd = self.compute_dtype = check_compute_dtype(compute_dtype)
        self.d_model, self.nhead = d_model, nhead
        self.dropout, self.n_memory = dropout, n_memory
        for name in ("fc_q", "fc_k", "fc_v", "fc_o"):
            setattr(self, name, _xavier_linear(d_model, d_model, cd))
        self.norm = LayerNorm(d_model, compute_dtype=cd)
        if n_memory:
            d_k = d_model // nhead
            self.m_k = nn.Parameter(torch.randn(n_memory, d_model) / d_k)
            self.m_v = nn.Parameter(torch.randn(n_memory, d_model)
                                    / n_memory)

    def project_kv(self, kv: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Projected keys and values, without the memory slots."""
        return self.fc_k(kv), self.fc_v(kv)

    def memory_kv(self, B: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The rescaled memory slots, broadcast to the batch."""
        d_k = self.d_model // self.nhead
        mk = narrow(math.sqrt(d_k) * self.m_k, self.compute_dtype)
        mv = narrow(math.sqrt(self.n_memory) * self.m_v, self.compute_dtype)
        return (mk[None].expand(B, -1, -1), mv[None].expand(B, -1, -1))

    def attend(self, q_in: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               key_bias: Optional[torch.Tensor]) -> torch.Tensor:
        """q_in [B, Tq, d]; k, v [B, S, d] (memory slots appended by the
        caller); key_bias [B, Tq or 1, S] additive, float32."""
        d_k = self.d_model // self.nhead
        q = _split_heads(self.fc_q(q_in), self.nhead)
        scores = (q @ _split_heads(k, self.nhead).transpose(-1, -2)
                  / math.sqrt(d_k)).float()
        if key_bias is not None:
            scores = scores + key_bias[:, None]
        att = narrow(F.softmax(scores, dim=-1), self.compute_dtype)
        out = self.fc_o(_merge_heads(att @ _split_heads(v, self.nhead)))
        out = F.dropout(out, self.dropout, self.training)
        return self.norm(narrow(q_in, self.compute_dtype) + out)

    def forward(self, q_in: torch.Tensor, kv: torch.Tensor,
                key_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        k, v = self.project_kv(kv)
        if self.n_memory:
            mk, mv = self.memory_kv(q_in.shape[0])
            k, v = torch.cat([k, mk], 1), torch.cat([v, mv], 1)
            if key_bias is not None:
                key_bias = F.pad(key_bias, (0, self.n_memory))
        return self.attend(q_in, k, v, key_bias)


class M2FeedForward(nn.Module):
    """The package's ``PositionWiseFeedForward``."""

    def __init__(self, d_model: int, dim_feedforward: int,
                 dropout: float = 0.1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cd = self.compute_dtype = check_compute_dtype(compute_dtype)
        self.dropout = dropout
        self.fc1 = _xavier_linear(d_model, dim_feedforward, cd)
        self.fc2 = _xavier_linear(dim_feedforward, d_model, cd)
        self.norm = LayerNorm(d_model, compute_dtype=cd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = narrow(x, self.compute_dtype)
        h = F.dropout(F.relu(self.fc1(x)), self.dropout, self.training)
        h = F.dropout(self.fc2(h), self.dropout, self.training)
        return self.norm(x + h)


class M2TransformerEncoder(nn.Module):
    """Memory-augmented multi-level encoder over precomputed features
    ``[B, T, input_dim]`` -> {attn_emb [B, nlayers, T, d_model], attn_emb_len,
    fc_emb [B, nlayers, d_model]} (float32)."""

    def __init__(self, input_dim: int, d_model: int, nlayers: int = 2,
                 nhead: Optional[int] = None,
                 dim_feedforward: Optional[int] = None,
                 dropout: float = 0.1, n_memory: int = 40,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cd = self.compute_dtype = check_compute_dtype(compute_dtype)
        nhead = nhead or d_model // 64
        ff = dim_feedforward or d_model * 4
        self.nlayers, self.dropout = nlayers, dropout
        self.input_proj = _xavier_linear(input_dim, d_model, cd)
        self.input_norm = LayerNorm(d_model, compute_dtype=cd)
        for i in range(nlayers):
            setattr(self, f"layer{i}_attn", M2Attention(
                d_model, nhead, dropout, n_memory=n_memory, compute_dtype=cd))
            setattr(self, f"layer{i}_ff", M2FeedForward(d_model, ff, dropout,
                                                        cd))
        self.fc_emb_size = self.attn_emb_size = d_model

    def forward(self, attn: torch.Tensor, attn_len: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        x = F.relu(self.input_proj(attn))
        x = self.input_norm(F.dropout(x, self.dropout, self.training))
        B, T = attn.shape[:2]
        key_bias = _bias(length_mask(attn_len, T))[:, None, :].expand(
            B, T, T)
        levels = []
        for i in range(self.nlayers):
            x = getattr(self, f"layer{i}_attn")(x, x, key_bias)
            x = getattr(self, f"layer{i}_ff")(x)
            levels.append(x)
        attn_emb = widen(torch.stack(levels, 1))
        return {"attn_emb": attn_emb, "attn_emb_len": attn_len,
                "fc_emb": attn_emb.mean(-2)}


class M2TransformerDecoder(TransformerDecoder):
    """Meshed decoder (see the module docstring).  ``emb_dim`` is the
    package's ``d_model``; ``attn_emb`` is the encoder's ``[B, n_levels,
    S, d]``."""

    def __init__(self, emb_dim: int, vocab_size: int, nlayers: int = 2,
                 nhead: Optional[int] = None,
                 dim_feedforward: Optional[int] = None,
                 dropout: float = 0.1, n_enc_levels: int = 2,
                 max_pos: int = 100,
                 compute_dtype: torch.dtype = torch.float32):
        nn.Module.__init__(self)        # its own parameters, not the base's
        cd = self.compute_dtype = check_compute_dtype(compute_dtype)
        d = self.emb_dim = emb_dim
        self.vocab_size, self.nlayers = vocab_size, nlayers
        self.nhead = nhead if nhead is not None else emb_dim // 64
        self.dim_feedforward = (dim_feedforward if dim_feedforward is not None
                                else emb_dim * 4)
        self.dropout, self.n_enc_levels = dropout, n_enc_levels
        self.tie_weights = False
        self.word_embedding = nn.Embedding(vocab_size, d)
        nn.init.xavier_uniform_(self.word_embedding.weight)
        pe = torch.from_numpy(sinusoidal_positions(max_pos + 1, d))
        pe[0] = 0.0
        self.register_buffer("pe", pe)
        for i in range(nlayers):
            setattr(self, f"layer{i}_self", M2Attention(d, self.nhead,
                                                        dropout,
                                                        compute_dtype=cd))
            setattr(self, f"layer{i}_cross", M2Attention(d, self.nhead,
                                                         dropout,
                                                         compute_dtype=cd))
            for j in range(n_enc_levels):
                setattr(self, f"layer{i}_alpha{j}", _xavier_linear(2 * d, d,
                                                                   cd))
            setattr(self, f"layer{i}_ff", M2FeedForward(
                d, self.dim_feedforward, dropout, cd))
        self.classifier = _xavier_linear(d, vocab_size, cd)

    @property
    def pe(self) -> torch.Tensor:
        """The positional table [max_pos + 1, d], a buffer (the base
        class's ``pe`` is a view of another module's)."""
        try:
            return self._buffers["pe"]
        except KeyError:
            raise AttributeError("pe") from None

    @property
    def classifier_weight(self) -> torch.Tensor:
        return self.classifier.weight

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        return widen(self.classifier(h))

    def _embed(self, word: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        return narrow(self.word_embedding(word) + self.pe[pos],
                      self.compute_dtype)

    def _meshed_cross(self, i: int, sa: torch.Tensor, level_kv,
                      key_bias: torch.Tensor,
                      mask_pad: Optional[torch.Tensor]) -> torch.Tensor:
        """The shared cross-attention over every level, gated and summed."""
        cross = getattr(self, f"layer{i}_cross")
        out = 0.0
        for j, (k, v) in enumerate(level_kv):
            c = cross.attend(sa, k, v, key_bias)
            if mask_pad is not None:
                c = c * mask_pad
            alpha = torch.sigmoid(getattr(self, f"layer{i}_alpha{j}")(
                torch.cat([sa, c], -1)))
            out = out + alpha * c
        out = out / math.sqrt(self.n_enc_levels)
        return out if mask_pad is None else out * mask_pad

    def forward(self, word: torch.Tensor, attn_emb: torch.Tensor,
                attn_emb_len: torch.Tensor,
                cap_padding_mask: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """word [B, T] ids, attn_emb [B, n_levels, S, d] -> {logit [B, T,
        V], embed [B, T, d]}."""
        B, T = word.shape
        S = attn_emb.shape[2]
        if cap_padding_mask is None:
            cap_padding_mask = torch.zeros_like(word, dtype=torch.bool)
        mask_pad = narrow((~cap_padding_mask)[:, :, None].float(),
                          self.compute_dtype)
        pos = torch.where(cap_padding_mask, 0, torch.arange(
            1, T + 1, device=word.device)[None])
        x = self._embed(word, pos)
        causal = torch.ones(T, T, dtype=torch.bool,
                            device=word.device).tril()
        sa_bias = _bias(causal[None] & (~cap_padding_mask)[:, None, :])
        mem_bias = _bias(length_mask(attn_emb_len, S))[:, None, :].expand(
            B, T, S)
        for i in range(self.nlayers):
            sa = getattr(self, f"layer{i}_self")(x, x, sa_bias) * mask_pad
            cross = getattr(self, f"layer{i}_cross")
            level_kv = [cross.project_kv(attn_emb[:, j])
                        for j in range(self.n_enc_levels)]
            mc = self._meshed_cross(i, sa, level_kv, mem_bias, mask_pad)
            x = getattr(self, f"layer{i}_ff")(mc) * mask_pad
        x = widen(x)
        return {"logit": self.logits(x), "embed": x}

    # ---------------------------------------------------------- decode ----

    def init_cache(self, attn_emb: torch.Tensor, attn_emb_len: torch.Tensor,
                   max_length: int, fc_emb: Optional[torch.Tensor] = None
                   ) -> Tuple[Dict, Dict]:
        """Every level's cross K/V per layer and the mask bias (static);
        the self-attention caches and pad flags (dynamic)."""
        B, n_levels, S, _ = attn_emb.shape
        cache_dtype = narrow(attn_emb[:0], self.compute_dtype).dtype
        static = {"mem_bias": _bias(length_mask(attn_emb_len, S))[:, None]}
        dyn = {}
        for i in range(self.nlayers):
            cross = getattr(self, f"layer{i}_cross")
            for j in range(n_levels):
                static[f"mem_k{i}_{j}"], static[f"mem_v{i}_{j}"] = \
                    cross.project_kv(attn_emb[:, j])
            for name in ("self_k", "self_v"):
                dyn[f"{name}{i}"] = attn_emb.new_zeros(
                    B, max_length, self.emb_dim, dtype=cache_dtype)
        dyn["self_pad"] = torch.zeros(B, max_length, dtype=torch.bool,
                                      device=attn_emb.device)
        return static, dyn

    def step_hidden(self, word_t: torch.Tensor, t: int, static: Dict,
                    dyn: Dict, is_pad_t: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict]:
        """One decode step up to the float32 hidden state [B, d]; row
        ``t`` of the caches written (in place when autograd is off,
        ``layers.put_row``)."""
        L = dyn["self_k0"].shape[1]
        if is_pad_t is None:
            is_pad_t = torch.zeros_like(word_t, dtype=torch.bool)
        row = min(t, L - 1)
        self_pad = put_row(dyn["self_pad"], row, is_pad_t)
        pos = torch.where(is_pad_t, 0, t + 1)
        x = self._embed(word_t, pos)[:, None]
        ok = (torch.arange(L, device=word_t.device)[None] <= t) & ~self_pad
        sa_bias = _bias(ok)[:, None]
        dyn = dict(dyn, self_pad=self_pad)
        for i in range(self.nlayers):
            att = getattr(self, f"layer{i}_self")
            k_t, v_t = att.project_kv(x)
            dyn[f"self_k{i}"] = put_row(dyn[f"self_k{i}"], row, k_t[:, 0])
            dyn[f"self_v{i}"] = put_row(dyn[f"self_v{i}"], row, v_t[:, 0])
            sa = att.attend(x, dyn[f"self_k{i}"], dyn[f"self_v{i}"], sa_bias)
            level_kv = [(static[f"mem_k{i}_{j}"], static[f"mem_v{i}_{j}"])
                        for j in range(self.n_enc_levels)]
            mc = self._meshed_cross(i, sa, level_kv, static["mem_bias"], None)
            x = getattr(self, f"layer{i}_ff")(mc)
        return widen(x[:, 0]), dyn

    def step(self, word_t: torch.Tensor, t: int, static: Dict, dyn: Dict,
             is_pad_t: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict]:
        x, dyn = self.step_hidden(word_t, t, static, dyn, is_pad_t)
        return self.logits(x), dyn
