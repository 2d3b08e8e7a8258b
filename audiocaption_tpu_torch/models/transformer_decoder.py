"""Transformer caption decoder (counterpart of
``audiocaption_tpu/models/transformer_decoder.py``), inference only.

Two execution paths over one parameter set:

  * ``forward`` — full-sequence causal pass over [B, L] tokens;
  * ``init_cache`` + ``step`` — KV-cached single-token decode used by
    the decoding engine and mirrored by the fused CUDA kernels.

Semantics:
  * word embedding * sqrt(emb_dim) + positional table (max_len 100);
  * memory projection Linear -> ReLU -> (Dropout) -> LayerNorm;
  * n post-norm ``TransformerDecoderLayer``s (nhead = d/64, ff = 4d);
  * classifier without bias, optionally tied to the embedding.

``compute_dtype`` (float32 or bfloat16) follows the JAX package: the
embedding (float32 table, * sqrt(E) + PE) is cast to it, the memory
projection, the layers and an untied classifier run in it, the KV caches
are allocated in it, and ``step`` / ``forward`` return float32 logits of
a float32 hidden state (a tied classifier is a float32 product).

Module names follow the reference (``word_embedding``, ``attn_proj.0/3``,
``pos_encoder.pe`` [max_len, 1, E], ``model.layers.{i}.*``,
``classifier``) so its checkpoints load with ``load_state_dict``.  The
positional table is a loadable buffer: reference checkpoints carry a
random frozen table, not sinusoids.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from audiocaption_tpu_torch.models.layers import (
    LayerNorm, Linear, TransformerDecoderLayer, causal_mask,
    check_compute_dtype, narrow, sinusoidal_positions, widen)
from audiocaption_tpu_torch.ops.masking import length_mask


class PositionalEncoding(nn.Module):
    """Holds the loadable positional table ``pe`` [max_len, 1, E]."""

    def __init__(self, max_len: int, d_model: int):
        super().__init__()
        self.register_buffer("pe", torch.from_numpy(
            sinusoidal_positions(max_len, d_model))[:, None, :])


class _LayerStack(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class TransformerDecoder(nn.Module):
    def __init__(self, emb_dim: int, vocab_size: int, attn_emb_dim: int,
                 nlayers: int = 2, nhead: Optional[int] = None,
                 dim_feedforward: Optional[int] = None,
                 tie_weights: bool = False, max_pos: int = 100,
                 dropout: float = 0.2,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cd = self.compute_dtype = check_compute_dtype(compute_dtype)
        self.emb_dim, self.vocab_size = emb_dim, vocab_size
        self.nlayers = nlayers
        self.nhead = nhead if nhead is not None else emb_dim // 64
        self.dim_feedforward = (dim_feedforward if dim_feedforward is not None
                                else emb_dim * 4)
        self.tie_weights = tie_weights
        self.word_embedding = nn.Embedding(vocab_size, emb_dim)
        nn.init.xavier_uniform_(self.word_embedding.weight)
        self.attn_proj = nn.Sequential(
            Linear(attn_emb_dim, emb_dim, compute_dtype=cd), nn.ReLU(),
            nn.Dropout(dropout),
            LayerNorm(emb_dim, eps=1e-5, compute_dtype=cd))
        self.pos_encoder = PositionalEncoding(max_pos, emb_dim)
        self.model = _LayerStack(
            TransformerDecoderLayer(emb_dim, self.nhead, self.dim_feedforward,
                                    cd)
            for _ in range(nlayers))
        if not tie_weights:
            self.classifier = Linear(emb_dim, vocab_size, bias=False,
                                     compute_dtype=cd)

    @property
    def layers(self):
        return self.model.layers

    @property
    def pe(self) -> torch.Tensor:
        return self.pos_encoder.pe[:, 0, :]

    @property
    def classifier_weight(self) -> torch.Tensor:
        """[V, E] output projection (the embedding when tied)."""
        return (self.word_embedding.weight if self.tie_weights
                else self.classifier.weight)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """Float32 logits of the float32 hidden state ``h``."""
        if self.tie_weights:
            return F.linear(h, self.word_embedding.weight)
        return widen(self.classifier(h))

    def project_memory(self, attn_emb: torch.Tensor) -> torch.Tensor:
        return self.attn_proj(attn_emb)

    def embed(self, word: torch.Tensor, pos_offset: int = 0) -> torch.Tensor:
        e = self.word_embedding(word) * math.sqrt(self.emb_dim)
        T = word.shape[-1]
        return narrow(e + self.pe[pos_offset:pos_offset + T][None],
                      self.compute_dtype)

    def forward(self, word: torch.Tensor, attn_emb: torch.Tensor,
                attn_emb_len: torch.Tensor,
                cap_padding_mask: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """word [B, L] ids -> {logit [B, L, V], embed [B, L, E]}."""
        memory = self.project_memory(attn_emb)
        mem_kpm = ~length_mask(attn_emb_len, attn_emb.shape[1])
        x = self.embed(word)
        tgt_mask = causal_mask(word.shape[1], device=word.device)
        for layer in self.layers:
            x = layer(x, memory, tgt_mask=tgt_mask,
                      tgt_key_padding_mask=cap_padding_mask,
                      memory_key_padding_mask=mem_kpm)
        x = widen(x)
        return {"logit": self.logits(x), "embed": x}

    # ---------------------------------------------------------- decode ----

    def init_cache(self, attn_emb: torch.Tensor, attn_emb_len: torch.Tensor,
                   max_length: int) -> Tuple[Dict, Dict]:
        """Precompute memory K/V and allocate the self-attention caches.

        Returns (static, dynamic): ``static`` is read-only during decode,
        ``dynamic`` is the per-step state the engine threads and reorders.
        """
        B = attn_emb.shape[0]
        cache_dtype = narrow(attn_emb[:0], self.compute_dtype).dtype
        memory = self.project_memory(attn_emb)
        static = {"mem_kpm": ~length_mask(attn_emb_len, attn_emb.shape[1])}
        dyn = {}
        for i, layer in enumerate(self.layers):
            static[f"mem_k{i}"], static[f"mem_v{i}"] = \
                layer.precompute_memory(memory)
            for name in ("self_k", "self_v"):
                dyn[f"{name}{i}"] = attn_emb.new_zeros(
                    B, max_length, self.emb_dim, dtype=cache_dtype)
        dyn["self_pad"] = torch.zeros(B, max_length, dtype=torch.bool,
                                      device=attn_emb.device)
        return static, dyn

    def step(self, word_t: torch.Tensor, t: int, static: Dict, dyn: Dict,
             is_pad_t: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict]:
        """One decode step: word_t [B] ids -> (logit [B, V], dyn).  The
        caches in ``dyn`` are updated in place at row ``t``."""
        L = dyn["self_k0"].shape[1]
        if is_pad_t is None:
            is_pad_t = torch.zeros_like(word_t, dtype=torch.bool)
        dyn["self_pad"][:, t] = is_pad_t
        positions = torch.arange(L, device=word_t.device)
        kpm = (positions[None, :] > t) | dyn["self_pad"]
        x = self.embed(word_t[:, None], t)[:, 0]
        for i, layer in enumerate(self.layers):
            x = layer.step(x, t, dyn[f"self_k{i}"], dyn[f"self_v{i}"], kpm,
                           static[f"mem_k{i}"], static[f"mem_v{i}"],
                           static["mem_kpm"])
        return self.logits(widen(x)), dyn
