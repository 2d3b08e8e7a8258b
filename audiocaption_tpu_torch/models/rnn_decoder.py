"""Bahdanau-attention GRU caption decoders (counterpart of
``audiocaption_tpu/models/rnn_decoder.py``: ``Seq2SeqAttention``,
``BahAttnCatFcDecoder``, ``TemporalBahAttnDecoder``).

Decoding is step-wise through the torch engine (``decoding/engine.py``):
``init_cache`` returns (static, dynamic) caches and ``step`` maps a word
per row to logits.  The dynamic cache is {state [N, 1, H] (one GRU
layer), attn_weight [N, S]}, so the beam's parent gather on axis 0
reorders it.
Parameter names follow the reference (``word_embedding``, ``model`` (an
``nn.GRU``), ``attn.h2attn``, ``attn.v``, ``fc_proj``, ``ctx_proj``,
``classifier``, ``temporal_embedding``).  In ``train()`` the input
embedding of each step (the word's, or the tag's at t=0) takes dropout,
the JAX decoders' only dropout.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from audiocaption_tpu_torch.ops.masking import length_mask

ATTN_FILL = -1e10   # the reference's padding fill (not -inf)


class Seq2SeqAttention(nn.Module):
    """Additive attention: score = v . tanh(h2attn([h_dec; h_enc])),
    padded positions filled with -1e10 before the softmax.

    ``h2attn`` is one Linear over the concatenation; its encoder half is
    applied once per decode (:meth:`project_memory`) and its decoder half
    once per step."""

    def __init__(self, hs_dec: int, hs_enc: int, attn_size: int):
        super().__init__()
        self.hs_dec = hs_dec
        self.h2attn = nn.Linear(hs_dec + hs_enc, attn_size)
        self.v = nn.Parameter(torch.randn(attn_size))

    def project_memory(self, h_enc: torch.Tensor) -> torch.Tensor:
        """h_enc [N, S, hs_enc] -> its h2attn term (bias included)."""
        return torch.matmul(h_enc, self.h2attn.weight[:, self.hs_dec:].T) \
            + self.h2attn.bias

    def forward(self, h_dec: torch.Tensor, h_enc: torch.Tensor,
                enc_proj: torch.Tensor, src_lens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """h_dec [N, hs_dec]; h_enc [N, S, E]; enc_proj from
        :meth:`project_memory` -> (ctx [N, E], weights [N, S])."""
        q = torch.matmul(h_dec, self.h2attn.weight[:, :self.hs_dec].T)
        score = torch.matmul(torch.tanh(enc_proj + q[:, None]), self.v)
        score = score.masked_fill(~length_mask(src_lens, h_enc.shape[1]),
                                  ATTN_FILL)
        weights = torch.softmax(score, dim=-1)
        return torch.einsum("ns,nse->ne", weights, h_enc), weights


class BahAttnCatFcDecoder(nn.Module):
    """GRU input cat(word_emb, ctx_proj(ctx), fc_proj(fc_emb)) -> one-layer
    GRU -> classifier.  The attention query is the previous step's hidden
    state (zeros at t=0); the attention size is d_model."""

    def __init__(self, emb_dim: int, vocab_size: int, fc_emb_dim: int,
                 attn_emb_dim: int, d_model: int, dropout: float = 0.5):
        super().__init__()
        self.vocab_size, self.d_model = vocab_size, d_model
        self.dropout = dropout
        self.word_embedding = nn.Embedding(vocab_size, emb_dim)
        self.model = nn.GRU(3 * emb_dim, d_model, batch_first=True)
        self.attn = Seq2SeqAttention(d_model, attn_emb_dim, d_model)
        self.fc_proj = nn.Linear(fc_emb_dim, emb_dim)
        self.ctx_proj = nn.Linear(attn_emb_dim, emb_dim)
        self.classifier = nn.Linear(d_model, vocab_size)

    def init_cache(self, attn_emb: torch.Tensor, attn_emb_len: torch.Tensor,
                   fc_emb: torch.Tensor, max_length: int
                   ) -> Tuple[Dict, Dict]:
        """-> (static, dynamic) caches; the state starts at zeros."""
        N, S = attn_emb.shape[:2]
        static = {"attn_emb": attn_emb, "attn_emb_len": attn_emb_len,
                  "enc_proj": self.attn.project_memory(attn_emb),
                  "p_fc": self.fc_proj(fc_emb)}
        dyn = {"state": attn_emb.new_zeros(N, 1, self.d_model),
               "attn_weight": attn_emb.new_zeros(N, S)}
        return static, dyn

    def embed_input(self, word_t: torch.Tensor, t: int,
                    static: Dict) -> torch.Tensor:
        return self.word_embedding(word_t)

    def step(self, word_t: torch.Tensor, t: int, static: Dict, dyn: Dict
             ) -> Tuple[torch.Tensor, Dict]:
        """word_t [N] -> (logit [N, V], new dynamic cache)."""
        state = dyn["state"]                               # [N, 1, H]
        ctx, attn_weight = self.attn(state[:, 0], static["attn_emb"],
                                     static["enc_proj"],
                                     static["attn_emb_len"])
        embed = F.dropout(self.embed_input(word_t, t, static), self.dropout,
                          self.training)
        rnn_in = torch.cat([embed, self.ctx_proj(ctx), static["p_fc"]],
                           dim=-1)
        out, h = self.model(rnn_in[:, None],
                            state.transpose(0, 1).contiguous())
        return self.classifier(out[:, 0]), {"state": h.transpose(0, 1),
                                            "attn_weight": attn_weight}


class TemporalBahAttnDecoder(BahAttnCatFcDecoder):
    """At t=0 the input embedding is ``temporal_embedding(tag)`` (4 tags:
    single, simultaneous, sequential, complex) instead of <bos>'s."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.temporal_embedding = nn.Embedding(
            4, self.word_embedding.embedding_dim)

    def init_cache(self, attn_emb: torch.Tensor, attn_emb_len: torch.Tensor,
                   fc_emb: torch.Tensor, max_length: int,
                   temporal_tag: Optional[torch.Tensor] = None
                   ) -> Tuple[Dict, Dict]:
        static, dyn = super().init_cache(attn_emb, attn_emb_len, fc_emb,
                                         max_length)
        if temporal_tag is None:
            temporal_tag = torch.zeros(attn_emb.shape[0], dtype=torch.long,
                                       device=attn_emb.device)
        static["temporal_tag"] = temporal_tag.to(attn_emb.device).long()
        return static, dyn

    def embed_input(self, word_t: torch.Tensor, t: int,
                    static: Dict) -> torch.Tensor:
        if t == 0:
            return self.temporal_embedding(static["temporal_tag"])
        return self.word_embedding(word_t)
