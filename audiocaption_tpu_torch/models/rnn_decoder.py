"""GRU caption decoders (counterpart of
``audiocaption_tpu/models/rnn_decoder.py``): ``Seq2SeqAttention``, the
Bahdanau-attention decoders ``BahAttnCatFcDecoder``,
``TemporalBahAttnDecoder``, ``BahAttnAddFcDecoder``, ``BahAttnDecoder``,
``ConditionalBahAttnDecoder``, ``StyleBahAttnDecoder``,
``SpecificityBahAttnDecoder`` and ``StructBahAttnDecoder``, and the
attention-free ``RnnFcDecoder``.

Decoding is step-wise through the torch engine (``decoding/engine.py``):
``init_cache`` returns (static, dynamic) caches and ``step`` maps a word
per row to logits.  The dynamic cache is {state [N, L, H] (every GRU
layer's state), attn_weight [N, S]}, so the beam's parent gather on axis
0 reorders it.  A conditioned decoder takes its condition as an
``init_cache`` keyword: ``temporal_tag`` [N] ints, ``condition`` [N]
floats, ``style`` [N, emb_dim], ``structure`` [N] ints.

The GRU is one ``nn.GRU`` of ``num_layers`` layers run one step at a
time, with no dropout between its layers (the JAX ``GRUCellStack``).
The attention query is every layer's previous state concatenated,
[N, L * H] (zeros at t=0), so ``h2attn`` reads ``num_layers * d_model +
memory width`` inputs.  The attention size is ``attn_size`` or d_model.

Parameter names follow the reference (the JAX ``convert_bahattn_decoder``:
``word_embedding``, ``model`` (an ``nn.GRU``), ``attn.h2attn``,
``attn.v``, ``fc_proj``, ``ctx_proj``, ``classifier``,
``temporal_embedding``); the variants' own modules keep the JAX names
(``attn_proj``, ``condition_embedding``, ``struct_embedding``).  In
``train()`` the input embedding of each step (the word's, or the tag's
at t=0) takes dropout, the JAX decoders' only dropout.
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


class RnnDecoder(nn.Module):
    """What every GRU decoder shares: ``word_embedding``, the GRU stack
    ``model`` over ``rnn_input`` features, ``classifier``, the dropout of
    the input embedding, and the GRU step."""

    def __init__(self, emb_dim: int, vocab_size: int, d_model: int,
                 rnn_input: int, dropout: float = 0.5, num_layers: int = 1):
        super().__init__()
        self.emb_dim, self.vocab_size, self.d_model = emb_dim, vocab_size, \
            d_model
        self.dropout, self.num_layers = dropout, num_layers
        self.word_embedding = nn.Embedding(vocab_size, emb_dim)
        self.model = nn.GRU(rnn_input, d_model, num_layers=num_layers,
                            batch_first=True)

    def zero_state(self, ref: torch.Tensor) -> torch.Tensor:
        """The initial state [N, L, H] on ``ref``'s device."""
        return ref.new_zeros(ref.shape[0], self.num_layers, self.d_model)

    def embed_input(self, word_t: torch.Tensor, t: int,
                    static: Dict) -> torch.Tensor:
        return F.dropout(self.word_embedding(word_t), self.dropout,
                         self.training)

    def gru_step(self, rnn_in: torch.Tensor, state: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """rnn_in [N, I], state [N, L, H] -> (logit [N, V], new state)."""
        out, h = self.model(rnn_in[:, None],
                            state.transpose(0, 1).contiguous())
        return self.classifier(out[:, 0]), h.transpose(0, 1)


class RnnFcDecoder(RnnDecoder):
    """GRU input cat(word_emb, fc_proj(fc_emb)): no attention; the cache
    holds the state only."""

    def __init__(self, emb_dim: int, vocab_size: int, fc_emb_dim: int,
                 d_model: int, attn_emb_dim: int = 0, dropout: float = 0.5,
                 num_layers: int = 1):
        super().__init__(emb_dim, vocab_size, d_model, 2 * emb_dim, dropout,
                         num_layers)
        self.fc_proj = nn.Linear(fc_emb_dim, emb_dim)
        self.classifier = nn.Linear(d_model, vocab_size)

    def init_cache(self, attn_emb: torch.Tensor, attn_emb_len: torch.Tensor,
                   fc_emb: torch.Tensor, max_length: int
                   ) -> Tuple[Dict, Dict]:
        return {"p_fc": self.fc_proj(fc_emb)}, {"state": self.zero_state(
            fc_emb)}

    def step(self, word_t: torch.Tensor, t: int, static: Dict, dyn: Dict,
             is_pad_t: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict]:
        rnn_in = torch.cat([self.embed_input(word_t, t, static),
                            static["p_fc"]], dim=-1)
        logit, state = self.gru_step(rnn_in, dyn["state"])
        return logit, {"state": state}


class BahAttnCatFcDecoder(RnnDecoder):
    """GRU input cat(word_emb, ctx_proj(ctx), fc_proj(fc_emb)) -> GRU stack
    -> classifier.  The attention query is the previous step's state of
    every layer (zeros at t=0).

    The variants change three hooks: the memory the attention reads
    (:meth:`memory`), the static "fc slot" (:meth:`fc_slot`, None for
    none) and the GRU input (:meth:`rnn_input`)."""

    def __init__(self, emb_dim: int, vocab_size: int, fc_emb_dim: int,
                 attn_emb_dim: int, d_model: int, dropout: float = 0.5,
                 num_layers: int = 1, attn_size: Optional[int] = None):
        super().__init__(emb_dim, vocab_size, d_model,
                         self.rnn_input_size(emb_dim, attn_emb_dim), dropout,
                         num_layers)
        self.attn = Seq2SeqAttention(num_layers * d_model,
                                     self.memory_size(emb_dim, attn_emb_dim),
                                     attn_size or d_model)
        self.build_slots(emb_dim, fc_emb_dim, attn_emb_dim)
        self.classifier = nn.Linear(d_model, vocab_size)

    # -- the hooks of the variants --
    @staticmethod
    def rnn_input_size(emb_dim: int, attn_emb_dim: int) -> int:
        return 3 * emb_dim

    @staticmethod
    def memory_size(emb_dim: int, attn_emb_dim: int) -> int:
        return attn_emb_dim

    def build_slots(self, emb_dim: int, fc_emb_dim: int,
                    attn_emb_dim: int) -> None:
        self.fc_proj = nn.Linear(fc_emb_dim, emb_dim)
        self.ctx_proj = nn.Linear(attn_emb_dim, emb_dim)

    def memory(self, attn_emb: torch.Tensor) -> torch.Tensor:
        return attn_emb

    def fc_slot(self, fc_emb: torch.Tensor, **cond) -> Optional[torch.Tensor]:
        return self.fc_proj(fc_emb)

    def rnn_input(self, embed: torch.Tensor, ctx: torch.Tensor,
                  static: Dict) -> torch.Tensor:
        return torch.cat([embed, self.ctx_proj(ctx), static["p_fc"]], dim=-1)

    # -- the engine's contract --
    def init_cache(self, attn_emb: torch.Tensor, attn_emb_len: torch.Tensor,
                   fc_emb: torch.Tensor, max_length: int, **cond
                   ) -> Tuple[Dict, Dict]:
        """-> (static, dynamic) caches; the state starts at zeros.
        ``cond`` holds the variant's condition keyword, if any."""
        mem = self.memory(attn_emb)
        static = {"attn_emb": mem, "attn_emb_len": attn_emb_len,
                  "enc_proj": self.attn.project_memory(mem)}
        p_fc = self.fc_slot(fc_emb, **cond)
        if p_fc is not None:
            static["p_fc"] = p_fc
        dyn = {"state": self.zero_state(attn_emb),
               "attn_weight": attn_emb.new_zeros(attn_emb.shape[:2])}
        return static, dyn

    def step(self, word_t: torch.Tensor, t: int, static: Dict, dyn: Dict,
             is_pad_t: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict]:
        """word_t [N] -> (logit [N, V], new dynamic cache); ``is_pad_t``
        is the transformer step's keyword, which a GRU step ignores."""
        state = dyn["state"]                               # [N, L, H]
        ctx, attn_weight = self.attn(state.reshape(state.shape[0], -1),
                                     static["attn_emb"], static["enc_proj"],
                                     static["attn_emb_len"])
        embed = self.embed_input(word_t, t, static)
        logit, state = self.gru_step(self.rnn_input(embed, ctx, static),
                                     state)
        return logit, {"state": state, "attn_weight": attn_weight}


class TemporalBahAttnDecoder(BahAttnCatFcDecoder):
    """At t=0 the input embedding is ``temporal_embedding(tag)`` (4 tags:
    single, simultaneous, sequential, complex) instead of <bos>'s; without
    a tag every row takes tag 0, as in the JAX package."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.temporal_embedding = nn.Embedding(4, self.emb_dim)

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
        emb = (self.temporal_embedding(static["temporal_tag"]) if t == 0
               else self.word_embedding(word_t))
        return F.dropout(emb, self.dropout, self.training)


class BahAttnAddFcDecoder(BahAttnCatFcDecoder):
    """GRU input word_emb + ctx + fc_proj(fc_emb), the attention over the
    memory projected to emb_dim (``attn_proj``)."""

    @staticmethod
    def rnn_input_size(emb_dim: int, attn_emb_dim: int) -> int:
        return emb_dim

    @staticmethod
    def memory_size(emb_dim: int, attn_emb_dim: int) -> int:
        return emb_dim

    def build_slots(self, emb_dim: int, fc_emb_dim: int,
                    attn_emb_dim: int) -> None:
        self.fc_proj = nn.Linear(fc_emb_dim, emb_dim)
        self.attn_proj = nn.Linear(attn_emb_dim, emb_dim)

    def memory(self, attn_emb: torch.Tensor) -> torch.Tensor:
        return self.attn_proj(attn_emb)

    def rnn_input(self, embed, ctx, static):
        return embed + ctx + static["p_fc"]


class BahAttnDecoder(BahAttnCatFcDecoder):
    """GRU input cat(word_emb, ctx_proj(ctx)): no fc slot (``fc_proj``
    exists, as in the JAX tree, and is not used)."""

    @staticmethod
    def rnn_input_size(emb_dim: int, attn_emb_dim: int) -> int:
        return 2 * emb_dim

    def fc_slot(self, fc_emb, **cond):
        return None

    def rnn_input(self, embed, ctx, static):
        return torch.cat([embed, self.ctx_proj(ctx)], dim=-1)


class ConditionalBahAttnDecoder(BahAttnCatFcDecoder):
    """The fc slot is a soft two-class condition embedding,
    [1 - c, c] @ ``condition_embedding`` (c = 0 without a condition)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.condition_embedding = nn.Embedding(2, self.emb_dim)

    def fc_slot(self, fc_emb: torch.Tensor,
                condition: Optional[torch.Tensor] = None):
        if condition is None:
            condition = fc_emb.new_zeros(fc_emb.shape[0])
        c = condition.to(fc_emb.device, fc_emb.dtype)
        soft = torch.stack([1.0 - c, c], dim=-1)
        return soft @ self.condition_embedding.weight


class StyleBahAttnDecoder(BahAttnCatFcDecoder):
    """The fc slot is the caller's style vector [N, emb_dim], or
    ``fc_proj(fc_emb)`` without one."""

    def fc_slot(self, fc_emb: torch.Tensor,
                style: Optional[torch.Tensor] = None):
        return self.fc_proj(fc_emb) if style is None else style


class SpecificityBahAttnDecoder(BahAttnCatFcDecoder):
    """GRU input cat(word_emb, ctx, condition): the raw context and a
    scalar condition per row (0 without one); no fc or context
    projection."""

    @staticmethod
    def rnn_input_size(emb_dim: int, attn_emb_dim: int) -> int:
        return emb_dim + attn_emb_dim + 1

    def build_slots(self, emb_dim, fc_emb_dim, attn_emb_dim) -> None:
        pass

    def fc_slot(self, fc_emb: torch.Tensor,
                condition: Optional[torch.Tensor] = None):
        if condition is None:
            condition = fc_emb.new_zeros(fc_emb.shape[0])
        return condition.to(fc_emb.device, fc_emb.dtype)

    def rnn_input(self, embed, ctx, static):
        return torch.cat([embed, ctx, static["p_fc"][:, None]], dim=-1)


class StructBahAttnDecoder(BahAttnCatFcDecoder):
    """The fc slot is a learned embedding of the row's structure id
    (``struct_vocab_size`` ids, 0 without one)."""

    def __init__(self, *args, struct_vocab_size: int = 4, **kwargs):
        super().__init__(*args, **kwargs)
        self.struct_embedding = nn.Embedding(struct_vocab_size, self.emb_dim)

    def fc_slot(self, fc_emb: torch.Tensor,
                structure: Optional[torch.Tensor] = None):
        if structure is None:
            structure = torch.zeros(fc_emb.shape[0], dtype=torch.long,
                                    device=fc_emb.device)
        return self.struct_embedding(structure.to(fc_emb.device).long())
