"""Transformer caption decoder (counterpart of
``audiocaption_tpu/models/transformer_decoder.py``).

Two execution paths over one parameter set:

  * ``forward`` — full-sequence causal pass over [B, L] tokens;
  * ``init_cache`` + ``step`` — KV-cached single-token decode used by
    the decoding engine and mirrored by the fused CUDA kernels, and by
    the scheduled-sampling training forward (``step_hidden``; with
    autograd on, the caches grow out of place, ``layers.put_row``).

Semantics:
  * word embedding -> dropout -> * sqrt(emb_dim) -> + positional table
    (max_len 100) -> dropout;
  * memory projection Linear -> ReLU -> Dropout -> LayerNorm (the
    cached path's ``init_cache`` projects without the dropout, as the
    JAX decoder does);
  * n post-norm ``TransformerDecoderLayer``s (nhead = d/64, ff = 4d);
  * classifier without bias, optionally tied to the embedding;
  * every dropout (rate ``dropout``, also inside the layers) acts only
    in ``train()``.

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

The conditioned decoders (the JAX ``EventTransformerDecoder`` and
``KeywordProbTransformerDecoder``) add a per-sample condition [B, E] to
the scaled word embeddings before the positional table: an event
embedding (the event distribution, normalised to sum 1, times a [C, E]
table) or a keyword projection (a Linear of the keyword probabilities)
followed by a LayerNorm, the LayerNorm only when a condition is given.
``forward`` takes it as ``event=`` [B, C]; ``init_cache(..., event=)``
keeps its embedding in ``static["cond"]`` for every cached step.  The
base class carries the hooks (:meth:`TransformerDecoder.condition`, the
``cond`` of ``embed``, ``static["cond"]`` in ``step_hidden``) and never
sets a condition itself, so the plain decoder computes what it did.  The
new parameters keep the JAX names (``event_embedding``,
``keyword_proj``, ``word_keyword_norm``): the JAX loader gives them no
reference key.  No kernel takes a condition: ``decoding/select.py``
sends only the plain ``TransformerDecoder`` to the fused kernels.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from audiocaption_tpu_torch.models.layers import (
    LayerNorm, Linear, TransformerDecoderLayer, causal_mask,
    check_compute_dtype, narrow, put_row, sinusoidal_positions, widen)
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
        self.dropout = dropout
        self.word_embedding = nn.Embedding(vocab_size, emb_dim)
        nn.init.xavier_uniform_(self.word_embedding.weight)
        self.attn_proj = nn.Sequential(
            Linear(attn_emb_dim, emb_dim, compute_dtype=cd), nn.ReLU(),
            nn.Dropout(dropout),
            LayerNorm(emb_dim, eps=1e-5, compute_dtype=cd))
        self.pos_encoder = PositionalEncoding(max_pos, emb_dim)
        self.model = _LayerStack(
            TransformerDecoderLayer(emb_dim, self.nhead, self.dim_feedforward,
                                    cd, dropout)
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

    def project_memory(self, attn_emb: torch.Tensor,
                       dropout: bool = True) -> torch.Tensor:
        if dropout:
            return self.attn_proj(attn_emb)
        dense, relu, _, norm = self.attn_proj
        return norm(relu(dense(attn_emb)))

    def _drop(self, x: torch.Tensor) -> torch.Tensor:
        return F.dropout(x, self.dropout, self.training)

    def condition(self, e: torch.Tensor,
                  cond: Optional[torch.Tensor]) -> torch.Tensor:
        """The scaled word embeddings ``e`` [B, T, E] with the condition
        ``cond`` [B, E] mixed in (the conditioned subclasses); this decoder
        takes none."""
        return e

    def embed(self, word: torch.Tensor, pos_offset: int = 0,
              cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        e = self._drop(self.word_embedding(word)) * math.sqrt(self.emb_dim)
        e = self.condition(e, cond)
        T = word.shape[-1]
        return narrow(self._drop(e + self.pe[pos_offset:pos_offset + T][None]),
                      self.compute_dtype)

    def forward(self, word: torch.Tensor, attn_emb: torch.Tensor,
                attn_emb_len: torch.Tensor,
                cap_padding_mask: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """word [B, L] ids -> {logit [B, L, V], embed [B, L, E]}."""
        return self._forward(word, attn_emb, attn_emb_len, cap_padding_mask)

    def _forward(self, word, attn_emb, attn_emb_len, cap_padding_mask,
                 cond: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
        memory = self.project_memory(attn_emb)
        mem_kpm = ~length_mask(attn_emb_len, attn_emb.shape[1])
        x = self.embed(word, 0, cond)
        tgt_mask = causal_mask(word.shape[1], device=word.device)
        for layer in self.layers:
            x = layer(x, memory, tgt_mask=tgt_mask,
                      tgt_key_padding_mask=cap_padding_mask,
                      memory_key_padding_mask=mem_kpm)
        x = widen(x)
        return {"logit": self.logits(x), "embed": x}

    # ---------------------------------------------------------- decode ----

    def init_cache(self, attn_emb: torch.Tensor, attn_emb_len: torch.Tensor,
                   max_length: int, fc_emb: Optional[torch.Tensor] = None
                   ) -> Tuple[Dict, Dict]:
        """Precompute memory K/V and allocate the self-attention caches.
        ``fc_emb`` is the GRU decoders' keyword, which this one ignores.

        Returns (static, dynamic): ``static`` is read-only during decode,
        ``dynamic`` is the per-step state the engine threads and reorders.
        """
        B = attn_emb.shape[0]
        cache_dtype = narrow(attn_emb[:0], self.compute_dtype).dtype
        memory = self.project_memory(attn_emb, dropout=False)
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

    def step_hidden(self, word_t: torch.Tensor, t: int, static: Dict,
                    dyn: Dict, is_pad_t: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict]:
        """One decode step up to the float32 hidden state: word_t [B] ids
        -> (hidden [B, E], dyn).  Row ``t`` of the caches is written in
        place when autograd is off, else the returned ``dyn`` holds new
        caches (``layers.put_row``)."""
        L = dyn["self_k0"].shape[1]
        if is_pad_t is None:
            is_pad_t = torch.zeros_like(word_t, dtype=torch.bool)
        # a step past the caches (diverse beam search's later groups)
        # writes their last row, as the JAX step's clamped update does
        row = min(t, L - 1)
        self_pad = put_row(dyn["self_pad"], row, is_pad_t)
        positions = torch.arange(L, device=word_t.device)
        kpm = (positions[None, :] > t) | self_pad
        x = self.embed(word_t[:, None], t, static.get("cond"))[:, 0]
        dyn = dict(dyn, self_pad=self_pad)
        for i, layer in enumerate(self.layers):
            x, dyn[f"self_k{i}"], dyn[f"self_v{i}"] = layer.step(
                x, row, dyn[f"self_k{i}"], dyn[f"self_v{i}"], kpm,
                static[f"mem_k{i}"], static[f"mem_v{i}"], static["mem_kpm"])
        return widen(x), dyn

    def step(self, word_t: torch.Tensor, t: int, static: Dict, dyn: Dict,
             is_pad_t: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict]:
        """One decode step: word_t [B] ids -> (logit [B, V], dyn)."""
        x, dyn = self.step_hidden(word_t, t, static, dyn, is_pad_t)
        return self.logits(x), dyn


class EventTransformerDecoder(TransformerDecoder):
    """Event-conditioned decoder (the JAX ``EventTransformerDecoder``): the
    event distribution [B, ``event_classes``], normalised to sum 1 (by
    max(sum, 1e-8)), times a [C, E] xavier-initialised table, added to the
    scaled word embeddings before the positional table."""

    def __init__(self, *args, event_classes: int = 527, **kwargs):
        super().__init__(*args, **kwargs)
        self.event_classes = event_classes
        self.build_condition(event_classes)

    def build_condition(self, classes: int) -> None:
        self.event_embedding = nn.Embedding(classes, self.emb_dim)
        nn.init.xavier_uniform_(self.event_embedding.weight)

    def encode_event(self, event: torch.Tensor) -> torch.Tensor:
        """[N, C] probabilities -> the condition [N, E] (float32)."""
        event = event.float()
        probs = event / event.sum(-1, keepdim=True).clamp(min=1e-8)
        return probs @ self.event_embedding.weight

    def condition(self, e, cond):
        return e if cond is None else e + cond[:, None, :]

    def forward(self, word, attn_emb, attn_emb_len, cap_padding_mask=None,
                event: Optional[torch.Tensor] = None):
        """As the plain decoder's, with the condition of ``event`` [B, C]
        (None: no condition)."""
        cond = None if event is None else self.encode_event(event)
        return self._forward(word, attn_emb, attn_emb_len, cap_padding_mask,
                             cond)

    def init_cache(self, attn_emb, attn_emb_len, max_length, fc_emb=None,
                   event: Optional[torch.Tensor] = None):
        """As the plain decoder's; with ``event`` [B, C], its condition in
        ``static["cond"]``, which every cached step adds."""
        static, dyn = super().init_cache(attn_emb, attn_emb_len, max_length,
                                         fc_emb)
        if event is not None:
            static["cond"] = self.encode_event(event.to(attn_emb.device))
        return static, dyn


class KeywordProbTransformerDecoder(EventTransformerDecoder):
    """Keyword-conditioned decoder (the JAX
    ``KeywordProbTransformerDecoder``): the keyword probabilities
    [B, ``keyword_classes_num``] through ``keyword_proj`` (a Linear),
    added to the scaled word embeddings, then ``word_keyword_norm`` (a
    LayerNorm, only where a condition is given), before the positional
    table.  The condition rides the ``event`` argument, as in JAX."""

    def __init__(self, *args, keyword_classes_num: int = 527, **kwargs):
        super().__init__(*args, event_classes=keyword_classes_num, **kwargs)
        self.keyword_classes_num = keyword_classes_num

    def build_condition(self, classes: int) -> None:
        self.keyword_proj = Linear(classes, self.emb_dim)
        self.word_keyword_norm = LayerNorm(self.emb_dim, eps=1e-5)

    def encode_event(self, event: torch.Tensor) -> torch.Tensor:
        return self.keyword_proj(event.float())

    def condition(self, e, cond):
        return e if cond is None else self.word_keyword_norm(
            e + cond[:, None, :])
