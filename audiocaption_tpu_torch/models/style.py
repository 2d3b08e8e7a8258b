"""Style-conditioned captioning (counterpart of
``audiocaption_tpu/models/style.py``; reference ``style_model.py`` and
``ref_encoder.py``).

A learned bank of style tokens.  In training the style vector is
inferred from the reference caption: a text encoder's CLS output
(:class:`TextRefEncoder`) attends over the bank (:class:`StyleBank`).
At inference the caller supplies a mixture ``style_weight`` over the
bank, which :meth:`StyleCaptioner.style_of_weight` turns into the style
vector for ``generate(..., cond_kwargs={"style": vec})``.  The style
vector feeds a ``StyleBahAttnDecoder`` through its fc slot
(``models/rnn_decoder.py``); without one the decoder uses its own
``fc_proj(fc_emb)`` (the runner's val score).

Module names follow the JAX tree (``ref_encoder.word_embedding``,
``ref_encoder.cls_token``, ``ref_encoder.layer{i}.*``,
``style_bank.styles``, ``style_bank.query_proj``), the key space that
``models/convert.py::style_state_dict_from_jax`` writes and a
``StyleCaptioner``'s checkpoints hold beside ``encoder.`` and
``decoder.``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from audiocaption_tpu_torch.models.captioner import Captioner
from audiocaption_tpu_torch.models.encoders_extra import (
    TransformerEncoderLayerTorch)
from audiocaption_tpu_torch.models.layers import Linear
from audiocaption_tpu_torch.ops.masking import length_mask


class TextRefEncoder(nn.Module):
    """Reference-caption encoder: word embedding, a learned CLS token in
    front, ``nlayers`` post-norm encoder layers (``nhead`` d_model // 64,
    at least 1; an FFN of 4 * d_model) over the CLS token and the
    caption's ``cap_len`` words; the sentence embedding is the CLS
    output [B, d_model]."""

    def __init__(self, vocab_size: int, d_model: int = 256, nlayers: int = 2,
                 nhead: Optional[int] = None, dropout: float = 0.2):
        super().__init__()
        nhead = nhead or max(1, d_model // 64)
        self.d_model, self.nlayers = d_model, nlayers
        self.word_embedding = nn.Embedding(vocab_size, d_model)
        nn.init.xavier_uniform_(self.word_embedding.weight)
        self.cls_token = nn.Parameter(torch.empty(1, d_model))
        nn.init.xavier_uniform_(self.cls_token)
        for i in range(nlayers):
            setattr(self, f"layer{i}", TransformerEncoderLayerTorch(
                d_model, nhead, d_model * 4, dropout))

    def forward(self, cap: torch.Tensor, cap_len: torch.Tensor
                ) -> torch.Tensor:
        emb = self.word_embedding(cap)
        cls = self.cls_token[None].expand(cap.shape[0], 1, self.d_model)
        h = torch.cat([cls, emb], dim=1)
        kpm = ~length_mask(cap_len + 1, h.shape[1])
        for i in range(self.nlayers):
            h = getattr(self, f"layer{i}")(h, src_key_padding_mask=kpm)
        return h[:, 0]


class StyleBank(nn.Module):
    """``n_styles`` learned style tokens [n, style_dim] (N(0, 0.02)) and
    the attention of a query embedding over them."""

    def __init__(self, n_styles: int = 4, style_dim: int = 256,
                 query_dim: Optional[int] = None):
        super().__init__()
        self.n_styles, self.style_dim = n_styles, style_dim
        self.styles = nn.Parameter(torch.randn(n_styles, style_dim) * 0.02)
        self.query_proj = Linear(query_dim or style_dim, style_dim)

    def from_reference(self, ref_emb: torch.Tensor) -> torch.Tensor:
        """The soft style of a reference-caption embedding: softmax(q
        styles^T / sqrt(style_dim)) styles, q = query_proj(ref_emb)."""
        q = self.query_proj(ref_emb)
        w = torch.softmax(q @ self.styles.T / math.sqrt(self.style_dim),
                          dim=-1)
        return w @ self.styles

    def from_weight(self, style_weight: torch.Tensor) -> torch.Tensor:
        """A caller's mixture [N, n_styles] over the bank -> [N, style_dim]."""
        return style_weight.to(self.styles.dtype) @ self.styles

    def forward(self, ref_emb: torch.Tensor) -> torch.Tensor:
        return self.from_reference(ref_emb)


class StyleCaptioner(Captioner):
    """The reference's ``StyleCaptionModel``: a ``Captioner`` whose
    training forward infers each row's style from its own caption
    (``cap[:, 1:]``, the <bos> stripped, over max(cap_len - 1, 1) words)
    unless ``cond_kwargs`` carries a ``style``; the decoder must take a
    ``style`` (``StyleBahAttnDecoder``)."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module, mel,
                 special=None, input_mode: str = "mel",
                 ref_encoder: Optional[TextRefEncoder] = None,
                 style_bank: Optional[StyleBank] = None):
        kw = {} if special is None else {"special": special}
        super().__init__(encoder, decoder, mel, input_mode=input_mode, **kw)
        self.ref_encoder = ref_encoder
        self.style_bank = style_bank

    def forward(self, wav: torch.Tensor, wav_len: torch.Tensor,
                cap: torch.Tensor, cap_len: torch.Tensor, ss_ratio=1.0,
                generator: Optional[torch.Generator] = None,
                temporal_tag: Optional[torch.Tensor] = None,
                specaug: bool = False,
                specaug_generator: Optional[torch.Generator] = None,
                cond_kwargs: Optional[Dict[str, torch.Tensor]] = None,
                specaug_rows: Optional[Tuple[int, int]] = None
                ) -> Dict[str, torch.Tensor]:
        cond = dict(cond_kwargs or {})
        if "style" not in cond:
            cond["style"] = self.style_bank.from_reference(self.ref_encoder(
                cap[:, 1:], torch.clamp(cap_len - 1, min=1)))
        return super().forward(wav, wav_len, cap, cap_len, ss_ratio=ss_ratio,
                               generator=generator, temporal_tag=temporal_tag,
                               specaug=specaug,
                               specaug_generator=specaug_generator,
                               cond_kwargs=cond, specaug_rows=specaug_rows)

    def style_of_weight(self, style_weight: torch.Tensor) -> torch.Tensor:
        """[N, n_styles] mixture -> the style vector [N, style_dim]."""
        return self.style_bank.from_weight(style_weight)
