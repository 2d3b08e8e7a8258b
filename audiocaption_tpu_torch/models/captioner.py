"""Caption model: frontend + encoder + decoder, and greedy / beam
generation (counterpart of the inference half of
``audiocaption_tpu/models/captioner.py``)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from audiocaption_tpu_torch.decoding.engine import (
    SpecialTokens, beam_search, expand_to_beams, stepwise_decode)
from audiocaption_tpu_torch.models.rnn_decoder import BahAttnCatFcDecoder
from audiocaption_tpu_torch.ops.frontend import LogMelFrontend, MelConfig


class Captioner(nn.Module):
    """Waveform -> caption model (inference)."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module,
                 mel: MelConfig, special: SpecialTokens = SpecialTokens()):
        super().__init__()
        self.frontend = LogMelFrontend(mel)
        self.encoder = encoder
        self.decoder = decoder
        self.mel = mel
        self.special = special

    def encode(self, wav: torch.Tensor, wav_len: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
        return self.encode_lms(self.frontend(wav), self.mel.feat_len(wav_len))

    def encode_lms(self, lms: torch.Tensor, feat_len: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
        """Encode a log-mel computed elsewhere (the temporal model computes
        it once for its SED branch and its captioner)."""
        return self.encoder(lms, feat_len)


@torch.no_grad()
def generate(model: Captioner, wav: Optional[torch.Tensor] = None,
             wav_len: Optional[torch.Tensor] = None,
             sample_method: str = "greedy", max_length: Optional[int] = None,
             temp: float = 1.0, beam_size: Optional[int] = None,
             n_best: bool = False, n_best_size: Optional[int] = None,
             enc: Optional[Dict[str, torch.Tensor]] = None,
             lms: Optional[torch.Tensor] = None,
             feat_len: Optional[torch.Tensor] = None,
             temporal_tag: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
    """Batched caption generation with the torch engine: greedy or beam.
    The input is a waveform (``wav``, ``wav_len``), a log-mel (``lms``,
    ``feat_len``) or the encoder's outputs (``enc``).  ``temporal_tag``
    [B] conditions a temporal decoder."""
    special = model.special
    L = max_length if max_length is not None else special.max_length
    if enc is None:
        enc = (model.encode(wav, wav_len) if lms is None
               else model.encode_lms(lms, feat_len))
    dec = model.decoder
    B = enc["attn_emb"].shape[0]
    device = enc["attn_emb"].device
    rnn = isinstance(dec, BahAttnCatFcDecoder)
    keys = ("attn_emb", "attn_emb_len", "fc_emb") if rnn else (
        "attn_emb", "attn_emb_len")
    cond = {} if temporal_tag is None else {"temporal_tag": temporal_tag}

    def init_cache(enc_in, cond_in):
        if rnn:
            return dec.init_cache(enc_in["attn_emb"], enc_in["attn_emb_len"],
                                  enc_in["fc_emb"], L, **cond_in)
        return dec.init_cache(enc_in["attn_emb"], enc_in["attn_emb_len"], L)

    def make_step_fn(static):
        if rnn:   # RNN steps take no pad flags
            return lambda word, t, dyn: dec.step(word, t, static, dyn)

        def step_fn(word, t, dyn):
            return dec.step(word, t, static, dyn,
                            is_pad_t=word == special.pad)
        return step_fn

    if sample_method == "beam":
        K = beam_size if beam_size is not None else 3
        static, dyn = init_cache(
            expand_to_beams({k: enc[k] for k in keys}, K),
            expand_to_beams(cond, K))
        out = beam_search(make_step_fn(static), dyn, B, K, dec.vocab_size,
                          special, max_length=L, temp=temp, n_best=n_best,
                          n_best_size=n_best_size, device=device)
    elif sample_method == "greedy":
        static, dyn = init_cache(enc, cond)
        out = stepwise_decode(make_step_fn(static), dyn, B, special,
                              max_length=L, device=device)
    else:
        raise ValueError(f"unsupported sample_method {sample_method!r} "
                         "(this port serves 'greedy' and 'beam')")
    out.update(enc)
    return out
