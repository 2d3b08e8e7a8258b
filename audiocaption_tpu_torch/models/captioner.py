"""Caption model: frontend + encoder + decoder, and greedy / beam
generation (counterpart of the inference half of
``audiocaption_tpu/models/captioner.py``)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from audiocaption_tpu_torch.decoding.engine import (
    SpecialTokens, beam_search, expand_to_beams, stepwise_decode)
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
        lms = self.frontend(wav)
        return self.encoder(lms, self.mel.feat_len(wav_len))


@torch.no_grad()
def generate(model: Captioner, wav: torch.Tensor, wav_len: torch.Tensor,
             sample_method: str = "greedy", max_length: Optional[int] = None,
             temp: float = 1.0, beam_size: Optional[int] = None,
             n_best: bool = False, n_best_size: Optional[int] = None,
             enc: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
    """Batched caption generation with the torch engine: greedy or beam.
    ``enc`` skips the encoder when its outputs are already known."""
    special = model.special
    L = max_length if max_length is not None else special.max_length
    if enc is None:
        enc = model.encode(wav, wav_len)
    dec = model.decoder
    B = enc["attn_emb"].shape[0]
    device = enc["attn_emb"].device

    def make_step_fn(static):
        def step_fn(word, t, dyn):
            return dec.step(word, t, static, dyn,
                            is_pad_t=word == special.pad)
        return step_fn

    if sample_method == "beam":
        K = beam_size if beam_size is not None else 3
        enc_k = expand_to_beams(
            {k: enc[k] for k in ("attn_emb", "attn_emb_len")}, K)
        static, dyn = dec.init_cache(enc_k["attn_emb"],
                                     enc_k["attn_emb_len"], L)
        out = beam_search(make_step_fn(static), dyn, B, K, dec.vocab_size,
                          special, max_length=L, temp=temp, n_best=n_best,
                          n_best_size=n_best_size, device=device)
    elif sample_method == "greedy":
        static, dyn = dec.init_cache(enc["attn_emb"], enc["attn_emb_len"], L)
        out = stepwise_decode(make_step_fn(static), dyn, B, special,
                              max_length=L, device=device)
    else:
        raise ValueError(f"unsupported sample_method {sample_method!r} "
                         "(this port serves 'greedy' and 'beam')")
    out.update(enc)
    return out
