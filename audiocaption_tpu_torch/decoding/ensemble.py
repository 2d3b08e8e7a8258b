"""Ensemble decoding by per-step log-probability averaging (counterpart of
``audiocaption_tpu/decoding/ensemble.py``; reference
``python_scripts/train_eval/ensemble.py``): each member encodes the batch
alone, and at every step the next-token distribution is the mean of the
members' log-softmax.  The averaged step is a step function of the torch
engine (``decoding/engine.py``), so greedy, sampling, beam and diverse
beam search all work as for one model.  No kernel computes this step (no
Pallas kernel does in the JAX package either): it runs in the engine, on
the members' device.

The members share one tokenizer.  A member's decoder is a
``TransformerDecoder`` (a conditioned one among them), or any GRU decoder
(``models/rnn_decoder.py``), mixed as they come.  Every member's cache is
built from its ``attn_emb``, ``attn_emb_len`` and ``fc_emb`` with no
condition, and each steps through its own class's ``step``, as in the
JAX ensemble: the temporal decoder runs on tag 0 (ROADMAP Queue 3 H), an
``EventTransformerDecoder`` or ``KeywordProbTransformerDecoder`` with no
event or keyword.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from audiocaption_tpu_torch.decoding.engine import (
    NoiseFn, beam_search, diverse_beam_search, expand_to_beams,
    stepwise_decode)


@torch.no_grad()
def ensemble_generate(models: Sequence[torch.nn.Module],
                      wav: torch.Tensor, wav_len: torch.Tensor,
                      sample_method: str = "beam",
                      beam_size: Optional[int] = None,
                      max_length: Optional[int] = None,
                      temp: float = 1.0, group_size: int = 3,
                      diversity_lambda: float = 0.5,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[NoiseFn] = None
                      ) -> Dict[str, torch.Tensor]:
    """Decode a batch with an ensemble of ``Captioner``s (in ``eval()``, on
    the batch's device) -> the engine's outputs: ``seq`` [B, L] for beam
    (with ``score``), greedy and sampling (with ``sampled_logprob``),
    [B, beam_size, L] for "dbs".  Sampling draws from ``generator``, or a
    generator seeded with 0 where none is given, or takes ``noise``."""
    if not models:
        raise ValueError("an ensemble needs at least one model")
    special = models[0].special
    L = max_length if max_length is not None else special.max_length
    V = models[0].decoder.vocab_size
    device = wav.device
    encs = [m.encode(wav, wav_len) for m in models]
    B = encs[0]["attn_emb"].shape[0]

    def init_caches(k: int):
        """Every member's caches for k rows a sample; the engine reorders
        one flat dict of tensors, so member i's keys get the prefix
        "i."."""
        statics, dyn = [], {}
        for i, (m, enc) in enumerate(zip(models, encs)):
            enc_k = expand_to_beams({x: enc[x] for x in (
                "attn_emb", "attn_emb_len", "fc_emb")}, k)
            s, d = m.decoder.init_cache(enc_k["attn_emb"],
                                        enc_k["attn_emb_len"],
                                        max_length=L, fc_emb=enc_k["fc_emb"])
            statics.append(s)
            dyn.update({f"{i}.{key}": v for key, v in d.items()})
        return statics, dyn

    def make_step(statics):
        def step_fn(word, t, dyn):
            lps, new_dyn = [], {}
            for i, (m, static) in enumerate(zip(models, statics)):
                prefix = f"{i}."
                own = {k[len(prefix):]: v for k, v in dyn.items()
                       if k.startswith(prefix)}
                logit, nd = m.decoder.step(word, t, static, own,
                                           is_pad_t=word == special.pad)
                lps.append(torch.log_softmax(logit, dim=-1))
                new_dyn.update({prefix + k: v for k, v in nd.items()})
            return sum(lps) / len(lps), new_dyn
        return step_fn

    if sample_method == "beam":
        K = beam_size if beam_size is not None else 3
        statics, dyn = init_caches(K)
        return beam_search(make_step(statics), dyn, B, K, V, special,
                           max_length=L, temp=temp, device=device)
    if sample_method == "dbs":
        K = beam_size if beam_size is not None else 6
        statics, dyn = init_caches(group_size * (K // group_size))
        return diverse_beam_search(make_step(statics), dyn, B, K, V,
                                   special, group_size=group_size,
                                   diversity_lambda=diversity_lambda,
                                   max_length=L, temp=temp, device=device)
    if generator is None and noise is None and sample_method != "greedy":
        generator = torch.Generator(device=device).manual_seed(0)
    statics, dyn = init_caches(1)
    return stepwise_decode(make_step(statics), dyn, B, special,
                           max_length=L, device=device, method=sample_method,
                           temp=temp, generator=generator, noise=noise)
