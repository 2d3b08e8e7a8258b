"""Caption model: frontend + encoder + decoder, its training forward,
and generation: greedy, sampling, beam and diverse beam search
(counterpart of
``audiocaption_tpu/models/captioner.py``).

Training forward (``Captioner.forward``), for the transformer decoder:

  * ``ss_ratio`` the Python float 1.0: full teacher forcing, one causal
    pass over ``cap[:, :-1]``;
  * any other value (a float or a tensor, 1.0 included): scheduled
    sampling on the KV cache.  One teacher pass serves every step whose
    coin says "teacher" (the prefix is then exactly ``cap[:, :t+1]``);
    the model prefix (<bos> + the words picked so far) only ever
    appends, so a KV cache over it advances one step at a time.  Each
    step draws one whole-batch coin ``U < ss_ratio``, U uniform from the
    caller's ``torch.Generator`` on the host.  :func:`ss_forward_recompute`
    re-runs the decoder over the selected prefix every step instead (the
    reference's shape), kept as the oracle the tests hold the cached path
    to.

For a GRU decoder (``models/rnn_decoder.py``, every variant) the
training forward runs step by step whatever ``ss_ratio`` is (the JAX
``_ss_forward_rnn``): the input word at step t is the teacher word
``cap[:, t]`` when that step's coin says "teacher" (always, for the
Python float 1.0), else the previous step's greedy word.  A
``temporal_tag`` and the ``cond_kwargs`` (``condition``, ``style``,
``structure``: the JAX package's route) go into the decoder's cache, in
training and in ``generate``.

A conditioned transformer decoder (``EventTransformerDecoder``,
``KeywordProbTransformerDecoder``) takes ``cond_kwargs={"event": ...}``
(keyword probabilities ride the same key) in the teacher-forcing
forward, and in ``generate``, where its cache keeps the condition for
every step (expanded to the beams).  The scheduled-sampling forward
passes no condition, neither to the teacher pass nor to the cache, as
the JAX ``_ss_forward_transformer`` does (ROADMAP Queue 3 K): a
conditioned transformer trained with ``ss_ratio`` below 1 trains
unconditioned in both packages.

The frontend runs without autograd; the encoder and decoder follow their
``train()`` / ``eval()`` mode (batch statistics, dropout, drop-connect).
With ``specaug`` (the config key of the same name), SpecAugment
(``ops/specaug.py``) drops stripes of the log-mel between the frontend
and the encoder, in ``train()`` only, drawn from ``specaug_generator``
on the batch's device (the JAX ``Captioner.frontend``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from audiocaption_tpu_torch.decoding.engine import (
    NoiseFn, SpecialTokens, beam_search, diverse_beam_search,
    expand_to_beams, stepwise_decode)
from audiocaption_tpu_torch.models.rnn_decoder import RnnDecoder
from audiocaption_tpu_torch.ops.frontend import LogMelFrontend, MelConfig
from audiocaption_tpu_torch.ops.masking import mean_with_lens
from audiocaption_tpu_torch.ops.specaug import spec_augment
from audiocaption_tpu_torch.utils.profiling import span


class Captioner(nn.Module):
    """Waveform -> caption model.  ``input_mode`` says what the first
    input is, as in the JAX ``Captioner``: "mel", a waveform, through the
    log-mel frontend first; "features", precomputed features ``[B, T, D]``
    with their lengths (``cli/prepare_features.py``; the feature-input
    encoders ``RnnEncoder``, ``AudioTransformerEncoder``,
    ``M2TransformerEncoder``), straight into the encoder: no frontend,
    no SpecAugment; "raw_wav", a waveform straight into an encoder that
    has its own frontend (``ESResNeXtFBSPEncoder``'s learned filterbank),
    no SpecAugment either."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module,
                 mel: MelConfig, special: SpecialTokens = SpecialTokens(),
                 input_mode: str = "mel"):
        super().__init__()
        if input_mode not in ("mel", "features", "raw_wav"):
            raise ValueError(f"input_mode must be 'mel', 'features' or "
                             f"'raw_wav', not {input_mode!r}")
        self.frontend = LogMelFrontend(mel)
        self.encoder = encoder
        self.decoder = decoder
        self.mel = mel
        self.special = special
        self.input_mode = input_mode

    def encode(self, wav: torch.Tensor, wav_len: torch.Tensor,
               specaug: bool = False,
               specaug_generator: Optional[torch.Generator] = None,
               specaug_rows: Optional[Tuple[int, int]] = None
               ) -> Dict[str, torch.Tensor]:
        if self.input_mode != "mel":
            with span("ac.encoder"):
                return self.encoder(wav, wav_len)
        return self.encode_lms(self.log_mel(wav, specaug, specaug_generator,
                                            specaug_rows),
                               self.mel.feat_len(wav_len))

    def log_mel(self, wav: torch.Tensor, specaug: bool = False,
                specaug_generator: Optional[torch.Generator] = None,
                specaug_rows: Optional[Tuple[int, int]] = None
                ) -> torch.Tensor:
        """The frontend's log-mel, without autograd; with ``specaug`` in
        ``train()`` mode, SpecAugment's stripes dropped (``specaug_rows``:
        the batch's rows of a global batch, ``ops/specaug.py``)."""
        with span("ac.frontend"), torch.no_grad():
            lms = self.frontend(wav)
            if specaug and self.training:
                lms = spec_augment(lms, specaug_generator,
                                   rows=specaug_rows)
        return lms

    def encode_lms(self, lms: torch.Tensor, feat_len: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
        """Encode a log-mel computed elsewhere (the temporal model computes
        it once for its SED branch and its captioner)."""
        with span("ac.encoder"):
            return self.encoder(lms, feat_len)

    def forward(self, wav: torch.Tensor, wav_len: torch.Tensor,
                cap: torch.Tensor, cap_len: torch.Tensor,
                ss_ratio: Union[float, torch.Tensor] = 1.0,
                generator: Optional[torch.Generator] = None,
                temporal_tag: Optional[torch.Tensor] = None,
                specaug: bool = False,
                specaug_generator: Optional[torch.Generator] = None,
                cond_kwargs: Optional[Dict[str, torch.Tensor]] = None,
                specaug_rows: Optional[Tuple[int, int]] = None
                ) -> Dict[str, torch.Tensor]:
        """Training forward: wav [B, T], cap [B, Lc] ids (<bos> ... <eos>,
        padded) -> {logit [B, Lc-1, V], embed [B, Lc-1, E], encoder
        outputs; on the scheduled-sampling path (and for a GRU decoder)
        also seq and sampled_logprob [B, Lc-1]}.  ``cap_len`` is the
        loss's, not this forward's; ``temporal_tag`` [B] and
        ``cond_kwargs`` condition a GRU decoder; ``specaug`` applies
        SpecAugment in ``train()`` (``specaug_generator`` on the batch's
        device; ``specaug_rows`` the batch's rows of a global batch)."""
        enc = self.encode(wav, wav_len, specaug, specaug_generator,
                          specaug_rows)
        cond = dict(cond_kwargs or {})
        if temporal_tag is not None:
            cond["temporal_tag"] = temporal_tag
        if isinstance(self.decoder, RnnDecoder):
            out = self._ss_forward_rnn(enc, cap, ss_ratio, generator, cond)
        elif isinstance(ss_ratio, float) and ss_ratio == 1.0:
            word = cap[:, :-1]
            out = self.decoder(word, enc["attn_emb"], enc["attn_emb_len"],
                               cap_padding_mask=word == self.special.pad,
                               **cond)
        else:
            out = self._ss_forward(enc, cap, ss_ratio, generator)
        out.update(enc)
        return out

    def _ss_forward(self, enc: Dict[str, torch.Tensor], cap: torch.Tensor,
                    ss_ratio, generator: Optional[torch.Generator]
                    ) -> Dict[str, torch.Tensor]:
        """Scheduled sampling on the KV cache (the JAX
        ``_ss_forward_transformer``).  Eval-mode logits equal
        :func:`ss_forward_recompute`'s at the same coins; under dropout
        the two draw different noise (cached K/V keep the noise of the
        step that wrote them)."""
        dec, sp = self.decoder, self.special
        B, Lc = cap.shape
        word = cap[:, :-1]
        t_out = dec(word, enc["attn_emb"], enc["attn_emb_len"],
                    cap_padding_mask=word == sp.pad)
        static, dyn = dec.init_cache(enc["attn_emb"], enc["attn_emb_len"],
                                     Lc - 1)
        prev = torch.full((B,), sp.bos, dtype=torch.long, device=cap.device)
        steps = []
        with span("ac.ss_loop"):
            for t in range(Lc - 1):
                teacher = ss_coin(ss_ratio, generator)
                hidden, dyn = dec.step_hidden(prev, t, static, dyn,
                                              is_pad_t=prev == sp.pad)
                if teacher:
                    logit_t = t_out["logit"][:, t]
                    embed_t = t_out["embed"][:, t]
                else:
                    logit_t, embed_t = dec.logits(hidden), hidden
                prev, step = _greedy_pick(logit_t, embed_t)
                steps.append(step)
        return _stack_steps(steps)

    def _ss_forward_rnn(self, enc: Dict[str, torch.Tensor],
                        cap: torch.Tensor, ss_ratio,
                        generator: Optional[torch.Generator],
                        cond: Optional[Dict[str, torch.Tensor]] = None
                        ) -> Dict[str, torch.Tensor]:
        """The GRU decoder's training forward, one step at a time (the JAX
        ``_ss_forward_rnn``): step t feeds the teacher word ``cap[:, t]``
        when its coin says so (:func:`ss_coin`; the Python float 1.0 draws
        none and always does), else the previous greedy word.  ``cond``
        goes to the decoder's ``init_cache``."""
        dec, sp = self.decoder, self.special
        B, Lc = cap.shape
        cond = cond or {}
        static, dyn = dec.init_cache(enc["attn_emb"], enc["attn_emb_len"],
                                     enc["fc_emb"], Lc - 1, **cond)
        forced = isinstance(ss_ratio, float) and ss_ratio == 1.0
        prev = torch.full((B,), sp.bos, dtype=torch.long, device=cap.device)
        steps = []
        with span("ac.ss_loop"):
            for t in range(Lc - 1):
                word = cap[:, t] if forced or ss_coin(ss_ratio, generator) \
                    else prev
                logit_t, dyn = dec.step(word, t, static, dyn)
                prev, step = _greedy_pick(logit_t, dyn["state"][:, -1])
                steps.append(step)
        return _stack_steps(steps)


def ss_coin(ss_ratio, generator: Optional[torch.Generator]) -> bool:
    """One scheduled-sampling coin: True (feed the teacher's word) when
    U < ``ss_ratio``, U uniform in [0, 1) in float32 from ``generator``
    on the host (no device sync unless ``ss_ratio`` is a device tensor)."""
    u = torch.rand((), generator=generator, dtype=torch.float32)
    return bool(u < torch.as_tensor(ss_ratio, dtype=torch.float32).cpu())


def _greedy_pick(logit_t: torch.Tensor, embed_t: torch.Tensor):
    lp = F.log_softmax(logit_t, dim=-1)
    lp_max, w_t = lp.max(-1)
    return w_t, {"logit": logit_t, "embed": embed_t, "seq": w_t,
                 "sampled_logprob": lp_max}


def _stack_steps(steps) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([s[k] for s in steps], 1) for k in steps[0]}


def ss_forward_recompute(model: Captioner, enc: Dict[str, torch.Tensor],
                         cap: torch.Tensor, ss_ratio,
                         generator: Optional[torch.Generator] = None
                         ) -> Dict[str, torch.Tensor]:
    """The reference-shaped scheduled-sampling forward (the JAX
    ``_ss_forward_transformer_recompute``): every step re-runs the decoder
    over the whole selected prefix, ``cap[:, :t+1]`` or <bos> + the words
    picked so far.  The oracle of :meth:`Captioner._ss_forward`."""
    dec, sp = model.decoder, model.special
    B, Lc = cap.shape
    prefix = torch.full((B, Lc), sp.bos, dtype=torch.long, device=cap.device)
    steps = []
    for t in range(Lc - 1):
        teacher = ss_coin(ss_ratio, generator)
        word = cap[:, :t + 1] if teacher else prefix[:, :t + 1]
        out = dec(word, enc["attn_emb"], enc["attn_emb_len"],
                  cap_padding_mask=word == sp.pad)
        w_t, step = _greedy_pick(out["logit"][:, -1], out["embed"][:, -1])
        prefix = prefix.clone()
        prefix[:, t + 1] = w_t
        steps.append(step)
    return _stack_steps(steps)


@torch.no_grad()
def generate(model: Captioner, wav: Optional[torch.Tensor] = None,
             wav_len: Optional[torch.Tensor] = None,
             sample_method: str = "greedy", max_length: Optional[int] = None,
             temp: float = 1.0, beam_size: Optional[int] = None,
             n_best: bool = False, n_best_size: Optional[int] = None,
             group_size: int = 3, diversity_lambda: float = 0.5,
             group_nbest: bool = True,
             enc: Optional[Dict[str, torch.Tensor]] = None,
             lms: Optional[torch.Tensor] = None,
             feat_len: Optional[torch.Tensor] = None,
             temporal_tag: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             noise: Optional[NoiseFn] = None,
             cond_kwargs: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
    """Batched caption generation with the torch engine, as the JAX
    ``generate`` routes it: "beam" (beam 3 by default), "dbs" (diverse beam
    search, beam 6 in ``group_size`` groups by default; ``seq`` [B, K, L]
    with ``group_nbest``, else [B, G, L]), and every method of
    ``engine.sample_next_word`` ("greedy", "gumbel", "sample", "topN",
    "top0.x"; ``seq`` and ``sampled_logprob`` [B, L]).  The input is a
    waveform (``wav``, ``wav_len``), a log-mel (``lms``, ``feat_len``) or
    the encoder's outputs (``enc``).  ``temporal_tag`` [B] and
    ``cond_kwargs`` (``condition`` [B], ``style`` [B, E], ``structure``
    [B]) condition a GRU decoder's cache, ``cond_kwargs={"event": [B, C]}``
    a conditioned transformer decoder's.  Sampling draws from
    ``generator`` (on the model's device), or, without one, from a fresh
    generator seeded with 0, so that two calls draw the same (the JAX
    default key is ``PRNGKey(0)``); ``noise(t, shape)`` hands in step t's
    draws instead."""
    special = model.special
    L = max_length if max_length is not None else special.max_length
    if enc is None:
        enc = (model.encode(wav, wav_len) if lms is None
               else model.encode_lms(lms, feat_len))
    dec = model.decoder
    B = enc["attn_emb"].shape[0]
    device = enc["attn_emb"].device
    cond = dict(cond_kwargs or {})
    if temporal_tag is not None:
        cond["temporal_tag"] = temporal_tag

    def make_step_fn(static):
        def step_fn(word, t, dyn):
            return dec.step(word, t, static, dyn,
                            is_pad_t=word == special.pad)
        return step_fn

    def expanded(n):
        # a transformer decoder's caller may hand in no fc_emb
        enc_n = expand_to_beams({k: v for k, v in enc.items() if k in (
            "attn_emb", "attn_emb_len", "fc_emb")}, n)
        return dec.init_cache(enc_n["attn_emb"], enc_n["attn_emb_len"],
                              max_length=L, fc_emb=enc_n.get("fc_emb"),
                              **expand_to_beams(cond, n))

    if sample_method == "beam":
        K = beam_size if beam_size is not None else 3
        static, dyn = expanded(K)
        out = beam_search(make_step_fn(static), dyn, B, K, dec.vocab_size,
                          special, max_length=L, temp=temp, n_best=n_best,
                          n_best_size=n_best_size, device=device)
    elif sample_method == "dbs":
        K = beam_size if beam_size is not None else 6
        static, dyn = expanded(group_size * (K // group_size))
        out = diverse_beam_search(
            make_step_fn(static), dyn, B, K, dec.vocab_size, special,
            group_size=group_size, diversity_lambda=diversity_lambda,
            max_length=L, temp=temp, group_nbest=group_nbest, device=device)
    else:
        if generator is None and noise is None and sample_method != "greedy":
            generator = torch.Generator(device=device).manual_seed(0)
        static, dyn = expanded(1)
        out = stepwise_decode(make_step_fn(static), dyn, B, special,
                              max_length=L, device=device,
                              method=sample_method, temp=temp,
                              generator=generator, noise=noise)
    out.update(enc)
    return out


def sequence_embedding(output: Dict[str, torch.Tensor],
                       cap_len: torch.Tensor) -> torch.Tensor:
    """The mean of a training forward's ``embed`` [B, L, E] over each row's
    ``cap_len - 1`` valid steps -> [B, E] (the JAX ``sequence_embedding``;
    the reference's ``CaptionSequenceModel``)."""
    return mean_with_lens(output["embed"], cap_len - 1)
