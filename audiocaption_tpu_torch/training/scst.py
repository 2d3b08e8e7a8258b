"""Self-critical sequence training (counterpart of
``audiocaption_tpu/training/scst.py``): REINFORCE with a CIDEr-D reward,
measured against the greedy caption's reward as the baseline.

One step (:func:`scst_step`):

  1. the sample pass, without autograd: one encode, the greedy baseline
     (on the card the hand-written greedy kernel through a
     ``FusedGreedyDecoder`` re-packed from the current weights, on the
     CPU the torch engine) and a multinomial sample at ``sample_temp``
     from the torch engine (``generate``), its draws from the caller's
     ``torch.Generator``;
  2. host rewards: CIDEr-D of both captions against the clip's
     references (:func:`compute_batch_score`, the native scorer);
  3. the grad pass: teacher-force ``[<bos>] + sampled[:-1]`` to recompute
     the sampled words' log-probabilities with autograd (a GRU decoder
     steps through them, as the JAX ``loss_fn`` does), loss
     ``-(r_sample - r_greedy) * logprob * mask / sum(mask)``, ``mask`` 1 up
     to and including the first <eos> (:func:`scst_mask`), backward, the
     global-norm clip;
  4. the optimizer step (the XE trainer's Adam with L2 weight decay and
     its schedule, ``training/trainer.py::create_train_state``).  Its
     gradients are applied whatever their value, as the JAX runner does:
     SCST has no NaN skip.

A GRU decoder's baseline and sample come from the torch engine (no
kernel decodes a GRU).  Its caches are built with no condition, as in
the JAX step: the temporal decoder then conditions every clip on tag 0
(``TemporalBahAttnDecoder.init_cache``), in the sample pass and in the
grad pass alike (a JAX-side fault kept for parity, ROADMAP Queue 3).

Mode.  The JAX step runs the whole model in inference mode (no dropout,
batch norm on its running statistics, which no pass updates), and so
does this one (:func:`scst_mode`).  One exception is forced by cuDNN,
which runs the backward of an ``nn.GRU`` only in training mode: the grad
pass puts every recurrent module in ``train()`` with its own ``dropout``
set to 0 for the pass, so they compute their eval-mode output.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiocaption_tpu_torch.decoding.engine import NoiseFn
from audiocaption_tpu_torch.models.captioner import generate
from audiocaption_tpu_torch.models.rnn_decoder import RnnDecoder
from audiocaption_tpu_torch.training.trainer import clip_grad_norm


def scst_mask(seq: np.ndarray, eos: int) -> np.ndarray:
    """1 up to and including the first <eos>, 0 after; all 1 for a row
    without one."""
    B, L = seq.shape
    mask = np.zeros((B, L), np.float32)
    for b in range(B):
        ended = np.where(seq[b] == eos)[0]
        mask[b, :(ended[0] + 1) if len(ended) else L] = 1.0
    return mask


def compute_batch_score(seqs: np.ndarray, key2refs: Dict[str, List[str]],
                        keys: List[str], idx2word: Dict[int, str],
                        bos: int, eos: int, scorer=None) -> np.ndarray:
    """CIDEr-D of each row's caption against its clip's references ->
    [B] float32.  A clip that appears in several rows is scored once, on
    its first row's caption (the reference's de-duplication), and every
    row of it gets that score."""
    if scorer is None:
        from audiocaption_tpu_torch.native import FastCiderD
        scorer = FastCiderD()
    hyp: Dict[str, List[str]] = {}
    refs: Dict[str, List[str]] = {}
    for i, key in enumerate(keys):
        if key in hyp:
            continue
        words = []
        for w in seqs[i]:
            w = int(w)
            if w == bos:
                continue
            if w == eos:
                break
            words.append(idx2word.get(w, "<unk>"))
        hyp[key] = [" ".join(words)]
        refs[key] = key2refs[key]
    _, scores = scorer.compute_score(refs, hyp)
    key2score = dict(zip(refs, scores))
    return np.asarray([key2score[k] for k in keys], np.float32)


@contextmanager
def scst_mode(model: nn.Module) -> Iterator[nn.Module]:
    """The grad pass's mode: ``eval()`` everywhere but the recurrent
    modules, which go to ``train()`` (cuDNN's rule) with their own
    dropout set to 0, so that they compute their eval-mode output.  Their
    dropout is restored on exit."""
    model.eval()
    rnns = [m for m in model.modules() if isinstance(m, nn.RNNBase)]
    saved = [m.dropout for m in rnns]
    for m in rnns:
        m.dropout = 0.0
        m.train()
    try:
        yield model
    finally:
        for m, p in zip(rnns, saved):
            m.dropout = p


@torch.no_grad()
def sample_pass(model, wav: torch.Tensor, wav_len: torch.Tensor,
                max_length: int = 20, sample_temp: float = 1.0,
                generator: Optional[torch.Generator] = None,
                baseline: Optional[Callable] = None,
                noise: Optional[NoiseFn] = None,
                mark: Optional[Callable[[str], None]] = None
                ) -> Dict[str, torch.Tensor]:
    """The inference-mode pass: -> {greedy [B, L], sampled [B, L] ids,
    sampled_logprob [B, L]}.  ``baseline(enc)`` decodes the greedy
    captions from the encoder's outputs (a ``FusedGreedyDecoder``'s
    ``decode_enc``); without one, the torch engine does.  ``mark`` as in
    :func:`scst_step` ("encode", "baseline")."""
    model.eval()
    enc = model.encode(wav, wav_len)
    if mark:
        mark("encode")
    if baseline is not None:
        greedy = baseline(enc).long()
    else:
        greedy = generate(model, enc=enc, sample_method="greedy",
                          max_length=max_length)["seq"]
    if mark:
        mark("baseline")
    out = generate(model, enc=enc, sample_method="sample", temp=sample_temp,
                   max_length=max_length, generator=generator, noise=noise)
    return {"greedy": greedy, "sampled": out["seq"],
            "sampled_logprob": out["sampled_logprob"]}


def scst_loss(model, wav: torch.Tensor, wav_len: torch.Tensor,
              sampled: torch.Tensor, advantage: torch.Tensor,
              mask: torch.Tensor):
    """The grad pass's loss (call under :func:`scst_mode`) -> (loss, the
    sampled words' log-probabilities [B, L])."""
    dec, sp = model.decoder, model.special
    word = torch.cat([torch.full_like(sampled[:, :1], sp.bos),
                      sampled[:, :-1]], dim=1)
    enc = model.encode(wav, wav_len)
    if isinstance(dec, RnnDecoder):
        # no condition: the temporal decoder runs on tag 0, as in JAX
        static, dyn = dec.init_cache(enc["attn_emb"], enc["attn_emb_len"],
                                     enc["fc_emb"], sampled.shape[1])
        logits = []
        for t in range(sampled.shape[1]):
            logit_t, dyn = dec.step(word[:, t], t, static, dyn)
            logits.append(logit_t)
        logit = torch.stack(logits, 1)
    else:
        logit = dec(word, enc["attn_emb"], enc["attn_emb_len"],
                    cap_padding_mask=word == sp.pad)["logit"]
    tok_lp = torch.gather(F.log_softmax(logit, dim=-1), -1,
                          sampled[..., None])[..., 0]
    loss = torch.sum(-advantage[:, None] * tok_lp * mask) / torch.sum(mask)
    return loss, tok_lp


def apply_scst(state, wav: torch.Tensor, wav_len: torch.Tensor,
               sampled: torch.Tensor, advantage: torch.Tensor,
               mask: torch.Tensor,
               mark: Optional[Callable[[str], None]] = None
               ) -> Dict[str, torch.Tensor]:
    """Grad pass, clip and optimizer step on ``state``
    (``trainer.TrainState``) -> {loss, grad_norm (raw, before the clip),
    token_logprob}.  ``mark("grad")`` is called between the clip and the
    optimizer."""
    state.optimizer.zero_grad(set_to_none=True)
    with scst_mode(state.model):
        loss, tok_lp = scst_loss(state.model, wav, wav_len, sampled,
                                 advantage, mask)
        loss.backward()
    grad_norm = clip_grad_norm(state.params, state.max_grad_norm)
    if mark:
        mark("grad")
    state.optimizer.step()
    state.scheduler.step()
    return {"loss": loss.detach(), "grad_norm": grad_norm.detach(),
            "token_logprob": tok_lp.detach()}


def scst_step(state, batch: Dict[str, torch.Tensor], keys: List[str],
              key2refs: Dict[str, List[str]], idx2word: Dict[int, str],
              max_length: int = 20, sample_temp: float = 1.0,
              generator: Optional[torch.Generator] = None, scorer=None,
              baseline=None, noise: Optional[NoiseFn] = None,
              mark: Optional[Callable[[str], None]] = None) -> Dict:
    """One SCST step on ``batch`` (wav [B, T] float32, wav_len [B], on the
    model's device; ``keys`` the rows' clip ids) -> {loss, grad_norm,
    reward_sample, reward_greedy (batch means, host floats), and the
    step's tensors: greedy, sampled, sampled_logprob, token_logprob,
    advantage, mask}.  ``baseline`` is a ``FusedGreedyDecoder`` (re-packed
    here from the current weights) or None for the torch engine.
    ``mark(name)``, if given, is called after each part ("repack",
    "encode", "baseline", "sample", "rewards", "grad", "optimizer"), for
    the caller's timers."""
    model, sp = state.model, state.model.special
    wav, wav_len = batch["wav"], batch["wav_len"]
    if baseline is not None:
        baseline.refresh()
    if mark:
        mark("repack")
    s = sample_pass(model, wav, wav_len, max_length, sample_temp, generator,
                    baseline.decode_enc if baseline is not None else None,
                    noise, mark)
    if mark:
        mark("sample")
    greedy, sampled = s["greedy"].cpu().numpy(), s["sampled"].cpu().numpy()
    r_greedy = compute_batch_score(greedy, key2refs, keys, idx2word, sp.bos,
                                   sp.eos, scorer)
    r_sample = compute_batch_score(sampled, key2refs, keys, idx2word,
                                   sp.bos, sp.eos, scorer)
    device = wav.device
    advantage = torch.from_numpy(r_sample - r_greedy).to(device)
    mask = torch.from_numpy(scst_mask(sampled, sp.eos)).to(device)
    if mark:
        mark("rewards")
    m = apply_scst(state, wav, wav_len, s["sampled"], advantage, mask, mark)
    if mark:
        mark("optimizer")
    return dict(m, loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                reward_sample=float(r_sample.mean()),
                reward_greedy=float(r_greedy.mean()), greedy=s["greedy"],
                sampled=s["sampled"], sampled_logprob=s["sampled_logprob"],
                advantage=advantage, mask=mask)
