"""Composite losses (counterpart of ``audiocaption_tpu/losses/wrappers.py``;
reference ``captioning/losses/loss.py:77-219``): a weighted sum of
losses, the augmented-sample loss that drops the augmented items not kept
this step, the discriminator's condition loss with its straight-through
and gumbel relaxations, and the expected word-specificity regression.

The wrappers read the step's output dict: ``logit`` [N, T, V],
``tgt_len`` [N] and, for the condition and specificity losses,
``conditions`` [N] (the batch's ``condition``; the port's train step
fills it, ``training/trainer.py::train_step``).  The gumbel noise is
drawn from an explicit ``torch.Generator``, where the JAX wrapper reads
``output["rng"]``.

Under data parallelism (``output["count_sum"]``, ``output["rows"]``, set
by ``training/trainer.py::train_step``) each mean is taken over the
global batch (``losses/loss.py::global_count``), and the gumbel noise of
this rank's rows is that of the same rows of the global batch's draw."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from audiocaption_tpu_torch.losses.loss import batch_mean, global_count
from audiocaption_tpu_torch.ops.masking import length_mask, mean_with_lens

LossFn = Callable[[Dict], torch.Tensor]


def multiple_loss_sum(loss_fns: Sequence[LossFn],
                      weights: Sequence[float]) -> LossFn:
    """sum_i weights[i] * loss_fns[i](output)."""
    def fn(output: Dict) -> torch.Tensor:
        total = 0.0
        for loss_fn, w in zip(loss_fns, weights):
            total = total + w * loss_fn(output)
        return total
    return fn


def augment_loss_wrapper(loss_fn_none: LossFn, eps: float = 1e-12) -> LossFn:
    """The mean per-token loss over the kept items: ``loss_fn_none``
    gives per-token losses [N, T] (``reduction="none"``), and
    ``output["aug_keep"]`` [N] is 1 for a real item and for an augmented
    item kept this step, else 0 (the runner's draw) ->
    sum(loss * keep) / (kept valid tokens + eps)."""
    def fn(output: Dict) -> torch.Tensor:
        loss = loss_fn_none(output)
        keep = output["aug_keep"].to(loss.dtype)[:, None]
        mask = length_mask(output["tgt_len"], loss.shape[1]).to(loss.dtype)
        kept = global_count(output, torch.sum(mask * keep))
        return torch.sum(loss * keep) / (kept + eps)
    return fn


def reparameterize_argmax(logit: torch.Tensor) -> torch.Tensor:
    """Straight-through hard one-hot: the forward value is
    one-hot(argmax), the gradient the identity with respect to
    ``logit``."""
    hard = F.one_hot(logit.argmax(-1), logit.shape[-1]).to(logit.dtype)
    return (hard - logit).detach() + logit


def gumbel_softmax(logit: torch.Tensor, u: torch.Tensor,
                   temperature: float = 1.0) -> torch.Tensor:
    """Straight-through gumbel-softmax one-hot from uniforms ``u`` (the
    shape of ``logit``): g = -log(-log(u + 1e-20) + 1e-20),
    y = softmax((logit + g) / temperature), forward one-hot(argmax y),
    gradient through y."""
    g = -torch.log(-torch.log(u + 1e-20) + 1e-20)
    y = torch.softmax((logit + g) / temperature, dim=-1)
    hard = F.one_hot(y.argmax(-1), logit.shape[-1]).to(y.dtype)
    return (hard - y).detach() + y


UniformFn = Callable[[torch.Size, torch.device], torch.Tensor]


def condition_loss_wrapper(loss_fn: LossFn,
                           dscrm_apply: Callable[[torch.Tensor, torch.Tensor],
                                                 torch.Tensor],
                           alpha: float = 1.0,
                           sample_method: str = "argmax",
                           generator: Optional[torch.Generator] = None,
                           uniform: Optional[UniformFn] = None) -> LossFn:
    """``loss_fn`` plus ``alpha`` x the BCE of the discriminator's
    probability (``dscrm_apply(soft_caps [N, T, V], lens) -> probs [N]``,
    clipped to [1e-7, 1 - 1e-7]) against ``output["conditions"]``.  The
    decoder's words are relaxed into one-hots by ``sample_method``:
    "argmax" (straight-through), "gumbel" (straight-through gumbel-softmax,
    its uniforms from ``uniform(shape, device)`` or else from
    ``generator`` on the logits' device) or "weighted" (the softmax).  The
    discriminator reads ``tgt_len - 1`` words (no <eos>).  Where
    ``output["rows"]`` is (first row, global rows), the uniforms are drawn
    for the global batch and this rank's rows taken."""
    if sample_method not in ("argmax", "gumbel", "weighted"):
        raise ValueError(sample_method)

    def draw(logit: torch.Tensor, rows=None) -> torch.Tensor:
        n = logit.shape[0]
        lo, total = rows if rows is not None else (0, n)
        shape = (total,) + tuple(logit.shape[1:])
        if uniform is not None:
            u = uniform(torch.Size(shape), logit.device).to(logit.dtype)
        else:
            u = torch.rand(shape, generator=generator, device=logit.device,
                           dtype=logit.dtype)
        return u[lo:lo + n]

    def fn(output: Dict) -> torch.Tensor:
        word_loss = loss_fn(output)
        logit = output["logit"]
        if sample_method == "argmax":
            preds = reparameterize_argmax(logit)
        elif sample_method == "gumbel":
            preds = gumbel_softmax(logit, draw(logit, output.get("rows")))
        else:
            preds = torch.softmax(logit, dim=-1)
        probs = torch.clamp(dscrm_apply(preds, output["tgt_len"] - 1),
                            1e-7, 1 - 1e-7)
        cond = output["conditions"].to(probs.dtype)
        bce = -batch_mean(output, cond * torch.log(probs)
                          + (1 - cond) * torch.log(1 - probs))
        return word_loss + alpha * bce
    return fn


def specificity_loss_wrapper(loss_fn: LossFn, word_specificity,
                             sentence_reduce: str = "sum",
                             alpha: float = 1.0) -> LossFn:
    """``loss_fn`` plus ``alpha`` x the MSE between the caption's expected
    specificity and ``output["conditions"]``: each step's word
    distribution times ``word_specificity`` [V], summed ("sum") or
    averaged (else) over the first ``tgt_len - 1`` steps."""
    ws_host = torch.as_tensor(np.asarray(word_specificity, np.float32))

    def fn(output: Dict) -> torch.Tensor:
        word_loss = loss_fn(output)
        probs = torch.softmax(output["logit"], dim=-1)
        cond_pred = probs @ ws_host.to(probs.device, probs.dtype)  # [N, T]
        tgt_len = output["tgt_len"] - 1
        if sentence_reduce == "sum":
            mask = length_mask(tgt_len, cond_pred.shape[1]).to(
                cond_pred.dtype)
            cond_pred = torch.sum(cond_pred * mask, dim=1)
        else:
            cond_pred = mean_with_lens(cond_pred, tgt_len)
        mse = batch_mean(output, (cond_pred - output["conditions"].to(
            cond_pred.dtype)) ** 2)
        return word_loss + alpha * mse
    return fn
