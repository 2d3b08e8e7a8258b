"""Caption training losses (counterpart of
``audiocaption_tpu/losses/loss.py``): pure functions over the model's
output dict, with the length mask of the reference (mean = sum over
valid tokens / their count).

Under data parallelism a rank's output dict holds its slice of the global
batch and a ``count_sum`` (``training/trainer.py::train_step``): a mean's
denominator is then the global batch's count, so that the ranks' losses
sum to the global batch's mean (:func:`global_count`)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from audiocaption_tpu_torch.ops.masking import length_mask


def global_count(output: Dict, local: torch.Tensor) -> torch.Tensor:
    """The denominator of a mean over the global batch: ``local``, this
    batch's count, summed over the ranks that hold the global batch's
    slices by ``output["count_sum"]`` where the step is data parallel;
    ``local`` itself in one process."""
    count_sum = output.get("count_sum")
    return local if count_sum is None else count_sum(local)


def batch_mean(output: Dict, x: torch.Tensor) -> torch.Tensor:
    """The mean of the per-sample ``x`` [N] over the global batch:
    ``x.mean()`` in one process, sum(x) / the global sample count under
    data parallelism (:func:`global_count`)."""
    if "count_sum" not in output:
        return torch.mean(x)
    return torch.sum(x) / global_count(output, x.new_tensor(x.shape[0]))


def _reduce(loss: torch.Tensor, mask: torch.Tensor,
            reduction: str) -> torch.Tensor:
    loss = loss * mask
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        return loss.sum() / mask.sum()
    raise ValueError(reduction)


def cross_entropy_loss(logit: torch.Tensor, tgt: torch.Tensor,
                       tgt_len: torch.Tensor,
                       reduction: str = "mean") -> torch.Tensor:
    """Token cross entropy under the length mask: logit [B, L, V],
    tgt [B, L] ids, tgt_len [B]."""
    lp = F.log_softmax(logit.float(), dim=-1)
    nll = -lp.gather(-1, tgt[..., None].long())[..., 0]
    mask = length_mask(tgt_len, tgt.shape[1]).float()
    return _reduce(nll, mask, reduction)


def label_smoothing_loss(logit: torch.Tensor, tgt: torch.Tensor,
                         tgt_len: torch.Tensor, smoothing: float = 0.1,
                         reduction: str = "mean") -> torch.Tensor:
    """Smoothed cross entropy as the reference computes it: its target
    distribution is ``fill_(smoothing / (V - 1))`` then ``scatter_`` of
    ``1 - smoothing`` at the target, so the target's share is the
    confidence alone (the scatter overwrites the base mass there)."""
    V = logit.shape[-1]
    lp = F.log_softmax(logit.float(), dim=-1)
    confidence = 1.0 - smoothing
    base = smoothing / (V - 1)
    # -sum(true_dist * lp) = -(base * sum(lp)) - (confidence - base) * lp[tgt]
    lp_tgt = lp.gather(-1, tgt[..., None].long())[..., 0]
    loss = -(base * lp.sum(-1) + (confidence - base) * lp_tgt)
    mask = length_mask(tgt_len, tgt.shape[1]).float()
    return _reduce(loss, mask, reduction)


def masked_token_loss(kind: str = "label_smoothing", smoothing: float = 0.1,
                      reduction: str = "mean"
                      ) -> Callable[[Dict], torch.Tensor]:
    """Loss over an output dict with keys logit / tgt / tgt_len (the
    reference's ``loss_fn(output_dict)`` protocol); the mean's count is
    the global batch's tokens (:func:`global_count`)."""
    def loss(output: Dict, reduction: str) -> torch.Tensor:
        if kind == "cross_entropy":
            return cross_entropy_loss(output["logit"], output["tgt"],
                                      output["tgt_len"], reduction)
        return label_smoothing_loss(output["logit"], output["tgt"],
                                    output["tgt_len"], smoothing, reduction)

    def fn(output: Dict) -> torch.Tensor:
        if reduction != "mean" or "count_sum" not in output:
            return loss(output, reduction)
        mask = length_mask(output["tgt_len"], output["tgt"].shape[1])
        return loss(output, "sum") / global_count(output,
                                                  mask.float().sum())
    return fn


def build_loss(config: Dict, generator: Optional[torch.Generator] = None,
               device=None) -> Callable[[Dict], torch.Tensor]:
    """A loss from a config node {type, args}; our names or the
    reference's dotted paths.  The composite wrappers build recursively
    (``losses/wrappers.py``):

      MultipleLossSum         args: {losses: [node, ...], weights: [...]}
      AugmentLossWrapper      args: {loss: node}, the inner label-smoothing
                              or cross-entropy loss with
                              ``reduction="none"``
      ConditionLossWrapper    args: {loss: node, dscrm: {vocab_size,
                              emb_dim, hidden_size, checkpoint | seed},
                              alpha, sample_method}; "gumbel" draws
                              from ``generator``
      SpecificityLossWrapper  args: {loss: node, word_specificity: a .npy
                              path or an array [V], sentence_reduce, alpha}

    ``device`` is where the discriminator runs."""
    type_name = config.get("type", "LabelSmoothingLoss").split(".")[-1]
    args = config.get("args", {}) or {}
    if type_name == "LabelSmoothingLoss":
        return masked_token_loss("label_smoothing",
                                 args.get("smoothing", 0.0))
    if type_name == "CrossEntropyLoss":
        return masked_token_loss("cross_entropy")
    if type_name == "MultipleLossSum":
        from audiocaption_tpu_torch.losses.wrappers import multiple_loss_sum
        return multiple_loss_sum(
            [build_loss(c, generator, device)
             for c in args["losses"]], args["weights"])
    if type_name == "AugmentLossWrapper":
        from audiocaption_tpu_torch.losses.wrappers import (
            augment_loss_wrapper)
        inner = args.get("loss", {"type": "LabelSmoothingLoss"})
        inner_type = inner.get("type", "LabelSmoothingLoss").split(".")[-1]
        return augment_loss_wrapper(masked_token_loss(
            "cross_entropy" if inner_type == "CrossEntropyLoss"
            else "label_smoothing",
            (inner.get("args", {}) or {}).get("smoothing", 0.0),
            reduction="none"))
    if type_name == "ConditionLossWrapper":
        from audiocaption_tpu_torch.losses.wrappers import (
            condition_loss_wrapper)
        inner = build_loss(args.get("loss", {"type": "LabelSmoothingLoss"}))
        return condition_loss_wrapper(
            inner, build_dscrm_apply(args["dscrm"], device),
            alpha=args.get("alpha", 1.0),
            sample_method=args.get("sample_method", "argmax"),
            generator=generator)
    if type_name == "SpecificityLossWrapper":
        from audiocaption_tpu_torch.losses.wrappers import (
            specificity_loss_wrapper)
        inner = build_loss(args.get("loss", {"type": "LabelSmoothingLoss"}))
        ws = args["word_specificity"]
        return specificity_loss_wrapper(
            inner, np.load(ws) if isinstance(ws, str) else ws,
            sentence_reduce=args.get("sentence_reduce", "sum"),
            alpha=args.get("alpha", 1.0))
    raise ValueError(f"unknown loss type: {type_name}")


def build_dscrm_apply(cfg: Dict, device=None) -> Callable:
    """The condition loss's discriminator: an ``HmClassifier``
    (``vocab_size``, ``emb_dim`` 256, ``hidden_size`` 256), frozen ->
    fn(soft_caps [N, T, V], lens [N]) -> sigmoid probs [N].
    Its weights come from ``checkpoint``, a ``.pth`` holding the port's
    ``HmClassifier`` state dict (plain or under ``"model"``; a JAX
    discriminator's params convert with
    ``models.convert.jax_tree_state_dict``), or else are drawn from
    ``seed`` (0) by ``models.zoo.random_init``.  The JAX package reads a
    flax msgpack here, which the port does not read."""
    from audiocaption_tpu_torch.models.hm_classifier import HmClassifier
    from audiocaption_tpu_torch.models.zoo import random_init
    model = HmClassifier(vocab_size=cfg["vocab_size"],
                         emb_dim=cfg.get("emb_dim", 256),
                         hidden_size=cfg.get("hidden_size", 256))
    if cfg.get("checkpoint"):
        sd = torch.load(cfg["checkpoint"], map_location="cpu")
        model.load_state_dict(sd.get("model", sd))
    else:
        random_init(model, torch.Generator().manual_seed(cfg.get("seed", 0)))
    # train(): cuDNN runs a GRU's backward (the loss's gradient reaches
    # the decoder through it) in training mode only; the classifier has
    # no dropout or batch norm, so its output is the eval output
    model = model.to(device or "cpu").train().requires_grad_(False)

    def apply(soft_caps: torch.Tensor, tgt_len: torch.Tensor
              ) -> torch.Tensor:
        return torch.sigmoid(model(soft_caps, tgt_len))
    apply.model = model
    return apply
