"""Caption training losses (counterpart of
``audiocaption_tpu/losses/loss.py``): pure functions over the model's
output dict, with the length mask of the reference (mean = sum over
valid tokens / their count)."""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from audiocaption_tpu_torch.ops.masking import length_mask


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
    reference's ``loss_fn(output_dict)`` protocol)."""
    def fn(output: Dict) -> torch.Tensor:
        if kind == "cross_entropy":
            return cross_entropy_loss(output["logit"], output["tgt"],
                                      output["tgt_len"], reduction)
        return label_smoothing_loss(output["logit"], output["tgt"],
                                    output["tgt_len"], smoothing, reduction)
    return fn


def build_loss(config: Dict) -> Callable[[Dict], torch.Tensor]:
    """A loss from a config node {type, args}; our names or the
    reference's dotted paths.  The composite wrappers of the JAX package
    (``MultipleLossSum``, ``AugmentLossWrapper``, ``ConditionLossWrapper``
    with its discriminator, ``SpecificityLossWrapper``) are not ported
    (ROADMAP Queue 1 item 6) and raise."""
    type_name = config.get("type", "LabelSmoothingLoss").split(".")[-1]
    args = config.get("args", {}) or {}
    if type_name == "LabelSmoothingLoss":
        return masked_token_loss("label_smoothing",
                                 args.get("smoothing", 0.0))
    if type_name == "CrossEntropyLoss":
        return masked_token_loss("cross_entropy")
    raise ValueError(f"loss type {type_name!r} is not ported yet "
                     "(ROADMAP Queue 1 item 6)")
