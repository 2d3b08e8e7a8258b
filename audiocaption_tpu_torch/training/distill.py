"""Knowledge-distillation training steps (counterpart of
``audiocaption_tpu/training/distill.py``).

Three modes, the JAX runner's ``kd.type``:

  * token KD (:func:`token_kd_step`): the student's label-smoothed loss
    mixed with a divergence from the teacher's logits on the same
    captions (``losses.kd.token_kd_loss``, ``sup_kd_loss``); the teacher's
    logits come from :func:`teacher_logits`;
  * sequence KD: the teacher greedy-decodes each clip once
    (:func:`teacher_captions`), cached per audio id by
    :func:`generate_pseudo_captions`, and the student trains on those
    captions with the plain train step;
  * encoder KD (:func:`encoder_kd_step`): the caption loss plus a head's
    loss (``losses.kd.ContraEncoderKdHead``) between the student's
    pooled embedding and the teacher's (:func:`teacher_embedding`, or an
    npz); ``unsup`` runs ``Captioner.encode`` alone, without captions.

The steps apply every update, as the JAX steps do: no NaN skip, unlike
``trainer.train_step``.  They use the trainer's Adam with L2 weight
decay, its global-norm clip and its schedule (``trainer.TrainState``);
an encoder-KD head's parameters join that optimizer
(``create_train_state(..., head=...)``).

The student's forward is teacher-forced.  The JAX runner passes its
steps a traced ``ss_ratio`` of 1.0, which takes its cached
scheduled-sampling path; every coin there picks the teacher pass's
logits, so its loss and gradients are those of teacher forcing (the
extra decode steps it runs feed nothing).

``mark(name)``, where given, is called after each part of a step
("student", "loss", "backward", "optimizer"), for timing by CUDA events.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from audiocaption_tpu_torch.losses.kd import sup_kd_loss, token_kd_loss
from audiocaption_tpu_torch.losses.loss import masked_token_loss
from audiocaption_tpu_torch.models.captioner import generate
from audiocaption_tpu_torch.training.trainer import clip_grad_norm

Mark = Optional[Callable[[str], None]]


def _mark(mark: Mark, name: str) -> None:
    if mark is not None:
        mark(name)


@torch.no_grad()
def teacher_logits(teacher, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The teacher's teacher-forced logits [B, Lc-1, V] on the batch's
    captions, in ``eval()`` (the JAX runner's ``ss_ratio=1.0,
    train=False``)."""
    teacher.eval()
    return teacher(batch["wav"], batch["wav_len"], batch["cap"],
                   batch["cap_len"])["logit"]


@torch.no_grad()
def teacher_embedding(teacher, wav: torch.Tensor, wav_len: torch.Tensor
                      ) -> torch.Tensor:
    """The teacher encoder's pooled ``fc_emb`` [B, D], in ``eval()``."""
    teacher.eval()
    return teacher.encode(wav, wav_len)["fc_emb"]


@torch.no_grad()
def teacher_captions(teacher, wav: torch.Tensor, wav_len: torch.Tensor,
                     fused=None) -> torch.Tensor:
    """The teacher's greedy ids [B, max_length] (the JAX ``generate(...,
    "greedy")``): through ``fused`` (a ``FusedGreedyDecoder`` of the
    teacher, the greedy kernel) where given, else the torch engine."""
    teacher.eval()
    if fused is not None:
        return fused(wav, wav_len)
    return generate(teacher, wav, wav_len, sample_method="greedy")["seq"]


def apply_update(state, loss: torch.Tensor, mark: Mark = None
                 ) -> torch.Tensor:
    """Backward, the global-norm clip and the optimizer step on ``state``
    (its gradients zeroed before the caller's forward) -> the raw
    gradient norm, before the clip.  A parameter the loss does not reach
    (the decoder in an unsup encoder-KD step) takes a zero gradient, as
    in the JAX step: Adam still decays its moments and applies the L2
    term, where torch's Adam would skip a parameter without a gradient.
    The clip's norms are float32, as the JAX step's are: the student's
    largest tensor holds 0.64 M values, far from the tens of millions at
    which a float32 sum drifts, and with float64 norms the weights leave
    JAX's by float32 rounding in the other direction, enough to flip a
    LeakyReLU kink in the one-step parity test
    (``tests/test_torch_kd.py``, token step 2)."""
    loss.backward()
    for p in state.params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grad_norm = clip_grad_norm(state.params, state.max_grad_norm,
                               dtype=torch.float32)
    _mark(mark, "backward")
    state.optimizer.step()
    state.scheduler.step()
    _mark(mark, "optimizer")
    return grad_norm.detach()


def token_kd_step(state, batch: Dict[str, torch.Tensor],
                  kd_weight: float = 0.5, kd_type: str = "kl",
                  temperature: float = 1.0, smoothing: float = 0.1,
                  mark: Mark = None) -> Dict[str, torch.Tensor]:
    """One token-KD step on ``batch`` (wav, wav_len, cap, cap_len and
    ``teacher_logit`` [B, Lc-1, V], on the model's device) ->
    {loss, sup_loss, kd_loss, grad_norm (raw)}."""
    model = state.model
    model.train()
    state.optimizer.zero_grad(set_to_none=True)
    out = model(batch["wav"], batch["wav_len"], batch["cap"],
                batch["cap_len"])
    _mark(mark, "student")
    out["tgt"] = batch["cap"][:, 1:]
    out["tgt_len"] = batch["cap_len"] - 1
    sup = masked_token_loss("label_smoothing", smoothing)(out)
    kd = token_kd_loss(out["logit"], batch["teacher_logit"], out["tgt_len"],
                       kd_type, temperature)
    loss = sup_kd_loss(sup, kd, kd_weight)
    _mark(mark, "loss")
    grad_norm = apply_update(state, loss, mark)
    return {"loss": loss.detach(), "sup_loss": sup.detach(),
            "kd_loss": kd.detach(), "grad_norm": grad_norm}


def encoder_kd_step(state, head: nn.Module, batch: Dict[str, torch.Tensor],
                    kd_weight: float = 1.0, smoothing: float = 0.1,
                    unsup: bool = False, mark: Mark = None
                    ) -> Dict[str, torch.Tensor]:
    """One encoder-KD step: the caption loss (none with ``unsup``) plus
    ``kd_weight`` times ``head(student fc_emb, batch["tchr_emb"])``; the
    head's parameters must be in ``state``'s optimizer.  ``batch``: wav,
    wav_len, tchr_emb [B, D] and, without ``unsup``, cap and cap_len.
    -> {loss, kd_loss, grad_norm (raw)}."""
    model = state.model
    model.train()
    head.train()
    state.optimizer.zero_grad(set_to_none=True)
    if unsup:
        with torch.no_grad():
            lms = model.frontend(batch["wav"])
        fc_emb = model.encode_lms(lms, model.mel.feat_len(
            batch["wav_len"]))["fc_emb"]
        sup = 0.0
    else:
        out = model(batch["wav"], batch["wav_len"], batch["cap"],
                    batch["cap_len"])
        out["tgt"] = batch["cap"][:, 1:]
        out["tgt_len"] = batch["cap_len"] - 1
        sup = masked_token_loss("label_smoothing", smoothing)(out)
        fc_emb = out["fc_emb"]
    _mark(mark, "student")
    kd = head(fc_emb, batch["tchr_emb"])
    loss = sup + kd_weight * kd
    _mark(mark, "loss")
    grad_norm = apply_update(state, loss, mark)
    return {"loss": loss.detach(), "kd_loss": kd.detach(),
            "grad_norm": grad_norm}


def generate_pseudo_captions(
        teacher_generate: Callable[[np.ndarray, np.ndarray], List[str]],
        loader, cache: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Sequence KD: the teacher's caption of every audio id the loader
    yields, ``teacher_generate(wav, wav_len)`` called only for batches
    with an id not yet in ``cache`` (a copy is returned)."""
    cache = dict(cache or {})
    for batch in loader:
        todo = [i for i, aid in enumerate(batch["audio_id"])
                if aid not in cache]
        if not todo:
            continue
        caps = teacher_generate(batch["wav"], batch["wav_len"])
        for i in todo:
            cache[batch["audio_id"][i]] = caps[i]
    return cache
