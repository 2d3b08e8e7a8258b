"""Training step (counterpart of ``audiocaption_tpu/training/trainer.py``).

One step: forward in ``train()`` mode, loss, backward, the raw global
gradient norm, clip to ``max_grad_norm``, then Adam with L2 weight decay
(torch ``Adam(weight_decay=w)`` adds ``w * p`` to the gradient before the
moments, as the JAX chain's ``add_decayed_weights`` before
``scale_by_adam``) and a per-update learning-rate schedule
(``optim.schedules.lambda_lr``).

The reference's NaN skip: a step whose loss or raw gradient norm is not
finite changes nothing: no parameter, no Adam moment or step count, no
learning-rate count, and no batch-norm running statistic.  Torch updates
those statistics inside the forward, so the step copies the model's
buffers before it and writes them back on a skip.

Only ``nn.Parameter``s with ``requires_grad`` train; the decoder's
positional table ``pe`` is a buffer, so neither Adam nor the weight
decay ever sees it (the JAX optimizer masks it out by name).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Union

import torch
from torch import nn

from audiocaption_tpu_torch.optim.schedules import Schedule, lambda_lr


@dataclasses.dataclass
class TrainState:
    """The model with its optimizer and learning-rate scheduler.
    ``lr_count`` counts the updates applied, which set the learning
    rate."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    max_grad_norm: float = 1.0

    @property
    def lr_count(self) -> int:
        return self.scheduler.last_epoch

    @property
    def params(self) -> List[nn.Parameter]:
        return [p for group in self.optimizer.param_groups
                for p in group["params"]]


def make_optimizer(model: nn.Module, base_lr: float, schedule: Schedule,
                   weight_decay: float = 1e-6,
                   head: Optional[nn.Module] = None):
    """-> (Adam over the trainable parameters of ``model`` and of
    ``head``, e.g. an encoder-KD head, its LambdaLR)."""
    params = [p for m in (model, head) if m is not None
              for p in m.parameters() if p.requires_grad]
    optimizer = torch.optim.Adam(params, lr=base_lr,
                                 weight_decay=weight_decay)
    return optimizer, lambda_lr(optimizer, schedule, base_lr)


def create_train_state(model: nn.Module, base_lr: float, schedule: Schedule,
                       weight_decay: float = 1e-6,
                       max_grad_norm: float = 1.0,
                       head: Optional[nn.Module] = None) -> TrainState:
    optimizer, scheduler = make_optimizer(model, base_lr, schedule,
                                          weight_decay, head)
    return TrainState(model, optimizer, scheduler, max_grad_norm)


def train_step(state: TrainState, loss_fn: Callable[[Dict], torch.Tensor],
               batch: Dict[str, torch.Tensor],
               ss_ratio: Union[float, torch.Tensor] = 1.0,
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
    """One training step on ``batch`` (wav [B, T] float32, wav_len [B],
    cap [B, L] ids, cap_len [B], on the model's device; a
    ``temporal_tag`` [B] goes to the forward) ->
    {loss, grad_norm (raw, before the clip), skipped}.  ``ss_ratio`` and
    ``generator`` go to ``Captioner.forward``: the Python float 1.0 takes
    the teacher-forcing path, anything else scheduled sampling."""
    model = state.model
    model.train()
    buffers = bn_buffers(model)
    saved = [b.clone() for b in buffers]
    state.optimizer.zero_grad(set_to_none=True)
    cond = ({"temporal_tag": batch["temporal_tag"]}
            if "temporal_tag" in batch else {})
    out = model(batch["wav"], batch["wav_len"], batch["cap"],
                batch["cap_len"], ss_ratio=ss_ratio, generator=generator,
                **cond)
    out["tgt"] = batch["cap"][:, 1:]
    out["tgt_len"] = batch["cap_len"] - 1
    loss = loss_fn(out)
    loss.backward()
    # the raw norm; the gradients are clipped in place (a non-finite norm
    # leaves them non-finite, and they are then dropped)
    grad_norm = clip_grad_norm(state.params, state.max_grad_norm)
    ok = bool(torch.isfinite(loss) & torch.isfinite(grad_norm))
    if ok:
        state.optimizer.step()
        state.scheduler.step()
    else:
        state.optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():
            for b, s in zip(buffers, saved):
                b.copy_(s)
    return {"loss": loss.detach(), "grad_norm": grad_norm.detach(),
            "skipped": not ok}


def clip_grad_norm(params, max_norm: float,
                   dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """``nn.utils.clip_grad_norm_`` with the norms taken in ``dtype``
    (``torch._foreach_norm``'s): float64 by default, since on the CPU a
    float32 sum over a tensor of tens of millions of elements (the Cnn14's
    2048 x 2048 x 3 x 3 convolutions) drifts by ~1e-3, where the JAX
    package's reduction stays near float32 rounding.  KD's step passes
    float32 (``training/distill.py::apply_update``).  Scales the gradients
    in place by min(1, max_norm / (norm + 1e-6)); returns the raw norm
    (float32)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm = torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(grads, 2, dtype=dtype)))
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    torch._foreach_mul_(grads, coef.to(grads[0].dtype))
    return norm.float()


def bn_buffers(model: nn.Module) -> List[torch.Tensor]:
    """The running statistics and batch counts of every batch norm."""
    return [b for m in model.modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm)
            for b in m.buffers()]
