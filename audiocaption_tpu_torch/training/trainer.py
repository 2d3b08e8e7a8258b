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

A batch of a device-resident corpus (``data/device_bank.py``) carries
``wav_idx`` and the bank, ``wav_bank``, in place of ``wav``: the step
gathers the rows on the device (:func:`batch_wav`).  A wave (or feature
row) that arrives as float16, bfloat16 or int16 (the collate's
``wire_dtype``, a float16 bank) is widened to float32 first, int16 /
32768, as in the JAX step.

Under data parallelism (``parallel/mesh.py::ParallelContext``) the batch
is this rank's slice of a global batch and the step is the global
batch's: each mean of the loss divides by the global batch's count (the
output's ``count_sum``, ``losses/loss.py::global_count``), the per-row
draws (SpecAugment's stripes, the condition loss's gumbel noise) are
this rank's rows of the global batch's draw (the output's ``rows``), the
gradients are summed over the data-parallel group before the clip, and
the loss and norm it returns, and the NaN skip, are the global ones.  A
scheduled-sampling coin is one draw for the whole batch, as in JAX, and
the same on every rank.

Only ``nn.Parameter``s with ``requires_grad`` train; the decoder's
positional table ``pe`` is a buffer, so neither Adam nor the weight
decay ever sees it (the JAX optimizer masks it out by name).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Union

import torch
from torch import nn

from audiocaption_tpu_torch.data.device_bank import bank_rows
from audiocaption_tpu_torch.optim.schedules import Schedule, lambda_lr
from audiocaption_tpu_torch.utils.profiling import span, sync


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

    def restore_count(self, count: int) -> None:
        """Set the update count (a full resume's ``lr_count``) and the
        learning rate it gives."""
        self.scheduler.last_epoch = count
        for group, base, fn in zip(self.optimizer.param_groups,
                                   self.scheduler.base_lrs,
                                   self.scheduler.lr_lambdas):
            group["lr"] = base * fn(count)

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


Mark = Optional[Callable[[str], None]]


def mark_part(mark: Mark, name: str) -> None:
    """``mark(name)`` where a step was given a ``mark`` (timing a step's
    parts by CUDA events)."""
    if mark is not None:
        mark(name)


# the batch keys that condition a decoder (the JAX step's
# ``cond_kwargs``): a GRU decoder's, and a conditioned transformer
# decoder's ``event``; a batch's ``keyword`` rides the ``event`` slot
COND_KEYS = ("condition", "style", "structure", "event")


def batch_wav(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``batch`` with its ``wav`` in float32: gathered from ``wav_bank``
    by ``wav_idx`` when the batch carries them (both keys then dropped),
    a float16 / bfloat16 wave widened, an int16 one / 32768."""
    if "wav_idx" in batch:
        batch = dict(batch)
        batch["wav"] = bank_rows(batch.pop("wav_bank"), batch.pop("wav_idx"))
    wav = batch["wav"]
    if wav.dtype in (torch.float16, torch.bfloat16):
        batch = dict(batch, wav=wav.float())
    elif wav.dtype == torch.int16:
        batch = dict(batch, wav=wav.float() / 32768.0)
    return batch


def train_step(state: TrainState, loss_fn: Callable[[Dict], torch.Tensor],
               batch: Dict[str, torch.Tensor],
               ss_ratio: Union[float, torch.Tensor] = 1.0,
               generator: Optional[torch.Generator] = None,
               specaug: bool = False,
               specaug_generator: Optional[torch.Generator] = None,
               mark: Mark = None,
               parallel=None) -> Dict[str, torch.Tensor]:
    """One training step on ``batch`` (wav [B, T] float32, wav_len [B],
    cap [B, L] ids, cap_len [B], on the model's device; a
    ``temporal_tag`` [B], and a ``condition`` [B], ``style`` [B, E],
    ``structure`` [B] or ``event`` / ``keyword`` [B, C] (the keyword as
    ``event``), go to the forward, as in the JAX step; the
    ``condition`` also goes to the loss as ``conditions``, which the JAX
    step leaves out though its condition and specificity losses read it,
    ROADMAP Queue 3) ->
    {loss, grad_norm (raw, before the clip), skipped}.  ``ss_ratio`` and
    ``generator`` go to ``Captioner.forward``: the Python float 1.0 takes
    the teacher-forcing path, anything else scheduled sampling.
    ``specaug`` and ``specaug_generator`` (on the batch's device) too:
    SpecAugment on the log-mel.  A parameter the loss does not reach
    takes a zero gradient (:func:`zero_unreached_grads`).
    ``mark(name)``, if given, is called after
    the forward and loss ("forward"), the backward and clip ("backward")
    and the optimizer ("optimizer"), for the caller's timers.
    ``parallel``: a ``parallel.mesh.ParallelContext`` when ``batch`` is
    this rank's slice of a global batch (see the module docstring).
    Its parts are the spans ``ac.train.forward``, ``ac.train.backward``
    and ``ac.train.optimizer`` (``utils/profiling.py``), at the ``mark``
    boundaries; the host's one wait is ``ac.sync.finite_check``."""
    with span("ac.train.forward"):
        batch = batch_wav(batch)
        model = state.model
        model.train()
        buffers = bn_buffers(model)
        saved = [b.clone() for b in buffers]
        state.optimizer.zero_grad(set_to_none=True)
        tag = ({"temporal_tag": batch["temporal_tag"]}
               if "temporal_tag" in batch else {})
        cond = {k: batch[k] for k in COND_KEYS if k in batch}
        if "keyword" in batch:
            cond["event"] = batch["keyword"]
        rows = None if parallel is None else parallel.rows(len(batch["cap"]))
        out = model(batch["wav"], batch["wav_len"], batch["cap"],
                    batch["cap_len"], ss_ratio=ss_ratio, generator=generator,
                    specaug=specaug, specaug_generator=specaug_generator,
                    cond_kwargs=cond, specaug_rows=rows, **tag)
        out["tgt"] = batch["cap"][:, 1:]
        out["tgt_len"] = batch["cap_len"] - 1
        if "condition" in batch:
            out["conditions"] = batch["condition"]
        if parallel is not None:
            out["count_sum"], out["rows"] = parallel.sum, rows
        loss = loss_fn(out)
    mark_part(mark, "forward")
    with span("ac.train.backward"):
        loss.backward()
        zero_unreached_grads(state.params)
        if parallel is not None:
            parallel.reduce_grads(state.params)
            loss = parallel.sum(loss)
        # the raw norm; the gradients are clipped in place (a non-finite
        # norm leaves them non-finite, and they are then dropped)
        grad_norm = clip_grad_norm(state.params, state.max_grad_norm,
                                   parallel=parallel)
    mark_part(mark, "backward")
    with span("ac.train.optimizer"):
        with sync("finite_check"):
            ok = bool(torch.isfinite(loss) & torch.isfinite(grad_norm))
        if ok:
            state.optimizer.step()
            state.scheduler.step()
        else:
            state.optimizer.zero_grad(set_to_none=True)
            with torch.no_grad():
                for b, s in zip(buffers, saved):
                    b.copy_(s)
    mark_part(mark, "optimizer")
    return {"loss": loss.detach(), "grad_norm": grad_norm.detach(),
            "skipped": not ok}


def zero_unreached_grads(params) -> None:
    """A zero gradient for each parameter the loss did not reach (an
    encoder's fc head under a transformer decoder, the decoder in an
    unsup encoder-KD step), as the JAX step has: Adam then decays its
    moments and applies its L2 term, where torch's Adam would skip a
    parameter without a gradient."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def clip_grad_norm(params, max_norm: float,
                   dtype: torch.dtype = torch.float64,
                   parallel=None) -> torch.Tensor:
    """``nn.utils.clip_grad_norm_`` with the norms taken in ``dtype``
    (``torch._foreach_norm``'s): float64 by default, since on the CPU a
    float32 sum over a tensor of tens of millions of elements (the Cnn14's
    2048 x 2048 x 3 x 3 convolutions) drifts by ~1e-3, where the JAX
    package's reduction stays near float32 rounding.  KD's step passes
    float32 (:func:`apply_update`).  Scales the gradients
    in place by min(1, max_norm / (norm + 1e-6)); returns the raw norm
    (float32).  ``parallel`` (a ``ParallelContext``) takes the norm
    (over the shards, where parameters are split across ranks)."""
    params = list(params)
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if parallel is not None:
        norm = parallel.grad_norm(params, dtype)
    else:
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads, 2, dtype=dtype)))
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    torch._foreach_mul_(grads, coef.to(grads[0].dtype))
    return norm.float()


def apply_update(state, loss: torch.Tensor, mark: Mark = None,
                 norm_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Backward, the global-norm clip and the optimizer step on ``state``
    (its gradients zeroed before the caller's forward) -> the raw
    gradient norm, before the clip.  A parameter the loss does not reach
    takes a zero gradient (:func:`zero_unreached_grads`).  The clip's norms are float32 by default, as the JAX KD step's are:
    the KD student's largest tensor holds 0.64 M values, far from the tens
    of millions at which a float32 sum drifts, and with float64 norms the
    weights leave JAX's by float32 rounding in the other direction, enough
    to flip a LeakyReLU kink in the one-step parity test
    (``tests/test_torch_kd.py``, token step 2).  The augmented step of the
    Cnn14 asks for float64 (``norm_dtype``; ``training/aug_runner.py``)."""
    loss.backward()
    zero_unreached_grads(state.params)
    grad_norm = clip_grad_norm(state.params, state.max_grad_norm,
                               dtype=norm_dtype)
    mark_part(mark, "backward")
    state.optimizer.step()
    state.scheduler.step()
    mark_part(mark, "optimizer")
    return grad_norm.detach()


def bn_buffers(model: nn.Module) -> List[torch.Tensor]:
    """The running statistics and batch counts of every batch norm."""
    return [b for m in model.modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm)
            for b in m.buffers()]
