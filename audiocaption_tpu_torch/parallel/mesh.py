"""Data parallelism over ``torch.distributed`` (counterpart of
``audiocaption_tpu/parallel/mesh.py``).

The JAX package runs one jitted step over a mesh: the batch is sharded on
its first axis, the parameters are replicated, XLA inserts the gradient
all-reduce, and batch norm sees the global batch (the reference's DDP
with SyncBatchNorm, run_ddp.py:33-108).  Here each process (a rank: one
card, or one CPU process on gloo) holds a replica and:

  * every rank's loader yields the same global batch in the same order;
    :func:`shard_batch` hands a rank its contiguous slice, after
    :func:`pad_to_world` repeats leading rows so that the world size
    divides the batch (JAX's ``_pad_to_devices``, DistributedSampler's
    wraparound);
  * :class:`ParallelContext` makes the step the global batch's: each
    mean of the loss divides by the global batch's count (one all-reduce
    a mean), a per-row draw takes this rank's rows of the global batch's
    draw, gradients are summed over the data-parallel group, and the
    clip, the NaN skip and the logged norm read the summed gradient;
  * :func:`sync_batch_norm` turns every batch norm into one whose training
    statistics (mean and variance) are taken over the group's global
    batch, with the gradient through them, on gloo or NCCL
    (``nn.SyncBatchNorm`` refuses CPU tensors).

:func:`init_distributed` starts the process group from ``torchrun``'s
environment or explicit arguments: NCCL for CUDA, gloo for the CPU.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     device: Optional[torch.device] = None,
                     backend: Optional[str] = None,
                     timeout_s: float = 1800.0) -> None:
    """Join the default process group: from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) when no
    argument is given, else at ``init_method`` (``tcp://host:port``) as
    ``rank`` of ``world_size``.  The backend is NCCL for a CUDA ``device``
    (gloo where ``backend`` says so: NCCL refuses two ranks on one card),
    gloo for the CPU.  A CUDA rank's current device is ``LOCAL_RANK``'s
    card."""
    if dist.is_initialized():
        return
    device = torch.device(device if device is not None else "cpu")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              if device.index is None else device.index)
    kwargs = dict(backend=backend,
                  timeout=datetime.timedelta(seconds=timeout_s))
    if init_method is not None:
        kwargs.update(init_method=init_method, world_size=world_size,
                      rank=rank)
    dist.init_process_group(**kwargs)


def rank_and_size(group=None):
    """(this process's rank in ``group``, its size); (0, 1) with no process
    group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def pad_to_world(batch: dict, n: int) -> dict:
    """``batch`` with its leading rows repeated until ``n`` divides its
    size (real samples counted twice, no filler rows in the loss)."""
    B = len(batch["wav"] if "wav" in batch else batch["wav_idx"])
    rem = (-B) % n
    if rem == 0:
        return batch
    idx = np.arange(rem) % B
    out = {}
    for k, v in batch.items():
        if torch.is_tensor(v):
            out[k] = torch.cat([v, v[torch.as_tensor(idx)]])
        elif isinstance(v, np.ndarray):
            out[k] = np.concatenate([v, v[idx]])
        else:
            out[k] = list(v) + [v[i] for i in idx]
    return out


def shard_batch(batch: dict, rank: Optional[int] = None,
                world_size: Optional[int] = None) -> dict:
    """Rank ``rank``'s contiguous slice of the global ``batch`` (every
    first-axis entry: tensors, arrays, lists), whose size ``world_size``
    divides (:func:`pad_to_world`)."""
    if rank is None or world_size is None:
        rank, world_size = rank_and_size()
    B = len(batch["wav"] if "wav" in batch else batch["wav_idx"])
    if B % world_size:
        raise ValueError(f"a batch of {B} does not split over {world_size} "
                         "ranks; pad it first (pad_to_world)")
    lo, hi = rank * B // world_size, (rank + 1) * B // world_size
    return {k: v[lo:hi] for k, v in batch.items()}


def replicate(module: nn.Module, src: int = 0, group=None) -> nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank ``src``."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src, group=group)
    return module


class _GroupSum(torch.autograd.Function):
    """Sum over the group's ranks; the gradient is summed the same way
    (each rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def group_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    return _GroupSum.apply(x, group)


class _CrossRankBatchNorm:
    """Mixin over a batch-norm class: in training, with a group of more
    than one rank, the statistics are the global batch's (two passes: the
    mean, then the mean squared deviation), and the running buffers move
    as torch's do (the unbiased variance of the global count)."""

    process_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and dist.is_initialized()
                and dist.get_world_size(self.process_group) > 1):
            return super().forward(x)
        xf = x.float()
        dims = [0] + list(range(2, x.ndim))
        shape = [1, -1] + [1] * (x.ndim - 2)
        count = torch.tensor([xf.numel() / xf.shape[1]], device=x.device,
                             dtype=torch.float32)
        stats = group_sum(torch.cat([xf.sum(dims), count]),
                          self.process_group)
        n = stats[-1]
        mean = stats[:-1] / n
        var = group_sum((xf - mean.view(shape)).pow(2).sum(dims),
                        self.process_group) / n
        y = (xf - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        if self.affine:
            y = y * self.weight.view(shape) + self.bias.view(shape)
        if self.track_running_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * var * n / (n - 1))
                self.num_batches_tracked.add_(1)
        cd = getattr(self, "compute_dtype", None)
        return y.to(cd) if cd is not None else y.to(x.dtype)


def sync_batch_norm(model: nn.Module, group=None) -> nn.Module:
    """Every batch norm of ``model`` (in place) takes its training
    statistics over ``group``'s ranks (:class:`_CrossRankBatchNorm`); its
    parameters, buffers and state-dict keys stay as they were."""
    classes = {}
    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm) \
                and not isinstance(m, _CrossRankBatchNorm):
            if m.momentum is None:
                raise ValueError("a cumulative-average batch norm "
                                 "(momentum None) is not supported")
            cls = type(m)
            if cls not in classes:
                classes[cls] = type(f"CrossRank{cls.__name__}",
                                    (_CrossRankBatchNorm, cls), {})
            m.__class__ = classes[cls]
            m.process_group = group
    return model


def grads_norm(grads: List[torch.Tensor], dtype: torch.dtype,
               device=None) -> torch.Tensor:
    """The 2-norm of all of ``grads`` together, the norms taken in
    ``dtype``; zero for no gradients."""
    if not grads:
        return torch.zeros((), dtype=dtype, device=device)
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(grads, 2, dtype=dtype)))


@dataclasses.dataclass
class ParallelContext:
    """What a train step needs to compute the global batch's step when its
    batch is this rank's slice: the data-parallel group, whose ranks hold
    the slices of one global batch in rank order (:func:`shard_batch`)."""
    dp_group: Any = None

    def rows(self, n: int) -> Tuple[int, int]:
        """(the first row of this rank's slice of ``n`` rows, the global
        batch's rows): where a per-row draw takes this rank's rows."""
        rank, size = rank_and_size(self.dp_group)
        return rank * n, size * n

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data-parallel group (no gradient): a
        mean's global count, the global loss."""
        x = x.detach().clone()
        dist.all_reduce(x, group=self.dp_group)
        return x

    def reduce_grads(self, params: Iterable[nn.Parameter]) -> None:
        """Sum every gradient over the data-parallel group, in one
        flattened all-reduce per dtype and device."""
        grads = [p.grad for p in params if p.grad is not None]
        buckets = {}
        for g in grads:
            buckets.setdefault((g.dtype, g.device), []).append(g)
        for group in buckets.values():
            flat = torch.cat([g.reshape(-1) for g in group])
            dist.all_reduce(flat, group=self.dp_group)
            offset = 0
            for g in group:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()

    def grad_norm(self, params: List[nn.Parameter],
                  dtype: torch.dtype) -> torch.Tensor:
        """The norm of the summed gradients (every rank holds them all)."""
        return grads_norm([p.grad for p in params if p.grad is not None],
                          dtype, params[0].device)


def launched_by_torchrun() -> bool:
    """Whether the process runs under ``torchrun`` (its ``RANK`` and
    ``WORLD_SIZE`` are set)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def data_parallel_context(model: nn.Module, device: torch.device
                          ) -> Optional[ParallelContext]:
    """Under ``torchrun``: join the process group (NCCL on CUDA, gloo on
    the CPU), copy rank 0's weights to every rank, make the batch norms
    cross-rank, give each rank's card its own dropout stream, and return
    the context of the train step; None in a process that ``torchrun``
    did not start.  A world of one rank runs the same path (its
    collectives change nothing, and rank 0 keeps its stream).

    Dropout draws from the device's default generator, which every rank
    seeded alike; rank r > 0 reseeds its card's with the seed plus r, so
    that the slices do not share masks.  On the CPU (gloo) dropout draws
    from the host generator, which the ranks share so that their loaders
    yield one global batch: there the slices' masks repeat, and a CPU run
    is a check of the collectives, held at dropout 0."""
    if not launched_by_torchrun():
        return None
    init_distributed(device=device)
    rank = dist.get_rank()
    if rank > 0 and torch.device(device).type == "cuda":
        torch.cuda.manual_seed(torch.cuda.initial_seed() + rank)
    replicate(model)
    sync_batch_norm(model)
    return ParallelContext()
