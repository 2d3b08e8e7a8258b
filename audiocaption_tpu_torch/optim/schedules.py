"""Learning-rate schedules as functions of the update count (counterpart
of ``audiocaption_tpu/optim/schedules.py``, itself the reference's torch
schedulers, ``captioning/utils/lr_scheduler.py``).

Each schedule maps the number of updates already applied, ``count``, to
the learning rate of the next one.  The reference's schedulers are
1-based (``step()`` runs once at construction), so each evaluates at
``it = count + 1``.  :func:`lambda_lr` drives ``torch.optim``'s
``LambdaLR`` with one: stepped once after every applied update, its
``last_epoch`` is ``count``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

Schedule = Callable[[int], float]


def exponential_decay_with_warmup(base_lr: float, final_lr: float,
                                  total_iters: int,
                                  warmup_iters: int = 3000) -> Schedule:
    """Linear warm-up to ``base_lr``, then exponential decay reaching
    ``final_lr`` at ``total_iters``."""
    base = (final_lr / base_lr) ** (1.0 / (total_iters - warmup_iters))

    def schedule(count: int) -> float:
        it = count + 1
        if it <= warmup_iters:
            return base_lr * it / warmup_iters
        return base_lr * base ** (it - warmup_iters)
    return schedule


def noam_schedule(model_size: int = 512, factor: float = 1.0,
                  warmup_iters: int = 3000) -> Schedule:
    def schedule(count: int) -> float:
        it = float(max(count + 1, 1))
        return factor * model_size ** (-0.5) * min(
            it ** (-0.5), it * warmup_iters ** (-1.5))
    return schedule


def cosine_with_warmup(base_lr: float, total_iters: int, warmup_iters: int,
                       num_cycles: float = 0.5) -> Schedule:
    def schedule(count: int) -> float:
        it = float(count + 1)
        if it < warmup_iters:
            return base_lr * it / max(1, warmup_iters)
        progress = (it - warmup_iters) / max(1, total_iters - warmup_iters)
        return base_lr * max(
            0.0, 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress)))
    return schedule


def build_schedule(config: Dict, base_lr: float, total_iters: int,
                   warmup_iters: int) -> Schedule:
    """From a config node {type, args}, with the runner's total and
    warm-up iterations (warm-up ``total // 5`` unless the node sets it)."""
    type_name = config.get("type", "ExponentialDecayScheduler").split(".")[-1]
    args = dict(config.get("args", {}) or {})
    args.setdefault("warmup_iters", warmup_iters)
    if type_name == "ExponentialDecayScheduler":
        return exponential_decay_with_warmup(
            base_lr, args.get("final_lrs", args.get("final_lr", 1e-7)),
            total_iters, args["warmup_iters"])
    if type_name == "NoamScheduler":
        return noam_schedule(args.get("model_size", 512),
                             args.get("factor", 1.0), args["warmup_iters"])
    if type_name == "CosineWithWarmup":
        return cosine_with_warmup(base_lr, total_iters, args["warmup_iters"],
                                  args.get("num_cycles", 0.5))
    raise ValueError(f"unknown scheduler: {type_name}")


def lambda_lr(optimizer: torch.optim.Optimizer, schedule: Schedule,
              base_lr: float) -> torch.optim.lr_scheduler.LambdaLR:
    """``LambdaLR`` whose learning rate is ``schedule(count)``: the
    optimizer's ``lr`` must be ``base_lr``."""
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda count: schedule(count) / base_lr)
