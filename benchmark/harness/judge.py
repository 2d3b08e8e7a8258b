"""The comparisons that decide ``correct``, against the plain reference.

Captions (beam search), two numbers over the same served captions.
``score_gap``: the reference scores each served caption by teacher
forcing, and the gap is how far the search's own score of it
(``capture.best_scores``) lies from that; a wrong token, or a search
computed in a lower precision, moves the gap; rounding in float32 moves
it by about a millionth.  ``caption_miss_share``: the share of served
captions that are not the reference's own beam search's best caption
(up to and including its first <eos>); a search that keeps the wrong
beams, a narrower beam or an approximate top-k serves other captions.

Training: the first step's loss, each leaf's gradient norm at the first
step as the optimizer took it, and each leaf's change over the first
three steps, against the reference's; a leaf's gap is measured against the
larger of its reference norm and the median leaf's."""

from __future__ import annotations

import sys
from typing import Dict, List, Tuple

import torch

from reference.common import beam_search, precision, sequence_scores


@torch.no_grad()
def compare_captions(ref, wav: torch.Tensor, lens: torch.Tensor,
                     served: torch.Tensor, score, beam: int, max_len: int
                     ) -> Dict[str, torch.Tensor]:
    """-> {"score_gap": |the search's own score of each served caption -
    the reference's score of that caption| [B], infinite for a caption
    holding an id outside the vocabulary or with no score recorded;
    "miss": whether each served caption differs from the reference's
    beam search's best [B]; "steps": the steps that search ran [B]}."""
    with precision(False):
        mem, mask = ref.encode(wav, lens)
        served = served.to(wav.device).long()
        bad = ((served < 0) | (served >= ref.decoder.vocab)).any(1)
        scores = sequence_scores(ref.decoder, mem, mask,
                                 served.clamp(0, ref.decoder.vocab - 1))
        best, _, steps = beam_search(ref.decoder, mem, mask, max_len, beam)
    if score is None:
        gap = torch.full_like(scores, float("inf"))
    else:
        gap = (score.to(wav.device).float() - scores).abs()
    gap[bad] = float("inf")
    miss = torch.tensor([a != b for a, b in zip(caption_words(served),
                                                caption_words(best))])
    return {"score_gap": gap, "miss": miss, "steps": steps}


def caption_words(seq: torch.Tensor, eos: int = 2) -> List[Tuple[int, ...]]:
    """Each row's ids up to and including its first <eos> (all of them
    without one)."""
    out = []
    for row in seq.tolist():
        out.append(tuple(row[:row.index(eos) + 1] if eos in row else row))
    return out


@torch.no_grad()
def search_steps(ref, wav, lens, beam: int, max_len: int) -> torch.Tensor:
    """The steps the reference's beam search runs per clip (the work a
    decode needs)."""
    with precision(False):
        mem, mask = ref.encode(wav, lens)
        return beam_search(ref.decoder, mem, mask, max_len, beam)[2]


def caption_checks(found: List[Dict[str, torch.Tensor]], config
                   ) -> List[Tuple[str, float, float]]:
    """(name, value, limit) of the two caption numbers over every
    compared caption."""
    gaps = torch.cat([f["score_gap"] for f in found])
    miss = torch.cat([f["miss"] for f in found]).float()
    limits = config["limits"]
    return [("score_gap", float(gaps.max()), limits["score_gap"]),
            ("caption_miss_share", float(miss.mean()),
             limits["caption_miss_share"])]


@torch.no_grad()
def control_captions(ref, wav: torch.Tensor, lens: torch.Tensor, beam: int,
                     max_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The control's captions and their scores: the reference's beam search
    computed with TF32 products and convolutions, one precision below
    float32."""
    with precision(True):
        mem, mask = ref.encode(wav, lens)
        seq, score, _ = beam_search(ref.decoder, mem, mask, max_len, beam)
    return seq, score


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: List[str]) -> Tuple[float, str]:
    """The worst leaf's |program norm - reference norm| over the larger of
    its reference norm and the median leaf's -> (gap, leaf)."""
    norms = sorted(ref[k] for k in keep)
    median = norms[len(norms) // 2] if norms else 0.0
    worst, where = 0.0, ""
    for k in keep:
        gap = abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
        if gap > worst or not where:
            worst, where = gap, k
    return worst, where


def moved_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient is above a thousandth of the median
    leaf's: the others are nought to rounding, and Adam moves them by
    round-off alone."""
    norms = sorted(ref_grad.values())
    median = norms[len(norms) // 2]
    return [k for k, v in ref_grad.items() if v > 1e-3 * median]


def reference_train(ref, batches: List[Dict], coins: List[List[bool]],
                    hyper: Dict, dropout_seed: int, tf32: bool = False
                    ) -> Dict:
    """The reference follows the program's first steps: on each batch the
    scheduled-sampling forward with that step's coins, the smoothed loss,
    the gradients (zero for a parameter the loss does not reach), the
    global-norm clip and Adam with L2 decay at the step's learning rate.
    The default generators are seeded with ``dropout_seed`` before the
    first step, as the program's were, so that every dropout (the GRU's
    in cuDNN, the decoder's) draws what the program's drew.
    -> {"loss": [per step], "grad": {leaf: norm of the first step's
    gradient as Adam took it}, "change": {leaf: norm of the change over
    the steps}}.  ``tf32`` computes it in TF32 (the control)."""
    from reference.common import (Adam, clip_by_global_norm, exp_decay_lr,
                                  label_smoothing_loss, scheduled_sampling)
    params = dict(ref.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    adam = Adam({k: p.data for k, p in params.items()},
                weight_decay=hyper["weight_decay"])
    ref.train()
    out = {"loss": []}
    torch.manual_seed(dropout_seed)
    with precision(tf32):
        for step, (batch, step_coins) in enumerate(zip(batches, coins)):
            wav = batch["wav"].float() / 32768.0
            attn, attn_len = ref.features(wav, batch["wav_len"])
            logits = scheduled_sampling(ref.decoder, attn, attn_len,
                                        batch["cap"], step_coins)
            loss = label_smoothing_loss(logits, batch["cap"][:, 1:],
                                        batch["cap_len"] - 1,
                                        hyper["label_smoothing"])
            names = list(params)
            got = torch.autograd.grad(loss, [params[k] for k in names],
                                      allow_unused=True)
            grads = {k: (torch.zeros_like(params[k]) if g is None else g)
                     for k, g in zip(names, got)}
            clip_by_global_norm(grads, hyper["max_grad_norm"])
            lr = exp_decay_lr(hyper["lr"], hyper["final_lr"],
                              hyper["total_iters"], hyper["warmup_iters"],
                              hyper["lr_count"] + step)
            seen = adam.step(grads, lr)
            out["loss"].append(float(loss.detach()))
            if step == 0:
                out["grad"] = {k: float(g.double().norm())
                               for k, g in seen.items()}
    out["change"] = {k: float((p.detach() - start[k]).double().norm())
                     for k, p in params.items()}
    return out


def train_checks(prog: Dict, ref: Dict, limits: Dict) -> List[Tuple]:
    """(name, value, limit) of the three training numbers.  The loss is
    the first step's: later steps' losses move with a scheduled-sampling
    pick that a float32 rounding of the updated weights can flip (one
    word in one row moves the loss by ~1e-4), where the first step's
    inputs are the same on both sides."""
    loss = abs(prog["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0])
    keep = moved_leaves(ref["grad"])
    grad, grad_leaf = leaf_gaps(prog["grad"], ref["grad"], keep)
    change, change_leaf = leaf_gaps(prog["change"], ref["change"], keep)
    print(f"worst leaves: gradient {grad_leaf}, change {change_leaf}",
          file=sys.stderr, flush=True)
    return [("loss1_gap", loss, limits["loss1_gap"]),
            ("grad_gap", grad, limits["grad_gap"]),
            ("change_gap", change, limits["change_gap"])]
