"""Batched caption decoding engine, greedy and beam search (counterpart of
``audiocaption_tpu/decoding/engine.py``).

Built from a decoder-agnostic step function

    step_fn(word_t [N] int64, t int, dyn_cache) -> (logit [N, V], dyn)

This engine is the CPU path of the API and the path of every decode
method the fused CUDA kernels do not serve.  Semantics:

  * greedy: early exit once every row emitted <eos>; finished rows are
    forced to <eos>;
  * beam: log-softmax, then log-softmax(./temp); at t=0 only beam 0
    competes; top-K over [K*V] with ties going to the lower flat index
    (as ``lax.top_k``); parent-beam gather of the caches; harvest with
    score/(t+1), every beam harvested at t=L-1; stable merge of the K best
    finished beams; early stop per sample once K finished; -1000 on
    ended beams.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

StepFn = Callable[[torch.Tensor, int, Any], Tuple[torch.Tensor, Any]]

NEG_INF = float(torch.finfo(torch.float32).min)


@dataclasses.dataclass(frozen=True)
class SpecialTokens:
    pad: int = 0
    bos: int = 1
    eos: int = 2
    max_length: int = 20


def expand_to_beams(tensors: Dict[str, torch.Tensor], beam_size: int
                    ) -> Dict[str, torch.Tensor]:
    """Repeat every tensor's rows beam_size times (sample-major: row
    b*K+k belongs to sample b, beam k)."""
    return {k: torch.repeat_interleave(v, beam_size, dim=0)
            for k, v in tensors.items()}


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis; equal values go to the lower index
    (``lax.top_k`` order).  Picks by repeated first-occurrence argmax."""
    x = x.clone()
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(x, dim=-1, keepdim=True)
        vals.append(torch.gather(x, -1, i))
        idxs.append(i)
        x.scatter_(-1, i, float("-inf"))
    return torch.cat(vals, -1), torch.cat(idxs, -1)


def stepwise_decode(step_fn: StepFn, dyn_cache: Any, batch_size: int,
                    special: SpecialTokens, max_length: Optional[int] = None,
                    device=None) -> Dict[str, torch.Tensor]:
    """Greedy decode -> {seq [B, L] int64}."""
    L = max_length if max_length is not None else special.max_length
    B = batch_size
    seq = torch.full((B, L), special.eos, dtype=torch.long, device=device)
    word = torch.full((B,), special.bos, dtype=torch.long, device=device)
    finished = torch.zeros(B, dtype=torch.bool, device=device)
    dyn = dyn_cache
    for t in range(L):
        if bool(finished.all()):
            break
        logit, dyn = step_fn(word, t, dyn)
        new_word = torch.argmax(torch.log_softmax(logit, dim=-1), dim=-1)
        out_word = torch.where(finished, torch.full_like(new_word, special.eos),
                               new_word)
        finished = finished | (new_word == special.eos)
        seq[:, t] = out_word
        word = out_word
    return {"seq": seq}


def _merge_done(done_score, done_seq, cand_score, cand_seq):
    """Keep the best K finished beams so far (stable: lower index first)."""
    K = done_score.shape[1]
    scores = torch.cat([done_score, cand_score], dim=1)
    seqs = torch.cat([done_seq, cand_seq], dim=1)
    new_score, sel = top_k_stable(scores, K)
    new_seq = torch.gather(seqs, 1, sel[..., None].expand(-1, -1,
                                                          seqs.shape[-1]))
    return new_score, new_seq


def beam_search(step_fn: StepFn, dyn_cache: Dict[str, torch.Tensor],
                batch_size: int, beam_size: int, vocab_size: int,
                special: SpecialTokens, max_length: Optional[int] = None,
                temp: float = 1.0, n_best: bool = False,
                n_best_size: Optional[int] = None, device=None
                ) -> Dict[str, torch.Tensor]:
    """Batched beam search.  ``dyn_cache`` tensors have leading dim B*K
    (sample-major, see :func:`expand_to_beams`).  Returns {"seq": [B, L],
    "score": [B]} or, with ``n_best``, [B, n, L] and [B, n]."""
    L = max_length if max_length is not None else special.max_length
    B, K, V = batch_size, beam_size, vocab_size
    f32 = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.long, device=device)
    topk_lp = torch.zeros(B, K, **f32)
    word = torch.full((B, K), special.bos, **i64)
    seq = torch.full((B, K, L), special.eos, **i64)
    done_score = torch.full((B, K), NEG_INF, **f32)
    done_seq = torch.full((B, K, L), special.eos, **i64)
    done_count = torch.zeros(B, **i64)
    stopped = torch.zeros(B, dtype=torch.bool, device=device)
    beam_arange = torch.arange(K, device=device)[None, :, None]
    batch_base = (torch.arange(B, device=device) * K)[:, None]
    dyn = dyn_cache

    for t in range(L):
        if bool(stopped.all()):
            break
        logit, dyn = step_fn(word.reshape(B * K), t, dyn)
        lp = torch.log_softmax(logit, dim=-1)
        lp = torch.log_softmax(lp / temp, dim=-1).reshape(B, K, V)
        total = topk_lp[..., None] + lp
        if t == 0:   # all beams identical: select from beam 0 only
            total = total.masked_fill(beam_arange > 0, NEG_INF)
        new_lp, idx = top_k_stable(total.reshape(B, K * V), K)
        prev_beam = torch.div(idx, V, rounding_mode="floor")
        new_word = idx % V

        seq = torch.gather(seq, 1, prev_beam[..., None].expand(-1, -1, L))
        seq[:, :, t] = new_word
        gather_idx = (batch_base + prev_beam).reshape(-1)
        dyn = {k: v[gather_idx] for k, v in dyn.items()}

        is_end = (new_word == special.eos) | (t == L - 1)
        harvest = is_end & ~stopped[:, None]
        cand_score = torch.where(harvest, new_lp / float(t + 1),
                                 torch.full_like(new_lp, NEG_INF))
        done_score, done_seq = _merge_done(done_score, done_seq,
                                           cand_score, seq)
        done_count = done_count + harvest.sum(dim=1)
        stopped = stopped | (done_count == K)
        topk_lp = torch.where(is_end, new_lp - 1000.0, new_lp)
        word = new_word

    if n_best:
        n = n_best_size if n_best_size is not None else K
        return {"seq": done_seq[:, :n], "score": done_score[:, :n]}
    return {"seq": done_seq[:, 0], "score": done_score[:, 0]}
