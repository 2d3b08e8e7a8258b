"""Batched caption decoding engine: greedy, sampling, beam and diverse beam
search (counterpart of ``audiocaption_tpu/decoding/engine.py``).

Built from a decoder-agnostic step function

    step_fn(word_t [N] int64, t int, dyn_cache) -> (logit [N, V], dyn)

This engine is the CPU path of the API and the path of every decode
method the fused CUDA kernels do not serve.  Semantics:

  * greedy and sampling (:func:`sample_next_word`: "greedy", "gumbel",
    "sample", top-k "topN", top-p "top0.x"): early exit once every row
    emitted <eos>; finished rows are forced to <eos>;
  * beam: log-softmax, then log-softmax(./temp); at t=0 only beam 0
    competes; top-K over [K*V] with ties going to the lower flat index
    (as ``lax.top_k``); parent-beam gather of the caches; harvest with
    score/(t+1), every beam harvested at t=L-1; stable merge of the K best
    finished beams; early stop per sample once K finished; -1000 on
    ended beams;
  * diverse beam search: G groups of K // G beams, group g starting at
    step g; each group's scores lose ``diversity_lambda`` per time an
    earlier group chose the word at the same local time; inactive groups
    are frozen (their caches too).

Random draws.  Every sampling method picks ``argmax(lp + g)``, ``g``
Gumbel noise (``jax.random.categorical``'s form), and "gumbel" perturbs
with ``-log(-log(u + eps) + eps)``, ``u`` uniform: the draw (``g``, or
``u`` for "gumbel") comes from a ``torch.Generator`` on the logits'
device, or is handed in (``noise``), so the JAX package's own draws can
be replayed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

StepFn = Callable[[torch.Tensor, int, Any], Tuple[torch.Tensor, Any]]

NEG_INF = float(torch.finfo(torch.float32).min)
TINY = float(torch.finfo(torch.float32).tiny)
SAMPLING_METHODS = ("greedy", "gumbel", "sample")
NoiseFn = Callable[[int, Tuple[int, ...]], torch.Tensor]


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


def _top_p_logprob(logit: torch.Tensor, top_p: float) -> torch.Tensor:
    """Top-p: probabilities from the *raw* logits, keep the smallest
    leading set of the sorted words whose cumulative probability stays
    below ``top_p`` (the first word always kept), renormalise, take the
    log (-inf off the set), back in vocabulary order.  Ties sort by the
    lower id first, as ``jnp.argsort``."""
    probs = torch.softmax(logit, dim=-1)
    sorted_probs, order = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    keep = torch.cumsum(sorted_probs, dim=-1) < top_p
    keep = torch.cat([torch.ones_like(keep[..., :1]), keep[..., :-1]], -1)
    kept = sorted_probs * keep
    log_kept = torch.log(kept / kept.sum(-1, keepdim=True))
    return torch.empty_like(log_kept).scatter_(-1, order, log_kept)


def parse_method(method: str) -> Tuple[str, float]:
    """A sampling method's kind ("greedy", "gumbel", "sample", "topk" or
    "topp") and its number; an unknown name raises."""
    if method in SAMPLING_METHODS:
        return method, 0.0
    if method.startswith("top"):
        try:
            n = float(method[3:])
        except ValueError:
            n = 0.0
        if 0 < n < 1:
            return "topp", n
        if n >= 1 and n == int(n):
            return "topk", n
    raise ValueError(f"unknown sample_method {method!r}")


def draw_noise(method: str, shape, generator: Optional[torch.Generator],
               device) -> Optional[torch.Tensor]:
    """The draw one sampling step needs: None for "greedy", uniforms in
    [0, 1) for "gumbel", standard Gumbel noise for the others (from
    uniforms in [tiny, 1), as ``jax.random.gumbel``)."""
    kind, _ = parse_method(method)
    if kind == "greedy":
        return None
    u = torch.rand(shape, generator=generator, device=device)
    if kind == "gumbel":
        return u
    return -torch.log(-torch.log(u.clamp_min(TINY)))


def sample_next_word(logit: torch.Tensor, method: str, temp: float = 1.0,
                     noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (word [N] int64, sampled_logprob [N] float32).  ``noise`` is the
    step's draw (see :func:`draw_noise`), drawn from ``generator`` when
    not given.  "sample" and top-k return ``logprob / temp`` at the word,
    not renormalised; top-p its renormalised log-probability; "gumbel"
    the plain log-probability."""
    kind, n = parse_method(method)
    logprob = torch.log_softmax(logit, dim=-1)
    if kind == "greedy":
        samp, word = logprob.max(-1)
        return word, samp
    if noise is None:
        noise = draw_noise(method, logit.shape, generator, logit.device)
    if kind == "gumbel":
        eps = 1e-20
        g = -torch.log(-torch.log(noise + eps) + eps)
        y = torch.log_softmax((logprob + g) / temp, dim=-1)
        word = torch.argmax(y, dim=-1)
        lp = logprob
    else:
        lp = logprob / temp
        if kind == "topp":
            lp = _top_p_logprob(logit, n)
        elif kind == "topk":
            kth = torch.sort(lp, dim=-1).values[..., -int(n)][..., None]
            lp = torch.where(lp >= kth, lp, torch.full_like(lp, NEG_INF))
        word = torch.argmax(lp + noise, dim=-1)
    return word, torch.gather(lp, -1, word[:, None])[:, 0]


def stepwise_decode(step_fn: StepFn, dyn_cache: Any, batch_size: int,
                    special: SpecialTokens, max_length: Optional[int] = None,
                    device=None, method: str = "greedy", temp: float = 1.0,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[NoiseFn] = None
                    ) -> Dict[str, torch.Tensor]:
    """Greedy or sampled decode -> {seq [B, L] int64, sampled_logprob
    [B, L] float32 (0 after the loop stops)}.  ``noise(t, shape)``, when
    given, supplies step t's draw; else each step draws from
    ``generator``."""
    parse_method(method)
    L = max_length if max_length is not None else special.max_length
    B = batch_size
    seq = torch.full((B, L), special.eos, dtype=torch.long, device=device)
    lps = torch.zeros(B, L, dtype=torch.float32, device=device)
    word = torch.full((B,), special.bos, dtype=torch.long, device=device)
    finished = torch.zeros(B, dtype=torch.bool, device=device)
    dyn = dyn_cache
    for t in range(L):
        if bool(finished.all()):
            break
        logit, dyn = step_fn(word, t, dyn)
        step_noise = noise(t, tuple(logit.shape)) if noise else None
        new_word, samp_lp = sample_next_word(logit, method, temp,
                                             step_noise, generator)
        out_word = torch.where(finished, torch.full_like(new_word, special.eos),
                               new_word)
        finished = finished | (new_word == special.eos)
        seq[:, t] = out_word
        lps[:, t] = samp_lp
        word = out_word
    return {"seq": seq, "sampled_logprob": lps}


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


def diverse_beam_search(step_fn: StepFn, dyn_cache: Dict[str, torch.Tensor],
                        batch_size: int, beam_size: int, vocab_size: int,
                        special: SpecialTokens, group_size: int,
                        diversity_lambda: float = 0.5,
                        max_length: Optional[int] = None, temp: float = 1.0,
                        group_nbest: bool = True, device=None
                        ) -> Dict[str, torch.Tensor]:
    """Batched diverse beam search.  ``dyn_cache`` tensors have leading dim
    B*G*bdash, group-major within each sample (row b*G*bdash + g*bdash +
    k).  Every group steps at the global time t, which is also the
    position ``step_fn`` gets (the JAX engine's choice: group g's first
    step writes cache row g, its rows before stay as they were).  Returns
    {"seq": [B, G*bdash, L], "score": [B, G*bdash]} with ``group_nbest``
    (the bdash best of each group), else the best of each group, [B, G, L]
    and [B, G]."""
    L = max_length if max_length is not None else special.max_length
    B, G, V = batch_size, group_size, vocab_size
    bdash = beam_size // G
    f32 = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.long, device=device)
    lp_table = torch.zeros(B, G, bdash, **f32)
    word = torch.full((B, G, bdash), special.bos, **i64)
    seq = torch.full((B, G, bdash, L), special.eos, **i64)
    done_score = torch.full((B, G, bdash), NEG_INF, **f32)
    done_seq = torch.full((B, G, bdash, L), special.eos, **i64)
    beam_arange = torch.arange(bdash, device=device)
    base = (torch.arange(B, device=device)[:, None, None] * G * bdash
            + torch.arange(G, device=device)[None, :, None] * bdash)
    dyn = dyn_cache

    for t in range(L + G - 1):
        # a copy: the step may write its caches in place, and an
        # inactive group keeps its old ones
        logit, dyn_new = step_fn(word.reshape(-1), t,
                                 {k: v.clone() for k, v in dyn.items()})
        lp = torch.log_softmax(logit, dim=-1)
        lp = torch.log_softmax(lp / temp, dim=-1).reshape(B, G, bdash, V)
        states = []
        for g in range(G):
            active = g <= t <= L + g - 1
            local_t = t - g
            pos = min(max(local_t, 0), L - 1)
            lp_g = lp[:, g]
            if g > 0:
                # earlier groups' words at this local time, after this
                # step's reorder of their beams
                prev = torch.stack([s["seq"][..., pos] for s in states], 1)
                change = torch.zeros(B, V, **f32).scatter_add_(
                    1, prev.reshape(B, -1),
                    torch.ones(B, prev[0].numel(), **f32))
                lp_g = lp_g - diversity_lambda * change[:, None, :]
            total = lp_table[:, g][..., None] + lp_g
            if local_t == 0:
                total = total.masked_fill(beam_arange[None, :, None] > 0,
                                          NEG_INF)
            new_lp, idx = top_k_stable(total.reshape(B, bdash * V), bdash)
            prev_beam = torch.div(idx, V, rounding_mode="floor")
            new_word = idx % V
            seq_g = torch.gather(seq[:, g], 1,
                                 prev_beam[..., None].expand(-1, -1, L))
            seq_g[:, :, pos] = new_word
            is_end = (new_word == special.eos) | (t == L + g - 1)
            harvest = is_end & active
            cand = torch.where(harvest, new_lp / float(local_t + 1),
                               torch.full_like(new_lp, NEG_INF))
            d_score, d_seq = _merge_done(done_score[:, g], done_seq[:, g],
                                         cand, seq_g)
            new_lp = torch.where(is_end, new_lp - 1000.0, new_lp)
            if active:
                states.append(dict(lp=new_lp, word=new_word, seq=seq_g,
                                   d_score=d_score, d_seq=d_seq,
                                   prev_beam=prev_beam))
            else:            # frozen
                states.append(dict(lp=lp_table[:, g], word=word[:, g],
                                   seq=seq[:, g], d_score=done_score[:, g],
                                   d_seq=done_seq[:, g],
                                   prev_beam=beam_arange.expand(B, -1)))
        lp_table = torch.stack([s["lp"] for s in states], 1)
        word = torch.stack([s["word"] for s in states], 1)
        seq = torch.stack([s["seq"] for s in states], 1)
        done_score = torch.stack([s["d_score"] for s in states], 1)
        done_seq = torch.stack([s["d_seq"] for s in states], 1)
        gather_idx = (base + torch.stack([s["prev_beam"] for s in states], 1)
                      ).reshape(-1)
        row_active = torch.tensor(
            [g <= t <= L + g - 1 for g in range(G)], device=device
        ).repeat_interleave(bdash).repeat(B)
        dyn = {k: torch.where(
            row_active.view(-1, *([1] * (v.dim() - 1))),
            dyn_new[k][gather_idx], v) for k, v in dyn.items()}

    if group_nbest:
        return {"seq": done_seq.reshape(B, G * bdash, L),
                "score": done_score.reshape(B, G * bdash)}
    return {"seq": done_seq[:, :, 0], "score": done_score[:, :, 0]}
