"""``meteor_py``: METEOR with its two data-free matcher stages, a copy of
``audiocaption_tpu/metrics/meteor.py``.

The reference scores METEOR through pycocoevalcap's Java jar, whose
synonym and paraphrase modules need WordNet and paraphrase tables.  This
module implements the original algorithm (Banerjee & Lavie 2005, Lavie &
Agarwal 2007) with the stages that need no data:

  stage 1: exact surface match
  stage 2: Porter-stem match (``metrics/porter.py``, nltk's stemmer)

so it is an APPROXIMATION of the jar's METEOR, a lower bound in matching
power, and is reported as ``meteor_py``, never as ``meteor``.

Parameters are METEOR's classic defaults: Fmean weighs recall 9:1
(alpha = 0.9), fragmentation penalty gamma * (chunks / matches) ** beta
with gamma = 0.5, beta = 3.  A segment scores its best reference; the
corpus score is the mean of the segments.

Alignment: the stages run in order, each on the words the earlier left
free; every stage's cardinality is maximal (per key min(count_hyp,
count_ref)), and among the maximum-cardinality alignments the one with
the FEWEST chunks is chosen, by exhaustive enumeration over each key's
pairings (captions are short, so repeated matchable words are rare).  A
budget of ``_ENUM_BUDGET`` pairings caps pathological inputs; past it the
search keeps the best alignment seen, seeded with the greedy in-order
one.
"""

from __future__ import annotations

from itertools import combinations, permutations
from typing import Dict, List, Sequence, Tuple

from audiocaption_tpu_torch.metrics.porter import porter_stem

_ALPHA = 0.9
_BETA = 3.0
_GAMMA = 0.5
_ENUM_BUDGET = 100_000

_stem_cache: Dict[str, str] = {}


def stem(w: str) -> str:
    """The Porter stem of ``w``, cached."""
    s = _stem_cache.get(w)
    if s is None:
        s = porter_stem(w)
        _stem_cache[w] = s
    return s


def _stage_match_greedy(hyp: Sequence[str], ref: Sequence[str],
                        hyp_free: List[bool], ref_free: List[bool],
                        key) -> List[Tuple[int, int]]:
    """Each free hyp token takes the first free ref token with the same
    key: the stage's maximum cardinality, not always its fewest chunks
    (it seeds the exact search)."""
    out: List[Tuple[int, int]] = []
    for i, hw in enumerate(hyp):
        if not hyp_free[i]:
            continue
        hk = key(hw)
        for j, rw in enumerate(ref):
            if ref_free[j] and key(rw) == hk:
                out.append((i, j))
                hyp_free[i] = False
                ref_free[j] = False
                break
    return out


def _count_chunks(matches: List[Tuple[int, int]]) -> int:
    """Maximal runs of matches contiguous and monotone in both the
    hypothesis and the reference."""
    if not matches:
        return 0
    matches = sorted(matches)
    chunks = 1
    for (i0, j0), (i1, j1) in zip(matches, matches[1:]):
        if i1 != i0 + 1 or j1 != j0 + 1:
            chunks += 1
    return chunks


def _stage_groups(hyp: Sequence[str], ref: Sequence[str],
                  hyp_free: List[bool], ref_free: List[bool],
                  key) -> List[Tuple[List[int], List[int]]]:
    """The free positions grouped by match key, keys on both sides only."""
    groups: Dict[object, Tuple[List[int], List[int]]] = {}
    for i, w in enumerate(hyp):
        if hyp_free[i]:
            groups.setdefault(key(w), ([], []))[0].append(i)
    for j, w in enumerate(ref):
        if ref_free[j]:
            k = key(w)
            if k in groups:
                groups[k][1].append(j)
    return [(h, r) for h, r in groups.values() if h and r]


def _min_chunk_alignment(hyp: Sequence[str],
                         ref: Sequence[str]) -> Tuple[int, int]:
    """(matches, chunks) of the staged exact + stem alignment with the
    fewest chunks among the maximum-cardinality pairings."""
    hf = [True] * len(hyp)
    rf = [True] * len(ref)
    seed = _stage_match_greedy(hyp, ref, hf, rf, key=lambda w: w)
    seed += _stage_match_greedy(hyp, ref, hf, rf, key=stem)
    m = len(seed)
    if m == 0:
        return 0, 0
    best = [_count_chunks(seed)]
    budget = [_ENUM_BUDGET]
    hyp_free = [True] * len(hyp)
    ref_free = [True] * len(ref)

    def rec(groups, gi, partial, on_done):
        if best[0] == 1 or budget[0] <= 0:
            return
        if gi == len(groups):
            on_done(partial)
            return
        h, r = groups[gi]
        mk = min(len(h), len(r))
        for hs in combinations(h, mk):
            for rs in permutations(r, mk):
                budget[0] -= 1
                if budget[0] <= 0:
                    return
                pairs = list(zip(hs, rs))
                for i, j in pairs:
                    hyp_free[i] = False
                    ref_free[j] = False
                rec(groups, gi + 1, partial + pairs, on_done)
                for i, j in pairs:
                    hyp_free[i] = True
                    ref_free[j] = True

    def after_stage1(partial):
        groups2 = _stage_groups(hyp, ref, hyp_free, ref_free, stem)

        def finish(full):
            c = _count_chunks(full)
            if c < best[0]:
                best[0] = c

        rec(groups2, 0, partial, finish)

    groups1 = _stage_groups(hyp, ref, hyp_free, ref_free, lambda w: w)
    rec(groups1, 0, [], after_stage1)
    return m, best[0]


def meteor_pair(hyp_tokens: Sequence[str],
                ref_tokens: Sequence[str]) -> float:
    """METEOR of one hypothesis against one reference."""
    if not hyp_tokens or not ref_tokens:
        return 0.0
    m, chunks = _min_chunk_alignment(hyp_tokens, ref_tokens)
    if m == 0:
        return 0.0
    p = m / len(hyp_tokens)
    r = m / len(ref_tokens)
    fmean = p * r / (_ALPHA * p + (1.0 - _ALPHA) * r)
    penalty = _GAMMA * (chunks / m) ** _BETA
    return fmean * (1.0 - penalty)


def meteor_sentence(hyp: str, refs: List[str]) -> float:
    h = hyp.split()
    return max((meteor_pair(h, ref.split()) for ref in refs), default=0.0)


def meteor_py(key2pred: Dict[str, List[str]],
              key2refs: Dict[str, List[str]]
              ) -> Tuple[float, Dict[str, float]]:
    """Corpus METEOR approximation -> (mean score, per-key scores)."""
    per_key = {k: meteor_sentence(v[0], key2refs[k])
               for k, v in key2pred.items()}
    return sum(per_key.values()) / max(len(per_key), 1), per_key
