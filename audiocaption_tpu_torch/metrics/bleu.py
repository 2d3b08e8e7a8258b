"""Corpus BLEU 1-4 (Papineni et al.), a copy of
``audiocaption_tpu/metrics/bleu.py``, pycocoevalcap-compatible: clipped
n-gram counts against the max reference count, a corpus-level geometric
mean, the brevity penalty against the *closest* reference length.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Tuple


def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def _bleu_from(clip, tot, h_len, r_len, upto: int) -> float:
    tiny, small = 1e-15, 1e-9
    logs = 0.0
    for n in range(upto):
        logs += math.log(max(clip[n], tiny) / max(tot[n], small))
    bp = 1.0 if h_len > r_len else math.exp(1 - r_len / max(h_len, 1))
    return bp * math.exp(logs / upto)


def corpus_bleu(key2pred: Dict[str, List[str]],
                key2refs: Dict[str, List[str]],
                max_n: int = 4) -> Tuple[List[float], Dict[str, List[float]]]:
    """-> ([bleu1..bleu4], per-key sentence scores)."""
    clipped = [0] * max_n
    total = [0] * max_n
    hyp_len = ref_len = 0
    stats = {}
    for key, preds in key2pred.items():
        hyp = preds[0].split()
        refs = [r.split() for r in key2refs[key]]
        # closest reference length (ties -> shorter)
        closest = min((abs(len(r) - len(hyp)), len(r)) for r in refs)[1]
        hyp_len += len(hyp)
        ref_len += closest
        key_clip, key_tot = [], []
        for n in range(1, max_n + 1):
            max_ref = Counter()
            for r in refs:
                for g, c in _ngrams(r, n).items():
                    max_ref[g] = max(max_ref[g], c)
            c = sum(min(cnt, max_ref[g])
                    for g, cnt in _ngrams(hyp, n).items())
            t = max(len(hyp) - n + 1, 0)
            clipped[n - 1] += c
            total[n - 1] += t
            key_clip.append(c)
            key_tot.append(t)
        stats[key] = (key_clip, key_tot, len(hyp), closest)

    scores = [_bleu_from(clipped, total, hyp_len, ref_len, n)
              for n in range(1, max_n + 1)]
    per_key = {key: [_bleu_from(kc, kt, hl, rl, n)
                     for n in range(1, max_n + 1)]
               for key, (kc, kt, hl, rl) in stats.items()}
    return scores, per_key
