"""ROUGE-L, a copy of ``audiocaption_tpu/metrics/rouge.py``,
pycocoevalcap-compatible: beta = 1.2, a sample's F from the max precision
and max recall over its references, averaged over the corpus.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

_BETA = 1.2


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(cur[-1], prev[j]))
        prev = cur
    return prev[-1]


def rouge_l_sentence(hyp: str, refs: List[str]) -> float:
    h = hyp.split()
    prec, rec = [], []
    for ref in refs:
        r = ref.split()
        lcs = _lcs_len(h, r)
        prec.append(lcs / len(h) if h else 0.0)
        rec.append(lcs / len(r) if r else 0.0)
    p, r = max(prec), max(rec)
    if p + r == 0:
        return 0.0
    return ((1 + _BETA ** 2) * p * r) / (r + _BETA ** 2 * p)


def rouge_l(key2pred: Dict[str, List[str]],
            key2refs: Dict[str, List[str]]
            ) -> Tuple[float, Dict[str, float]]:
    per_key = {k: rouge_l_sentence(v[0], key2refs[k])
               for k, v in key2pred.items()}
    return sum(per_key.values()) / max(len(per_key), 1), per_key
