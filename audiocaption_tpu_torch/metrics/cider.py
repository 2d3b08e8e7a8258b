"""CIDEr-D (Vedantam et al. 2015), a copy of
``audiocaption_tpu/metrics/cider.py``, pycocoevalcap-compatible:
TF-IDF n-gram vectors (n = 1..4), cosine similarity with candidate-count
clipping, gaussian length penalty (sigma = 6), x10 scaling.  Document
frequencies come from the evaluation references themselves, as in
pycocoevalcap (corpus mode).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np


def _counts(sentence: str, max_n: int) -> List[Counter]:
    words = sentence.split()
    return [Counter(tuple(words[i:i + n])
                    for i in range(len(words) - n + 1))
            for n in range(1, max_n + 1)]


class CiderD:

    def __init__(self, n: int = 4, sigma: float = 6.0,
                 df_corpus: Optional[Dict[str, List[str]]] = None):
        self.n = n
        self.sigma = sigma
        self.doc_freq: List[Dict] = [defaultdict(float)
                                     for _ in range(n)]
        self.ref_len: Optional[float] = None
        if df_corpus is not None:
            self.fit_df(df_corpus)

    def fit_df(self, key2refs: Dict[str, List[str]]):
        num_docs = 0
        for refs in key2refs.values():
            num_docs += 1
            seen = [set() for _ in range(self.n)]
            for ref in refs:
                for i, c in enumerate(_counts(ref, self.n)):
                    seen[i].update(c.keys())
            for i, s in enumerate(seen):
                for g in s:
                    self.doc_freq[i][g] += 1
        self.ref_len = math.log(float(num_docs))

    def _vec(self, counts: List[Counter]):
        vecs, norms, length = [], [], 0
        for i, c in enumerate(counts):
            vec = {}
            norm = 0.0
            for g, tf in c.items():
                df = math.log(max(1.0, self.doc_freq[i][g]))
                w = tf * (self.ref_len - df)
                vec[g] = w
                norm += w * w
                if i == 0:
                    length += tf
            vecs.append(vec)
            norms.append(math.sqrt(norm))
        return vecs, norms, length

    def _sim(self, hv, hn, hl, rv, rn, rl) -> np.ndarray:
        delta = float(hl - rl)
        val = np.zeros(self.n)
        for i in range(self.n):
            s = 0.0
            for g, w in hv[i].items():
                # CIDEr-D clips the candidate weight to the reference's
                s += min(w, rv[i].get(g, 0.0)) * rv[i].get(g, 0.0)
            if hn[i] != 0 and rn[i] != 0:
                s /= hn[i] * rn[i]
            s *= math.exp(-(delta ** 2) / (2 * self.sigma ** 2))
            val[i] = s
        return val

    def compute_score(self, key2refs: Dict[str, List[str]],
                      key2pred: Dict[str, List[str]]
                      ) -> Tuple[float, np.ndarray]:
        """Same call convention as pycocoevalcap's Cider.compute_score
        (gts, res) -> (corpus score, per-key array in key order)."""
        if self.ref_len is None:
            self.fit_df(key2refs)
        scores = []
        for key in key2pred:
            hyp = key2pred[key][0]
            hv, hn, hl = self._vec(_counts(hyp, self.n))
            score = np.zeros(self.n)
            for ref in key2refs[key]:
                rv, rn, rl = self._vec(_counts(ref, self.n))
                score += self._sim(hv, hn, hl, rv, rn, rl)
            score_avg = np.mean(score / len(key2refs[key]))
            scores.append(score_avg * 10.0)
        scores = np.asarray(scores)
        return float(scores.mean()) if len(scores) else 0.0, scores
