"""Caption diversity, a copy of ``audiocaption_tpu/metrics/diversity.py``
(reference ``python_scripts/eval/diversity.py`` and
``diversity_instance.py``): vocabulary size, the share of captions not
in the training corpus, distinct-1 / distinct-2 (over the corpus, or
within each caption and averaged) and self-BLEU over the predictions.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Optional

from audiocaption_tpu_torch.metrics.bleu import corpus_bleu


def _novel_ratio(predictions: List[str], train_captions) -> float:
    train_set = set(train_captions)
    novel = sum(1 for p in predictions if p not in train_set)
    return novel / max(len(predictions), 1)


def diversity_metrics(predictions: List[str],
                      train_captions: Optional[Iterable[str]] = None
                      ) -> Dict[str, float]:
    tokens = [p.split() for p in predictions]
    vocab = set(t for toks in tokens for t in toks)

    def distinct(n: int) -> float:
        grams = Counter()
        total = 0
        for toks in tokens:
            for i in range(len(toks) - n + 1):
                grams[tuple(toks[i:i + n])] += 1
                total += 1
        return len(grams) / total if total else 0.0

    out = {"vocab_size": float(len(vocab)),
           "distinct_1": distinct(1),
           "distinct_2": distinct(2)}
    if train_captions is not None:
        out["novel_ratio"] = _novel_ratio(predictions, train_captions)
    # self-BLEU: each prediction scored against all the others
    if len(predictions) > 1:
        key2pred = {str(i): [p] for i, p in enumerate(predictions)}
        key2refs = {str(i): predictions[:i] + predictions[i + 1:]
                    for i in range(len(predictions))}
        bleu, _ = corpus_bleu(key2pred, key2refs)
        out["self_bleu_4"] = bleu[3]
    return out


def instance_diversity_metrics(predictions: List[str],
                               train_captions: Optional[Iterable[str]]
                               = None) -> Dict[str, float]:
    """Per-caption diversity averaged over captions: distinct-n is the
    within-caption share of unique n-grams."""
    tokens = [p.split() for p in predictions]
    vocab = set(t for toks in tokens for t in toks)

    def distinct(toks: List[str], n: int) -> float:
        grams = [tuple(toks[i:i + n]) for i in range(len(toks) - n + 1)]
        return len(set(grams)) / len(grams) if grams else 0.0

    out = {"vocab_size": float(len(vocab)),
           "distinct_1": (sum(distinct(t, 1) for t in tokens)
                          / max(len(tokens), 1)),
           "distinct_2": (sum(distinct(t, 2) for t in tokens)
                          / max(len(tokens), 1))}
    if train_captions is not None:
        out["novel_ratio"] = _novel_ratio(predictions, train_captions)
    return out
