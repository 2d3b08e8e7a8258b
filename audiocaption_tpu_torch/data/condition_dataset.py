"""Condition, temporal-tag and keyword datasets (counterpart of
``audiocaption_tpu/data/condition_dataset.py``).

  * ``ConditionCaptionDataset``: each (clip, caption) item with its
    ``condition`` (float32), read from a tsv of ``cap_id`` -> ``prob``
    rows whose ``cap_id`` is ``{audio_id}_{cap_id}``: the conditioned
    GRU decoders' training data;
  * ``RandomConditionDataset``: clips with a ``condition`` drawn from the
    file's values (those below ``threshold`` repeated ``oversample``
    times), for condition-controlled decoding;
  * the temporal-tag pipeline's captioner trains on (clip, caption,
    ground-truth tag) and is scored with the ground-truth tag or the SED
    net's.  Tags: 0 single event, 1 simultaneous, 2 sequential,
    3 complex.  The tag file is a tsv (``audio_id\\ttag``,
    ``cli/synthetic_corpus.py::generate_temporal``);
  * ``KeywordProbCaptionDataset`` / ``KeywordProbInferenceDataset``: each
    item with its clip's ``keyword`` probabilities [C] (float32), from a
    tsv of ``audio_id`` -> ``hdf5_path`` rows, optionally binarised by
    :func:`binarize_keyword` (a float threshold, ``"topK"`` or
    ``"thr_topK"``).  A row is an h5 file holding the clip's vector under
    its ``audio_id`` (as in the JAX package), or a path ending in
    ``.npy`` holding the vector itself, read with ``numpy.load`` (the
    card machine has no h5py; ROADMAP Queue 3 J).  The conditioned
    transformer decoders take it (``models/transformer_decoder.py``).

The collate turns the items' scalar ``condition`` / ``temporal_tag``
into [B] arrays and a ``keyword`` / ``event`` into [B, C] float32
(``data/collate.py``).
"""

from __future__ import annotations

import csv
import random
from typing import Dict, Optional, Union

import numpy as np

from audiocaption_tpu_torch.data.dataset import (
    CaptionDataset, InferenceDataset, _H5Cache)


def load_dict_from_csv(path: str, cols) -> Dict:
    """A tsv -> {row[cols[0]]: row[cols[1]]}, the value a float where it
    parses as one."""
    out = {}
    with open(path) as f:
        for row in csv.DictReader(f, delimiter="\t"):
            out[row[cols[0]]] = _maybe_float(row[cols[1]])
    return out


def _maybe_float(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


def binarize_keyword(keyword: np.ndarray,
                     threshold: Union[None, float, str]) -> np.ndarray:
    """The JAX package's threshold rules: None keeps the probabilities; a
    float sets each to 1 at or above it, else 0; ``"topK"`` sets the K
    largest to 1 and the rest to 0; ``"thr_topK"`` applies the threshold
    ``thr`` and, where more than K pass it, keeps the K largest only (ties
    broken by ``argsort``'s order, as there)."""
    if threshold is None:
        return keyword
    keyword = keyword.copy()
    if isinstance(threshold, float):
        return np.where(keyword < threshold, 0.0, 1.0)
    if threshold.startswith("top"):
        return _top_k(keyword, int(threshold[3:]))
    thr_s, top_s = threshold.split("_")
    onehot = np.where(keyword < float(thr_s), 0.0, 1.0)
    k = int(top_s[3:])
    return _top_k(keyword, k) if (onehot == 1).sum() > k else onehot


def _top_k(keyword: np.ndarray, k: int) -> np.ndarray:
    ind = keyword.argsort()
    keyword[ind[-k:]] = 1.0
    keyword[ind[:-k]] = 0.0
    return keyword


class ConditionCaptionDataset(CaptionDataset):
    """``CaptionDataset`` items with their caption's ``condition``."""

    def __init__(self, features, caption: str, condition: str, **kwargs):
        super().__init__(features, caption, **kwargs)
        self.key_to_condition = load_dict_from_csv(condition,
                                                   ("cap_id", "prob"))

    def __getitem__(self, index: int) -> Dict:
        item = super().__getitem__(index)
        key = f"{item['audio_id']}_{item['cap_id']}"
        item["condition"] = np.float32(self.key_to_condition[key])
        return item


class RandomConditionDataset(InferenceDataset):
    """``InferenceDataset`` items with a ``condition`` drawn uniformly
    from the condition file's values, those below ``threshold`` repeated
    ``oversample`` times.  The draws come from ``random.Random(seed)``
    (the JAX dataset draws from the global ``random``: with the same seed
    both draw the same values in the same order)."""

    def __init__(self, features, condition: str,
                 threshold: Optional[float] = None, oversample: int = 1,
                 seed: int = 0, **kwargs):
        super().__init__(features, **kwargs)
        values = [float(v) for v in load_dict_from_csv(
            condition, ("cap_id", "prob")).values()]
        if threshold is not None and oversample > 1:
            values = values + [v for v in values if v < threshold] * (
                oversample - 1)
        self.condition_pool = values or [0.0]
        self.rng = random.Random(seed)

    def __getitem__(self, index: int) -> Dict:
        item = super().__getitem__(index)
        item["condition"] = np.float32(self.rng.choice(self.condition_pool))
        return item


class TemporalTagCaptionDataset(CaptionDataset):
    """``CaptionDataset`` items with the clip's ``temporal_tag`` (int32)."""

    def __init__(self, features, caption: str, temporal_tag: str,
                 **kwargs):
        super().__init__(features, caption, **kwargs)
        self.key_to_tag = load_dict_from_csv(temporal_tag,
                                             ("audio_id", "tag"))

    def __getitem__(self, index: int) -> Dict:
        item = super().__getitem__(index)
        item["temporal_tag"] = np.int32(self.key_to_tag[item["audio_id"]])
        return item


class TemporalTagInferenceDataset(InferenceDataset):
    """``InferenceDataset`` items with the clip's ground-truth
    ``temporal_tag``: decoding with oracle tags, or the reference of the
    SED tag accuracy (``cli/run.py::Runner.predict_temporal``)."""

    def __init__(self, features, temporal_tag: str, **kwargs):
        super().__init__(features, **kwargs)
        self.key_to_tag = load_dict_from_csv(temporal_tag,
                                             ("audio_id", "tag"))

    def __getitem__(self, index: int) -> Dict:
        item = super().__getitem__(index)
        item["temporal_tag"] = np.int32(self.key_to_tag[item["audio_id"]])
        return item


class _KeywordMixin:
    """The keyword map (``audio_id`` -> ``hdf5_path`` rows of a tsv), its
    reader and the threshold rule."""

    def _init_keywords(self, keyword_prob: str,
                       threshold: Union[None, float, str]) -> None:
        self.keyword_map = load_dict_from_csv(keyword_prob,
                                              ("audio_id", "hdf5_path"))
        self.keyword_cache = _H5Cache()
        self.keyword_threshold = threshold

    def load_keyword(self, audio_id: str) -> np.ndarray:
        path = self.keyword_map[audio_id]
        kw = (np.load(path) if path.endswith(".npy")
              else self.keyword_cache.read(path, audio_id))
        return binarize_keyword(np.asarray(kw, np.float32),
                                self.keyword_threshold)


class KeywordProbInferenceDataset(InferenceDataset, _KeywordMixin):
    """``InferenceDataset`` items with the clip's ``keyword``."""

    def __init__(self, features, keyword_prob: str,
                 threshold: Union[None, float, str] = None, **kwargs):
        super().__init__(features, **kwargs)
        self._init_keywords(keyword_prob, threshold)

    def __getitem__(self, index: int) -> Dict:
        item = super().__getitem__(index)
        item["keyword"] = self.load_keyword(item["audio_id"])
        return item


class KeywordProbCaptionDataset(CaptionDataset, _KeywordMixin):
    """``CaptionDataset`` items with the clip's ``keyword``."""

    def __init__(self, features, caption: str, keyword_prob: str,
                 threshold: Union[None, float, str] = None, **kwargs):
        super().__init__(features, caption, **kwargs)
        self._init_keywords(keyword_prob, threshold)

    def __getitem__(self, index: int) -> Dict:
        item = super().__getitem__(index)
        item["keyword"] = self.load_keyword(item["audio_id"])
        return item
