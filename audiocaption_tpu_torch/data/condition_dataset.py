"""Condition and temporal-tag datasets (counterpart of
``audiocaption_tpu/data/condition_dataset.py`` but its keyword datasets,
ROADMAP Queue 1 item 8b).

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
    ``cli/synthetic_corpus.py::generate_temporal``).

The collate turns the items' scalar ``condition`` / ``temporal_tag``
into [B] arrays (``data/collate.py``).
"""

from __future__ import annotations

import csv
import random
from typing import Dict, Optional

import numpy as np

from audiocaption_tpu_torch.data.dataset import (
    CaptionDataset, InferenceDataset)


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
