"""Temporal-tag datasets (counterpart of the temporal part of
``audiocaption_tpu/data/condition_dataset.py``): the captioner of the
temporal-tag pipeline trains on (clip, caption, ground-truth tag) and is
scored with the ground-truth tag or the SED net's.  Tags: 0 single event,
1 simultaneous, 2 sequential, 3 complex.  The tag file is a tsv
(``audio_id\\ttag``, ``cli/synthetic_corpus.py::generate_temporal``).
"""

from __future__ import annotations

import csv
from typing import Dict

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
