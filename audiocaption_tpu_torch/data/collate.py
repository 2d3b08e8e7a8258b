"""Batch collation with padding and length arrays (counterpart of
``audiocaption_tpu/data/collate.py``; reference
``captioning/datasets/collate_func.py``), with its length bucketing:
padded lengths round up to a multiple of a bucket, so a corpus yields a
handful of batch shapes (a wave by ``buckets``, in samples; a row of
precomputed features ``[T, D]`` by ``feature_bucket`` frames, as the JAX
collate does).  Batches are numpy; the runner moves them to the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


# per-clip probability vectors [C] that stack into [B, C] float32 (the
# conditioned transformer decoders' inputs: a float threshold of
# ``binarize_keyword`` gives float64 rows)
FLOAT_KEYS = ("keyword", "event")


def bucket_length(n: int, bucket: int) -> int:
    """Round n up to a multiple of ``bucket``."""
    return max(bucket, (n + bucket - 1) // bucket * bucket)


def pad_sequences(seqs: List[np.ndarray], pad_value=0.0,
                  bucket: Optional[int] = None):
    """List of [T, ...] arrays -> (padded [N, Tmax(, ...)], lens [N])."""
    lens = np.asarray([s.shape[0] for s in seqs], np.int32)
    tmax = int(lens.max())
    if bucket:
        tmax = bucket_length(tmax, bucket)
    shape = (len(seqs), tmax) + seqs[0].shape[1:]
    out = np.full(shape, pad_value, seqs[0].dtype)
    for i, s in enumerate(seqs):
        out[i, :s.shape[0]] = s
    return out, lens


class VarLenPadCollate:
    """Dict-of-lists collate padding ``pad_keys`` and emitting
    ``{key}_len`` (collate_func.py:10-43)."""

    def __init__(self, pad_keys: Sequence[str] = (),
                 sort_key: Optional[str] = None,
                 buckets: Optional[Dict[str, int]] = None,
                 wire_dtype: Optional[Dict[str, str]] = None,
                 feature_bucket: int = 16):
        self.pad_keys = list(pad_keys)
        self.sort_key = sort_key
        # per-key bucket, in samples for a wave (16000 = 1 s at 16 kHz);
        # rows of two or more dimensions (features) by feature_bucket
        self.buckets = buckets or {}
        self.feature_bucket = feature_bucket
        # per-key compact wire dtype (e.g. {"wav": "float16"}): the
        # padded batch is emitted in this dtype to halve host->device
        # bytes; the runner widens it to float32 on the device
        # (cli/run.py::to_device).  float16 is lossless for corpora
        # packed as int16/f16 waveforms.
        self.wire_dtype = {k: np.dtype(v)
                           for k, v in (wire_dtype or {}).items()}

    def __call__(self, items: List[Dict]) -> Dict[str, np.ndarray]:
        if self.sort_key:
            items = sorted(items,
                           key=lambda x: len(x[self.sort_key]), reverse=True)
        batch: Dict[str, List] = {k: [item[k] for item in items]
                                  for k in items[0]}
        out: Dict[str, np.ndarray] = {}
        for k, vals in batch.items():
            if k in self.pad_keys:
                wire = self.wire_dtype.get(k)
                arrs = [np.asarray(v) if wire is None
                        else np.asarray(v).astype(wire, copy=False)
                        for v in vals]
                bucket = (self.feature_bucket if arrs[0].ndim >= 2
                          else self.buckets.get(k))
                padded, lens = pad_sequences(arrs, bucket=bucket)
                out[k] = padded
                out[f"{k}_len"] = lens
            elif k in FLOAT_KEYS:
                out[k] = np.asarray(vals, np.float32)
            else:
                try:
                    out[k] = np.asarray(vals)
                except (ValueError, TypeError):
                    out[k] = vals  # ragged / non-numeric (ids, strings)
        return out


class TextCollate(VarLenPadCollate):
    """VarLenPadCollate + tokenizer over ``text_key`` producing
    cap/cap_len (collate_func.py:46-84)."""

    def __init__(self, tokenizer, text_key: str = "cap",
                 pad_keys: Sequence[str] = (),
                 sort_key: Optional[str] = None,
                 buckets: Optional[Dict[str, int]] = None,
                 wire_dtype: Optional[Dict[str, str]] = None,
                 feature_bucket: int = 16):
        pad_keys = [k for k in pad_keys if k != text_key]
        super().__init__(pad_keys, sort_key, buckets, wire_dtype,
                         feature_bucket)
        self.tokenizer = tokenizer
        self.text_key = text_key

    def __call__(self, items: List[Dict]) -> Dict[str, np.ndarray]:
        if self.sort_key == self.text_key:
            items = sorted(items, key=lambda x: len(x[self.text_key]),
                           reverse=True)
            self_sort, self.sort_key = self.sort_key, None
            out = super().__call__(items)
            self.sort_key = self_sort
        else:
            out = super().__call__(items)
        texts = out.pop(self.text_key)
        if not isinstance(texts, list):
            texts = list(texts)
        out.update(self.tokenizer(texts))
        # A configured bucket for the tokenized key rounds the padded
        # caption length up (tokenizer pad id; padded positions are
        # inert under the length-masked loss).
        b = self.buckets.get(self.text_key)
        cap = out.get(self.text_key)
        if b and cap is not None and cap.ndim == 2:
            L = bucket_length(cap.shape[1], b)
            if L > cap.shape[1]:
                out[self.text_key] = np.pad(
                    cap, ((0, 0), (0, L - cap.shape[1])),
                    constant_values=getattr(self.tokenizer, "pad", 0))
        return out
