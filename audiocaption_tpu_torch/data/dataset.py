"""Audio (caption) datasets (counterpart of
``audiocaption_tpu/data/dataset.py``; reference
``captioning/datasets/caption_dataset.py``).

Map-style datasets for ``torch.utils.data.DataLoader``; items are plain
numpy.  As in the reference:

  * ``wav.csv`` maps audio_id (tab-separated) to an ``hdf5_path`` or a
    ``file_name`` column.  An ``hdf5_path`` row is read from the h5
    (AudioCaps ids fall back to "Y{id}.wav" keys), a ``file_name`` row
    from its wav file (``scipy.io.wavfile``, at the file's own rate).
    The JAX package's h5-backed classes read ``hdf5_path`` rows only and
    its ``WavCaptionDataset`` ``file_name`` rows only; the port reads
    both in every dataset, because the card machine has no h5py and the
    port's corpora (``cli/synthetic_corpus.py``) are wav files;
  * h5 handles open lazily, once per process (re-opened after a fork);
  * resample orig_sr -> target_sr (scipy polyphase);
  * ``audio_duration`` (seconds at the target rate): a random crop of a
    longer clip (Python's ``random``, as the reference), zeros after a
    shorter one;
  * ``CaptionDataset`` yields one item per (audio_id, cap_id), the
    caption string tokenized later by the collate;
  * ``transforms``, a chain of callables (``data/augment.py``), apply to
    the wave after the crop or pad, in order;
  * a row may hold precomputed features ``[T, D]`` in place of a wave
    (the feature-input families): an ``hdf5_path`` row of
    ``cli/prepare_features.py``'s ``attn.h5``, or a ``file_name`` row
    ending in ``.npy``, read with ``numpy.load`` (its ``--format npy``;
    the card machine has no h5py);
  * ``enable_wav_index(lens)`` switches items to ``{wav_idx, wav_len}``,
    a row of the device-resident bank (``data/device_bank.py``) in place
    of the samples (``wav_index_mode``).

``h5py`` and ``scipy`` are imported where they are used.
"""

from __future__ import annotations

import csv
import json
import os
import random
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

import numpy as np


def read_wav_table(path: str) -> Tuple[Dict[str, str], bool]:
    """wav.csv (tab-separated: audio_id, hdf5_path | file_name) ->
    (audio_id -> path, whether the rows are wav files)."""
    mapping = {}
    with open(path) as f:
        reader = csv.DictReader(f, delimiter="\t")
        files = "hdf5_path" not in (reader.fieldnames or ())
        for row in reader:
            mapping[row["audio_id"]] = (row.get("hdf5_path")
                                        or row.get("file_name"))
    return mapping, files


def read_wav_csv(path: str) -> Dict[str, str]:
    """wav.csv (tab-separated: audio_id, hdf5_path | file_name) -> audio_id
    -> its h5 or wav path (``audiocaption_tpu/data/dataset.py::
    read_wav_csv``)."""
    return read_wav_table(path)[0]


def read_wav(path: str) -> Tuple[int, np.ndarray]:
    """-> (sample rate, float32 mono wave in [-1, 1])."""
    from scipy.io import wavfile
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data / 32768.0
    elif data.dtype == np.int32:
        data = data / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    data = np.asarray(data, np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    return sr, data


def load_caption_json(path: str, zh: bool = False) -> Dict[str, List[str]]:
    """caption json -> {audio_id: [caption strings]}."""
    with open(path) as f:
        data = json.load(f)
    key2refs: Dict[str, List[str]] = {}
    for audio in data["audios"]:
        refs = []
        for cap in audio["captions"]:
            if zh:
                refs.append(cap.get("tokens", cap.get("caption", "")))
            else:
                refs.append(cap.get("caption", cap.get("tokens", "")))
        key2refs[audio["audio_id"]] = refs
    return key2refs


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return wav
    from scipy.signal import resample_poly
    frac = Fraction(target_sr, orig_sr)
    return resample_poly(wav, frac.numerator, frac.denominator
                         ).astype(np.float32)


class _H5Cache:
    """Lazy per-process h5 file handles."""

    def __init__(self):
        self._handles: Dict = {}
        self._pid = None

    def read(self, h5_path: str, key: str) -> np.ndarray:
        import h5py
        if self._pid != os.getpid():
            self._handles = {}
            self._pid = os.getpid()
        if h5_path not in self._handles:
            self._handles[h5_path] = h5py.File(h5_path, "r")
        f = self._handles[h5_path]
        if key not in f and not key.startswith("Y"):
            alt = f"Y{key}.wav"   # AudioCaps packing quirk
            if alt in f:
                key = alt
        # read in the stored dtype (a plain copy), then convert in numpy
        arr = f[key][...]
        if arr.dtype == np.int16:
            return arr.astype(np.float32) / 32768.0
        if arr.dtype != np.float32:
            return arr.astype(np.float32)
        return arr


class InferenceDataset:
    """Audio only: {audio_id, wav} items."""

    # None: read the rows by their wav.csv column; True: wav files
    from_files: Optional[bool] = None

    def __init__(self, features: Dict[str, str],
                 orig_sr: Optional[int] = None,
                 target_sr: Optional[int] = None,
                 audio_duration: Optional[float] = None,
                 transforms: Optional[List] = None):
        wav_csv = features["wav"] if isinstance(features, dict) else features
        self.aid_to_h5, files = read_wav_table(wav_csv)
        if self.from_files is None:
            self.from_files = files
        self.audio_ids = list(self.aid_to_h5.keys())
        self.orig_sr = orig_sr
        self.target_sr = target_sr
        self.audio_duration = audio_duration
        self.transforms = list(transforms or [])
        self.cache = _H5Cache()
        self.wav_index_mode = False

    def enable_wav_index(self, bank_lens: np.ndarray) -> None:
        """Items carry ``{wav_idx, wav_len}`` from now on: row i of the
        device bank built over ``audio_ids`` (``build_wav_bank``) and its
        length, in place of the samples."""
        self.wav_index_mode = True
        self._bank_lens = np.asarray(bank_lens, np.int32)
        self._aid_to_idx = {a: i for i, a in enumerate(self.audio_ids)}

    def _index_item(self, audio_id: str) -> Dict:
        i = self._aid_to_idx[audio_id]
        return {"wav_idx": np.int32(i), "wav_len": self._bank_lens[i]}

    def __len__(self) -> int:
        return len(self.audio_ids)

    def read_with_rate(self, audio_id: str) -> Tuple[Optional[int],
                                                      np.ndarray]:
        """(its rate: a wav file's own, ``orig_sr`` for an h5 row; the
        stored wave)."""
        if self.from_files:
            path = self.aid_to_h5[audio_id]
            if path.endswith(".npy"):
                return None, np.load(path)
            return read_wav(path)
        return self.orig_sr, self.cache.read(self.aid_to_h5[audio_id],
                                             audio_id)

    def read(self, audio_id: str) -> np.ndarray:
        """The stored wave, at its own rate."""
        return self.read_with_rate(audio_id)[1]

    def _crop_or_pad(self, wav: np.ndarray) -> np.ndarray:
        if self.audio_duration is None:
            return wav
        n = int(self.audio_duration * (self.target_sr or self.orig_sr))
        if len(wav) > n:
            start = random.randint(0, len(wav) - n)
            return wav[start:start + n]
        if len(wav) < n:
            return np.pad(wav, (0, n - len(wav)))
        return wav

    def get_audio(self, audio_id: str) -> np.ndarray:
        sr, wav = self.read_with_rate(audio_id)
        if sr and self.target_sr:
            wav = resample(wav, sr, self.target_sr)
        wav = self._crop_or_pad(wav)
        for tf in self.transforms:
            wav = tf(wav)
        return np.asarray(wav, np.float32)

    def __getitem__(self, index: int) -> Dict:
        aid = self.audio_ids[index]
        if self.wav_index_mode:
            return {"audio_id": aid, **self._index_item(aid)}
        return {"audio_id": aid, "wav": self.get_audio(aid)}


class CaptionDataset(InferenceDataset):
    """One item per (audio_id, cap_id), with the raw caption string."""

    def __init__(self, features: Dict[str, str], caption: str,
                 zh: bool = False, **kwargs):
        super().__init__(features, **kwargs)
        with open(caption) as f:
            data = json.load(f)
        self.items: List[Dict] = []
        for audio in data["audios"]:
            aid = audio["audio_id"]
            if aid not in self.aid_to_h5:
                continue
            for cap in audio["captions"]:
                self.items.append({
                    "audio_id": aid,
                    "cap_id": str(cap.get("cap_id", 0)),
                    "cap": cap.get("tokens", cap.get("caption", "")),
                })

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, index: int) -> Dict:
        item = dict(self.items[index])
        if self.wav_index_mode:
            item.update(self._index_item(item["audio_id"]))
        else:
            item["wav"] = self.get_audio(item["audio_id"])
        return item


class WavCaptionDataset(CaptionDataset):
    """A ``CaptionDataset`` whose wav.csv rows are wav files whatever the
    column's name (the JAX ``WavCaptionDataset``; reference
    ``caption_wav_read_dataset.py``), resampled from the file's rate."""

    from_files = True
