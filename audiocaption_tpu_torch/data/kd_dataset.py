"""Dual-rate student / teacher KD datasets and the wraparound iteration
batch sampler (counterpart of ``audiocaption_tpu/data/kd_dataset.py``;
reference ``caption_dataset.py``).

The KD datasets emit a student wave (resampled to ``target_sr``, cropped
at random to ``audio_duration``) and a teacher wave (``teacher_target_sr``,
its crop ALIGNED to the student's: it starts at the same time, cut to
``teacher_duration``).  The crop draws from Python's ``random``; the
sampler's shuffles from ``np.random``, as in the JAX package.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np

from audiocaption_tpu_torch.data.dataset import (
    CaptionDataset, InferenceDataset, resample)


class _DualRateMixin:

    def _init_teacher(self, teacher_target_sr: int,
                      teacher_duration: Optional[float]) -> None:
        self.teacher_target_sr = teacher_target_sr
        self.teacher_duration = teacher_duration

    def _dual_waveforms(self, orig_wav: np.ndarray) -> Dict[str, np.ndarray]:
        stu = resample(orig_wav, self.orig_sr, self.target_sr) \
            if self.orig_sr and self.orig_sr != self.target_sr else orig_wav
        tea = resample(orig_wav, self.orig_sr, self.teacher_target_sr) \
            if self.orig_sr and self.orig_sr != self.teacher_target_sr \
            else orig_wav
        start = 0
        if self.audio_duration is not None:
            n = int(self.audio_duration * self.target_sr)
            if len(stu) > n:
                start = random.randint(0, len(stu) - n)
                stu = stu[start:start + n]
            elif len(stu) < n:
                stu = np.pad(stu, (0, n - len(stu)))
        if self.teacher_duration is not None:
            m = int(self.teacher_duration * self.teacher_target_sr)
            if len(tea) > m:
                # the same start time as the student's crop
                t_start = self.teacher_target_sr * start // self.target_sr
                tea = tea[t_start:t_start + m]
            if len(tea) < m:
                tea = np.pad(tea, (0, m - len(tea)))
        return {"wav": np.asarray(stu, np.float32),
                "teacher_wav": np.asarray(tea, np.float32)}


class InferKdDataset(InferenceDataset, _DualRateMixin):
    """Audio only: {audio_id, wav, teacher_wav} items."""

    def __init__(self, features, orig_sr: int = 32000,
                 target_sr: int = 32000, teacher_target_sr: int = 32000,
                 audio_duration: Optional[float] = None,
                 teacher_duration: Optional[float] = None, **kwargs):
        super().__init__(features, orig_sr=orig_sr, target_sr=target_sr,
                         audio_duration=audio_duration, **kwargs)
        self._init_teacher(teacher_target_sr, teacher_duration)

    def __getitem__(self, index: int) -> Dict:
        aid = self.audio_ids[index]
        item = {"audio_id": aid}
        item.update(self._dual_waveforms(
            np.asarray(self.read(aid), np.float32)))
        return item


class CaptionKdDataset(CaptionDataset, _DualRateMixin):
    """One item per (audio_id, cap_id): the caption and both waves."""

    def __init__(self, features, caption: str, orig_sr: int = 32000,
                 target_sr: int = 32000, teacher_target_sr: int = 32000,
                 audio_duration: Optional[float] = None,
                 teacher_duration: Optional[float] = None, **kwargs):
        super().__init__(features, caption, orig_sr=orig_sr,
                         target_sr=target_sr, audio_duration=audio_duration,
                         **kwargs)
        self._init_teacher(teacher_target_sr, teacher_duration)

    def __getitem__(self, index: int) -> Dict:
        item = dict(self.items[index])
        item.update(self._dual_waveforms(
            np.asarray(self.read(item["audio_id"]), np.float32)))
        return item


class IterationBatchSampler:
    """A fixed number of samples an epoch, in batches, with a wraparound
    shuffle: when the index queue runs out it is refilled (and shuffled
    again with ``shuffle``).  Usable as a ``DataLoader``'s
    ``batch_sampler``."""

    def __init__(self, data_source, batch_size: int, num_samples: int,
                 shuffle: bool = False):
        self.data_source = data_source
        self.batch_size = batch_size
        self.num_samples = num_samples
        self.shuffle = shuffle
        self.index_queue = list(range(len(data_source)))
        if shuffle:
            np.random.shuffle(self.index_queue)
        self.pointer = 0

    def __iter__(self):
        batches: List[List[int]] = []
        produced = 0
        while produced < self.num_samples:
            take = min(self.batch_size, self.num_samples - produced)
            batch = []
            for _ in range(take):
                if self.pointer >= len(self.index_queue):
                    self.index_queue = list(range(len(self.data_source)))
                    self.pointer = 0
                    if self.shuffle:
                        np.random.shuffle(self.index_queue)
                batch.append(self.index_queue[self.pointer])
                self.pointer += 1
            batches.append(batch)
            produced += take
        return iter(batches)

    def __len__(self) -> int:
        return (self.num_samples + self.batch_size - 1) // self.batch_size
