"""Device-resident corpus bank (counterpart of
``audiocaption_tpu/data/device_bank.py``).

Opt-in (``data.{train,val}.device_resident`` in a config): every row of a
fixed corpus goes to the device once, as a zero-padded float16 tensor;
each batch then carries bank row indices (``wav_idx``) and lengths, and
the train step and the val scorer gather the rows on the device
(:func:`bank_rows`).  Rows are waves ``[T]`` or precomputed features
``[T, D]`` (the feature-input families, e.g. M2), padded along axis 0.
float16 is exact for corpora stored as float16 or int16 waves; features
lose what float16 rounds off, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def bank_rows(bank: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of ``bank``, widened to float32: float16 / bfloat16 as
    they are, int16 / 32768."""
    rows = bank.index_select(0, idx.to(bank.device, torch.long))
    if rows.dtype in (torch.float16, torch.bfloat16):
        return rows.float()
    if rows.dtype == torch.int16:
        return rows.float() / 32768.0
    return rows


def build_wav_bank(dataset, device: torch.device
                   ) -> Tuple[torch.Tensor, np.ndarray]:
    """A ``[N, max_len(, D)]`` float16 bank on ``device`` over
    ``dataset.audio_ids`` (an ``InferenceDataset`` / ``CaptionDataset``)
    -> (bank, lens): row i holds ``dataset.get_audio(audio_ids[i])``
    zero-padded to the longest, ``lens[i]`` its length.  Pair it with
    ``dataset.enable_wav_index(lens)``, so that items carry ``wav_idx`` and
    ``wav_len`` in place of the samples."""
    rows = [np.asarray(dataset.get_audio(aid), np.float16)
            for aid in dataset.audio_ids]
    lens = np.asarray([r.shape[0] for r in rows], np.int32)
    bank = np.zeros((len(rows), int(lens.max())) + rows[0].shape[1:],
                    np.float16)
    for i, r in enumerate(rows):
        bank[i, :r.shape[0]] = r
    return torch.from_numpy(bank).to(device), lens
