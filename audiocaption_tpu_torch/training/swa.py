"""Stochastic weight averaging over parameters and batch-norm statistics
(counterpart of ``audiocaption_tpu/training/swa.py``; the reference's
``AveragedModel`` averages buffers too, so the averaged model needs no
BN re-estimation).

The average is kept on flat state dicts (name -> tensor or array, the
checkpoint's key space), on whatever device or host the snapshots live:
the runner averages host copies on its checkpoint thread.  Floating
entries are averaged in float32; integer entries (BN batch counts)
follow the newest snapshot.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

SwaState = Tuple[Dict, int]


def _copy(v):
    return v.detach().clone() if torch.is_tensor(v) else np.array(v)


def swa_init(state: Mapping) -> SwaState:
    """-> (a copy of ``state``, n_averaged = 0)."""
    return {k: _copy(v) for k, v in state.items()}, 0


def _is_float(v) -> bool:
    return (v.is_floating_point() if torch.is_tensor(v)
            else np.issubdtype(np.asarray(v).dtype, np.floating))


def swa_update(swa: SwaState, state: Mapping) -> SwaState:
    """avg <- avg + (new - avg) / (n + 1), each term in float32."""
    avg, n = swa
    out = {}
    for k, a in avg.items():
        b = state[k]
        if not _is_float(a):
            out[k] = _copy(b)
        elif torch.is_tensor(a):
            a32 = a.float()
            out[k] = (a32 + (b.float() - a32) / float(n + 1)).to(a.dtype)
        else:
            a32 = np.asarray(a, np.float32)
            out[k] = (a32 + (np.asarray(b, np.float32) - a32)
                      / np.float32(n + 1)).astype(np.asarray(a).dtype)
    return out, n + 1
