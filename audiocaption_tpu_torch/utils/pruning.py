"""Structured filter-pruning criteria (counterpart of
``audiocaption_tpu/utils/pruning.py``, kept as a copy so that the port
imports nothing of the JAX package): rank conv filters for removal by
operator norm, L1 norm or geometric median, and slice parameter dicts to
the kept filters.  ``models/effb2.py::build_pruned_effb2`` uses them to
build the pruned EfficientNet-B2 encoders.

Kernels are in flax's layout ``[kh, kw, I, O]`` (a torch conv weight
``[O, I, kh, kw]`` becomes it by ``transpose(2, 3, 1, 0)``); rankings are
per output filter, and the keep sets equal the JAX package's index for
index on the same weights.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def operator_norm_ranking(kernel: np.ndarray) -> np.ndarray:
    """Spectral norm of each filter's ``[kh * kw, I]`` matrix."""
    kh, kw, i, o = kernel.shape
    mats = kernel.reshape(kh * kw, i, o)
    scores = np.empty(o)
    for f in range(o):
        scores[f] = np.linalg.norm(mats[:, :, f], ord=2)
    return scores


def l1_ranking(kernel: np.ndarray) -> np.ndarray:
    """Li et al. (ICLR'17): L1 norm of each filter."""
    return np.abs(kernel).sum(axis=(0, 1, 2))


def geometric_median_ranking(kernel: np.ndarray) -> np.ndarray:
    """He et al. (FPGM): total distance of each filter to all others; the
    filters closest to the geometric median are the most redundant."""
    o = kernel.shape[-1]
    flat = kernel.reshape(-1, o).T          # [O, kh*kw*I]
    dists = np.linalg.norm(flat[:, None, :] - flat[None, :, :], axis=-1)
    return dists.sum(axis=1)


_CRITERIA = {
    "operator_norm": operator_norm_ranking,
    "iclr_l1": l1_ranking,
    "iclr_gm": geometric_median_ranking,
}


def select_filters(kernel: np.ndarray, prune_ratio: float,
                   method: str = "operator_norm") -> np.ndarray:
    """-> sorted indices of the filters to KEEP."""
    scores = _CRITERIA[method](np.asarray(kernel))
    n_keep = max(1, int(round(kernel.shape[-1] * (1.0 - prune_ratio))))
    keep = np.argsort(-scores)[:n_keep]
    return np.sort(keep)


def prune_conv_params(params: Dict, keep: np.ndarray,
                      next_params: Dict = None) -> Dict:
    """Slice a conv's output filters (and the next conv's input
    channels) to the kept set."""
    out = dict(params)
    out["kernel"] = np.asarray(params["kernel"])[..., keep]
    if "bias" in params:
        out["bias"] = np.asarray(params["bias"])[keep]
    if next_params is not None:
        nxt = dict(next_params)
        nxt["kernel"] = np.asarray(next_params["kernel"])[:, :, keep, :]
        return out, nxt
    return out


def prune_bn_params(bn_params: Dict, bn_stats: Dict, keep: np.ndarray):
    p = {k: np.asarray(v)[keep] for k, v in bn_params.items()}
    s = {k: np.asarray(v)[keep] for k, v in bn_stats.items()}
    return p, s
