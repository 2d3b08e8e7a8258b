"""Length-mask primitives (counterpart of ``audiocaption_tpu/ops/masking.py``).

Ragged batches travel as ``(data, lens)``: ``data`` padded to a fixed
length and ``lens`` the valid prefix of each row.
"""

from __future__ import annotations

import torch


def length_mask(lens: torch.Tensor, max_length: int) -> torch.Tensor:
    """Boolean mask [N, max_length]: True where position < lens[n]."""
    idxs = torch.arange(max_length, device=lens.device, dtype=lens.dtype)
    return idxs[None, :] < lens[:, None]


def mean_with_lens(features: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Masked mean over axis 1 of [N, T, ...], divided by ``lens``
    (not by the padded T).  A row of length 0 gives NaN (0 / 0), as in
    the JAX package; callers keep lengths >= 1."""
    mask = length_mask(lens, features.shape[1])
    mask = mask.reshape(mask.shape + (1,) * (features.ndim - 2))
    total = torch.sum(features * mask.to(features.dtype), dim=1)
    denom = lens.to(features.dtype).reshape(lens.shape + (1,) * (total.ndim - 1))
    return total / denom


def max_with_lens(features: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Masked max over axis 1 of [N, T, ...]: padded positions are -inf so
    they never win (a row of length 0 gives -inf)."""
    mask = length_mask(lens, features.shape[1])
    mask = mask.reshape(mask.shape + (1,) * (features.ndim - 2))
    return features.masked_fill(~mask, float("-inf")).amax(dim=1)
