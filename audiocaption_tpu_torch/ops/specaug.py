"""SpecAugment, torchlibrosa-style stripe dropping (counterpart of
``audiocaption_tpu/ops/specaug.py``).

Per sample, ``stripes_num`` stripes along time, then along frequency; a
stripe has width ``distance ~ U[0, drop_width)`` and start
``bgn ~ U[0, max(dim - distance, 1))`` (the JAX bound, kept exactly: a
stripe as wide as the axis still starts at 0), and every element inside
it is zeroed.

The draw and the apply are split: :func:`draw_stripes` draws one axis's
stripes from an explicit ``torch.Generator`` on the batch's device,
:func:`drop_stripes` zeroes given stripes (a pure function, so stripes
drawn anywhere, JAX's included, can be replayed), and
:func:`spec_augment` does both for time and frequency.

Under data parallelism a rank holds rows ``[lo, lo + B)`` of a global
batch: given ``rows=(lo, total)`` the stripes are drawn for all ``total``
rows and this rank's taken, so that every row gets the stripes that one
process drawing for the global batch would give it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

Stripes = Tuple[torch.Tensor, torch.Tensor]


def draw_stripes(batch: int, dim: int, drop_width: int, stripes_num: int,
                 generator: Optional[torch.Generator] = None,
                 device=None, rows: Optional[Tuple[int, int]] = None
                 ) -> Stripes:
    """-> (distance, bgn), each int64 [stripes_num, batch]: widths in
    [0, drop_width) and starts in [0, max(dim - distance, 1)); with
    ``rows=(lo, total)``, columns ``[lo, lo + batch)`` of the draw for
    ``total`` rows."""
    lo, total = rows if rows is not None else (0, batch)
    distance = torch.randint(0, drop_width, (stripes_num, total),
                             generator=generator, device=device)
    high = torch.clamp(dim - distance, min=1)
    u = torch.rand((stripes_num, total), generator=generator,
                   device=device, dtype=torch.float64)
    bgn = torch.minimum((u * high).long(), high - 1)
    return distance[:, lo:lo + batch], bgn[:, lo:lo + batch]


def drop_stripes(x: torch.Tensor, axis: int, distance: torch.Tensor,
                 bgn: torch.Tensor) -> torch.Tensor:
    """x [B, T, F] with every stripe ``[bgn, bgn + distance)`` of
    ``axis`` (1: time, 2: frequency) zeroed; ``distance`` and ``bgn``
    [stripes, B]."""
    dim = x.shape[axis]
    coords = torch.arange(dim, device=x.device)
    distance, bgn = distance.to(x.device), bgn.to(x.device)
    stripe = ((coords >= bgn[..., None])
              & (coords < (bgn + distance)[..., None]))   # [S, B, dim]
    keep = ~stripe.any(0)
    shape = [x.shape[0], 1, 1]
    shape[axis] = dim
    return x * keep.reshape(shape).to(x.dtype)


def spec_augment(lms: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 time_drop_width: int = 64, time_stripes_num: int = 2,
                 freq_drop_width: int = 8, freq_stripes_num: int = 2,
                 stripes: Optional[Dict[str, Stripes]] = None,
                 rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """lms [B, T, F] -> a copy with time stripes, then frequency stripes
    dropped, drawn from ``generator`` (on ``lms``'s device; None: the
    device's default generator) for ``rows`` of a global batch (see the
    module docstring; None: the batch is all).  Given a dict ``stripes``,
    the draws are stored in it under "time" and "freq"."""
    B, T, F = lms.shape
    time = draw_stripes(B, T, time_drop_width, time_stripes_num, generator,
                        lms.device, rows)
    freq = draw_stripes(B, F, freq_drop_width, freq_stripes_num, generator,
                        lms.device, rows)
    if stripes is not None:
        stripes.update(time=time, freq=freq)
    return drop_stripes(drop_stripes(lms, 1, *time), 2, *freq)
