"""The beam search's own score of each caption it serves, recorded as the
window runs: the kernel's (``fused_beam.fused_beam_decode``, on the card)
or the torch engine's (``generate``, on the CPU), the best beam's.  The
judge holds these scores against the reference's score of the served
sequence, which moves with the precision the search computed in, where
the served tokens seldom do.  Recording keeps a reference to the score
tensor and adds no synchronisation."""

from __future__ import annotations

import contextlib
import functools
from typing import List

import torch


@contextlib.contextmanager
def best_scores(into: List[torch.Tensor]):
    """Append each beam search's best-beam scores [B] to ``into``.  The
    wrappers carry the kernel wrapper's attributes (its launch counters,
    which it updates through its module's name)."""
    from audiocaption_tpu_torch.decoding import fused_beam, select
    kernel, engine = fused_beam.fused_beam_decode, select.generate

    @functools.wraps(kernel)
    def kernel_call(*a, **k):
        seq, score = kernel(*a, **k)
        into.append(score[:, 0])
        return seq, score

    @functools.wraps(engine)
    def engine_call(*a, **k):
        out = engine(*a, **k)
        if "score" in out:
            into.append(out["score"])
        return out
    fused_beam.fused_beam_decode, select.generate = kernel_call, engine_call
    try:
        yield into
    finally:
        fused_beam.fused_beam_decode, select.generate = kernel, engine
