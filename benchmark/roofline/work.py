"""Operations and bytes of the frontend and the decode, from shapes.

Copied from the program's ``chip_smoke.py`` (``logmel_work``,
``decode_flops``, ``decode_bound_ms``, ``input_bytes``) and written in
terms of shapes, so that it reads the same work whatever implements it:
each input byte read once, each output byte written once, the
operations that these inputs need (a beam search's executed steps, not
its most)."""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, dtype: str = "float32") -> float:
    """The least time the card could take: operations at the dtype's
    peak against bytes at the memory's rate, whichever is longer."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def logmel_work(n_fft: int, hop: int, n_mels: int, fb: np.ndarray,
                batch: int, samples: int) -> Tuple[int, int]:
    """(float ops, bytes) of the log-mel of ``batch`` waves of ``samples``
    each.  Per frame: the window product (n_fft), a real FFT (2.5 n_fft
    log2 n_fft), the power of the bins that carry mel weight (3 each),
    the mel product over the filterbank's nonzero weights (2 each) and
    the dB conversion (2 per mel).  Bytes: the wave read once, the window
    and the nonzero mel weights read once, the log-mel written once."""
    frames = samples // hop + 1
    nonzero = fb != 0
    nnz, bins = int(nonzero.sum()), int(nonzero.any(1).sum())
    per_frame = (n_fft + 2.5 * n_fft * math.log2(n_fft) + 3 * bins
                 + 2 * nnz + 2 * n_mels)
    flops = int(batch * frames * per_frame)
    nbytes = 4 * (batch * samples + n_fft + nnz + batch * frames * n_mels)
    return flops, nbytes


def memory_kv_work(batch: int, S: int, D: int, E: int, layers: int
                   ) -> Tuple[int, int]:
    """(ops, bytes) of projecting the encoder's memory [B, S, D] to each
    layer's cross-attention keys and values: Linear D -> E (ReLU,
    LayerNorm), then 2 E x E products a layer."""
    flops = 2 * batch * S * D * E + layers * 2 * 2 * batch * S * E * E
    nbytes = 4 * (batch * S * D + D * E + 3 * E + layers * 2 * (E * E + E)
                  + layers * 2 * batch * S * E)
    return flops, nbytes


def decode_flops(E: int, F: int, V: int, S_valid: Sequence[int],
                 steps: Sequence[int], rows_per_sample: int, layers: int,
                 S: int) -> Tuple[int, int]:
    """(product ops, attention ops) of a decode: per executed step and row
    the layers' and the vocabulary products (weights times the row), and
    self attention over t + 1 keys plus cross attention over the valid
    memory (all S keys where none is valid); 2 ops a multiply-add."""
    per_step = layers * 2 * (6 * E * E + 2 * E * F) + 2 * V * E
    mm = attn = 0
    for s_valid, n in zip(S_valid, steps):
        keys = s_valid if s_valid > 0 else S
        for t in range(int(n)):
            mm += rows_per_sample * per_step
            attn += rows_per_sample * layers * 2 * 2 * E * ((t + 1) + keys)
    return mm, attn


def decode_bytes(E: int, F: int, V: int, layers: int, tied: bool, B: int,
                 S: int, K: int, L: int) -> int:
    """Each input of a beam decode read once (the embedding, an untied
    classifier, each layer's matrices, biases and norms, the positional
    rows used, the memory K/V, the valid mask) and the outputs written
    once (sequences and scores)."""
    per_layer = 6 * E * E + 2 * E * F + 9 * E + F + 6 * E
    weights = V * E * (1 if tied else 2) + layers * per_layer + L * E
    memkv = layers * 2 * B * S * E
    return 4 * (weights + memkv) + B * S + 4 * (B * K * L + B * K)


def decode_work(dims: Dict, B: int, S: int, S_valid: Sequence[int],
                steps: Sequence[int]) -> Tuple[int, int]:
    """(ops, bytes) of a call's decode: the memory K/V products and the
    beam search at its executed steps."""
    E, F, V, nl = dims["E"], dims["F"], dims["V"], dims["layers"]
    kv_ops, kv_bytes = memory_kv_work(B, S, dims["D"], E, nl)
    mm, attn = decode_flops(E, F, V, S_valid, steps, dims["K"], nl, S)
    return (kv_ops + mm + attn,
            kv_bytes + decode_bytes(E, F, V, nl, dims["tied"], B, S,
                                    dims["K"], dims["L"]))
