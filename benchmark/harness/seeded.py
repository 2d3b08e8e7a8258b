"""Inputs and weights made from ``--seed``.

Every seed gets the same sizes: lengths, caption lengths and arrival
gaps are fixed quantiles of their distributions, put in an order drawn
from the seed.  The seed changes the order, the audio, the words and
the weights, not the amount of work.  Bulk draws are made on the
device by a ``torch.Generator`` in a few large calls.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

TAGS = {"weights": 1, "audio": 2, "order": 3, "words": 4, "coins": 5,
        "sample": 6, "arrivals": 7, "dropout": 8}


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of ``seed`` (seeds may exceed 32 bits)."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), TAGS[tag]])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def host_rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, tag))


def device_gen(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def quantiles(n: int, lo: float, hi: float) -> np.ndarray:
    """n evenly spaced mid-point quantiles of U(lo, hi)."""
    return lo + (hi - lo) * (np.arange(n) + 0.5) / n


def clip_lengths(n: int, spec: Dict, sample_rate: int, seed: int
                 ) -> np.ndarray:
    """Sample counts of ``n`` clips, in an order drawn from ``seed``.
    ``spec``: {"full_s", "full_share", "short_s": [lo, hi]} (a share of
    clips at full length, the rest spread evenly over [lo, hi]) or
    {"uniform_s": [lo, hi]}."""
    if "uniform_s" in spec:
        secs = quantiles(n, *spec["uniform_s"])
    else:
        n_short = int(round(n * (1.0 - spec["full_share"])))
        secs = np.concatenate([np.full(n - n_short, float(spec["full_s"])),
                               quantiles(n_short, *spec["short_s"])])
    samples = np.floor(secs * sample_rate).astype(np.int64)
    return samples[host_rng(seed, "order").permutation(n)]


def bucket_samples(n: int, sample_rate: int, bucket_s: float = 1.0) -> int:
    """``hf_api.pad_bucket``'s padded length of a longest clip of ``n``."""
    bucket = int(sample_rate * bucket_s)
    return max(bucket, (n + bucket - 1) // bucket * bucket)


@torch.no_grad()
def audio(lengths: Sequence[int], width: int, sample_rate: int,
          gen: torch.Generator, chunk: int = 64) -> torch.Tensor:
    """Clips [N, width] float32 on ``gen``'s device, zero past each
    length: three tones at log-uniform frequencies under a slow amplitude
    swell, plus white noise, peaks about 0.5."""
    device = gen.device
    n = len(lengths)
    out = torch.empty(n, width, dtype=torch.float32, device=device)
    t = torch.arange(width, device=device, dtype=torch.float32) / sample_rate
    lens = torch.as_tensor(np.asarray(lengths), device=device)
    for a in range(0, n, chunk):
        b = min(n, a + chunk)
        m = b - a
        params = torch.rand(m, 12, generator=gen, device=device)
        freq = 100.0 * (sample_rate / 250.0) ** params[:, 0:3]
        amp = 0.05 + 0.1 * params[:, 3:6]
        phase = 2 * math.pi * params[:, 6:9]
        swell = 0.2 + 2.0 * params[:, 9:10]
        noise_level = 0.005 + 0.05 * params[:, 10:11]
        x = torch.zeros(m, width, device=device)
        for k in range(3):
            x += amp[:, k:k + 1] * torch.sin(
                2 * math.pi * freq[:, k:k + 1] * t + phase[:, k:k + 1])
        x *= 0.6 + 0.4 * torch.sin(2 * math.pi * swell * t)
        x += noise_level * torch.randn(m, width, generator=gen, device=device)
        x *= (torch.arange(width, device=device)[None] < lens[a:b, None])
        out[a:b] = x
    return out


def to_int16(x: torch.Tensor) -> torch.Tensor:
    """16-bit PCM of a float wave in [-1, 1]."""
    return torch.round(x.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)


def captions(n: int, words: Tuple[int, int], vocab: int, seed: int,
             bos: int = 1, eos: int = 2, pad: int = 0,
             first_word: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """``n`` captions of words[0]..words[1] words (evenly spread, in a
    seeded order), ids drawn from [first_word, vocab), framed by <bos> and
    <eos> -> (ids [n, max + 2] padded with ``pad``, lengths with both
    marks)."""
    counts = np.rint(quantiles(n, words[0] - 0.5, words[1] + 0.5)).astype(int)
    counts = counts[host_rng(seed, "order").permutation(n)]
    rng = host_rng(seed, "words")
    ids = np.full((n, words[1] + 2), pad, np.int64)
    for i, c in enumerate(counts):
        ids[i, 0] = bos
        ids[i, 1:c + 1] = rng.integers(first_word, vocab, c)
        ids[i, c + 1] = eos
    return ids, counts + 2


# ------------------------------------------------------------ weights --

def _rule(module: nn.Module, leaf: str, shape) -> Tuple[float, float, float]:
    """(centre, half-width of a uniform part, std of a normal part) of one
    leaf: He-normal fan-out convolutions, torch-default uniform linears
    and GRUs, Xavier-uniform embeddings and attention projections, batch
    norms with non-identity statistics, identity layer norms."""
    if isinstance(module, (nn.Conv1d, nn.Conv2d)):
        if leaf == "weight":
            fan_out = module.out_channels * math.prod(module.kernel_size)
            return 0.0, 0.0, math.sqrt(2.0 / fan_out)
        return 0.0, 0.0, 0.0
    if isinstance(module, nn.Linear):
        return 0.0, 1.0 / math.sqrt(module.in_features), 0.0
    if isinstance(module, nn.Embedding):
        return 0.0, math.sqrt(6.0 / sum(shape)), 0.0
    if isinstance(module, nn.GRU):
        return 0.0, 1.0 / math.sqrt(module.hidden_size), 0.0
    if isinstance(module, nn.modules.batchnorm._BatchNorm):
        return {"weight": (1.0, 0.0, 0.2), "bias": (0.0, 0.0, 0.2),
                "running_mean": (0.0, 0.0, 0.1),
                "running_var": (1.0, 0.5, 0.0)}[leaf]
    if isinstance(module, nn.LayerNorm):
        return (1.0 if leaf == "weight" else 0.0), 0.0, 0.0
    if leaf == "in_proj_weight":
        return 0.0, math.sqrt(6.0 / (shape[0] + shape[1])), 0.0
    if leaf == "in_proj_bias":
        return 0.0, 0.0, 0.0
    raise ValueError(f"no weight rule for {type(module).__name__}.{leaf}")


@torch.no_grad()
def weights(model: nn.Module, seed: int, device,
            fixed: Dict[str, torch.Tensor], jitter: Dict[str, float]
            ) -> Dict[str, torch.Tensor]:
    """Every floating parameter and buffer of ``model`` (the benchmark's
    reference, built on the meta device: only its names and shapes are
    read) drawn from ``seed`` on ``device`` by :func:`_rule`, in one
    uniform and one normal draw.  ``fixed`` gives leaves their values
    (the positional table); ``jitter`` adds N(0, s^2) to every parameter
    under a name prefix (the decoder's, so that a random decoder's
    logits spread and do not tie).  Integer buffers are zero."""
    leaves: List[Tuple[str, nn.Module, str, torch.Size]] = []
    for mname, module in model.named_modules():
        for leaf, t in list(module.named_parameters(recurse=False)) + list(
                module.named_buffers(recurse=False)):
            name = f"{mname}.{leaf}" if mname else leaf
            leaves.append((name, module, leaf, t.shape, t.dtype))
    out: Dict[str, torch.Tensor] = {}
    todo = []
    for name, module, leaf, shape, dtype in leaves:
        if name in fixed:
            out[name] = fixed[name].to(device)
        elif not dtype.is_floating_point:
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            c, h, s = _rule(module, leaf, shape)
            is_param = leaf in dict(module.named_parameters(recurse=False))
            for prefix, std in jitter.items():
                if is_param and name.startswith(prefix):
                    s = math.hypot(s, std)
            todo.append((name, shape, c, h, s))
    total = sum(math.prod(shape) for _, shape, *_ in todo)
    gen = device_gen(seed, "weights", device)
    uni = torch.rand(total, generator=gen, device=device)
    nrm = torch.randn(total, generator=gen, device=device)
    at = 0
    for name, shape, c, h, s in todo:
        n = math.prod(shape)
        v = torch.full(shape, c, device=device)
        if h:
            v += h * (2.0 * uni[at:at + n].view(shape) - 1.0)
        if s:
            v += s * nrm[at:at + n].view(shape)
        out[name] = v
        at += n
    return out
