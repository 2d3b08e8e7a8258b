"""Pretrained word embeddings for decoders, and the word2vec trainer that
makes them (counterpart of ``audiocaption_tpu/utils/word_embedding.py``;
reference ``BaseDecoder.load_word_embedding``, models/__init__.py:82-92,
and python_scripts/utils/word2vec/create_word_embedding.py).

``load_word_embedding`` reads a [vocab, dim] ``.npy`` (PCA-reduced when
wider than the decoder), ``install_word_embedding`` writes it into a
port decoder's ``word_embedding.weight``, and ``train_word2vec`` trains
skip-gram with negative sampling by plain SGD on a device, in place of
the reference's gensim and of JAX's jitted step (``draw_negatives``
records a run's negative draws, to replay it on another device).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from audiocaption_tpu_torch.device import DeviceLike, resolve_device


def pca_reduce(embeddings: np.ndarray, dim: int) -> np.ndarray:
    """Project embeddings to ``dim`` by PCA (create_word_embedding.py)."""
    x = embeddings - embeddings.mean(0, keepdims=True)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return x @ vt[:dim].T


def load_word_embedding(path: str, vocab_size: int, emb_dim: int
                        ) -> np.ndarray:
    """A ``.npy`` embedding matrix [vocab_size, >= emb_dim] -> float32
    [vocab_size, emb_dim], PCA-reduced if wider."""
    emb = np.load(path)
    if emb.shape[0] != vocab_size:
        raise ValueError(f"embedding rows {emb.shape[0]} != vocab "
                         f"{vocab_size}")
    if emb.shape[1] > emb_dim:
        emb = pca_reduce(emb, emb_dim)
    elif emb.shape[1] < emb_dim:
        raise ValueError(f"embedding dim {emb.shape[1]} < {emb_dim}")
    return emb.astype(np.float32)


def install_word_embedding(decoder: torch.nn.Module, embedding: np.ndarray,
                           freeze: bool = False) -> torch.nn.Module:
    """Copy ``embedding`` [vocab, emb_dim] into ``decoder.word_embedding``
    (in place, on the module's device; the JAX function returns a param
    tree with ``word_embedding/embedding`` set).  ``freeze`` stops its
    gradient.  -> ``decoder``."""
    weight = decoder.word_embedding.weight
    emb = torch.as_tensor(np.asarray(embedding, np.float32))
    if tuple(emb.shape) != tuple(weight.shape):
        raise ValueError(f"embedding {tuple(emb.shape)} does not fit the "
                         f"decoder's word embedding {tuple(weight.shape)}")
    with torch.no_grad():
        weight.copy_(emb.to(weight.device, weight.dtype))
    weight.requires_grad_(not freeze)
    return decoder


def skipgram_pairs(sentences, window: int, word2idx: Dict[str, int]):
    """Every (center, context) id pair within ``window`` words, in the
    order of JAX's trainer -> (centers, contexts) int64 arrays."""
    centers, contexts = [], []
    for s in sentences:
        ids = [word2idx[w] for w in s if w in word2idx]
        for i, c in enumerate(ids):
            for j in range(max(0, i - window), min(len(ids), i + window + 1)):
                if j != i:
                    centers.append(c)
                    contexts.append(ids[j])
    return np.asarray(centers, np.int64), np.asarray(contexts, np.int64)


def _vocabulary(sentences, min_count: int):
    """(the words seen at least ``min_count`` times, in first-seen order;
    their counts)."""
    counter = Counter(w for s in sentences for w in s)
    return [w for w, c in counter.items() if c >= min_count], counter


def _negative_draws(probs: torch.Tensor, steps: int, batch_size: int,
                    negatives: int, seed: int):
    """The negatives of ``steps`` steps, [batch_size, negatives] ids each,
    drawn with replacement from ``probs`` by a generator on its device
    seeded with ``seed``."""
    gen = torch.Generator(device=probs.device).manual_seed(seed)
    for _ in range(steps):
        yield torch.multinomial(probs, batch_size * negatives,
                                replacement=True, generator=gen
                                ).view(batch_size, negatives)


def _unigram_probs(vocab, counter, device) -> torch.Tensor:
    freqs = np.asarray([counter[w] for w in vocab], np.float64) ** 0.75
    return torch.tensor(freqs / freqs.sum(), dtype=torch.float32,
                        device=device)


def draw_negatives(sentences, window: int = 5, epochs: int = 10,
                   negatives: int = 5, batch_size: int = 4096,
                   min_count: int = 1, seed: int = 0,
                   device: DeviceLike = "cuda") -> list:
    """The negative ids ``train_word2vec`` draws on ``device`` with these
    arguments, step by step ([batch_size, negatives] tensors): to replay
    a run elsewhere through its ``negative_ids``."""
    vocab, counter = _vocabulary(sentences, min_count)
    n = len(skipgram_pairs(sentences, window,
                           {w: i for i, w in enumerate(vocab)})[0])
    if not n:
        return []
    probs = _unigram_probs(vocab, counter, resolve_device(device))
    return list(_negative_draws(probs, epochs * -(-n // batch_size),
                                batch_size, negatives, seed))


def train_word2vec(sentences, embed_size: int, window: int = 5,
                   epochs: int = 10, negatives: int = 5,
                   lr: float = 0.025, min_count: int = 1,
                   batch_size: int = 4096, seed: int = 0,
                   device: DeviceLike = "cuda",
                   negative_ids: Optional[Sequence] = None
                   ) -> Dict[str, np.ndarray]:
    """Skip-gram with negative sampling by plain SGD (the JAX trainer's
    algorithm; the reference used gensim's Word2Vec with min_count 1 and
    10 epochs).  sentences: token lists -> {word: [embed_size] float32},
    the input vectors (gensim's ``wv``).

    From ``np.random.RandomState(seed)``, as in JAX: the input vectors
    (uniform in +-0.5 / embed_size; output vectors start at zero), each
    epoch's order of the (center, context) pairs, and the pairs that pad
    an epoch's last batch to ``batch_size``.  Negatives: ``negatives`` a
    pair, drawn with replacement from unigram^0.75 by a ``torch.Generator``
    on ``device`` seeded with ``seed`` (JAX draws from its own key, so the
    two differ; :func:`draw_negatives` gives this run's), or, where
    ``negative_ids`` is given, its step-th [batch, negatives] array at
    step s (another run's draws, JAX's in the parity tests).  The loss is
    the mean over the batch of -log sigmoid(c . o) - sum log sigmoid(-c .
    n); each step moves both tables by ``lr`` times its gradient."""
    dev = resolve_device(device)
    vocab, counter = _vocabulary(sentences, min_count)
    word2idx = {w: i for i, w in enumerate(vocab)}
    V = len(vocab)
    if V == 0:
        return {}
    rng = np.random.RandomState(seed)
    centers, contexts = skipgram_pairs(sentences, window, word2idx)
    if not len(centers):
        return {w: rng.randn(embed_size).astype(np.float32) for w in vocab}
    w_in = torch.tensor((rng.rand(V, embed_size) - 0.5) / embed_size,
                        dtype=torch.float32, device=dev)
    w_out = torch.zeros(V, embed_size, dtype=torch.float32, device=dev)
    centers_t = torch.from_numpy(centers).to(dev)
    contexts_t = torch.from_numpy(contexts).to(dev)
    n = len(centers)
    steps = epochs * -(-n // batch_size)
    draws = (iter(negative_ids) if negative_ids is not None else
             _negative_draws(_unigram_probs(vocab, counter, dev), steps,
                             batch_size, negatives, seed))
    for _ in range(epochs):
        order = rng.permutation(n)
        for s0 in range(0, n, batch_size):
            idx = order[s0:s0 + batch_size]
            if len(idx) < batch_size:
                idx = np.concatenate([idx, rng.choice(n, batch_size - len(idx))])
            idx_t = torch.from_numpy(idx).to(dev)
            d = next(draws)
            neg = (d if torch.is_tensor(d) else torch.from_numpy(
                np.array(d))).to(dev, torch.long)
            w_in, w_out = sgns_step(w_in, w_out, centers_t[idx_t],
                                    contexts_t[idx_t], neg, lr)
    w_in = w_in.cpu().numpy()
    return {w: w_in[i] for w, i in word2idx.items()}


def sgns_step(w_in: torch.Tensor, w_out: torch.Tensor, c_ids: torch.Tensor,
              o_ids: torch.Tensor, neg_ids: torch.Tensor, lr: float):
    """One SGD step of the skip-gram loss on a batch of (center, context)
    ids [B] and their negatives [B, N] -> the updated (w_in, w_out)."""
    w_in = w_in.detach().requires_grad_(True)
    w_out = w_out.detach().requires_grad_(True)
    vc, vo, vn = w_in[c_ids], w_out[o_ids], w_out[neg_ids]
    pos = F.logsigmoid((vc * vo).sum(-1))
    neg = F.logsigmoid(-torch.einsum("bd,bnd->bn", vc, vn)).sum(-1)
    loss = -(pos + neg).mean()
    g_in, g_out = torch.autograd.grad(loss, (w_in, w_out))
    with torch.no_grad():
        return w_in - lr * g_in, w_out - lr * g_out
