"""Word embeddings (``utils/word_embedding.py``) and
``cli/data_tools.py::create_word_embedding`` against the JAX package's, on
the CPU.

``train_word2vec`` runs in both packages from the same
``np.random.RandomState(seed)`` (initial vectors, the epochs' orders, the
padding of each epoch's last batch) and JAX's own negative draws, which
this test makes as JAX's jitted step does (``jax.random.split`` of
``PRNGKey(seed)`` a step, ``jax.random.choice`` with the unigram^0.75
probabilities) and hands to the port (``negative_ids``).  After four
epochs of 4 steps (the last of each padded) the vectors agree within
1e-5 of the largest |w|: both are float32 SGD on the same gradients,
summed in another order.  ``pca_reduce`` and ``load_word_embedding`` are
numpy in both packages and must be equal; the ``.npy`` of
``create_word_embedding`` from pretrained vectors is byte-equal, the one
from word2vec within the bound above."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocaption_tpu.cli import data_tools as JDT
from audiocaption_tpu.data.tokenizer import build_vocab as j_build_vocab
from audiocaption_tpu.utils import word_embedding as JWE

from audiocaption_tpu_torch.cli import data_tools as DT
from audiocaption_tpu_torch.models.transformer_decoder import (
    TransformerDecoder)
from audiocaption_tpu_torch.utils import word_embedding as WE

RTOL_OF_MAX = 1e-5
WORDS = ("dog bark loud water stream flow music soft play car engine rain "
         "wind bird sing door slam people talk crowd cheer").split()


def sentences(n: int = 40, seed: int = 5):
    rng = np.random.RandomState(seed)
    return [list(rng.choice(WORDS, rng.randint(3, 9))) for _ in range(n)]


def jax_negatives(sents, embed_size, window, epochs, negatives, batch_size,
                  seed, min_count=1):
    """The negative ids JAX's ``train_word2vec`` draws, step by step."""
    from collections import Counter
    counter = Counter(w for s in sents for w in s)
    vocab = [w for w, c in counter.items() if c >= min_count]
    word2idx = {w: i for i, w in enumerate(vocab)}
    n = len(WE.skipgram_pairs(sents, window, word2idx)[0])
    freqs = np.asarray([counter[w] for w in vocab], np.float64) ** 0.75
    probs = jnp.asarray(freqs / freqs.sum(), jnp.float32)
    draw = jax.jit(lambda k: jax.random.choice(
        k, len(vocab), (batch_size, negatives), p=probs))
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(epochs * -(-n // batch_size)):
        key, sub = jax.random.split(key)
        out.append(np.array(draw(sub)))
    return out


W2V = dict(embed_size=16, window=3, epochs=4, negatives=4, lr=0.5,
           batch_size=256, seed=2)


def test_train_word2vec_matches_jax_from_the_same_draws():
    sents = sentences()
    n_pairs = len(WE.skipgram_pairs(
        sents, W2V["window"], {w: i for i, w in enumerate(
            dict.fromkeys(w for s in sents for w in s))})[0])
    assert n_pairs % W2V["batch_size"] and n_pairs // W2V["batch_size"] == 3
    want = JWE.train_word2vec(sents, **W2V)
    neg = jax_negatives(sents, **{k: v for k, v in W2V.items()
                                  if k != "lr"})
    got = WE.train_word2vec(sents, **W2V, device="cpu", negative_ids=neg)
    assert list(got) == list(want)
    w_got = np.stack(list(got.values()))
    w_want = np.stack(list(want.values()))
    w0 = WE.train_word2vec(sents, **{**W2V, "epochs": 0}, device="cpu")
    # the vectors moved, and moved alike
    assert np.abs(w_want - np.stack(list(w0.values()))).max() > \
        100 * RTOL_OF_MAX * np.abs(w_want).max()
    np.testing.assert_allclose(w_got, w_want, rtol=0,
                               atol=RTOL_OF_MAX * np.abs(w_want).max())


def test_train_word2vec_draws_its_own_negatives_on_the_device():
    """Without ``negative_ids`` the draws come from the seeded generator:
    the same run twice gives the same vectors, another seed others."""
    sents = sentences(12)
    a = WE.train_word2vec(sents, 8, epochs=2, batch_size=32, device="cpu")
    b = WE.train_word2vec(sents, 8, epochs=2, batch_size=32, device="cpu")
    c = WE.train_word2vec(sents, 8, epochs=2, batch_size=32, seed=1,
                          device="cpu")
    assert all(np.array_equal(a[w], b[w]) for w in a)
    assert any(not np.array_equal(a[w], c[w]) for w in a)
    assert WE.train_word2vec([], 8, device="cpu") == {}


def test_pca_and_load_word_embedding_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    emb = rng.randn(30, 24).astype(np.float32)
    np.testing.assert_array_equal(WE.pca_reduce(emb, 8),
                                  JWE.pca_reduce(emb, 8))
    np.save(tmp_path / "e.npy", emb)
    for dim in (24, 10):
        np.testing.assert_array_equal(
            WE.load_word_embedding(str(tmp_path / "e.npy"), 30, dim),
            JWE.load_word_embedding(str(tmp_path / "e.npy"), 30, dim))
    for vocab, dim in ((29, 24), (30, 32)):
        with pytest.raises(ValueError):
            WE.load_word_embedding(str(tmp_path / "e.npy"), vocab, dim)


@pytest.mark.parametrize("freeze", [False, True])
def test_install_word_embedding_sets_the_decoder_table(freeze):
    dec = TransformerDecoder(emb_dim=16, vocab_size=30, attn_emb_dim=8,
                             nlayers=1)
    emb = np.random.RandomState(1).randn(30, 16).astype(np.float32)
    tree = JWE.install_word_embedding({"other": 1}, emb)
    assert WE.install_word_embedding(dec, emb, freeze=freeze) is dec
    np.testing.assert_array_equal(dec.word_embedding.weight.detach().numpy(),
                                  tree["word_embedding"]["embedding"])
    assert dec.word_embedding.weight.requires_grad is not freeze
    with pytest.raises(ValueError):
        WE.install_word_embedding(dec, emb[:, :8])


@pytest.fixture()
def vocab_corpus(tmp_path):
    sents = sentences()
    audios = [{"audio_id": f"a{i}", "captions": [
        {"caption": " ".join(s), "tokens": " ".join(s), "cap_id": "1"}]}
        for i, s in enumerate(sents)]
    (tmp_path / "text.json").write_text(json.dumps({"audios": audios}))
    j_build_vocab(str(tmp_path / "text.json"),
                  output_path=str(tmp_path / "vocab.pkl"))
    return tmp_path, sents


def test_create_word_embedding_from_pretrained_is_byte_equal(vocab_corpus):
    d, _ = vocab_corpus
    rng = np.random.RandomState(3)
    words = np.asarray(WORDS[:15] + ["absent"])
    np.savez(d / "pre.npz", words=words,
             vectors=rng.randn(len(words), 40).astype(np.float32))
    for mod, name in ((JDT, "j.npy"), (DT, "p.npy")):
        mod.create_word_embedding(str(d / "vocab.pkl"), 8, str(d / name),
                                  pretrained_weights_path=str(d / "pre.npz"))
    assert (d / "j.npy").read_bytes() == (d / "p.npy").read_bytes()


def test_create_word_embedding_by_word2vec_matches_jax(vocab_corpus):
    d, sents = vocab_corpus
    kw = dict(window=3, epochs=3, negatives=4, lr=0.5, seed=2)
    JDT.create_word_embedding(str(d / "vocab.pkl"), 16, str(d / "j.npy"),
                              caption_file=str(d / "text.json"), **kw)
    neg = jax_negatives(sents, 16, kw["window"], kw["epochs"],
                        kw["negatives"], 4096, kw["seed"])
    DT.create_word_embedding(str(d / "vocab.pkl"), 16, str(d / "p.npy"),
                             caption_file=str(d / "text.json"), **kw,
                             device="cpu", negative_ids=neg)
    want, got = np.load(d / "j.npy"), np.load(d / "p.npy")
    assert got.shape == want.shape == (4 + len(set(WORDS)), 16)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL_OF_MAX * np.abs(want).max())
