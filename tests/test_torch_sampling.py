"""The port's sampling decode against the JAX package's
(``decoding/engine.py``: ``sample_next_word``, ``_top_p_logprob``,
``stepwise_decode`` with a method and a temperature).

Both packages pick a sampled word as ``argmax(lp + g)`` (Gumbel noise
``g``; for "gumbel", a perturbation built from uniforms ``u``), so the
port is fed JAX's own draws: ``jax.random.gumbel(key, shape)`` or
``jax.random.uniform(key, shape)`` of the same key that the JAX call
uses, and for a whole decode the draws of JAX's per-step ``split`` chain.
Limits: words equal, ``sampled_logprob`` within 1e-5; top-p kept sets
equal (ties included).  The whole-loop decodes run the flagship's
decoder at a narrow width (emb 64, vocab 50, tied, its weight matrices
jittered by 0.4 as ``test_hf_checkpoint_io.py`` jitters them) on seeded
random encoder memory; sequences must be equal and ``sampled_logprob``
within 1e-4 (the decoders' own float32 difference over 12 steps, ~1e-5
on log-probabilities of magnitude up to ~7, as ``test_torch_decoder.py``
holds the decoder's logits to 1e-4)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocaption_tpu.decoding.engine import (
    _top_p_logprob as j_top_p, sample_next_word as j_sample)
from audiocaption_tpu.models.captioner import (
    Captioner as JCaptioner, generate as j_generate)
from audiocaption_tpu.models.effb2 import EfficientNetB2 as JEfficientNetB2
from audiocaption_tpu.models.transformer_decoder import (
    TransformerDecoder as JTransformerDecoder, convert_transformer_decoder)
from audiocaption_tpu.ops.frontend import EFFB2_MEL_16K as J_MEL

from audiocaption_tpu_torch.decoding.engine import (
    _top_p_logprob, sample_next_word)
from audiocaption_tpu_torch.models.captioner import Captioner, generate
from audiocaption_tpu_torch.models.transformer_decoder import (
    TransformerDecoder)
from audiocaption_tpu_torch.models.zoo import random_init
from audiocaption_tpu_torch.ops.frontend import EFFB2_MEL_16K

V, EMB, MEM, B, S, L = 50, 64, 1408, 4, 7, 12
METHODS = ("greedy", "gumbel", "sample", "top1", "top3", "top0.3",
           "top0.9")


def jax_draw(method: str, key, shape):
    if method == "greedy":
        return None
    if method == "gumbel":
        return jax.random.uniform(key, shape)
    return jax.random.gumbel(key, shape)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


@pytest.mark.parametrize("temp", [1.0, 0.7])
@pytest.mark.parametrize("method", METHODS)
def test_sample_next_word_matches_jax(method, temp):
    rng = np.random.RandomState(3)
    logit = (rng.randn(8, V) * 3).astype(np.float32)
    key = jax.random.PRNGKey(11)
    w_want, lp_want = j_sample(jnp.asarray(logit), method, temp, key)
    w, lp = sample_next_word(torch.from_numpy(logit), method, temp,
                             noise=_t(jax_draw(method, key, logit.shape)))
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_want))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("p", [0.3, 0.9])
def test_top_p_kept_set_matches_jax(p):
    """Kept sets equal, with ties planted at the boundary of the set."""
    rng = np.random.RandomState(5)
    logit = (rng.randn(6, V) * 2).astype(np.float32)
    logit[:, 10:14] = logit[:, 3:4]           # a four-way tie per row
    logit[1] = 0.0                            # every word tied
    want = np.asarray(j_top_p(jnp.asarray(logit), p))
    got = _top_p_logprob(torch.from_numpy(logit), p).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got[np.isfinite(got)],
                               want[np.isfinite(want)], rtol=0, atol=1e-5)
    assert (np.isfinite(got).sum(-1) >= 1).all()


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="sample_method"):
        sample_next_word(torch.zeros(2, V), "nucleus", 1.0)
    with pytest.raises(ValueError, match="sample_method"):
        sample_next_word(torch.zeros(2, V), "top0", 1.0)


@pytest.fixture(scope="module")
def decoders():
    return make_decoders(0.4)


def make_decoders(jitter: float):
    """The narrow flagship decoder in both packages on the same weights,
    its matrices jittered by ``jitter``, the JAX one under a ``Captioner``
    whose encoder never runs (the memory comes in as ``enc_override``),
    and seeded memory."""
    dec = TransformerDecoder(EMB, V, MEM, tie_weights=True, dropout=0.0)
    random_init(dec, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    with torch.no_grad():
        for prm in dec.parameters():
            if prm.dim() == 2:
                prm.add_(torch.from_numpy(
                    (rng.randn(*prm.shape) * jitter).astype(np.float32)))
    port = Captioner(torch.nn.Identity(), dec, EFFB2_MEL_16K).eval()
    sd = {k: v.numpy().copy() for k, v in dec.state_dict().items()}
    jmodel = JCaptioner(encoder=JEfficientNetB2(),
                        decoder=JTransformerDecoder(
                            emb_dim=EMB, vocab_size=V, attn_emb_dim=MEM,
                            dropout=0.0, nlayers=2, tie_weights=True),
                        mel=J_MEL)
    jvars = {"params": {"decoder": convert_transformer_decoder(
        sd, nlayers=2, tie_weights=True)}}
    attn = (rng.randn(B, S, MEM)).astype(np.float32)
    lens = np.asarray([S, 5, 3, 6], np.int32)
    enc = {"attn_emb": attn, "attn_emb_len": lens}
    return port, jmodel, jvars, enc


def port_enc(enc):
    return {"attn_emb": torch.from_numpy(enc["attn_emb"]),
            "attn_emb_len": torch.from_numpy(enc["attn_emb_len"]).long()}


def jax_chain_noise(method: str, key, shape):
    """``noise(t, shape)`` replaying the JAX loop's draws: step t uses
    the second half of the t-th ``split`` of ``key``."""
    draws, k = [], key
    for _ in range(L):
        k, sub = jax.random.split(k)
        draws.append(_t(jax_draw(method, sub, shape)))
    return lambda t, shp: draws[t]


@pytest.mark.parametrize("method,temp", [("sample", 1.0), ("sample", 0.8),
                                         ("top3", 1.0), ("top0.5", 1.0),
                                         ("gumbel", 1.0), ("greedy", 1.0)])
def test_whole_loop_sampled_decode_matches_jax(decoders, method, temp):
    port, jmodel, jvars, enc = decoders
    key = jax.random.PRNGKey(7)
    jenc = {k: jnp.asarray(v) for k, v in enc.items()}
    want = j_generate(jmodel, jvars, sample_method=method, temp=temp,
                      max_length=L, key=key, enc_override=jenc)
    got = generate(port, enc=port_enc(enc), sample_method=method, temp=temp,
                   max_length=L,
                   noise=jax_chain_noise(method, key, (B, V)))
    seq = np.asarray(want["seq"])
    np.testing.assert_array_equal(got["seq"].numpy(), seq)
    np.testing.assert_allclose(got["sampled_logprob"].numpy(),
                               np.asarray(want["sampled_logprob"]), rtol=0,
                               atol=1e-4)
    if method != "greedy":      # the draws do steer the words
        assert len(np.unique(seq)) > 3


def test_default_generator_repeats(decoders):
    """Without a generator each call draws from a fresh one seeded with
    0: two calls give the same tokens, a seeded generator others."""
    port = decoders[0]
    enc = port_enc(decoders[3])
    a = generate(port, enc=enc, sample_method="sample", max_length=L)["seq"]
    b = generate(port, enc=enc, sample_method="sample", max_length=L)["seq"]
    assert torch.equal(a, b)
    c = generate(port, enc=enc, sample_method="sample", max_length=L,
                 generator=torch.Generator().manual_seed(123))["seq"]
    assert not torch.equal(a, c)
    with pytest.raises(ValueError, match="sample_method"):
        generate(port, enc=enc, sample_method="topx", max_length=L)
