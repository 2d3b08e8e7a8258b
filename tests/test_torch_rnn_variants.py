"""Every GRU decoder of the port (``models/rnn_decoder.py``) against the
JAX package's, at one and two GRU layers, on weights carried across by
``models.convert.jax_tree_state_dict`` (flax init, every parameter
jittered by 0.3 from a numpy seed): emb 16, d_model 16, vocab 48, memory
width 24, fc width 20, 4 rows with ragged memory lengths, each
conditioned decoder with its condition keyword (``temporal_tag``,
``condition``, ``style``, ``structure``).

  * the parameter counts and names: the converted tree fills the port
    decoder exactly (strict load);
  * ``init_cache`` + 6 ``step``s: logits within 1e-5 (absolute), the
    dynamic cache (every layer's state, [N, L, H], and the attention
    weights) within 1e-5 (float32 sums in another order: the port applies
    the encoder half of ``h2attn`` once per decode);
  * greedy and beam-3 decoding through each package's ``generate``
    (the port's torch engine, the JAX engine) from the same encoder
    outputs: tokens equal, beam scores within 1e-5;
  * without its condition a conditioned decoder decodes as with the
    JAX default (0, zeros or fc_proj)."""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from audiocaption_tpu.models import rnn_decoder as JD
from audiocaption_tpu.models.captioner import (
    Captioner as JCaptioner, generate as j_generate)
from audiocaption_tpu.ops.frontend import CNN14_MEL_32K as J_MEL

from audiocaption_tpu_torch.models import rnn_decoder as TD
from audiocaption_tpu_torch.models.captioner import Captioner, generate
from audiocaption_tpu_torch.models.convert import jax_tree_state_dict
from audiocaption_tpu_torch.ops.frontend import CNN14_MEL_32K

torch.set_num_threads(1)

DIMS = dict(emb_dim=16, vocab_size=48, fc_emb_dim=20, attn_emb_dim=24,
            d_model=16)
B, S, STEPS, L_DEC = 4, 7, 6, 8
VARIANTS = ["BahAttnCatFcDecoder", "TemporalBahAttnDecoder",
            "BahAttnAddFcDecoder", "BahAttnDecoder",
            "ConditionalBahAttnDecoder", "StyleBahAttnDecoder",
            "SpecificityBahAttnDecoder", "StructBahAttnDecoder",
            "RnnFcDecoder"]


def conditions(name: str, rng) -> dict:
    """The variant's condition keyword as numpy, or {}."""
    if name == "TemporalBahAttnDecoder":
        return {"temporal_tag": np.arange(B) % 4}
    if name in ("ConditionalBahAttnDecoder", "SpecificityBahAttnDecoder"):
        return {"condition": rng.rand(B).astype(np.float32) * 2}
    if name == "StyleBahAttnDecoder":
        return {"style": rng.randn(B, DIMS["emb_dim"]).astype(np.float32)}
    if name == "StructBahAttnDecoder":
        return {"structure": np.asarray([3, 1, 0, 2])}
    return {}


def _init_all(mdl, attn, lens, fc, word, **cond):
    static, dyn = mdl.init_cache(attn, lens, fc, STEPS, **cond)
    return mdl.step(word, jnp.int32(0), static, dyn)


def inputs(seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    return dict(attn=rng.randn(B, S, 24).astype(np.float32),
                lens=np.asarray([S, 3, 1, 5]),
                fc=rng.randn(B, 20).astype(np.float32),
                words=rng.randint(3, 48, (STEPS, B)))


def make_pair(name: str, num_layers: int, seed: int = 0):
    """-> (JAX decoder, its variables, the port decoder, the condition as
    numpy)."""
    x = inputs(seed)
    rng = np.random.RandomState(seed + 1)
    cond = conditions(name, rng)
    jdec = getattr(JD, name)(num_layers=num_layers, **DIMS)
    v = jax.device_get(jdec.init(
        jax.random.PRNGKey(seed), jnp.asarray(x["attn"]),
        jnp.asarray(x["lens"]), jnp.asarray(x["fc"]),
        jnp.asarray(x["words"][0]), method=_init_all,
        **{k: jnp.asarray(c) for k, c in cond.items()}))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.randn(*np.shape(a)).astype(np.float32)
        * 0.3, v["params"])
    tdec = getattr(TD, name)(num_layers=num_layers, **DIMS).eval()
    tdec.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in
                          jax_tree_state_dict(params).items()})
    return jdec, {"params": params}, tdec, cond


CASES = [(n, nl) for n in VARIANTS for nl in (1, 2)]
CASE_IDS = [f"{n}-L{nl}" for n, nl in CASES]


@pytest.mark.parametrize("name,num_layers", CASES, ids=CASE_IDS)
def test_steps_match_jax(name, num_layers):
    jdec, v, tdec, cond = make_pair(name, num_layers)
    x = inputs()
    n_jax = sum(np.size(a) for a in jax.tree_util.tree_leaves(v["params"]))
    assert n_jax == sum(p.numel() for p in tdec.parameters())
    jcond = {k: jnp.asarray(c) for k, c in cond.items()}
    tcond = {k: torch.from_numpy(c) for k, c in cond.items()}
    jstatic, jdyn = jdec.apply(v, jnp.asarray(x["attn"]),
                               jnp.asarray(x["lens"]), jnp.asarray(x["fc"]),
                               STEPS, method=type(jdec).init_cache, **jcond)
    with torch.no_grad():
        tstatic, tdyn = tdec.init_cache(
            torch.from_numpy(x["attn"]), torch.from_numpy(x["lens"]),
            torch.from_numpy(x["fc"]), STEPS, **tcond)
    for t in range(STEPS):
        jlogit, jdyn = jdec.apply(v, jnp.asarray(x["words"][t]), jnp.int32(t),
                                  jstatic, jdyn, method=type(jdec).step)
        with torch.no_grad():
            tlogit, tdyn = tdec.step(torch.from_numpy(x["words"][t]), t,
                                     tstatic, tdyn)
        np.testing.assert_allclose(tlogit.numpy(), np.asarray(jlogit),
                                   atol=1e-5, rtol=0, err_msg=f"step {t}")
        assert set(tdyn) == set(jdyn)
        for key in jdyn:
            assert tuple(tdyn[key].shape) == jdyn[key].shape, key
            np.testing.assert_allclose(tdyn[key].numpy(),
                                       np.asarray(jdyn[key]), atol=1e-5,
                                       rtol=0, err_msg=f"{key} step {t}")
    assert tdyn["state"].shape == (B, num_layers, DIMS["d_model"])


def _decode(jdec, v, tdec, cond, method):
    x = inputs(3)
    enc = {"attn_emb": x["attn"], "attn_emb_len": x["lens"],
           "fc_emb": x["fc"]}
    jmodel = JCaptioner(encoder=nn.Identity, decoder=jdec, mel=J_MEL)
    want = jax.device_get(j_generate(
        jmodel, {"params": {"decoder": v["params"]}},
        enc_override={k: jnp.asarray(a) for k, a in enc.items()},
        max_length=L_DEC, cond_kwargs={k: jnp.asarray(c)
                                       for k, c in cond.items()}, **method))
    tmodel = Captioner(nn.Identity(), tdec, CNN14_MEL_32K).eval()
    got = generate(tmodel, enc={k: torch.from_numpy(a)
                                for k, a in enc.items()},
                   max_length=L_DEC, cond_kwargs={
                       k: torch.from_numpy(c) for k, c in cond.items()},
                   **method)
    return got, want


METHODS = [dict(sample_method="greedy"),
           dict(sample_method="beam", beam_size=3)]


@pytest.mark.parametrize("name,num_layers", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("method", METHODS, ids=["greedy", "beam3"])
def test_decode_matches_jax(name, num_layers, method):
    jdec, v, tdec, cond = make_pair(name, num_layers, seed=5)
    got, want = _decode(jdec, v, tdec, cond, method)
    np.testing.assert_array_equal(got["seq"].numpy(), np.asarray(want["seq"]))
    assert len(np.unique(want["seq"])) > 2
    if "score" in want:
        np.testing.assert_allclose(got["score"].numpy(),
                                   np.asarray(want["score"]), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("name", [n for n in VARIANTS
                                  if conditions(n, np.random) != {}])
def test_missing_condition_is_the_jax_default(name):
    jdec, v, tdec, _ = make_pair(name, 2, seed=9)
    got, want = _decode(jdec, v, tdec, {}, METHODS[1])
    np.testing.assert_array_equal(got["seq"].numpy(), np.asarray(want["seq"]))
