"""The port's temporal Bahdanau-attention GRU decoder against the JAX
package, step by step, on weights carried across by the JAX exporter:
emb 16, d_model 16, vocab 48, memory width 24, one row per temporal tag
(0-3) and ragged memory lengths.  Step logits atol 1e-5 and the dynamic
caches (GRU state, attention weights) atol 1e-6 (float32 sums in another
order; the port applies the encoder half of ``h2attn`` once per decode)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocaption_tpu.models import export
from audiocaption_tpu.models import rnn_decoder as JD
from audiocaption_tpu_torch.models import rnn_decoder as TD

torch.set_num_threads(1)

DIMS = dict(emb_dim=16, vocab_size=48, fc_emb_dim=24, attn_emb_dim=24,
            d_model=16)
B, S, STEPS = 4, 7, 6


def _init_all(mdl, attn, lens, fc, tag, word):
    static, dyn = mdl.init_cache(attn, lens, fc, STEPS, temporal_tag=tag)
    return mdl.step(word, jnp.int32(0), static, dyn)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.RandomState(0)
    inputs = dict(attn=rng.randn(B, S, 24).astype(np.float32),
                  lens=np.asarray([S, 3, 1, 5]),
                  fc=rng.randn(B, 24).astype(np.float32),
                  tag=np.arange(4),
                  words=rng.randint(3, 48, (STEPS, B)))
    jdec = JD.TemporalBahAttnDecoder(**DIMS)
    v = jax.device_get(jdec.init(
        jax.random.PRNGKey(1), jnp.asarray(inputs["attn"]),
        jnp.asarray(inputs["lens"]), jnp.asarray(inputs["fc"]),
        jnp.asarray(inputs["tag"]), jnp.asarray(inputs["words"][0]),
        method=_init_all))
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.randn(*np.shape(x)).astype(np.float32)
        * 0.3, v["params"])
    tdec = TD.TemporalBahAttnDecoder(**DIMS).eval()
    tdec.load_state_dict({k: torch.from_numpy(np.array(x)) for k, x in
                          export.bahattn_decoder_state_dict(
                              params, temporal=True).items()})
    return jdec, {"params": params}, tdec, inputs


def test_module_names_follow_export(pair):
    jdec, v, tdec, _ = pair
    assert set(tdec.state_dict()) == set(
        export.bahattn_decoder_state_dict(v["params"], temporal=True))


@pytest.mark.parametrize("with_tag", [True, False], ids=["tags", "no_tag"])
def test_steps_match_jax(pair, with_tag):
    jdec, v, tdec, x = pair
    j_tag = jnp.asarray(x["tag"]) if with_tag else None
    t_tag = torch.from_numpy(x["tag"]) if with_tag else None
    jstatic, jdyn = jdec.apply(v, jnp.asarray(x["attn"]),
                               jnp.asarray(x["lens"]), jnp.asarray(x["fc"]),
                               STEPS, temporal_tag=j_tag,
                               method=JD.TemporalBahAttnDecoder.init_cache)
    with torch.no_grad():
        tstatic, tdyn = tdec.init_cache(
            torch.from_numpy(x["attn"]), torch.from_numpy(x["lens"]),
            torch.from_numpy(x["fc"]), STEPS, temporal_tag=t_tag)
    logits = []
    for t in range(STEPS):
        jlogit, jdyn = jdec.apply(v, jnp.asarray(x["words"][t]), jnp.int32(t),
                                  jstatic, jdyn,
                                  method=JD.TemporalBahAttnDecoder.step)
        with torch.no_grad():
            tlogit, tdyn = tdec.step(torch.from_numpy(x["words"][t]), t,
                                     tstatic, tdyn)
        np.testing.assert_allclose(tlogit.numpy(), np.asarray(jlogit),
                                   atol=1e-5, rtol=0, err_msg=f"step {t}")
        for key in ("state", "attn_weight"):
            assert tuple(tdyn[key].shape) == jdyn[key].shape
            np.testing.assert_allclose(tdyn[key].numpy(),
                                       np.asarray(jdyn[key]), atol=1e-6,
                                       rtol=0, err_msg=f"{key} step {t}")
        logits.append(tlogit.numpy())
    # padded memory gets no weight; the first step differs by tag
    assert not tdyn["attn_weight"][2, 1:].any()
    if with_tag:
        assert len({tuple(np.round(r, 4)) for r in logits[0]}) == B
