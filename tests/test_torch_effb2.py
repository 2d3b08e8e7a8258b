"""EfficientNet-B2 encoder of the PyTorch port against the JAX package on
weights carried across by the converter, with batch-norm statistics and
affine parameters jittered so they are not the identity (random-init
EffB2 otherwise collapses its output to ~0).  Tolerance on attn_emb and
fc_emb: rtol 1e-3, atol 1e-4 (float32 convolutions summed in another
order, compounded over 23 blocks)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocaption_tpu.models import effb2 as JE
from audiocaption_tpu_torch.models import effb2 as TE
from audiocaption_tpu_torch.models.convert import effb2_state_dict_from_jax

torch.set_num_threads(1)


def jitter_bn(params, stats, rng):
    """Random non-identity BN statistics and affine parameters, in place."""
    for k in stats:
        if "mean" in stats[k]:
            n = stats[k]["mean"].shape
            stats[k] = {"mean": (rng.randn(*n) * 0.1).astype(np.float32),
                        "var": (0.5 + rng.rand(*n)).astype(np.float32)}
            params[k] = {"scale": (1 + 0.2 * rng.randn(*n)).astype(np.float32),
                         "bias": (0.2 * rng.randn(*n)).astype(np.float32)}
        else:
            jitter_bn(params[k], stats[k], rng)


@pytest.fixture(scope="module")
def encoders():
    model = JE.EfficientNetB2()
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 101, 64)),
                   jnp.asarray([101]))
    v = jax.device_get(v)
    params, stats = dict(v["params"]), dict(v["batch_stats"])
    jitter_bn(params, stats, np.random.RandomState(4))
    enc = TE.EfficientNetB2().eval()
    enc.load_state_dict(effb2_state_dict_from_jax(params, stats))
    return model, {"params": params, "batch_stats": stats}, enc


def test_block_plan_and_padding_match_jax():
    assert TE.b2_block_plan() == [
        dict(a) for a in JE._b2_block_plan()]
    for size in (260, 130, 65, 33, 17, 9):
        for k, s in ((3, 1), (3, 2), (5, 1), (5, 2)):
            assert TE.tf_same_padding(size, k, s) == JE.tf_same_padding(
                size, k, s)


def test_module_names_follow_export(encoders):
    from audiocaption_tpu.models import export
    model, v, enc = encoders
    want = export.effb2_state_dict(v["params"], v["batch_stats"])
    assert set(enc.state_dict()) == set(want)


def test_encoder_matches_jax(encoders):
    model, v, enc = encoders
    rng = np.random.RandomState(2)
    lms = (rng.randn(2, 151, 64) * 10 - 40).astype(np.float32)
    feat_len = np.asarray([151, 100], np.int64)
    want = model.apply(v, jnp.asarray(lms), jnp.asarray(feat_len))
    with torch.no_grad():
        got = enc(torch.from_numpy(lms), torch.from_numpy(feat_len))
    assert got["attn_emb"].shape == (2, 5, 1408)       # ceil(151 / 32)
    np.testing.assert_array_equal(got["attn_emb_len"].numpy(),
                                  np.asarray(want["attn_emb_len"]))
    assert np.abs(np.asarray(want["attn_emb"])).max() > 0.1   # not collapsed
    for key in ("attn_emb", "fc_emb"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-3, atol=1e-4, err_msg=key)
