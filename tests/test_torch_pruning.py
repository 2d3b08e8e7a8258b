"""Structured pruning of the PyTorch port (``utils/pruning.py``,
``models/effb2.py::build_pruned_effb2``) against the JAX package's, on
weights carried across by the converter: rankings and keep sets equal
index for index, the pruned plans and tensors equal, and the pruned
encoder's output within 1e-4 of JAX ``PrunedEfficientNetB2`` (float32
convolutions summed in another order over 23 blocks).  BN statistics are
jittered so the encoders do not collapse their output."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocaption_tpu.models import effb2 as JE
from audiocaption_tpu.utils import pruning as JP
from audiocaption_tpu_torch.models import effb2 as TE
from audiocaption_tpu_torch.models.convert import effb2_state_dict_from_jax
from audiocaption_tpu_torch.ops import fused_mbconv as FM
from audiocaption_tpu_torch.utils import pruning as TP

torch.set_num_threads(1)
METHODS = ("operator_norm", "iclr_l1", "iclr_gm")


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
def full():
    """JAX EfficientNetB2 variables (jittered BN) and the port encoder
    loaded from them."""
    v = jax.device_get(JE.EfficientNetB2().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 101, 64)), jnp.asarray([101])))
    params, stats = dict(v["params"]), dict(v["batch_stats"])
    jitter_bn(params, stats, np.random.RandomState(5))
    enc = TE.EfficientNetB2().eval()
    enc.load_state_dict(effb2_state_dict_from_jax(params, stats))
    return params, stats, enc


@pytest.mark.parametrize("shape", [(3, 3, 4, 8), (1, 1, 16, 24),
                                   (5, 5, 1, 12)])
def test_rankings_and_keep_sets_match_jax(shape):
    rng = np.random.RandomState(sum(shape))
    kernel = rng.randn(*shape).astype(np.float32)
    for fn in ("operator_norm_ranking", "l1_ranking",
               "geometric_median_ranking"):
        np.testing.assert_array_equal(getattr(TP, fn)(kernel),
                                      getattr(JP, fn)(kernel), err_msg=fn)
    for method in METHODS:
        for ratio in (0.3, 0.5, 0.9):
            np.testing.assert_array_equal(
                TP.select_filters(kernel, ratio, method),
                JP.select_filters(kernel, ratio, method))
    keep = TP.select_filters(kernel, 0.5)
    nxt = {"kernel": rng.randn(1, 1, shape[-1], 6).astype(np.float32)}
    got = TP.prune_conv_params({"kernel": kernel}, keep, nxt)
    want = JP.prune_conv_params({"kernel": kernel}, keep, nxt)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["kernel"], w["kernel"])
    bn_p = {"scale": rng.rand(shape[-1]), "bias": rng.rand(shape[-1])}
    bn_s = {"mean": rng.rand(shape[-1]), "var": rng.rand(shape[-1])}
    for g, w in zip(TP.prune_bn_params(bn_p, bn_s, keep),
                    JP.prune_bn_params(bn_p, bn_s, keep)):
        for key in w:
            np.testing.assert_array_equal(g[key], w[key])


PRUNE_CASES = [
    dict(prune_ratio=0.3, prune_start_layer=5, prune_head=False),
    dict(prune_ratio=0.5, prune_start_layer=5, prune_head=False),
    dict(prune_ratio=0.3, prune_start_layer=0, prune_se=False,
         method="iclr_l1", prune_head=True),
]


@pytest.mark.parametrize("kwargs", PRUNE_CASES,
                         ids=["r03_start5", "r05_start5", "r03_l1_head"])
def test_build_pruned_effb2_matches_jax(full, kwargs):
    params, stats, enc = full
    jm, jp, js = JE.build_pruned_effb2(params, stats, **kwargs)
    got = TE.build_pruned_effb2(enc, **kwargs)
    assert isinstance(got, TE.PrunedEfficientNetB2)
    assert [dict(a) for a in got.block_plan] == [dict(a)
                                                 for a in jm.block_plan]
    assert got.fc_emb_size == jm.head_filters
    if not kwargs["prune_head"]:
        assert got.fc_emb_size == 1408
    want = effb2_state_dict_from_jax(jp, js)
    have = got.state_dict()
    assert set(have) == set(want)
    for key, w in want.items():
        assert torch.equal(have[key], w), key


def test_pruned_encoder_matches_jax(full):
    """The pruned encoder on the converted pruned JAX tree, and its folded
    walk (``folded_blocks``), against JAX ``PrunedEfficientNetB2``."""
    params, stats, enc = full
    jm, jp, js = JE.build_pruned_effb2(params, stats, prune_ratio=0.3,
                                       prune_head=False)
    pruned = TE.PrunedEfficientNetB2(jm.stem_filters, jm.head_filters,
                                     jm.block_plan).eval()
    pruned.load_state_dict(effb2_state_dict_from_jax(jp, js))
    rng = np.random.RandomState(6)
    lms = (rng.randn(2, 101, 64) * 10 - 40).astype(np.float32)
    feat_len = np.asarray([101, 64], np.int64)
    want = jm.apply({"params": jp, "batch_stats": js}, jnp.asarray(lms),
                    jnp.asarray(feat_len))
    assert np.abs(np.asarray(want["attn_emb"])).max() > 0.1   # not collapsed
    with torch.no_grad():
        args = (torch.from_numpy(lms), torch.from_numpy(feat_len))
        outs = {"modules": pruned(*args),
                "folded": pruned(*args, blocks=FM.folded_blocks(pruned))}
    for how, got in outs.items():
        for key in ("attn_emb", "fc_emb"):
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), atol=1e-4,
                                       err_msg=f"{how} {key}")


def test_folded_encoder_matches_jax(full):
    """The flagship encoder walked block by block on folded weights
    (stride-1 blocks through ``fused_mbconv_s1``, here its plain version)
    against the JAX encoder."""
    params, stats, enc = full
    rng = np.random.RandomState(7)
    lms = (rng.randn(2, 101, 64) * 10 - 40).astype(np.float32)
    feat_len = np.asarray([101, 77], np.int64)
    want = JE.EfficientNetB2().apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(lms),
        jnp.asarray(feat_len))
    with torch.no_grad():
        got = enc(torch.from_numpy(lms), torch.from_numpy(feat_len),
                  blocks=FM.folded_blocks(enc))
    for key in ("attn_emb", "fc_emb"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4, err_msg=key)
