"""Layers, Cnn14 and the Cnn14-BiGRU encoder of the PyTorch port against
the JAX package on the same numpy inputs and weights carried across by
the JAX package's exporter (``models/export.py``).

Tolerances: pooling and masking rtol 1e-6 / atol 1e-6 (the same float32
arithmetic); BatchNorm rtol 1e-5 (the normalisation is composed in
another order, on outputs up to ~1e2); ConvBlock and the GRU rtol/atol
1e-5 (float32 sums in another order); Cnn14 and Cnn14RnnEncoder rtol/atol 1e-4 (six
conv blocks and three GRU layers of such sums).  The encoders' batch-norm
statistics are jittered away from the identity so the output does not
collapse."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocaption_tpu.models import export
from audiocaption_tpu.models import layers as JL
from audiocaption_tpu.ops import masking as JM
from audiocaption_tpu_torch.models import layers as TL
from audiocaption_tpu_torch.models.cnn14 import Cnn14Encoder
from audiocaption_tpu_torch.models.rnn_encoder import Cnn14RnnEncoder
from audiocaption_tpu_torch.ops import masking as TM

from test_torch_effb2 import jitter_bn

torch.set_num_threads(1)


def _load(module, sd):
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in sd.items()})
    return module.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(x):
    return x.permute(0, 2, 3, 1).detach().numpy()


def test_batchnorm_eps_and_statistics_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 7, 8).astype(np.float32)
    p = {"scale": rng.rand(8).astype(np.float32) + 0.5,
         "bias": rng.randn(8).astype(np.float32)}
    s = {"mean": rng.randn(8).astype(np.float32),
         "var": rng.rand(8).astype(np.float32) * 1e-4}   # eps matters here
    want = JL.BatchNorm().apply({"params": p, "batch_stats": s},
                                jnp.asarray(x))
    bn = torch.nn.BatchNorm2d(8)
    out = {}
    export.batchnorm(p, s, "bn", out)
    _load(bn, {k[3:]: v for k, v in out.items()})
    with torch.no_grad():
        got = _nhwc(bn(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


def test_conv_block_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, 11, 3).astype(np.float32)
    block = JL.ConvBlock(8)
    v = jax.device_get(block.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params, stats = dict(v["params"]), dict(v["batch_stats"])
    jitter_bn(params, stats, rng)
    want = block.apply({"params": params, "batch_stats": stats},
                       jnp.asarray(x))
    out = {}
    export.conv_block(params, stats, "b", out)
    tb = _load(TL.ConvBlock(3, 8), {k[2:]: v for k, v in out.items()})
    with torch.no_grad():
        got = _nhwc(tb(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [(2, 2), (1, 2), (1, 1)])
@pytest.mark.parametrize("pool_type", ["avg", "max", "avg+max"])
def test_pool_2d_matches_jax(window, pool_type):
    x = np.random.RandomState(2).randn(2, 9, 7, 8).astype(np.float32)
    want = JL.pool_2d(jnp.asarray(x), window, pool_type)     # odd sizes
    got = _nhwc(TL.pool_2d(_nchw(x), window, pool_type))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)


def test_max_with_lens_matches_jax():
    feats = np.random.RandomState(3).randn(3, 7, 5).astype(np.float32)
    lens = np.asarray([7, 3, 1])
    np.testing.assert_array_equal(
        TM.max_with_lens(torch.from_numpy(feats),
                         torch.from_numpy(lens)).numpy(),
        np.asarray(JM.max_with_lens(jnp.asarray(feats), jnp.asarray(lens))))


def test_zero_length_behaviour_matches_jax():
    """Length 0: the masked max is -inf and the masked mean is NaN (0/0),
    in both packages; callers keep lengths >= 1."""
    feats = np.ones((1, 4, 2), np.float32)
    lens = np.asarray([0])
    got_max = TM.max_with_lens(torch.from_numpy(feats), torch.from_numpy(lens))
    got_mean = TM.mean_with_lens(torch.from_numpy(feats),
                                 torch.from_numpy(lens))
    assert np.isneginf(got_max.numpy()).all()
    assert np.isneginf(np.asarray(JM.max_with_lens(jnp.asarray(feats),
                                                   jnp.asarray(lens)))).all()
    assert np.isnan(got_mean.numpy()).all()
    assert np.isnan(np.asarray(JM.mean_with_lens(jnp.asarray(feats),
                                                 jnp.asarray(lens)))).all()


@pytest.mark.parametrize("lens", [[9, 1, 5, 9], [9, 1, 0, 4]],
                         ids=["ragged", "with_zero"])
def test_gru_pack_padded_semantics_match_jax(lens):
    rng = np.random.RandomState(4)
    x = rng.randn(4, 9, 6).astype(np.float32)
    lens = np.asarray(lens)
    gru = JL.GRU(hidden_size=16, num_layers=2, bidirectional=True)
    v = jax.device_get(gru.init(jax.random.PRNGKey(1), jnp.asarray(x),
                                jnp.asarray(lens)))
    want, _ = gru.apply(v, jnp.asarray(x), jnp.asarray(lens))
    out = {}
    export.gru(v["params"], "g", 2, True, out)
    tg = _load(TL.GRU(6, 16, num_layers=2, bidirectional=True),
               {k[2:]: val for k, val in out.items()})
    with torch.no_grad():
        got = tg(torch.from_numpy(x), torch.from_numpy(lens)).numpy()
    assert got.shape == (4, 9, 32)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    for b, n in enumerate(lens):
        assert not got[b, n:].any()             # zero past each length


@pytest.fixture(scope="module")
def lms_input():
    rng = np.random.RandomState(5)
    lms = (rng.randn(2, 101, 64) * 10 - 40).astype(np.float32)   # 2 x 1 s
    return lms, np.asarray([101, 64], np.int64)


@pytest.fixture(scope="module")
def cnn14_rnn_vars(lms_input):
    """One JAX Cnn14RnnEncoder init (its "cnn" subtree serves the Cnn14
    test), batch-norm statistics jittered."""
    from audiocaption_tpu.models.rnn_encoder import (
        Cnn14RnnEncoder as JEncoder)
    lms, feat_len = lms_input
    model = JEncoder()
    v = jax.device_get(model.init(jax.random.PRNGKey(7), jnp.asarray(lms),
                                  jnp.asarray(feat_len)))
    params, stats = dict(v["params"]), dict(v["batch_stats"])
    jitter_bn(params, stats, np.random.RandomState(7))
    return model, params, stats


def _assert_encoder_outputs(got, want):
    np.testing.assert_array_equal(got["attn_emb_len"].numpy(),
                                  np.asarray(want["attn_emb_len"]))
    assert np.abs(np.asarray(want["attn_emb"])).max() > 0.05  # not collapsed
    for key in ("attn_emb", "fc_emb"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_cnn14_matches_jax(lms_input, cnn14_rnn_vars):
    from audiocaption_tpu.models.cnn14 import Cnn14Encoder as JCnn14
    lms, feat_len = lms_input
    _, params, stats = cnn14_rnn_vars
    params, stats = params["cnn"], stats["cnn"]
    want = JCnn14().apply({"params": params, "batch_stats": stats},
                          jnp.asarray(lms), jnp.asarray(feat_len))
    enc = _load(Cnn14Encoder(), export.cnn14_state_dict(params, stats))
    with torch.no_grad():
        got = enc(torch.from_numpy(lms), torch.from_numpy(feat_len))
    assert got["attn_emb"].shape == (2, 3, 2048)        # 101 // 32
    _assert_encoder_outputs(got, want)


def test_cnn14_rnn_encoder_matches_jax(lms_input, cnn14_rnn_vars):
    lms, feat_len = lms_input
    model, params, stats = cnn14_rnn_vars
    want = model.apply({"params": params, "batch_stats": stats},
                       jnp.asarray(lms), jnp.asarray(feat_len))
    enc = _load(Cnn14RnnEncoder(), export.cnn14_rnn_state_dict(params, stats))
    with torch.no_grad():
        got = enc(torch.from_numpy(lms), torch.from_numpy(feat_len))
    assert got["attn_emb"].shape == (2, 3, 512)
    np.testing.assert_array_equal(got["attn_emb_len"].numpy(), [3, 2])
    _assert_encoder_outputs(got, want)
