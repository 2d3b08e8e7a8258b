"""Layers, Cnn14 and the Cnn14-BiGRU encoder of the PyTorch port against
the JAX package on the same numpy inputs and weights carried across by
the JAX package's exporter (``models/export.py``).

The GRU's host-side packing (``layers.pack_rows`` / ``unpack_rows``,
``HostLengths``) is held bit for bit against ``pack_padded_sequence`` /
``pad_packed_sequence`` and the GRU over them (outputs and gradients),
and the Cnn14's length rule against its pooling.

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
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

import jax
import jax.numpy as jnp

from audiocaption_tpu.models import export
from audiocaption_tpu.models import layers as JL
from audiocaption_tpu.ops import masking as JM
from audiocaption_tpu_torch.models import layers as TL
from audiocaption_tpu_torch.models.cnn14 import Cnn14Encoder
from audiocaption_tpu_torch.models.rnn_encoder import Cnn14RnnEncoder
from audiocaption_tpu_torch.ops import masking as TM
from audiocaption_tpu_torch.ops.frontend import CNN14_MEL_32K

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


# lengths of 7 rows over T = 10: ties, above T, a zero, all full, all 1
PACK_LENS = [[10, 3, 3, 12, 1, 7, 3], [4, 0, 9, 4, 4, 15, 2],
             [10] * 7, [1] * 7, [2, 9, 9, 9, 0, 0, 5]]
PACK_IDS = ["ties_above_T", "zero", "full", "ones", "ties_zeros"]


def _torch_packed_gru(gru, x, lens):
    """The GRU over ``pack_padded_sequence`` / ``pad_packed_sequence``
    (lengths clamped to [1, T], rows of length 0 zeroed after): the
    reference encoders' packing through torch's own helpers."""
    T = x.shape[1]
    packed = pack_padded_sequence(x, lens.clamp(1, T), batch_first=True,
                                  enforce_sorted=False)
    out, _ = pad_packed_sequence(torch.nn.GRU.forward(gru, packed)[0],
                                 batch_first=True, total_length=T)
    return out * (lens > 0).to(out.dtype)[:, None, None]


@pytest.mark.parametrize("lens", PACK_LENS, ids=PACK_IDS)
def test_pack_rows_equals_pack_padded_sequence(lens):
    x = torch.randn(7, 10, 16, generator=torch.Generator().manual_seed(6))
    lens = torch.tensor(lens).clamp(1, 10)
    want = pack_padded_sequence(x, lens, batch_first=True,
                                enforce_sorted=False)
    got = TL.pack_rows(x, lens)
    for field in ("data", "batch_sizes", "sorted_indices",
                  "unsorted_indices"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    assert torch.equal(TL.unpack_rows(got, 12), pad_packed_sequence(
        want, batch_first=True, total_length=12)[0])


@pytest.mark.parametrize("lens", PACK_LENS, ids=PACK_IDS)
def test_gru_host_lengths_equal_the_read_and_torch_packing(lens):
    """Train mode, dropout 0.5 between the 3 layers: the GRU handed
    ``HostLengths``, the GRU reading a tensor and the GRU over torch's
    helpers give the same outputs and parameter gradients, bit for bit,
    on one seed of the dropout."""
    torch.manual_seed(0)
    gru = TL.GRU(16, 16, num_layers=3, bidirectional=True,
                 dropout=0.5).train()
    x = torch.randn(7, 10, 16, generator=torch.Generator().manual_seed(8))
    lens = torch.tensor(lens)
    runs = []
    for call in (lambda: gru(x, TL.HostLengths(lens)),
                 lambda: gru(x, lens),
                 lambda: _torch_packed_gru(gru, x, lens)):
        torch.manual_seed(9)
        out = call()
        runs.append((out, torch.autograd.grad((out * out).sum(),
                                              list(gru.parameters()))))
    for out, grads in runs[1:]:
        assert torch.equal(out, runs[0][0])
        for g, g0 in zip(grads, runs[0][1]):
            assert torch.equal(g, g0)
    assert not runs[0][0][lens == 0].any()


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_cnn14_length_rule_follows_its_pooling(dtype):
    """For every wave length within two hops of each multiple of 32
    frames (2-7 of them): ``HostLengths`` with the Cnn14's rule gives
    the ``attn_emb_len`` the Cnn14 computes, which is the frame count
    that its five 2x2 poolings leave of ``feat_len`` frames."""
    mel, hop = CNN14_MEL_32K, CNN14_MEL_32K.hop
    wav_len = torch.tensor([(32 * k - 1) * hop + d for k in range(2, 8)
                            for d in range(-2 * hop, 2 * hop + 1)],
                           dtype=dtype)
    feat_len = mel.feat_len(wav_len)
    device_rule = Cnn14Encoder.out_len(feat_len)
    host = TL.HostLengths(feat_len, Cnn14Encoder.out_len).wait()
    assert host.dtype == torch.int64
    assert torch.equal(host, device_rule.long())
    pooled = {}
    for n in set(feat_len.tolist()):
        x = torch.zeros(1, 1, n, 64)
        for _ in range(5):
            x = TL.pool_2d(x, (2, 2), "avg")
        pooled[n] = x.shape[2]
    assert {n % 32 for n in pooled} == {30, 31, 0, 1, 2}
    for n, got in zip(feat_len.tolist(), host.tolist()):
        assert got == pooled[n], (n, got)


def test_cnn14_rnn_encoder_host_lengths_equal_the_read(lms_input):
    """``Cnn14RnnEncoder`` (random weights, train mode at its dropouts, the
    CNN frozen) fed host ``feat_len`` equals its Cnn14 and RNN run apart
    with the GRU reading its device-style lengths, bit for bit; under a
    profiler the encoder waits once (``ac.sync.gru_lengths``) and never
    reads."""
    lms, feat_len = (torch.from_numpy(a) for a in lms_input)
    torch.manual_seed(3)
    enc = Cnn14RnnEncoder(freeze_cnn=True, freeze_cnn_bn=True).train()
    torch.manual_seed(4)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = enc(lms, feat_len)
    torch.manual_seed(4)
    cnn_out = enc.cnn(lms, feat_len)
    want = enc.rnn(cnn_out["attn_emb"].detach(), cnn_out["attn_emb_len"])
    for key in ("attn_emb", "fc_emb", "attn_emb_len"):
        assert torch.equal(got[key], want[key]), key
    names = [e.name for e in prof.events()
             if e.name.startswith("ac.sync.")]
    assert names == ["ac.sync.gru_lengths"], names


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
