"""The port in bf16 (``compute_dtype=torch.bfloat16``) against the JAX
package in bf16 (``compute_dtype=jnp.bfloat16``), module by module, and
the decode kernels' plain versions in their bf16 modes (``cache_bf16``,
``weights_bf16``) against the JAX fused kernels in Pallas interpret
mode.  Inputs are made with numpy from a seed; weights cross over
through the converters (``models/convert.py``), BN statistics jittered.

The bar for a module (``floor_check``): the port is no further from
JAX's bf16 output than JAX's own bf16 output is from its float32 one,
max |port_bf16 - jax_bf16| <= max |jax_f32 - jax_bf16|; a single layer
also lies within 3 bf16 ulps (3 * 2^-7) of max |jax_bf16|.  Both
frameworks round to bf16 at the same places; what differs is the order
of the float32 sums, which moves an output across a bf16 rounding
boundary now and then (one ulp), while bf16 itself moves outputs by
many ulps.  The measured ratio of the two maxima (``floor_check`` prints
it): 0 for the single layers and the MBConv blocks (bit-identical), 0.53
and 0.40 for the EffB2's attn_emb and fc_emb, 0.83 and 0.81 for the
Cnn14's, 0.52 for the SED probabilities, 5e-6 for the decoder step's
logits.

Decode plain versions: greedy ``cache_bf16`` tokens exact; beam 3
``cache_bf16`` tokens exact, scores within 1e-4; beam 3 ``weights_bf16``
tokens exact, scores within 5e-3 (not 1e-3): the measured gap is
2.8e-3 on two of nine scores.  The reason: in the bf16
modes the plain version sums in float64 and rounds to float32 where its
CUDA kernel does (so that the two agree on the card), while the JAX
kernel sums in float32; an activation that lands an ulp apart in float32
rounds to the other bf16 neighbour now and then, and the beam's score
moves by that 2^-8 relative step.  (JAX holds its own bf16 beam scores
to 5e-2, ``tests/test_fused_beam.py``.)
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocaption_tpu.models import effb2 as JE
from audiocaption_tpu.models import layers as JL
from audiocaption_tpu_torch.decoding import fused_beam as TB
from audiocaption_tpu_torch.decoding import fused_greedy as TG
from audiocaption_tpu_torch.models import convert as TC
from audiocaption_tpu_torch.models import effb2 as TE
from audiocaption_tpu_torch.models import layers as TL

from test_torch_effb2 import jitter_bn
from test_torch_fused import (E, L, NHEAD, NL, _interpret, decoders,
                              jax_memory, memory, torch_inputs)

torch.set_num_threads(1)

BF16, JBF16 = torch.bfloat16, jnp.bfloat16
ULP3 = 3 * 2.0 ** -7          # 3 bf16 ulps at 1.0


def floor_check(name, port, jax_bf16, jax_f32, single=False):
    port, jb, jf = (np.asarray(np.asarray(x, np.float32), np.float64)
                    for x in (port, jax_bf16, jax_f32))
    assert port.shape == jb.shape == jf.shape, name
    gap = np.abs(port - jb).max()
    floor = np.abs(jf - jb).max()
    scale = np.abs(jb).max()
    print(f"{name}: port-vs-jax bf16 {gap:.3g}, jax f32-vs-bf16 {floor:.3g}"
          f" (ratio {gap / floor:.3g}), max |ref| {scale:.3g}")
    assert floor > 0 and gap <= floor, name
    if single:
        assert gap <= ULP3 * scale, name


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(x):
    return x.float().permute(0, 2, 3, 1).numpy()


def _bf16_round(x):
    return np.asarray(jnp.asarray(x).astype(JBF16).astype(jnp.float32))


def _load(module, sd):
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in sd.items()})
    return module.eval()


# ------------------------------------------------------------ layers --

@pytest.mark.parametrize("k,stride,pad,groups,bias", [
    (3, 1, (1, 1, 1, 1), 1, True), (1, 1, (0, 0, 0, 0), 1, False),
    (5, 2, (1, 2, 1, 2), 8, False)], ids=["3x3_bias", "1x1", "depthwise"])
def test_conv2d_same_bf16(k, stride, pad, groups, bias):
    rng = np.random.RandomState(k)
    x = rng.randn(2, 11, 13, 8).astype(np.float32)
    cin = 8 // groups
    w = (rng.randn(k, k, cin, 8) / np.sqrt(k * k * cin)).astype(np.float32)
    p = {"kernel": w}
    if bias:
        p["bias"] = rng.randn(8).astype(np.float32)
    outs = {}
    for cd in (jnp.float32, JBF16):
        conv = JL.Conv2dSame(8, (k, k), strides=(stride, stride),
                             padding=pad, use_bias=bias, groups=groups,
                             compute_dtype=cd)
        outs[cd] = conv.apply({"params": p}, jnp.asarray(x))
    sd = {}
    TC._conv2d(p, "c", sd)
    tc = _load(TL.Conv2dSame(8, 8, k, stride=stride, groups=groups,
                             bias=bias, padding4=pad, compute_dtype=BF16),
               {n[2:]: v for n, v in sd.items()})
    with torch.no_grad():
        got = tc(_nchw(x))
    assert got.dtype == BF16
    floor_check("conv", _nhwc(got), outs[JBF16], outs[jnp.float32], True)


def test_batchnorm_bf16():
    rng = np.random.RandomState(0)
    x = _bf16_round(rng.randn(2, 5, 7, 8) * 3)
    p = {"scale": (rng.rand(8) + 0.5).astype(np.float32),
         "bias": rng.randn(8).astype(np.float32)}
    s = {"mean": rng.randn(8).astype(np.float32),
         "var": (rng.rand(8) + 0.1).astype(np.float32)}
    outs = {cd: JL.BatchNorm(epsilon=1e-3, compute_dtype=cd).apply(
        {"params": p, "batch_stats": s}, jnp.asarray(x))
        for cd in (jnp.float32, JBF16)}
    sd = {}
    TC._batchnorm(p, s, "b", sd)
    bn = _load(TL.BatchNorm2d(8, eps=1e-3, compute_dtype=BF16),
               {n[2:]: v for n, v in sd.items()})
    with torch.no_grad():
        got = bn(_nchw(x).to(BF16))
    assert got.dtype == BF16
    floor_check("batchnorm", _nhwc(got), outs[JBF16], outs[jnp.float32],
                True)


def test_layernorm_bf16():
    rng = np.random.RandomState(1)
    x = _bf16_round(rng.randn(3, 4, 32) * 2 + 1)
    p = {"scale": (rng.rand(32) + 0.5).astype(np.float32),
         "bias": rng.randn(32).astype(np.float32)}
    outs = {cd: JL.LayerNorm(compute_dtype=cd).apply({"params": p},
                                                     jnp.asarray(x))
            for cd in (jnp.float32, JBF16)}
    ln = TL.LayerNorm(32, compute_dtype=BF16).eval()
    ln.load_state_dict({"weight": torch.from_numpy(p["scale"]),
                        "bias": torch.from_numpy(p["bias"])})
    with torch.no_grad():
        got = ln(torch.from_numpy(x).to(BF16))
    floor_check("layernorm", got.float().numpy(), outs[JBF16],
                outs[jnp.float32], True)


def test_attention_bf16():
    rng = np.random.RandomState(2)
    Em, H = 64, 4
    q = rng.randn(2, 5, Em).astype(np.float32)
    kv = rng.randn(2, 9, Em).astype(np.float32)
    kpm = np.zeros((2, 9), bool)
    kpm[1, 6:] = True
    p = {n: {"kernel": (rng.randn(Em, Em) / 8).astype(np.float32),
             "bias": (rng.randn(Em) * 0.1).astype(np.float32)}
         for n in ("q_proj", "k_proj", "v_proj", "out_proj")}
    outs = {cd: JL.MultiheadAttention(Em, H, compute_dtype=cd).apply(
        {"params": p}, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
        key_padding_mask=jnp.asarray(kpm)) for cd in (jnp.float32, JBF16)}
    sd = {}
    TC._mha(p, "a", sd)
    mha = _load(TL.MultiheadAttention(Em, H, BF16),
                {n[2:]: v for n, v in sd.items()})
    with torch.no_grad():
        got = mha(torch.from_numpy(q), torch.from_numpy(kv),
                  torch.from_numpy(kv), torch.from_numpy(kpm))
    assert got.dtype == BF16
    floor_check("attention", got.float().numpy(), outs[JBF16],
                outs[jnp.float32], True)


# ---------------------------------------------------------- encoders --

@pytest.fixture(scope="module")
def effb2_weights():
    v = jax.device_get(JE.EfficientNetB2().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 101, 64)), jnp.asarray([101])))
    params, stats = dict(v["params"]), dict(v["batch_stats"])
    jitter_bn(params, stats, np.random.RandomState(4))
    enc = TE.EfficientNetB2(compute_dtype=BF16).eval()
    enc.load_state_dict(TC.effb2_state_dict_from_jax(params, stats))
    return {"params": params, "batch_stats": stats}, enc


@pytest.mark.parametrize("idx", [5, 4], ids=["stride2", "stride1_skip"])
def test_mbconv_block_bf16(effb2_weights, idx):
    v, enc = effb2_weights
    plan = JE._b2_block_plan()[idx]
    # a float32 input, as the encoder test's log-mel: both blocks round it
    # at their first conv (and add it unrounded at the skip).  An input
    # already in bf16 leaves JAX's own bf16 error at about half an output
    # ulp, below the one-ulp flips that another sum order makes.
    x = np.random.RandomState(idx).randn(
        2, 16, 12, plan["in_filters"]).astype(np.float32)
    outs = {cd: JE.MBConvBlock(**plan, compute_dtype=cd).apply(
        {"params": v["params"][f"block{idx}"],
         "batch_stats": v["batch_stats"][f"block{idx}"]}, jnp.asarray(x))
        for cd in (jnp.float32, JBF16)}
    with torch.no_grad():
        got = enc._blocks[idx](_nchw(x))
    assert got.dtype == (BF16 if plan["stride"] == 2 else torch.float32)
    floor_check(f"mbconv block {idx}", _nhwc(got), outs[JBF16],
                outs[jnp.float32])


def test_effb2_encoder_bf16(effb2_weights):
    v, enc = effb2_weights
    rng = np.random.RandomState(2)
    lms = (rng.randn(2, 101, 64) * 10 - 40).astype(np.float32)   # 1 s
    feat_len = np.asarray([101, 70], np.int64)
    outs = {cd: JE.EfficientNetB2(compute_dtype=cd).apply(
        v, jnp.asarray(lms), jnp.asarray(feat_len))
        for cd in (jnp.float32, JBF16)}
    with torch.no_grad():
        got = enc(torch.from_numpy(lms), torch.from_numpy(feat_len))
    assert got["attn_emb"].dtype == torch.float32
    for key in ("attn_emb", "fc_emb"):
        floor_check(f"effb2 {key}", got[key].numpy(), outs[JBF16][key],
                    outs[jnp.float32][key])


def test_cnn14_encoder_bf16():
    from audiocaption_tpu.models import export
    from audiocaption_tpu.models.cnn14 import Cnn14Encoder as JCnn14
    from audiocaption_tpu_torch.models.cnn14 import Cnn14Encoder
    rng = np.random.RandomState(5)
    lms = (rng.randn(2, 128, 64) * 10 - 40).astype(np.float32)
    feat_len = np.asarray([128, 90])
    v = jax.device_get(JCnn14().init(jax.random.PRNGKey(1),
                                     jnp.asarray(lms), jnp.asarray(feat_len)))
    params, stats = dict(v["params"]), dict(v["batch_stats"])
    jitter_bn(params, stats, rng)
    v = {"params": params, "batch_stats": stats}
    outs = {cd: JCnn14(compute_dtype=cd).apply(v, jnp.asarray(lms),
                                               jnp.asarray(feat_len))
            for cd in (jnp.float32, JBF16)}
    enc = _load(Cnn14Encoder(compute_dtype=BF16),
                export.cnn14_state_dict(params, stats))
    with torch.no_grad():
        got = enc(torch.from_numpy(lms), torch.from_numpy(feat_len))
    for key in ("attn_emb", "fc_emb"):
        assert got[key].dtype == torch.float32
        floor_check(f"cnn14 {key}", got[key].numpy(), outs[JBF16][key],
                    outs[jnp.float32][key])


def test_sed_framewise_bf16():
    from audiocaption_tpu.models import export
    from audiocaption_tpu.models import sed as JS
    from audiocaption_tpu_torch.models import sed as TS
    rng = np.random.RandomState(6)
    lms = (rng.randn(2, 101, 64) * 10 - 40).astype(np.float32)
    v = jax.device_get(JS.Cnn8RnnSedModel().init(jax.random.PRNGKey(0),
                                                 jnp.asarray(lms)))
    params, stats = dict(v["params"]), dict(v["batch_stats"])
    jitter_bn(params, stats, rng)
    v = {"params": params, "batch_stats": stats}
    outs = {cd: JS.Cnn8RnnSedModel(compute_dtype=cd).apply(
        v, jnp.asarray(lms))["framewise_output"]
        for cd in (jnp.float32, JBF16)}
    sed = _load(TS.Cnn8RnnSedModel(compute_dtype=BF16),
                export.cnn8rnn_state_dict(params, stats))
    with torch.no_grad():
        got = sed(torch.from_numpy(lms))["framewise_output"]
    assert got.dtype == torch.float32
    floor_check("sed framewise", got.numpy(), outs[JBF16],
                outs[jnp.float32])


# ----------------------------------------------------------- decoder --

def test_decoder_step_bf16(decoders):
    """Teacher-forced steps of the bf16 decoder: every step's logits."""
    from audiocaption_tpu.models.transformer_decoder import (
        TransformerDecoder as JDec)
    from audiocaption_tpu_torch.models.transformer_decoder import (
        TransformerDecoder as TDec)
    jdec32, params, tdec32 = decoders
    rng = np.random.RandomState(8)
    attn = rng.randn(2, 9, 32).astype(np.float32)
    lens = np.asarray([9, 5])
    words = rng.randint(3, 48, (2, 6))
    words[1, 3] = 0                                       # a pad token
    tdec = TDec(E, 48, 32, nlayers=NL, nhead=NHEAD, dim_feedforward=256,
                tie_weights=True, compute_dtype=BF16).eval()
    tdec.load_state_dict(tdec32.state_dict())
    logits = {}
    for cd in (jnp.float32, JBF16):
        jdec = jdec32.clone(compute_dtype=cd)
        v = {"params": params}
        static, dyn = jdec.apply(v, jnp.asarray(attn), jnp.asarray(lens), 6,
                                 method=JDec.init_cache)
        out = []
        for t in range(6):
            w = jnp.asarray(words[:, t])
            lg, dyn = jdec.apply(v, w, t, static, dyn, is_pad_t=w == 0,
                                 method=JDec.step)
            out.append(np.asarray(lg))
        logits[cd] = np.stack(out, 1)
    with torch.no_grad():
        static, dyn = tdec.init_cache(torch.from_numpy(attn),
                                      torch.from_numpy(lens), 6)
        assert dyn["self_k0"].dtype == BF16
        out = []
        for t in range(6):
            w = torch.from_numpy(words[:, t])
            lg, dyn = tdec.step(w, t, static, dyn, is_pad_t=w == 0)
            assert lg.dtype == torch.float32
            out.append(lg.numpy())
    floor_check("decoder step logits", np.stack(out, 1), logits[JBF16],
                logits[jnp.float32])


# ------------------------------------- decode plain versions, bf16 modes --

def _jax_bf16_memory(memkv, valid):
    memk, memv, mv = jax_memory(memkv, valid)
    return (tuple(m.astype(JBF16) for m in memk),
            tuple(m.astype(JBF16) for m in memv), mv)


def _bf16_inputs(tdec, memkv, valid):
    packed, mk, mv = torch_inputs(tdec, memkv, valid)
    return packed, mk.to(BF16), mv


@pytest.mark.parametrize("lens", [(9, 4, 6), (9, 0, 3)],
                         ids=["ragged", "empty_memory"])
def test_greedy_plain_cache_bf16_matches_jax_kernel(decoders, monkeypatch,
                                                    lens):
    import audiocaption_tpu.decoding.fused_greedy as FG
    jdec, params, tdec = decoders
    memkv, valid = memory(3, 11, lens)
    _interpret(monkeypatch, FG, FG._fused_decode_call)
    packed_j = {k: jnp.asarray(v)
                for k, v in FG.pack_decoder_weights(jdec, params).items()}
    want = np.asarray(FG._fused_decode_call(
        jdec, L, packed_j, *_jax_bf16_memory(memkv, valid), cache_bf16=True))
    got = TG.fused_greedy_decode(*_bf16_inputs(tdec, memkv, valid), L,
                                 cache_bf16=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 2


@pytest.mark.parametrize("cache_bf16,weights_bf16,atol", [
    (True, False, 1e-4), (False, True, 5e-3)],
    ids=["cache_bf16", "weights_bf16"])
def test_beam_plain_bf16_modes_match_jax_kernel(decoders, monkeypatch,
                                                cache_bf16, weights_bf16,
                                                atol):
    import audiocaption_tpu.decoding.fused_beam as FB
    from audiocaption_tpu.decoding.fused_greedy import pack_decoder_weights
    jdec, params, tdec = decoders
    memkv, valid = memory(3, 5, (9, 4, 6))
    _interpret(monkeypatch, FB, FB._fused_beam_call)
    packed_j = {k: jnp.asarray(v)
                for k, v in pack_decoder_weights(jdec, params).items()}
    jmem = (_jax_bf16_memory if cache_bf16 else jax_memory)(memkv, valid)
    want_seq, want_score = FB._fused_beam_call(
        jdec, L, 3, packed_j, *jmem, cache_bf16=cache_bf16,
        weights_bf16=weights_bf16)
    args = (_bf16_inputs if cache_bf16 else torch_inputs)(tdec, memkv, valid)
    seq, score = TB.fused_beam_decode(*args, L, 3, cache_bf16=cache_bf16,
                                      weights_bf16=weights_bf16)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(want_seq))
    np.testing.assert_allclose(score.numpy(), np.asarray(want_score),
                               atol=atol)
    # the mode changes the result: the float32 search differs somewhere
    s32, sc32 = TB.fused_beam_decode(*torch_inputs(tdec, memkv, valid), L, 3)
    assert not torch.equal(sc32, score)


def test_wrappers_check_the_mode(decoders):
    _, _, tdec = decoders
    memkv, valid = memory(2, 1, (9, 5))
    packed, mk, mv = torch_inputs(tdec, memkv, valid)
    with pytest.raises(ValueError, match="cache_bf16"):
        TG.fused_greedy_decode(packed, mk, mv, L, cache_bf16=True)
    with pytest.raises(ValueError, match="cache_bf16"):
        TB.fused_beam_decode(packed, mk.to(BF16), mv, L)
    # on the CPU the plain version runs: nothing is launched or counted
    n0 = dict(TB.fused_beam_decode.mode_launches)
    TB.fused_beam_decode(packed, mk.to(BF16), mv, 3, cache_bf16=True)
    assert TB.fused_beam_decode.mode_launches == n0


def test_memory_kv_follows_the_mode(decoders):
    _, _, tdec = decoders
    attn = torch.randn(2, 9, 32)
    lens = torch.tensor([9, 4])
    mk32, valid = TG.memory_kv(tdec, attn, lens)
    mk16, valid16 = TG.memory_kv(tdec, attn, lens, cache_bf16=True)
    assert mk32.dtype == torch.float32 and mk16.dtype == BF16
    assert torch.equal(mk16, mk32.to(BF16)) and torch.equal(valid, valid16)
