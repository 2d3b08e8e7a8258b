"""The port's extended encoders (``models/encoders_extra.py``,
``models/cnn14.py::Cnn14Classifier``) against the JAX package's, on the
CPU, with the JAX variables (flax init, BN statistics and affine
parameters jittered from a numpy seed) carried across by
``models.convert.jax_tree_state_dict``.  Inputs: a log-mel drawn from a
seed, [2, T, 64] with ragged frame counts (the audio transformer: [2, 9,
48] features).

  * eval forward: ``attn_emb`` and ``fc_emb`` within 1e-4 relative (to
    max(1, max |JAX|)), ``attn_emb_len`` equal;
  * one train-mode forward (BN on batch statistics, dropout the identity
    on both sides: flax's ``Dropout`` intercepted, torch's
    ``F.dropout`` patched): its outputs within 1e-4 relative and every
    BN's running statistics after it within 1e-4 relative (torch
    momentum 0.1 = flax 0.9);
  * bf16 (``compute_dtype`` of Cnn6 / Cnn10 / MobileNetV2), on a
    dB-scale log-mel as ``test_torch_bf16``'s Cnn14 case: the port's bf16
    output no further from JAX's eager bf16 apply than JAX's own float32
    output is (``test_torch_bf16.floor_check`` on ``attn_emb``), and the
    head (pooling, ``fc1``) on JAX's bf16 ``attn_emb`` gives JAX's
    ``fc_emb`` bit for bit;
  * the converted state dict fills the port module exactly (strict
    load), and the parameter counts are equal."""

import flax.linen as fnn
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from audiocaption_tpu.models import cnn14 as JC
from audiocaption_tpu.models import encoders_extra as JX

from audiocaption_tpu_torch.models import cnn14 as TC
from audiocaption_tpu_torch.models.cnn14 import pooled_fc
from audiocaption_tpu_torch.models import encoders_extra as TX
from audiocaption_tpu_torch.models.convert import jax_tree_state_dict

from test_torch_bf16 import floor_check

torch.set_num_threads(2)
TOL = 1e-4
B = 2


def no_dropout(next_fun, args, kwargs, context):
    """``intercept_methods`` hook: every flax ``Dropout`` is the identity."""
    if isinstance(context.module, fnn.Dropout) and \
            context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def close(got, want, tol=TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), f"{what}: {err}"


def jitter(tree, rng, scale):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.randn(*np.shape(x)).astype(
            np.float32), tree)


def jax_variables(jmod, x, n, seed=0):
    """flax init, then BN affine parameters and statistics jittered (the
    variances kept positive)."""
    v = jax.device_get(jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                                 jnp.asarray(n)))
    rng = np.random.RandomState(seed + 10)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = {}
    if "batch_stats" in v:
        stats = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + 0.1 * rng.randn(*a.shape).astype(
                np.float32), v["batch_stats"])
        stats = _positive_var(stats)
        params = _jitter_bn(params, v["batch_stats"], rng)
    return {"params": params, "batch_stats": stats}


def _positive_var(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _positive_var(v)
        else:
            out[k] = np.abs(v) + 0.5 if k == "var" else v
    return out


def _jitter_bn(params, stats, rng):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict) and k in stats and "mean" in stats[k]:
            out[k] = {"scale": v["scale"] + 0.1 * rng.randn(
                *v["scale"].shape).astype(np.float32),
                "bias": v["bias"] + 0.1 * rng.randn(
                    *v["bias"].shape).astype(np.float32)}
        elif isinstance(v, dict):
            out[k] = _jitter_bn(v, stats.get(k, {}), rng)
        else:
            out[k] = v
    return out


def port_of(tmod, v):
    tmod.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in
                          jax_tree_state_dict(v["params"],
                                              v["batch_stats"]).items()})
    return tmod.eval()


def n_params(tree):
    return sum(np.size(x) for x in jax.tree_util.tree_leaves(tree))


def lms_batch(T, seed=3, D=64):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, D).astype(np.float32)
    n = np.asarray([T, T - T // 3], np.int32)
    x[1, n[1]:] = 0.0
    return x, n


# name -> (JAX module, port module, input T)
ENCODERS = {
    "cnn6": (lambda: JX.Cnn6Encoder(), lambda: TX.Cnn6Encoder(), 64),
    "cnn10": (lambda: JX.Cnn10Encoder(), lambda: TX.Cnn10Encoder(), 64),
    "mobilenetv2": (lambda: JX.MobileNetV2Encoder(),
                    lambda: TX.MobileNetV2Encoder(), 192),
    "cdur8": (lambda: JX.Cdur8Encoder(), lambda: TX.Cdur8Encoder(), 40),
    "cnn14_trm": (lambda: JX.Cnn14TransformerEncoder(d_model=64, nlayers=1),
                  lambda: TX.Cnn14TransformerEncoder(d_model=64, nlayers=1),
                  64),
}


@pytest.fixture(scope="module", params=sorted(ENCODERS))
def encoder_pair(request):
    jf, tf, T = ENCODERS[request.param]
    x, n = lms_batch(T)
    jmod = jf()
    v = jax_variables(jmod, x, n)
    return request.param, jmod, v, port_of(tf(), v), x, n


def test_eval_forward_matches_jax(encoder_pair):
    name, jmod, v, tmod, x, n = encoder_pair
    assert n_params(v["params"]) == sum(p.numel() for p in
                                        tmod.parameters()), name
    want = jax.device_get(jax.jit(lambda v_, a, b: jmod.apply(v_, a, b))(
        v, jnp.asarray(x), jnp.asarray(n)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(n).long())
    assert got["attn_emb_len"].tolist() == np.asarray(
        want["attn_emb_len"]).tolist(), name
    for k in ("attn_emb", "fc_emb"):
        close(got[k].numpy(), want[k], what=f"{name} {k}")
    assert np.abs(np.asarray(want["fc_emb"])).max() > 1e-3, name


def test_train_forward_and_bn_statistics_match_jax(encoder_pair,
                                                   monkeypatch):
    name, jmod, v, tmod, x, n = encoder_pair
    assert v["batch_stats"], name

    def fwd(v_, a, b):
        with fnn.intercept_methods(no_dropout):
            return jmod.apply(v_, a, b, train=True,
                              mutable=["batch_stats"])
    want, upd = jax.device_get(jax.jit(fwd)(v, jnp.asarray(x),
                                            jnp.asarray(n)))
    monkeypatch.setattr(F, "dropout", lambda t, p=0.5, training=True,
                        inplace=False: t)
    tmod.train()
    try:
        with torch.no_grad():
            got = tmod(torch.from_numpy(x), torch.from_numpy(n).long())
    finally:
        tmod.eval()
    for k in ("attn_emb", "fc_emb"):
        close(got[k].numpy(), want[k], what=f"{name} train {k}")
    sd = {k: t.numpy() for k, t in tmod.state_dict().items()}
    want_sd = jax_tree_state_dict(v["params"], upd["batch_stats"])
    stats = [k for k in want_sd if k.endswith(("running_mean",
                                               "running_var"))]
    assert stats, name
    for k in stats:
        close(sd[k], want_sd[k], what=f"{name} {k}")
    # restore the statistics for the other tests of the module
    tmod.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in
                          jax_tree_state_dict(v["params"],
                                              v["batch_stats"]).items()})


def test_audio_transformer_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(B, 9, 48).astype(np.float32)
    n = np.asarray([9, 4], np.int32)
    for nhead, ff in ((None, None), (4, 96)):
        jmod = JX.AudioTransformerEncoder(d_model=64, nlayers=2, nhead=nhead,
                                          dim_feedforward=ff)
        v = jax_variables(jmod, x, n, seed=7)
        v["params"] = jitter(v["params"], rng, 0.1)
        tmod = port_of(TX.AudioTransformerEncoder(48, 64, 2, nhead, ff), v)
        assert n_params(v["params"]) == sum(
            p.numel() for p in tmod.parameters())
        want = jax.device_get(jmod.apply(v, jnp.asarray(x), jnp.asarray(n)))
        with torch.no_grad():
            got = tmod(torch.from_numpy(x), torch.from_numpy(n).long())
        assert got["attn_emb_len"].tolist() == [10, 5]
        for k in ("attn_emb", "fc_emb"):
            close(got[k].numpy(), want[k], what=f"nhead {nhead} {k}")


def test_cnn14_classifier_matches_jax():
    """The plain Cnn14's ``fc_emb`` (the builder's ``Cnn14Encoder`` type)
    and the AudioSet head's logits and probabilities."""
    x, n = lms_batch(64, seed=8)
    jmod = JC.Cnn14Classifier()
    v = jax_variables(jmod, x, n, seed=2)
    tmod = port_of(TC.Cnn14Classifier(), v)
    assert n_params(v["params"]) == sum(p.numel() for p in tmod.parameters())
    want = jax.device_get(jax.jit(lambda v_, a, b: jmod.apply(v_, a, b))(
        v, jnp.asarray(x), jnp.asarray(n)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(n).long())
    for k in ("attn_emb", "fc_emb", "logits", "clipwise_output"):
        close(got[k].numpy(), want[k], what=k)
    assert got["logits"].shape == (B, 527)


@pytest.mark.parametrize("name", ["cnn6", "cnn10", "mobilenetv2"])
def test_bf16_floor(name):
    jcls = {"cnn6": JX.Cnn6Encoder, "cnn10": JX.Cnn10Encoder,
            "mobilenetv2": JX.MobileNetV2Encoder}[name]
    tcls = {"cnn6": TX.Cnn6Encoder, "cnn10": TX.Cnn10Encoder,
            "mobilenetv2": TX.MobileNetV2Encoder}[name]
    # a dB-scale log-mel, as test_torch_bf16's Cnn14 case
    x, n = lms_batch(192 if name == "mobilenetv2" else 128, seed=11)
    x = x * 10 - 40
    v = jax_variables(jcls(), x, n, seed=4)
    jb = jcls(compute_dtype=jnp.bfloat16).apply(v, jnp.asarray(x),
                                                jnp.asarray(n))
    jf = jcls().apply(v, jnp.asarray(x), jnp.asarray(n))
    tmod = port_of(tcls(compute_dtype=torch.bfloat16), v)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(n).long())
        head = pooled_fc(torch.from_numpy(np.array(jb["attn_emb"])),
                         torch.from_numpy(np.asarray(jb["attn_emb_len"])),
                         tmod.fc1, False)
    assert got["attn_emb"].dtype == got["fc_emb"].dtype == torch.float32
    floor_check(f"{name} attn_emb", got["attn_emb"].numpy(),
                jb["attn_emb"], jf["attn_emb"])
    # the head adds no gap of its own: on JAX's attn_emb it gives JAX's
    # fc_emb bit for bit (the conv stack's one-ulp differences in
    # attn_emb are what reach fc_emb)
    np.testing.assert_array_equal(head.numpy(), np.asarray(jb["fc_emb"]))
