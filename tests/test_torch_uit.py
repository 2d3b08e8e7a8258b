"""The port's UiT family (``models/uit.py``) against the JAX package's, on
the CPU, at small widths (embed 32, 2 heads, depth 2, 16x16 patches).
JAX variables are drawn from a numpy seed on flax's shapes
(``test_torch_item8_wiring.random_variables``) and carried across by
``models.convert.uit_state_dict_from_jax``.

  * ``UITBase`` on 16 kHz waveforms (its own log-mel, ``UIT_MEL_16K``),
    every pooling ("mean", "token", "dm") and attention
    (``BNeckAttention`` with its full-width scale, ``Attention``), ReLU
    and tanh-GELU, with and without LayerScale: class probabilities
    within 1e-4 relative (to max(1, max |JAX|)); in ``eval()`` a clip
    longer than ``target_length`` (101 frames against 48) goes through
    the chunking, averaged ("mean") or maxed ("max"), a shorter one and
    ``train()`` (BN on batch statistics) straight through;
  * ``UitEncoder`` on a log-mel [2, T, 64] with two frame counts, for
    T longer than ``target_length`` (the image cut) and shorter, "mean"
    and "token" trunks (the CLS token dropped): ``attn_emb`` and
    ``fc_emb`` within 1e-4 relative, ``attn_emb_len`` equal;
  * every published variant (``UIT_VARIANTS``) with the zenodo sizes:
    the same parameter count as JAX's (flax shapes by ``jax.eval_shape``);
    ``UIT_MEL_16K`` its own constant, equal in value to JAX's and to
    ``EFFB2_MEL_16K`` (whose f_max None is 8000 at 16 kHz);
  * a float32 greedy caption of a ``UitEncoder`` captioner (16 kHz)
    token-exact against JAX;
  * the weight round trip: a seeded dict under the reference UiT keys ->
    JAX ``convert_uit`` (without a model) -> the port's inverse gives
    back the same arrays."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocaption_tpu.models import uit as JU
from audiocaption_tpu.models.captioner import generate as j_generate

from audiocaption_tpu_torch.models import uit as TU
from audiocaption_tpu_torch.models.captioner import generate
from audiocaption_tpu_torch.models.convert import uit_state_dict_from_jax
from audiocaption_tpu_torch.ops.frontend import EFFB2_MEL_16K

from test_torch_family import clips
from test_torch_item8_wiring import item8_captioner_pair, random_variables
from test_torch_panns import close

torch.set_num_threads(2)
SR = 16000
SMALL = dict(embed_dim=32, depth=2, num_heads=2, mlp_ratio=3.0,
             outputdim=11, target_length=48)
CASES = {
    "bneck_relu_mean": dict(pooling="mean", act="relu",
                            attention_type="BNeckAttention"),
    "attn_gelu_token": dict(pooling="token", act="gelu"),
    "attn_gelu_dm_ls": dict(pooling="dm", act="gelu", init_values=0.1),
    "bneck_relu_mean_max": dict(pooling="mean", act="relu",
                                attention_type="BNeckAttention",
                                eval_avg="max")}


def base_pair(case, wav, seed=0):
    kw = dict(SMALL, **CASES[case])
    jmod = JU.UITBase(**kw)
    v = random_variables(jmod, jnp.asarray(wav), seed=seed)
    port = TU.UITBase(**kw)
    port.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in
                          uit_state_dict_from_jax(
                              v["params"], v["batch_stats"]).items()})
    return jmod, v, port.eval()


def waves(seconds, seed=0):
    return (0.1 * np.random.RandomState(seed).randn(
        2, int(SR * seconds))).astype(np.float32)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("seconds", [1.0, 0.4], ids=["chunked", "short"])
def test_uitbase_matches_jax(case, seconds):
    wav = waves(seconds, 1)
    jmod, v, port = base_pair(case, wav)
    want = np.asarray(jax.jit(jmod.apply)(v, jnp.asarray(wav)))
    with torch.no_grad():
        got = port(torch.from_numpy(wav))
    close(got.numpy(), want, what=f"{case} {seconds} s")
    assert want.shape == (2, SMALL["outputdim"])


def test_uitbase_train_matches_jax():
    wav = waves(0.4, 2)
    jmod, v, port = base_pair("bneck_relu_mean", wav, seed=3)
    want, upd = jax.jit(lambda v_, w: jmod.apply(
        v_, w, train=True, mutable=["batch_stats"]))(v, jnp.asarray(wav))
    got = port.train()(torch.from_numpy(wav))
    close(got.detach().numpy(), np.asarray(want), what="train")
    stats = uit_state_dict_from_jax(v["params"], jax.device_get(
        upd["batch_stats"]))
    for k in ("init_bn.1.running_mean", "init_bn.1.running_var"):
        close(port.state_dict()[k].numpy(), stats[k], what=k)


@pytest.mark.parametrize("pooling", ["mean", "token"])
@pytest.mark.parametrize("T", [101, 40])
def test_uit_encoder_matches_jax(pooling, T):
    kw = dict(SMALL, pooling=pooling, act="relu",
              attention_type="BNeckAttention")
    jenc = JU.UitEncoder(trunk=JU.UITBase(**kw))
    x = np.random.RandomState(T).randn(2, T, 64).astype(np.float32)
    n = np.asarray([T, T - 25])
    v = random_variables(jenc, jnp.asarray(x), jnp.asarray(n), seed=4)
    port = TU.UitEncoder(TU.UITBase(**kw, classifier=False))
    port.load_state_dict({"trunk." + k: torch.from_numpy(np.array(a))
                          for k, a in uit_state_dict_from_jax(
                              v["params"]["trunk"],
                              v["batch_stats"]["trunk"]).items()})
    want = jax.device_get(jax.jit(jenc.apply)(v, jnp.asarray(x),
                                              jnp.asarray(n)))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x), torch.from_numpy(n))
    for k in ("attn_emb", "fc_emb"):
        close(got[k].numpy(), want[k], what=f"{pooling} T={T} {k}")
    np.testing.assert_array_equal(got["attn_emb_len"].numpy(),
                                  want["attn_emb_len"])
    assert got["attn_emb"].shape[1] == min(T, 48) // 16
    # the encoder has no head, as the JAX encoder's variables have none
    assert sum(np.size(a) for a in jax.tree_util.tree_leaves(
        v["params"])) == sum(p.numel() for p in port.parameters())


@pytest.mark.parametrize("name", list(JU.UIT_VARIANTS))
def test_variants_match_jax_sizes(name):
    jmod = JU.UIT_VARIANTS[name](**JU.UIT_PRETRAINED_KWARGS)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, SR))))
    port = TU.UIT_VARIANTS[name](**TU.UIT_PRETRAINED_KWARGS)
    assert sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
        shapes["params"])) == sum(p.numel() for p in port.parameters())
    assert (port.depth, port.embed_dim, port.pooling, port.target_length) \
        == (jmod.depth, jmod.embed_dim, jmod.pooling, jmod.target_length)


def test_uit_mel_is_its_own_constant():
    assert dataclasses.asdict(TU.UIT_MEL_16K) == dataclasses.asdict(
        JU.UIT_MEL_16K)
    # the same filterbank: EffB2's f_max None is sample_rate / 2 = 8000
    assert TU.UIT_MEL_16K == dataclasses.replace(
        EFFB2_MEL_16K, f_max=EFFB2_MEL_16K.effective_f_max)


def test_greedy_caption_matches_jax():
    kw = dict(SMALL, pooling="mean", act="relu",
              attention_type="BNeckAttention")
    jmodel, v, port, b = item8_captioner_pair(
        JU.UitEncoder(trunk=JU.UITBase(**kw)),
        TU.UitEncoder(TU.UITBase(**kw, classifier=False)),
        JU.UIT_MEL_16K, TU.UIT_MEL_16K, seed=6, b=clips(seed=6, B=3, Lc=8))
    want = jax.device_get(jax.jit(lambda v_, w, n: j_generate(
        jmodel, v_, w, n, max_length=12))(
            v, jnp.asarray(b["wav"]), jnp.asarray(b["wav_len"]
                                                   .astype(np.int32))))
    got = generate(port, torch.from_numpy(b["wav"]),
                   torch.from_numpy(b["wav_len"]), max_length=12)
    np.testing.assert_array_equal(got["seq"].numpy(), np.asarray(want["seq"]))
    assert len(np.unique(want["seq"])) > 3


def test_weight_round_trip_is_exact():
    """Reference UiT keys (uit_xs, LayerScale on) -> JAX ``convert_uit``
    without a model -> the port's inverse: the same arrays."""
    port = TU.UIT_VARIANTS["uit_xs"](init_values=0.1,
                                     **TU.UIT_PRETRAINED_KWARGS)
    rng = np.random.RandomState(8)
    sd = {k: (rng.rand(*t.shape) + 0.5 if k.endswith("running_var")
              else rng.randn(*t.shape)).astype(np.float32)
          for k, t in port.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    params, stats = JU.convert_uit(sd)
    back = {k: a for k, a in uit_state_dict_from_jax(params, stats).items()
            if not k.endswith("num_batches_tracked")}
    assert set(back) == set(sd)
    for k, a in sd.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)
