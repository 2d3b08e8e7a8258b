"""The port's EfficientAT MobileNetV3 encoder
(``models/mobilenet_v3.py``) against the JAX package's, on the CPU.  JAX
variables are drawn from a numpy seed on flax's shapes
(``test_torch_item8_wiring.random_variables``), carried across by
``models.convert.mobilenet_v3_state_dict_from_jax``; inputs are a log-mel
[2, T, 64] drawn from a seed with two frame counts (a padded batch).

  * eval forward at three widths and both poolings ("mn01", whose second
    block has no expand conv once the widths are rounded, "mn04",
    "mn10"): ``attn_emb`` and ``fc_emb`` within 1e-4 relative
    (to max(1, max |JAX|)), ``attn_emb_len`` equal;
  * one train-mode forward (BN on batch statistics, dropout the identity
    on both sides): its outputs within 1e-4 relative and every BN's
    running statistics after it within 1e-4 relative (BN eps 1e-3 and
    flax momentum 0.99, torch 0.01, in the blocks);
  * bf16 (``compute_dtype``), against JAX's eager (op by op) bf16 apply:
    six blocks of "mn10", one of each kind, on one bf16 input, and the whole
    encoder on a dB-scale log-mel.  Every activation (hard swish, hard
    sigmoid, the SE and mel means) and every BN rounds as JAX's does, bit
    for bit; what differs is the order in which oneDNN and XLA sum a
    convolution's products in float32, which moves an output across a
    bf16 rounding boundary now and then (one ulp).  ``test_torch_bf16.
    floor_check``'s bar (no further from JAX's bf16 output than JAX's
    float32 output is) is printed, but it cannot hold here in general:
    JAX's own float32-vs-bf16 gap at these outputs is often below one
    bf16 ulp of their largest magnitude (0.6 to 0.95 ulps measured), so a
    single flipped rounding crosses it.  The bar is the larger of that
    gap and one ulp at max |JAX| (:func:`ulp_floor_check`); measured: 0
    to 0.5 ulps a block, one ulp for ``attn_emb`` and ``fc_emb``;
  * a float32 greedy caption of a MobileNetV3 ("mn04") captioner
    token-exact against JAX;
  * the weight round trip: a seeded dict under the EfficientAT keys ->
    JAX ``convert_mobilenet_v3`` -> the port's inverse gives back the same
    arrays, and the dict fills the port module exactly (strict load)."""

import flax.linen as fnn
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from audiocaption_tpu.models import mobilenet_v3 as JM
from audiocaption_tpu.models.captioner import generate as j_generate
from audiocaption_tpu.ops.frontend import CNN14_MEL_32K as J_MEL

from audiocaption_tpu_torch.models import mobilenet_v3 as TM
from audiocaption_tpu_torch.models.captioner import generate
from audiocaption_tpu_torch.models.convert import (
    mobilenet_v3_state_dict_from_jax)
from audiocaption_tpu_torch.ops.frontend import CNN14_MEL_32K

from test_torch_item8_wiring import item8_captioner_pair, random_variables
from test_torch_panns import close, n_params, no_dropout

torch.set_num_threads(2)
B, T = 2, 203
N = np.asarray([203, 150])


def lms(seed=0, db=False):
    x = np.random.RandomState(seed).randn(B, T, 64).astype(np.float32)
    return (x * 10.0 - 40.0).astype(np.float32) if db else x


def pair(name, pooling, seed=0):
    jmod = JM.MobileNetV3Encoder(model_name=name, pooling=pooling)
    v = random_variables(jmod, jnp.asarray(lms(seed)), jnp.asarray(N),
                         seed=seed)
    port = TM.MobileNetV3Encoder(name, pooling)
    port.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in
                          mobilenet_v3_state_dict_from_jax(
                              v["params"], v["batch_stats"]).items()})
    return jmod, v, port.eval()


@pytest.mark.parametrize("name,pooling", [("mn01", "mean_max_fc"),
                                          ("mn04", "mean"),
                                          ("mn10", "mean_max_fc")])
def test_eval_forward_matches_jax(name, pooling):
    jmod, v, port = pair(name, pooling)
    x = lms(1)
    want = jax.device_get(jax.jit(jmod.apply)(v, jnp.asarray(x),
                                              jnp.asarray(N)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(N))
    for k in ("attn_emb", "fc_emb"):
        close(got[k].numpy(), want[k], what=f"{name} {k}")
    np.testing.assert_array_equal(got["attn_emb_len"].numpy(),
                                  want["attn_emb_len"])
    assert got["attn_emb"].shape[-1] == port.attn_emb_size == \
        jmod.last_channels
    assert got["fc_emb"].shape[-1] == port.fc_emb_size == jmod.fc_emb_size
    assert n_params(v["params"]) == sum(p.numel()
                                        for p in port.parameters())


def test_train_forward_and_bn_statistics_match_jax():
    jmod, v, port = pair("mn04", "mean_max_fc", seed=2)
    x = lms(3)

    def jfwd(v_, a, n):
        with fnn.intercept_methods(no_dropout):
            return jmod.apply(v_, a, n, train=True, mutable=["batch_stats"])
    want, upd = jax.device_get(jax.jit(jfwd)(v, jnp.asarray(x),
                                             jnp.asarray(N)))
    port.train()
    dropout = F.dropout
    F.dropout = lambda t, p=0.5, training=True, inplace=False: t
    try:
        got = port(torch.from_numpy(x), torch.from_numpy(N))
    finally:
        F.dropout = dropout
    for k in ("attn_emb", "fc_emb"):
        close(got[k].detach().numpy(), want[k], what=f"train {k}")
    stats = mobilenet_v3_state_dict_from_jax(v["params"],
                                             upd["batch_stats"])
    own = port.state_dict()
    n = 0
    for k, a in stats.items():
        if k.endswith(("running_mean", "running_var")):
            close(own[k].numpy(), a, what=k)
            n += 1
    assert n == 2 * sum(isinstance(m, torch.nn.BatchNorm2d)
                        for m in port.modules())


def ulp_floor_check(name, port, jax_bf16, jax_f32):
    """max |port - JAX bf16| <= max(max |JAX f32 - JAX bf16|, one bf16 ulp
    at max |JAX bf16|)."""
    p, jb, jf = (np.asarray(np.asarray(a, np.float32), np.float64)
                 for a in (port, jax_bf16, jax_f32))
    assert p.shape == jb.shape == jf.shape, name
    gap, floor = np.abs(p - jb).max(), np.abs(jf - jb).max()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(jb).max())) - 7)
    print(f"{name}: port-vs-jax bf16 {gap:.3g}, jax f32-vs-bf16 {floor:.3g} "
          f"(ratio {gap / floor:.3g}), one bf16 ulp at max |ref| {ulp:.3g}")
    assert 0 < floor and gap <= max(floor, ulp), name


@pytest.fixture(scope="module")
def mn10_variables():
    jmod = JM.MobileNetV3Encoder(model_name="mn10")
    v = random_variables(jmod, jnp.asarray(lms(4, db=True)), jnp.asarray(N),
                         seed=5)
    return v, mobilenet_v3_state_dict_from_jax(v["params"],
                                               v["batch_stats"])


# one block of each kind: no expand with the residual; ReLU stride 2; ReLU
# 5x5 with SE, stride 2; hard swish stride 2; hard swish with SE, widths
# changing; hard swish 5x5 with SE and the residual
@pytest.mark.parametrize("i", [0, 1, 3, 6, 10, 13])
def test_bf16_block_within_jax_floor(mn10_variables, i):
    v, sd = mn10_variables
    ci, k, ce, co, se, act, s = JM._V3_LARGE[i]
    args = (ci, k, ce, co, se, act == "HS", s)       # mn10: width 1.0
    vb = {"params": v["params"][f"block{i}"],
          "batch_stats": v["batch_stats"][f"block{i}"]}
    h = np.random.RandomState(i).randn(2, 24, 8, ci).astype(np.float32)
    h = jnp.asarray(h).astype(jnp.bfloat16)
    j32 = JM.V3InvertedResidual(*args).apply(vb, h.astype(jnp.float32))
    j16 = JM.V3InvertedResidual(*args, compute_dtype=jnp.bfloat16).apply(
        vb, h)
    blk = TM.V3InvertedResidual(*args, compute_dtype=torch.bfloat16)
    pre = f"features.{i + 1}."
    blk.load_state_dict({k_[len(pre):]: torch.from_numpy(np.array(a))
                         for k_, a in sd.items() if k_.startswith(pre)})
    x = torch.from_numpy(np.asarray(h.astype(jnp.float32)))
    with torch.no_grad():
        got = blk.eval()(x.permute(0, 3, 1, 2).bfloat16())
    assert got.dtype == torch.bfloat16
    ulp_floor_check(f"MobileNetV3 block {i}",
                    got.float().permute(0, 2, 3, 1),
                    np.asarray(j16.astype(jnp.float32)), j32)


def test_bf16_encoder_within_one_ulp_or_jax_floor(mn10_variables):
    v, sd = mn10_variables
    x = lms(4, db=True)
    j32 = JM.MobileNetV3Encoder(model_name="mn10").apply(
        v, jnp.asarray(x), jnp.asarray(N))
    j16 = JM.MobileNetV3Encoder(model_name="mn10",
                                compute_dtype=jnp.bfloat16).apply(
        v, jnp.asarray(x), jnp.asarray(N))
    port = TM.MobileNetV3Encoder("mn10", compute_dtype=torch.bfloat16)
    port.load_state_dict({k: torch.from_numpy(np.array(a))
                          for k, a in sd.items()})
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x), torch.from_numpy(N))
    for k in ("attn_emb", "fc_emb"):
        assert got[k].dtype == torch.float32
        ulp_floor_check(f"MobileNetV3 mn10 bf16 {k}", got[k].numpy(), j16[k],
                        j32[k])


def test_greedy_caption_matches_jax():
    jmodel, v, port, b = item8_captioner_pair(
        JM.MobileNetV3Encoder(model_name="mn04"),
        TM.MobileNetV3Encoder("mn04"), J_MEL, CNN14_MEL_32K, seed=4)
    want = jax.device_get(jax.jit(lambda v_, w, n: j_generate(
        jmodel, v_, w, n, max_length=12))(
            v, jnp.asarray(b["wav"]), jnp.asarray(b["wav_len"]
                                                   .astype(np.int32))))
    got = generate(port, torch.from_numpy(b["wav"]),
                   torch.from_numpy(b["wav_len"]), max_length=12)
    np.testing.assert_array_equal(got["seq"].numpy(), np.asarray(want["seq"]))
    assert len(np.unique(want["seq"])) > 3


@pytest.mark.parametrize("name", ["mn04", "mn10"])
def test_weight_round_trip_is_exact(name):
    """EfficientAT keys -> JAX converter -> the port's inverse: the same
    arrays; ``bn0`` and ``fc1`` (which the converter leaves alone) ride
    along under their JAX names."""
    port = TM.MobileNetV3Encoder(name)
    rng = np.random.RandomState(7)
    sd = {k: (rng.rand(*t.shape) + 0.5 if k.endswith("running_var")
              else rng.randn(*t.shape)).astype(np.float32)
          for k, t in port.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    params, stats = JM.convert_mobilenet_v3(sd)
    params["bn0"] = {"scale": sd["bn0.weight"], "bias": sd["bn0.bias"]}
    stats["bn0"] = {"mean": sd["bn0.running_mean"],
                    "var": sd["bn0.running_var"]}
    params["fc1"] = {"kernel": sd["fc1.weight"].T, "bias": sd["fc1.bias"]}
    back = mobilenet_v3_state_dict_from_jax(params, stats)
    back = {k: a for k, a in back.items()
            if not k.endswith("num_batches_tracked")}
    assert set(back) == set(sd)
    for k, a in sd.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)
    port.load_state_dict({k: torch.from_numpy(np.array(a))
                          for k, a in back.items()}, strict=False)
    missing = set(port.state_dict()) - set(back)
    assert all(k.endswith("num_batches_tracked") for k in missing)
