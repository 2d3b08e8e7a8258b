"""The port's PANNs classifiers (``models/panns.py``: ``Cnn10`` and
``Wavegram_Logmel_Cnn14``) against the JAX package's, on the CPU, at
their published widths.  JAX variables are drawn from a numpy seed on
flax's shapes (``test_torch_item8_wiring.random_variables``) and carried
across by ``models.convert.panns_classifier_state_dict_from_jax``; the
inputs are 1 s waves at 32 kHz (two clips, the second zero-padded after
0.7 s) and their log-mel from the JAX frontend.

  * eval forward: ``clipwise_output``, ``logits``, ``fc_feat`` and
    ``attn_feat`` within 1e-4 relative (to max(1, max |JAX|)); the
    wavegram branch's [B, 4, T', 32] regrouping and both branches cut
    to the shorter time before the concat (a wave one hop longer than
    the log-mel covers);
  * a train-mode forward (BN on batch statistics, dropout the identity
    on both sides): the outputs and every BN's running statistics after
    it within 1e-4 relative;
  * ``prepare_features --encoder panns_cnn10|panns_wavegram
    --checkpoint`` (a reference-key file) against JAX's tool on 3 clips:
    the same ids, ``fc.h5``, ``attn.h5`` (cut to ``feat_len // ratio``,
    the ratio from the realised shapes) and ``probs.h5`` rows within 1e-4
    relative;
  * the weight round trip: a seeded dict under the PANNs keys -> JAX
    ``convert_cnn10_classifier`` / ``convert_wavegram_cnn14`` -> the
    port's inverse gives back the same arrays (1-D conv kernels [O, I,
    k])."""

import flax.linen as fnn
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from audiocaption_tpu.models import panns as JP
from audiocaption_tpu.ops.frontend import CNN14_MEL_32K, LogMelFrontend

from audiocaption_tpu_torch.models import panns as TP
from audiocaption_tpu_torch.models.convert import (
    panns_classifier_state_dict_from_jax)

from test_torch_item8_wiring import (
    check_prepared, prepare_features_pair, random_variables)
from test_torch_panns import close, no_dropout

torch.set_num_threads(2)
SR = 32000
KEYS = ("clipwise_output", "logits", "fc_feat", "attn_feat")


def inputs(seed=0, extra=0):
    rng = np.random.RandomState(seed)
    wav = (0.1 * rng.randn(2, SR + extra)).astype(np.float32)
    wav[1, int(0.7 * SR):] = 0.0
    lms = np.asarray(LogMelFrontend(CNN14_MEL_32K)(
        jnp.asarray(wav[:, :SR])))
    return wav, lms


def pair(name, seed=0, extra=0):
    wav, lms = inputs(seed, extra)
    if name == "cnn10":
        jmod, args, port = JP.Cnn10(classes_num=17), (lms,), TP.Cnn10(17)
    else:
        jmod, args = JP.Wavegram_Logmel_Cnn14(classes_num=17), (wav, lms)
        port = TP.Wavegram_Logmel_Cnn14(17)
    v = random_variables(jmod, *(jnp.asarray(a) for a in args), seed=seed)
    port.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in
                          panns_classifier_state_dict_from_jax(
                              v["params"], v["batch_stats"]).items()})
    return jmod, v, port.eval(), args


@pytest.mark.parametrize("name,extra", [("cnn10", 0), ("wavegram", 0),
                                        ("wavegram", 320)])
def test_eval_forward_matches_jax(name, extra):
    jmod, v, port, args = pair(name, 1, extra)
    want = jax.device_get(jax.jit(jmod.apply)(
        v, *(jnp.asarray(a) for a in args)))
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in args))
    for k in KEYS:
        close(got[k].numpy(), want[k], what=f"{name} {k}")
    assert got["attn_feat"].shape[1] == args[-1].shape[1] // (
        16 if name == "cnn10" else 32)
    assert sum(np.size(a) for a in jax.tree_util.tree_leaves(
        v["params"])) == sum(p.numel() for p in port.parameters())


@pytest.mark.parametrize("name", ["cnn10", "wavegram"])
def test_train_forward_and_bn_statistics_match_jax(name):
    jmod, v, port, args = pair(name, 2)

    def jfwd(v_, *a):
        with fnn.intercept_methods(no_dropout):
            return jmod.apply(v_, *a, train=True, mutable=["batch_stats"])
    want, upd = jax.device_get(jax.jit(jfwd)(
        v, *(jnp.asarray(a) for a in args)))
    dropout = F.dropout
    F.dropout = lambda t, p=0.5, training=True, inplace=False: t
    try:
        got = port.train()(*(torch.from_numpy(a) for a in args))
    finally:
        F.dropout = dropout
    for k in KEYS:
        close(got[k].detach().numpy(), want[k], what=f"train {k}")
    stats = panns_classifier_state_dict_from_jax(v["params"],
                                                 upd["batch_stats"])
    own = port.state_dict()
    keys = [k for k in stats if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * sum(isinstance(
        m, torch.nn.modules.batchnorm._BatchNorm) for m in port.modules())
    for k in keys:
        close(own[k].numpy(), stats[k], what=k)


@pytest.mark.parametrize("name", ["cnn10", "wavegram"])
def test_weight_round_trip_is_exact(name):
    port = TP.Cnn10() if name == "cnn10" else TP.Wavegram_Logmel_Cnn14()
    conv = (JP.convert_cnn10_classifier if name == "cnn10"
            else JP.convert_wavegram_cnn14)
    rng = np.random.RandomState(5)
    sd = {k: (rng.rand(*t.shape) + 0.5 if k.endswith("running_var")
              else rng.randn(*t.shape)).astype(np.float32)
          for k, t in port.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    params, stats = conv(sd)
    back = {k: a for k, a in panns_classifier_state_dict_from_jax(
        params, stats).items() if not k.endswith("num_batches_tracked")}
    assert set(back) == set(sd)
    for k, a in sd.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)


@pytest.mark.parametrize("name", ["panns_cnn10", "panns_wavegram"])
def test_prepare_features_matches_jax(name, tmp_path):
    module = TP.Cnn10() if name == "panns_cnn10" else \
        TP.Wavegram_Logmel_Cnn14()
    out = prepare_features_pair(tmp_path, name, module, seed=2)
    assert set(out) == {"fc", "attn", "probs"}
    check_prepared(out)
