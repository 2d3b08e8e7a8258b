"""Pruned training from a config (``encoder.args.prune_ratio`` on an
``EfficientNetB2``) in the PyTorch port against the JAX runner's path
(``cli/run.py``: the pretrained weights loaded, then
``build_pruned_effb2`` with ``prune_start_layer``, ``prune_se``,
``prune_method`` and ``prune_head``), on the CPU:

  * the port's sequence (``build_model_from_config``, ``load_pretrained``,
    ``utils/config.py::apply_pruning``) builds the pruned widths and
    weights of the JAX sequence exactly, from one pretrained encoder file
    (a full EffB2 with jittered BN);
  * one train step of the pruned flagship (decoder emb 64, dropout and
    drop-connect 0, no scheduled sampling) against the JAX
    ``make_train_step``: loss relative 1e-5, raw gradient norm relative
    1e-4, gradients within 1e-4 * max(1, max |g|) of each tensor,
    parameters by ``test_torch_train_step``'s floor."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocaption_tpu.losses.loss import masked_token_loss as j_loss
from audiocaption_tpu.models import effb2 as JE
from audiocaption_tpu.optim.schedules import (
    exponential_decay_with_warmup as j_schedule)
from audiocaption_tpu.training.trainer import (
    create_train_state as j_create_state, make_optimizer as j_optimizer,
    make_train_step)
from audiocaption_tpu.utils.config import (
    build_model_from_config as j_build, load_pretrained_into)

from audiocaption_tpu_torch.cli.run import load_pretrained
from audiocaption_tpu_torch.losses.loss import masked_token_loss
from audiocaption_tpu_torch.models.convert import (
    effb2_state_dict_from_jax, load_reference_state_dict,
    state_dict_from_jax)
from audiocaption_tpu_torch.models.effb2 import PrunedEfficientNetB2
from audiocaption_tpu_torch.models.zoo import random_init
from audiocaption_tpu_torch.optim.schedules import (
    exponential_decay_with_warmup)
from audiocaption_tpu_torch.training.trainer import (
    create_train_state, train_step)
from audiocaption_tpu_torch.utils.config import (
    apply_pruning, build_model_from_config)

from test_torch_pruning import jitter_bn
from test_torch_train_forward import jax_batch, make_batch, torch_batch
from test_torch_train_step import (
    B1, MISS_SHARE, PARAM_ATOL, _adam_state, _ref_key, _ref_space,
    _report_close)

torch.set_num_threads(2)
V, RATIO = 50, 0.3
LR, FINAL, TOTAL, WD, CLIP = 5e-4, 5e-7, 100, 1e-6, 1.0


def node(pretrained: str) -> dict:
    return {"type": "captioning.models.transformer_model.TransformerModel",
            "encoder": {"type": "captioning.models.cnn_encoder."
                                "EfficientNetB2",
                        "args": {"prune_ratio": RATIO,
                                 "prune_method": "operator_norm"},
                        "pretrained": pretrained},
            "decoder": {"type": "TransformerDecoder",
                        "args": {"emb_dim": 64, "attn_emb_dim": 1408,
                                 "nlayers": 2, "dropout": 0.0,
                                 "tie_weights": True}}}


@pytest.fixture(scope="module")
def pruned(tmp_path_factory):
    """-> (the port model, the JAX model and variables), both pruned from
    the same pretrained encoder file."""
    v = jax.device_get(JE.EfficientNetB2().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 101, 64)), jnp.asarray([101])))
    params, stats = dict(v["params"]), dict(v["batch_stats"])
    jitter_bn(params, stats, np.random.RandomState(5))
    path = tmp_path_factory.mktemp("prune") / "effb2.pth"
    torch.save(effb2_state_dict_from_jax(params, stats), path)
    n = node(str(path))

    port, specs = build_model_from_config(n, vocab_size=V)
    random_init(port, torch.Generator().manual_seed(0))
    for spec in specs:
        load_pretrained(port, spec)
    assert apply_pruning(port, n)
    assert isinstance(port.encoder, PrunedEfficientNetB2)

    jmodel, jspecs = j_build(n, vocab_size=V)
    b = jax_batch(make_batch(seed=3, B=2))
    jv = jax.device_get(jmodel.init(
        {"params": jax.random.PRNGKey(1), "sample": jax.random.PRNGKey(2)},
        b["wav"], b["wav_len"], b["cap"], b["cap_len"], train=False))
    for spec in jspecs:
        jv = load_pretrained_into(jv, spec)
    pm, pp, ps = JE.build_pruned_effb2(
        jv["params"]["encoder"], jv["batch_stats"]["encoder"], RATIO,
        prune_start_layer=0, prune_se=True, method="operator_norm",
        prune_head=False)
    jmodel = jmodel.clone(encoder=pm.clone(drop_connect_rate=0.0))
    rng = np.random.RandomState(7)
    dec = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*np.shape(a)).astype(
            np.float32), jv["params"]["decoder"])
    jvars = {"params": {"encoder": jax.device_get(pp), "decoder": dec},
             "batch_stats": {"encoder": jax.device_get(ps)}}
    return port, jmodel, jvars


def test_pruned_widths_and_weights_match_jax(pruned):
    port, _, jvars = pruned
    want = effb2_state_dict_from_jax(jvars["params"]["encoder"],
                                     jvars["batch_stats"]["encoder"])
    got = port.encoder.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(np.shape(w)), k
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(w),
                                          err_msg=k)
    assert port.encoder.fc_emb_size == 1408           # prune_head False
    n_full = sum(p.numel() for p in build_model_from_config(
        node(""), vocab_size=V)[0].encoder.parameters())
    assert sum(p.numel() for p in port.encoder.parameters()) < 0.8 * n_full


@pytest.fixture(scope="module")
def step(pruned):
    port, jmodel, jvars = pruned
    load_reference_state_dict(port, state_dict_from_jax(
        jvars, nlayers=2, tie_weights=True))
    for block in port.encoder._blocks:
        block.drop_rate = 0.0
    warm = TOTAL // 5
    tx = j_optimizer(LR, j_schedule(LR, FINAL, TOTAL, warm), WD, CLIP)
    jstate = j_create_state(jvars, tx, jax.random.PRNGKey(0))
    jstep = make_train_step(jmodel, j_loss("label_smoothing", 0.1), tx,
                            donate=False, use_ss=False)
    b = make_batch(seed=11, B=2)
    p_prev = _ref_space(jvars["params"], jvars["params"],
                        jvars["batch_stats"])
    jstate, jm = jstep(jstate, jax_batch(b), jnp.float32(1.0))
    jm = jax.device_get(jm)
    state = create_train_state(
        port, LR, exponential_decay_with_warmup(LR, FINAL, TOTAL, warm),
        WD, CLIP)
    m = train_step(state, masked_token_loss("label_smoothing", 0.1),
                   torch_batch(b))
    j_params = jax.device_get(jstate.params)
    j_stats = jax.device_get(jstate.batch_stats)
    named = dict(port.named_parameters())
    want = _ref_space(j_params, j_params, j_stats)
    mu = _ref_space(_adam_state(jax.device_get(jstate.opt_state)).mu,
                    j_params, j_stats)
    coef = min(1.0, CLIP / (float(m["grad_norm"]) + 1e-6))
    unclip = max(1.0, float(jm["grad_norm"]) / CLIP)
    return dict(j=jm, m=m, j_params={_ref_key(n): want[_ref_key(n)]
                                     for n in named},
                j_grads={_ref_key(n): (mu[_ref_key(n)] / (1 - B1) - WD
                                       * p_prev[_ref_key(n)]) * unclip
                         for n in named},
                grads={_ref_key(n): p.grad.numpy() / coef
                       for n, p in named.items()},
                params={_ref_key(n): p.detach().numpy().copy()
                        for n, p in named.items()})


def test_pruned_train_step_matches_jax(step):
    s = step
    assert not s["m"]["skipped"] and not bool(s["j"]["skipped"])
    np.testing.assert_allclose(float(s["m"]["loss"]), float(s["j"]["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(s["m"]["grad_norm"]),
                               float(s["j"]["grad_norm"]), rtol=1e-4)
    _report_close(s["grads"], s["j_grads"],
                  lambda w: 1e-4 * max(1.0, np.abs(w).max()), "gradients")
    _report_close(s["params"], s["j_params"], PARAM_ATOL, "parameters",
                  MISS_SHARE)
