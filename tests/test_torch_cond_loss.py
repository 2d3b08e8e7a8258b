"""The conditioned decoders' losses and data in the port against the JAX
package, on the CPU, on numpy inputs from a seed (logits [3, 6, 40]
drawn at scale 2, lengths [6, 4, 2] + 1):

  * ``HmClassifier`` on ids and on soft one-hots, its weights carried
    across by ``models.convert.jax_tree_state_dict``: logits within 1e-6;
  * ``reparameterize_argmax``: forward one-hot, and its gradient (the
    identity) equal to JAX's;
  * ``condition_loss_wrapper``: "argmax", "weighted", and "gumbel" under a
    shared noise tensor (JAX's uniforms from ``output["rng"]`` handed to
    the port's ``uniform``); loss and its gradient with respect to the
    logits within 1e-6;
  * ``specificity_loss_wrapper`` with "sum" and "mean": loss and
    gradient within 1e-6;
  * ``build_loss`` reads both wrappers' nodes (a discriminator ``.pth``
    written from JAX's params; a word-specificity ``.npy``) and gives the
    same loss as the wrappers built by hand;
  * ``ConditionCaptionDataset`` and ``RandomConditionDataset`` against
    JAX's on one HDF5 corpus (the random one seeded as JAX's global
    ``random``);
  * a JAX-side fault, pinned: JAX's train step hands the loss no
    ``conditions``, so its ``ConditionLossWrapper`` fails on that key
    (ROADMAP Queue 3); the port's step fills it from the batch."""

import json
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocaption_tpu.losses import loss as JL
from audiocaption_tpu.losses import wrappers as JW
from audiocaption_tpu.models.hm_classifier import HmClassifier as JHm

from audiocaption_tpu_torch.losses import loss as TL
from audiocaption_tpu_torch.losses import wrappers as TW
from audiocaption_tpu_torch.models.convert import jax_tree_state_dict
from audiocaption_tpu_torch.models.hm_classifier import HmClassifier

torch.set_num_threads(1)
N, T, V = 3, 6, 40
ATOL = 1e-6


@pytest.fixture(scope="module")
def hm():
    """JAX's HmClassifier (emb 16, hidden 12) and the port's on its
    weights."""
    jmod = JHm(vocab_size=V, emb_dim=16, hidden_size=12)
    v = jax.device_get(jmod.init(jax.random.PRNGKey(3),
                                 jnp.zeros((1, 4), jnp.int32),
                                 jnp.asarray([4])))
    tmod = HmClassifier(V, 16, 12)
    tmod.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in
                          jax_tree_state_dict(v["params"]).items()})
    return jmod, v, tmod


def outputs(seed: int = 0):
    rng = np.random.RandomState(seed)
    logit = (rng.randn(N, T, V) * 2).astype(np.float32)
    tgt = rng.randint(3, V, (N, T))
    tgt_len = np.asarray([6, 4, 2]) + 1
    cond = np.asarray([1.0, 0.0, 1.0], np.float32)
    return logit, tgt, tgt_len, cond


def test_hm_classifier_matches_jax(hm):
    jmod, v, tmod = hm
    rng = np.random.RandomState(1)
    ids = rng.randint(0, V, (N, T))
    soft = np.asarray(jax.nn.softmax(rng.randn(N, T, V) * 3, -1),
                      np.float32)
    lens = np.asarray([6, 3, 1])
    for cap in (ids, soft):
        want = jmod.apply(v, jnp.asarray(cap), jnp.asarray(lens))
        with torch.no_grad():
            got = tmod(torch.from_numpy(cap), torch.from_numpy(lens))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


def test_reparameterize_argmax_forward_and_gradient():
    logit, _, _, _ = outputs(2)
    w = np.random.RandomState(4).randn(N, T, V).astype(np.float32)
    jval, jgrad = jax.value_and_grad(
        lambda x: jnp.sum(JW.reparameterize_argmax(x) * w))(
            jnp.asarray(logit))
    x = torch.from_numpy(logit).requires_grad_()
    out = TW.reparameterize_argmax(x)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(
        JW.reparameterize_argmax(jnp.asarray(logit))))
    val = torch.sum(out * torch.from_numpy(w))
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), atol=ATOL,
                               rtol=0)


def _port_dscrm(tmod):
    return lambda caps, lens: torch.sigmoid(tmod(caps, lens))


def _jax_dscrm(jmod, v):
    return lambda caps, lens: jax.nn.sigmoid(jmod.apply(v, caps, lens))


def _loss_and_grad_jax(fn, logit, tgt, tgt_len, cond, rng_key=None):
    def f(x):
        out = {"logit": x, "tgt": jnp.asarray(tgt),
               "tgt_len": jnp.asarray(tgt_len),
               "conditions": jnp.asarray(cond)}
        if rng_key is not None:
            out["rng"] = rng_key
        return fn(out)
    val, grad = jax.value_and_grad(f)(jnp.asarray(logit))
    return float(val), np.asarray(grad)


def _loss_and_grad_port(fn, logit, tgt, tgt_len, cond):
    x = torch.from_numpy(logit).requires_grad_()
    loss = fn({"logit": x, "tgt": torch.from_numpy(tgt),
               "tgt_len": torch.from_numpy(tgt_len),
               "conditions": torch.from_numpy(cond)})
    loss.backward()
    return float(loss.detach()), x.grad.numpy()


@pytest.mark.parametrize("method", ["argmax", "weighted", "gumbel"])
def test_condition_loss_matches_jax(hm, method):
    jmod, v, tmod = hm
    logit, tgt, tgt_len, cond = outputs(5)
    key = jax.random.PRNGKey(11)
    jfn = JW.condition_loss_wrapper(
        JL.masked_token_loss("label_smoothing", 0.1), _jax_dscrm(jmod, v),
        alpha=0.7, sample_method=method)
    tfn = TW.condition_loss_wrapper(
        TL.masked_token_loss("label_smoothing", 0.1), _port_dscrm(tmod),
        alpha=0.7, sample_method=method,
        uniform=lambda shape, device: torch.from_numpy(np.array(
            jax.random.uniform(key, tuple(shape)))))
    want, wgrad = _loss_and_grad_jax(jfn, logit, tgt, tgt_len, cond,
                                     key if method == "gumbel" else None)
    got, ggrad = _loss_and_grad_port(tfn, logit, tgt, tgt_len, cond)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(ggrad, wgrad, atol=ATOL, rtol=0)
    # the condition term is there: it moves with the target condition
    other, _ = _loss_and_grad_port(tfn, logit, tgt, tgt_len, 1 - cond)
    assert abs(other - got) > 1e-5


def test_gumbel_draws_from_the_generator():
    logit, tgt, tgt_len, cond = outputs(6)
    dscrm = lambda caps, lens: torch.sigmoid(caps.sum((1, 2)) / 10)  # noqa
    fns = [TW.condition_loss_wrapper(
        TL.masked_token_loss(), dscrm, sample_method="gumbel",
        generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    a, b, c = (_loss_and_grad_port(f, logit, tgt, tgt_len, cond)[1]
               for f in fns)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_specificity_loss_matches_jax(reduce):
    logit, tgt, tgt_len, _ = outputs(7)
    rng = np.random.RandomState(8)
    ws = rng.rand(V).astype(np.float32)
    cond = (rng.rand(N) * 3).astype(np.float32)
    jfn = JW.specificity_loss_wrapper(JL.masked_token_loss("cross_entropy"),
                                      ws, sentence_reduce=reduce, alpha=0.5)
    tfn = TW.specificity_loss_wrapper(TL.masked_token_loss("cross_entropy"),
                                      ws, sentence_reduce=reduce, alpha=0.5)
    want, wgrad = _loss_and_grad_jax(jfn, logit, tgt, tgt_len, cond)
    got, ggrad = _loss_and_grad_port(tfn, logit, tgt, tgt_len, cond)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(ggrad, wgrad, atol=ATOL, rtol=0)


def test_build_loss_reads_both_wrappers(hm, tmp_path):
    jmod, v, tmod = hm
    logit, tgt, tgt_len, cond = outputs(9)
    ckpt = tmp_path / "hm.pth"
    torch.save({k: torch.from_numpy(np.array(a)) for k, a in
                jax_tree_state_dict(v["params"]).items()}, ckpt)
    node = {"type": "captioning.losses.loss.ConditionLossWrapper",
            "args": {"loss": {"type": "LabelSmoothingLoss",
                              "args": {"smoothing": 0.1}},
                     "dscrm": {"vocab_size": V, "emb_dim": 16,
                               "hidden_size": 12, "checkpoint": str(ckpt)},
                     "alpha": 0.7, "sample_method": "argmax"}}
    by_hand = TW.condition_loss_wrapper(
        TL.masked_token_loss("label_smoothing", 0.1), _port_dscrm(tmod),
        alpha=0.7)
    got, _ = _loss_and_grad_port(TL.build_loss(node), logit, tgt, tgt_len,
                                 cond)
    want, _ = _loss_and_grad_port(by_hand, logit, tgt, tgt_len, cond)
    assert got == want
    # a seeded discriminator (no checkpoint) is drawn the same each time
    node["args"]["dscrm"] = {"vocab_size": V, "seed": 3}
    a, b = (_loss_and_grad_port(TL.build_loss(node), logit, tgt, tgt_len,
                                cond)[0] for _ in range(2))
    assert a == b and np.isfinite(a)
    ws = np.random.RandomState(2).rand(V).astype(np.float32)
    np.save(tmp_path / "ws.npy", ws)
    node = {"type": "SpecificityLossWrapper",
            "args": {"word_specificity": str(tmp_path / "ws.npy"),
                     "sentence_reduce": "mean"}}
    got, _ = _loss_and_grad_port(TL.build_loss(node), logit, tgt, tgt_len,
                                 cond)
    want, _ = _loss_and_grad_port(TW.specificity_loss_wrapper(
        TL.masked_token_loss("label_smoothing", 0.0), ws, "mean"), logit,
        tgt, tgt_len, cond)
    assert got == want


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    import h5py
    root = tmp_path_factory.mktemp("cond_corpus")
    rng = np.random.RandomState(0)
    with h5py.File(root / "w.h5", "w") as f:
        for i in range(3):
            f[f"a{i}"] = rng.randn(800).astype(np.float32)
    with open(root / "wav.csv", "w") as f:
        f.write("audio_id\thdf5_path\n")
        for i in range(3):
            f.write(f"a{i}\t{root / 'w.h5'}\n")
    data = {"audios": [{"audio_id": f"a{i}", "captions": [
        {"tokens": f"word {j}", "cap_id": str(j)} for j in range(2)]}
        for i in range(3)]}
    with open(root / "text.json", "w") as f:
        json.dump(data, f)
    with open(root / "condition.csv", "w") as f:
        f.write("cap_id\tprob\n")
        for i in range(3):
            for j in range(2):
                f.write(f"a{i}_{j}\t{(i * 2 + j) / 10}\n")
    return root


def test_condition_datasets_match_jax(corpus):
    from audiocaption_tpu.data import condition_dataset as JCD
    from audiocaption_tpu_torch.data import condition_dataset as TCD
    feats = {"wav": str(corpus / "wav.csv")}
    args = dict(features=feats, caption=str(corpus / "text.json"),
                condition=str(corpus / "condition.csv"))
    jds, tds = JCD.ConditionCaptionDataset(**args), \
        TCD.ConditionCaptionDataset(**args)
    assert len(jds) == len(tds) == 6
    for i in range(6):
        j, t = jds[i], tds[i]
        assert (t["audio_id"], t["cap_id"]) == (j["audio_id"], j["cap_id"])
        assert t["condition"] == j["condition"] and t["condition"].dtype == \
            np.float32
        np.testing.assert_array_equal(t["wav"], j["wav"])
    args = dict(features=feats, condition=str(corpus / "condition.csv"),
                threshold=0.25, oversample=3)
    jds = JCD.RandomConditionDataset(**args)
    tds = TCD.RandomConditionDataset(seed=7, **args)
    assert tds.condition_pool == jds.condition_pool
    random.seed(7)
    want = [jds[i % 3]["condition"] for i in range(12)]
    assert [tds[i % 3]["condition"] for i in range(12)] == want


def test_jax_train_step_hands_the_loss_no_conditions():
    """JAX's train step builds the loss's output dict from the model's
    outputs plus ``tgt`` / ``tgt_len`` (``training/trainer.py:158-165``):
    no ``conditions``, so a ``ConditionLossWrapper`` fails there on that
    key.  The port's ``train_step`` fills it from the batch's
    ``condition``."""
    import optax
    from audiocaption_tpu.models.captioner import Captioner as JCaptioner
    from audiocaption_tpu.models.encoders_extra import Cdur5Encoder
    from audiocaption_tpu.models.rnn_decoder import ConditionalBahAttnDecoder
    from audiocaption_tpu.ops.frontend import CNN14_MEL_32K
    from audiocaption_tpu.training.trainer import (
        create_train_state, make_train_step)
    model = JCaptioner(encoder=Cdur5Encoder(),
                       decoder=ConditionalBahAttnDecoder(
                           emb_dim=8, vocab_size=12, fc_emb_dim=256,
                           attn_emb_dim=256, d_model=8),
                       mel=CNN14_MEL_32K)
    B, n = 2, 6400
    batch = {"wav": jnp.zeros((B, n)), "wav_len": jnp.full((B,), n),
             "cap": jnp.asarray([[1, 4, 5, 2], [1, 6, 2, 0]]),
             "cap_len": jnp.asarray([4, 3]),
             "condition": jnp.asarray([1.0, 0.0])}
    v = model.init({"params": jax.random.PRNGKey(0)}, batch["wav"],
                   batch["wav_len"], batch["cap"], batch["cap_len"],
                   train=False, cond_kwargs={"condition": batch["condition"]})
    loss_fn = JW.condition_loss_wrapper(
        JL.masked_token_loss("label_smoothing", 0.1),
        lambda caps, lens: jnp.full((caps.shape[0],), 0.5))
    tx = optax.sgd(1e-3)
    state = create_train_state(dict(v), tx, jax.random.PRNGKey(1))
    step = make_train_step(model, loss_fn, tx, donate=False)
    with pytest.raises(KeyError, match="conditions"):
        step(state, batch, jnp.float32(1.0))
