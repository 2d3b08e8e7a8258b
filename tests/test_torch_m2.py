"""The meshed-memory (M2) transformer of the PyTorch port
(``models/m2.py``) against the JAX package's ``models/m2.py``, on the
CPU, float32, on JAX variables carried across by
``models/convert.py::jax_tree_state_dict`` (the port keeps the JAX module
names; no M2 leaf needs a rule of its own):

  * ``M2Attention`` (with and without memory slots, padded keys),
    ``M2FeedForward``, ``M2TransformerEncoder`` and the
    ``M2TransformerDecoder``'s teacher-forced forward (padded captions)
    within 1e-5;
  * the decoder's cached ``step`` against its full-prefix forward;
  * a captioner built from one config dict by both builders (the
    ``m2_trm.yaml`` model node at a small width): greedy and beam-3
    tokens equal to JAX's ``generate``, beam scores within 1e-5;
  * one XE step's loss, gradients, Adam moments and parameters against
    the JAX ``make_train_step``, by ``test_torch_train_step``'s floors
    (dropout the identity on both sides);
  * the builder's raise for an M2 decoder without an M2 encoder, and the
    decode dispatch that keeps M2 off the fused kernels.

Inputs are made from numpy seeds; the decoder's tensors are jittered by
their own spread (a fresh decoder's captions are near ties)."""

import flax.linen as fnn
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from audiocaption_tpu.losses.loss import masked_token_loss as j_loss
from audiocaption_tpu.models import m2 as JM
from audiocaption_tpu.models.captioner import generate as j_generate
from audiocaption_tpu.optim.schedules import (
    exponential_decay_with_warmup as j_schedule)
from audiocaption_tpu.training.trainer import (
    create_train_state as j_create_state, make_optimizer as j_optimizer,
    make_train_step)
from audiocaption_tpu.utils.config import build_model_from_config as j_build

from audiocaption_tpu_torch.decoding.select import select_decoder
from audiocaption_tpu_torch.losses.loss import masked_token_loss
from audiocaption_tpu_torch.models import m2 as TM
from audiocaption_tpu_torch.models.captioner import generate
from audiocaption_tpu_torch.models.convert import (
    captioner_state_dict_from_jax, jax_tree_state_dict,
    load_reference_state_dict)
from audiocaption_tpu_torch.optim.schedules import (
    exponential_decay_with_warmup)
from audiocaption_tpu_torch.training.trainer import (
    create_train_state, train_step)
from audiocaption_tpu_torch.utils.config import build_model_from_config

from test_torch_family import no_dropout, port_grads_space
from test_torch_train_step import (
    B1, MISS_SHARE, PARAM_ATOL, _adam_state, _moment_tol, _report_close)

ATOL = 1e-5
D, NHEAD, DIN, V = 32, 4, 24, 30


def load(module, variables):
    """JAX variables of a module -> the port module (same names)."""
    sd = jax_tree_state_dict(jax.device_get(variables["params"]))
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in sd.items()}, strict=False)
    missing = set(module.state_dict()) - set(sd)
    assert missing <= {"pe"}, missing
    return module.eval()


def jittered(params, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * (np.std(a) if np.size(a) > 1
                                           else 1.0)
        * rng.randn(*np.shape(a)).astype(np.float32), params)


def feats(seed=0, B=3, T=9, lens=(9, 6, 4)):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, DIN).astype(np.float32)
    lens = np.asarray(lens[:B], np.int64)
    for i, n in enumerate(lens):
        x[i, n:] = 0.0
    return x, lens


def key_bias(lens, Tq, S):
    ok = np.arange(S)[None] < np.asarray(lens)[:, None]
    b = np.where(ok, 0.0, JM.NEG_BIAS).astype(np.float32)
    return np.broadcast_to(b[:, None, :], (len(lens), Tq, S)).copy()


@pytest.mark.parametrize("n_memory", [0, 5])
def test_m2_attention_matches_jax(n_memory):
    rng = np.random.RandomState(n_memory)
    q = rng.randn(3, 4, D).astype(np.float32)
    kv = rng.randn(3, 7, D).astype(np.float32)
    bias = key_bias([7, 5, 2], 4, 7)
    jmod = JM.M2Attention(D, NHEAD, n_memory=n_memory)
    v = jmod.init(jax.random.PRNGKey(0), q, kv, bias)
    v = {"params": jittered(v["params"], 1, 0.3)}
    want = np.asarray(jmod.apply(v, q, kv, bias))
    port = load(TM.M2Attention(D, NHEAD, n_memory=n_memory), v)
    with torch.no_grad():
        got = port(torch.from_numpy(q), torch.from_numpy(kv),
                   torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_m2_feedforward_matches_jax():
    x = np.random.RandomState(2).randn(3, 5, D).astype(np.float32)
    jmod = JM.M2FeedForward(D, 2 * D)
    v = jmod.init(jax.random.PRNGKey(1), x)
    v = {"params": jittered(v["params"], 2, 0.3)}
    port = load(TM.M2FeedForward(D, 2 * D), v)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply(v, x)), atol=ATOL,
                               rtol=0)


@pytest.fixture(scope="module")
def encoder_pair():
    x, lens = feats()
    jmod = JM.M2TransformerEncoder(D, nlayers=2, nhead=NHEAD, n_memory=6)
    v = jmod.init(jax.random.PRNGKey(2), x, lens.astype(np.int32))
    v = {"params": jittered(v["params"], 3, 0.3)}
    port = load(TM.M2TransformerEncoder(DIN, D, nlayers=2, nhead=NHEAD,
                                        n_memory=6), v)
    return jmod, v, port, x, lens


def test_m2_encoder_matches_jax(encoder_pair):
    jmod, v, port, x, lens = encoder_pair
    want = jax.device_get(jmod.apply(v, x, lens.astype(np.int32)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(lens))
    assert got["attn_emb"].shape == (3, 2, 9, D)
    for k in ("attn_emb", "fc_emb"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def decoder_pair(encoder_pair):
    jenc, venc, _, x, lens = encoder_pair
    enc = jax.device_get(jenc.apply(venc, x, lens.astype(np.int32)))
    rng = np.random.RandomState(4)
    word = rng.randint(3, V, (3, 6)).astype(np.int32)
    word[1, 4:] = 0
    word[2, 2:] = 0
    jdec = JM.M2TransformerDecoder(emb_dim=D, vocab_size=V, attn_emb_dim=D,
                                   nlayers=2, nhead=NHEAD, n_enc_levels=2)
    v = jdec.init(jax.random.PRNGKey(3), word, enc["attn_emb"],
                  enc["attn_emb_len"])
    params = dict(v["params"])
    pe = params.pop("pe")
    params = jittered(params, 5, 0.5)
    params["pe"] = np.asarray(pe)
    v = {"params": params}
    port = load(TM.M2TransformerDecoder(D, V, nlayers=2, nhead=NHEAD,
                                        n_enc_levels=2), v)
    np.testing.assert_array_equal(port.pe.numpy(), np.asarray(pe))
    return jdec, v, port, enc, word


def test_m2_decoder_forward_matches_jax(decoder_pair):
    jdec, v, port, enc, word = decoder_pair
    pad = word == 0
    want = jax.device_get(jdec.apply(v, word, enc["attn_emb"],
                                     enc["attn_emb_len"],
                                     cap_padding_mask=pad))
    with torch.no_grad():
        got = port(torch.from_numpy(word).long(),
                   torch.from_numpy(np.asarray(enc["attn_emb"])),
                   torch.from_numpy(np.asarray(enc["attn_emb_len"])).long(),
                   cap_padding_mask=torch.from_numpy(pad))
    for k in ("logit", "embed"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, rtol=0, err_msg=k)


def test_m2_cached_step_matches_full_prefix(decoder_pair):
    _, _, port, enc, word = decoder_pair
    mem = torch.from_numpy(np.asarray(enc["attn_emb"]))
    mem_len = torch.from_numpy(np.asarray(enc["attn_emb_len"])).long()
    w = torch.from_numpy(word).long()[:, :4].clone()
    w[:, :] = torch.from_numpy(np.random.RandomState(6).randint(3, V, (3, 4)))
    with torch.no_grad():
        full = port(w, mem, mem_len)["logit"]
        static, dyn = port.init_cache(mem, mem_len, 4)
        for t in range(4):
            logit, dyn = port.step(w[:, t], t, static, dyn)
            np.testing.assert_allclose(logit.numpy(), full[:, t].numpy(),
                                       atol=ATOL, rtol=0)


# ------------------------------------------------------ the captioner --

def m2_node(dropout: float = 0.1) -> dict:
    """``configs/synthetic/m2_trm.yaml``'s model node at a small width."""
    return {"type": "captioning.models.transformer_model.M2TransformerModel",
            "encoder": {"type": "captioning.models.transformer_encoder."
                                "M2TransformerEncoder",
                        "args": {"input_dim": DIN, "d_model": D,
                                 "nlayers": 2, "nhead": NHEAD,
                                 "dropout": dropout, "m": 6}},
            "decoder": {"type": "captioning.models.transformer_decoder."
                                "M2TransformerDecoder",
                        "args": {"attn_emb_dim": D, "fc_emb_dim": D,
                                 "nlayers": 2, "nhead": NHEAD,
                                 "dropout": dropout}},
            "args": {}}


def caps(seed=7, B=3, Lc=7):
    rng = np.random.RandomState(seed)
    cap_len = np.asarray([Lc, Lc - 2, Lc - 3][:B], np.int64)
    cap = np.zeros((B, Lc), np.int64)
    for i, n in enumerate(cap_len):
        cap[i, 0], cap[i, n - 1] = 1, 2
        cap[i, 1:n - 1] = rng.randint(3, V, n - 2)
    return cap, cap_len


def captioner_pair(seed=0, dec_jitter=0.5):
    node = m2_node()
    jmodel, _ = j_build(node, vocab_size=V)
    x, lens = feats(seed)
    cap, cap_len = caps()
    v = jax.device_get(jmodel.init(
        {"params": jax.random.PRNGKey(seed), "sample": jax.random.PRNGKey(1)},
        x, lens.astype(np.int32), cap.astype(np.int32),
        cap_len.astype(np.int32), train=False))
    params = dict(jax.tree_util.tree_map(np.asarray, v["params"]))
    dec = dict(params["decoder"])
    pe = dec.pop("pe")
    dec = jittered(dec, seed + 50, dec_jitter)
    dec["pe"] = pe
    params["decoder"] = dec
    jvars = {"params": params, "batch_stats": {}}
    port, _ = build_model_from_config(node, vocab_size=V)
    assert port.input_mode == "features"
    load_reference_state_dict(port, captioner_state_dict_from_jax(jvars))
    return jmodel, jvars, port.eval(), x, lens, cap, cap_len


@pytest.fixture(scope="module")
def pair():
    return captioner_pair()


@pytest.mark.parametrize("method", [dict(sample_method="greedy"),
                                    dict(sample_method="beam", beam_size=3)],
                         ids=["greedy", "beam3"])
def test_m2_captioner_decodes_as_jax(pair, method):
    jmodel, jvars, port, x, lens, _, _ = pair
    want = jax.device_get(jax.jit(lambda v, w, n: j_generate(
        jmodel, v, w, n, max_length=10, **method))(
            jvars, jnp.asarray(x), jnp.asarray(lens.astype(np.int32))))
    got = generate(port, torch.from_numpy(x), torch.from_numpy(lens),
                   max_length=10, **method)
    np.testing.assert_array_equal(got["seq"].numpy(), np.asarray(want["seq"]))
    assert len(np.unique(want["seq"])) > 2
    if "score" in want:
        np.testing.assert_allclose(got["score"].numpy(),
                                   np.asarray(want["score"]), atol=1e-5,
                                   rtol=0)


LR, FINAL, TOTAL, WD, CLIP = 5e-4, 5e-7, 100, 1e-6, 1.0


@pytest.fixture(scope="module")
def xe_step():
    jmodel, jvars, port, x, lens, cap, cap_len = captioner_pair(seed=2)
    warm = TOTAL // 5
    tx = j_optimizer(LR, j_schedule(LR, FINAL, TOTAL, warm), WD, CLIP)
    jstate = j_create_state(jvars, tx, jax.random.PRNGKey(0))
    jstep = make_train_step(jmodel, j_loss("label_smoothing", 0.1), tx,
                            donate=False, use_ss=False)
    batch = {"wav": x, "wav_len": lens, "cap": cap, "cap_len": cap_len}
    p_prev = port_grads_space(jvars["params"], jvars["params"], {})
    with fnn.intercept_methods(no_dropout):
        jstate, jm = jstep(jstate, {k: jnp.asarray(
            v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in batch.items()}, jnp.float32(1.0))
    jm = jax.device_get(jm)
    state = create_train_state(
        port, LR, exponential_decay_with_warmup(LR, FINAL, TOTAL, warm),
        WD, CLIP)
    dropout = F.dropout
    F.dropout = lambda t, p=0.5, training=True, inplace=False: t
    try:
        m = train_step(state, masked_token_loss("label_smoothing", 0.1),
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    finally:
        F.dropout = dropout
    j_params = jax.device_get(jstate.params)
    adam = _adam_state(jax.device_get(jstate.opt_state))
    mu = port_grads_space(adam.mu, j_params, {})
    nu = port_grads_space(adam.nu, j_params, {})
    named = dict(port.named_parameters())
    coef = min(1.0, CLIP / (float(m["grad_norm"]) + 1e-6))
    unclip = max(1.0, float(jm["grad_norm"]) / CLIP)
    want = port_grads_space(j_params, j_params, {})
    ost = state.optimizer.state
    return dict(
        j=jm, m=m,
        j_grads={n: (mu[n] / (1 - B1) - WD * p_prev[n]) * unclip
                 for n in named},
        grads={n: p.grad.numpy() / coef for n, p in named.items()},
        j_params={n: want[n] for n in named},
        params={n: p.detach().numpy().copy() for n, p in named.items()},
        j_mu={n: mu[n] for n in named}, j_nu={n: nu[n] for n in named},
        mu={n: ost[p]["exp_avg"].numpy().copy() for n, p in named.items()},
        nu={n: ost[p]["exp_avg_sq"].numpy().copy()
            for n, p in named.items()})


def test_m2_xe_step_loss_and_grads_match_jax(xe_step):
    s = xe_step
    assert not s["m"]["skipped"] and not bool(s["j"]["skipped"])
    np.testing.assert_allclose(float(s["m"]["loss"]), float(s["j"]["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(s["m"]["grad_norm"]),
                               float(s["j"]["grad_norm"]), rtol=1e-4)
    _report_close(s["grads"], s["j_grads"],
                  lambda w: 1e-4 * max(1.0, np.abs(w).max()), "gradients")
    # the memory slots and every level's gate took gradients
    for name in ("encoder.layer1_attn.m_k", "decoder.layer1_alpha1.weight"):
        assert np.abs(s["grads"][name]).max() > 0, name


def test_m2_xe_step_params_and_moments_match_jax(xe_step):
    s = xe_step
    _report_close(s["params"], s["j_params"], PARAM_ATOL, "parameters",
                  MISS_SHARE)
    _report_close(s["mu"], s["j_mu"], _moment_tol(s["j_mu"]), "Adam mu")
    _report_close(s["nu"], s["j_nu"], _moment_tol(s["j_nu"]), "Adam nu")


def test_m2_decoder_needs_m2_encoder():
    node = m2_node()
    node["encoder"] = {"type": "AudioTransformerEncoder",
                       "args": {"input_dim": DIN, "d_model": D}}
    with pytest.raises(ValueError, match="requires an M2TransformerEncoder"):
        build_model_from_config(node, vocab_size=V)
    with pytest.raises(ValueError, match="requires an M2TransformerEncoder"):
        j_build(node, vocab_size=V)


def test_m2_never_reaches_the_fused_kernels(pair):
    """``select_decoder`` keeps its exact-type test: on a CUDA device an M2
    decoder, a ``TransformerDecoder`` subclass, still decodes through the
    torch engine (a plain function, no kernel decoder is built)."""
    _, _, port, _, _, _, _ = pair
    assert isinstance(port.decoder, TM.TransformerDecoder)
    for method in ("greedy", "beam"):
        fn = select_decoder(port, torch.device("cuda"), sample_method=method)
        assert fn.__name__ == "fn"
