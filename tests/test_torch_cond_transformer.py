"""The conditioned transformer decoders (``EventTransformerDecoder``,
``KeywordProbTransformerDecoder``) of the port against the JAX package's,
on the CPU.

  * each decoder alone (emb 32, 2 layers, 2 heads, 10 condition classes,
    weights from a numpy seed): the forward's logits within 1e-5 of
    JAX's with the condition and without it; the cached steps
    (``init_cache`` with the condition, then ``step``) equal to the
    forward and to JAX's steps within 1e-5;
  * each over a ``Cnn6Encoder`` built from one config dict in both
    packages (``test_torch_family.jax_pair``): the converted parameters
    are exactly the port's keys (none unknown, none missing); greedy and
    beam-3 tokens of ``generate(..., cond_kwargs={"event": ...})`` equal
    in float32, beam scores within 1e-5;
  * one XE step of a keyword captioner (a ``keyword`` batch, scheduled
    sampling off) against the JAX ``make_train_step`` by
    ``test_torch_train_step``'s floors, the encoder's unused fc head (a
    zero gradient, moved by the L2 term alone) included;
  * pins of the JAX behaviours the port keeps (ROADMAP Queue 3): K, the
    scheduled-sampling forward of a conditioned transformer drops the
    condition in both packages; L, the runner's val decode passes no
    condition; and a conditioned decoder never reaches the fused decode
    kernels (``decoding/select.py``), nor does an ensemble member get a
    condition (``decoding/ensemble.py``, equal to JAX's ensemble).
"""

import inspect

import flax.linen as fnn
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import audiocaption_tpu.cli.run as j_run
from audiocaption_tpu.decoding.ensemble import (
    ensemble_generate as j_ensemble)
from audiocaption_tpu.losses.loss import masked_token_loss as j_loss
from audiocaption_tpu.models import transformer_decoder as JTD
from audiocaption_tpu.models.captioner import generate as j_generate
from audiocaption_tpu.optim.schedules import (
    exponential_decay_with_warmup as j_schedule)
from audiocaption_tpu.training.trainer import (
    create_train_state as j_create_state, make_optimizer as j_optimizer,
    make_train_step)

from audiocaption_tpu_torch.cli.run import ValScorer
from audiocaption_tpu_torch.decoding.ensemble import ensemble_generate
from audiocaption_tpu_torch.decoding.fused_beam import FusedBeamDecoder
from audiocaption_tpu_torch.decoding.fused_greedy import FusedGreedyDecoder
from audiocaption_tpu_torch.decoding.select import (
    LoaderDecoder, select_decoder)
from audiocaption_tpu_torch.losses.loss import masked_token_loss
from audiocaption_tpu_torch.models import transformer_decoder as TD
from audiocaption_tpu_torch.models.captioner import generate
from audiocaption_tpu_torch.models.convert import (
    captioner_state_dict_from_jax, decoder_state_dict_from_jax)
from audiocaption_tpu_torch.optim.schedules import (
    exponential_decay_with_warmup)
from audiocaption_tpu_torch.training.checkpoint import model_variables
from audiocaption_tpu_torch.training.trainer import (
    create_train_state, train_step)

from test_torch_family import (
    V, clips, jax_batch, jax_pair, no_dropout, port_grads_space)
from test_torch_item8_wiring import random_variables
from test_torch_train_step import (
    B1, MISS_SHARE, PARAM_ATOL, _adam_state, _moment_tol, _report_close)

torch.set_num_threads(2)
E, C, S, D_MEM, L_CAP = 32, 10, 9, 24, 7
KINDS = ("EventTransformerDecoder", "KeywordProbTransformerDecoder")
LR, FINAL, TOTAL, WD, CLIP = 5e-4, 5e-7, 100, 1e-6, 1.0


def condition(B: int, seed: int, classes: int = C) -> np.ndarray:
    """Per-clip keyword / event probabilities: a few classes on, others
    at random small values (and one row all zero)."""
    rng = np.random.RandomState(seed)
    p = rng.rand(B, classes).astype(np.float32) * 0.2
    for i in range(B):
        p[i, rng.choice(classes, 2, replace=False)] = 1.0
    p[-1] = 0.0
    return p


def class_kw(kind: str) -> dict:
    return ({"event_classes": C} if kind == "EventTransformerDecoder"
            else {"keyword_classes_num": C})


# ----------------------------------------------------- decoders alone --

@pytest.fixture(scope="module", params=KINDS)
def dec_pair(request):
    """(kind, JAX decoder, its params, the port decoder in ``eval()``, the
    inputs as numpy)."""
    kind = request.param
    rng = np.random.RandomState(4)
    B = 3
    word = rng.randint(3, V, (B, L_CAP)).astype(np.int32)
    word[:, 0] = 1
    word[1, 5:] = 0                      # padding
    attn = rng.randn(B, S, D_MEM).astype(np.float32)
    attn_len = np.asarray([S, 6, 4], np.int32)
    ev = condition(B, 5)
    jdec = getattr(JTD, kind)(emb_dim=E, vocab_size=V, attn_emb_dim=D_MEM,
                              nlayers=2, nhead=2, dropout=0.2,
                              **class_kw(kind))
    params = random_variables(jdec, jnp.asarray(word), jnp.asarray(attn),
                              jnp.asarray(attn_len), seed=6,
                              init_kw={"event": jnp.asarray(ev)})["params"]
    port = getattr(TD, kind)(E, V, D_MEM, nlayers=2, nhead=2, dropout=0.2,
                             **class_kw(kind))
    port.load_state_dict(decoder_state_dict_from_jax(params, 2, False))
    return kind, jdec, params, port.eval(), dict(
        word=word, attn=attn, attn_len=attn_len, event=ev)


@pytest.mark.parametrize("with_cond", [True, False])
def test_forward_matches_jax(dec_pair, with_cond):
    kind, jdec, params, port, x = dec_pair
    pad = x["word"] == 0
    jkw = {"event": jnp.asarray(x["event"])} if with_cond else {}
    kw = {"event": torch.from_numpy(x["event"])} if with_cond else {}
    want = np.asarray(jdec.apply(
        {"params": params}, jnp.asarray(x["word"]), jnp.asarray(x["attn"]),
        jnp.asarray(x["attn_len"]), cap_padding_mask=jnp.asarray(pad),
        **jkw)["logit"])
    with torch.no_grad():
        got = port(torch.from_numpy(x["word"]).long(),
                   torch.from_numpy(x["attn"]),
                   torch.from_numpy(x["attn_len"]).long(),
                   cap_padding_mask=torch.from_numpy(pad), **kw)["logit"]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    if with_cond:
        with torch.no_grad():
            plain = port(torch.from_numpy(x["word"]).long(),
                         torch.from_numpy(x["attn"]),
                         torch.from_numpy(x["attn_len"]).long(),
                         cap_padding_mask=torch.from_numpy(pad))["logit"]
        assert float((plain - got).abs().max()) > 1e-2, \
            "the condition does not reach the logits"


def test_cached_steps_equal_forward_and_jax(dec_pair):
    """``init_cache(..., event=)`` then ``step`` over the teacher words:
    each step's logits equal the forward's at that position, and JAX's
    cached steps, within 1e-5."""
    kind, jdec, params, port, x = dec_pair
    word = x["word"].copy()
    word[word == 0] = 5                  # no padding in the cached walk
    ev = x["event"]
    with torch.no_grad():
        full = port(torch.from_numpy(word).long(),
                    torch.from_numpy(x["attn"]),
                    torch.from_numpy(x["attn_len"]).long(),
                    event=torch.from_numpy(ev))["logit"].numpy()
        static, dyn = port.init_cache(torch.from_numpy(x["attn"]),
                                      torch.from_numpy(x["attn_len"]).long(),
                                      L_CAP, event=torch.from_numpy(ev))
        assert "cond" in static
        steps = []
        for t in range(L_CAP):
            logit, dyn = port.step(torch.from_numpy(word[:, t]).long(), t,
                                   static, dyn)
            steps.append(logit.numpy())
    steps = np.stack(steps, 1)
    np.testing.assert_allclose(steps, full, atol=1e-5, rtol=0)
    jstatic, jdyn = jdec.apply(
        {"params": params}, jnp.asarray(x["attn"]),
        jnp.asarray(x["attn_len"]), L_CAP, event=jnp.asarray(ev),
        method=type(jdec).init_cache)
    jsteps = []
    for t in range(L_CAP):
        logit, jdyn = jdec.apply({"params": params}, jnp.asarray(word[:, t]),
                                 jnp.int32(t), jstatic, jdyn,
                                 method=type(jdec).step)
        jsteps.append(np.asarray(logit))
    np.testing.assert_allclose(steps, np.stack(jsteps, 1), atol=1e-5,
                               rtol=0)


# ------------------------------------------------ over an encoder --

def cond_node(kind: str) -> dict:
    return {"type": "captioning.models.transformer_model.TransformerModel",
            "encoder": {"type": "captioning.models.cnn_encoder.Cnn6Encoder",
                        "args": {"sample_rate": 32000}},
            "decoder": {"type": f"captioning.models.transformer_decoder."
                                f"{kind}",
                        "args": {"emb_dim": E, "nlayers": 2, "nhead": 2,
                                 "dropout": 0.2, **class_kw(kind)}}}


@pytest.fixture(scope="module", params=KINDS)
def cap_pair(request):
    b = clips(seed=3, B=4)
    ev = condition(4, 7)
    jmodel, jvars, port = jax_pair(cond_node(request.param), b, seed=1,
                                   cond={"event": ev})
    return request.param, jmodel, jvars, port, b, ev


def test_builder_and_converted_keys(cap_pair):
    """Both builders make the same decoder type from one node, and the
    converted JAX tree is exactly the port's key space."""
    kind, jmodel, jvars, port, _, _ = cap_pair
    assert type(port.decoder).__name__ == type(jmodel.decoder).__name__
    assert type(port.decoder) is getattr(TD, kind)
    got = set(captioner_state_dict_from_jax(jvars))
    want = set(model_variables(port))
    assert got == want, (sorted(got - want), sorted(want - got))


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_generate_with_condition_matches_jax(cap_pair, method):
    kind, jmodel, jvars, port, b, ev = cap_pair
    jb = jax_batch(b)
    want = j_generate(jmodel, jvars, jb["wav"], jb["wav_len"],
                      sample_method=method, beam_size=3, max_length=12,
                      cond_kwargs={"event": jnp.asarray(ev)})
    got = generate(port, torch.from_numpy(b["wav"]),
                   torch.from_numpy(b["wav_len"]), sample_method=method,
                   beam_size=3, max_length=12,
                   cond_kwargs={"event": torch.from_numpy(ev)})
    np.testing.assert_array_equal(got["seq"].numpy(),
                                  np.asarray(want["seq"]))
    if method == "beam":
        np.testing.assert_allclose(got["score"].numpy(),
                                   np.asarray(want["score"]), atol=1e-5,
                                   rtol=0)
    none = generate(port, torch.from_numpy(b["wav"]),
                    torch.from_numpy(b["wav_len"]), sample_method=method,
                    beam_size=3, max_length=12)["seq"]
    assert not torch.equal(none, got["seq"]), \
        "the condition does not move the decode"


# ----------------------------------------------------------- XE step --

@pytest.fixture(scope="module")
def xe_step():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return _xe_step()
    finally:
        torch.set_num_threads(threads)


def _xe_step():
    """One XE step of a keyword captioner (teacher forcing: JAX's
    ``use_ss=False``, the port's float 1.0) on a batch with a
    ``keyword``; dropout the identity on both sides."""
    b = clips(seed=5, B=3, Lc=8)
    b["keyword"] = condition(3, 9)
    jmodel, jvars, port = jax_pair(
        cond_node("KeywordProbTransformerDecoder"), b, seed=2,
        cond={"event": b["keyword"]})
    warm = TOTAL // 5
    tx = j_optimizer(LR, j_schedule(LR, FINAL, TOTAL, warm), WD, CLIP)
    jstate = j_create_state(jvars, tx, jax.random.PRNGKey(0))
    jstep = make_train_step(jmodel, j_loss("label_smoothing", 0.1), tx,
                            donate=False, use_ss=False)
    p_prev = port_grads_space(jvars["params"], jvars["params"],
                              jvars["batch_stats"])
    with fnn.intercept_methods(no_dropout):
        jstate, jm = jstep(jstate, jax_batch(b), jnp.float32(1.0))
    jm = jax.device_get(jm)
    state = create_train_state(
        port, LR, exponential_decay_with_warmup(LR, FINAL, TOTAL, warm),
        WD, CLIP)
    dropout = F.dropout
    F.dropout = lambda t, p=0.5, training=True, inplace=False: t
    try:
        m = train_step(state, masked_token_loss("label_smoothing", 0.1),
                       {k: torch.from_numpy(v) for k, v in b.items()})
    finally:
        F.dropout = dropout
    j_params = jax.device_get(jstate.params)
    j_stats = jax.device_get(jstate.batch_stats)
    adam = _adam_state(jax.device_get(jstate.opt_state))
    mu = port_grads_space(adam.mu, j_params, j_stats)
    nu = port_grads_space(adam.nu, j_params, j_stats)
    named = dict(port.named_parameters())
    coef = min(1.0, CLIP / (float(m["grad_norm"]) + 1e-6))
    unclip = max(1.0, float(jm["grad_norm"]) / CLIP)
    want = port_grads_space(j_params, j_params, j_stats)
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
            for n, p in named.items()},
        j_stats={k: v for k, v in want.items()
                 if k.endswith(("running_mean", "running_var"))},
        stats={"encoder." + k: v.numpy().copy()
               for k, v in port.encoder.state_dict().items()
               if k.endswith(("running_mean", "running_var"))})


def test_keyword_xe_step_loss_and_grads_match_jax(xe_step):
    s = xe_step
    assert not s["m"]["skipped"] and not bool(s["j"]["skipped"])
    np.testing.assert_allclose(float(s["m"]["loss"]), float(s["j"]["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(s["m"]["grad_norm"]),
                               float(s["j"]["grad_norm"]), rtol=1e-4)
    _report_close(s["grads"], s["j_grads"],
                  lambda w: 1e-4 * max(1.0, np.abs(w).max()), "gradients")
    # the keyword reached the step: its projection took gradients
    assert np.abs(s["grads"]["decoder.keyword_proj.weight"]).max() > 0
    assert np.abs(s["grads"]["decoder.word_keyword_norm.weight"]).max() > 0
    # the encoder's fc head feeds no transformer decoder: a zero gradient,
    # and its L2 term moves it in both packages (``train_step``)
    assert np.abs(s["grads"]["encoder.fc1.weight"]).max() == 0


def test_keyword_xe_step_params_moments_and_stats_match_jax(xe_step):
    s = xe_step
    _report_close(s["params"], s["j_params"], PARAM_ATOL, "parameters",
                  MISS_SHARE)
    _report_close(s["mu"], s["j_mu"], _moment_tol(s["j_mu"]), "Adam mu")
    _report_close(s["nu"], s["j_nu"], _moment_tol(s["j_nu"]), "Adam nu")
    _report_close(s["stats"], s["j_stats"],
                  lambda w: PARAM_ATOL * max(1.0, np.abs(w).max()),
                  "BN stats")


# --------------------------------------------------------------- pins --

def test_ss_forward_drops_the_condition_in_both_packages(cap_pair):
    """ROADMAP Queue 3 K: with scheduled sampling (ss_ratio below 1) a
    conditioned transformer's training forward equals the unconditioned
    one in JAX and in the port, while the teacher-forcing forward moves
    with the condition."""
    kind, jmodel, jvars, port, b, ev = cap_pair
    jb = jax_batch(b)

    def j_logit(ss, **cond):
        return np.asarray(jmodel.apply(
            jvars, jb["wav"], jb["wav_len"], jb["cap"], jb["cap_len"],
            ss_ratio=ss, train=False, cond_kwargs=cond or None,
            rngs={"sample": jax.random.PRNGKey(3)})["logit"])
    jev = {"event": jnp.asarray(ev)}
    np.testing.assert_array_equal(j_logit(jnp.float32(0.5), **jev),
                                  j_logit(jnp.float32(0.5)))
    assert np.abs(j_logit(1.0, **jev) - j_logit(1.0)).max() > 1e-3

    def logit(ss, **cond):
        with torch.no_grad():
            return port(torch.from_numpy(b["wav"]),
                        torch.from_numpy(b["wav_len"]),
                        torch.from_numpy(b["cap"]),
                        torch.from_numpy(b["cap_len"]), ss_ratio=ss,
                        generator=torch.Generator().manual_seed(3),
                        cond_kwargs=cond)["logit"]
    pev = {"event": torch.from_numpy(ev)}
    assert torch.equal(logit(torch.tensor(0.5), **pev),
                       logit(torch.tensor(0.5)))
    assert float((logit(1.0, **pev) - logit(1.0)).abs().max()) > 1e-3


def test_runner_val_decode_passes_no_condition(cap_pair):
    """ROADMAP Queue 3 L: the JAX runner hands no ``cond_kwargs`` to
    ``generate`` anywhere (its val score, ``evaluate``, ``predict``); the
    port's val score (``ValScorer`` through ``LoaderDecoder``) decodes a
    batch that carries a ``keyword`` as ``generate`` with no condition."""
    assert "cond_kwargs" not in inspect.getsource(j_run)
    kind, _, _, port, b, ev = cap_pair
    batch = {"audio_id": [f"a{i}" for i in range(4)],
             "wav": b["wav"], "wav_len": b["wav_len"], "keyword": ev}
    dec = LoaderDecoder(port, torch.device("cpu"))
    dec.decode_loader(_Tok(), [batch], sample_method="greedy",
                      max_length=12)
    wav, wav_len = (torch.from_numpy(b["wav"]),
                    torch.from_numpy(b["wav_len"]))
    plain = generate(port, wav, wav_len, max_length=12)["seq"].numpy()
    cond = generate(port, wav, wav_len, max_length=12, cond_kwargs={
        "event": torch.from_numpy(ev)})["seq"].numpy()
    np.testing.assert_array_equal(np.concatenate(dec.last_seq), plain)
    assert not np.array_equal(plain, cond)
    assert "cond_kwargs" not in inspect.getsource(ValScorer)


class _Tok:
    def decode(self, seq):
        return [" ".join(map(str, s)) for s in np.asarray(seq)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_conditioned_decoders_never_reach_the_kernels(kind, method):
    """``select_decoder`` on CUDA sends the exact type
    ``TransformerDecoder`` only to the fused kernels; a conditioned
    decoder decodes on the torch engine, as in JAX (no TPU kernel takes a
    condition).  (The choice is made before any kernel is built, so it
    is read here without a card.)"""
    port = built(kind)
    fn = select_decoder(port, torch.device("cuda"), sample_method=method,
                        beam_size=3)
    assert not isinstance(fn, (FusedGreedyDecoder, FusedBeamDecoder))
    assert type(port.decoder) is not TD.TransformerDecoder


def built(kind):
    from audiocaption_tpu_torch.utils.config import build_model_from_config
    return build_model_from_config(cond_node(kind), vocab_size=V)[0].eval()


def test_ensemble_member_takes_no_condition(cap_pair):
    """An ensemble of a conditioned captioner and itself decodes as
    ``generate`` with no condition, and as the JAX ensemble does."""
    kind, jmodel, jvars, port, b, ev = cap_pair
    jb = jax_batch(b)
    wav, wav_len = (torch.from_numpy(b["wav"]),
                    torch.from_numpy(b["wav_len"]))
    got = ensemble_generate([port, port], wav, wav_len,
                            sample_method="beam", beam_size=3,
                            max_length=12)["seq"].numpy()
    plain = generate(port, wav, wav_len, sample_method="beam", beam_size=3,
                     max_length=12)["seq"].numpy()
    want = np.asarray(j_ensemble([jmodel, jmodel], [jvars, jvars],
                                 jb["wav"], jb["wav_len"],
                                 sample_method="beam", beam_size=3,
                                 max_length=12)["seq"])
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, want)
