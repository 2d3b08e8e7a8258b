"""The 32 kHz captioner family built from config dicts in both packages
(``utils/config.py::build_model_from_config``), on the CPU.

  * every encoder type the port's builder takes, and every GRU decoder at
    one and two layers: the same parameter count as the JAX builder's
    model (flax shapes by ``jax.eval_shape``), the same memory widths and
    mel preset;
  * the whole slice: the model of ``chip_smoke.py`` phase 27(b) (a
    ``Cnn10Encoder`` and a 2-layer ``BahAttnAddFcDecoder`` at emb and
    d_model 512) from one config in both packages, the JAX variables
    (flax init, BN statistics from one train-mode pass over the batch,
    decoder tensors jittered by their own spread) carried across by
    ``models.convert.captioner_state_dict_from_jax``: greedy and beam-3
    tokens on 4 clips of at most 1 s equal, beam scores within 1e-5;
  * one XE step with scheduled sampling on (the coin fixed at "model"
    words) of a 2-layer ``BahAttnAddFcDecoder`` over a ``Cnn6Encoder``
    (emb and d_model 32) against the JAX ``make_train_step`` (dropout the
    identity on both sides), by ``test_torch_train_step``'s floors: loss
    relative 1e-5, raw gradient norm relative 1e-4, gradients
    1e-4 * max(1, max |g|) per tensor, Adam moments 1e-4 of each tensor's
    largest (floor 1e-2 of the model's), parameters 1e-5 (0.1% may
    miss), BN statistics 1e-5.

The helpers (``model_node``, ``jax_pair``, ``clips``) serve the SCST and
ensemble tests of the GRU decoders as well."""

import flax.linen as fnn
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from audiocaption_tpu.losses.loss import masked_token_loss as j_loss
from audiocaption_tpu.models.captioner import generate as j_generate
from audiocaption_tpu.optim.schedules import (
    exponential_decay_with_warmup as j_schedule)
from audiocaption_tpu.training.trainer import (
    create_train_state as j_create_state, make_optimizer as j_optimizer,
    make_train_step)
from audiocaption_tpu.utils.config import (
    build_model_from_config as j_build)

from audiocaption_tpu_torch.losses.loss import masked_token_loss
from audiocaption_tpu_torch.models.captioner import generate
from audiocaption_tpu_torch.models.convert import (
    captioner_state_dict_from_jax, load_reference_state_dict)
from audiocaption_tpu_torch.optim.schedules import (
    exponential_decay_with_warmup)
from audiocaption_tpu_torch.training.trainer import (
    create_train_state, train_step)
from audiocaption_tpu_torch.utils.config import (
    RNN_DECODERS, build_model_from_config)

from test_torch_train_step import (
    B1, MISS_SHARE, PARAM_ATOL, _adam_state, _moment_tol, _report_close)

torch.set_num_threads(2)
SR = 32000
V = 40


def model_node(enc_type: str = "Cnn10Encoder",
               dec_type: str = "BahAttnAddFcDecoder", emb: int = 512,
               d_model: int = 512, num_layers: int = 2,
               dropout: float = 0.0, enc: dict = None) -> dict:
    node = {"type": "captioning.models.seq2seq.Seq2SeqAttnModel",
            "encoder": {"type": f"captioning.models.cnn_encoder.{enc_type}",
                        "args": {"sample_rate": SR}},
            "decoder": {"type": f"captioning.models.rnn_decoder.{dec_type}",
                        "args": {"emb_dim": emb, "d_model": d_model,
                                 "num_layers": num_layers,
                                 "dropout": dropout}}}
    if enc:
        node["encoder"].update(enc)
    return node


def clips(seed: int = 3, B: int = 4, Lc: int = 7) -> dict:
    """B clips of at most 1 s, each its own sound (a tone at its own pitch
    over noise at its own level), and <bos> words <eos> captions."""
    rng = np.random.RandomState(seed)
    t = np.arange(SR) / SR
    wav = np.stack([0.3 * np.sin(2 * np.pi * 200 * 2 ** (i % 4) * t)
                    + rng.randn(SR) * 0.05 * (i + 1) for i in range(B)])
    wav_len = np.asarray([SR, 27000, 21000, 16000, 30000, 24000][:B],
                         np.int64)
    for i, n in enumerate(wav_len):
        wav[i, n:] = 0.0
    cap_len = np.asarray([Lc, Lc - 2, Lc - 3, Lc - 1, Lc, Lc - 2][:B],
                         np.int64)
    cap = np.zeros((B, Lc), np.int64)
    for i, n in enumerate(cap_len):
        cap[i, 0], cap[i, n - 1] = 1, 2
        cap[i, 1:n - 1] = rng.randint(3, V, n - 2)
    return {"wav": wav.astype(np.float32), "wav_len": wav_len, "cap": cap,
            "cap_len": cap_len}


def jax_batch(b: dict) -> dict:
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64
                           else v) for k, v in b.items()}


def no_dropout(next_fun, args, kwargs, context):
    """``intercept_methods`` hook: every flax ``Dropout`` is the identity."""
    if isinstance(context.module, fnn.Dropout) and \
            context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def jax_pair(node: dict, b: dict, seed: int = 0, dec_jitter: float = 1.0,
             cond: dict = None, vocab: int = V):
    """-> (JAX model, its variables, the port model in ``eval()`` on the
    same weights).  flax init; every BN's statistics those of one
    train-mode pass over ``b`` (dropout off; solved from flax's running
    average at momentum 0.9); each decoder tensor jittered by
    ``dec_jitter`` times its own standard deviation, from a numpy seed
    (an absolute jitter turns a 512-wide GRU chaotic: float32 rounding
    alone then flips late tokens)."""
    jmodel, _ = j_build(node, vocab_size=vocab)
    jb = jax_batch(b)
    cond = {k: jnp.asarray(c) for k, c in (cond or {}).items()}
    v = jax.device_get(jmodel.init(
        {"params": jax.random.PRNGKey(seed),
         "sample": jax.random.PRNGKey(1)}, jb["wav"], jb["wav_len"],
        jb["cap"], jb["cap_len"], train=False, cond_kwargs=cond))

    def calib(v_):
        with fnn.intercept_methods(no_dropout):
            return jmodel.apply(v_, jb["wav"], jb["wav_len"], jb["cap"],
                                jb["cap_len"], train=True,
                                mutable=["batch_stats"], cond_kwargs=cond,
                                rngs={"sample": jax.random.PRNGKey(2),
                                      "dropout": jax.random.PRNGKey(3)})
    _, upd = jax.device_get(jax.jit(calib)(v))
    stats = jax.tree_util.tree_map(
        lambda new, old: ((np.asarray(new) - 0.9 * np.asarray(old)) / 0.1
                          ).astype(np.float32),
        upd["batch_stats"], v["batch_stats"])
    rng = np.random.RandomState(seed + 50)
    params = dict(jax.tree_util.tree_map(np.asarray, v["params"]))
    params["decoder"] = jax.tree_util.tree_map(
        lambda a: a + dec_jitter * (np.std(a) if a.size > 1 else 1.0)
        * rng.randn(*a.shape).astype(np.float32), params["decoder"])
    jvars = {"params": params, "batch_stats": stats}
    port, _ = build_model_from_config(node, vocab_size=vocab)
    load_reference_state_dict(port, captioner_state_dict_from_jax(jvars))
    return jmodel, jvars, port.eval()


def port_grads_space(tree, params, stats) -> dict:
    """A params-shaped JAX tree (masked leaves as zeros) in the port's
    key space (``encoder.*``, ``decoder.*``), as numpy."""
    tree = jax.tree_util.tree_map(
        lambda t, p: np.zeros(np.shape(p), np.float32)
        if isinstance(t, optax.MaskedNode) else np.asarray(t),
        tree, params, is_leaf=lambda x: isinstance(x, optax.MaskedNode))
    sd = captioner_state_dict_from_jax({"params": tree,
                                        "batch_stats": stats})
    return {k: t.numpy() for k, t in sd.items()}


# ------------------------------------------------------------ builder --

ENC_TYPES = ["Cnn6Encoder", "Cnn10Encoder", "MobileNetV2", "Cdur5Encoder",
             "Cdur8Encoder", "Cnn14Encoder", "Cnn14TransformerEncoder"]


def _counts(node):
    jmodel, _ = j_build(node, vocab_size=V)
    b = jax_batch(clips(B=2))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        b["wav"], b["wav_len"], b["cap"], b["cap_len"], train=False))
    # the transformer decoder's positional table is a JAX parameter and
    # a port buffer
    n_jax = {part: sum(int(np.prod(x.shape)) for path, x in
                       jax.tree_util.tree_leaves_with_path(
                           shapes["params"][part])
                       if getattr(path[-1], "key", None) != "pe")
             for part in ("encoder", "decoder")}
    port, _ = build_model_from_config(node, vocab_size=V)
    n_port = {part: sum(p.numel() for p in getattr(port, part).parameters())
              for part in ("encoder", "decoder")}
    return n_jax, n_port, jmodel, port


@pytest.mark.parametrize("enc_type", ENC_TYPES)
def test_builder_encoders_match_jax(enc_type):
    enc = ({"transformer": {"args": {"d_model": 256, "nlayers": 2}}}
           if enc_type == "Cnn14TransformerEncoder" else None)
    node = model_node(enc_type, "BahAttnCatFcDecoder", 16, 16, 1, enc=enc)
    n_jax, n_port, jmodel, port = _counts(node)
    assert n_port == n_jax
    assert port.mel.sample_rate == jmodel.mel.sample_rate
    assert port.mel.n_mels == jmodel.mel.n_mels


@pytest.mark.parametrize("dec_type", RNN_DECODERS)
@pytest.mark.parametrize("num_layers", [1, 2])
def test_builder_decoders_match_jax(dec_type, num_layers):
    node = model_node("Cdur5Encoder", dec_type, 24, 16, num_layers)
    n_jax, n_port, _, port = _counts(node)
    assert n_port == n_jax
    assert port.decoder.num_layers == num_layers


def test_builder_transformer_decoder_on_a_new_encoder():
    node = model_node("MobileNetV2", "BahAttnCatFcDecoder")
    node["decoder"] = {"type": "TransformerDecoder",
                       "args": {"emb_dim": 64, "nlayers": 1}}
    n_jax, n_port, _, port = _counts(node)
    assert n_port == n_jax
    # the memory is the encoder's 1280-wide attn_emb, not its fc_emb
    assert port.decoder.attn_proj[0].in_features == 1280


# -------------------------------------------------------- whole slice --

@pytest.fixture(scope="module")
def slice_pair():
    b = clips()
    return (*jax_pair(model_node(), b), b)


@pytest.mark.parametrize("method", [dict(sample_method="greedy"),
                                    dict(sample_method="beam", beam_size=3)],
                         ids=["greedy", "beam3"])
def test_slice_decodes_as_jax(slice_pair, method):
    jmodel, jvars, port, b = slice_pair
    want = jax.device_get(jax.jit(lambda v, w, n: j_generate(
        jmodel, v, w, n, max_length=12, **method))(
            jvars, jnp.asarray(b["wav"]),
            jnp.asarray(b["wav_len"].astype(np.int32))))
    got = generate(port, torch.from_numpy(b["wav"]),
                   torch.from_numpy(b["wav_len"]), max_length=12, **method)
    np.testing.assert_array_equal(got["seq"].numpy(), np.asarray(want["seq"]))
    assert len(np.unique(want["seq"])) > 2
    if "score" in want:
        np.testing.assert_allclose(got["score"].numpy(),
                                   np.asarray(want["score"]), atol=1e-5,
                                   rtol=0)


# ------------------------------------------------------------ XE step --

LR, FINAL, TOTAL, WD, CLIP = 5e-4, 5e-7, 100, 1e-6, 1.0


XE_THREADS = 2


@pytest.fixture(scope="module")
def xe_step():
    """The XE step at XE_THREADS torch CPU threads (set here and restored
    after): the float32 sums of the step, and so how near its floors it
    lands, follow the thread count, which other test modules set at
    import."""
    threads = torch.get_num_threads()
    torch.set_num_threads(XE_THREADS)
    try:
        return _xe_step()
    finally:
        torch.set_num_threads(threads)


def _xe_step():
    b = clips(seed=5, B=3, Lc=8)
    node = model_node("Cnn6Encoder", "BahAttnAddFcDecoder", 32, 32, 2)
    jmodel, jvars, port = jax_pair(node, b, seed=2)
    warm = TOTAL // 5
    tx = j_optimizer(LR, j_schedule(LR, FINAL, TOTAL, warm), WD, CLIP)
    jstate = j_create_state(jvars, tx, jax.random.PRNGKey(0))
    jstep = make_train_step(jmodel, j_loss("label_smoothing", 0.1), tx,
                            donate=False, use_ss=True)
    p_prev = port_grads_space(jvars["params"], jvars["params"],
                              jvars["batch_stats"])
    with fnn.intercept_methods(no_dropout):
        jstate, jm = jstep(jstate, jax_batch(b), jnp.float32(0.0))
    jm = jax.device_get(jm)
    state = create_train_state(
        port, LR, exponential_decay_with_warmup(LR, FINAL, TOTAL, warm),
        WD, CLIP)
    dropout = F.dropout
    F.dropout = lambda t, p=0.5, training=True, inplace=False: t
    try:
        m = train_step(state, masked_token_loss("label_smoothing", 0.1),
                       {k: torch.from_numpy(v) for k, v in b.items()},
                       ss_ratio=torch.tensor(0.0),
                       generator=torch.Generator())
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


def test_xe_step_loss_and_grads_match_jax(xe_step):
    s = xe_step
    assert not s["m"]["skipped"] and not bool(s["j"]["skipped"])
    np.testing.assert_allclose(float(s["m"]["loss"]), float(s["j"]["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(s["m"]["grad_norm"]),
                               float(s["j"]["grad_norm"]), rtol=1e-4)
    _report_close(s["grads"], s["j_grads"],
                  lambda w: 1e-4 * max(1.0, np.abs(w).max()), "gradients")
    # the GRU stack's second layer and the attention took gradients
    assert np.abs(s["grads"]["decoder.model.weight_hh_l1"]).max() > 0
    assert np.abs(s["grads"]["decoder.attn_proj.weight"]).max() > 0


def test_xe_step_params_moments_and_stats_match_jax(xe_step):
    s = xe_step
    _report_close(s["params"], s["j_params"], PARAM_ATOL, "parameters",
                  MISS_SHARE)
    _report_close(s["mu"], s["j_mu"], _moment_tol(s["j_mu"]), "Adam mu")
    _report_close(s["nu"], s["j_nu"], _moment_tol(s["j_nu"]), "Adam nu")
    # relative: bn0's running variance is that of a dB log-mel (~1e2)
    _report_close(s["stats"], s["j_stats"],
                  lambda w: PARAM_ATOL * max(1.0, np.abs(w).max()),
                  "BN stats")
