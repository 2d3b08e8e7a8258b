"""One train step of the temporal family in the port against the JAX
package, on the CPU, under the floors of ``test_torch_train_step.py``.

(a) The tag-conditioned captioner (Cnn14 -> BiGRU -> ``TemporalBahAttn
Decoder``, narrow: GRU 16, decoder 24) through ``train_step`` and the JAX
``make_train_step`` (``use_ss=True``) on the same weights and batch, the
recipe's label smoothing 0.1, Adam 5e-4 with L2 1e-6, clip 1.0, the
schedule with warm-up; ``ss_ratio`` 1.0 (every coin "teacher") and 0.0
(every step fed the previous greedy word), each from the same start.
The CNN's BN is frozen (``freeze_cnn_bn``: no dropout, BN on its
statistics; the CNN trains), the GRU and decoder dropout 0, so both
forwards are deterministic.  Loss relative 1e-5, raw gradient norm
relative 1e-4, every trained parameter after the step within 1e-5 with
at most 0.1% of elements over (Adam's first step divides gradients near
float32 noise).  This step caught the input BN's gradient fault that
``layers.batch_norm_mels`` now avoids (its view of the log-mel looked
channels-last to the CPU batch-norm backward, which then read the
incoming gradient in the wrong order).

(b) One SED step (``training/sed_trainer.py::sed_train_step``, the JAX
``make_sed_train_step``): BCE at the segmentwise resolution against
4 -> 1 max-pooled targets, Adam 1e-3, BN on batch statistics.  The JAX
SED's dropout is hard-wired in train mode, so both packages run it at
rate 0 here (the JAX ``Dropout`` and the port's ``F.dropout`` patched to
the identity for the test); loss relative 1e-5, parameters and BN
running statistics as in (a).

(c) The RNN training forward feeds ``cap[:, t]`` at every step for the
float 1.0 and the previous step's greedy word for a ratio of 0.0: held by
replaying the decoder's steps (logits within 1e-6, the greedy words
equal)."""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from audiocaption_tpu.losses.loss import masked_token_loss as j_loss
from audiocaption_tpu.models.rnn_decoder import convert_bahattn_decoder
from audiocaption_tpu.models.rnn_encoder import convert_cnn14_rnn
from audiocaption_tpu.optim.schedules import (
    exponential_decay_with_warmup as j_schedule)
from audiocaption_tpu.training.trainer import (
    create_train_state as j_create_state, make_optimizer as j_optimizer,
    make_train_step)
from audiocaption_tpu.utils.config import build_model_from_config as j_build

from audiocaption_tpu_torch.losses.loss import masked_token_loss
from audiocaption_tpu_torch.models import sed as port_sed
from audiocaption_tpu_torch.models.convert import sed_state_dict_from_jax
from audiocaption_tpu_torch.models.zoo import random_init
from audiocaption_tpu_torch.optim.schedules import (
    exponential_decay_with_warmup)
from audiocaption_tpu_torch.training.checkpoint import (
    jax_variables_to_reference, model_variables)
from audiocaption_tpu_torch.training.sed_trainer import (
    framewise_targets, sed_train_step)
from audiocaption_tpu_torch.training.trainer import (
    create_train_state, train_step)
from audiocaption_tpu_torch.utils.config import build_model_from_config

from test_torch_cnn14rnn_trm import jitter

torch.set_num_threads(2)

V, SR, B, LC = 30, 32000, 3, 7
LR, FINAL, TOTAL, WD, CLIP = 5e-4, 5e-7, 100, 1e-6, 1.0
PARAM_ATOL, MISS_SHARE = 1e-5, 1e-3
MODEL = {
    "type": "captioning.models.TemporalSeq2SeqAttnModel",
    "encoder": {"type": "Cnn14RnnEncoder",
                "args": {"freeze_cnn_bn": True},
                "cnn": {"args": {"sample_rate": 32000}},
                "rnn": {"args": {"bidirectional": True, "hidden_size": 16,
                                 "num_layers": 1, "dropout": 0.0}}},
    "decoder": {"type": "TemporalBahAttnDecoder",
                "args": {"emb_dim": 16, "fc_emb_dim": 32,
                         "attn_emb_dim": 32, "d_model": 24,
                         "dropout": 0.0}}}


def port_captioner():
    model, _ = build_model_from_config(MODEL, vocab_size=V)
    random_init(model, torch.Generator().manual_seed(0))
    jitter(model, 1)
    return model


def jax_captioner_variables(port):
    enc = {k: v.numpy().copy() for k, v in port.encoder.state_dict().items()}
    dec = {k: v.numpy().copy() for k, v in port.decoder.state_dict().items()}
    p_enc, s_enc = convert_cnn14_rnn(enc, rnn_num_layers=1)
    p_dec = convert_bahattn_decoder(dec, temporal=True)
    return {"params": {"encoder": p_enc, "decoder": p_dec},
            "batch_stats": {"encoder": s_enc}}


def make_batch():
    rng = np.random.RandomState(5)
    wav = (rng.randn(B, SR) * 0.1).astype(np.float32)
    wav_len = np.asarray([SR, SR, SR], np.int64)
    for b in range(B):
        wav[b, wav_len[b]:] = 0.0
    cap = np.zeros((B, LC), np.int64)
    cap_len = np.asarray([LC, 5, 4])
    for b in range(B):
        n = cap_len[b]
        cap[b, 0], cap[b, n - 1] = 1, 2
        cap[b, 1:n - 1] = rng.randint(4, V, n - 2)
    tag = np.asarray([0, 2, 3], np.int64)
    return dict(wav=wav, wav_len=wav_len, cap=cap, cap_len=cap_len,
                temporal_tag=tag)


def _close_share(got, want, what):
    """Every tensor within PARAM_ATOL, at most MISS_SHARE of elements over."""
    n = over = 0
    worst = 0.0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        d = np.abs(np.asarray(got[k], np.float64) - np.asarray(w))
        n += d.size
        over += int((d > PARAM_ATOL).sum())
        worst = max(worst, float(d.max()))
    print(f"{what}: largest difference {worst:.3g}, "
          f"{over}/{n} elements over {PARAM_ATOL}")
    assert over <= MISS_SHARE * n, what
    return n


@pytest.fixture(scope="module")
def captioner_steps():
    jmodel, _ = j_build(MODEL, vocab_size=V)
    warm = TOTAL // 5
    tx = j_optimizer(LR, j_schedule(LR, FINAL, TOTAL, warm), WD, CLIP)
    jstep = make_train_step(jmodel, j_loss("label_smoothing", 0.1), tx,
                            donate=False, use_ss=True)
    b = make_batch()
    jb = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
          for k, v in b.items()}
    out = {}
    for ss in (1.0, 0.0):
        port = port_captioner()
        jvars = jax_captioner_variables(port)
        jstate = j_create_state(jvars, tx, jax.random.PRNGKey(0))
        jstate, jm = jstep(jstate, jb, jnp.float32(ss))
        jm = jax.device_get(jm)
        state = create_train_state(
            port, LR, exponential_decay_with_warmup(LR, FINAL, TOTAL, warm),
            WD, CLIP)
        m = train_step(state, masked_token_loss("label_smoothing", 0.1),
                       {k: torch.from_numpy(v) for k, v in b.items()},
                       ss_ratio=torch.tensor(ss),
                       generator=torch.Generator().manual_seed(3))
        want = jax_variables_to_reference(jax.device_get(
            {"params": jstate.params, "batch_stats": jstate.batch_stats}))
        out[ss] = dict(j_loss=float(jm["loss"]), j_norm=float(jm["grad_norm"]),
                       loss=float(m["loss"]), norm=float(m["grad_norm"]),
                       skipped=m["skipped"], want=want,
                       got=model_variables(port))
    return out


@pytest.mark.parametrize("ss", [1.0, 0.0], ids=["teacher", "model_words"])
def test_rnn_ss_step_loss_and_norm_match_jax(captioner_steps, ss):
    r = captioner_steps[ss]
    assert not r["skipped"]
    assert r["loss"] == pytest.approx(r["j_loss"], rel=1e-5)
    assert r["norm"] == pytest.approx(r["j_norm"], rel=1e-4)
    assert r["j_norm"] > CLIP      # the clip acts


@pytest.mark.parametrize("ss", [1.0, 0.0], ids=["teacher", "model_words"])
def test_rnn_ss_step_params_match_jax(captioner_steps, ss):
    r = captioner_steps[ss]
    assert set(r["got"]) == set(r["want"])
    # the Cnn14's fc1, unused by the GRU encoder: torch's Adam leaves a
    # parameter without a gradient alone, where optax's decayed-weight
    # term still moves it
    trained = {k: w for k, w in r["want"].items()
               if not k.startswith("encoder.cnn.fc1.")}
    assert _close_share(r["got"], trained, f"params, ss {ss}") > 1e6


def test_rnn_forward_feeds_teacher_or_greedy_words():
    """ss 1.0 (the Python float) feeds cap[:, t], ss 0.0 each step's
    previous greedy word: held by a replay of the decoder's steps."""
    port = port_captioner().eval()
    b = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    with torch.no_grad():
        enc = port.encode(b["wav"], b["wav_len"])
        for ss in (1.0, torch.tensor(0.0)):
            out = port(b["wav"], b["wav_len"], b["cap"], b["cap_len"],
                       ss_ratio=ss, generator=torch.Generator(),
                       temporal_tag=b["temporal_tag"])
            static, dyn = port.decoder.init_cache(
                enc["attn_emb"], enc["attn_emb_len"], enc["fc_emb"], LC - 1,
                temporal_tag=b["temporal_tag"])
            prev = b["cap"][:, 0]
            for t in range(LC - 1):
                word = b["cap"][:, t] if isinstance(ss, float) else prev
                logit, dyn = port.decoder.step(word, t, static, dyn)
                torch.testing.assert_close(out["logit"][:, t], logit,
                                           rtol=0, atol=1e-6)
                prev = logit.argmax(-1)
                assert torch.equal(out["seq"][:, t], prev)


# ------------------------------------------------------------------ SED --

@pytest.fixture(scope="module")
def sed_step():
    import optax
    from audiocaption_tpu.models import sed as jsed
    from audiocaption_tpu.training.sed_trainer import make_sed_train_step
    from test_torch_effb2 import jitter_bn

    class Identity:
        def __init__(self, *args, **kwargs):
            pass

        def __call__(self, x):
            return x
    rng = np.random.RandomState(0)
    lms = (rng.randn(4, 200, 64) * 10 - 30).astype(np.float32)
    segs = [[[1, 0.2, 1.1]], [[0, 0.1, 0.9], [3, 0.5, 1.9]], [],
            [[7, 1.0, 2.0]]]
    y = np.stack([framewise_targets(s, 200, 8) for s in segs])
    jmodel = jsed.Cnn8RnnSedModel(classes_num=8)
    v = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 200, 64))))
    v = {"params": dict(v["params"]), "batch_stats": dict(v["batch_stats"])}
    jitter_bn(v["params"], v["batch_stats"], rng)
    port = port_sed.Cnn8RnnSedModel(classes_num=8)
    port.load_state_dict({k: torch.as_tensor(np.array(a)) for k, a in
                          sed_state_dict_from_jax(v).items()})
    tx = optax.adam(1e-3)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jsed.nn, "Dropout", Identity)
        mp.setattr(port_sed, "F", types.SimpleNamespace(
            dropout=lambda x, p, training: x, relu=F.relu))
        step = make_sed_train_step(jmodel, tx)
        _, jv, jl = step(tx.init(v["params"]), v,
                         jnp.asarray(lms, jnp.float16), jnp.asarray(y),
                         jnp.arange(4), jax.random.PRNGKey(1))
        opt = torch.optim.Adam(port.parameters(), lr=1e-3)
        loss = sed_train_step(port, opt,
                              torch.from_numpy(lms).half(),
                              torch.from_numpy(y), torch.arange(4))
    finally:
        mp.undo()
    want = sed_state_dict_from_jax(jax.device_get(jv))
    got = {k: t.detach().numpy() for k, t in port.state_dict().items()}
    return float(jl), float(loss), got, want


def test_sed_step_loss_matches_jax(sed_step):
    j_l, loss, _, _ = sed_step
    assert loss == pytest.approx(j_l, rel=1e-5)


def test_sed_step_params_and_bn_stats_match_jax(sed_step):
    _, _, got, want = sed_step
    assert set(got) == set(want)
    assert _close_share(got, want, "SED params and BN statistics") > 1e6


def test_sed_targets_pool_to_segments():
    """A frame-level event marks its 4-frame segment positive (the max
    pool), and nothing else."""
    from audiocaption_tpu_torch.training.sed_trainer import sed_loss

    class Fixed(torch.nn.Module):
        interpolate_ratio = 4

        def forward(self, lms):
            return {"segmentwise_output": torch.full((1, 5, 2), 0.5)}
    y = torch.from_numpy(framewise_targets([[1, 0.05, 0.06]], 20, 2))[None]
    base = sed_loss(Fixed(), None, y)
    # every element's BCE at p=0.5 is log 2, pooled or not
    assert float(base) == pytest.approx(np.log(2), rel=1e-6)
    seg = y[:, :20].reshape(1, 5, 4, 2).amax(2)
    assert seg.sum() == 1 and seg[0, 1, 1] == 1
