"""The port's Cdur5 encoder and KD student (``zoo.kd_student_cdur5``)
against the JAX package's, on 2 clips of at most 1 s at 32 kHz, with a
small vocabulary (60).  The port model is drawn from a seed, its BN
running statistics set from one train-mode pass over a separate batch
(BN1 sees the raw dB log-mel: through identity statistics the features
reach the GRU hundreds of times too large and saturate it, where float32
noise alone moves ``attn_emb`` by ~1e-5), its BN affine parameters
jittered and its decoder matrices jittered by 0.3; the JAX variables come
from it through the JAX package's own torch -> flax helpers
(``models/convert.py``, ``convert_transformer_decoder``).

  * ``lp_pool`` against the JAX ``lp_pool``: rtol 1e-6 (its sum is the
    window mean times the area);
  * the Cdur5 encoder's eval forward (``attn_emb``, ``fc_emb``) and the
    student's teacher-forced logits: within 1e-5 (absolute, scaled by
    max(1, max |JAX|));
  * one train-mode forward: every BN's running statistics after it
    against JAX ``batch_stats``: relative 1e-5 (torch momentum 0.1 = flax
    0.9); its output within 1e-4 (the batch statistics' float32 sums
    differ in order, as in ``test_torch_train_forward``).  Dropout is
    the identity on the JAX side (``flax.linen.intercept_methods``) and
    p=0 in the port;
  * ``cdur5_trm_state_dict_from_jax`` equals the JAX exporters' helpers'
    output key for key; a JAX-written KD-student checkpoint loads through
    ``load_checkpoint`` into a fresh port model equal to the original,
    and a port-written one round-trips bit for bit;
  * ``build_model_from_config`` on ``configs/synthetic_v2/kd_token.yaml``
    builds the student that the JAX package's builds (parameter count,
    memory width, mel preset)."""

from pathlib import Path

import flax.linen as fnn
import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from audiocaption_tpu.models import convert as jconvert
from audiocaption_tpu.models import export
from audiocaption_tpu.models import zoo as jzoo
from audiocaption_tpu.models.captioner import Captioner as JCaptioner
from audiocaption_tpu.models.encoders_extra import lp_pool as j_lp_pool
from audiocaption_tpu.models.transformer_decoder import (
    convert_transformer_decoder)
from audiocaption_tpu.training.checkpoint import (
    save_checkpoint as j_save_checkpoint)
from audiocaption_tpu.utils.config import (
    build_model_from_config as j_build, load_config as j_load_config)

from audiocaption_tpu_torch.models.convert import (
    cdur5_trm_state_dict_from_jax, load_reference_state_dict)
from audiocaption_tpu_torch.models.encoders_extra import (
    Cdur5Encoder, lp_pool)
from audiocaption_tpu_torch.models.zoo import kd_student_cdur5, random_init
from audiocaption_tpu_torch.training.checkpoint import (
    load_checkpoint, model_variables, save_checkpoint)
from audiocaption_tpu_torch.utils.config import (
    build_model_from_config, load_config)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
V, SR = 60, 32000
WAV_LEN = np.asarray([SR, 21000], np.int64)


def calibrate_and_jitter(model: nn.Module, seed: int,
                         decoder_scale: float = 0.3) -> None:
    """Every encoder BN's running statistics from one train-mode pass over
    a batch drawn from ``seed`` (the model left in ``eval()``), then the
    BN affine parameters and the decoder's matrices jittered from the
    same numpy seed."""
    bns = [m for m in model.encoder.modules()
           if isinstance(m, nn.BatchNorm2d)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None             # a cumulative average: one batch
    b = make_batch(seed=seed)
    model.train()
    with torch.no_grad():
        model.encode(torch.from_numpy(b["wav"]),
                     torch.from_numpy(b["wav_len"]))
    model.eval()
    for m in bns:
        m.momentum = 0.1
    rng = np.random.RandomState(seed)

    def rand(shape, scale, offset=0.0):
        return torch.from_numpy(
            (offset + rng.randn(*shape) * scale).astype(np.float32))
    with torch.no_grad():
        for m in bns:
            n = (m.num_features,)
            m.weight.copy_(rand(n, 0.2, 1.0))
            m.bias.copy_(rand(n, 0.2))
        for p in model.decoder.parameters():
            if p.dim() == 2:
                p.add_(rand(p.shape, decoder_scale))


def port_student(seed: int = 0, vocab: int = V, dropout: float = 0.0):
    """The port KD student, seeded, calibrated and jittered, every dropout
    at ``dropout``, in ``eval()``."""
    m = kd_student_cdur5(vocab_size=vocab, decoder_dropout=dropout)
    m.encoder.dropout = dropout
    random_init(m, torch.Generator().manual_seed(seed))
    calibrate_and_jitter(m, seed + 101)
    return m


def jax_encoder_variables(enc_sd: dict):
    """The port Cdur5's state dict (numpy) -> JAX (params, batch_stats)."""
    params, stats = {}, {}
    for i in range(1, 6):
        b = f"b{i}"
        bp, bs = jconvert.batchnorm(enc_sd, f"{b}.bn")
        params[b] = {"bn": bp, "conv": jconvert.conv2d(enc_sd, f"{b}.conv")}
        stats[b] = {"bn": bs}
    params["gru"] = jconvert.gru(enc_sd, "gru", 1, True)
    return params, stats


def jax_variables(port) -> dict:
    """The port student's weights as the JAX Captioner's variables."""
    enc = {k: v.numpy().copy() for k, v in port.encoder.state_dict().items()}
    dec = {k: v.numpy().copy() for k, v in port.decoder.state_dict().items()}
    p_enc, s_enc = jax_encoder_variables(enc)
    p_dec = convert_transformer_decoder(dec, nlayers=1, tie_weights=False)
    return {"params": {"encoder": p_enc, "decoder": p_dec},
            "batch_stats": {"encoder": s_enc}}


def no_dropout(next_fun, args, kwargs, context):
    """``intercept_methods`` hook: every flax ``Dropout`` is the identity."""
    if isinstance(context.module, fnn.Dropout) and \
            context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def make_batch(seed: int = 2, B: int = 2, Lc: int = 7) -> dict:
    rng = np.random.RandomState(seed)
    wav = (rng.randn(B, SR) * 0.1).astype(np.float32)
    wav[1, WAV_LEN[1]:] = 0.0
    cap_len = np.asarray([Lc, Lc - 2], np.int64)
    cap = np.zeros((B, Lc), np.int64)
    for i, n in enumerate(cap_len):
        cap[i, 0], cap[i, n - 1] = 1, 2
        cap[i, 1:n - 1] = rng.randint(3, V, n - 2)
    return {"wav": wav, "wav_len": WAV_LEN.copy(), "cap": cap,
            "cap_len": cap_len}


def _close(got, want, atol=1e-5, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=atol * max(1.0, float(np.abs(want).max())),
        err_msg=err_msg)


@pytest.fixture(scope="module")
def pair():
    port = port_student()
    jmodel = jzoo.kd_student_cdur5(vocab_size=V, decoder_dropout=0.0)
    jvars = jax_variables(port)
    return port, jmodel, jvars, make_batch()


@pytest.mark.parametrize("window", [(2, 4), (1, 4), (3, 3)])
def test_lp_pool_matches_jax(window):
    x = np.random.RandomState(0).randn(2, 9, 17, 5).astype(np.float32)
    want = np.asarray(j_lp_pool(jnp.asarray(x), window))
    got = lp_pool(torch.from_numpy(x).permute(0, 3, 1, 2), window)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_encoder_eval_forward_matches_jax(pair):
    port, jmodel, jvars, b = pair
    j_enc = jax.device_get(jax.jit(lambda v, w, n: jmodel.apply(
        v, w, n, method=JCaptioner.encode))(
            jvars, jnp.asarray(b["wav"]),
            jnp.asarray(b["wav_len"].astype(np.int32))))
    with torch.no_grad():
        got = port.encode(torch.from_numpy(b["wav"]),
                          torch.from_numpy(b["wav_len"]))
    assert got["attn_emb"].shape == (2, 25, 256)
    np.testing.assert_array_equal(got["attn_emb_len"].numpy(),
                                  np.asarray(j_enc["attn_emb_len"]))
    assert np.abs(np.asarray(j_enc["attn_emb"])).max() > 0.05
    for key in ("attn_emb", "fc_emb"):
        _close(got[key].numpy(), j_enc[key], err_msg=key)


def test_student_logits_match_jax(pair):
    port, jmodel, jvars, b = pair
    want = jax.device_get(jax.jit(lambda v, w, n, c, cl: jmodel.apply(
        v, w, n, c, cl, ss_ratio=1.0, train=False)["logit"])(
            jvars, jnp.asarray(b["wav"]),
            jnp.asarray(b["wav_len"].astype(np.int32)),
            jnp.asarray(b["cap"].astype(np.int32)),
            jnp.asarray(b["cap_len"].astype(np.int32))))
    with torch.no_grad():
        got = port(*(torch.from_numpy(b[k]) for k in
                     ("wav", "wav_len", "cap", "cap_len")))["logit"]
    assert got.shape == (2, 6, V)
    assert np.abs(want).std() > 0.5
    _close(got.numpy(), want)


def test_train_forward_and_bn_statistics_match_jax():
    port = port_student(seed=3)
    jmodel = jzoo.kd_student_cdur5(vocab_size=V, decoder_dropout=0.0)
    jvars = jax_variables(port)
    b = make_batch(seed=4)

    def fwd(v, w, n):
        with fnn.intercept_methods(no_dropout):
            return jmodel.apply(v, w, n, method=JCaptioner.encode,
                                train=True, mutable=["batch_stats"])
    j_enc, upd = jax.device_get(jax.jit(fwd)(
        jvars, jnp.asarray(b["wav"]),
        jnp.asarray(b["wav_len"].astype(np.int32))))
    init = {k: v.clone() for k, v in port.encoder.state_dict().items()}
    port.train()
    with torch.no_grad():
        got = port.encode(torch.from_numpy(b["wav"]),
                          torch.from_numpy(b["wav_len"]))
    for key in ("attn_emb", "fc_emb"):
        _close(got[key].numpy(), j_enc[key], atol=1e-4, err_msg=key)
    stats = port.encoder.state_dict()
    j_stats = upd["batch_stats"]["encoder"]
    for i in range(1, 6):
        for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
            k = f"b{i}.bn.{ours}"
            want = np.asarray(j_stats[f"b{i}"]["bn"][theirs])
            assert np.abs(want - init[k].numpy()).max() > 0, k
            np.testing.assert_allclose(stats[k].numpy(), want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=k)


def test_dropout_acts_in_train_mode_only():
    enc = Cdur5Encoder()
    random_init(enc, torch.Generator().manual_seed(0))
    lms = torch.randn(2, 40, 64)
    n = torch.tensor([40, 40])
    enc.eval()
    with torch.no_grad():
        a, b = enc(lms, n)["attn_emb"], enc(lms, n)["attn_emb"]
    assert torch.equal(a, b)
    enc.train()
    with torch.no_grad():
        c = enc(lms, n)["attn_emb"]
    assert enc.dropout == 0.3 and not torch.allclose(a, c)


def test_converter_matches_jax_exporters(pair):
    port, _, jvars, _ = pair
    p, s = jvars["params"], jvars["batch_stats"]
    want = {}
    for i in range(1, 6):
        b = f"b{i}"
        export.batchnorm(p["encoder"][b]["bn"], s["encoder"][b]["bn"],
                         f"encoder.{b}.bn", want)
        export.conv2d(p["encoder"][b]["conv"], f"encoder.{b}.conv", want)
    export.gru(p["encoder"]["gru"], "encoder.gru", 1, True, want)
    export.transformer_decoder_state_dict(p["decoder"], "decoder",
                                          nlayers=1, tie_weights=False,
                                          out=want)
    got = cdur5_trm_state_dict_from_jax(jvars)
    want = {k: v for k, v in want.items()
            if not k.endswith("num_batches_tracked")}
    assert set(k for k in got if not k.endswith("num_batches_tracked")) \
        == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert "decoder.classifier.weight" in got
    assert set(got) == set(model_variables(port))


def test_jax_written_checkpoint_loads(pair, tmp_path):
    port, _, jvars, _ = pair
    path = tmp_path / "jax_student.pth"
    j_save_checkpoint(str(path), jvars, epoch=3,
                      tokenizer_state={"<pad>": 0})
    ckpt = load_checkpoint(str(path))
    assert ckpt["epoch"] == 3
    fresh = kd_student_cdur5(vocab_size=V)
    load_reference_state_dict(fresh, ckpt["variables"])
    mine = model_variables(port)
    for k, v in model_variables(fresh).items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(v, mine[k], err_msg=k)


def test_port_written_checkpoint_round_trips(pair, tmp_path):
    port = pair[0]
    path = tmp_path / "port_student.pth"
    save_checkpoint(str(path), model_variables(port), epoch=1)
    fresh = kd_student_cdur5(vocab_size=V)
    load_reference_state_dict(fresh, load_checkpoint(str(path))["variables"])
    for (k, a), b in zip(port.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k


def test_config_builds_the_jax_student():
    path = ROOT / "configs" / "synthetic_v2" / "kd_token.yaml"
    jmodel, _ = j_build(j_load_config(str(path))["model"], vocab_size=V)
    model, pretrained = build_model_from_config(
        load_config(str(path))["model"], vocab_size=V)
    assert not pretrained
    assert isinstance(model.encoder, Cdur5Encoder)
    assert model.mel.sample_rate == jmodel.mel.sample_rate == 32000
    dec = model.decoder
    assert (dec.emb_dim, dec.nlayers, dec.nhead, dec.dim_feedforward,
            dec.tie_weights) == (128, 1, 2, 512, False)
    random_init(model, torch.Generator().manual_seed(0))
    jv = jax_variables(model)
    n_jax = sum(np.size(x) for x in jax.tree_util.tree_leaves(jv["params"]))
    n_port = sum(p.numel() for p in model.parameters())
    assert n_jax == n_port + model.decoder.pos_encoder.pe.numel()
    # the tree the JAX-built model initialises (pe is a JAX param)
    ref = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SR)), jnp.asarray([SR]),
        jnp.ones((1, 4), jnp.int32), jnp.asarray([4]), train=False))
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), ref["params"])
    assert shapes == jax.tree_util.tree_map(np.shape, jv["params"])
