"""The port's ``zoo.cnn14rnn_trm`` (Cnn14 -> 3-layer BiGRU(256) encoder at
32 kHz, 2-layer transformer decoder, emb 256, untied classifier) against
the JAX package's, at full width with a small vocabulary (60), on 2 clips
of at most 1 s.  The port model is drawn from a seed, its BN statistics
and affine parameters jittered (so the encoder does not collapse) and its
decoder matrices jittered by 0.4 (so decodes depend on the weights); the
JAX variables come from it through the JAX package's own converters.

  * ``cnn14rnn_trm_state_dict_from_jax`` equals the JAX exporters'
    output key for key and loads back into the port unchanged;
  * encode within rtol / atol 1e-4 (as ``test_torch_cnn14.py``);
  * greedy and beam-3 tokens equal (the JAX search on its own encoding);
  * ``freeze_cnn``: no gradient reaches the CNN; ``freeze_cnn_bn``: the
    CNN's BN statistics stay fixed in ``train()``, in both packages;
  * ``build_model_from_config`` on ``configs/audiocaps/cnn14rnn_trm.yaml``
    and ``configs/synthetic_v2/scst.yaml`` builds what the JAX package's
    ``build_model_from_config`` builds;
  * one port SCST step is finite."""

from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from audiocaption_tpu.models import export
from audiocaption_tpu.models import zoo as jzoo
from audiocaption_tpu.models.captioner import (
    Captioner as JCaptioner, generate as j_generate)
from audiocaption_tpu.models.rnn_encoder import (
    Cnn14RnnEncoder as JEncoder, convert_cnn14_rnn)
from audiocaption_tpu.models.transformer_decoder import (
    convert_transformer_decoder)
from audiocaption_tpu.utils.config import (
    build_model_from_config as j_build, load_config as j_load_config)

from audiocaption_tpu_torch.models.convert import (
    cnn14rnn_trm_state_dict_from_jax, load_reference_state_dict)
from audiocaption_tpu_torch.models.captioner import generate
from audiocaption_tpu_torch.models.rnn_encoder import Cnn14RnnEncoder
from audiocaption_tpu_torch.models.zoo import cnn14rnn_trm, random_init
from audiocaption_tpu_torch.optim.schedules import (
    exponential_decay_with_warmup)
from audiocaption_tpu_torch.training.checkpoint import (
    jax_variables_to_reference, model_variables)
from audiocaption_tpu_torch.training.scst import scst_step
from audiocaption_tpu_torch.training.trainer import create_train_state
from audiocaption_tpu_torch.utils.config import (
    build_model_from_config, load_config)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
V, SR, L = 60, 32000, 12
WAV_LEN = np.asarray([SR, 21000], np.int64)


def jitter(model: nn.Module, seed: int, decoder_scale: float = 0.4):
    rng = np.random.RandomState(seed)

    def rand(shape, scale, offset=0.0):
        return torch.from_numpy(
            (offset + rng.randn(*shape) * scale).astype(np.float32))
    with torch.no_grad():
        for m in model.encoder.modules():
            if isinstance(m, nn.BatchNorm2d):
                n = (m.num_features,)
                m.running_mean.copy_(rand(n, 0.1))
                m.running_var.copy_(torch.from_numpy(
                    (0.5 + rng.rand(*n)).astype(np.float32)))
                m.weight.copy_(rand(n, 0.2, 1.0))
                m.bias.copy_(rand(n, 0.2))
        for p in model.decoder.parameters():
            if p.dim() == 2:
                p.add_(rand(p.shape, decoder_scale))


def jax_variables(port) -> dict:
    enc = {k: v.numpy().copy() for k, v in port.encoder.state_dict().items()}
    dec = {k: v.numpy().copy() for k, v in port.decoder.state_dict().items()}
    p_enc, s_enc = convert_cnn14_rnn(enc)
    p_dec = convert_transformer_decoder(dec, nlayers=2, tie_weights=False)
    return {"params": {"encoder": p_enc, "decoder": p_dec},
            "batch_stats": {"encoder": s_enc}}


@pytest.fixture(scope="module")
def pair():
    port = cnn14rnn_trm(vocab_size=V)
    random_init(port, torch.Generator().manual_seed(0))
    jitter(port, 1)
    port.eval()
    jmodel = jzoo.cnn14rnn_trm(vocab_size=V)
    rng = np.random.RandomState(2)
    wav = (rng.randn(2, SR) * 0.1).astype(np.float32)
    wav[1, WAV_LEN[1]:] = 0.0
    jvars = jax_variables(port)
    j_enc = jax.device_get(jax.jit(lambda v, w, n: jmodel.apply(
        v, w, n, method=JCaptioner.encode))(
            jvars, jnp.asarray(wav), jnp.asarray(WAV_LEN.astype(np.int32))))
    return port, jmodel, jvars, wav, j_enc


def test_converter_from_jax(pair):
    port, _, jvars, _, _ = pair
    p, s = jvars["params"], jvars["batch_stats"]
    want = export.cnn14_rnn_state_dict(p["encoder"], s["encoder"],
                                       "encoder.cnn", "encoder.rnn")
    export.transformer_decoder_state_dict(p["decoder"], "decoder",
                                          tie_weights=False, out=want)
    got = cnn14rnn_trm_state_dict_from_jax(jvars)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert "decoder.classifier.weight" in got              # untied
    assert "decoder.classifier.bias" not in got
    # a JAX-written checkpoint's variables read into the same key space
    ref = jax_variables_to_reference(jvars)
    assert set(ref) == set(got)
    fresh = cnn14rnn_trm(vocab_size=V)
    load_reference_state_dict(fresh, got)
    mine = model_variables(port)
    for k, v in model_variables(fresh).items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(v, mine[k], err_msg=k)


def test_encode_matches_jax(pair):
    port, _, _, wav, j_enc = pair
    with torch.no_grad():
        got = port.encode(torch.from_numpy(wav), torch.from_numpy(WAV_LEN))
    np.testing.assert_array_equal(got["attn_emb_len"].numpy(),
                                  np.asarray(j_enc["attn_emb_len"]))
    assert np.abs(np.asarray(j_enc["attn_emb"])).max() > 0.05
    for key in ("attn_emb", "fc_emb"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(j_enc[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_tokens_match_jax(pair, method):
    port, jmodel, jvars, wav, j_enc = pair
    want = np.asarray(jax.jit(lambda v, e: j_generate(
        jmodel, v, sample_method=method, beam_size=3, max_length=L,
        enc_override=e)["seq"])(jvars, j_enc))
    got = generate(port, torch.from_numpy(wav), torch.from_numpy(WAV_LEN),
                   sample_method=method, beam_size=3, max_length=L)["seq"]
    np.testing.assert_array_equal(got.numpy(), want)
    # random decoders fall into one-word loops; the clips still differ
    assert not np.array_equal(want[0], want[1])


def test_freeze_options_match_jax(pair):
    """Train-mode encoder with both options on: the CNN gets no gradient
    and its BN statistics stay; the GRU gets gradients in both."""
    port = pair[0]
    lms = (np.random.RandomState(3).randn(2, 101, 64) * 10 - 40).astype(
        np.float32)
    feat_len = np.asarray([101, 66], np.int64)
    enc = Cnn14RnnEncoder(freeze_cnn=True, freeze_cnn_bn=True)
    enc.load_state_dict(port.encoder.state_dict())
    enc.train()
    assert not enc.cnn.training and enc.rnn.training
    before = {k: v.clone() for k, v in enc.cnn.state_dict().items()}
    enc(torch.from_numpy(lms), torch.from_numpy(feat_len))["fc_emb"] \
        .sum().backward()
    assert all(p.grad is None for p in enc.cnn.parameters())
    assert all(p.grad is not None for p in enc.rnn.parameters())
    for k, v in enc.cnn.state_dict().items():
        assert torch.equal(v, before[k]), k

    jvars = pair[2]
    jenc = JEncoder(freeze_cnn=True, freeze_cnn_bn=True)
    v = {"params": jvars["params"]["encoder"],
         "batch_stats": jvars["batch_stats"]["encoder"]}

    def loss(params):
        out, new = jenc.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jnp.asarray(lms), jnp.asarray(feat_len.astype(np.int32)),
            train=True, rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])
        return out["fc_emb"].sum(), new
    grads, new = jax.device_get(jax.jit(jax.grad(loss, has_aux=True))(
        v["params"]))
    assert all(not np.any(g) for g in jax.tree_util.tree_leaves(
        grads["cnn"]))
    assert any(np.any(g) for g in jax.tree_util.tree_leaves(grads["rnn"]))
    for a, b in zip(jax.tree_util.tree_leaves(new["batch_stats"]["cnn"]),
                    jax.tree_util.tree_leaves(v["batch_stats"]["cnn"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("path", ["configs/audiocaps/cnn14rnn_trm.yaml",
                                  "configs/synthetic_v2/scst.yaml"])
def test_build_model_from_config_matches_jax(path):
    cfg = load_config(str(ROOT / path))
    jcfg = j_load_config(str(ROOT / path))
    model, pretrained = build_model_from_config(cfg["model"], vocab_size=V)
    node = jcfg["model"]
    if node["type"].endswith("ScstWrapper"):
        node = node["model"]
    jm, jpre = j_build(node, vocab_size=V)
    enc, jenc = model.encoder, jm.encoder
    assert isinstance(enc, Cnn14RnnEncoder)
    assert (enc.freeze_cnn, enc.freeze_cnn_bn) == (jenc.freeze_cnn,
                                                   jenc.freeze_cnn_bn)
    gru = enc.rnn.network
    assert (gru.hidden_size, gru.num_layers, gru.bidirectional,
            enc.rnn.dropout, enc.rnn.pooling) == (
        jenc.rnn_hidden_size, jenc.rnn_num_layers, jenc.rnn_bidirectional,
        jenc.rnn_dropout, jenc.rnn_pooling)
    dec, jdec = model.decoder, jm.decoder
    assert (dec.emb_dim, dec.vocab_size, dec.nlayers, dec.tie_weights,
            dec.dropout) == (jdec.emb_dim, jdec.vocab_size, jdec.nlayers,
                             jdec.tie_weights, jdec.dropout)
    assert dec.attn_proj[0].in_features == jdec.attn_emb_dim == 512
    assert model.mel.sample_rate == jm.mel.sample_rate == 32000
    assert [p[1] for p in pretrained] == [p[1] for p in jpre]


def test_port_scst_step_is_finite(pair):
    port = pair[0]
    model = cnn14rnn_trm(vocab_size=V)
    model.load_state_dict(port.state_dict())
    state = create_train_state(
        model, 5e-5, exponential_decay_with_warmup(5e-5, 5e-7, 10, 2), 1e-6,
        1.0)
    batch = {"wav": torch.from_numpy(pair[3]),
             "wav_len": torch.from_numpy(WAV_LEN)}
    refs = {"a": ["w5 w6 w7", "w8 w9"], "b": ["w10 w11 w12 w13"]}
    m = scst_step(state, batch, ["a", "b"], refs,
                  {i: f"w{i}" for i in range(V)}, max_length=L,
                  generator=torch.Generator().manual_seed(0))
    assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
    assert m["sampled"].shape == m["greedy"].shape == (2, L)
    assert state.lr_count == 1


def test_gru_dropout_and_scst_mode():
    """``layers.GRU``'s dropout is ``nn.GRU``'s own: none in ``eval()``
    (the output of the same weights without dropout), dropping in
    ``train()`` with the output still zero past each length, and none for
    one layer.  Under ``scst_mode`` (the GRU in ``train()``, its encoder
    in ``eval()``) the encoder's output is its eval-mode output, and the
    dropout is back on exit."""
    from audiocaption_tpu_torch.models.layers import GRU
    from audiocaption_tpu_torch.models.rnn_encoder import RnnEncoder
    from audiocaption_tpu_torch.training.scst import scst_mode
    torch.manual_seed(0)
    gru = GRU(6, 16, num_layers=3, bidirectional=True, dropout=0.5)
    plain = GRU(6, 16, num_layers=3, bidirectional=True)
    plain.load_state_dict(gru.state_dict())
    x = torch.randn(3, 9, 6)
    lens = torch.tensor([9, 5, 2])
    assert torch.equal(gru.eval()(x, lens), plain(x, lens))
    dropped = gru.train()(x, lens)
    assert not torch.allclose(dropped, plain(x, lens))
    assert not dropped[1, 5:].any() and not dropped[2, 2:].any()
    assert GRU(6, 16, dropout=0.5).dropout == 0.0
    enc = RnnEncoder(6, 16, 3, dropout=0.5).eval()
    want = enc(x, lens)["attn_emb"]
    with scst_mode(enc):
        assert enc.network.training and not enc.training
        assert torch.equal(enc(x, lens)["attn_emb"], want)
    assert enc.network.dropout == 0.5
