"""The top-level feature-input encoders of the PyTorch port
(``RnnEncoder``, ``AudioTransformerEncoder`` and its other name
``TransformerEncoder``, ``input_mode`` "features") built from one config
dict by both packages' builders, on the CPU, float32: JAX variables (flax
init, the decoder jittered by its own spread) carried across by
``models/convert.py::captioner_state_dict_from_jax``; the encoder outputs
within 1e-5 and the teacher-forced logits of a ``TransformerDecoder`` on
them within 1e-5, greedy tokens equal.  Also the input-width rule: flax
infers a layer's input width, torch needs it up front, so the port's
builder takes ``encoder.args.input_dim`` when the config gives it, else
the width of the data's first row (``utils/config.py::
feature_input_dim``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocaption_tpu.models.captioner import generate as j_generate
from audiocaption_tpu.utils.config import build_model_from_config as j_build

from audiocaption_tpu_torch.models.captioner import generate
from audiocaption_tpu_torch.models.convert import (
    captioner_state_dict_from_jax, load_reference_state_dict)
from audiocaption_tpu_torch.utils.config import (
    build_model_from_config, feature_input_dim)

torch.set_num_threads(2)
DIN, V = 20, 30
ATOL = 1e-5


def node(enc_type: str, enc_args: dict) -> dict:
    return {"type": "captioning.models.transformer_model.TransformerModel",
            "encoder": {"type": f"captioning.models.rnn_encoder.{enc_type}",
                        "args": dict(enc_args)},
            "decoder": {"type": "captioning.models.transformer_decoder."
                                "TransformerDecoder",
                        "args": {"emb_dim": 32, "nlayers": 1, "nhead": 2,
                                 "dropout": 0.1}}}


def batch(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(3, 11, DIN).astype(np.float32)
    lens = np.asarray([11, 7, 4])
    for i, n in enumerate(lens):
        x[i, n:] = 0.0
    cap = np.asarray([[1, 5, 6, 7, 2], [1, 8, 9, 2, 0], [1, 4, 2, 0, 0]])
    return x, lens, cap


def pair(n: dict, input_dim=None, seed=0):
    jmodel, _ = j_build(n, vocab_size=V)
    x, lens, cap = batch()
    v = jax.device_get(jmodel.init(
        {"params": jax.random.PRNGKey(seed), "sample": jax.random.PRNGKey(1)},
        x, lens.astype(np.int32), cap.astype(np.int32),
        np.asarray([5, 4, 3], np.int32), train=False))
    rng = np.random.RandomState(seed + 9)
    params = dict(jax.tree_util.tree_map(np.asarray, v["params"]))
    params["decoder"] = jax.tree_util.tree_map(
        lambda a: a + 0.5 * (np.std(a) if a.size > 1 else 1.0)
        * rng.randn(*a.shape).astype(np.float32), params["decoder"])
    jvars = {"params": params, "batch_stats": v.get("batch_stats", {})}
    port, _ = build_model_from_config(n, vocab_size=V, input_dim=input_dim)
    load_reference_state_dict(port, captioner_state_dict_from_jax(jvars))
    return jmodel, jvars, port.eval()


RNN_CASES = [(bi, pooling) for bi in (False, True)
             for pooling in ("mean", "max", "mean+max", "last")]


@pytest.mark.parametrize("bi,pooling", RNN_CASES,
                         ids=[f"{'bi' if b else 'uni'}-{p}"
                              for b, p in RNN_CASES])
def test_rnn_encoder_matches_jax(bi, pooling):
    n = node("RnnEncoder", {"input_dim": DIN, "hidden_size": 16,
                            "bidirectional": bi, "num_layers": 2,
                            "pooling": pooling, "dropout": 0.2})
    check_pair(*pair(n))


@pytest.mark.parametrize("enc_type", ["AudioTransformerEncoder",
                                      "TransformerEncoder"])
def test_audio_transformer_encoder_matches_jax(enc_type):
    n = node(enc_type, {"d_model": 32, "nlayers": 2, "nhead": 4,
                        "dropout": 0.1})
    # no input_dim in the config: the width comes from the data
    jmodel, jvars, port = pair(n, input_dim=DIN)
    assert port.encoder.attn_proj_dense.in_features == DIN
    check_pair(jmodel, jvars, port)


def check_pair(jmodel, jvars, port):
    x, lens, cap = batch()
    assert port.input_mode == "features" and jmodel.input_mode == "features"
    j_enc = jax.device_get(jmodel.apply(jvars, x, lens.astype(np.int32),
                                        method=type(jmodel).encode))
    j_out = jax.device_get(jmodel.apply(
        jvars, x, lens.astype(np.int32), cap.astype(np.int32),
        np.asarray([5, 4, 3], np.int32), train=False))
    with torch.no_grad():
        enc = port.encode(torch.from_numpy(x), torch.from_numpy(lens))
        out = port(torch.from_numpy(x), torch.from_numpy(lens),
                   torch.from_numpy(cap), torch.tensor([5, 4, 3]))
    for k in ("attn_emb", "fc_emb", "attn_emb_len"):
        np.testing.assert_allclose(enc[k].numpy(), np.asarray(j_enc[k]),
                                   atol=ATOL, rtol=0, err_msg=k)
    np.testing.assert_allclose(out["logit"].numpy(),
                               np.asarray(j_out["logit"]), atol=ATOL, rtol=0)
    want = jax.device_get(j_generate(jmodel, jvars, jnp.asarray(x),
                                     jnp.asarray(lens.astype(np.int32)),
                                     sample_method="greedy", max_length=8))
    got = generate(port, torch.from_numpy(x), torch.from_numpy(lens),
                   sample_method="greedy", max_length=8)
    np.testing.assert_array_equal(got["seq"].numpy(), np.asarray(want["seq"]))


class Rows:
    audio_ids = ["a", "b"]

    def get_audio(self, aid):
        return np.zeros((5 if aid == "a" else 3, 44), np.float32)


def test_input_width_rule():
    """``encoder.args.input_dim`` wins; without it the first row's last
    dimension; other encoders need none; a feature encoder with neither
    raises."""
    given = node("M2TransformerEncoder", {"input_dim": 64, "d_model": 32,
                                          "nhead": 4})
    assert feature_input_dim(given, Rows()) is None
    free = node("AudioTransformerEncoder", {"d_model": 32, "nhead": 4})
    assert feature_input_dim(free, Rows()) == 44
    wrapped = {"type": "ScstWrapper", "model": free}
    assert feature_input_dim(wrapped, Rows()) == 44
    wave = node("Cnn14Encoder", {})
    assert feature_input_dim(wave, Rows()) is None
    with pytest.raises(ValueError, match="input_dim"):
        build_model_from_config(free, vocab_size=V)
    model, _ = build_model_from_config(free, vocab_size=V, input_dim=44)
    assert model.encoder.attn_proj_dense.in_features == 44
    model, _ = build_model_from_config(given, vocab_size=V, input_dim=44)
    assert model.encoder.input_proj.in_features == 64
