"""The runner's pretrained-submodule loader (``cli/run.py::
load_pretrained``) against the JAX package's ``load_pretrained_into``.

A Cnn14-GRU + transformer captioner is built by both packages from one
model node with ``pretrained`` on its ``cnn`` and ``decoder`` nodes; the
JAX variables start from the port's weights.  A second, differently
seeded port model supplies the files, written in every wrapping the
JAX adapters read: a plain state dict, ``{"model": sd}`` (PANNs),
``{"model": {"backbone.*": ...}}`` (COLA, with a stray key outside
``backbone.``), ``{"state_dict": {"audio_encoder.*": ...}}`` (BLAT, with
a text-encoder key beside it) and a decoder file with ``decoder.*``
keys.  After loading, both packages hold the same tensors (in the
reference key space, exactly), and the loaded part holds the file's.
A file that fills none of its part's tensors raises in the port."""

import numpy as np
import pytest
import torch

import jax

from audiocaption_tpu.utils.config import (
    build_model_from_config as j_build, load_pretrained_into)

from audiocaption_tpu_torch.cli.run import load_pretrained, unwrap_pretrained
from audiocaption_tpu_torch.models.zoo import random_init
from audiocaption_tpu_torch.training.checkpoint import (
    jax_variables_to_reference, model_variables)
from audiocaption_tpu_torch.utils.config import build_model_from_config

from test_torch_cnn14rnn_trm import jax_variables

V = 40


def model_cfg(cnn_file=None, dec_file=None):
    cnn = {"type": "Cnn14Encoder", "args": {"sample_rate": 32000}}
    dec = {"type": "TransformerDecoder",
           "args": {"emb_dim": 256, "nlayers": 2, "dropout": 0.0}}
    if cnn_file:
        cnn["pretrained"] = str(cnn_file)
    if dec_file:
        dec["pretrained"] = str(dec_file)
    return {"type": "TransformerModel",
            "encoder": {"type": "Cnn14RnnEncoder", "args": {},
                        "cnn": cnn,
                        "rnn": {"type": "RnnEncoder",
                                "args": {"bidirectional": True,
                                         "hidden_size": 256,
                                         "num_layers": 3}}},
            "decoder": dec}


def port_model(seed):
    model, _ = build_model_from_config(model_cfg(), vocab_size=V)
    random_init(model, torch.Generator().manual_seed(seed))
    return model


@pytest.fixture(scope="module")
def source():
    """The file-side model's Cnn14 and decoder state dicts."""
    src = port_model(7)
    return ({k: v.clone() for k, v in src.encoder.cnn.state_dict().items()},
            {k: v.clone() for k, v in src.decoder.state_dict().items()})


WRAPS = {
    "plain": lambda sd: sd,
    "panns_model": lambda sd: {"model": sd},
    "cola_backbone": lambda sd: {"model": {
        **{f"backbone.{k}": v for k, v in sd.items()},
        "projector.weight": torch.zeros(3)}},
    "blat_state_dict": lambda sd: {"state_dict": {
        **{f"audio_encoder.{k}": v for k, v in sd.items()},
        "text_encoder.weight": torch.zeros(3)}},
}


def _load_both(cfg, tmp_path):
    port, specs = build_model_from_config(cfg, vocab_size=V)
    random_init(port, torch.Generator().manual_seed(0))
    jvars = jax.device_get(jax_variables(port))
    _, j_specs = j_build(cfg, vocab_size=V)
    assert [(s[0].replace("/", "."), s[1], s[2]) for s in j_specs] == specs
    for spec, j_spec in zip(specs, j_specs):
        load_pretrained(port, spec)
        jvars = load_pretrained_into(jvars, j_spec)
    return port, jax_variables_to_reference(jax.device_get(jvars))


def _assert_same(port, want, part_sd, prefix):
    got = model_variables(port)
    checked = 0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_array_equal(got[k], np.asarray(w), err_msg=k)
        checked += 1
    assert checked > 100
    for k, v in part_sd.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(got[prefix + k], v.numpy(),
                                          err_msg=k)


@pytest.mark.parametrize("wrap", list(WRAPS))
def test_cnn_file_loads_what_jax_loads(source, tmp_path, wrap):
    cnn_sd, _ = source
    path = tmp_path / f"{wrap}.pth"
    torch.save(WRAPS[wrap](cnn_sd), path)
    port, want = _load_both(model_cfg(cnn_file=path), tmp_path)
    _assert_same(port, want, cnn_sd, "encoder.cnn.")


@pytest.mark.parametrize("prefixed", [False, True],
                         ids=["plain", "decoder_prefix"])
def test_decoder_file_loads_what_jax_loads(source, tmp_path, prefixed):
    _, dec_sd = source
    sd = ({f"decoder.{k}": v for k, v in dec_sd.items()} if prefixed
          else dec_sd)
    if prefixed:
        sd["encoder.stray"] = torch.zeros(2)
    path = tmp_path / "decoder.pth"
    torch.save(sd, path)
    port, want = _load_both(model_cfg(dec_file=path), tmp_path)
    _assert_same(port, want, {k: v for k, v in dec_sd.items()
                              if k != "pos_encoder.pe"}, "decoder.")


def test_unwrap_keeps_jax_adapter_rules(source):
    cnn_sd, _ = source
    for wrap in WRAPS:
        got = unwrap_pretrained(WRAPS[wrap](cnn_sd), "cnn14")
        assert set(got) == set(cnn_sd), wrap


@pytest.mark.parametrize("contents", [
    {"model": {"backbone.nothing": torch.zeros(2)}},
    {"state_dict": {"text_encoder.weight": torch.zeros(2)}},
    {"conv_block1.conv1.weight": torch.zeros(1, 1, 1, 1)},
], ids=["cola_no_match", "blat_no_audio_encoder", "wrong_shape"])
def test_file_that_fills_nothing_raises(tmp_path, contents):
    path = tmp_path / "empty.pth"
    torch.save(contents, path)
    port = port_model(0)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with pytest.raises(ValueError, match="fills none"):
        load_pretrained(port, ("encoder.cnn", str(path), "cnn14"))
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k
