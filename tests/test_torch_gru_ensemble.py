"""Ensembles with GRU members in the port (``decoding/ensemble.py``)
against the JAX package's ``ensemble_generate``, on the CPU: members
built from config dicts in both packages (``test_torch_family.jax_pair``:
``Cnn6Encoder`` encoders; a 2-layer ``BahAttnAddFcDecoder``, a 1-layer
``BahAttnCatFcDecoder`` and a 1-layer ``TransformerDecoder``, emb 32,
vocab 40), 4 clips of at most 1 s.

  * two GRU members, and a mixed pair (a GRU and a transformer member):
    greedy, beam 3 and diverse beam search (beam 6 in 3 groups) give
    JAX's tokens, beam scores within 1e-5;
  * a GRU member's cache is built with no condition, as JAX's: an
    ensemble of one temporal decoder decodes as ``generate`` with tag 0
    (ROADMAP Queue 3)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocaption_tpu.decoding.ensemble import (
    ensemble_generate as j_ensemble_generate)

from audiocaption_tpu_torch.decoding.ensemble import ensemble_generate
from audiocaption_tpu_torch.models.captioner import generate

from test_torch_family import clips, jax_pair, model_node

torch.set_num_threads(2)
METHODS = [dict(sample_method="greedy"),
           dict(sample_method="beam", beam_size=3),
           dict(sample_method="dbs", beam_size=6, group_size=3)]
IDS = ["greedy", "beam3", "dbs"]


def _trm_node():
    node = model_node("Cnn6Encoder")
    node["decoder"] = {"type": "TransformerDecoder",
                       "args": {"emb_dim": 32, "nlayers": 1, "nhead": 2,
                                "dropout": 0.0}}
    return node


@pytest.fixture(scope="module")
def members():
    b = clips(seed=31)
    nodes = {"add2": model_node("Cnn6Encoder", "BahAttnAddFcDecoder", 32,
                                32, 2),
             "cat1": model_node("Cnn6Encoder", "BahAttnCatFcDecoder", 32,
                                32, 1),
             "trm": _trm_node()}
    return {k: jax_pair(n, b, seed=10 + i) for i, (k, n) in
            enumerate(nodes.items())}, b


@pytest.mark.parametrize("names", [("add2", "cat1"), ("add2", "trm")],
                         ids=["gru+gru", "gru+trm"])
@pytest.mark.parametrize("method", METHODS, ids=IDS)
def test_ensemble_with_gru_members_matches_jax(members, names, method):
    pairs, b = members
    jm = [pairs[n][0] for n in names]
    jv = [pairs[n][1] for n in names]
    ports = [pairs[n][2] for n in names]
    want = jax.device_get(jax.jit(lambda vs, w, n: j_ensemble_generate(
        jm, vs, w, n, max_length=10, **method))(
            jv, jnp.asarray(b["wav"]),
            jnp.asarray(b["wav_len"].astype(np.int32))))
    got = ensemble_generate(ports, torch.from_numpy(b["wav"]),
                            torch.from_numpy(b["wav_len"]), max_length=10,
                            **method)
    np.testing.assert_array_equal(got["seq"].numpy(), np.asarray(want["seq"]))
    assert len(np.unique(want["seq"])) > 2
    if "score" in want:
        np.testing.assert_allclose(got["score"].numpy(),
                                   np.asarray(want["score"]), rtol=0,
                                   atol=1e-5)


def test_temporal_member_runs_on_tag_zero():
    b = clips(seed=32)
    node = model_node("Cnn6Encoder", "TemporalBahAttnDecoder", 32, 32, 1)
    _, _, port = jax_pair(node, b, seed=7)
    wav, n = torch.from_numpy(b["wav"]), torch.from_numpy(b["wav_len"])
    got = ensemble_generate([port], wav, n, sample_method="beam",
                            max_length=10)
    tag0 = generate(port, wav, n, sample_method="beam", max_length=10,
                    temporal_tag=torch.zeros(4, dtype=torch.long))
    tag3 = generate(port, wav, n, sample_method="beam", max_length=10,
                    temporal_tag=torch.full((4,), 3, dtype=torch.long))
    assert torch.equal(got["seq"], tag0["seq"])
    assert torch.allclose(got["score"], tag0["score"], atol=1e-6)
    assert not torch.allclose(got["score"], tag3["score"], atol=1e-4)
