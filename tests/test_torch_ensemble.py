"""The port's ``ensemble_generate`` (``decoding/ensemble.py``) against the
JAX package's, on the CPU: two KD students (Cdur5 encoder, a 1-layer
transformer decoder at emb 128, V=60) drawn from seeds 0 and 1, each BN
calibrated and decoder jittered (``test_torch_cdur5.port_student``), the
JAX variables carried over by the JAX package's converters; 4 clips of
at most 1 s at 32 kHz, each its own sound.  Greedy, beam 3 and diverse
beam search (beam 6 in 3 groups): tokens identical, beam scores within
1e-5 (float32 sums in two frameworks).  The mean of two members differs
from either member alone, and a one-member ensemble decodes as
``generate`` does; a GRU member joins a transformer member
(``test_rnn_member_raises``, which raised before GRU members were
ported).  CPU only (not run on the card); ``chip_smoke.py`` phases 22(e)
and 27(e) hold the ensemble on the card against CPU copies."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocaption_tpu.decoding.ensemble import (
    ensemble_generate as j_ensemble_generate)
from audiocaption_tpu.models import zoo as jzoo

from audiocaption_tpu_torch.decoding.ensemble import ensemble_generate
from audiocaption_tpu_torch.models.captioner import generate

from test_torch_cdur5 import SR, jax_variables, port_student

SCORE_ATOL = 1e-5
METHODS = [dict(sample_method="greedy"),
           dict(sample_method="beam", beam_size=3),
           dict(sample_method="dbs", beam_size=6, group_size=3)]
IDS = ["greedy", "beam3", "dbs"]


def make_batch(B: int = 4) -> dict:
    """B clips of at most 1 s at 32 kHz, each its own sound: a tone at
    its own pitch over noise at its own level."""
    rng = np.random.RandomState(3)
    t = np.arange(SR) / SR
    wav = np.stack([0.3 * np.sin(2 * np.pi * 200 * 2 ** i * t)
                    + rng.randn(SR) * 0.05 * (i + 1) for i in range(B)])
    wav_len = np.asarray([SR, 27000, 21000, 16000][:B], np.int64)
    for i, n in enumerate(wav_len):
        wav[i, n:] = 0.0
    return {"wav": wav.astype(np.float32), "wav_len": wav_len}


@pytest.fixture(scope="module")
def members():
    ports = [port_student(seed) for seed in (0, 1)]
    jmodel = jzoo.kd_student_cdur5(vocab_size=60, decoder_dropout=0.0)
    return ports, [jmodel, jmodel], [jax_variables(p) for p in ports]


def _run_jax(jmodels, jvars, b, method):
    fn = jax.jit(lambda vs, w, n: j_ensemble_generate(
        jmodels, vs, w, n, max_length=12, **method))
    return jax.device_get(fn(jvars, jnp.asarray(b["wav"]),
                             jnp.asarray(b["wav_len"], jnp.int32)))


@pytest.mark.parametrize("method", METHODS, ids=IDS)
def test_ensemble_matches_jax(members, method):
    ports, jmodels, jvars = members
    b = make_batch()
    got = ensemble_generate(ports, torch.from_numpy(b["wav"]),
                            torch.from_numpy(b["wav_len"]), max_length=12,
                            **method)
    want = _run_jax(jmodels, jvars, b, method)
    np.testing.assert_array_equal(got["seq"].numpy(), np.asarray(want["seq"]))
    assert len(np.unique(want["seq"])) > 2
    if "score" in want:
        np.testing.assert_allclose(got["score"].numpy(),
                                   np.asarray(want["score"]), rtol=0,
                                   atol=SCORE_ATOL)


@pytest.mark.parametrize("method", METHODS[:2], ids=IDS[:2])
def test_one_member_is_generate(members, method):
    ports, _, _ = members
    b = make_batch()
    wav, n = torch.from_numpy(b["wav"]), torch.from_numpy(b["wav_len"])
    got = ensemble_generate(ports[:1], wav, n, max_length=12, **method)
    want = generate(ports[0], wav, n, max_length=12, **method)
    assert torch.equal(got["seq"], want["seq"])


def test_two_members_average(members):
    ports, _, _ = members
    b = make_batch()
    wav, n = torch.from_numpy(b["wav"]), torch.from_numpy(b["wav_len"])
    both = ensemble_generate(ports, wav, n, sample_method="beam",
                             max_length=12)["score"]
    alone = [ensemble_generate([p], wav, n, sample_method="beam",
                               max_length=12)["score"] for p in ports]
    assert not any(torch.allclose(both, a) for a in alone)


def test_rnn_member_raises(members):
    """A GRU member no longer raises: a KD student and a Cdur5 + 2-layer
    ``BahAttnAddFcDecoder`` captioner (the same vocabulary; built from a
    config dict in both packages, ``test_torch_family.jax_pair``) decode
    beam 3 as JAX's ensemble of the two does."""
    from test_torch_family import jax_pair, model_node
    ports, jmodels, jvars = members
    b = make_batch()
    node = model_node("Cdur5Encoder", "BahAttnAddFcDecoder", 32, 32, 2)
    cap = np.asarray([[1, 5, 6, 2]] * 4)
    j_gru, v_gru, p_gru = jax_pair(node, dict(b, cap=cap,
                                              cap_len=np.full(4, 4)),
                                   seed=3, vocab=60)
    assert p_gru.decoder.vocab_size == 60
    method = dict(sample_method="beam", beam_size=3)
    got = ensemble_generate([ports[0], p_gru], torch.from_numpy(b["wav"]),
                            torch.from_numpy(b["wav_len"]), max_length=12,
                            **method)
    want = _run_jax([jmodels[0], j_gru], [jvars[0], v_gru], b, method)
    np.testing.assert_array_equal(got["seq"].numpy(), np.asarray(want["seq"]))
    np.testing.assert_allclose(got["score"].numpy(),
                               np.asarray(want["score"]), rtol=0,
                               atol=SCORE_ATOL)
