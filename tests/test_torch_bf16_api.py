"""Both port APIs in bf16 (``compute_dtype=torch.bfloat16``, on the CPU)
against the JAX package's APIs in bf16 (``compute_dtype=jnp.bfloat16``)
on the same weights (carried across by the converters) and inputs, greedy
and beam 3, and ``MicroBatchServer`` over a bf16 ``decode``.  The
weights are the ones the float32 API tests use (decoders jittered, BN
statistics jittered, the SED classifier sharpened).

The bar: the port's tokens differ from JAX's bf16 tokens in no more than
max(1, n) places, n being the JAX package's own float32-vs-bf16 count on
the same inputs (both are printed).  It holds for the temporal model and
for EffB2 beam 3 (no token differs, nor does JAX's float32 from its
bf16).  It does not hold for EffB2 greedy: 9 tokens differ against
JAX's own 6.  The reason: this random-weight captioner picks between
two tokens whose logits lie within bf16's noise at many steps, and two
bf16 computations that sum in different orders part ways there by
chance.  The two packages' bf16 encoders differ by about half as much
as bf16 moves the output (``test_torch_bf16.py``'s floor ratios), and
JAX's jitted bf16 keeps excess float32 precision inside its fusions
where its op-by-op semantics (which the port follows) round: fed the
same encoder output, JAX's jitted engine and its op-by-op decoder step
pick different first tokens for one of these clips.  Greedy is held
instead to: every place where the port's caption leaves JAX's starts at
a step where the port's own two candidate logits lie closer than bf16
moves them (the port's float32 model's logits at that step,
teacher-forced on the same prefix, as the yardstick)."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiocaption_tpu_torch.hf_api import (
    Cnn14RnnTempAttnGruConfig as TempConfig,
    Cnn14RnnTempAttnGruModel as TempAPI,
    Effb2TrmCaptioningModel as EffAPI, Effb2TrmConfig as EffConfig,
    pad_bucket)
from audiocaption_tpu_torch.models.convert import (
    state_dict_from_jax, tempgru_state_dict_from_jax)

from test_torch_hf_api import AUDIO, LENS, jax_api  # noqa: F401 (fixture)
from test_torch_tempgru_api import (LENS as T_LENS, MAX_LEN, _audio,
                                    jax_api as jax_temporal)  # noqa: F401

torch.set_num_threads(1)

BF16 = torch.bfloat16


def counts(name, got, jax_bf16, jax_f32):
    got, jb, jf = (np.asarray(x) for x in (got, jax_bf16, jax_f32))
    assert got.shape == jb.shape == jf.shape
    mis, floor = int((got != jb).sum()), int((jf != jb).sum())
    print(f"{name}: port-vs-jax bf16 {mis}/{got.size} tokens differ; "
          f"jax f32-vs-bf16 {floor}")
    return mis, floor


def greedy_divergences_at_near_ties(port16, port32, wav, lens, got, want):
    """For each caption where the port's greedy tokens ``got`` leave JAX's
    ``want``, the first such step t: the port's logits teacher-forced on
    the shared prefix, bf16 and float32.  -> (lead, change) per caption:
    the bf16 model's lead of its own pick over JAX's, and the largest
    change bf16 makes to those logits there."""
    out = []
    for b in np.nonzero((got != want).any(1))[0]:
        t = int(np.argmax(got[b] != want[b]))
        logits = []
        for api in (port16, port32):
            m = api.model
            with torch.no_grad():
                enc = m.encode(wav[b:b + 1], lens[b:b + 1])
                static, dyn = m.decoder.init_cache(enc["attn_emb"],
                                                   enc["attn_emb_len"], 8)
                word = torch.tensor([m.special.bos])
                for u in range(t + 1):
                    lg, dyn = m.decoder.step(word, u, static, dyn,
                                             is_pad_t=word == m.special.pad)
                    word = torch.tensor([int(want[b, u])])
            logits.append(lg[0])
        lead = float(logits[0][got[b, t]] - logits[0][want[b, t]])
        change = float((logits[0] - logits[1]).abs().max())
        print(f"caption {b} leaves JAX's at step {t}: lead {lead:.4g}, "
              f"bf16 moves the logits by up to {change:.4g}")
        out.append((lead, change))
    return out


@pytest.fixture(scope="module")
def effb2(jax_api):  # noqa: F811
    from audiocaption_tpu.hf_api import Effb2TrmCaptioningModel
    jax16 = Effb2TrmCaptioningModel(jax_api.config,
                                    variables=jax_api.variables,
                                    compute_dtype=jnp.bfloat16)
    sd = state_dict_from_jax(jax_api.variables)
    port16 = EffAPI(EffConfig(vocab_size=48), state_dict=sd, device="cpu",
                    compute_dtype=BF16)
    port32 = EffAPI(EffConfig(vocab_size=48), state_dict=sd, device="cpu")
    return jax_api, jax16, port16, port32


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_effb2_api_bf16_tokens_match_jax(effb2, method):
    jax32, jax16, port, port32 = effb2
    kw = dict(sample_method=method, beam_size=3, max_length=8)
    got = port(AUDIO, LENS, **kw)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    want = np.asarray(jax16(AUDIO, LENS, **kw))
    mis, floor = counts(f"effb2 {method}", got, want, jax32(AUDIO, LENS, **kw))
    if method == "beam":
        assert mis <= max(1, floor)
        return
    wav = torch.from_numpy(pad_bucket(AUDIO, 16000))
    ties = greedy_divergences_at_near_ties(
        port, port32, wav, torch.tensor(LENS), got, want)
    assert mis == 0 or (ties and all(0 <= lead <= change
                                     for lead, change in ties))


def test_effb2_bf16_model_keeps_float32_parameters(effb2):
    port = effb2[2]
    assert port.model.encoder.compute_dtype == BF16
    assert port.model.decoder.compute_dtype == BF16
    assert all(v.dtype in (torch.float32, torch.int64)
               for v in port.model.state_dict().values())


@pytest.fixture(scope="module")
def temporal(jax_temporal):  # noqa: F811
    from audiocaption_tpu.hf_api import Cnn14RnnTempAttnGruModel
    jax16 = Cnn14RnnTempAttnGruModel(
        jax_temporal.config, variables=jax_temporal.variables,
        sed_variables=jax_temporal.sed_variables,
        compute_dtype=jnp.bfloat16)
    port = TempAPI(TempConfig(vocab_size=48),
                   state_dict=tempgru_state_dict_from_jax(
                       jax_temporal.variables, jax_temporal.sed_variables),
                   device="cpu", compute_dtype=BF16)
    return jax_temporal, jax16, port


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_temporal_api_bf16_tokens_match_jax(temporal, method):
    jax32, jax16, port = temporal
    audio = _audio()
    kw = dict(sample_method=method, beam_size=3, max_length=MAX_LEN)
    got = port(audio, T_LENS, **kw)
    assert got.dtype == np.int32 and got.shape == (2, MAX_LEN)
    mis, floor = counts(f"temporal {method}", got,
                        jax16(audio, T_LENS, **kw),
                        jax32(audio, T_LENS, **kw))
    assert mis <= max(1, floor)


def test_temporal_bf16_keeps_the_float32_parts(temporal):
    _, _, port = temporal
    cap, sed = port.model.cap_model, port.model.sed_model
    assert cap.encoder.cnn.compute_dtype == BF16
    assert sed.compute_dtype == BF16
    lms = port.log_mel(torch.from_numpy(_audio()))
    assert lms.dtype == torch.float32          # the log-mel stays float32
    with torch.no_grad():
        enc = cap.encode_lms(lms, port.mel.feat_len(torch.tensor(T_LENS)))
    assert enc["attn_emb"].dtype == torch.float32   # the BiGRU's output


def test_server_over_bf16_decode_equals_direct_decode(effb2):
    from audiocaption_tpu_torch.serving import MicroBatchServer, wire_decoder
    port = effb2[2]
    fn = wire_decoder(functools.partial(port.decode, sample_method="beam",
                                        beam_size=3, max_length=6),
                      "f32", device="cpu")
    rng = np.random.RandomState(4)
    clips = [(rng.randn(n) * 0.3).astype(np.float32)
             for n in (9000, 14000, 12000, 16000)]
    with MicroBatchServer(fn, max_batch=4, max_wait_ms=2000.0,
                          max_samples=16000) as srv:
        futs = [srv.submit(c) for c in clips]
        served = np.stack([f.result(timeout=300) for f in futs])
        n_batches = srv.dispatched_batches
    batch = np.zeros((4, 16000), np.float32)
    for i, c in enumerate(clips):
        batch[i, :len(c)] = c
    direct = fn(batch, np.asarray([len(c) for c in clips], np.int32))
    assert n_batches == 1
    np.testing.assert_array_equal(served, direct.numpy())
