"""MicroBatchServer of the PyTorch port: batched results equal per-clip
decodes through the same function, requests share dispatches, and the
wire formats dequantize as the JAX package's do."""

import functools
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiocaption_tpu_torch.hf_api import (Effb2TrmCaptioningModel,
                                           Effb2TrmConfig)
from audiocaption_tpu_torch.serving import (
    MicroBatchServer, decode_wire_device, encode_wire, wire_decoder)

torch.set_num_threads(1)

SR = 8000   # 0.5 s of 16 kHz audio per clip


@pytest.fixture(scope="module")
def model():
    return Effb2TrmCaptioningModel(Effb2TrmConfig(vocab_size=48), seed=5,
                                   device="cpu")


@pytest.fixture(scope="module")
def decode_fn(model):
    fn = functools.partial(model.decode, sample_method="greedy",
                           max_length=6)
    return wire_decoder(fn, "f32", device="cpu")


def test_results_match_direct_decode(decode_fn):
    rng = np.random.RandomState(0)
    clips = [rng.randn(rng.randint(SR // 2, SR + 1)).astype(np.float32) * 0.1
             for _ in range(10)]
    with MicroBatchServer(decode_fn, max_batch=8, max_wait_ms=50.0,
                          max_samples=SR) as srv:
        futs = [srv.submit(c) for c in clips]
        got = [f.result(timeout=120) for f in futs]
        n_batches = srv.dispatched_batches
    for clip, row in zip(clips, got):
        wav = np.zeros((1, SR), np.float32)
        wav[0, :clip.shape[0]] = clip
        ref = decode_fn(wav, np.asarray([clip.shape[0]], np.int32))
        np.testing.assert_array_equal(row, ref.numpy()[0])
    assert n_batches <= 4, n_batches


def test_lone_request_respects_wait_budget(decode_fn):
    with MicroBatchServer(decode_fn, max_batch=8, max_wait_ms=30.0,
                          max_samples=SR) as srv:
        t0 = time.perf_counter()
        row = srv.submit(np.zeros(SR, np.float32)).result(timeout=120)
    assert row.shape == (6,)
    assert time.perf_counter() - t0 < 60.0


def test_dispatch_error_resolves_futures():
    def boom(wav, lens):
        raise RuntimeError("decode failed")
    with MicroBatchServer(boom, max_batch=4, max_wait_ms=1.0,
                          max_samples=16) as srv:
        fut = srv.submit(np.zeros(16, np.float32))
        with pytest.raises(RuntimeError, match="decode failed"):
            fut.result(timeout=30)


@pytest.mark.parametrize("wire", ["f32", "f16", "i16", "mulaw"])
def test_wire_dequantize_matches_jax(wire):
    from audiocaption_tpu.serving import decode_wire_device as jax_decode
    from audiocaption_tpu.serving import encode_wire as jax_encode
    x = np.random.RandomState(1).uniform(-1, 1, 257).astype(np.float32)
    w = encode_wire(x, wire)
    np.testing.assert_array_equal(w, jax_encode(x, wire))
    got = decode_wire_device(torch.from_numpy(w), wire).numpy()
    want = np.asarray(jax_decode(jnp.asarray(w), wire))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_wire_decoder_feeds_device_tensors():
    seen = {}

    def fn(wav, lens):
        seen["wav"], seen["lens"] = wav, lens
        return lens
    wrapped = wire_decoder(fn, "i16", device="cpu")
    out = wrapped(np.asarray([[16384, -32768]], np.int16),
                  np.asarray([2], np.int32))
    assert torch.is_tensor(out)
    np.testing.assert_allclose(seen["wav"].numpy(), [[0.5, -1.0]])
    assert seen["lens"].dtype == torch.int64


def test_server_defaults_equal_jax():
    """Every keyword default of the port's MicroBatchServer equals the JAX
    server's (max_batch was 64 in the port, 128 in the JAX package)."""
    import inspect
    from audiocaption_tpu.serving import MicroBatchServer as JaxServer

    def defaults(cls):
        return {name: p.default for name, p in
                inspect.signature(cls.__init__).parameters.items()
                if p.default is not inspect.Parameter.empty}
    assert defaults(MicroBatchServer) == defaults(JaxServer)
    assert defaults(MicroBatchServer)["max_batch"] == 128
