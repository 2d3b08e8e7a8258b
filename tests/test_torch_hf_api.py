"""The PyTorch port's ``Effb2TrmCaptioningModel`` (on the CPU) against the
JAX package's, on weights carried across by ``state_dict_from_jax``:
greedy and beam-3 tokens must be identical, directly and after
``load_torch_checkpoint`` of a ``torch.save``d exported checkpoint (plain
and ``{"state_dict": ...}``-wrapped).

The shared JAX model gets non-identity batch-norm statistics (so the
encoder output does not collapse) and a jitter of the decoder's weight
matrices (so decodes depend on the weights)."""

import numpy as np
import pytest
import torch

import jax

from audiocaption_tpu_torch.hf_api import (
    Effb2TrmCaptioningModel as TorchAPI, Effb2TrmConfig as TorchConfig)
from audiocaption_tpu_torch.models.convert import state_dict_from_jax

from test_torch_effb2 import jitter_bn

torch.set_num_threads(1)

AUDIO = np.random.RandomState(0).randn(3, 14000).astype(np.float32) * 0.3
LENS = [14000, 9000, 12000]


@pytest.fixture(scope="module")
def jax_api():
    from audiocaption_tpu.hf_api import (Effb2TrmCaptioningModel,
                                         Effb2TrmConfig)
    api = Effb2TrmCaptioningModel(Effb2TrmConfig(vocab_size=48), seed=3)
    rng = np.random.RandomState(0)
    v = jax.device_get(api.variables)
    v["params"]["decoder"] = jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(x) + rng.randn(*np.shape(x)).astype(
            np.float32) * 0.1 * (np.ndim(x) == 2 and "pe" not in str(p)),
        v["params"]["decoder"])
    jitter_bn(v["params"]["encoder"], v["batch_stats"]["encoder"], rng)
    api.variables = v
    api._decode = {}
    return api


@pytest.fixture(scope="module")
def jax_tokens(jax_api):
    return {m: jax_api(AUDIO, LENS, sample_method=m, max_length=8)
            for m in ("greedy", "beam")}


def test_state_dict_from_jax_equals_export(jax_api):
    from audiocaption_tpu.models import export
    v = jax_api.variables
    want = export.effb2_trm_hf_state_dict(v)
    got = state_dict_from_jax(v)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_port_modules_cover_reference_keys(jax_api):
    from audiocaption_tpu_torch.models.convert import (DECODER_PREFIX,
                                                       ENCODER_PREFIX)
    port = TorchAPI(TorchConfig(vocab_size=48), device="cpu")
    keys = {ENCODER_PREFIX + k for k in port.model.encoder.state_dict()}
    keys |= {DECODER_PREFIX + k for k in port.model.decoder.state_dict()}
    assert keys == set(state_dict_from_jax(jax_api.variables))


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_api_tokens_match_jax(jax_api, jax_tokens, method):
    port = TorchAPI(TorchConfig(vocab_size=48),
                    state_dict=state_dict_from_jax(jax_api.variables),
                    device="cpu")
    got = port(AUDIO, LENS, sample_method=method, max_length=8)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, jax_tokens[method])


@pytest.mark.parametrize("wrapped", [False, True], ids=["plain", "wrapped"])
def test_load_torch_checkpoint_token_parity(jax_api, jax_tokens, tmp_path,
                                            wrapped):
    from audiocaption_tpu.models import export
    sd = {k: torch.from_numpy(np.array(x)) for k, x in
          export.effb2_trm_hf_state_dict(jax_api.variables).items()}
    path = tmp_path / "pytorch_model.bin"
    torch.save({"state_dict": sd} if wrapped else sd, path)
    port = TorchAPI(TorchConfig(vocab_size=48), seed=99, device="cpu")
    before = port(AUDIO, LENS, sample_method="greedy", max_length=8)
    assert not np.array_equal(before, jax_tokens["greedy"])
    port.load_torch_checkpoint(str(path))
    for method in ("greedy", "beam"):
        np.testing.assert_array_equal(
            port(AUDIO, LENS, sample_method=method, max_length=8),
            jax_tokens[method])


def test_bucket_padding_matches_jax():
    from audiocaption_tpu.hf_api import _pad_bucket
    from audiocaption_tpu_torch.hf_api import pad_bucket
    for n in (1, 15999, 16000, 16001, 40000):
        a = np.ones((2, n), np.float32)
        np.testing.assert_array_equal(pad_bucket(a, 16000),
                                      _pad_bucket(a, 16000))


def test_cuda_requested_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchAPI(TorchConfig(vocab_size=48))


def _exported(jax_api):
    from audiocaption_tpu.models import export
    return {k: torch.from_numpy(np.array(x)) for k, x in
            export.effb2_trm_hf_state_dict(jax_api.variables).items()}


def test_load_drops_keys_the_port_has_no_module_for(jax_api, jax_tokens):
    """A reference checkpoint also carries tensors the JAX converter never
    reads (EfficientNet's unused classifier, the feature extractor's
    buffers); the port drops them as well and decodes the same tokens."""
    gen = torch.Generator().manual_seed(0)
    extra = {
        "model.model.encoder.backbone.eff_net._fc.weight":
            torch.randn(10, 1408, generator=gen),
        "model.model.encoder.backbone.eff_net._fc.bias": torch.zeros(10),
        "model.model.encoder.melspec_extractor.mel_scale.fb":
            torch.rand(257, 64, generator=gen),
        "model.model.encoder.melspec_extractor.spectrogram.window":
            torch.hann_window(512)}
    port = TorchAPI(TorchConfig(vocab_size=48), seed=99, device="cpu")
    port.load_torch_state_dict({**_exported(jax_api), **extra})
    for method in ("greedy", "beam"):
        np.testing.assert_array_equal(
            port(AUDIO, LENS, sample_method=method, max_length=8),
            jax_tokens[method])


@pytest.mark.parametrize("key", [
    "model.model.decoder.model.layers.1.linear2.weight",
    "model.model.encoder.backbone.eff_net._blocks.3._bn1.running_var"])
def test_load_raises_on_a_missing_key(jax_api, key):
    sd = _exported(jax_api)
    del sd[key]
    port = TorchAPI(TorchConfig(vocab_size=48), device="cpu")
    with pytest.raises(RuntimeError, match=key.split(".")[-2]):
        port.load_torch_state_dict(sd)
