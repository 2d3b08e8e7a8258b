"""The PyTorch port's ``Cnn14RnnTempAttnGruModel`` (on the CPU) against the
JAX package's, on weights carried across by ``tempgru_state_dict_from_jax``:
greedy and beam-3 tokens identical, with and without a user temporal tag,
and equal SED tags.

One JAX model is built for the whole file (its construction dominates the
file's time).  Its decoder is jittered (0.4) so decodes depend on the
weights, every batch-norm gets non-identity statistics so the encoders do
not collapse, and the SED classifier is sharpened (x1.8) so the SED tags
are not all 0 and a user tag changes the merged tag."""

import numpy as np
import pytest
import torch

import jax

from audiocaption_tpu_torch.hf_api import (
    Cnn14RnnTempAttnGruConfig as TorchConfig,
    Cnn14RnnTempAttnGruModel as TorchAPI)
from audiocaption_tpu_torch.models.convert import tempgru_state_dict_from_jax

from test_torch_effb2 import jitter_bn

torch.set_num_threads(1)

SR = 32000
LENS = [32000, 20000]
USER_TAG = [2, 1]
MAX_LEN = 12


def _audio():
    audio = (np.random.RandomState(2).randn(2, SR) * 0.1).astype(np.float32)
    audio[1, LENS[1]:] = 0.0
    return audio


@pytest.fixture(scope="module")
def jax_api():
    from audiocaption_tpu.hf_api import (Cnn14RnnTempAttnGruConfig,
                                         Cnn14RnnTempAttnGruModel)
    api = Cnn14RnnTempAttnGruModel(Cnn14RnnTempAttnGruConfig(vocab_size=48),
                                   seed=3)
    rng = np.random.RandomState(0)
    v = jax.device_get(api.variables)
    v = {"params": dict(v["params"]), "batch_stats": dict(v["batch_stats"])}
    v["params"]["decoder"] = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.randn(*np.shape(x)).astype(np.float32)
        * 0.4, v["params"]["decoder"])
    jitter_bn(v["params"]["encoder"], v["batch_stats"]["encoder"], rng)
    sv = jax.device_get(api.sed_variables)
    sv = {"params": dict(sv["params"]), "batch_stats": dict(sv["batch_stats"])}
    jitter_bn(sv["params"], sv["batch_stats"], rng)
    sv["params"]["fc_audioset"] = {
        "kernel": np.asarray(sv["params"]["fc_audioset"]["kernel"]) * 1.8,
        "bias": np.asarray(sv["params"]["fc_audioset"]["bias"])}
    api.variables, api.sed_variables = v, sv
    return api


@pytest.fixture(scope="module")
def state_dict(jax_api):
    return tempgru_state_dict_from_jax(jax_api.variables,
                                       jax_api.sed_variables)


@pytest.fixture(scope="module")
def port(state_dict):
    return TorchAPI(TorchConfig(vocab_size=48), state_dict=state_dict,
                    device="cpu")


def test_converter_equals_export(jax_api, state_dict):
    from audiocaption_tpu.models import export
    want = export.cnn14rnn_tempgru_hf_state_dict(jax_api.variables,
                                                 jax_api.sed_variables)
    assert list(state_dict) == list(want)
    for k in want:
        np.testing.assert_array_equal(state_dict[k].numpy(),
                                      np.asarray(want[k]), err_msg=k)


def test_port_modules_are_the_reference_key_space(state_dict):
    port = TorchAPI(TorchConfig(vocab_size=48), device="cpu")
    assert set(port.model.state_dict()) == set(state_dict)


def test_sed_tags_equal(jax_api, port):
    import jax.numpy as jnp
    from audiocaption_tpu.models.sed import framewise_to_temporal_tags
    audio = _audio()
    jlms = jax_api._lms_fn()(jnp.asarray(audio))
    want_fw = np.asarray(jax_api._sed_fn()(jax_api.sed_variables, jlms))
    lms = port.log_mel(torch.from_numpy(audio))
    with torch.no_grad():
        got_fw = port.model.sed_model(lms)["framewise_output"].numpy()
    np.testing.assert_allclose(got_fw, want_fw, atol=1e-5, rtol=0)
    tags = port.sed_tags(lms)
    np.testing.assert_array_equal(tags, framewise_to_temporal_tags(want_fw))
    # the user tag below changes what the decoder is conditioned on
    assert tags.any() and (np.minimum(USER_TAG, tags) != tags).any()


@pytest.mark.parametrize("tag", [None, USER_TAG], ids=["sed_tag", "user_tag"])
@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_api_tokens_match_jax(jax_api, port, method, tag):
    audio = _audio()
    want = jax_api(audio, LENS, temporal_tag=tag, sample_method=method,
                   max_length=MAX_LEN)
    got = port(audio, LENS, temporal_tag=tag, sample_method=method,
               max_length=MAX_LEN)
    assert got.dtype == np.int32 and got.shape == (2, MAX_LEN)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_load_torch_checkpoint_token_parity(jax_api, port, state_dict,
                                            tmp_path):
    path = tmp_path / "tempgru.bin"
    torch.save(state_dict, path)
    fresh = TorchAPI(TorchConfig(vocab_size=48), seed=77, device="cpu")
    audio = _audio()
    want = port(audio, LENS, sample_method="greedy", max_length=MAX_LEN)
    assert not np.array_equal(
        fresh(audio, LENS, sample_method="greedy", max_length=MAX_LEN), want)
    fresh.load_torch_checkpoint(str(path))
    np.testing.assert_array_equal(
        fresh(audio, LENS, sample_method="greedy", max_length=MAX_LEN), want)
    # no {"state_dict": ...} unwrapping for this model, as in the JAX package
    torch.save({"state_dict": state_dict}, path)
    with pytest.raises(RuntimeError, match="state_dict"):
        fresh.load_torch_checkpoint(str(path))


def test_load_drops_keys_the_port_has_no_module_for(port, state_dict):
    """Keys the JAX converter never reads (the captioner's and the SED's
    feature-extractor buffers) are dropped; the tokens stay the same."""
    gen = torch.Generator().manual_seed(0)
    extra = {"cap_model.encoder.cnn.melspec_extractor.mel_scale.fb":
             torch.rand(513, 64, generator=gen),
             "sed_model.spectrogram_extractor.stft.conv_real.weight":
             torch.randn(513, 1, 1024, generator=gen)}
    fresh = TorchAPI(TorchConfig(vocab_size=48), seed=77, device="cpu")
    fresh.load_torch_state_dict({**state_dict, **extra})
    audio = _audio()
    for method in ("greedy", "beam"):
        np.testing.assert_array_equal(
            fresh(audio, LENS, sample_method=method, max_length=MAX_LEN),
            port(audio, LENS, sample_method=method, max_length=MAX_LEN))


@pytest.mark.parametrize("key", ["sed_model.fc1.weight",
                                 "cap_model.decoder.attn.v"])
def test_load_raises_on_a_missing_key(state_dict, key):
    sd = dict(state_dict)
    del sd[key]
    fresh = TorchAPI(TorchConfig(vocab_size=48), device="cpu")
    with pytest.raises(RuntimeError, match=key.split(".")[-2]):
        fresh.load_torch_state_dict(sd)


@pytest.mark.parametrize("tag", [None, USER_TAG], ids=["sed_tag", "user_tag"])
def test_api_dbs_matches_jax(jax_api, port, tag):
    """Diverse beam search through the temporal API (the API's beam 3 in
    the default 3 groups: [B, 3, L]) equals the JAX API's."""
    audio = _audio()
    want = np.asarray(jax_api(audio, LENS, temporal_tag=tag,
                              sample_method="dbs", max_length=MAX_LEN))
    got = port(audio, LENS, temporal_tag=tag, sample_method="dbs",
               max_length=MAX_LEN)
    assert got.shape == want.shape == (2, 3, MAX_LEN)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["sample", "top5", "top0.9", "gumbel"])
def test_api_sampling_methods_pass_through(port, method):
    """The sampling methods reach the engine with the JAX API's shape, and
    a repeated call draws the same (a fresh generator seeded with 0)."""
    audio = _audio()
    a = port(audio, LENS, sample_method=method, max_length=MAX_LEN)
    assert a.dtype == np.int32 and a.shape == (2, MAX_LEN)
    np.testing.assert_array_equal(
        a, port(audio, LENS, sample_method=method, max_length=MAX_LEN))
