"""Transformer decoder and torch decoding engine of the PyTorch port
against the JAX package, on decoder weights carried across by the
converter (jittered so trajectories depend on the weights) and on the
same random encoder outputs.  Tolerances: full-sequence logits atol 1e-4;
step == full forward atol 1e-9 in float64; greedy and beam tokens exact;
n-best beam scores atol 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocaption_tpu_torch.models.captioner import Captioner as TCap
from audiocaption_tpu_torch.models.captioner import generate as tgenerate
from audiocaption_tpu_torch.models.convert import decoder_state_dict_from_jax
from audiocaption_tpu_torch.models.effb2 import EfficientNetB2 as TEffB2
from audiocaption_tpu_torch.models.transformer_decoder import (
    TransformerDecoder as TDec)
from audiocaption_tpu_torch.ops.frontend import EFFB2_MEL_16K as TMEL

torch.set_num_threads(1)

E, V, D_ATTN, NL, S = 128, 48, 64, 2, 9


@pytest.fixture(scope="module")
def pair():
    """(jax captioner, jax variables, torch captioner)."""
    from audiocaption_tpu.models.captioner import Captioner
    from audiocaption_tpu.models.effb2 import EfficientNetB2
    from audiocaption_tpu.models.transformer_decoder import (
        TransformerDecoder)
    from audiocaption_tpu.ops.frontend import EFFB2_MEL_16K
    jdec = TransformerDecoder(emb_dim=E, vocab_size=V, attn_emb_dim=D_ATTN,
                              nlayers=NL, tie_weights=True)
    params = jdec.init(jax.random.PRNGKey(1), jnp.ones((1, 4), jnp.int32),
                       jnp.zeros((1, 5, D_ATTN)), jnp.asarray([5]))["params"]
    rng = np.random.RandomState(3)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x)
        + rng.randn(*np.shape(x)).astype(np.float32) * 0.3,
        jax.device_get(params))
    jmodel = Captioner(encoder=EfficientNetB2(), decoder=jdec,
                       mel=EFFB2_MEL_16K)
    tdec = TDec(E, V, D_ATTN, nlayers=NL, tie_weights=True)
    tdec.load_state_dict(decoder_state_dict_from_jax(params, NL, True))
    tmodel = TCap(TEffB2(), tdec, TMEL).eval()
    return jmodel, {"params": {"decoder": params}}, tmodel


def encoder_out(B, seed):
    rng = np.random.RandomState(seed)
    attn = rng.randn(B, S, D_ATTN).astype(np.float32)
    lens = np.asarray([S] + [int(x) for x in rng.randint(1, S + 1, B - 1)])
    return attn, lens


def test_full_sequence_logits_match_jax(pair):
    jmodel, v, tmodel = pair
    attn, lens = encoder_out(2, 0)
    rng = np.random.RandomState(5)
    word = rng.randint(0, V, (2, 6)).astype(np.int64)
    word[:, 0] = 1
    word[1, 4:] = 0                                         # padded caption
    want = jmodel.decoder.apply(
        {"params": v["params"]["decoder"]}, jnp.asarray(word),
        jnp.asarray(attn), jnp.asarray(lens),
        cap_padding_mask=jnp.asarray(word == 0))["logit"]
    with torch.no_grad():
        got = tmodel.decoder(torch.from_numpy(word), torch.from_numpy(attn),
                             torch.from_numpy(lens),
                             cap_padding_mask=torch.from_numpy(word == 0))
    np.testing.assert_allclose(got["logit"].numpy(), np.asarray(want),
                               atol=1e-4, rtol=0)


def test_step_matches_full_forward(pair):
    """The cached step path computes the full forward's logits.  Run in
    float64: the jittered layer norms amplify float32 rounding up to
    ~3e-3 on some rows, which would hide the identity being tested."""
    import copy
    _, _, tmodel = pair
    dec = copy.deepcopy(tmodel.decoder).double()
    attn, lens = encoder_out(3, 1)
    attn, lens = torch.from_numpy(attn).double(), torch.from_numpy(lens)
    word = torch.randint(3, V, (3, 7), generator=torch.Generator()
                         .manual_seed(0))
    with torch.no_grad():
        full = dec(word, attn, lens)["logit"]
        static, dyn = dec.init_cache(attn, lens, 7)
        for t in range(7):
            logit, dyn = dec.step(word[:, t], t, static, dyn)
            np.testing.assert_allclose(logit.numpy(), full[:, t].numpy(),
                                       atol=1e-9, rtol=0)


def _jax_generate(pair, attn, lens, **kw):
    from audiocaption_tpu.models.captioner import generate
    jmodel, v, _ = pair
    enc = {"attn_emb": jnp.asarray(attn), "attn_emb_len": jnp.asarray(lens),
           "fc_emb": jnp.zeros((attn.shape[0], D_ATTN))}
    return generate(jmodel, v, enc_override=enc, **kw)


def _torch_generate(pair, attn, lens, **kw):
    _, _, tmodel = pair
    enc = {"attn_emb": torch.from_numpy(attn),
           "attn_emb_len": torch.from_numpy(lens)}
    return tgenerate(tmodel, None, None, enc=enc, **kw)


def test_engine_greedy_matches_jax(pair):
    attn, lens = encoder_out(3, 2)
    want = _jax_generate(pair, attn, lens, sample_method="greedy",
                         max_length=8)["seq"]
    got = _torch_generate(pair, attn, lens, sample_method="greedy",
                          max_length=8)["seq"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(np.asarray(want))) > 2


@pytest.mark.parametrize("temp", [1.0, 1.5])
def test_engine_beam_matches_jax(pair, temp):
    attn, lens = encoder_out(3, 3)
    kw = dict(sample_method="beam", beam_size=3, max_length=8, temp=temp,
              n_best=True)
    want = _jax_generate(pair, attn, lens, **kw)
    got = _torch_generate(pair, attn, lens, **kw)
    np.testing.assert_array_equal(got["seq"].numpy(), np.asarray(want["seq"]))
    np.testing.assert_allclose(got["score"].numpy(),
                               np.asarray(want["score"]), atol=1e-4)


def test_engine_top_k_ties_go_to_lower_index():
    from audiocaption_tpu_torch.decoding.engine import top_k_stable
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    vals, idx = top_k_stable(x, 4)
    assert idx.tolist() == [[1, 2, 4, 3]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 2.0]]
