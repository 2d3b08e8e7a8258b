"""SCST of a GRU decoder in the port (``training/scst.py``) against the JAX
package's ``make_scst_fns`` (its jitted sample pass and its jitted loss
and gradients), on a ``Cnn6Encoder`` with a 2-layer
``BahAttnAddFcDecoder`` (emb and d_model 32, vocab 40) built from one
config in both packages (``test_torch_family.jax_pair``) and 3 clips of
at most 1 s.

  * the sample pass, fed the draws of JAX's own ``split`` chain from the
    key handed to the JAX ``sample_fn``, gives JAX's greedy and sampled
    sequences exactly (the torch engine: no kernel decodes a GRU);
  * given those sequences and rewards: the loss within relative 1e-5 and
    every gradient element within 1e-4 * max(1, max |g|) of its tensor;
  * the grad pass's log-probabilities of the sampled words (teacher-forced
    through ``step``, as JAX's ``loss_fn``) equal the sampler's within
    1e-5 on every masked position;
  * a JAX-side fault kept for parity, pinned: JAX builds the GRU cache
    with no temporal tag, so SCST of the temporal decoder runs every clip
    on tag 0 (``TemporalBahAttnDecoder.init_cache``).  The port's
    ``scst_step`` does the same whatever tags the batch carries: its
    sampled words match JAX's, and its grad-pass log-probabilities are
    those of tag 0 and not those of the batch's tags (ROADMAP Queue 3)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocaption_tpu.training.scst import make_scst_fns

from audiocaption_tpu_torch.training.scst import (
    compute_batch_score, sample_pass, scst_loss, scst_mask, scst_mode,
    scst_step)
from audiocaption_tpu_torch.training.trainer import create_train_state
from audiocaption_tpu_torch.optim.schedules import (
    exponential_decay_with_warmup)

from test_torch_family import V, clips, jax_pair, model_node

L = 10
KEYS = ["c0", "c1", "c0"]
IDX2WORD = {i: f"w{i}" for i in range(V)}


def chain_noise(key, shape, length=L):
    """``noise(t, shape)`` replaying JAX's sampling draws: step t uses the
    second half of the t-th ``split`` of ``key`` (Gumbel noise)."""
    draws, k = [], key
    for _ in range(length):
        k, sub = jax.random.split(k)
        draws.append(torch.from_numpy(np.array(jax.random.gumbel(sub,
                                                                 shape))))
    return lambda t, shp: draws[t]


def _refs(sampled: np.ndarray) -> dict:
    words = lambda row: " ".join(IDX2WORD[int(w)] for w in row[:4])  # noqa
    return {"c0": [words(sampled[0]), "w3 w4 w5"],
            "c1": [words(sampled[1][::-1]), words(sampled[1])]}


def _jax_sample(jmodel, jvars, b, key):
    sample_fn, loss_grad_fn = make_scst_fns(jmodel, max_length=L)
    greedy, sampled = jax.device_get(sample_fn(
        jvars, jnp.asarray(b["wav"]),
        jnp.asarray(b["wav_len"].astype(np.int32)), key))
    return np.asarray(greedy), np.asarray(sampled), loss_grad_fn


@pytest.fixture(scope="module")
def runs():
    b = clips(seed=21, B=3)
    node = model_node("Cnn6Encoder", "BahAttnAddFcDecoder", 32, 32, 2)
    jmodel, jvars, port = jax_pair(node, b, seed=4)
    key = jax.random.PRNGKey(5)
    j_greedy, j_sampled, loss_grad_fn = _jax_sample(jmodel, jvars, b, key)
    wav, wav_len = torch.from_numpy(b["wav"]), torch.from_numpy(b["wav_len"])
    s = sample_pass(port, wav, wav_len, L, 1.0,
                    noise=chain_noise(key, (3, V)))
    refs = _refs(j_sampled)
    r_s = compute_batch_score(j_sampled, refs, KEYS, IDX2WORD, 1, 2)
    r_g = compute_batch_score(j_greedy, refs, KEYS, IDX2WORD, 1, 2)
    adv = (r_s - r_g).astype(np.float32)
    mask = scst_mask(j_sampled, 2)
    j_loss, j_grads = jax.device_get(loss_grad_fn(
        jvars["params"], jvars["batch_stats"], jnp.asarray(b["wav"]),
        jnp.asarray(b["wav_len"].astype(np.int32)), jnp.asarray(j_sampled),
        jnp.asarray(adv), jnp.asarray(mask)))
    with scst_mode(port):
        loss, tok_lp = scst_loss(port, wav, wav_len,
                                 torch.from_numpy(j_sampled.copy()).long(),
                                 torch.from_numpy(adv),
                                 torch.from_numpy(mask))
        loss.backward()
    from test_torch_family import port_grads_space
    return dict(s=s, j_greedy=j_greedy, j_sampled=j_sampled, adv=adv,
                mask=mask, j_loss=float(j_loss), loss=float(loss.detach()),
                tok_lp=tok_lp.detach().numpy(),
                j_grads=port_grads_space(j_grads, jvars["params"],
                                         jvars["batch_stats"]),
                grads={n: p.grad.numpy() for n, p in port.named_parameters()})


def test_sample_pass_matches_jax(runs):
    np.testing.assert_array_equal(runs["s"]["greedy"].numpy(),
                                  runs["j_greedy"])
    np.testing.assert_array_equal(runs["s"]["sampled"].numpy(),
                                  runs["j_sampled"])
    assert len(np.unique(runs["j_sampled"])) > 3
    assert np.abs(runs["adv"]).max() > 0


def test_loss_and_grads_match_jax(runs):
    np.testing.assert_allclose(runs["loss"], runs["j_loss"], rtol=1e-5)
    assert set(runs["grads"]) <= set(runs["j_grads"])
    for k, g in runs["grads"].items():
        w = runs["j_grads"][k]
        tol = 1e-4 * max(1.0, np.abs(w).max())
        assert np.abs(g - w).max() <= tol, k
    assert np.abs(runs["grads"]["decoder.model.weight_ih_l1"]).max() > 0
    assert np.abs(runs["grads"]["encoder.conv_block1.conv1.weight"]
                  ).max() > 0


def test_grad_pass_logprobs_equal_the_samplers(runs):
    m = runs["mask"] > 0
    np.testing.assert_allclose(runs["tok_lp"][m],
                               runs["s"]["sampled_logprob"].numpy()[m],
                               atol=1e-5, rtol=0)


def test_temporal_decoder_runs_on_tag_zero():
    b = clips(seed=22, B=3)
    node = model_node("Cnn6Encoder", "TemporalBahAttnDecoder", 32, 32, 1)
    jmodel, jvars, port = jax_pair(node, b, seed=6)
    key = jax.random.PRNGKey(9)
    j_greedy, j_sampled, _ = _jax_sample(jmodel, jvars, b, key)
    refs = _refs(j_sampled)
    batch = {"wav": torch.from_numpy(b["wav"]),
             "wav_len": torch.from_numpy(b["wav_len"]),
             "temporal_tag": torch.tensor([1, 2, 3])}
    # a step at lr 1e-30: the weights stay put for the checks after it
    state = create_train_state(port, 1e-30, exponential_decay_with_warmup(
        1e-30, 1e-30, 10, 1))
    out = scst_step(state, batch, KEYS, refs, IDX2WORD, L,
                    noise=chain_noise(key, (3, V)))
    np.testing.assert_array_equal(out["greedy"].cpu().numpy(), j_greedy)
    np.testing.assert_array_equal(out["sampled"].cpu().numpy(), j_sampled)
    # the grad pass's log-probabilities are tag 0's, not the batch's tags'
    dec = port.eval().decoder
    with torch.no_grad():
        enc = port.encode(batch["wav"], batch["wav_len"])
    word = torch.cat([torch.ones(3, 1, dtype=torch.long),
                      out["sampled"][:, :-1]], 1)

    @torch.no_grad()
    def tok_lp(tag):
        static, dyn = dec.init_cache(enc["attn_emb"], enc["attn_emb_len"],
                                     enc["fc_emb"], L, temporal_tag=tag)
        lps = []
        for t in range(L):
            logit, dyn = dec.step(word[:, t], t, static, dyn)
            lps.append(torch.log_softmax(logit, -1).gather(
                -1, out["sampled"][:, t:t + 1])[:, 0])
        return torch.stack(lps, 1).numpy()
    m = out["mask"].numpy() > 0
    got = out["token_logprob"].numpy()
    np.testing.assert_allclose(got[m], tok_lp(torch.zeros(3).long())[m],
                               atol=1e-5, rtol=0)
    assert np.abs(got - tok_lp(batch["temporal_tag"]))[m].max() > 1e-3
