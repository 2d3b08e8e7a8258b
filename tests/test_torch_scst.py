"""One SCST step of the port (``training/scst.py``) against the JAX
package's (``make_scst_fns``: the jitted sample pass and the jitted loss
and gradients; its runner's optax update), on the narrow flagship of
``test_torch_train_forward`` (full EffB2 plan, emb 64, vocab 50, tied;
BN statistics and decoder jittered) and 3 clips of at most 1 s.

  * ``scst_mask`` and ``compute_batch_score`` (with a repeated clip, and
    the port's native scorer against the JAX package's) equal JAX's;
  * the sample pass, fed the draws of JAX's own ``split`` chain from the
    key handed to the JAX ``sample_fn``, gives JAX's greedy and sampled
    sequences exactly;
  * given those sequences and the rewards: loss within relative 1e-5;
    every gradient element within 1e-4 * max(1, max |g|) of its tensor
    (the port's clipped gradients scaled back by the clip's factor);
  * after one Adam step (L2 1e-6 and clip 1.0 of the recipe of
    ``configs/synthetic_v2/scst.yaml``, its exponential schedule, but at
    a first-step learning rate of 5e-4, 50 times the tolerance: Adam's
    first step moves each element by at most the learning rate, so at the
    recipe's 5e-5 warmed up over 20 steps no fault of the step could
    show) the parameters within 1e-5, with at most 0.1% of elements over
    (Adam's first step moves a near-zero gradient by about lr * sign(g),
    see ``test_torch_train_step``);
  * a step with every advantage 0 has zero gradients, so Adam moves each
    parameter by its L2 weight decay alone, as JAX's does;
  * the grad pass's log-probabilities of the sampled words equal the
    sampler's within 1e-5 on every masked position, and no BN statistic
    moves (the step runs in inference mode; JAX applies its grad pass
    without ``mutable``)."""

import copy

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocaption_tpu.metrics.cider import CiderD as JCiderD
from audiocaption_tpu.optim.schedules import (
    exponential_decay_with_warmup as j_schedule)
from audiocaption_tpu.training.scst import (
    compute_batch_score as j_batch_score, make_scst_fns,
    scst_mask as j_scst_mask)
from audiocaption_tpu.training.trainer import make_optimizer as j_optimizer

from audiocaption_tpu_torch.optim.schedules import (
    exponential_decay_with_warmup)
from audiocaption_tpu_torch.training.scst import (
    apply_scst, compute_batch_score, sample_pass, scst_mask)
from audiocaption_tpu_torch.training.trainer import (
    bn_buffers, create_train_state)

from test_torch_sampling import jax_chain_noise
from test_torch_train_forward import (
    V, jax_model, jax_variables, make_batch, port_model)
from test_torch_train_step import _ref_key, _ref_space, _report_close

L, LR, FINAL, TOTAL, WARMUP, WD, CLIP = 10, 5e-4, 5e-7, 100, 1, 1e-6, 1.0
KEYS = ["c0", "c1", "c0"]            # clip c0 twice: scored once
IDX2WORD = {i: f"w{i}" for i in range(V)}


def test_scst_mask_matches_jax():
    rng = np.random.RandomState(0)
    seq = rng.randint(0, 6, (7, 9))
    seq[3] = 5                                    # no <eos> at all
    np.testing.assert_array_equal(scst_mask(seq, 2), j_scst_mask(seq, 2))


def _refs(sampled: np.ndarray) -> dict:
    """References that share words with the samples, so rewards differ."""
    words = lambda row: " ".join(IDX2WORD[int(w)] for w in row[:4])
    return {"c0": [words(sampled[0]), "w3 w4 w5"],
            "c1": [words(sampled[1][::-1]), words(sampled[1])]}


@pytest.fixture(scope="module")
def runs():
    port = port_model()
    jmodel, jvars = jax_model(), jax_variables(port)
    b = make_batch(seed=30)
    wav, wav_len = b["wav"], b["wav_len"]
    key = jax.random.PRNGKey(5)
    sample_fn, loss_grad_fn = make_scst_fns(jmodel, max_length=L)
    j_greedy, j_sampled = jax.device_get(sample_fn(
        jvars, jnp.asarray(wav), jnp.asarray(wav_len.astype(np.int32)), key))
    s = sample_pass(port, torch.from_numpy(wav), torch.from_numpy(wav_len),
                    L, 1.0, noise=jax_chain_noise("sample", key, (3, V)))
    sampled = np.array(j_sampled)
    refs = _refs(sampled)
    r_s = compute_batch_score(sampled, refs, KEYS, IDX2WORD, 1, 2)
    r_g = compute_batch_score(np.asarray(j_greedy), refs, KEYS, IDX2WORD, 1,
                              2)
    advantage = (r_s - r_g).astype(np.float32)
    mask = scst_mask(sampled, 2)

    j_loss, j_grads = loss_grad_fn(
        jvars["params"], jvars["batch_stats"], jnp.asarray(wav),
        jnp.asarray(wav_len.astype(np.int32)), jnp.asarray(sampled),
        jnp.asarray(advantage), jnp.asarray(mask))
    tx = j_optimizer(LR, j_schedule(LR, FINAL, TOTAL, WARMUP), WD, CLIP)
    params = jax.tree_util.tree_map(jnp.asarray, jvars["params"])

    @jax.jit                  # one program: eager optax compiles per op
    def adam_step(grads, params):
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates)
    j_new = jax.device_get(adam_step(j_grads, params))
    j_decayed = jax.device_get(adam_step(
        jax.tree_util.tree_map(jnp.zeros_like, j_grads), params))
    stats = jvars["batch_stats"]

    def port_step(model, adv):
        state = create_train_state(
            model, LR, exponential_decay_with_warmup(LR, FINAL, TOTAL,
                                                     WARMUP), WD, CLIP)
        return apply_scst(state, torch.from_numpy(wav),
                          torch.from_numpy(wav_len),
                          torch.from_numpy(sampled.copy()).long(),
                          torch.from_numpy(adv), torch.from_numpy(mask))

    def port_params(model):
        return {_ref_key(n): p.detach().numpy().copy()
                for n, p in model.named_parameters()}

    start = port_params(port)
    zero_adv = copy.deepcopy(port)
    bn_before = [b_.clone() for b_ in bn_buffers(port)]
    named = dict(port.named_parameters())
    m = port_step(port, advantage)
    coef = min(1.0, CLIP / (float(m["grad_norm"]) + 1e-6))
    m0 = port_step(zero_adv, np.zeros_like(advantage))
    return dict(
        port_seq=s, j_greedy=np.asarray(j_greedy), j_sampled=sampled,
        refs=refs, r_s=r_s, r_g=r_g, mask=mask, m=m,
        j_loss=float(j_loss),
        j_grads=_ref_space(jax.device_get(j_grads), j_new, stats),
        grads={_ref_key(n): p.grad.numpy() / coef for n, p in named.items()},
        j_params=_ref_space(j_new, j_new, stats),
        params=port_params(port), start=start,
        zero_grads={n: p.grad for n, p in zero_adv.named_parameters()},
        zero_loss=float(m0["loss"]),
        j_decayed=_ref_space(j_decayed, j_new, stats),
        decayed=port_params(zero_adv),
        bn_same=all(torch.equal(a, b_) for a, b_ in
                    zip(bn_before, bn_buffers(port))))


def test_compute_batch_score_matches_jax(runs):
    for seq in (runs["j_sampled"], runs["j_greedy"]):
        want = j_batch_score(seq, runs["refs"], KEYS, IDX2WORD, 1, 2,
                             scorer=JCiderD())
        got = compute_batch_score(seq, runs["refs"], KEYS, IDX2WORD, 1, 2)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        assert got[0] == got[2]                   # the repeated clip
    assert np.any(runs["r_s"] != runs["r_g"])     # a non-zero advantage


def test_sample_pass_matches_jax(runs):
    s = runs["port_seq"]
    np.testing.assert_array_equal(s["greedy"].numpy(), runs["j_greedy"])
    np.testing.assert_array_equal(s["sampled"].numpy(), runs["j_sampled"])
    assert not np.array_equal(runs["j_greedy"], runs["j_sampled"])


def test_loss_and_grads_match_jax(runs):
    m = runs["m"]
    np.testing.assert_allclose(float(m["loss"]), runs["j_loss"], rtol=1e-5)
    _report_close(runs["grads"], {k: runs["j_grads"][k]
                                  for k in runs["grads"]},
                  lambda w: 1e-4 * max(1.0, np.abs(w).max()),
                  "SCST gradients")


def test_adam_step_matches_jax(runs):
    _report_close(runs["params"], {k: runs["j_params"][k]
                                   for k in runs["params"]},
                  1e-5, "SCST step parameters", 1e-3)


def test_zero_advantage_step_is_weight_decay_alone(runs):
    assert runs["zero_loss"] == 0.0
    assert all(g is None or not g.any() for g in runs["zero_grads"].values())
    moved = max(float(np.abs(runs["decayed"][k] - runs["start"][k]).max())
                for k in runs["start"])
    assert moved > 0.5 * LR                       # decay moved parameters
    _report_close(runs["decayed"], {k: runs["j_decayed"][k]
                                    for k in runs["decayed"]},
                  1e-5, "zero-advantage step parameters")


def test_grad_pass_is_the_sampler_and_bn_stays(runs):
    mask = torch.from_numpy(runs["mask"]) > 0
    got = runs["m"]["token_logprob"][mask]
    want = runs["port_seq"]["sampled_logprob"][mask]
    assert float((got - want).abs().max()) <= 1e-5
    assert runs["bn_same"]
