"""Three train steps of the port against the JAX package's
``make_train_step`` on the same weights and batches (the narrow flagship
of ``test_torch_train_forward``: full EffB2 plan, emb 64, vocab 50;
dropout and drop-connect 0), with the flagship recipe: label smoothing
0.1, Adam lr 5e-4 with L2 weight decay 1e-6, global-norm clip 1.0, the
exponential schedule with warm-up, scheduled sampling on (the JAX step's
``use_ss=True``; ``ss_ratio`` 1.0, then 0.0 twice, so the coins are
fixed).  The clip is active in every step (raw norms far above 1).

Before steps 2 and 3 the JAX state takes the port's parameters (its
Adam moments and BN statistics stay its own), so both packages take each
step's gradients at the same point.  Per step: loss relative 1e-5; raw
gradient norm relative 1e-4; every gradient element within
1e-4 * max(1, max |g|) of its tensor (JAX's gradients read off its Adam
moments, ``(mu_k - b1 mu_{k-1}) / (1 - b1) - wd p``, unclipped by the
raw norm); Adam ``mu`` / ``nu`` (mapped through the converter's key
space) within 1e-4 of each tensor's largest magnitude, as the gradients
they are made of, with a floor of 1e-6 of the largest moment of the
model (the clip scales every gradient by one global factor, and the
float32 noise of the backward is relative to that scale: the gradients
of a BN bias that feeds a train-mode BN are zero in exact arithmetic and
only that noise, so no bound relative to their own size can hold); BN
running statistics and parameters within 1e-5.  Adam divides gradients that lie
near float32 noise (an update of about lr * sign(g)), so a parameter
element may miss its bound: the test prints the largest miss and the
share of elements over the bound, which must stay under 0.1%.

The NaN skip (port only): a batch with a NaN leaves parameters, Adam
moments and step counts, the learning-rate count and every BN buffer
bit-identical.  The positional table ``pe`` never moves.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocaption_tpu.losses.loss import masked_token_loss as j_loss
from audiocaption_tpu.optim.schedules import (
    exponential_decay_with_warmup as j_schedule)
from audiocaption_tpu.training.trainer import (
    create_train_state as j_create_state, make_optimizer as j_optimizer,
    make_train_step)

from audiocaption_tpu_torch.losses.loss import masked_token_loss
from audiocaption_tpu_torch.models.convert import (
    DECODER_PREFIX, ENCODER_PREFIX, state_dict_from_jax)
from audiocaption_tpu_torch.optim.schedules import (
    exponential_decay_with_warmup)
from audiocaption_tpu_torch.training.trainer import (
    bn_buffers, create_train_state, train_step)

from test_torch_train_forward import (
    jax_batch, jax_model, jax_variables, make_batch, port_model, torch_batch)

LR, FINAL, TOTAL, WD, CLIP = 5e-4, 5e-7, 100, 1e-6, 1.0
SS = (1.0, 0.0, 0.0)
PARAM_ATOL, MISS_SHARE = 1e-5, 1e-3
MOMENT_RTOL, MOMENT_FLOOR = 1e-4, 1e-2
B1 = 0.9


def _ref_key(name: str) -> str:
    part, rest = name.split(".", 1)
    return {"encoder": ENCODER_PREFIX, "decoder": DECODER_PREFIX}[part] + rest


def _adam_state(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def _ref_space(tree, params, stats) -> dict:
    """A params-shaped JAX tree (masked leaves filled with zeros) in the
    reference key space, as numpy."""
    tree = jax.tree_util.tree_map(
        lambda t, p: np.zeros(np.shape(p), np.float32)
        if isinstance(t, optax.MaskedNode) else np.asarray(t),
        tree, params, is_leaf=lambda x: isinstance(x, optax.MaskedNode))
    sd = state_dict_from_jax({"params": tree, "batch_stats": stats})
    return {k: v.numpy() for k, v in sd.items()}


def _report_close(got: dict, want: dict, atol, what: str,
                  share_limit: float = 0.0) -> None:
    """Every entry within ``atol`` (a number, or a function of the wanted
    array); with ``share_limit``, a share of elements up to it may miss
    (printed with the largest miss).  Prints the largest |diff| / bound."""
    n_over = n_all = 0
    worst = (0.0, None)
    used = 0.0
    for k, w in want.items():
        tol = atol(w) if callable(atol) else atol
        d = np.abs(got[k] - w)
        n_over += int((d > tol).sum())
        n_all += d.size
        used = max(used, float(d.max() / tol))
        if (d - tol).max() > worst[0]:
            worst = (float((d - tol).max()), k)
    share = n_over / n_all
    print(f"{what}: largest |diff| / bound {used:.3g}")
    if n_over:
        print(f"{what}: {n_over}/{n_all} elements ({share:.2e}) over the "
              f"bound; largest miss {worst[0]:.3g} beyond it at {worst[1]}")
    assert share <= share_limit, (what, share, worst)


def _moment_tol(want: dict):
    """The bound of an Adam moment tensor: MOMENT_RTOL of its largest
    magnitude, or of MOMENT_FLOOR times the largest of the model."""
    floor = MOMENT_FLOOR * max(float(np.abs(w).max()) for w in want.values())
    return lambda w: MOMENT_RTOL * max(float(np.abs(w).max()), floor)


@pytest.fixture(scope="module")
def runs():
    """The three steps in both packages, with what each step leaves."""
    port = port_model()
    jmodel, jvars = jax_model(), jax_variables(port)
    warm = TOTAL // 5
    tx = j_optimizer(LR, j_schedule(LR, FINAL, TOTAL, warm), WD, CLIP)
    jstate = j_create_state(jvars, tx, jax.random.PRNGKey(0))
    jstep = make_train_step(jmodel, j_loss("label_smoothing", 0.1), tx,
                            donate=False, use_ss=True)
    state = create_train_state(
        port, LR, exponential_decay_with_warmup(LR, FINAL, TOTAL, warm),
        WD, CLIP)
    loss_fn = masked_token_loss("label_smoothing", 0.1)
    named = dict(port.named_parameters())
    pe0 = port.decoder.pos_encoder.pe.clone()
    steps = []
    j_mu_prev = None
    for k, ss in enumerate(SS):
        if k:
            synced = jax.tree_util.tree_map(
                jnp.asarray, jax_variables(port)["params"])
            assert (jax.tree_util.tree_structure(synced)
                    == jax.tree_util.tree_structure(jstate.params))
            jstate = jstate.replace(params=synced)
        j_params_prev = jax.device_get(jstate.params)
        b = make_batch(seed=10 + k)
        jstate, jm = jstep(jstate, jax_batch(b), jnp.float32(ss))
        jm = jax.device_get(jm)
        m = train_step(state, loss_fn, torch_batch(b),
                       ss_ratio=torch.tensor(ss), generator=torch.Generator())
        j_params = jax.device_get(jstate.params)
        j_stats = jax.device_get(jstate.batch_stats)
        adam = _adam_state(jax.device_get(jstate.opt_state))
        mu = _ref_space(adam.mu, j_params, j_stats)
        nu = _ref_space(adam.nu, j_params, j_stats)
        p_prev = _ref_space(j_params_prev, j_params_prev, j_stats)
        # JAX's clipped gradient read off its first moment, then unclipped
        g_clip = {key: (mu[key] - (B1 * j_mu_prev[key] if j_mu_prev else 0))
                  / (1 - B1) - WD * p_prev[key] for key in mu}
        unclip = max(1.0, float(jm["grad_norm"]) / CLIP)
        want = _ref_space(j_params, j_params, j_stats)
        coef = min(1.0, CLIP / (float(m["grad_norm"]) + 1e-6))
        ost = state.optimizer.state
        steps.append(dict(
            j_loss=float(jm["loss"]), j_norm=float(jm["grad_norm"]),
            j_skipped=bool(jm["skipped"]), loss=float(m["loss"]),
            norm=float(m["grad_norm"]), skipped=m["skipped"],
            j_grads={_ref_key(n): g_clip[_ref_key(n)] * unclip
                     for n in named},
            grads={_ref_key(n): p.grad.numpy() / coef
                   for n, p in named.items()},
            j_params=want,
            params={_ref_key(n): p.detach().numpy().copy()
                    for n, p in named.items()},
            j_mu={_ref_key(n): mu[_ref_key(n)] for n in named},
            j_nu={_ref_key(n): nu[_ref_key(n)] for n in named},
            mu={_ref_key(n): ost[p]["exp_avg"].numpy().copy()
                for n, p in named.items()},
            nu={_ref_key(n): ost[p]["exp_avg_sq"].numpy().copy()
                for n, p in named.items()},
            j_stats={k2: v for k2, v in want.items()
                     if k2.endswith(("running_mean", "running_var"))},
            stats={ENCODER_PREFIX + k2: v.numpy().copy()
                   for k2, v in port.encoder.state_dict().items()
                   if k2.endswith(("running_mean", "running_var"))}))
        j_mu_prev = mu
    return dict(steps=steps, state=state, loss_fn=loss_fn, pe0=pe0)


@pytest.mark.parametrize("k", range(len(SS)))
def test_loss_and_raw_grad_norm_match_jax(runs, k):
    s = runs["steps"][k]
    assert not s["skipped"] and not s["j_skipped"]
    assert s["norm"] > CLIP and s["j_norm"] > CLIP        # the clip acts
    np.testing.assert_allclose(s["loss"], s["j_loss"], rtol=1e-5)
    np.testing.assert_allclose(s["norm"], s["j_norm"], rtol=1e-4)


@pytest.mark.parametrize("k", range(len(SS)))
def test_grads_match_jax(runs, k):
    s = runs["steps"][k]
    _report_close(s["grads"], s["j_grads"],
                  lambda w: 1e-4 * max(1.0, np.abs(w).max()),
                  f"step {k} gradients")


@pytest.mark.parametrize("k", range(len(SS)))
def test_params_adam_moments_and_bn_stats_match_jax(runs, k):
    s = runs["steps"][k]
    assert set(s["params"]) == set(s["j_params"]) - {
        DECODER_PREFIX + "pos_encoder.pe"} - set(s["j_stats"]) - {
        k2 for k2 in s["j_params"] if k2.endswith("num_batches_tracked")}
    _report_close(s["params"], {k2: s["j_params"][k2] for k2 in s["params"]},
                  PARAM_ATOL, f"step {k} parameters", MISS_SHARE)
    _report_close(s["mu"], s["j_mu"], _moment_tol(s["j_mu"]),
                  f"step {k} Adam mu")
    _report_close(s["nu"], s["j_nu"], _moment_tol(s["j_nu"]),
                  f"step {k} Adam nu")
    _report_close(s["stats"], s["j_stats"], PARAM_ATOL, f"step {k} BN stats")


def test_nan_step_changes_nothing(runs):
    state = runs["state"]
    model = state.model
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt_before = {id(p): {k: v.clone() for k, v in st.items()}
                  for p, st in state.optimizer.state.items()}
    lr_before = [g["lr"] for g in state.optimizer.param_groups]
    count_before = state.lr_count
    b = torch_batch(make_batch(seed=20))
    b["wav"][1, 100] = float("nan")
    m = train_step(state, runs["loss_fn"], b, ss_ratio=torch.tensor(0.5),
                   generator=torch.Generator())
    assert m["skipped"] and not np.isfinite(float(m["loss"]))
    after = model.state_dict()
    for k, v in before.items():
        assert torch.equal(v, after[k]), k
    assert {k for k in after if k.endswith("num_batches_tracked")}
    for p, st in state.optimizer.state.items():
        for k, v in st.items():
            assert torch.equal(v, opt_before[id(p)][k]), k
    assert state.lr_count == count_before == len(SS)
    assert [g["lr"] for g in state.optimizer.param_groups] == lr_before
    assert all(p.grad is None for p in state.params)
    # BN buffers: the forward did update them, and the skip put them back
    assert len(bn_buffers(model)) == 3 * sum(
        1 for _ in filter(lambda m_: isinstance(m_, torch.nn.BatchNorm2d),
                          model.modules()))


def test_pe_never_moves(runs):
    state = runs["state"]
    pe = state.model.decoder.pos_encoder.pe
    assert torch.equal(pe, runs["pe0"])
    assert all(p is not pe for p in state.params)
    assert not any(n.endswith("pe") for n, _ in
                   state.model.named_parameters())
