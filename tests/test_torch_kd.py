"""The port's KD losses, heads and steps against the JAX package's
(``audiocaption_tpu/losses/kd.py``, ``training/distill.py``).

Losses and heads, on seeded numpy inputs: ``token_kd_loss`` (kl, l2, l1
at temperatures 1 and 2, length-masked), ``sup_kd_loss``,
``info_nce_loss`` and the three encoder-KD heads (the JAX heads' own
initialised parameters carried to the port by
``kd_head_state_dict_from_jax``): within 1e-6 relative.

Steps, on the KD student of ``test_torch_cdur5`` (V=60, every dropout 0;
flax ``Dropout`` made the identity by ``intercept_methods``) with the
recipe of ``configs/synthetic_v2/kd_token.yaml``: Adam 5e-4 with L2 1e-6,
clip 1.0, the exponential schedule with a fifth of warm-up, label
smoothing 0.1.  Three token-KD steps (KL, T=2, weight 0.5; seeded teacher
logits) against ``make_token_kd_step`` (called with a traced ss_ratio of
1.0, as the JAX runner calls it: its cached path, whose loss and
gradients are teacher forcing's), then one encoder-KD step with captions
and one without (``ContraEncoderKdHead``, shared width 32, seeded teacher
embeddings) against ``make_encoder_kd_step``.  Before each JAX step its
state takes the port's parameters (Adam moments and BN statistics stay
its own), as in ``test_torch_train_step``.  Per step: loss relative
1e-5; the clipped gradients (JAX's read off its Adam moments:
``(mu_k - b1 mu_{k-1}) / (1 - b1) - wd p``) and both Adam moments within
1e-4 of each tensor's largest magnitude, with the floors of
``test_torch_train_step``: a gradient within 1e-4 * max(1, max |g|)
unclipped, i.e. the clip factor as the floor of a clipped one; a moment
1e-2 of the largest of the model, or for the first moment the gradient
floor carried through it, (1 - b1) times the clip factor, if that is
larger.  (b1's BN scale is one number summed
over every log-mel bin of the batch, ~2e4 terms that cancel to ~1e-3 of
their size, so float32 order alone moves it by ~1e-4 of itself.)  In
the unsup step the decoder,
which the loss does not reach, has a zero gradient in the port and a
readout below 1e-9 in JAX (float32 rounding of the moment arithmetic).
Neither package skips a step (no NaN skip in KD).

A precondition of each step, asserted first: the two packages take the
same branch at every LeakyReLU of the encoder (the sign of every
Block2D conv output, train mode, this step's weights and batch).  The
forwards agree to ~1e-6, so a pre-activation closer than that to 0 can
take the other slope in the other package; one such element moves the
gradients of every block before it by up to ~3% of their largest
magnitude (measured: one flip at |x| = 7e-7 in 6e5 elements).  The
batches' seeds are ones where no element lies that close; a seed that
does fails here, by name, not in the gradient bound.

``generate_pseudo_captions``: one teacher call per batch with a new id,
none on a second pass over the cache."""

import numpy as np
import optax
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from audiocaption_tpu.losses import kd as jkd
from audiocaption_tpu.models.captioner import Captioner as JCaptioner
from audiocaption_tpu.models import zoo as jzoo
from audiocaption_tpu.optim.schedules import (
    exponential_decay_with_warmup as j_schedule)
from audiocaption_tpu.training.distill import (
    make_encoder_kd_step, make_token_kd_step)
from audiocaption_tpu.training.trainer import (
    create_train_state as j_create_state, make_optimizer as j_optimizer)

from audiocaption_tpu_torch.losses import kd
from audiocaption_tpu_torch.models.convert import (
    cdur5_trm_state_dict_from_jax, kd_head_state_dict_from_jax)
from audiocaption_tpu_torch.optim.schedules import (
    exponential_decay_with_warmup)
from audiocaption_tpu_torch.training.distill import (
    encoder_kd_step, generate_pseudo_captions, token_kd_step)
from audiocaption_tpu_torch.training.trainer import create_train_state

from test_torch_cdur5 import (
    SR, V, jax_variables, no_dropout, port_student)

LR, FINAL, TOTAL, WD, CLIP, B1 = 5e-4, 5e-7, 25, 1e-6, 1.0, 0.9
T_KD, W_KD, SHARED, TCHR_DIM = 2.0, 0.5, 32, 24
B, LC = 3, 7
TOKEN_SEEDS, ENC_SEEDS = (20, 23, 22), (41, 31)
MOMENT_FLOOR = 1e-2


def make_batch(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    wav_len = np.asarray([SR, 21000, 15000], np.int64)
    wav = (rng.randn(B, SR) * 0.1).astype(np.float32)
    cap_len = np.asarray([LC, LC - 2, LC - 3], np.int64)
    cap = np.zeros((B, LC), np.int64)
    for i, n in enumerate(cap_len):
        cap[i, 0], cap[i, n - 1] = 1, 2
        cap[i, 1:n - 1] = rng.randint(3, V, n - 2)
    return {"wav": wav, "wav_len": wav_len, "cap": cap, "cap_len": cap_len,
            "teacher_logit": (rng.randn(B, LC - 1, V) * 2).astype(np.float32),
            "tchr_emb": rng.randn(B, TCHR_DIM).astype(np.float32)}


def torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def jax_batch(b: dict) -> dict:
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in b.items()}


# ------------------------------------------------------------- losses --

@pytest.mark.parametrize("kd_type", ["kl", "l2", "l1"])
@pytest.mark.parametrize("temperature", [1.0, 2.0])
def test_token_kd_loss_matches_jax(kd_type, temperature):
    rng = np.random.RandomState(0)
    s = (rng.randn(4, 9, 50) * 3).astype(np.float32)
    t = (rng.randn(4, 9, 50) * 3).astype(np.float32)
    t[0, 0, 7] = 40.0                      # a teacher prob below 1e-10
    lens = np.asarray([9, 5, 1, 7])
    want = float(jkd.token_kd_loss(jnp.asarray(s), jnp.asarray(t),
                                   jnp.asarray(lens), kd_type, temperature))
    got = float(kd.token_kd_loss(torch.from_numpy(s), torch.from_numpy(t),
                                 torch.from_numpy(lens), kd_type,
                                 temperature))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert want > 0


def test_sup_kd_and_info_nce_match_jax():
    rng = np.random.RandomState(1)
    got = kd.sup_kd_loss(torch.tensor(2.5), torch.tensor(0.7), 0.3)
    want = jkd.sup_kd_loss(jnp.float32(2.5), jnp.float32(0.7), 0.3)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    s = rng.randn(6, 16).astype(np.float32)
    t = rng.randn(6, 16).astype(np.float32)
    want = float(jkd.info_nce_loss(jnp.asarray(s), jnp.asarray(t),
                                   jnp.float32(14.3)))
    got = float(kd.info_nce_loss(torch.from_numpy(s), torch.from_numpy(t),
                                 torch.tensor(14.3)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _head_case(jhead, port_head, args):
    """Init the JAX head, carry its params to the port head, compare."""
    jparams = jax.device_get(jhead.init(
        jax.random.PRNGKey(0), *map(jnp.asarray, args))["params"])
    port_head.load_state_dict(kd_head_state_dict_from_jax(jparams))
    want = float(jhead.apply({"params": jparams}, *map(jnp.asarray, args)))
    with torch.no_grad():
        got = float(port_head(*map(torch.from_numpy, args)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("head", ["contra", "mse", "mse_proj", "wml"])
def test_encoder_kd_heads_match_jax(head):
    rng = np.random.RandomState(2)
    s = rng.randn(5, 12).astype(np.float32)
    t = rng.randn(5, 20).astype(np.float32)
    if head == "contra":
        _head_case(jkd.ContraEncoderKdHead(shared_dim=8),
                   kd.ContraEncoderKdHead(12, 20, shared_dim=8), (s, t))
    elif head == "mse":
        _head_case(jkd.MseEncoderKdHead(tchr_dim=20),
                   kd.MseEncoderKdHead(12, tchr_dim=20), (s, t))
    elif head == "mse_proj":
        _head_case(jkd.MseEncoderKdHead(tchr_dim=20, use_tchr_proj=True,
                                        shared_dim=8),
                   kd.MseEncoderKdHead(12, tchr_dim=20, use_tchr_proj=True,
                                       shared_dim=8), (s, t))
    else:
        dists = np.abs(rng.randn(4)).astype(np.float32)
        jhead = jkd.WmlEncoderKdHead(n_layers=4)
        jp = {"layer_weights": rng.randn(4).astype(np.float32)}
        port = kd.WmlEncoderKdHead(4)
        port.load_state_dict(kd_head_state_dict_from_jax(jp))
        want = float(jhead.apply({"params": jp}, jnp.asarray(dists)))
        with torch.no_grad():
            got = float(port(torch.from_numpy(dists)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_contra_head_init_is_flax_dense():
    """The port head's own draw: zero biases, kernels of std
    1 / sqrt(fan_in) (flax's LeCun normal), logit scale log(1 / 0.07)."""
    h = kd.ContraEncoderKdHead(256, 512, 1024,
                               generator=torch.Generator().manual_seed(0))
    assert float(h.stdnt_proj.bias.detach().abs().max()) == 0.0
    for lin, fan_in in ((h.stdnt_proj, 256), (h.tchr_proj, 512)):
        np.testing.assert_allclose(float(lin.weight.detach().std()),
                                   fan_in ** -0.5, rtol=0.02)
    np.testing.assert_allclose(float(h.logit_scale), np.log(1 / 0.07))


# -------------------------------------------------------------- steps --

def _adam_state(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def _fill_masked(tree, params):
    return jax.tree_util.tree_map(
        lambda t, p: np.zeros(np.shape(p), np.float32)
        if isinstance(t, optax.MaskedNode) else np.asarray(t),
        tree, params, is_leaf=lambda x: isinstance(x, optax.MaskedNode))


def _port_space(tree, params, stats) -> dict:
    """A params-shaped JAX tree ({model, kd} for encoder KD) -> the port's
    parameter names, as numpy."""
    tree = _fill_masked(tree, params)
    model = tree["model"] if "model" in tree else tree
    out = {k: v.numpy() for k, v in cdur5_trm_state_dict_from_jax(
        {"params": model, "batch_stats": stats}).items()}
    if "kd" in tree:
        out.update({f"head.{k}": v.numpy() for k, v in
                    kd_head_state_dict_from_jax(tree["kd"]).items()})
    return out


def _close_per_tensor(got: dict, want: dict, what: str,
                      floor: float = None) -> None:
    """Each tensor within 1e-4 of its largest magnitude, or of ``floor``
    (default MOMENT_FLOOR times the largest of the model)."""
    if floor is None:
        floor = MOMENT_FLOOR * max(float(np.abs(w).max())
                                   for w in want.values())
    worst = 0.0
    for k, w in want.items():
        tol = 1e-4 * max(float(np.abs(w).max()), floor)
        d = float(np.abs(got[k] - w).max())
        worst = max(worst, d / tol if tol else float(d > 0))
        assert d <= tol, (what, k, d, tol)
    print(f"{what}: largest |diff| / bound {worst:.3g}")


def kink_flips(port, jmodel, b: dict) -> list:
    """Per Block2D, how many conv outputs have another sign in the port
    than in JAX: one train-mode forward of each on the port's current
    weights (a copy, so that no BN statistic moves)."""
    import copy
    with fnn.intercept_methods(no_dropout):
        _, st = jmodel.apply(
            jax_variables(port), jnp.asarray(b["wav"]),
            jnp.asarray(b["wav_len"].astype(np.int32)),
            method=JCaptioner.encode, train=True,
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=True)
    enc = jax.device_get(st["intermediates"])["encoder"]
    twin, out = copy.deepcopy(port).train(), {}
    for i in range(1, 6):
        getattr(twin.encoder, f"b{i}").conv.register_forward_hook(
            lambda m, a, o, i=i: out.__setitem__(i, o))
    with torch.no_grad():
        twin.encode(torch.from_numpy(b["wav"]), torch.from_numpy(b["wav_len"]))
    return [int((np.sign(out[i].permute(0, 2, 3, 1).numpy()) != np.sign(
        np.asarray(enc[f"b{i}"]["conv"]["__call__"][0]))).sum())
        for i in range(1, 6)]


def _step_record(state, named, jstate, j_mu_prev, j_params_prev, jm, m):
    j_params = jax.device_get(jstate.params)
    stats = jax.device_get(jstate.batch_stats)
    adam = _adam_state(jax.device_get(jstate.opt_state))
    mu = _port_space(adam.mu, j_params, stats)
    nu = _port_space(adam.nu, j_params, stats)
    p_prev = _port_space(j_params_prev, j_params_prev, stats)
    ost = state.optimizer.state
    return dict(
        j_loss=float(jm["loss"]), loss=float(m["loss"]),
        coef=min(1.0, CLIP / (float(m["grad_norm"]) + 1e-6)),
        j_grads={n: (mu[n] - (B1 * j_mu_prev[n] if j_mu_prev else 0))
                 / (1 - B1) - WD * p_prev[n] for n in named},
        grads={n: p.grad.numpy().copy() for n, p in named.items()},
        j_mu={n: mu[n] for n in named}, j_nu={n: nu[n] for n in named},
        mu={n: ost[p]["exp_avg"].numpy().copy() for n, p in named.items()},
        nu={n: ost[p]["exp_avg_sq"].numpy().copy()
            for n, p in named.items()}), mu


def _schedule():
    return (j_schedule(LR, FINAL, TOTAL, TOTAL // 5),
            exponential_decay_with_warmup(LR, FINAL, TOTAL, TOTAL // 5))


@pytest.fixture(scope="module")
def token_runs():
    port = port_student(seed=5)
    jmodel = jzoo.kd_student_cdur5(vocab_size=V, decoder_dropout=0.0)
    j_sched, sched = _schedule()
    tx = j_optimizer(LR, j_sched, WD, CLIP)
    jstate = j_create_state(jax_variables(port), tx, jax.random.PRNGKey(0))
    jstep = make_token_kd_step(jmodel, tx, kd_weight=W_KD, kd_type="kl",
                               temperature=T_KD, smoothing=0.1)
    state = create_train_state(port, LR, sched, WD, CLIP)
    named = dict(port.named_parameters())
    steps, j_mu_prev = [], None
    for k in range(3):
        jstate = jstate.replace(params=jax.tree_util.tree_map(
            jnp.asarray, jax_variables(port)["params"]))
        j_params_prev = jax.device_get(jstate.params)
        b = make_batch(seed=TOKEN_SEEDS[k])
        flips = kink_flips(port, jmodel, b)
        with fnn.intercept_methods(no_dropout):
            jstate, jm = jstep(jstate, jax_batch(b), jnp.float32(1.0))
        m = token_kd_step(state, torch_batch(b), kd_weight=W_KD,
                          kd_type="kl", temperature=T_KD, smoothing=0.1)
        rec, j_mu_prev = _step_record(state, named, jstate, j_mu_prev,
                                      j_params_prev, jax.device_get(jm), m)
        steps.append(dict(rec, flips=flips))
    return steps


def _check_step(s: dict, what: str, unreached=()) -> None:
    assert not any(s["flips"]), (
        f"{what}: the packages take another LeakyReLU branch at "
        f"{s['flips']} conv outputs of b1..b5 (pre-activations within "
        "float32 noise of 0); pick another batch seed")
    np.testing.assert_allclose(s["loss"], s["j_loss"], rtol=1e-5)
    for n in unreached:
        assert not np.any(s["grads"][n]), n
        assert np.abs(s["j_grads"][n]).max() < 1e-9, n
    keep = [n for n in s["j_grads"] if n not in unreached]
    _close_per_tensor({n: s["grads"][n] for n in keep},
                      {n: s["j_grads"][n] for n in keep}, f"{what} gradients",
                      floor=s["coef"])
    mu_floor = max(MOMENT_FLOOR * max(float(np.abs(w).max())
                                      for w in s["j_mu"].values()),
                   (1 - B1) * s["coef"])
    _close_per_tensor(s["mu"], s["j_mu"], f"{what} Adam mu", mu_floor)
    _close_per_tensor(s["nu"], s["j_nu"], f"{what} Adam nu")


@pytest.mark.parametrize("k", range(3))
def test_token_kd_step_matches_jax(token_runs, k):
    _check_step(token_runs[k], f"token step {k}")


ENC_THREADS = 2


@pytest.fixture(scope="module")
def enc_runs():
    """The two encoder-KD steps at ENC_THREADS torch CPU threads (set here
    and restored after): the float32 sums of the step, and so how near
    its floors it lands, follow the thread count, which other test modules
    set at import."""
    threads = torch.get_num_threads()
    torch.set_num_threads(ENC_THREADS)
    try:
        return _enc_runs()
    finally:
        torch.set_num_threads(threads)


def _enc_runs():
    port = port_student(seed=6)
    jmodel = jzoo.kd_student_cdur5(vocab_size=V, decoder_dropout=0.0)
    head = kd.ContraEncoderKdHead(256, TCHR_DIM, SHARED,
                                  generator=torch.Generator().manual_seed(7))
    jhead = jkd.ContraEncoderKdHead(shared_dim=SHARED)
    j_sched, sched = _schedule()
    tx = j_optimizer(LR, j_sched, WD, CLIP)

    def jax_params():
        hp = {n: {"kernel": getattr(head, n).weight.detach().numpy().T.copy(),
                  "bias": getattr(head, n).bias.detach().numpy().copy()}
              for n in ("stdnt_proj", "tchr_proj")}
        hp["logit_scale"] = head.logit_scale.detach().numpy().copy()
        return {"model": jax_variables(port)["params"], "kd": hp}
    jv = jax_variables(port)
    jstate = j_create_state({"params": jax_params(),
                             "batch_stats": jv["batch_stats"]}, tx,
                            jax.random.PRNGKey(0))
    state = create_train_state(port, LR, sched, WD, CLIP, head=head)
    named = dict(port.named_parameters())
    named.update({f"head.{n}": p for n, p in head.named_parameters()})
    steps, j_mu_prev = [], None
    for k, unsup in enumerate((False, True)):
        jstate = jstate.replace(params=jax.tree_util.tree_map(
            jnp.asarray, jax_params()))
        j_params_prev = jax.device_get(jstate.params)
        b = make_batch(seed=ENC_SEEDS[k])
        flips = kink_flips(port, jmodel, b)
        jstep = make_encoder_kd_step(jmodel, jhead, tx, kd_weight=1.0,
                                     smoothing=0.1, unsup=unsup)
        jb = jax_batch(b)
        if unsup:
            jb = {n: jb[n] for n in ("wav", "wav_len", "tchr_emb")}
        with fnn.intercept_methods(no_dropout):
            jstate, jm = jstep(jstate, jb, jnp.float32(1.0))
        tb = torch_batch(b)
        if unsup:
            tb = {n: tb[n] for n in ("wav", "wav_len", "tchr_emb")}
        m = encoder_kd_step(state, head, tb, kd_weight=1.0, smoothing=0.1,
                            unsup=unsup)
        rec, j_mu_prev = _step_record(state, named, jstate, j_mu_prev,
                                      j_params_prev, jax.device_get(jm), m)
        steps.append(dict(rec, flips=flips))
    return steps


@pytest.mark.parametrize("k", [0, 1], ids=["sup", "unsup"])
def test_encoder_kd_step_matches_jax(enc_runs, k):
    s = enc_runs[k]
    dec = [n for n in s["grads"] if n.startswith("decoder.")]
    assert all(np.abs(s["grads"][n]).max() > 0 for n in dec) == (k == 0)
    _check_step(s, f"enc step {k}", unreached=dec if k else ())


def test_generate_pseudo_captions_caches():
    calls = []

    def teacher(wav, wav_len):
        calls.append(len(wav))
        return [f"cap{len(calls)}_{i}" for i in range(len(wav))]
    loader = [{"audio_id": ["a", "b"], "wav": np.zeros((2, 10)),
               "wav_len": np.asarray([10, 10])},
              {"audio_id": ["a", "c"], "wav": np.zeros((2, 10)),
               "wav_len": np.asarray([10, 10])}]
    cache = generate_pseudo_captions(teacher, loader)
    assert cache == {"a": "cap1_0", "b": "cap1_1", "c": "cap2_1"}
    again = generate_pseudo_captions(teacher, loader, cache)
    assert len(calls) == 2 and again == cache and again is not cache
