"""Data and tensor parallelism of the port (``parallel/mesh.py``,
``parallel/tp.py``, ``training/trainer.py::train_step(parallel=...)``) on
CPU gloo process groups, against the single-process step on the global
batch and against the JAX package's ``make_train_step``.

The model: a ``Cnn6Encoder`` (batch norm) and a 1-layer
``TransformerDecoder`` (emb 32, 2 heads, FFN 64), built from one config in
both packages (``test_torch_family.jax_pair``: flax init, BN statistics
from a train-mode pass, decoder jittered), dropout the identity.  The
workers are this file run as a script (``python test_torch_parallel.py
worker ...``), one process a rank, as ``tests/test_multihost.py`` runs
JAX's.  Cases:

  * dp2, a batch of 5 that two ranks do not divide (padded to 6 by
    repeating its first row, as JAX's runner pads): loss within rtol 1e-5
    and raw gradient norm within rtol 1e-4 of the single-process step on
    the padded batch (``tests/test_multihost.py:126-129``), and every
    parameter after the Adam step within 2e-5, each BN running statistic
    within 1e-5 of its tensor's largest;
  * dp2 x tp2 (4 ranks) at V=24, where the vocabulary, the heads and the
    FFN split over the model-parallel pair: loss and raw gradient norm
    within rtol 1e-4 of the single-process step and of JAX's step on the
    same weights, parameters after Adam within 2e-5 of both
    (``tests/test_training.py:205-258``);
  * dp2 x tp2 at V=23, which two ranks do not divide: the embedding and
    the classifier stay replicated (JAX's fallback), the rest is sharded;
    the same bounds against the single-process step;
  * dp2 with every per-row draw of a step: scheduled sampling at 0.5,
    SpecAugment, and a condition loss (gumbel noise) over a specificity
    loss over label smoothing, whose means are over samples as well as
    tokens: the dp2 bounds against the single-process step on the padded
    batch, which holds only if each rank takes its rows of the global
    batch's draws and divides by the global batch's counts.

In this process, without subprocesses: the losses' global means and
draws on emulated ranks (each mean's count summed over the ranks, as the
step's all-reduce sums it) against the loss of the whole batch, loss and
gradient with respect to the logits within 1e-6; and SpecAugment's
stripes for a rank's rows, equal to the columns of the global draw.

Of the parameters, 0.1% of the elements may miss the bound, as in
``test_torch_train_step.py``: the first Adam step moves an element by the
learning rate times the sign of its gradient, and the single-process
step's float32 batch norm (torch's CPU kernel) lies ~1e-5 from float64 in
the encoder's gradients, where the ranks' cross-rank batch norm lies
~1e-7 from it, so an element whose gradient is near zero may move the
other way.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

HERE = Path(__file__).resolve()
SR = 32000
LR, FINAL, TOTAL, WARM, WD, CLIP = 5e-4, 5e-7, 100, 2, 1e-6, 1.0
PARAM_ATOL = 2e-5
STATS_RTOL = 1e-5
MISS_SHARE = 1e-3
WORKER_TIMEOUT = 300


def node(vocab: int) -> dict:
    return {"type": "captioning.models.transformer_model.TransformerModel",
            "encoder": {"type": "captioning.models.cnn_encoder.Cnn6Encoder",
                        "args": {"sample_rate": SR}},
            "decoder": {"type": "captioning.models.transformer_decoder."
                                "TransformerDecoder",
                        "args": {"emb_dim": 32, "nlayers": 1, "nhead": 2,
                                 "dim_feedforward": 64, "dropout": 0.0,
                                 "vocab_size": vocab}}}


def identity_dropout(t, p=0.5, training=True, inplace=False):
    return t


def batch_of(B: int, vocab: int) -> dict:
    """B clips of at most 0.5 s, each its own tone over noise, and <bos>
    words <eos> captions of 4-7 tokens."""
    rng = np.random.RandomState(11)
    T = SR // 2
    t = np.arange(T) / SR
    wav = np.stack([0.3 * np.sin(2 * np.pi * 300 * (i + 1) * t)
                    + rng.randn(T) * 0.05 for i in range(B)])
    wav_len = np.asarray([T, T - 3000, T - 5000, T - 1000, T - 7000][:B],
                         np.int64)
    for i, n in enumerate(wav_len):
        wav[i, n:] = 0.0
    Lc = 7
    cap_len = np.asarray([7, 5, 4, 6, 7][:B], np.int64)
    cap = np.zeros((B, Lc), np.int64)
    for i, n in enumerate(cap_len):
        cap[i, 0], cap[i, n - 1] = 1, 2
        cap[i, 1:n - 1] = rng.randint(3, vocab, n - 2)
    return {"wav": wav.astype(np.float32), "wav_len": wav_len, "cap": cap,
            "cap_len": cap_len}


def make_state(model):
    from audiocaption_tpu_torch.optim.schedules import (
        exponential_decay_with_warmup)
    from audiocaption_tpu_torch.training.trainer import create_train_state
    return create_train_state(
        model, LR, exponential_decay_with_warmup(LR, FINAL, TOTAL, WARM),
        WD, CLIP)


def drawing_loss(vocab: int):
    """A condition loss with gumbel noise (its discriminator a fixed
    projection of the soft words, its label the parity of the first
    target word) over a specificity loss over label smoothing: means
    over samples and over tokens, and a per-row draw."""
    from audiocaption_tpu_torch.losses.loss import masked_token_loss
    from audiocaption_tpu_torch.losses.wrappers import (
        condition_loss_wrapper, specificity_loss_wrapper)
    from audiocaption_tpu_torch.ops.masking import length_mask
    rng = np.random.RandomState(5)
    proj = torch.from_numpy(rng.randn(vocab).astype(np.float32))
    spec = rng.rand(vocab).astype(np.float32)

    def dscrm(soft, lens):
        mask = length_mask(lens, soft.shape[1]).float()
        return torch.sigmoid((soft @ proj * mask).sum(1)
                             / lens.clamp(min=1).float())

    inner = specificity_loss_wrapper(
        masked_token_loss("label_smoothing", 0.1), spec, "sum", alpha=0.1)
    fn = condition_loss_wrapper(inner, dscrm, alpha=0.5,
                                sample_method="gumbel",
                                generator=torch.Generator().manual_seed(7))
    return lambda out: fn(dict(out, conditions=(out["tgt"][:, 0] % 2)))


def port_step(model, batch, parallel=None, draws: bool = False) -> dict:
    """One XE step (dropout the identity) -> loss, raw gradient norm:
    teacher forcing and label smoothing, or with ``draws`` scheduled
    sampling at 0.5, SpecAugment and :func:`drawing_loss`, each from its
    seeded generator."""
    from audiocaption_tpu_torch.losses.loss import masked_token_loss
    from audiocaption_tpu_torch.training.trainer import train_step
    state = make_state(model)
    vocab = model.decoder.classifier.out_features
    kw = dict(ss_ratio=torch.tensor(0.5),
              generator=torch.Generator().manual_seed(3), specaug=True,
              specaug_generator=torch.Generator().manual_seed(4)
              ) if draws else {}
    loss = (drawing_loss(vocab) if draws
            else masked_token_loss("label_smoothing", 0.1))
    dropout = F.dropout
    F.dropout = identity_dropout
    try:
        m = train_step(state, loss,
                       {k: torch.from_numpy(v) for k, v in batch.items()},
                       parallel=parallel, **kw)
    finally:
        F.dropout = dropout
    assert not m["skipped"]
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}


# ------------------------------------------------------------- worker --

def worker(rank: int, world: int, port: int, tp: int, case_dir: str) -> None:
    """One rank: the model from the saved weights, its slice of the saved
    global batch, one step; rank 0 writes the loss, the norm and the full
    state dict after the step."""
    import torch.distributed as dist
    from audiocaption_tpu_torch.parallel import (
        ParallelContext, TensorParallelContext, full_state_dict,
        init_distributed, make_tp_groups, shard_batch, shard_params,
        sync_batch_norm)
    from audiocaption_tpu_torch.utils.config import build_model_from_config
    torch.set_num_threads(1)
    d = Path(case_dir)
    meta = json.loads((d / "meta.json").read_text())
    batch = dict(np.load(d / "batch.npz"))
    init_distributed(f"tcp://localhost:{port}", world, rank)
    model, _ = build_model_from_config(node(meta["vocab"]),
                                       vocab_size=meta["vocab"])
    model.load_state_dict(torch.load(d / "weights.pt"))
    if tp > 1:
        dp_group, tp_group = make_tp_groups(world, tp)
        dp_rank = rank // tp
        sharded = shard_params(model, tp_group)
        ctx = TensorParallelContext(dp_group=dp_group, tp_group=tp_group,
                                    sharded=frozenset(sharded))
    else:
        dp_group, tp_group, dp_rank, sharded = None, None, rank, set()
        ctx = ParallelContext()
    sync_batch_norm(model, dp_group)
    local = shard_batch(batch, dp_rank, world // tp)
    out = port_step(model.train(), local, ctx, meta.get("draws", False))
    out["sharded"] = len(sharded)
    state = {k: v.numpy() for k, v in full_state_dict(
        model, tp_group).items()} if tp > 1 else {
        k: v.detach().numpy() for k, v in model.state_dict().items()}
    if rank == 0:
        np.savez(d / "after.npz", **state)
        (d / "result.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------------- parent --

def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_workers(case_dir: Path, world: int, tp: int) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(HERE.parent.parent) + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(HERE), "worker", str(rank), str(world),
         str(port), str(tp), str(case_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
    res = json.loads((case_dir / "result.json").read_text())
    res["state"] = dict(np.load(case_dir / "after.npz"))
    return res


def make_case(tmp: Path, vocab: int, B: int, world: int,
              draws: bool = False):
    """The JAX / port pair at ``vocab``, the global batch padded for
    ``world`` ranks, the files the workers read, and the single-process
    port step on that batch (with ``draws``: :func:`port_step`'s)."""
    from test_torch_family import jax_pair
    from audiocaption_tpu_torch.parallel import pad_to_world
    b = batch_of(B, vocab)
    jmodel, jvars, port = jax_pair(node(vocab), b, seed=4, vocab=vocab)
    padded = pad_to_world(b, world)
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(port.state_dict(), tmp / "weights.pt")
    np.savez(tmp / "batch.npz", **padded)
    (tmp / "meta.json").write_text(json.dumps({"vocab": vocab,
                                                "draws": draws}))
    single = port_step(port.train(), padded, draws=draws)
    single["state"] = {k: v.detach().numpy().copy()
                       for k, v in port.state_dict().items()}
    return jmodel, jvars, padded, single


def jax_step(jmodel, jvars, batch) -> dict:
    """JAX's ``make_train_step`` on the same weights and batch (dropout the
    identity) -> loss, raw gradient norm, parameters and BN statistics in
    the port's key space."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    from audiocaption_tpu.losses.loss import masked_token_loss as j_loss
    from audiocaption_tpu.optim.schedules import (
        exponential_decay_with_warmup as j_schedule)
    from audiocaption_tpu.training.trainer import (
        create_train_state as j_create_state, make_optimizer as j_optimizer,
        make_train_step)
    from test_torch_family import jax_batch, no_dropout, port_grads_space
    tx = j_optimizer(LR, j_schedule(LR, FINAL, TOTAL, WARM), WD, CLIP)
    jstate = j_create_state(jvars, tx, jax.random.PRNGKey(0))
    step = make_train_step(jmodel, j_loss("label_smoothing", 0.1), tx,
                           donate=False)
    with fnn.intercept_methods(no_dropout):
        jstate, m = step(jstate, jax_batch(batch), jnp.float32(1.0))
    m = jax.device_get(m)
    params = jax.device_get(jstate.params)
    stats = jax.device_get(jstate.batch_stats)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "state": port_grads_space(params, params, stats)}


def assert_states_close(got: dict, want: dict, keys=None) -> None:
    """Every parameter within PARAM_ATOL and every BN running statistic
    within STATS_RTOL of its tensor's largest (the input BN's variance of
    dB values runs to the hundreds), a share of MISS_SHARE of the
    elements excepted (see the module docstring)."""
    from test_torch_train_step import _report_close
    keys = keys if keys is not None else [
        k for k in want if not k.endswith("num_batches_tracked")]
    stats = [k for k in keys if k.endswith(("running_mean", "running_var"))]
    params = [k for k in keys if k not in stats]
    _report_close({k: got[k] for k in params}, {k: want[k] for k in params},
                  PARAM_ATOL, "parameters after Adam", MISS_SHARE)
    _report_close({k: got[k] for k in stats}, {k: want[k] for k in stats},
                  lambda w: STATS_RTOL * max(1.0, float(np.abs(w).max())),
                  "BN running statistics")


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp2")
    _, _, _, single = make_case(d, vocab=24, B=5, world=2)
    return single, run_workers(d, world=2, tp=1)


def test_dp2_matches_the_single_process_step_on_the_padded_batch(dp2):
    single, got = dp2
    np.testing.assert_allclose(got["loss"], single["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], single["grad_norm"],
                               rtol=1e-4)
    assert_states_close(got["state"], single["state"])


@pytest.fixture(scope="module")
def dp2_tp2(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp2tp2")
    jmodel, jvars, padded, single = make_case(d, vocab=24, B=4, world=2)
    return single, jax_step(jmodel, jvars, padded), run_workers(d, 4, 2)


def test_dp2_tp2_matches_the_single_process_step(dp2_tp2):
    single, _, got = dp2_tp2
    # each decoder layer's attentions and FFN, the embedding, the
    # classifier: in_proj weight and bias of two attentions, linear1
    # weight and bias, the three row-parallel weights, embedding, classifier
    assert got["sharded"] == 2 * 2 + 2 + 3 + 2
    np.testing.assert_allclose(got["loss"], single["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], single["grad_norm"],
                               rtol=1e-4)
    assert_states_close(got["state"], single["state"])


def test_dp2_tp2_matches_jax_make_train_step(dp2_tp2):
    single, jx, got = dp2_tp2
    np.testing.assert_allclose(got["loss"], jx["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], jx["grad_norm"], rtol=1e-4)
    keys = [k for k in jx["state"] if k in got["state"]
            and not k.endswith("num_batches_tracked")]
    assert len(keys) == len([k for k in single["state"]
                             if not k.endswith("num_batches_tracked")])
    assert_states_close(got["state"], jx["state"], keys)


def test_dp2_tp2_replicates_a_vocabulary_the_pair_does_not_divide(
        tmp_path):
    _, _, _, single = make_case(tmp_path, vocab=23, B=4, world=2)
    got = run_workers(tmp_path, 4, 2)
    assert got["sharded"] == 2 * 2 + 2 + 3
    np.testing.assert_allclose(got["loss"], single["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], single["grad_norm"],
                               rtol=1e-4)
    assert_states_close(got["state"], single["state"])


def test_dp2_draws_each_row_as_the_single_process_step_does(tmp_path):
    _, _, _, single = make_case(tmp_path, vocab=24, B=5, world=2,
                                draws=True)
    got = run_workers(tmp_path, world=2, tp=1)
    np.testing.assert_allclose(got["loss"], single["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], single["grad_norm"],
                               rtol=1e-4)
    assert_states_close(got["state"], single["state"])


# ------------------------------------------- emulated ranks, one process --

def on_emulated_ranks(make_fn, outs):
    """The sum of ``make_fn()``'s losses over the ranks' outputs ``outs``
    (each with its ``rows``), each mean's count summed over the ranks as
    the step's all-reduce sums it: a first pass records every rank's
    counts in call order, a second divides by their sums."""
    counts = [[] for _ in outs]
    for r, out in enumerate(outs):
        make_fn()(dict(out, count_sum=lambda c, r=r: counts[r].append(c)
                       or c))
    total = 0.0
    for out in outs:
        calls = iter(range(len(counts[0])))

        def count_sum(c, calls=calls):
            i = next(calls)
            return sum(rank[i] for rank in counts)
        total = total + make_fn()(dict(out, count_sum=count_sum))
    return total


def loss_makers(V: int):
    """Each loss kind's maker (a fresh generator each time): label
    smoothing, cross entropy, the augment wrapper, the specificity and
    condition wrappers."""
    from audiocaption_tpu_torch.losses.loss import masked_token_loss
    from audiocaption_tpu_torch.losses.wrappers import (
        augment_loss_wrapper, condition_loss_wrapper,
        specificity_loss_wrapper)
    spec = np.random.RandomState(2).rand(V).astype(np.float32)
    proj = torch.from_numpy(np.random.RandomState(3).randn(V).astype(
        np.float32))

    def dscrm(soft, lens):
        return torch.sigmoid((soft @ proj).mean(1))

    return {
        "label_smoothing": lambda: masked_token_loss("label_smoothing", 0.1),
        "cross_entropy": lambda: masked_token_loss("cross_entropy"),
        "augment": lambda: augment_loss_wrapper(
            masked_token_loss("label_smoothing", 0.1, "none")),
        "specificity_mean": lambda: specificity_loss_wrapper(
            masked_token_loss("cross_entropy"), spec, "mean"),
        "condition_gumbel": lambda: condition_loss_wrapper(
            masked_token_loss("label_smoothing", 0.1), dscrm, alpha=0.7,
            sample_method="gumbel",
            generator=torch.Generator().manual_seed(9)),
    }


@pytest.mark.parametrize("kind", ["label_smoothing", "cross_entropy",
                                  "augment", "specificity_mean",
                                  "condition_gumbel"])
def test_losses_on_emulated_ranks_sum_to_the_global_batch_loss(kind):
    N, T, V, world = 6, 5, 11, 2
    rng = np.random.RandomState(8)
    logit = torch.from_numpy(rng.randn(N, T, V).astype(np.float32) * 2)
    full = {"tgt": torch.from_numpy(rng.randint(0, V, (N, T))),
            # the first rank's rows hold far more tokens than the second's
            "tgt_len": torch.tensor([5, 5, 4, 2, 2, 2]),
            "conditions": torch.tensor([1., 0., 1., 1., 0., 0.]),
            "aug_keep": torch.tensor([1., 1., 0., 1., 0., 1.])}
    make_fn = loss_makers(V)[kind]
    want_logit = logit.clone().requires_grad_(True)
    want = make_fn()(dict(full, logit=want_logit))
    want.backward()
    got_logit = logit.clone().requires_grad_(True)
    n = N // world
    outs = [dict({k: v[r * n:(r + 1) * n] for k, v in full.items()},
                 logit=got_logit[r * n:(r + 1) * n], rows=(r * n, N))
            for r in range(world)]
    got = on_emulated_ranks(make_fn, outs)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want.detach()),
                               atol=1e-6)
    np.testing.assert_allclose(got_logit.grad.numpy(),
                               want_logit.grad.numpy(), atol=1e-6)


def test_specaug_rows_are_the_global_draws_columns():
    from audiocaption_tpu_torch.ops.specaug import draw_stripes, spec_augment
    N, world = 6, 3
    whole = draw_stripes(N, 50, 16, 2, torch.Generator().manual_seed(1))
    n = N // world
    parts = [draw_stripes(n, 50, 16, 2, torch.Generator().manual_seed(1),
                          rows=(r * n, N)) for r in range(world)]
    for i in range(2):
        np.testing.assert_array_equal(
            torch.cat([p[i] for p in parts], 1).numpy(), whole[i].numpy())
    # the ranks' stripes differ from one another
    assert not all(torch.equal(parts[0][0], p[0]) for p in parts[1:])
    lms = torch.from_numpy(np.random.RandomState(2).rand(N, 50, 16).astype(
        np.float32))
    want = spec_augment(lms, torch.Generator().manual_seed(5))
    got = torch.cat([spec_augment(lms[r * n:(r + 1) * n],
                                  torch.Generator().manual_seed(5),
                                  rows=(r * n, N)) for r in range(world)])
    np.testing.assert_array_equal(got.numpy(), want.numpy())


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    sys.path.insert(0, str(HERE.parent.parent))
    worker(*map(int, sys.argv[2:6]), sys.argv[6])
