"""The port's caption losses and learning-rate schedules against the JAX
package's.

  * losses on seeded logits with padded positions (numpy seed): label
    smoothing (the reference's scatter quirk), cross entropy, each
    reduction; relative 1e-6;
  * the three schedules at update counts 0, warmup - 1, warmup and
    total - 1, and ``LambdaLR`` driven by them (``lambda_lr``): the
    learning rate of update k is ``schedule(k)``; relative 1e-6.  The
    JAX schedules get Python ints: with an int32 array count the
    exponential decay's float32 power is itself 2e-5 off at total - 1
    (the port evaluates in float64, as torch's ``LambdaLR`` does).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiocaption_tpu.losses import loss as JL
from audiocaption_tpu.optim import schedules as JS

from audiocaption_tpu_torch.losses import loss as TL
from audiocaption_tpu_torch.optim import schedules as TS

B, L, V = 4, 9, 37


def _inputs():
    rng = np.random.RandomState(0)
    logit = (rng.randn(B, L, V) * 3).astype(np.float32)
    tgt = rng.randint(0, V, (B, L)).astype(np.int64)
    tgt_len = np.asarray([9, 5, 1, 7], np.int64)   # padded positions
    return logit, tgt, tgt_len


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("kind,smoothing", [("label_smoothing", 0.1),
                                            ("label_smoothing", 0.0),
                                            ("cross_entropy", 0.0)])
def test_losses_match_jax(kind, smoothing, reduction):
    logit, tgt, tgt_len = _inputs()
    out_j = {"logit": jnp.asarray(logit), "tgt": jnp.asarray(tgt),
             "tgt_len": jnp.asarray(tgt_len)}
    out_t = {"logit": torch.from_numpy(logit), "tgt": torch.from_numpy(tgt),
             "tgt_len": torch.from_numpy(tgt_len)}
    want = np.asarray(JL.masked_token_loss(kind, smoothing, reduction)(out_j))
    got = TL.masked_token_loss(kind, smoothing, reduction)(out_t).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if reduction == "none":      # padded positions carry nothing
        assert (got[3, 7:] == 0).all() and (got[2, 1:] == 0).all()


def test_label_smoothing_scatter_quirk():
    """The target's share is the confidence alone: the loss is the
    cross entropy against fill(s / (V - 1)) with the target overwritten
    by 1 - s, written out densely."""
    logit, tgt, tgt_len = _inputs()
    lp = torch.log_softmax(torch.from_numpy(logit), -1)
    dist = torch.full_like(lp, 0.1 / (V - 1))
    dist.scatter_(-1, torch.from_numpy(tgt)[..., None], 0.9)
    per = -(dist * lp).sum(-1)
    mask = torch.arange(L)[None] < torch.from_numpy(tgt_len)[:, None]
    want = (per * mask).sum() / mask.sum()
    got = TL.label_smoothing_loss(torch.from_numpy(logit),
                                  torch.from_numpy(tgt),
                                  torch.from_numpy(tgt_len), 0.1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)


def test_build_loss_reads_reference_names():
    logit, tgt, tgt_len = _inputs()
    out = {"logit": torch.from_numpy(logit), "tgt": torch.from_numpy(tgt),
           "tgt_len": torch.from_numpy(tgt_len)}
    ls = TL.build_loss({"type": "captioning.losses.loss.LabelSmoothingLoss",
                        "args": {"smoothing": 0.1}})(out)
    ce = TL.build_loss({"type": "CrossEntropyLoss"})(out)
    assert float(ls) == float(TL.label_smoothing_loss(
        out["logit"], out["tgt"], out["tgt_len"], 0.1))
    assert float(ce) == float(TL.cross_entropy_loss(
        out["logit"], out["tgt"], out["tgt_len"]))
    # every loss type of the JAX package is ported: an unknown one
    # raises, and a condition loss without its discriminator node raises
    # as the JAX builder does
    with pytest.raises(ValueError, match="unknown loss type"):
        TL.build_loss({"type": "FocalLoss"})
    with pytest.raises(KeyError, match="dscrm"):
        TL.build_loss({"type": "ConditionLossWrapper"})


TOTAL, WARMUP = 1000, 200
NODES = [
    {"type": "captioning.utils.lr_scheduler.ExponentialDecayScheduler",
     "args": {"final_lrs": 5e-7}},
    {"type": "NoamScheduler", "args": {"model_size": 256, "factor": 2.0}},
    {"type": "CosineWithWarmup", "args": {"num_cycles": 0.5}},
]


@pytest.mark.parametrize("node", NODES, ids=lambda n: n["type"][-12:])
def test_schedules_match_jax(node):
    want = JS.build_schedule(node, 5e-4, TOTAL, WARMUP)
    got = TS.build_schedule(node, 5e-4, TOTAL, WARMUP)
    for count in (0, WARMUP - 1, WARMUP, TOTAL - 1):
        np.testing.assert_allclose(
            got(count), float(want(count)), rtol=1e-6,
            err_msg=f"count {count}")


def test_exponential_schedule_ends_at_final_lr():
    s = TS.exponential_decay_with_warmup(5e-4, 5e-7, TOTAL, WARMUP)
    assert s(0) == pytest.approx(5e-4 / WARMUP)
    assert s(WARMUP - 1) == pytest.approx(5e-4)
    assert s(TOTAL - 1) == pytest.approx(5e-7)


def test_lambda_lr_sets_the_lr_of_each_update():
    """Update k (k updates applied before it) runs at schedule(k)."""
    sched = TS.exponential_decay_with_warmup(5e-4, 5e-7, 50, 10)
    p = torch.nn.Parameter(torch.zeros(3))
    opt = torch.optim.Adam([p], lr=5e-4)
    lr = TS.lambda_lr(opt, sched, 5e-4)
    for k in range(50):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], sched(k),
                                   rtol=1e-12)
        p.grad = torch.ones(3)
        opt.step()
        lr.step()
        assert lr.last_epoch == k + 1
