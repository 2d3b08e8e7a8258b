"""Checkpoints, weight averaging and the checkpoint helpers of the port
against the JAX package's.

  * a checkpoint the JAX package's ``save_checkpoint`` wrote (the narrow
    flagship of ``test_torch_train_forward``, its BN statistics set from
    the clips so that each clip gets its own caption) loads into the port
    (``training.checkpoint.load_checkpoint`` converts its flax tree to
    the reference key space) and the port's API greedy-decodes the same
    tokens as the JAX ``generate``;
  * the port's own checkpoint round-trips: every array and field back as
    written, and the reloaded API decodes the same tokens;
  * ``swa_update`` against the JAX ``swa_update`` over three snapshots,
    1e-7;
  * ``AsyncCheckpointer`` keeps submission order and re-raises a job's
    error (as ``tests/test_training.py`` holds the JAX one);
  * ``MetricImprover`` answers as the JAX one does, in both modes;
    ``merge_variables`` copies only entries of matching shape.
"""

import time

import numpy as np
import pytest
import torch

import jax

from audiocaption_tpu.models.captioner import generate as j_generate
from audiocaption_tpu.training import checkpoint as JC
from audiocaption_tpu.training import swa as JSWA

from audiocaption_tpu_torch.hf_api import (
    Effb2TrmCaptioningModel, Effb2TrmConfig)
from audiocaption_tpu_torch.models.convert import state_dict_from_jax
from audiocaption_tpu_torch.training import checkpoint as TC
from audiocaption_tpu_torch.training import swa as TSWA

from test_torch_train_forward import (
    EMB, SR, V, calibrate_bn, jax_model, jax_variables, port_model)

torch.set_num_threads(2)

AUDIO = (np.random.RandomState(5).randn(3, SR) * 0.3).astype(np.float32)
LENS = np.asarray([SR, 12000, 9000])
L = 8


def _api(variables) -> Effb2TrmCaptioningModel:
    api = Effb2TrmCaptioningModel(
        Effb2TrmConfig(vocab_size=V, decoder_emb_dim=EMB), device="cpu")
    api.load_torch_state_dict(variables)
    return api


@pytest.fixture(scope="module")
def pair():
    port = port_model(seed=4)
    calibrate_bn(port, AUDIO, LENS)
    jvars = jax.device_get(jax_variables(port))
    jmodel = jax_model()
    seq = jax.jit(lambda v, w, n: j_generate(
        jmodel, v, w, n, sample_method="greedy", max_length=L)["seq"])(
            jvars, AUDIO, LENS)
    return port, jvars, np.asarray(seq)


def test_jax_checkpoint_loads_and_decodes_as_jax(pair, tmp_path):
    port, jvars, j_seq = pair
    path = tmp_path / "jax_last.pth"
    JC.save_checkpoint(str(path), jvars, epoch=3, lr_count=17,
                       monitor_state={"mode": "max", "best": 0.5},
                       tokenizer_state={"<pad>": 0})
    ckpt = TC.load_checkpoint(str(path))
    assert ckpt["epoch"] == 3 and ckpt["lr_count"] == 17
    assert ckpt["tokenizer"] == {"<pad>": 0}
    want = state_dict_from_jax(jvars)
    assert set(ckpt["variables"]) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(ckpt["variables"][k], v.numpy(), k)
    got = _api(ckpt["variables"])(AUDIO, LENS, sample_method="greedy",
                                  max_length=L)
    assert len({tuple(r) for r in j_seq}) == 3   # a caption of each clip
    np.testing.assert_array_equal(got, j_seq)


def test_port_checkpoint_round_trips(pair, tmp_path):
    port, _, j_seq = pair
    variables = TC.model_variables(port)
    opt = torch.optim.Adam(port.parameters(), lr=1e-3)
    port.train()
    port(torch.from_numpy(AUDIO[:2]), torch.from_numpy(LENS[:2]),
         torch.tensor([[1, 5, 2], [1, 7, 2]]),
         torch.tensor([3, 3]))["logit"].sum().backward()
    opt.step()
    port.eval()
    path = tmp_path / "last.pth"
    TC.save_checkpoint(str(path), variables, epoch=2, lr_count=9,
                       optimizer=opt.state_dict(), not_improve_cnt=1,
                       monitor_state={"mode": "max", "best": 1.5},
                       tokenizer_state={"a": 4})
    ckpt = TC.load_checkpoint(str(path))
    assert (ckpt["epoch"], ckpt["lr_count"], ckpt["not_improve_cnt"]) == (
        2, 9, 1)
    assert ckpt["monitor_state"] == {"mode": "max", "best": 1.5}
    assert set(ckpt["variables"]) == set(variables)
    for k, v in variables.items():
        assert isinstance(ckpt["variables"][k], np.ndarray)
        np.testing.assert_array_equal(ckpt["variables"][k], v, k)
    opt2 = torch.optim.Adam(port.parameters(), lr=1e-3)
    opt2.load_state_dict(ckpt["optimizer"])
    for a, b in zip(opt.state.values(), opt2.state.values()):
        for k in a:
            assert torch.equal(a[k], b[k])
    # the weights came from the JAX pair, so the tokens are JAX's too
    got = _api(ckpt["variables"])(AUDIO, LENS, sample_method="greedy",
                                  max_length=L)
    np.testing.assert_array_equal(got, j_seq)


def test_swa_matches_jax(pair):
    _, jvars, _ = pair
    rng = np.random.RandomState(0)
    snaps = [jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.randn(*np.shape(x)).astype(
            np.float32) * 0.3, jvars) for _ in range(3)]
    j = JSWA.swa_init(snaps[0]["params"], snaps[0]["batch_stats"])
    t = TSWA.swa_init({k: v.numpy() for k, v in
                       state_dict_from_jax(snaps[0]).items()})
    for s in snaps:
        j = JSWA.swa_update(j, s["params"], s["batch_stats"])
        t = TSWA.swa_update(t, {k: v.numpy() for k, v in
                                state_dict_from_jax(s).items()})
    assert t[1] == int(j[2]) == 3
    want = state_dict_from_jax({"params": j[0], "batch_stats": j[1]})
    for k, v in want.items():
        np.testing.assert_allclose(t[0][k], v.numpy(), rtol=0, atol=1e-7,
                                   err_msg=k)
    mean = np.mean([state_dict_from_jax(s)["model.model.decoder."
                                           "word_embedding.weight"].numpy()
                    for s in snaps], 0)
    np.testing.assert_allclose(
        t[0]["model.model.decoder.word_embedding.weight"], mean, atol=1e-6)


def test_swa_on_torch_tensors_keeps_counts():
    a = {"w": torch.ones(3), "n": torch.tensor(4)}
    b = {"w": torch.full((3,), 3.0), "n": torch.tensor(9)}
    s = TSWA.swa_update(TSWA.swa_update(TSWA.swa_init(a), a), b)
    assert s[1] == 2 and torch.equal(s[0]["w"], torch.full((3,), 2.0))
    assert int(s[0]["n"]) == 9


@pytest.mark.parametrize("impl", [JC, TC], ids=["jax", "port"])
def test_async_checkpointer_orders_jobs_and_propagates_errors(impl):
    seen = []
    w = impl.AsyncCheckpointer()
    for i in range(4):
        w.submit(lambda i=i: (time.sleep(0.01), seen.append(i)))
    w.wait()
    assert seen == [0, 1, 2, 3]
    w.wait()

    def boom():
        raise RuntimeError("ckpt write failed")
    w.submit(boom)
    with pytest.raises(RuntimeError, match="ckpt write failed"):
        w.submit(lambda: None)
    w.wait()


def test_async_checkpointer_overlap():
    w = TC.AsyncCheckpointer()
    assert w.submit(lambda: None) < 0.5
    time.sleep(0.05)
    assert w.submit(lambda: time.sleep(0.2)) < 0.5
    assert w.submit(lambda: None) > 0.1        # joined the 0.2 s job
    w.close()


@pytest.mark.parametrize("mode", ["max", "min"])
def test_metric_improver_matches_jax(mode):
    values = [0.3, 0.2, 0.5, 0.5, float("nan"), 0.1, 0.7]
    j, t = JC.MetricImprover(mode), TC.MetricImprover(mode)
    assert [t(v) for v in values] == [j(v) for v in values]
    assert t.best == j.best and t.state_dict() == j.state_dict()
    t2 = TC.MetricImprover("max" if mode == "min" else "min")
    t2.load_state_dict(j.state_dict())
    assert t2.state_dict() == j.state_dict()
    with pytest.raises(ValueError):
        TC.MetricImprover("mean")


def test_merge_variables_copies_matching_shapes_only():
    target = {"a": np.zeros(3, np.float32), "b": torch.zeros(2, 2),
              "c": np.zeros(4, np.float32)}
    source = {"a": np.arange(3.0), "b": np.ones((2, 2)),
              "c": np.ones(5), "extra": 1}
    out = TC.merge_variables(target, source)
    assert set(out) == set(target)
    np.testing.assert_array_equal(out["a"], [0, 1, 2])
    assert out["a"].dtype == np.float32
    assert torch.equal(out["b"], torch.ones(2, 2))
    assert out["c"] is target["c"]
    want = JC.merge_variables(
        {"a": np.zeros(3, np.float32), "c": np.zeros(4, np.float32)},
        {"a": np.arange(3.0), "c": np.ones(5)})
    np.testing.assert_array_equal(out["a"], want["a"])
    np.testing.assert_array_equal(out["c"], want["c"])
