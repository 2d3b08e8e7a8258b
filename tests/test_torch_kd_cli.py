"""Knowledge distillation through the port's command line on the CPU
(``python -m audiocaption_tpu_torch.cli.run train_kd CONFIG
device=cpu``), in the 4-clip 1 s workspace of ``test_torch_train_cli``.

The teacher is an experiment the JAX package wrote: a Cdur5 + 1-layer
transformer captioner (emb 64, 16 kHz), its weights drawn from a seed,
BN calibrated and decoder jittered (``test_torch_cdur5``, so that its
captions differ between clips), carried into the flax tree by the JAX
package's converters, its ``config.yaml`` and a ``best.pth`` saved by
the JAX ``save_checkpoint``, so that ``Runner._load_experiment`` reads a
JAX checkpoint.  The student is the KD student recipe at emb 64.  One
epoch of each mode:

  * token KD (KL, T=2, weight 0.5);
  * seq KD: ``pseudo_captions.json`` holds the teacher's greedy caption
    of every clip, equal to the JAX package's own greedy decode of the
    teacher on the same clips;
  * enc KD with the teacher's encoder on the fly, and unsupervised enc KD
    from an npz of teacher embeddings.

Each writes ``train.log`` (``kd[type] epoch 1: loss ... val_cider ...``)
with a finite loss, ``last.pth``, ``best.pth`` and ``swa.pth``, and the
student's weights moved from their seeded draw."""

import json
import re

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from audiocaption_tpu.models.captioner import generate as j_generate
from audiocaption_tpu.training.checkpoint import (
    save_checkpoint as j_save_checkpoint)
from audiocaption_tpu.utils.config import (
    build_model_from_config as j_build)

from audiocaption_tpu_torch.cli.run import main
from audiocaption_tpu_torch.data.dataset import InferenceDataset
from audiocaption_tpu_torch.models.zoo import random_init
from audiocaption_tpu_torch.training.checkpoint import load_checkpoint
from audiocaption_tpu_torch.utils.config import build_model_from_config

from test_torch_cdur5 import calibrate_and_jitter, jax_variables
from test_torch_train_cli import SR, workspace  # noqa: F401


def _cdur5_node(emb: int) -> dict:
    return {
        "type": "captioning.models.transformer_model.TransformerModel",
        "encoder": {"type": "captioning.models.crnn_trm_encoder.Cdur5Encoder",
                    "args": {"sample_rate": SR}},
        "decoder": {
            "type": "captioning.models.transformer_decoder."
                    "TransformerDecoder",
            "args": {"emb_dim": emb, "nlayers": 1, "dropout": 0.2}},
    }


@pytest.fixture(scope="module")
def teacher(workspace):  # noqa: F811
    """A JAX-written teacher experiment, and the clips' waves."""
    root, tok = workspace
    exp = root / "jax_teacher"
    exp.mkdir()
    node = _cdur5_node(64)
    model, _ = j_build(node, vocab_size=len(tok))
    drawn, _ = build_model_from_config(node, vocab_size=len(tok))
    random_init(drawn, torch.Generator().manual_seed(3))
    calibrate_and_jitter(drawn, 4)
    variables = jax_variables(drawn)
    j_save_checkpoint(str(exp / "best.pth"), variables, epoch=1,
                      tokenizer_state=tok.state_dict())
    (exp / "config.yaml").write_text(yaml.safe_dump({"model": node}))
    ds = InferenceDataset({"wav": str(root / "wav.csv")})
    wavs = {item["audio_id"]: item["wav"] for item in
            (ds[i] for i in range(len(ds)))}
    return exp, model, variables, wavs


def _run(workspace, teacher, mode: str, **kd) -> tuple:  # noqa: F811
    root, _ = workspace
    with open(root / "effb2_trm.yaml") as f:
        base = yaml.safe_load(f)
    cfg = dict(base, model=_cdur5_node(64),
               experiment_path=str(root / f"kd_{mode}"),
               scheduled_sampling={"use": False}, swa={"use": False},
               kd=dict(kd, teacher={"experiment_path": str(teacher[0]),
                                    "resume": "best.pth"}))
    cfg["trainer"] = dict(base["trainer"], epochs=1)
    path = root / f"kd_{mode}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    main(["train_kd", str(path), "device=cpu"])
    return root / f"kd_{mode}" / "seed_1"


@pytest.fixture(scope="module")
def runs(workspace, teacher):  # noqa: F811
    root, _ = workspace
    embs = {f"aud{i}": np.random.RandomState(i).randn(24).astype(np.float32)
            for i in range(4)}
    np.savez(root / "tchr_emb.npz", **embs)
    return {
        "token": _run(workspace, teacher, "token", type="token", weight=0.5,
                      kd_loss="kl", temperature=2.0),
        "seq": _run(workspace, teacher, "seq", type="seq"),
        "enc": _run(workspace, teacher, "enc", type="enc", shared_dim=32),
        "enc_unsup": _run(workspace, teacher, "enc_unsup", type="enc",
                          unsup=True, shared_dim=32,
                          teacher_emb=str(root / "tchr_emb.npz")),
    }


@pytest.mark.parametrize("mode", ["token", "seq", "enc", "enc_unsup"])
def test_train_kd_writes_log_and_checkpoints(runs, mode):
    exp = runs[mode]
    for name in ("config.yaml", "train.log", "last.pth", "best.pth",
                 "swa.pth"):
        assert (exp / name).is_file(), name
    text = (exp / "train.log").read_text()
    assert "teacher from" in text
    kind = "enc" if mode.startswith("enc") else mode
    found = re.findall(rf"kd\[{kind}\] epoch 1: loss (\S+) val_cider (\S+)",
                       text)
    assert len(found) == 1
    loss, score = map(float, found[0])
    assert np.isfinite(loss) and loss > 0 and np.isfinite(score)
    last = load_checkpoint(str(exp / "last.pth"))
    assert last["epoch"] == 1 and last["tokenizer"]
    assert any(k.startswith("encoder.gru.") for k in last["variables"])
    assert not any(k.startswith("head.") for k in last["variables"])


def test_train_kd_moves_the_student(runs, workspace):  # noqa: F811
    """The same seed draws the same student in every run; one epoch moves
    it, and differently in each mode."""
    lasts = {m: load_checkpoint(str(runs[m] / "last.pth"))["variables"]
             for m in runs}
    k = "decoder.word_embedding.weight"
    vals = [lasts[m][k] for m in runs]
    assert all(not np.array_equal(a, b) for i, a in enumerate(vals)
               for b in vals[i + 1:])


def test_seq_kd_pseudo_captions_are_the_jax_teachers(runs, teacher,
                                                     workspace):  # noqa: F811
    _, tok = workspace
    _, model, variables, wavs = teacher
    cache = json.loads((runs["seq"] / "pseudo_captions.json").read_text())
    assert set(cache) == set(wavs)
    ids = sorted(wavs)
    wav = jnp.asarray(np.stack([wavs[a] for a in ids]))
    seq = jax.jit(lambda v, w, n: j_generate(
        model, v, w, n, sample_method="greedy")["seq"])(
            variables, wav, jnp.full((len(ids),), SR, jnp.int32))
    want = dict(zip(ids, tok.decode(np.asarray(seq))))
    assert cache == want
    assert len(set(want.values())) > 1
