"""A full resume (``trainer.finetune: False``) of the port's runner, on the
CPU, with an M2 transformer on an h5 feature corpus (8 clips of 5-9 rows of
24 features, 2 captions each), device-resident banks and the prefetcher:

  * two epochs in one run equal one epoch followed by a full resume for
    the second (dropout 0, no shuffling, no scheduled sampling, the
    optimizer's state in the checkpoint): the weights, the epoch, the
    monitor's state, ``not_improve_cnt`` and the update count ``lr_count``;
  * a finetune resume takes the weights alone: the epoch, the counters and
    the monitor start again;
  * on one checkpoint written by the JAX runner, the port's full resume
    and the JAX runner's start from the same epoch and go on from the same
    update count."""

import json
import pickle
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch
import yaml

from audiocaption_tpu.cli.run import Runner as JRunner

from audiocaption_tpu_torch.cli.run import Runner
from audiocaption_tpu_torch.data.tokenizer import DictTokenizer

torch.set_num_threads(2)
DIN, N_CLIPS, BATCH = 24, 8, 8
STEPS = N_CLIPS * 2 // BATCH          # per epoch


def data_node(root, split):
    feats = {"wav": str(root / f"{split}.csv")}
    node = {"device_resident": True,
            "dataset": {"type": "CaptionDataset" if split == "train"
                        else "InferenceDataset",
                        "args": {"features": feats}},
            "dataloader_args": {"shuffle": False, "batch_size": BATCH,
                                "num_workers": 0}}
    if split == "train":
        node["dataset"]["args"]["caption"] = str(root / "text.json")
        node["collate_fn"] = {
            "type": "TextCollate",
            "args": {"pad_keys": ["wav", "cap"], "sort_key": "cap",
                     "wire_dtype": {"wav": "float16"}},
            "tokenizer": {"type": "DictTokenizer",
                          "args": {"tokenizer_path": str(root / "vocab.pkl"),
                                   "max_length": 20}}}
    else:
        node["collate_fn"] = {"type": "VarLenPadCollate",
                              "args": {"pad_keys": ["wav"]}}
        node["caption"] = str(root / "text.json")
    return node


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("resume")
    rng = np.random.RandomState(0)
    words = ["a", "dog", "barks", "water", "flows", "loud", "soft", "bird",
             "sings", "car", "passes", "by"]
    with h5py.File(root / "attn.h5", "w") as f:
        for i in range(N_CLIPS):
            f[f"c{i}"] = rng.randn(5 + i % 5, DIN).astype(np.float32)
    for split in ("train", "val"):
        with open(root / f"{split}.csv", "w") as f:
            f.write("audio_id\thdf5_path\n")
            ids = range(N_CLIPS) if split == "train" else range(4)
            f.writelines(f"c{i}\t{root / 'attn.h5'}\n" for i in ids)
    caps = {"audios": [{"audio_id": f"c{i}", "captions": [
        {"caption": " ".join(rng.choice(words, 4)), "cap_id": j}
        for j in range(2)]} for i in range(N_CLIPS)]}
    (root / "text.json").write_text(json.dumps(caps))
    tok = DictTokenizer()
    for w in words:
        tok.add_word(w)
    with open(root / "vocab.pkl", "wb") as f:
        pickle.dump(tok.state_dict(), f)
    cfg = {
        "seed": 1, "device": "cpu",
        "data": {"train": data_node(root, "train"),
                 "val": data_node(root, "val")},
        "model": {"type": "M2TransformerModel",
                  "encoder": {"type": "M2TransformerEncoder",
                              "args": {"input_dim": DIN, "d_model": 32,
                                       "nlayers": 2, "nhead": 4, "m": 4,
                                       "dropout": 0.0}},
                  "decoder": {"type": "M2TransformerDecoder",
                              "args": {"attn_emb_dim": 32, "nlayers": 1,
                                       "nhead": 4, "dropout": 0.0}}},
        "optimizer": {"args": {"lr": 1e-3, "weight_decay": 1e-6}},
        "lr_scheduler": {"type": "ExponentialDecayScheduler",
                         "args": {"final_lrs": 1e-5}},
        "loss": {"type": "LabelSmoothingLoss", "args": {"smoothing": 0.1}},
        "trainer": {"epochs": 2, "max_grad_norm": 1.0, "finetune": True,
                    "include_optim_in_ckpt": True, "early_stop": 10},
        "scheduled_sampling": {"use": False},
        "swa": {"use": False},
    }
    return root, cfg


def ckpt(exp, name="last.pth"):
    return pickle.loads((exp / name).read_bytes())


@pytest.fixture(scope="module")
def runs(workspace):
    root, cfg = workspace
    runner = Runner()
    whole = Runner().train(cfg, f"experiment_path={root}/whole")
    head = runner.train(cfg, f"experiment_path={root}/split", stop_epoch=1)
    first = ckpt(Path(head))
    split = runner.train(cfg, f"experiment_path={root}/split",
                         f"resume={head}/last.pth", "trainer.finetune=False")
    fine = runner.train(cfg, f"experiment_path={root}/fine",
                        "trainer.epochs=1", f"resume={head}/last.pth")
    return {k: Path(v) for k, v in (("whole", whole), ("split", split),
                                    ("fine", fine), ("head", head))}, first


def test_full_resume_equals_the_uninterrupted_run(runs):
    exps, first = runs
    a, b = ckpt(exps["whole"]), ckpt(exps["split"])
    assert first["epoch"] == 1 and first["lr_count"] == STEPS
    assert first["optimizer"] is not None
    log = (exps["split"] / "train.log").read_text()
    assert "(epoch 2)" in log and log.count("epoch 1:") == 1
    for k in ("epoch", "monitor_state", "not_improve_cnt", "lr_count"):
        assert a[k] == b[k], k
    assert a["epoch"] == 2 and a["lr_count"] == 2 * STEPS
    assert set(a["variables"]) == set(b["variables"])
    for k, v in a["variables"].items():
        np.testing.assert_allclose(b["variables"][k], v, atol=1e-7, rtol=0,
                                   err_msg=k)
    moved = max(float(np.abs(a["variables"][k] - first["variables"][k]).max())
                for k in a["variables"] if "m_k" in k)
    assert moved > 0


def test_finetune_resume_keeps_the_counters_at_zero(runs):
    exps, first = runs
    c = ckpt(exps["fine"])
    log = (exps["fine"] / "train.log").read_text()
    assert "weights from" in log and "resumed from" not in log
    assert c["epoch"] == 1 and c["lr_count"] == STEPS
    assert c["not_improve_cnt"] == 0


def test_jax_resume_starts_where_the_port_does(workspace, runs):
    """The JAX runner writes one epoch; both runners resume that
    checkpoint in full and write the same epoch and update count."""
    root, cfg = workspace
    jcfg = dict(cfg, experiment_path=str(root / "jax"))
    jcfg.pop("device")
    (root / "jax.yaml").write_text(yaml.safe_dump(jcfg))
    jexp = JRunner().train(str(root / "jax.yaml"), "trainer.epochs=1")
    jexp = Path(jexp)
    start = ckpt(jexp)
    assert start["epoch"] == 1 and start["lr_count"] == STEPS
    j_after = JRunner().train(str(root / "jax.yaml"),
                              f"experiment_path={root}/jax_resumed",
                              f"resume={jexp}/last.pth",
                              "trainer.finetune=False")
    port_after = Runner().train(cfg, f"experiment_path={root}/port_resumed",
                                f"resume={jexp}/last.pth",
                                "trainer.finetune=False")
    j_log = (Path(j_after) / "train.log").read_text()
    p_log = (Path(port_after) / "train.log").read_text()
    assert "(epoch 2)" in j_log and "(epoch 2)" in p_log
    j_ck, p_ck = ckpt(Path(j_after)), ckpt(Path(port_after))
    assert j_ck["epoch"] == p_ck["epoch"] == 2
    assert j_ck["lr_count"] == p_ck["lr_count"] == 2 * STEPS
    assert j_ck["not_improve_cnt"] == p_ck["not_improve_cnt"]
