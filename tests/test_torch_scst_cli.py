"""SCST through the port's command line on the CPU (``python -m
audiocaption_tpu_torch.cli.run train CONFIG device=cpu``), in the 4-clip
workspace of ``test_torch_train_cli``: an XE run of a cnn14rnn_trm
config (the ``CrnnEncoder`` composition at 16 kHz, a 2-layer BiGRU(32)
with dropout, a 2-layer transformer decoder at emb 64; one epoch), then
an ``ScstWrapper`` config of the same model that resumes from the XE
run's ``best.pth`` (``finetune: True``) and runs one epoch of SCST.  It
writes ``train.log`` (``loss``, minus the mean sampled reward, and
``val_cider``), ``last.pth`` and ``best.pth``."""

import re

import numpy as np
import pytest
import yaml

from audiocaption_tpu_torch.cli.run import main
from audiocaption_tpu_torch.training.checkpoint import load_checkpoint

from test_torch_train_cli import workspace  # noqa: F401


def _crnn_node(freeze: bool) -> dict:
    return {
        "type": "captioning.models.transformer_model.TransformerModel",
        "encoder": {
            "type": "captioning.models.crnn_trm_encoder.CrnnEncoder",
            "args": {"freeze_cnn": freeze, "freeze_cnn_bn": freeze},
            "cnn": {"type": "captioning.models.cnn_encoder.Cnn14Encoder",
                    "args": {"sample_rate": 16000}},
            "rnn": {"type": "captioning.models.rnn_encoder.RnnEncoder",
                    "args": {"bidirectional": True, "hidden_size": 32,
                             "dropout": 0.5, "num_layers": 2}}},
        "decoder": {
            "type": "captioning.models.transformer_decoder."
                    "TransformerDecoder",
            "args": {"emb_dim": 64, "fc_emb_dim": 64, "attn_emb_dim": 64,
                     "nlayers": 2, "dropout": 0.2}},
    }


@pytest.fixture(scope="module")
def runs(workspace):  # noqa: F811
    root, _ = workspace
    with open(root / "effb2_trm.yaml") as f:
        base = yaml.safe_load(f)
    xe = dict(base, model=_crnn_node(True),
              experiment_path=str(root / "crnn_xe"),
              scheduled_sampling={"use": False}, swa={"use": False})
    xe["trainer"] = dict(base["trainer"], epochs=1)
    with open(root / "crnn_xe.yaml", "w") as f:
        yaml.safe_dump(xe, f)
    main(["train", str(root / "crnn_xe.yaml"), "device=cpu"])
    xe_best = root / "crnn_xe" / "seed_1" / "best.pth"
    scst = dict(xe, experiment_path=str(root / "crnn_scst"),
                resume=str(xe_best), rl={"max_length": 20},
                model={"type": "captioning.models.rl_model.ScstWrapper",
                       "model": _crnn_node(False)})
    scst.pop("loss")
    scst["optimizer"] = {"type": "torch.optim.Adam",
                         "args": {"lr": 5e-5, "weight_decay": 1e-6}}
    scst["trainer"] = dict(xe["trainer"], finetune=True)
    with open(root / "scst.yaml", "w") as f:
        yaml.safe_dump(scst, f)
    main(["train", str(root / "scst.yaml"), "device=cpu"])
    return xe_best, root / "crnn_scst" / "seed_1"


def test_scst_run_writes_log_and_checkpoints(runs):
    xe_best, exp = runs
    for name in ("config.yaml", "train.log", "last.pth", "best.pth"):
        assert (exp / name).is_file(), name
    text = (exp / "train.log").read_text()
    assert f"weights from {xe_best}" in text
    epochs = re.findall(r"epoch 1: loss (\S+) val_cider (\S+)", text)
    assert len(epochs) == 1
    loss, score = map(float, epochs[0])
    assert np.isfinite(loss) and loss <= 0.0      # minus the mean reward
    assert np.isfinite(score) and score >= 0.0
    last = load_checkpoint(str(exp / "last.pth"))
    assert last["epoch"] == 1 and last["lr_count"] == 1
    assert any(k.startswith("encoder.rnn.network.") for k in last["variables"])


def test_scst_step_moved_the_xe_weights(runs):
    xe_best, exp = runs
    before = load_checkpoint(str(xe_best))["variables"]
    after = load_checkpoint(str(exp / "last.pth"))["variables"]
    assert set(before) == set(after)
    moved = [k for k in after if not np.array_equal(after[k], before[k])]
    assert any(k.startswith("decoder.") for k in moved)
    # SCST runs in inference mode: no BN statistic moves
    assert not [k for k in moved if "running_" in k]
