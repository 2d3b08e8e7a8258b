"""The port's temporal-tag pipeline in the runner against the JAX
runner's, on the CPU, on shared weights: ``predict_temporal``'s
predictions json and SED tag-accuracy file and ``evaluate_temporal``'s
score file byte for byte the JAX runner's, from the same two experiment
directories (a narrow tag-conditioned captioner and an 8-class SED net,
written by the JAX package's ``save_checkpoint``: the port reads them
through its checkpoint converter) on a 4-clip temporal corpus of 10 s
clips the JAX generator wrote (h5).  The captioner's decoder is jittered
and the SED classifier sharpened, so the tags are not all one value and
the captions depend on them.  ``train_sed`` runs one epoch in the port on
the same corpus through the ``sed.yaml`` node, and its checkpoint loads
back into a ``predict_temporal`` call.  The CLI's subcommands are wired
(no "not ported" refusal).
"""

import filecmp
import json

import pytest
import torch
import yaml

from audiocaption_tpu.cli import synthetic_corpus as J
from audiocaption_tpu.cli.run import Runner as JRunner
from audiocaption_tpu.models.rnn_decoder import convert_bahattn_decoder
from audiocaption_tpu.models.rnn_encoder import convert_cnn14_rnn
from audiocaption_tpu.models.sed import convert_cnn8rnn
from audiocaption_tpu.training.checkpoint import (
    save_checkpoint as j_save_checkpoint)

from audiocaption_tpu_torch.cli import run as port_run
from audiocaption_tpu_torch.cli.recipes import sed_train, temporal_test
from audiocaption_tpu_torch.data.tokenizer import DictTokenizer
from audiocaption_tpu_torch.models.sed import Cnn8RnnSedModel
from audiocaption_tpu_torch.models.zoo import random_init
from audiocaption_tpu_torch.utils.config import build_model_from_config

from test_torch_cnn14rnn_trm import jitter
from test_torch_temporal_train import MODEL

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("temporal")
    data = root / "data"
    J.generate_temporal(str(data), 2, 2, 4, sr=32000, seed=0)
    tok = DictTokenizer(str(data / "vocab.pkl"))

    cap = root / "tempgru"
    cap.mkdir()
    model, _ = build_model_from_config(MODEL, vocab_size=len(tok))
    random_init(model, torch.Generator().manual_seed(0))
    jitter(model, 1, decoder_scale=0.3)
    enc = {k: v.numpy() for k, v in model.encoder.state_dict().items()}
    dec = {k: v.numpy() for k, v in model.decoder.state_dict().items()}
    p_enc, s_enc = convert_cnn14_rnn(enc, rnn_num_layers=1)
    j_save_checkpoint(
        str(cap / "swa.pth"),
        {"params": {"encoder": p_enc,
                    "decoder": convert_bahattn_decoder(dec, temporal=True)},
         "batch_stats": {"encoder": s_enc}},
        tokenizer_state=tok.state_dict())
    (cap / "config.yaml").write_text(yaml.safe_dump({"model": MODEL}))

    sed_dir = root / "sed"
    sed_dir.mkdir()
    sed = Cnn8RnnSedModel(classes_num=8)
    random_init(sed, torch.Generator().manual_seed(2))
    jitter(torch.nn.ModuleDict({"encoder": sed,
                                "decoder": torch.nn.Linear(1, 1)}), 3)
    with torch.no_grad():
        sed.fc_audioset.weight.mul_(1.8)
    params, stats = convert_cnn8rnn(
        {k: v.numpy() for k, v in sed.state_dict().items()})
    j_save_checkpoint(str(sed_dir / "best.pth"),
                      {"params": params, "batch_stats": stats},
                      extra={"classes_num": 8})

    test_yaml = root / "test.yaml"
    test_yaml.write_text(yaml.safe_dump(temporal_test(str(data))))
    return dict(root=root, data=data, cap=cap, sed=sed_dir,
                test=str(test_yaml))


def _outputs(tag):
    return [f"caption_output=predictions/{tag}.json",
            f"tag_output=results/{tag}_tag.txt",
            f"score_output=results/{tag}_scores.txt",
            "data.test.dataloader_args.batch_size=4"]


@pytest.fixture(scope="module")
def runs(workspace):
    w = workspace
    j = JRunner().evaluate_temporal(str(w["cap"]), str(w["sed"]), w["test"],
                                    *_outputs("jax"))
    p = port_run.Runner().evaluate_temporal(
        str(w["cap"]), str(w["sed"]), w["test"], *_outputs("port"),
        "device=cpu")
    return j, p


@pytest.mark.parametrize("name", ["predictions/{}.json",
                                  "results/{}_tag.txt",
                                  "results/{}_scores.txt"])
def test_files_byte_equal_jax(workspace, runs, name):
    cap = workspace["cap"]
    assert filecmp.cmp(cap / name.format("jax"), cap / name.format("port"),
                       shallow=False), name


def test_tags_and_captions_are_informative(workspace, runs):
    cap = workspace["cap"]
    preds = json.loads((cap / "predictions/port.json").read_text())
    captions = [p["caption"] for p in preds["predictions"]]
    assert len(captions) == 4 and all(captions)
    acc = (cap / "results/port_tag.txt").read_text()
    assert acc.startswith("sed_tag_accuracy: ") and "/4)" in acc
    _, p = runs
    assert set(k for k, v in p.items() if isinstance(v, float)) >= {
        "bleu_4", "rouge_l", "cider", "meteor_py", "spider_py"}


def test_train_sed_writes_a_loadable_checkpoint(workspace):
    w = workspace
    cfg = sed_train(str(w["data"]))
    exp = port_run.Runner().train_sed(
        cfg, "device=cpu", f"experiment_path={w['root']}/sed_port",
        "trainer.epochs=1", "trainer.batch_size=2")
    log = (w["root"] / "sed_port/seed_1/train.log").read_text()
    assert "epoch 1: bce" in log and "val_tag_acc" in log
    # the port's corpus is read from wav.csv when the h5 is absent; here
    # the JAX corpus's h5 exists and is read
    model = port_run.Runner()._load_sed(exp, "best.pth",
                                        torch.device("cpu"))
    assert isinstance(model, Cnn8RnnSedModel) and not model.training
    key2pred = port_run.Runner().predict_temporal(
        str(w["cap"]), exp, w["test"], *_outputs("port_sed"), "device=cpu",
        "sed_resume=best.pth")
    assert len(key2pred) == 4


def test_cli_runs_the_temporal_subcommands(workspace, capsys):
    w = workspace
    port_run.main(["predict_temporal", "--experiment_path", str(w["cap"]),
                   "--sed_experiment_path", str(w["sed"]), "--eval_config",
                   w["test"], *_outputs("cli"), "device=cpu"])
    assert (w["cap"] / "predictions/cli.json").exists()
    assert "train_sed" not in port_run.NOT_PORTED
    assert set(port_run.NOT_PORTED) == {"train_aug"}
