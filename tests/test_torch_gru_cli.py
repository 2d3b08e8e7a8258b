"""``Runner.train`` of the GRU-decoder family on the CPU, from config
dicts, on a 4-clip HDF5 workspace at 32 kHz (clips of 1 s, one caption
each, a ``condition.csv`` with one value per caption):

  * the model of ``chip_smoke.py`` phase 27(b): a ``Cnn10Encoder`` and a
    2-layer ``BahAttnAddFcDecoder`` (emb and d_model 512), label
    smoothing, scheduled sampling, 2 epochs of one step: ``train.log``
    lines with finite losses and val scores, ``last`` / ``best`` /
    ``swa.pth``, and the weights of ``swa.pth`` load back into the model
    the builder makes;
  * SCST of that run's ``best.pth`` (an ``ScstWrapper`` node, ``resume``
    with ``finetune``): 2 steps on the torch engine, a finite reward;
  * conditioned decoders on ``ConditionCaptionDataset``:
    ``ConditionalBahAttnDecoder`` with ``ConditionLossWrapper`` (gumbel,
    a seeded discriminator) and ``SpecificityBahAttnDecoder`` with
    ``SpecificityLossWrapper`` (a word-specificity ``.npy``): 2 steps,
    finite losses, and the condition term is in the loss (the same run
    without it logs another loss)."""

import json
import pickle
import re

import numpy as np
import pytest

from audiocaption_tpu_torch.cli.run import Runner
from audiocaption_tpu_torch.data.tokenizer import DictTokenizer
from audiocaption_tpu_torch.models.convert import load_reference_state_dict
from audiocaption_tpu_torch.training.checkpoint import load_checkpoint
from audiocaption_tpu_torch.utils.config import build_model_from_config

SR = 32000
CAPS = ["a dog barks loudly", "water flows down", "someone speaks",
        "music plays softly"]


def _node(dec_type="BahAttnAddFcDecoder", enc_type="Cnn10Encoder", emb=512,
          d_model=512, num_layers=2):
    return {"type": "captioning.models.seq2seq.Seq2SeqAttnModel",
            "encoder": {"type": f"captioning.models.cnn_encoder.{enc_type}",
                        "args": {"sample_rate": SR}},
            "decoder": {"type": f"captioning.models.rnn_decoder.{dec_type}",
                        "args": {"emb_dim": emb, "d_model": d_model,
                                 "num_layers": num_layers, "dropout": 0.5}}}


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    import h5py
    root = tmp_path_factory.mktemp("gru_runner")
    rng = np.random.RandomState(0)
    t = np.arange(SR) / SR
    with h5py.File(root / "waveform.h5", "w") as f:
        for i in range(len(CAPS)):
            f[f"aud{i}"] = (0.3 * np.sin(2 * np.pi * 300 * (i + 1) * t)
                            + rng.randn(SR) * 0.05).astype(np.float32)
    with open(root / "wav.csv", "w") as f:
        f.write("audio_id\thdf5_path\n")
        for i in range(len(CAPS)):
            f.write(f"aud{i}\t{root / 'waveform.h5'}\n")
    with open(root / "text.json", "w") as f:
        json.dump({"audios": [
            {"audio_id": f"aud{i}", "captions": [
                {"tokens": c, "caption": c, "cap_id": "1"}]}
            for i, c in enumerate(CAPS)]}, f)
    with open(root / "condition.csv", "w") as f:
        f.write("cap_id\tprob\n")
        for i in range(len(CAPS)):
            f.write(f"aud{i}_1\t{i % 2}\n")
    tok = DictTokenizer()
    for c in CAPS:
        for w in c.split():
            tok.add_word(w)
    with open(root / "vocab.pkl", "wb") as f:
        pickle.dump(tok.state_dict(), f)
    np.save(root / "ws.npy", rng.rand(len(tok)).astype(np.float32))
    return root, tok


def _config(root, name, node, train_ds=None, loss=None, epochs=2):
    wav = {"wav": str(root / "wav.csv")}
    ds = train_ds or {"type": "CaptionDataset",
                      "args": {"features": wav,
                               "caption": str(root / "text.json")}}
    return {
        "experiment_path": str(root / name), "seed": 1, "device": "cpu",
        "model": node,
        "data": {
            "train": {
                "dataset": ds,
                "collate_fn": {
                    "type": "TextCollate",
                    "args": {"pad_keys": ["wav", "cap"], "sort_key": "cap"},
                    "tokenizer": {
                        "type": "DictTokenizer",
                        "args": {"tokenizer_path": str(root / "vocab.pkl"),
                                 "max_length": 20}}},
                "dataloader_args": {"batch_size": 2, "shuffle": False,
                                    "num_workers": 0}},
            "val": {
                "dataset": {"type": "InferenceDataset",
                            "args": {"features": wav}},
                "collate_fn": {"type": "VarLenPadCollate",
                               "args": {"pad_keys": ["wav"]}},
                "caption": str(root / "text.json"),
                "dataloader_args": {"batch_size": 4, "num_workers": 0}}},
        "optimizer": {"type": "Adam", "args": {"lr": 5e-4,
                                               "weight_decay": 1e-6}},
        "lr_scheduler": {"type": "ExponentialDecayScheduler",
                         "args": {"final_lrs": 5e-7}},
        "loss": loss or {"type": "LabelSmoothingLoss",
                         "args": {"smoothing": 0.1}},
        "trainer": {"epochs": epochs, "max_grad_norm": 1.0},
        "scheduled_sampling": {"use": True, "mode": "linear",
                               "final_ratio": 0.7},
        "swa": {"use": True, "start": 2}}


def _epoch_losses(exp) -> list:
    lines = (exp / "train.log").read_text().splitlines()
    out = []
    for ln in lines:
        m = re.search(r"epoch \d+: loss (\S+) val_cider (\S+)", ln)
        if m:
            out.append((float(m.group(1)), float(m.group(2))))
    return out


@pytest.fixture(scope="module")
def xe_run(workspace):
    root, tok = workspace
    cfg = _config(root, "xe", _node(), epochs=1)
    cfg["data"]["train"]["dataloader_args"]["batch_size"] = 2
    return root, tok, Runner().train(cfg)


def test_gru_config_trains(xe_run):
    from pathlib import Path
    root, tok, out = xe_run
    exp = Path(out)
    for name in ("config.yaml", "train.log", "last.pth", "best.pth",
                 "swa.pth"):
        assert (exp / name).is_file(), name
    losses = _epoch_losses(exp)
    assert len(losses) == 1
    assert all(np.isfinite(x) and s >= 0 for x, s in losses)
    model, _ = build_model_from_config(_node(), vocab_size=len(tok))
    load_reference_state_dict(model, load_checkpoint(
        str(exp / "swa.pth"))["variables"])
    assert model.decoder.num_layers == 2


def test_scst_of_the_gru_run(xe_run):
    from pathlib import Path
    root, tok, out = xe_run
    cfg = _config(root, "scst", {"type": "ScstWrapper", "model": _node()},
                  epochs=1)
    cfg["resume"] = str(Path(out) / "best.pth")
    cfg["trainer"]["finetune"] = True
    cfg["rl"] = {"max_length": 8, "sample_temp": 1.0}
    scst = Path(Runner().train(cfg))
    losses = _epoch_losses(scst)
    assert len(losses) == 1 and np.isfinite(losses[0][0])
    assert "weights from" in (scst / "train.log").read_text()


@pytest.mark.parametrize("kind", ["condition", "specificity"])
def test_conditioned_configs_train(workspace, kind):
    from pathlib import Path
    root, tok = workspace
    ds = {"type": "ConditionCaptionDataset",
          "args": {"features": {"wav": str(root / "wav.csv")},
                   "caption": str(root / "text.json"),
                   "condition": str(root / "condition.csv")}}
    inner = {"type": "LabelSmoothingLoss", "args": {"smoothing": 0.1}}
    if kind == "condition":
        node = _node("ConditionalBahAttnDecoder", "Cnn6Encoder", 32, 32, 1)
        loss = {"type": "ConditionLossWrapper",
                "args": {"loss": inner, "alpha": 1.0,
                         "sample_method": "gumbel",
                         "dscrm": {"vocab_size": len(tok), "emb_dim": 16,
                                   "hidden_size": 16, "seed": 2}}}
    else:
        node = _node("SpecificityBahAttnDecoder", "Cnn6Encoder", 32, 32, 2)
        loss = {"type": "SpecificityLossWrapper",
                "args": {"loss": inner, "alpha": 1.0,
                         "word_specificity": str(root / "ws.npy")}}
    runs = {}
    for name, lf in ((kind, loss), (kind + "_plain", inner)):
        exp = Path(Runner().train(_config(root, name, node, ds, lf)))
        runs[name] = _epoch_losses(exp)
    assert len(runs[kind]) == 2
    assert all(np.isfinite(x) for x, _ in runs[kind])
    assert runs[kind][0][0] != runs[kind + "_plain"][0][0]
