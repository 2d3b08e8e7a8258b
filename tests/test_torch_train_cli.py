"""``Runner.train`` of the port end to end on the CPU, through its command
line (``python -m audiocaption_tpu_torch.cli.run train CONFIG
device=cpu``): a 4-clip HDF5 workspace built as
``tests/test_cli_runners.py::workspace`` builds the JAX runner's, the
flagship recipe (EfficientNet-B2, 2-layer tied transformer decoder at
emb 64, label smoothing, Adam with the exponential schedule, scheduled
sampling, SWA) for 2 epochs with SWA from epoch 2.  It writes
``config.yaml``, ``train.log`` with ``val_cider`` each epoch,
``last.pth``, ``best.pth`` and ``swa.pth``, and the HF API decodes from
the reloaded ``swa.pth``.  Without ``device=cpu`` the run asks for the
card and raises here; types the port lacks raise naming the ROADMAP."""

import json
import pickle
import re

import numpy as np
import pytest
import yaml

from audiocaption_tpu_torch.cli.run import Runner, main
from audiocaption_tpu_torch.data.tokenizer import DictTokenizer
from audiocaption_tpu_torch.hf_api import (
    Effb2TrmCaptioningModel, Effb2TrmConfig)
from audiocaption_tpu_torch.training.checkpoint import load_checkpoint
from audiocaption_tpu_torch.utils.config import build_model_from_config

SR = 16000
CAPS = ["a dog barks loudly", "water flows down", "someone speaks",
        "music plays softly"]


def _model_node(emb: int = 64) -> dict:
    return {
        "type": "captioning.models.transformer_model.TransformerModel",
        "encoder": {"type": "captioning.models.cnn_encoder.EfficientNetB2",
                    "args": {}},
        "decoder": {
            "type": "captioning.models.transformer_decoder."
                    "TransformerDecoder",
            "args": {"emb_dim": emb, "fc_emb_dim": 1408,
                     "attn_emb_dim": 1408, "nlayers": 2, "dropout": 0.2,
                     "tie_weights": True}},
    }


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    import h5py
    root = tmp_path_factory.mktemp("port_runner")
    rng = np.random.RandomState(0)
    h5p = root / "waveform.h5"
    with h5py.File(h5p, "w") as f:
        for i in range(len(CAPS)):
            f[f"aud{i}"] = (rng.randn(SR) * (0.1 + 0.2 * i)).astype(
                np.float32)
    with open(root / "wav.csv", "w") as f:
        f.write("audio_id\thdf5_path\n")
        for i in range(len(CAPS)):
            f.write(f"aud{i}\t{h5p}\n")
    data = {"audios": [
        {"audio_id": f"aud{i}", "captions": [
            {"tokens": c, "caption": c, "cap_id": "1"}]}
        for i, c in enumerate(CAPS)]}
    with open(root / "text.json", "w") as f:
        json.dump(data, f)
    tok = DictTokenizer()
    for c in CAPS:
        for w in c.split():
            tok.add_word(w)
    with open(root / "vocab.pkl", "wb") as f:
        pickle.dump(tok.state_dict(), f)
    wav = {"wav": str(root / "wav.csv")}
    cfg = {
        "experiment_path": str(root / "exp"),
        "seed": 1,
        "model": _model_node(),
        "data": {
            "train": {
                "dataset": {
                    "type": "captioning.datasets.caption_dataset."
                            "CaptionDataset",
                    "args": {"features": wav,
                             "transforms": {"wav": None},
                             "caption": str(root / "text.json")}},
                "collate_fn": {
                    "type": "captioning.datasets.collate_func.TextCollate",
                    "args": {"pad_keys": ["wav", "cap"], "sort_key": "cap",
                             "wire_dtype": {"wav": "float16"}},
                    "tokenizer": {
                        "type": "DictTokenizer",
                        "args": {"tokenizer_path": str(root / "vocab.pkl"),
                                 "max_length": 20}}},
                "dataloader_args": {"batch_size": 4, "shuffle": True,
                                    "num_workers": 0}},
            "val": {
                "dataset": {
                    "type": "captioning.datasets.caption_dataset."
                            "InferenceDataset",
                    "args": {"features": wav}},
                "collate_fn": {
                    "type": "captioning.datasets.collate_func."
                            "VarLenPadCollate",
                    "args": {"pad_keys": ["wav"]}},
                "caption": str(root / "text.json"),
                "dataloader_args": {"batch_size": 4, "num_workers": 0}},
        },
        "optimizer": {"type": "torch.optim.Adam",
                      "args": {"lr": 5e-4, "weight_decay": 1e-6}},
        "lr_scheduler": {
            "type": "captioning.utils.lr_scheduler."
                    "ExponentialDecayScheduler",
            "args": {"final_lrs": 5e-7}},
        "loss": {"type": "captioning.losses.loss.LabelSmoothingLoss",
                 "args": {"smoothing": 0.1}},
        "trainer": {"epochs": 2, "max_grad_norm": 1.0,
                    "monitor_metric": {"name": "score", "mode": "max"}},
        "scheduled_sampling": {"use": True, "mode": "linear",
                               "final_ratio": 0.7},
        "swa": {"use": True, "start": 2},
    }
    with open(root / "effb2_trm.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    return root, tok


@pytest.fixture(scope="module")
def trained(workspace):
    root, tok = workspace
    main(["train", str(root / "effb2_trm.yaml"), "device=cpu"])
    return root / "exp" / "seed_1", tok


def test_train_writes_checkpoints_and_log(trained):
    exp, tok = trained
    for name in ("config.yaml", "train.log", "last.pth", "best.pth",
                 "swa.pth"):
        assert (exp / name).is_file(), name
    lines = (exp / "train.log").read_text().splitlines()
    epochs = [ln for ln in lines if re.search(r"epoch \d+: loss", ln)]
    assert len(epochs) == 2
    for ln in epochs:
        m = re.search(r"loss (\S+) val_cider (\S+) ss (\S+)", ln)
        assert m and np.isfinite(float(m.group(1)))
        assert float(m.group(2)) >= 0
    # one step an epoch, so the ratio falls 0.15 an epoch to 0.7
    assert [re.search(r"\bss (\S+)", ln).group(1) for ln in epochs] == [
        "0.850", "0.700"]
    with open(exp / "config.yaml") as f:
        assert yaml.safe_load(f)["device"] == "cpu"


def test_checkpoint_payloads(trained):
    exp, tok = trained
    last = load_checkpoint(str(exp / "last.pth"))
    swa = load_checkpoint(str(exp / "swa.pth"))
    assert last["epoch"] == 2 and last["lr_count"] == 2
    assert last["tokenizer"] == tok.state_dict()
    assert last["monitor_state"]["mode"] == "max"
    # SWA from epoch 2 of 2 averages one snapshot: epoch 2's weights
    assert set(swa["variables"]) == set(last["variables"])
    for k, v in last["variables"].items():
        np.testing.assert_array_equal(swa["variables"][k], v, k)
    best = load_checkpoint(str(exp / "best.pth"))
    assert best["epoch"] in (1, 2)


def test_api_decodes_from_swa_checkpoint(trained):
    exp, tok = trained
    api = Effb2TrmCaptioningModel(
        Effb2TrmConfig(vocab_size=len(tok), decoder_emb_dim=64),
        device="cpu")
    api.load_torch_state_dict(load_checkpoint(str(exp / "swa.pth"))
                              ["variables"])
    audio = np.random.RandomState(1).randn(2, SR).astype(np.float32) * 0.2
    ids = api(audio, [SR, 12000], sample_method="greedy", max_length=6)
    assert ids.shape == (2, 6) and ((ids >= 0) & (ids < len(tok))).all()
    assert not api.model.training


def test_resume_loads_the_weights(trained, workspace):
    """A second run starting from the first run's ``swa.pth`` (weights
    only, "finetune"), one epoch at a learning rate of 1e-30, ends with
    the same parameters (the BN statistics move with the batch)."""
    exp, _ = trained
    root, _ = workspace
    out = Runner().train(str(root / "effb2_trm.yaml"), "device=cpu",
                         f"resume={exp / 'swa.pth'}", "trainer.epochs=1",
                         "optimizer.args.lr=1.0e-30",
                         "lr_scheduler.args.final_lrs=1.0e-30",
                         f"experiment_path={root / 'resumed'}")
    got = load_checkpoint(f"{out}/swa.pth")["variables"]
    want = load_checkpoint(str(exp / "swa.pth"))["variables"]
    assert set(got) == set(want)
    for k, v in want.items():
        if not k.endswith(("running_mean", "running_var",
                           "num_batches_tracked")):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-20,
                                       err_msg=k)
    assert "weights from" in (root / "resumed" / "seed_1" / "train.log"
                              ).read_text()
    # a full resume goes on from the checkpoint's next epoch
    last = load_checkpoint(str(exp / "last.pth"))
    out = Runner().train(str(root / "effb2_trm.yaml"), "device=cpu",
                         f"resume={exp / 'last.pth'}", "trainer.finetune=false",
                         f"trainer.epochs={last['epoch'] + 1}",
                         f"experiment_path={root / 'full'}")
    log = (root / "full" / "seed_1" / "train.log").read_text()
    assert f"(epoch {last['epoch'] + 1})" in log
    assert log.count(" epoch ") == 1
    after = load_checkpoint(f"{out}/last.pth")
    assert after["epoch"] == last["epoch"] + 1
    assert after["lr_count"] > last["lr_count"] > 0


def test_train_asks_for_the_card_by_default(workspace):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root, _ = workspace
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Runner().train(str(root / "effb2_trm.yaml"))


def test_unported_types_raise_naming_the_roadmap():
    """Every model type of the JAX builder is ported: a conditioned
    transformer decoder (EventTransformerDecoder) and the style models
    build.  A top-level audio transformer encoder without an input width
    raises asking for one, and the M2 decoder on another encoder raises
    as the JAX builder does."""
    node = _model_node()
    node["decoder"]["type"] = ("captioning.models.transformer_decoder."
                               "EventTransformerDecoder")
    model, _ = build_model_from_config(node, vocab_size=20)
    assert type(model.decoder).__name__ == "EventTransformerDecoder"
    node = _model_node()
    node["encoder"]["type"] = "AudioTransformerEncoder"
    with pytest.raises(ValueError, match="input_dim"):
        build_model_from_config(node, vocab_size=20)
    node = _model_node()
    node["decoder"]["type"] = "M2TransformerDecoder"
    with pytest.raises(ValueError, match="requires an M2TransformerEncoder"):
        build_model_from_config(node, vocab_size=20)
    node = _model_node()
    node["type"] = "StyleCaptionModel"
    model, _ = build_model_from_config(node, vocab_size=20)
    assert type(model).__name__ == "StyleCaptioner"
    model, pretrained = build_model_from_config(_model_node(), 20)
    assert pretrained == [] and model.decoder.vocab_size == 20
    assert model.decoder.dropout == 0.2
    assert model.encoder._blocks[-1].drop_rate == pytest.approx(
        0.2 * (len(model.encoder._blocks) - 1) / len(model.encoder._blocks))


def test_pretrained_encoder_loads_matching_entries(tmp_path):
    """``encoder.pretrained``: a plain or ``{"model": ...}`` state dict
    (efficientnet_pytorch names) loads into the encoder, the entries of
    matching name and shape only."""
    import torch
    from audiocaption_tpu_torch.cli.run import load_pretrained
    donor, _ = build_model_from_config(_model_node(), 20)
    sd = {k: v + 1 for k, v in donor.encoder.state_dict().items()
          if k.endswith("weight")}
    sd["_fc.weight"] = torch.zeros(3)          # not the encoder's: dropped
    torch.save({"model": sd}, tmp_path / "effb2.pt")
    node = _model_node()
    node["encoder"]["pretrained"] = str(tmp_path / "effb2.pt")
    model, pretrained = build_model_from_config(node, 20)
    assert pretrained == [("encoder", str(tmp_path / "effb2.pt"), "effb2")]
    before = {k: v.clone() for k, v in model.encoder.state_dict().items()}
    assert load_pretrained(model, pretrained[0]) == len(sd) - 1
    for k, v in model.encoder.state_dict().items():
        assert torch.equal(v, sd[k] if k in sd else before[k]), k
