"""``cli/prepare_features.py`` of the PyTorch port against the JAX
package's, on the CPU: one small ``cnn14rnn_trm`` experiment (the Cnn14 at
its width, a 1-layer BiGRU of 32, seeded random weights with jittered BN)
written by the port, and the same weights converted for JAX
(``convert_cnn14_rnn`` / ``convert_transformer_decoder``) in a JAX
experiment; an h5 corpus of 5 clips of 0.4-1 s at 32 kHz (the JAX
dataset reads h5 rows).  Both tools run ``--experiment``:

  * ``fc.h5`` and ``attn.h5`` agree within 1e-4 clip by clip (attn cut to
    its length in both), and so do ``attn.csv`` / ``features.csv``'s
    columns and ids;
  * the port's ``--format npy`` layout (``fc/``, ``attn/``, ``attn.csv``
    and ``fc.csv`` with ``file_name``) reads back through the port's
    dataset equal to its own h5;
  * ``--format h5`` without h5py raises, naming ``--format npy``; the
    encoders that raised before the item-8 slice (``htsat``,
    ``panns_cnn10``, ``panns_wavegram``) build, an unknown name raises;
  * ``--encoder htsat`` against JAX's tool (the classifiers' runs are in
    ``test_torch_panns_classifiers.py``)."""

import csv
import sys

import numpy as np
import pytest
import torch
import yaml

import h5py

from audiocaption_tpu.cli import prepare_features as JPF
from audiocaption_tpu.models.rnn_encoder import convert_cnn14_rnn
from audiocaption_tpu.models.transformer_decoder import (
    convert_transformer_decoder)
from audiocaption_tpu.training.checkpoint import (
    save_checkpoint as j_save_checkpoint)

from audiocaption_tpu_torch.cli import prepare_features as TPF
from audiocaption_tpu_torch.data.dataset import InferenceDataset
from audiocaption_tpu_torch.models.zoo import random_init
from audiocaption_tpu_torch.training.checkpoint import (
    model_variables, save_checkpoint)
from audiocaption_tpu_torch.utils.config import build_model_from_config

from test_torch_cnn14rnn_trm import jitter

torch.set_num_threads(2)
SR, V = 32000, 40
NODE = {"type": "captioning.models.transformer_model.TransformerModel",
        "encoder": {"type": "captioning.models.crnn_trm_encoder."
                            "Cnn14RnnEncoder",
                    "args": {"freeze_cnn": False, "freeze_cnn_bn": False},
                    "cnn": {"type": "Cnn14Encoder",
                            "args": {"sample_rate": SR}},
                    "rnn": {"type": "RnnEncoder",
                            "args": {"bidirectional": True, "hidden_size": 32,
                                     "num_layers": 1, "dropout": 0.5}}},
        "decoder": {"type": "TransformerDecoder",
                    "args": {"emb_dim": 64, "attn_emb_dim": 64, "nlayers": 1,
                             "dropout": 0.2}}}


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The h5 corpus and the two experiments."""
    root = tmp_path_factory.mktemp("prepare_features")
    rng = np.random.RandomState(0)
    ids = [f"clip{i}" for i in range(5)]
    with h5py.File(root / "wav.h5", "w") as f:
        for i, aid in enumerate(ids):
            n = int(SR * (0.4 + 0.15 * i))
            t = np.arange(n) / SR
            f[aid] = (0.3 * np.sin(2 * np.pi * 220 * (i + 1) * t)
                      + 0.05 * rng.randn(n)).astype(np.float32)
    with open(root / "wav.csv", "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(["audio_id", "hdf5_path"])
        w.writerows((aid, str(root / "wav.h5")) for aid in ids)
    vocab = {f"w{i}": i for i in range(V)}
    model, _ = build_model_from_config(NODE, vocab_size=V)
    random_init(model, torch.Generator().manual_seed(0))
    jitter(model, 1)
    exps = {}
    for name in ("port", "jax"):
        exp = root / name
        exp.mkdir()
        (exp / "config.yaml").write_text(yaml.safe_dump({"model": NODE}))
        exps[name] = exp
    save_checkpoint(str(exps["port"] / "swa.pth"), model_variables(model),
                    tokenizer_state=vocab)
    enc = {k: v.numpy().copy() for k, v in model.encoder.state_dict().items()}
    dec = {k: v.numpy().copy() for k, v in model.decoder.state_dict().items()}
    p_enc, s_enc = convert_cnn14_rnn(enc, rnn_num_layers=1,
                                     rnn_bidirectional=True)
    p_dec = convert_transformer_decoder(dec, nlayers=1, tie_weights=False)
    j_save_checkpoint(str(exps["jax"] / "swa.pth"),
                      {"params": {"encoder": p_enc, "decoder": p_dec},
                       "batch_stats": {"encoder": s_enc}},
                      tokenizer_state=vocab)
    out = {}
    common = ["--wav_csv", str(root / "wav.csv"), "--batch_size", "2"]
    JPF.main(common + ["--output_dir", str(root / "out_jax"),
                       "--experiment", str(exps["jax"])])
    TPF.main(common + ["--output_dir", str(root / "out_port"),
                       "--experiment", str(exps["port"]), "--device", "cpu"])
    TPF.main(common + ["--output_dir", str(root / "out_npy"),
                       "--experiment", str(exps["port"]), "--device", "cpu",
                       "--format", "npy"])
    out.update(root=root, ids=ids)
    return out


def read_h5(path):
    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k]) for k in f}


def read_csv(path):
    with open(path) as f:
        return list(csv.reader(f, delimiter="\t"))


def test_h5_features_match_jax(workspace):
    root = workspace["root"]
    for name in ("fc", "attn"):
        want = read_h5(root / "out_jax" / f"{name}.h5")
        got = read_h5(root / "out_port" / f"{name}.h5")
        assert set(got) == set(want) == set(workspace["ids"])
        for aid, w in want.items():
            assert got[aid].shape == w.shape, (name, aid)
            np.testing.assert_allclose(got[aid], w, atol=1e-4, rtol=0,
                                       err_msg=f"{name} {aid}")
    attn = read_h5(root / "out_port" / "attn.h5")
    # clip i is 0.4 + 0.15 i s: its attn rows, cut to its length, grow
    assert [attn[a].shape[0] for a in workspace["ids"]] == sorted(
        attn[a].shape[0] for a in workspace["ids"])
    assert attn["clip0"].shape[-1] == 64


def test_csv_layout_matches_jax(workspace):
    root = workspace["root"]
    for name in ("attn.csv", "features.csv"):
        want = read_csv(root / "out_jax" / name)
        got = read_csv(root / "out_port" / name)
        assert got[0] == want[0], name                     # the columns
        assert [r[0] for r in got] == [r[0] for r in want]
        assert [[c.replace("out_port", "out_jax") for c in r[1:]]
                for r in got[1:]] == [r[1:] for r in want[1:]]


def test_npy_layout_reads_back_as_the_h5(workspace):
    root = workspace["root"] / "out_npy"
    h5 = {name: read_h5(workspace["root"] / "out_port" / f"{name}.h5")
          for name in ("fc", "attn")}
    for name in ("attn", "fc"):
        rows = read_csv(root / f"{name}.csv")
        assert rows[0] == ["audio_id", "file_name"]
        assert all(r[1].endswith(".npy") and f"/{name}/" in r[1]
                   for r in rows[1:])
        ds = InferenceDataset({"wav": str(root / f"{name}.csv")})
        assert ds.audio_ids == workspace["ids"]
        for aid in ds.audio_ids:
            np.testing.assert_array_equal(ds.get_audio(aid), h5[name][aid])


def test_h5_without_h5py_raises(workspace, monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(RuntimeError, match="--format npy"):
        TPF.write_features(str(workspace["root"] / "wav.csv"),
                           str(tmp_path / "x"), lambda w, n: {}, SR,
                           torch.device("cpu"))


@pytest.mark.parametrize("name", ["htsat", "panns_cnn10", "panns_wavegram"])
def test_unported_encoders_raise(name):
    """The encoders that raised before the item-8 slice build now (a 32
    kHz bucket); a name the tool does not know raises."""
    encode, bucket = TPF.named_encoder(name, None, torch.device("cpu"))
    assert callable(encode) and bucket == SR
    with pytest.raises(ValueError, match="unknown encoder"):
        TPF.named_encoder(name + "_x", None, torch.device("cpu"))


def test_htsat_features_match_jax(tmp_path):
    """``--encoder htsat --checkpoint`` (the published HTS-AT, a
    reference-key file) in both tools on 3 clips: the same ids, ``fc.h5``
    and ``attn.h5`` rows (attn cut to each clip's ``feat_len // 32``)
    within 1e-4 relative."""
    from audiocaption_tpu_torch.models.htsat import HtsatEncoder
    from test_torch_item8_wiring import check_prepared, prepare_features_pair
    out = prepare_features_pair(tmp_path, "htsat", HtsatEncoder(), seed=1)
    assert set(out) == {"fc", "attn"}
    check_prepared(out)
