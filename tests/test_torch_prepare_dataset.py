"""Dataset preparation (``cli/prepare_dataset.py``, ``cli/pack_waveform.py``)
and the demo's model path (``cli/demo.py``) on the CPU, against the JAX
package's tools.

  * ``prepare_clotho`` and ``prepare_audiocaps`` on the same csv and wav
    files: ``text.json`` and ``vocab.pkl`` byte-equal to JAX's, with
    ``--no_pack`` and with packing;
  * ``pack_waveform``: the same h5 datasets (names, float16 values,
    resampled where asked, one part or several, a file that does not read
    left out) and the same ``waveform.csv`` rows (the h5 path aside: each
    tool writes its own directory);
  * the demo: ``normalize_audio`` equal to JAX's for int16, int32, float
    and stereo input with resampling; the REPL over a tiny experiment
    (Cdur5 + a 1-layer transformer, random weights from a seed) prints,
    for each wav path on stdin, the caption the port's beam search gives
    that clip, and an error line for a path that does not read."""

import csv
import io
import json

import h5py
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from audiocaption_tpu.cli import demo as JDEMO
from audiocaption_tpu.cli import pack_waveform as JPW
from audiocaption_tpu.cli import prepare_dataset as JPD

from audiocaption_tpu_torch.cli import demo as DEMO
from audiocaption_tpu_torch.cli import pack_waveform as PW
from audiocaption_tpu_torch.cli import prepare_dataset as PD

SR = 32000


@pytest.fixture()
def raw(tmp_path):
    """Clotho- and AudioCaps-style csvs and their wav files (16 kHz int16,
    32 kHz float32, a stereo one), plus a broken file."""
    rng = np.random.RandomState(0)
    audio = tmp_path / "audio"
    audio.mkdir()
    wavfile.write(audio / "dog bark.wav", 16000,
                  (rng.randn(8000) * 3000).astype(np.int16))
    wavfile.write(audio / "rain.wav", SR,
                  (rng.randn(12000) * 0.1).astype(np.float32))
    wavfile.write(audio / "Yabc.wav", 16000,
                  (rng.randn(6000, 2) * 2000).astype(np.int16))
    wavfile.write(audio / "Ydef.wav", SR,
                  (rng.randn(9000) * 0.2).astype(np.float32))
    (audio / "broken.wav").write_bytes(b"not a wav")
    with open(tmp_path / "clotho.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["file_name"] + [f"caption_{i}" for i in range(1, 6)])
        w.writerow(["dog bark.wav", "A dog barks, loudly!", "Dogs bark.",
                    "A dog's bark.", "", "Barking; twice"])
        w.writerow(["rain.wav", "Rain falls on a roof.", "Rain, rain.",
                    "Heavy rain", "Rain drops", "It rains"])
        w.writerow(["broken.wav", "Nothing here.", "", "", "", ""])
    with open(tmp_path / "audiocaps.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["audiocap_id", "youtube_id", "start_time", "caption"])
        w.writerow(["11", "abc", "0", "A man speaks."])
        w.writerow(["12", "def", "30", "Birds chirp loudly."])
        w.writerow(["13", "abc", "0", "Someone talks, then stops."])
    return tmp_path


def _h5_contents(path):
    with h5py.File(path, "r") as f:
        return {k: (f[k].dtype, np.asarray(f[k])) for k in f}


def _assert_same_output(a, b, h5=True):
    for name in ("text.json", "vocab.pkl"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    if not h5:
        assert not (b / "waveform.h5").exists()
        return
    ja, jb = _h5_contents(a / "waveform.h5"), _h5_contents(b / "waveform.h5")
    assert list(ja) == list(jb) and ja
    for k in ja:
        assert ja[k][0] == jb[k][0] == np.float16
        np.testing.assert_array_equal(ja[k][1], jb[k][1])
    rows = [(a / "waveform.csv").read_text().replace(str(a), "OUT"),
            (b / "waveform.csv").read_text().replace(str(b), "OUT")]
    assert rows[0] == rows[1]


@pytest.mark.parametrize("pack", [False, True], ids=["no_pack", "pack"])
@pytest.mark.parametrize("dataset", ["clotho", "audiocaps"])
def test_prepare_writes_what_the_jax_tool_writes(raw, dataset, pack):
    args = ["--audio_dir", str(raw / "audio"), "--caption_csv",
            str(raw / f"{dataset}.csv"), "--sample_rate", str(SR)]
    if not pack:
        args.append("--no_pack")
    JPD.main([dataset, *args, "--output_dir", str(raw / "jax")])
    PD.main([dataset, *args, "--output_dir", str(raw / "port")])
    _assert_same_output(raw / "jax", raw / "port", h5=pack)
    text = json.loads((raw / "port" / "text.json").read_text())["audios"]
    assert text[0]["captions"][0]["tokens"] == (
        "a dog barks loudly" if dataset == "clotho" else "a man speaks")


@pytest.mark.parametrize("sample_rate,parts", [(None, 1), (16000, 2)])
def test_pack_waveform_matches_jax(raw, sample_rate, parts):
    entries = PW.collect_entries(str(raw / "audio"))
    assert entries == JPW.collect_entries(str(raw / "audio"))
    JPW.pack_waveform(entries, str(raw / "jax"), sample_rate, parts, 2)
    PW.pack_waveform(entries, str(raw / "port"), sample_rate, parts, 2)
    names = sorted(p.name for p in (raw / "port").iterdir())
    assert names == sorted(p.name for p in (raw / "jax").iterdir())
    for name in names:
        if name.endswith(".h5"):
            ja = _h5_contents(raw / "jax" / name)
            jb = _h5_contents(raw / "port" / name)
            assert list(ja) == list(jb)
            for k in ja:
                np.testing.assert_array_equal(ja[k][1], jb[k][1])
    rows = [(raw / d / "waveform.csv").read_text().replace(str(raw / d), "X")
            for d in ("jax", "port")]
    assert rows[0] == rows[1] and "broken" not in rows[1]


def test_pack_waveform_names_h5py_when_it_is_missing(monkeypatch, tmp_path):
    import builtins
    real = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real(name, *args, **kwargs)
    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="h5py"):
        PW.pack_waveform([], str(tmp_path))


@pytest.mark.parametrize("kind", ["int16", "int32", "float32", "stereo"])
def test_normalize_audio_matches_jax(kind):
    rng = np.random.RandomState(1)
    data = {"int16": (rng.randn(4000) * 3000).astype(np.int16),
            "int32": (rng.randn(4000) * 2e8).astype(np.int32),
            "float32": (rng.randn(4000) * 0.1).astype(np.float32),
            "stereo": (rng.randn(4000, 2) * 3000).astype(np.int16)}[kind]
    for target in (16000, SR):
        got = DEMO.normalize_audio(16000, data, target)
        want = JDEMO.normalize_audio(16000, data, target)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.fixture()
def experiment(tmp_path):
    from audiocaption_tpu_torch.data.tokenizer import DictTokenizer
    from audiocaption_tpu_torch.models.zoo import random_init
    from audiocaption_tpu_torch.training.checkpoint import (
        model_variables, save_checkpoint)
    from audiocaption_tpu_torch.utils.config import build_model_from_config
    tok = DictTokenizer()
    for w in "a dog barks rain falls loudly on the roof".split():
        tok.add_word(w)
    node = {"type": "captioning.models.transformer_model.TransformerModel",
            "encoder": {"type": "captioning.models.crnn_trm_encoder."
                                "Cdur5Encoder", "args": {"sample_rate": SR}},
            "decoder": {"type": "captioning.models.transformer_decoder."
                                "TransformerDecoder",
                        "args": {"emb_dim": 32, "nlayers": 1, "nhead": 2,
                                 "dropout": 0.0}}}
    model, _ = build_model_from_config(node, vocab_size=len(tok))
    random_init(model, torch.Generator().manual_seed(4))
    exp = tmp_path / "exp"
    exp.mkdir()
    save_checkpoint(str(exp / "swa.pth"), model_variables(model),
                    tokenizer_state=tok.state_dict())
    (exp / "config.yaml").write_text(yaml.safe_dump({"model": node}))
    return exp


def test_demo_repl_captions_each_path(experiment, raw):
    from audiocaption_tpu_torch.cli.run import read_experiment, \
        experiment_model
    from audiocaption_tpu_torch.data.dataset import read_wav
    from audiocaption_tpu_torch.models.captioner import generate
    caption = DEMO.load_captioner(str(experiment / "swa.pth"), beam_size=3,
                                  device="cpu")
    paths = [raw / "audio" / "dog bark.wav", raw / "audio" / "broken.wav",
             raw / "audio" / "rain.wav"]
    out = io.StringIO()
    DEMO.repl(caption, io.StringIO("\n".join(map(str, paths)) + "\n\n"), out)
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("gradio not installed") and len(lines) == 4
    assert lines[2].startswith("error: ")
    cfg, ckpt = read_experiment(str(experiment), "swa.pth")
    model, tok = experiment_model(cfg, ckpt, torch.device("cpu"))
    for line, path in ((lines[1], paths[0]), (lines[3], paths[2])):
        sr, data = read_wav(str(path))
        wav = DEMO.normalize_audio(sr, data, SR)
        with torch.no_grad():
            seq = generate(model, torch.from_numpy(wav[None]),
                           torch.tensor([len(wav)]), sample_method="beam",
                           beam_size=3)["seq"]
        assert line == tok.decode(seq.numpy())[0]
