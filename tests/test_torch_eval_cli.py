"""The port's evaluation and inference entry points on the CPU against the
JAX package's, through their command lines, in the 4-clip 1 s workspace
of ``test_torch_train_cli`` (16 kHz; one reference a clip):

  * ``predict`` / ``evaluate`` (``--experiment_path --eval_config``,
    ``device=cpu``) on a JAX-written Cdur5 + 1-layer transformer
    experiment (emb 64, BN calibrated, decoder jittered, as
    ``test_torch_kd_cli``'s teacher), beam 3 and greedy, in batches of 3
    (a ragged last batch): the predictions json byte for byte equal to the
    JAX runner's, the scores txt equal.  A port-written checkpoint of the
    same weights gives the same files;
  * ``ensemble_evaluate`` and ``dcase_predict`` over two JAX-written
    experiments (one member a plain path, one ``{path, resume}``): the
    predictions json (``tokens``), the scores txt and the dcase csv equal
    to the JAX runner's;
  * ``export_hf`` of a JAX-written EffB2-Transformer experiment (seeded
    random weights, BN and decoder jittered, no training): the same keys
    and equal tensors as the JAX runner's export, and the same beam-3
    tokens through both packages' ``Effb2TrmCaptioningModel``;
  * ``cli/inference.py`` on wav files at 16, 32 and 44.1 kHz (16-bit PCM,
    float, 8-bit unsigned), one of them under 0.32 s: a json identical to
    the JAX script's, the short clip skipped;
  * ``debug``: the loss of one forward and backward within 1e-5 of the
    JAX runner's, on the same seeded weights (the JAX runner's flax init
    replaced by the port's draw) with dropout off in both;
  * the CLI forms: ``train --config`` beside the positional config, and
    the unported subcommands raising with their ROADMAP item.

These tests run on the CPU (not on the card); the test on the card
(``test_torch_cuda.py::test_runner_decode_on_card_matches_engine``, run
on an H100) holds the same decode through the kernels."""

import json
import shutil
from pathlib import Path

import flax.linen as fnn
import numpy as np
import pytest
import torch
import yaml

from audiocaption_tpu.cli import inference as j_inference
from audiocaption_tpu.cli.run import Runner as JRunner
from audiocaption_tpu.training.checkpoint import (
    save_checkpoint as j_save_checkpoint)

from audiocaption_tpu_torch.cli import inference as t_inference
from audiocaption_tpu_torch.cli.run import main
from audiocaption_tpu_torch.models.zoo import effb2_trm, random_init
from audiocaption_tpu_torch.training.checkpoint import (
    model_variables, save_checkpoint)
from audiocaption_tpu_torch.utils.config import build_model_from_config

from test_torch_cdur5 import calibrate_and_jitter, jax_variables, no_dropout
from test_torch_kd_cli import _cdur5_node
from test_torch_train_cli import SR, workspace  # noqa: F401
from test_torch_train_forward import jax_variables as effb2_jax_variables

torch.set_num_threads(2)
DEBUG_ATOL = 1e-5


def _test_cfg(root) -> dict:
    wav = {"wav": str(root / "wav.csv")}
    return {
        "data": {"test": {
            "dataset": {"type": "captioning.datasets.caption_dataset."
                                "InferenceDataset",
                        "args": {"features": wav,
                                 "transforms": {"wav": None}}},
            "collate_fn": {"type": "captioning.datasets.collate_func."
                                   "VarLenPadCollate",
                           "args": {"pad_keys": ["wav"]}},
            "caption": str(root / "text.json"),
            "dataloader_args": {"shuffle": False, "batch_size": 3,
                                "num_workers": 0}}},
        "inference_args": {"sample_method": "beam", "beam_size": 3,
                           "max_length": 12},
        "resume": "swa.pth",
        "caption_output": "predictions/swa_beam3.json",
        "score_output": "results/swa_beam3.txt"}


def _cdur5_experiment(root, tok, name: str, seed: int):
    """A JAX-written Cdur5 experiment (``swa.pth`` and ``best.pth``) and
    the port model of the same weights."""
    exp = root / name
    exp.mkdir()
    node = _cdur5_node(64)
    drawn, _ = build_model_from_config(node, vocab_size=len(tok))
    random_init(drawn, torch.Generator().manual_seed(seed))
    calibrate_and_jitter(drawn, seed + 1)
    for ckpt in ("swa.pth", "best.pth"):
        j_save_checkpoint(str(exp / ckpt), jax_variables(drawn), epoch=1,
                          tokenizer_state=tok.state_dict())
    (exp / "config.yaml").write_text(yaml.safe_dump({"model": node}))
    return exp, drawn


@pytest.fixture(scope="module")
def ws(workspace):  # noqa: F811
    root, tok = workspace
    (root / "test.yaml").write_text(yaml.safe_dump(_test_cfg(root)))
    exp_a, drawn = _cdur5_experiment(root, tok, "exp_a", 3)
    exp_b, _ = _cdur5_experiment(root, tok, "exp_b", 5)
    # the same weights as exp_a, written by the port
    port_exp = root / "port_exp"
    port_exp.mkdir()
    save_checkpoint(str(port_exp / "swa.pth"), model_variables(drawn),
                    epoch=1, tokenizer_state=tok.state_dict())
    shutil.copy(exp_a / "config.yaml", port_exp / "config.yaml")
    return root, tok, exp_a, exp_b, port_exp


METHODS = {"beam3": [], "greedy": ["inference_args.sample_method=greedy"]}


@pytest.fixture(scope="module")
def evaluated(ws):
    """Both runners' evaluate, for each method; the port on the
    JAX-written and on the port-written experiment."""
    root, _, exp_a, _, port_exp = ws
    cfg = str(root / "test.yaml")
    out = {}
    for m, extra in METHODS.items():
        names = {w: [f"caption_output=predictions/{w}_{m}.json",
                     f"score_output=results/{w}_{m}.txt"]
                 for w in ("jax", "port")}
        JRunner().evaluate(str(exp_a), cfg, *(names["jax"] + extra))
        for exp in (exp_a, port_exp):
            main(["evaluate", "--experiment_path", str(exp),
                  "--eval_config", cfg, "device=cpu"] + names["port"]
                 + extra)
        out[m] = names
    return out


@pytest.mark.parametrize("method", list(METHODS))
def test_predictions_json_equals_jax(ws, evaluated, method):
    _, _, exp_a, _, port_exp = ws
    want = (exp_a / "predictions" / f"jax_{method}.json").read_text()
    for exp in (exp_a, port_exp):
        assert (exp / "predictions" / f"port_{method}.json").read_text() \
            == want
    preds = json.loads(want)["predictions"]
    assert [p["filename"] for p in preds] == [f"aud{i}" for i in range(4)]
    assert len({p["caption"] for p in preds}) > 1


@pytest.mark.parametrize("method", list(METHODS))
def test_scores_txt_equals_jax(ws, evaluated, method):
    _, _, exp_a, _, port_exp = ws
    want = (exp_a / "results" / f"jax_{method}.txt").read_text()
    assert "meteor_py" in want and "spider_py" in want
    for exp in (exp_a, port_exp):
        assert (exp / "results" / f"port_{method}.txt").read_text() == want


@pytest.fixture(scope="module")
def ensembled(ws):
    root, _, exp_a, exp_b, _ = ws
    cfg = {"inherit_from": "./test.yaml",
           "experiment_path": [str(exp_a), {"path": str(exp_b),
                                            "resume": "best.pth"}],
           "resume": "swa.pth", "output_path": str(root / "ens_jax"),
           "caption_output": "predictions_beam3.json",
           "score_output": "scores_beam3.txt"}
    path = root / "ensemble.yaml"
    path.write_text(yaml.safe_dump(cfg))
    JRunner().ensemble_evaluate(str(path))
    JRunner().dcase_predict(str(path))
    port = [f"output_path={root / 'ens_port'}", "device=cpu"]
    main(["ensemble_evaluate", "--eval_config", str(path)] + port)
    main(["dcase_predict", "--eval_config", str(path)] + port)
    return root / "ens_jax", root / "ens_port"


@pytest.mark.parametrize("name", ["predictions_beam3.json",
                                  "scores_beam3.txt",
                                  "dcase_predictions.csv"])
def test_ensemble_outputs_equal_jax(ensembled, name):
    want, got = (d / name for d in ensembled)
    assert got.read_text() == want.read_text()


def test_ensemble_outputs_form(ensembled):
    _, got = ensembled
    preds = json.loads((got / "predictions_beam3.json").read_text())
    assert set(preds["predictions"][0]) == {"filename", "tokens"}
    lines = (got / "dcase_predictions.csv").read_text().splitlines()
    assert lines[0] == "file_name,caption_predicted" and len(lines) == 5


def _effb2_port_model(vocab: int, seed: int = 0):
    """The narrow flagship (emb 64), seeded, its BN statistics and affine
    parameters and decoder matrices jittered (``test_torch_train_forward.
    port_model``'s draw at this vocabulary)."""
    m = effb2_trm(vocab_size=vocab, decoder_emb_dim=64, decoder_dropout=0.0)
    random_init(m, torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed + 1)

    def rand(shape, scale, offset=0.0):
        return torch.from_numpy(
            (offset + rng.randn(*shape) * scale).astype(np.float32))
    with torch.no_grad():
        for mod in m.encoder.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                n = (mod.num_features,)
                mod.running_mean.copy_(rand(n, 0.1))
                mod.running_var.copy_(torch.from_numpy(
                    (0.5 + rng.rand(*n)).astype(np.float32)))
                mod.weight.copy_(rand(n, 0.2, 1.0))
                mod.bias.copy_(rand(n, 0.2))
        for p in m.decoder.parameters():
            if p.dim() == 2:
                p.add_(rand(p.shape, 0.3))
    return m.eval()


@pytest.fixture(scope="module")
def exported(ws):
    root, tok, *_ = ws
    exp = root / "effb2_exp"
    exp.mkdir()
    with open(root / "effb2_trm.yaml") as f:
        node = yaml.safe_load(f)["model"]
    (exp / "config.yaml").write_text(yaml.safe_dump({"model": node}))
    jvars = effb2_jax_variables(_effb2_port_model(len(tok)))
    j_save_checkpoint(str(exp / "swa.pth"), jvars, epoch=0,
                      tokenizer_state=tok.state_dict())
    JRunner().export_hf(str(exp), str(root / "hf_jax.bin"))
    main(["export_hf", "--experiment_path", str(exp), "--output",
          str(root / "hf_port.bin")])
    return (torch.load(root / "hf_jax.bin", weights_only=False),
            torch.load(root / "hf_port.bin", weights_only=False),
            root, len(tok), jvars)


def test_export_hf_equals_jax(exported):
    want, got, *_ = exported
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_export_hf_decodes_as_jax(exported):
    from audiocaption_tpu.hf_api import (
        Effb2TrmCaptioningModel as JAPI, Effb2TrmConfig as JConfig)
    from audiocaption_tpu_torch.hf_api import (
        Effb2TrmCaptioningModel as TAPI, Effb2TrmConfig as TConfig)
    _, _, root, vocab, jvars = exported
    audio = np.random.RandomState(4).randn(2, SR).astype(np.float32) * 0.3
    lens = [SR, 11000]
    port = TAPI(TConfig(vocab_size=vocab, decoder_emb_dim=64), device="cpu")
    port.load_torch_checkpoint(str(root / "hf_port.bin"))
    jax_api = JAPI(JConfig(vocab_size=vocab, decoder_emb_dim=64),
                   variables=jvars)
    jax_api.load_torch_checkpoint(str(root / "hf_port.bin"))
    got = port(audio, lens, sample_method="beam", beam_size=3, max_length=8)
    want = jax_api(audio, lens, sample_method="beam", beam_size=3,
                   max_length=8)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_export_hf_rejects_other_families(ws):
    _, _, exp_a, *_ = ws
    with pytest.raises(ValueError, match="EffB2"):
        main(["export_hf", "--experiment_path", str(exp_a), "--output",
              str(exp_a / "x.bin")])


def _write_wavs(root):
    """Six clips: 16 kHz int16, 32 kHz float32, 44.1 kHz uint8 and int16
    stereo, a 0.2 s clip (skipped) and a 1.5 s clip (two batches of 4)."""
    from scipy.io import wavfile
    rng = np.random.RandomState(7)
    d = root / "wavs"
    d.mkdir()

    def wave(sr, seconds, level):
        t = np.arange(int(sr * seconds)) / sr
        return (0.4 * np.sin(2 * np.pi * 300 * level * t)
                + rng.randn(len(t)) * 0.1 * level)
    wavfile.write(d / "a16.wav", 16000,
                  (wave(16000, 1.0, 1) * 20000).astype(np.int16))
    wavfile.write(d / "b32.wav", 32000, wave(32000, 0.9, 2).astype(
        np.float32) * 0.5)
    wavfile.write(d / "c44.wav", 44100, (wave(44100, 0.8, 3) * 100
                                         + 128).clip(0, 255).astype(np.uint8))
    stereo = np.stack([wave(44100, 1.2, 4), wave(44100, 1.2, 5)], 1)
    wavfile.write(d / "d44.wav", 44100, (stereo * 20000).astype(np.int16))
    wavfile.write(d / "e_short.wav", 16000,
                  (wave(16000, 0.2, 1) * 20000).astype(np.int16))
    wavfile.write(d / "f16.wav", 16000,
                  (wave(16000, 1.5, 6) * 20000).astype(np.int16))
    return d


def test_inference_json_equals_jax(ws, capsys):
    root, _, exp_a, *_ = ws
    d = _write_wavs(root)
    args = ["--input", str(d), "--checkpoint", str(exp_a / "swa.pth"),
            "--batch_size", "4", "--max_length", "12"]
    j_inference.main(args + ["--output", str(root / "inf_jax.json")])
    t_inference.main(args + ["--output", str(root / "inf_port.json"),
                             "--device", "cpu"])
    assert "skipping e_short.wav" in capsys.readouterr().err
    want = (root / "inf_jax.json").read_text()
    assert (root / "inf_port.json").read_text() == want
    assert sorted(json.loads(want)) == ["a16.wav", "b32.wav", "c44.wav",
                                        "d44.wav", "f16.wav"]


def test_collect_inputs_and_read_wav_equal_jax(ws):
    root, *_ = ws
    d = root / "wavs"
    csv_path = root / "inputs.csv"
    csv_path.write_text("audio_id\tfile_name\nx\t" + str(d / "a16.wav")
                        + "\ny\t" + str(d / "c44.wav") + "\n")
    for src in (str(d), str(csv_path), str(d / "b32.wav")):
        assert t_inference.collect_inputs(src) == \
            j_inference.collect_inputs(src)
    for f in sorted(d.glob("*.wav")):
        sr_t, wav_t = t_inference.read_wav(str(f))
        sr_j, wav_j = j_inference.read_wav(str(f))
        assert sr_t == sr_j and wav_t.dtype == wav_j.dtype
        np.testing.assert_array_equal(wav_t, wav_j)


def test_debug_loss_equals_jax(ws, monkeypatch):
    """The same seeded weights in both runners: the port's draw, carried
    into the JAX runner in place of its flax init; dropout off in both."""
    root, tok, *_ = ws
    with open(root / "effb2_trm.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["model"] = _cdur5_node(64)
    cfg["model"]["decoder"]["args"]["dropout"] = 0.0
    path = root / "debug.yaml"
    path.write_text(yaml.safe_dump(cfg))
    drawn, _ = build_model_from_config(cfg["model"], vocab_size=len(tok))
    random_init(drawn, torch.Generator().manual_seed(cfg["seed"]))
    monkeypatch.setattr(JRunner, "_init_variables",
                        lambda self, model, c, seed: jax_variables(drawn))
    with fnn.intercept_methods(no_dropout):
        want = JRunner().debug(str(path))
    monkeypatch.setattr(torch.nn.functional, "dropout",
                        lambda x, p=0.5, training=True, inplace=False: x)
    got = main(["debug", "--config", str(path), "device=cpu"])
    assert np.isfinite(want)
    assert abs(got - want) <= DEBUG_ATOL, (got, want)


def test_cli_config_forms_and_unported(ws, monkeypatch):
    from audiocaption_tpu_torch.cli import run
    seen = []
    monkeypatch.setattr(run.Runner, "debug",
                        lambda self, config, *o: seen.append((config, o)))
    main(["debug", "--config", "a.yaml", "x=1", "y=2"])
    main(["debug", "a.yaml", "x=1"])
    assert seen == [("a.yaml", ("x=1", "y=2")), ("a.yaml", ("x=1",))]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(["train_aug", "--config", "a.yaml"])
    # the temporal subcommands are ported: they reach the runner
    for name in ("train_sed", "predict_temporal", "evaluate_temporal"):
        monkeypatch.setattr(run.Runner, name,
                            lambda self, *a, name=name: seen.append((name, a)))
    main(["train_sed", "--config", "a.yaml", "x=1"])
    for name in ("predict_temporal", "evaluate_temporal"):
        main([name, "--experiment_path", "e", "--sed_experiment_path",
              "s", "--eval_config", "c.yaml", "device=cpu"])
    assert seen[2:] == [
        ("train_sed", ("a.yaml", "x=1")),
        ("predict_temporal", ("e", "s", "c.yaml", "device=cpu")),
        ("evaluate_temporal", ("e", "s", "c.yaml", "device=cpu"))]


@pytest.mark.parametrize("name,config", [
    ("effb2_trm", "configs/audiocaps/effb2_trm.yaml"),
    ("cnn14rnn_trm", "configs/synthetic_v2/cnn14rnn_trm.yaml"),
    ("kd_student", "configs/synthetic_v2/kd_token.yaml")])
def test_chip_smoke_eval_nodes_are_the_recipes(name, config):
    """``chip_smoke.py`` phase 22 builds each family from a copy of its
    recipe's model node (the card machine has no PyYAML): the node equals
    the config's, and it builds the zoo model's tensors."""
    import chip_smoke
    from audiocaption_tpu_torch.models import zoo
    from audiocaption_tpu_torch.utils.config import load_config
    root = Path(__file__).resolve().parent.parent
    fam = chip_smoke.EVAL_FAMILIES[name]
    assert fam["node"] == load_config(str(root / config))["model"]
    built, _ = build_model_from_config(fam["node"], vocab_size=fam["vocab"])
    ctor = {"effb2_trm": zoo.effb2_trm, "cnn14rnn_trm": zoo.cnn14rnn_trm,
            "kd_student": zoo.kd_student_cdur5}[name]
    want = ctor(vocab_size=fam["vocab"])
    got_sd, want_sd = model_variables(built), model_variables(want)
    assert {k: v.shape for k, v in got_sd.items()} == \
        {k: v.shape for k, v in want_sd.items()}
    assert built.mel == want.mel


class _FakeTok:
    def __call__(self, texts, padding=True, return_tensors="pt"):
        return {"texts": list(texts)}


class _FakeClap:
    """A deterministic text tower: [word count, character sum mod 97]."""

    def eval(self):
        return self

    def get_text_features(self, texts):
        return torch.tensor([[float(len(t.split())),
                              float(sum(map(ord, t)) % 97)] for t in texts])


@pytest.fixture(scope="module")
def tool_inputs(tmp_path_factory):
    """A predictions json, a caption json (3 references a clip), a train
    caption json, a word-specificity TSV and two seeds' score files."""
    d = tmp_path_factory.mktemp("eval_tools")
    rng = np.random.RandomState(11)
    words = "a the dog barks water flows loudly bird sings engine runs".split()

    def cap():
        return " ".join(rng.choice(words, rng.randint(2, 8)))
    ids = [f"k{i}" for i in range(6)]
    (d / "preds.json").write_text(json.dumps({"predictions": [
        {"filename": k, "caption": cap()} for k in ids]}))
    for name, n in (("text.json", 3), ("train.json", 2)):
        (d / name).write_text(json.dumps({"audios": [
            {"audio_id": k, "captions": [{"caption": cap(), "cap_id": str(j)}
                                         for j in range(n)]}
            for k in ids]}))
    (d / "word.tsv").write_text("word\tspecificity\n" + "".join(
        f"{w}\t{0.5 + i / 3:.4f}\n" for i, w in enumerate(words)))
    for seed in (1, 2):
        res = d / "exp" / f"seed_{seed}" / "results"
        res.mkdir(parents=True)
        res.joinpath("scores.txt").write_text(
            f"cider: {0.3 * seed:.4f}\nbleu_4: {0.1 + seed / 50:.4f}\n")
    return d


TOOL_ARGS = {
    "round_robin": ["--caption", "text.json"],
    "report": ["--experiment_path", "exp"],
    "diversity": ["--predictions", "preds.json", "--train_caption",
                  "train.json"],
    "diversity_instance": ["--predictions", "preds.json", "--instance"],
    "score": ["--predictions", "preds.json", "--caption", "text.json"],
    "specificity": ["--predictions", "preds.json", "--word_specificity",
                    "word.tsv"],
    "clap_skipped": ["--predictions", "preds.json", "--caption",
                     "text.json"],
    "clap": ["--predictions", "preds.json", "--caption", "text.json"]}


@pytest.mark.parametrize("tool", list(TOOL_ARGS))
def test_eval_tools_print_as_jax(tool_inputs, tool, capsys, monkeypatch):
    """Every ``eval_tools`` subcommand prints what the JAX one prints; the
    CLAP weights never load (a fake text tower, or none)."""
    import audiocaption_tpu.metrics.extra as j_extra
    from audiocaption_tpu.cli.eval_tools import main as j_main
    import audiocaption_tpu_torch.metrics.extra as t_extra
    from audiocaption_tpu_torch.cli.eval_tools import main as t_main

    def no_weights(name):
        raise OSError("no weights")
    load = no_weights if tool == "clap_skipped" else (
        lambda name: (_FakeClap(), _FakeTok()))
    monkeypatch.setattr(j_extra, "_load_clap", load)
    monkeypatch.setattr(t_extra, "_load_clap", load)
    args = [tool.split("_")[0] if tool.startswith(("clap", "diversity"))
            else tool] + [str(tool_inputs / a) if a.endswith(
                (".json", ".tsv")) or a == "exp" else a
                for a in TOOL_ARGS[tool]]
    j_main(args)
    want = capsys.readouterr().out
    t_main(args)
    got = capsys.readouterr().out
    assert got == want and want.strip()
