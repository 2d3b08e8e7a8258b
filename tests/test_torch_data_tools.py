"""The port's offline data tools (``cli/data_tools.py``), and
``build_vocab``, ``strip_optimizer`` and ``read_wav_csv``, against the JAX
package's on the same inputs, on the CPU.

Every tool runs in both packages on one fixture corpus (the pattern of
``tests/test_data_tools.py``: four clips, five captions, their h5
embeddings and similarity store made from a numpy seed) and writes into
a directory of its own; every file written must be byte-equal.  The
pickled vocabulary is read back by both ``DictTokenizer``s.  The two
tools that need a download, ``back_translate`` and ``extract_syntax``,
must refuse with a message that says so."""

import json
import pickle
from pathlib import Path

import h5py
import numpy as np
import pytest

from audiocaption_tpu.cli import data_tools as JDT
from audiocaption_tpu.data.dataset import read_wav_csv as j_read_wav_csv
from audiocaption_tpu.data.tokenizer import (
    DictTokenizer as JTok, build_vocab as j_build_vocab)
from audiocaption_tpu.training.checkpoint import (
    strip_optimizer as j_strip_optimizer)

from audiocaption_tpu_torch.cli import data_tools as DT
from audiocaption_tpu_torch.data.dataset import read_wav_csv
from audiocaption_tpu_torch.data.tokenizer import DictTokenizer, build_vocab
from audiocaption_tpu_torch.training.checkpoint import strip_optimizer

CAPS = [("aud0", ["a dog barks loudly", "dog barking sound"]),
        ("aud1", ["water flows down a stream", "a stream of water flows"]),
        ("aud2", ["someone speaks quietly"]),
        ("aud3", ["music plays softly", "soft music plays"])]


@pytest.fixture()
def corpus(tmp_path):
    """text.json, wav.csv, caption-embedding h5 (similar captions close),
    audio-embedding h5s, a similarity store, prediction jsons, car label
    jsons, a keyword file and vocabulary, and three wav files."""
    rng = np.random.RandomState(0)
    audios = [{"audio_id": aid,
               "captions": [{"caption": c, "tokens": c, "cap_id": str(i + 1)}
                            for i, c in enumerate(cs)]}
              for aid, cs in CAPS]
    d = tmp_path / "in"
    d.mkdir()
    (d / "text.json").write_text(json.dumps({"audios": audios}))
    (d / "text_b.json").write_text(json.dumps({"audios": [
        {"audio_id": f"b{i}", "captions": [
            {"caption": f"clip {i} sound", "tokens": f"clip {i} sound",
             "cap_id": "1"}]} for i in range(3)]}))
    with open(d / "wav.csv", "w") as f:
        f.write("audio_id\thdf5_path\n")
        for aid, _ in CAPS:
            f.write(f"{aid}\t/data/waveform.h5\n")
    base = rng.randn(len(CAPS), 8)
    with h5py.File(d / "text_emb.h5", "w") as f:
        for i, (aid, cs) in enumerate(CAPS):
            for j in range(len(cs)):
                f[f"{aid}_{j + 1}"] = (base[i] + 0.05 * rng.randn(8)
                                       ).astype(np.float32)
    for name, noise in (("ref_emb.h5", 0.0), ("new_emb.h5", 0.1)):
        with h5py.File(d / name, "w") as f:
            for i, (aid, _) in enumerate(CAPS):
                f[f"{'n' if noise else ''}{aid}"] = (
                    base[i] + noise * rng.randn(8)).astype(np.float32)
    cap_ids = [f"{aid}_{j + 1}" for aid, cs in CAPS for j in range(len(cs))]
    with h5py.File(d / "sim.h5", "w") as f:
        f["sim"] = rng.rand(len(CAPS), len(cap_ids)).astype(np.float32)
        f["audio_id"] = np.asarray([a.encode() for a, _ in CAPS])
        f["text_id"] = np.asarray([c.encode() for c in cap_ids])

    def preds(key, vals):
        return {"audios": [{"audio_id": aid, "captions": [
            {"tokens": f"{key} caption {i}", key: f"{v:.3f}",
             "cap_id": "1"}]} for i, (aid, v) in enumerate(vals)]}
    (d / "gen.json").write_text(json.dumps(preds("at_sim", [
        (a, s) for (a, _), s in zip(CAPS, (0.6, 0.3, 0.45, 0.9))])))
    (d / "evgen.json").write_text(json.dumps(preds("at_sim", [
        (a, s) for (a, _), s in zip(CAPS, (0.5, 0.7, 0.2, 0.1))])))
    (d / "ret.json").write_text(json.dumps(preds("similarity", [
        (a, s) for (a, _), s in list(zip(CAPS, (0.4, 0.8, 0.6, 0.2)))[:3]])))
    (d / "blacklist.txt").write_text("aud3\n")
    (d / "pred.json").write_text(json.dumps({"predictions": [
        {"filename": aid, "tokens": cs[0]} for aid, cs in CAPS]}))
    (d / "pred2.json").write_text(json.dumps({"predictions": [
        {"filename": "aud0", "tokens": ["a dog"]},
        {"filename": "aud9", "tokens": "new clip"}]}))
    (d / "pred_flat.json").write_text(json.dumps({
        "YabcdefghijkZ.wav": "a car passes", "Y0123456789X.wav": "rain"}))
    (d / "dev_label.json").write_text(json.dumps([
        {"filename": "x/car1.wav", "caption": "车辆驶过", "caption_index": 1},
        {"filename": "x/car1.wav", "caption": "汽车开过", "caption_index": 2},
        {"filename": "y/car2.wav", "caption": "喇叭声", "caption_index": 1}]))
    (d / "eval_label.json").write_text(json.dumps({
        "filename": {"0": "z/car3.wav", "1": "z/car3.wav"},
        "caption": {"0": "引擎声", "1": "发动机响"},
        "caption_index": {"0": 1, "1": 2}}))
    (d / "audio_kw.tsv").write_text(
        "audio_id\tkeywords\naud0\tanimal; dog\naud1\t\n")
    (d / "kw_vocab.txt").write_text("dog\nwater\nmusic\nanimal\nstream\n")
    wavs = d / "wavs"
    wavs.mkdir()
    for name in ("b.wav", "a.wav", "c.flac", "notes.txt"):
        (wavs / name).write_bytes(b"\0")
    return d


def _run(fn, outdir: Path, *args, **kwargs):
    outdir.mkdir(parents=True, exist_ok=True)
    fn(*[str(outdir / a[4:]) if isinstance(a, str) and a.startswith("OUT:")
         else a for a in args], **kwargs)


def _assert_same_tree(a: Path, b: Path) -> None:
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert fa == fb and fa, (fa, fb)
    for rel in fa:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


TOOLS = {
    "subset_concat": lambda d: ("subset_concat", (
        str(d / "text.json"), str(d / "text_b.json"), "OUT:suba.json",
        "OUT:all.json"), {"a_percent": 0.5, "seed": 3}),
    "subset_concat_total": lambda d: ("subset_concat", (
        str(d / "text.json"), str(d / "text_b.json"), "OUT:suba.json",
        "OUT:all.json"), {"a_percent": 0.25, "total_number": 3}),
    "text_similarity": lambda d: ("text_similarity", (
        str(d / "text.json"), str(d / "text_emb.h5"), "OUT:aug.json"),
        {"thresholds": (0.0, 0.999)}),
    "text_similarity_nearest_exclude": lambda d: ("text_similarity", (
        str(d / "text.json"), str(d / "text_emb.h5"), "OUT:aug.json"),
        {"thresholds": (-1.0, 0.999), "nearest": True, "exclude_real": True,
         "max_caption_aug": 2}),
    "retrieve_similarity": lambda d: ("retrieve_similarity", (
        str(d / "text.json"), str(d / "sim.h5"), "OUT:ret.json"),
        {"thresholds": (0.3, 1.0), "exclude_real": True,
         "max_caption_aug": 3}),
    "retrieve_similarity_nearest": lambda d: ("retrieve_similarity", (
        str(d / "text.json"), str(d / "sim.h5"), "OUT:ret.json"),
        {"nearest": True, "exclude_real": True}),
    "audio_similarity": lambda d: ("audio_similarity", (
        str(d / "ref_emb.h5"), str(d / "text.json"), str(d / "new_emb.h5"),
        "OUT:audio.json"), {"threshold": 0.9}),
    "filter_new_audio_aug": lambda d: ("filter_new_audio_aug", (
        str(d / "wav.csv"), str(d / "gen.json"), str(d / "evgen.json"),
        str(d / "ret.json"), "OUT:filtered.json"),
        {"blacklist": str(d / "blacklist.txt"), "min_sim": 0.5}),
    "prepare_car": lambda d: ("prepare_car", ("OUT:car",),
                              {"dev_label": str(d / "dev_label.json"),
                               "eval_label": str(d / "eval_label.json")}),
    "extract_specificity_sum": lambda d: ("extract_specificity", (
        str(d / "text.json"), "OUT:word.tsv", "OUT:cap.tsv"), {}),
    "extract_specificity_mean": lambda d: ("extract_specificity", (
        str(d / "text.json"), "OUT:word.tsv", "OUT:cap.tsv"),
        {"sentence_reduce": "mean"}),
    "extract_keyword": lambda d: ("extract_keyword", (
        str(d / "text.json"), "OUT:kw.tsv"), {}),
    "extract_keyword_tags_vocab": lambda d: ("extract_keyword", (
        str(d / "text.json"), "OUT:kw.tsv"),
        {"audio_keyword_file": str(d / "audio_kw.tsv"),
         "keyword_vocab": str(d / "kw_vocab.txt")}),
    "predict_nrst_ngbr": lambda d: ("predict_nrst_ngbr", (
        str(d / "ref_emb.h5"), str(d / "text.json"), str(d / "new_emb.h5"),
        "OUT:nn.json"), {}),
    "model_eval_diff": lambda d: ("model_eval_diff", (
        str(d / "pred.json"), str(d / "text.json"), "OUT:diff.txt"), {}),
    "pred_to_anno": lambda d: ("pred_to_anno", (
        str(d / "pred.json"), "OUT:anno.json"),
        {"wav_csv": str(d / "wav.csv")}),
    "pred_to_anno_flat": lambda d: ("pred_to_anno", (
        str(d / "pred_flat.json"), "OUT:anno.json"), {}),
    "concat_anno_json": lambda d: ("concat_anno_json", (
        [str(d / "text.json"), str(d / "text_b.json"), str(d / "text.json")],
        "OUT:merged.json"), {"indent": 2}),
    "concat_pred_json": lambda d: ("concat_pred_json", (
        [str(d / "pred.json"), str(d / "pred2.json")], "OUT:merged.json"),
        {}),
    "prepare_wav_csv": lambda d: ("prepare_wav_csv", (
        str(d / "wavs"), "OUT:wav.csv"), {"prefix": "p_"}),
    "wavcsv_from_textjson": lambda d: ("wavcsv_from_textjson", (
        str(d / "text.json"), str(d / "wav.csv"), "OUT:sub.csv"), {}),
}


@pytest.mark.parametrize("case", sorted(TOOLS))
def test_tool_writes_what_the_jax_tool_writes(case, corpus, tmp_path):
    name, args, kwargs = TOOLS[case](corpus)
    _run(getattr(JDT, name), tmp_path / "jax", *args, **kwargs)
    _run(getattr(DT, name), tmp_path / "port", *args, **kwargs)
    _assert_same_tree(tmp_path / "jax", tmp_path / "port")


def test_subset_concat_reuses_an_existing_subset(corpus, tmp_path):
    args = (str(corpus / "text.json"), str(corpus / "text_b.json"))
    for fn, out in ((JDT.subset_concat, tmp_path / "jax"),
                    (DT.subset_concat, tmp_path / "port")):
        out.mkdir()
        fn(*args, str(out / "suba.json"), str(out / "all.json"),
           a_percent=0.5, seed=1)
        fn(*args, str(out / "suba.json"), str(out / "all2.json"),
           a_percent=0.5, seed=7)
    _assert_same_tree(tmp_path / "jax", tmp_path / "port")


def test_cli_runs_the_tools_with_the_jax_flags(corpus, tmp_path):
    """The port's argparse ``main`` with the JAX tool's sub-command and
    flags."""
    for mod, out in ((JDT, tmp_path / "jax"), (DT, tmp_path / "port")):
        out.mkdir()
        mod.main(["extract_specificity", str(corpus / "text.json"),
                  str(out / "w.tsv"), str(out / "c.tsv"),
                  "--sentence_reduce", "mean"])
        mod.main(["text_similarity", str(corpus / "text.json"),
                  str(corpus / "text_emb.h5"), str(out / "aug.json"),
                  "--thresholds", "0.0", "0.999", "--max_caption_aug", "1"])
    _assert_same_tree(tmp_path / "jax", tmp_path / "port")


@pytest.mark.parametrize("argv", [
    ["back_translate", "in.json", "out.json"],
    ["extract_syntax", "in.json", "http://localhost:9000", "pos", "o.json"]],
    ids=["back_translate", "extract_syntax"])
def test_tools_that_need_a_download_refuse(argv):
    with pytest.raises(SystemExit) as e:
        DT.main(argv)
    assert "MarianMT" in str(e.value) or "CoreNLP" in str(e.value)


@pytest.mark.parametrize("threshold", [1, 2])
def test_build_vocab_writes_the_jax_pickle(corpus, tmp_path, threshold):
    j_build_vocab(str(corpus / "text.json"), threshold,
                  output_path=str(tmp_path / "j.pkl"))
    tok = build_vocab(str(corpus / "text.json"), threshold,
                      output_path=str(tmp_path / "p.pkl"))
    assert (tmp_path / "j.pkl").read_bytes() == (tmp_path / "p.pkl").read_bytes()
    for cls in (JTok, DictTokenizer):
        back = cls(str(tmp_path / "p.pkl"))
        assert back.loaded and back.word2idx == tok.word2idx
    assert tok.word2idx["<unk>"] == 3 and "dog" in tok.word2idx
    assert ("quietly" in tok.word2idx) == (threshold == 1)


def test_strip_optimizer_writes_the_jax_pickle(tmp_path):
    payload = {"variables": {"params": {"w": np.arange(6.0).reshape(2, 3)}},
               "epoch": 3, "optimizer": {"mu": np.ones(4)},
               "tokenizer": {"<pad>": 0}, "lr_count": 12}
    for name in ("a.pth", "b.pth"):
        with open(tmp_path / name, "wb") as f:
            pickle.dump(payload, f, protocol=4)
    j_strip_optimizer(str(tmp_path / "a.pth"), str(tmp_path / "ja.pth"))
    strip_optimizer(str(tmp_path / "a.pth"), str(tmp_path / "pa.pth"))
    assert (tmp_path / "ja.pth").read_bytes() == \
        (tmp_path / "pa.pth").read_bytes()
    # in place by default
    j_strip_optimizer(str(tmp_path / "b.pth"))
    got = strip_optimizer(str(tmp_path / "a.pth"))
    assert got == str(tmp_path / "a.pth")
    assert (tmp_path / "a.pth").read_bytes() == \
        (tmp_path / "b.pth").read_bytes()
    with open(tmp_path / "a.pth", "rb") as f:
        assert "optimizer" not in pickle.load(f)


def test_read_wav_csv_reads_both_row_kinds(corpus, tmp_path):
    files = tmp_path / "files.csv"
    files.write_text("audio_id\tfile_name\nx\t/a/x.wav\ny\t/a/y.wav\n")
    for path in (corpus / "wav.csv", files):
        assert read_wav_csv(str(path)) == j_read_wav_csv(str(path))
    assert read_wav_csv(str(files)) == {"x": "/a/x.wav", "y": "/a/y.wav"}
