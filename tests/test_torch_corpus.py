"""The port's synthetic-corpus generators and wav-file datasets against the
JAX package's, on the CPU.

Generators (``cli/synthetic_corpus.py``): for the same seed and sizes,
``text.json``, ``tag.csv``, ``sed.json`` and ``vocab.pkl`` byte for byte
the JAX generator's, and every wave (a float32 wav file) sample for
sample the float16 value the JAX generator stores in its h5; the
round-robin ceiling equal.  Datasets: the port reading the port's wav
files gives the items the JAX ``CaptionDataset`` /
``TemporalTag*Dataset`` give from the JAX h5 (resampled 32 -> 16 kHz
too); the port reads the JAX h5 as well; ``WavCaptionDataset`` items
equal JAX's on the same wav files.
"""

import filecmp
import random

import numpy as np
import pytest

from audiocaption_tpu.cli import synthetic_corpus as J
from audiocaption_tpu.data import condition_dataset as JC
from audiocaption_tpu.data import dataset as JD

from audiocaption_tpu_torch.cli import synthetic_corpus as P
from audiocaption_tpu_torch.cli.run import build_dataset
from audiocaption_tpu_torch.data import condition_dataset as PC
from audiocaption_tpu_torch.data import dataset as PD

GENERATORS = ("generate", "generate_v2", "generate_temporal")
SIZES = (4, 2, 3)
SPLITS = ("train", "val", "test")


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Each generator's corpus from both packages, seed 1, 10 s clips at
    8 kHz (the v2 corpus also at 32 kHz, for the resampling datasets)."""
    root = tmp_path_factory.mktemp("corpora")
    out = {}
    for name, sr in [(g, 8000) for g in GENERATORS] + [("generate_v2",
                                                         32000)]:
        key = f"{name}_{sr}"
        for pkg, mod in (("jax", J), ("port", P)):
            getattr(mod, name)(str(root / pkg / key), *SIZES, sr=sr,
                               duration=10.0, seed=1)
        out[key] = (root / "jax" / key, root / "port" / key)
    return out


def _text_files(name):
    files = [f"{s}_text.json" for s in SPLITS] + ["vocab.pkl"]
    if name == "generate_temporal":
        files += [f"{s}_{k}" for s in SPLITS for k in ("tag.csv",
                                                       "sed.json")]
    return files


@pytest.mark.parametrize("name", GENERATORS)
def test_text_files_byte_equal(corpora, name):
    j, p = corpora[f"{name}_8000"]
    for f in _text_files(name):
        assert filecmp.cmp(j / f, p / f, shallow=False), f


@pytest.mark.parametrize("name", GENERATORS)
def test_waves_sample_equal(corpora, name):
    import h5py
    from scipy.io import wavfile
    j, p = corpora[f"{name}_8000"]
    n = 0
    for split in SPLITS:
        mapping, files = PD.read_wav_table(str(p / f"{split}_wav.csv"))
        assert files
        with h5py.File(j / f"{split}_waveform.h5", "r") as h5:
            assert sorted(h5) == sorted(mapping)
            for aid, path in mapping.items():
                sr, wav = wavfile.read(path)
                want = h5[aid][...]
                assert sr == 8000 and wav.dtype == np.float32
                assert want.dtype == np.float16
                np.testing.assert_array_equal(wav, want.astype(np.float32))
                n += 1
    assert n == sum(SIZES)


def test_ceiling_equal(corpora):
    j, p = corpora["generate_v2_8000"]
    want = J.ceiling(str(j / "val_text.json"))
    got = P.ceiling(str(p / "val_text.json"))
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12), k


def _items(ds, n):
    random.seed(0)
    return [ds[i] for i in range(n)]


def _same_items(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("target_sr", [32000, 16000])
def test_caption_dataset_items_equal_jax(corpora, target_sr):
    """The port's ``CaptionDataset`` on the port's wav files (and on the
    JAX h5) against the JAX one on the JAX h5, with the flagship's
    32 -> 16 kHz resampling and a 5 s crop at 16 kHz."""
    j, p = corpora["generate_v2_32000"]
    kw = dict(caption=str(j / "train_text.json"), orig_sr=32000,
              target_sr=target_sr,
              audio_duration=5.0 if target_sr == 16000 else None)
    want = _items(JD.CaptionDataset({"wav": str(j / "train_wav.csv")}, **kw),
                  20)
    for src in (p, j):
        ds = build_dataset({"type": "CaptionDataset", "args": dict(
            features={"wav": str(src / "train_wav.csv")}, **kw)})
        assert ds.from_files == (src == p)
        _same_items(_items(ds, 20), want)


def test_wav_caption_dataset_equals_jax(corpora):
    """``WavCaptionDataset`` (and its reference name) on wav files, the
    file's rate resampled to 16 kHz, in both packages."""
    _, p = corpora["generate_v2_32000"]
    kw = dict(features={"wav": str(p / "val_wav.csv")},
              caption=str(p / "val_text.json"), target_sr=16000)
    want = _items(JD.WavCaptionDataset(**kw), 10)
    for t in ("WavCaptionDataset", "CaptionWavReadDataset"):
        _same_items(_items(build_dataset({"type": t, "args": kw}), 10), want)


@pytest.mark.parametrize("kind", ["Caption", "Inference"])
def test_temporal_tag_datasets_equal_jax(corpora, kind):
    j, p = corpora["generate_temporal_8000"]

    def kw(root):
        out = dict(features={"wav": str(root / "train_wav.csv")},
                   temporal_tag=str(root / "train_tag.csv"),
                   orig_sr=8000, target_sr=8000)
        if kind == "Caption":
            out["caption"] = str(root / "train_text.json")
        return out
    name = f"TemporalTag{kind}Dataset"
    n = SIZES[0] * (5 if kind == "Caption" else 1)
    want = _items(getattr(JC, name)(**kw(j)), n)
    assert all(w["temporal_tag"].dtype == np.int32 for w in want)
    _same_items(_items(getattr(PC, name)(**kw(p)), n), want)
    _same_items(_items(build_dataset({"type": f"a.b.{name}",
                                      "args": kw(j)}), n), want)


def test_temporal_tag_survives_collates(corpora):
    from audiocaption_tpu.data.collate import TextCollate as JText
    from audiocaption_tpu.data.tokenizer import DictTokenizer as JTok
    from audiocaption_tpu_torch.data.collate import TextCollate
    from audiocaption_tpu_torch.data.tokenizer import DictTokenizer
    j, p = corpora["generate_temporal_8000"]
    items = _items(PC.TemporalTagCaptionDataset(
        {"wav": str(p / "train_wav.csv")}, str(p / "train_text.json"),
        str(p / "train_tag.csv")), 6)
    args = dict(pad_keys=["wav", "cap"], sort_key="cap",
                wire_dtype={"wav": "float16"})
    got = TextCollate(DictTokenizer(str(p / "vocab.pkl")), **args)(items)
    want = JText(JTok(str(j / "vocab.pkl")), **args)(items)
    for k in ("temporal_tag", "cap", "cap_len", "wav", "wav_len"):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    assert np.asarray(got["temporal_tag"]).dtype == np.int32


@pytest.mark.parametrize("name", GENERATORS)
def test_subset_is_the_smaller_corpus(corpora, tmp_path, name):
    """``subset`` of the port's corpus to its first 2 train clips: every
    text file byte for byte what the JAX generator writes for 2 train
    clips and the same seed, and the wav table the first rows of the
    source's (the waves stay there)."""
    _, p = corpora[f"{name}_8000"]
    small = tmp_path / "jax_small"
    getattr(J, name)(str(small), 2, *SIZES[1:], sr=8000, duration=10.0,
                     seed=1)
    paths = P.subset(str(p), str(tmp_path / "cut"), 2)
    for f in _text_files(name):
        assert filecmp.cmp(small / f, tmp_path / "cut" / f,
                           shallow=False), f
    rows = (p / "train_wav.csv").read_text().splitlines(keepends=True)
    assert (tmp_path / "cut" / "train_wav.csv").read_text() == \
        "".join(rows[:3])
    assert (tmp_path / "cut" / "val_wav.csv").read_text() == \
        (p / "val_wav.csv").read_text()
    assert paths["train"]["text"] == str(tmp_path / "cut" /
                                         "train_text.json")
    assert paths["vocab"]["vocab"] == str(tmp_path / "cut" / "vocab.pkl")
