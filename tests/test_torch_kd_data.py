"""The port's KD datasets and iteration batch sampler
(``data/kd_dataset.py``) against the JAX package's, exactly, on a small
h5 corpus (clips of 0.3 s to 2 s at 32 kHz):

  * ``CaptionKdDataset`` / ``InferKdDataset`` items under the same Python
    ``random`` seed: the student wave (resampled to 16 kHz, cropped or
    padded to ``audio_duration``) and the teacher wave (32 kHz, its crop
    aligned to the student's) equal element for element, with and
    without durations, the teacher longer or shorter than the student;
  * ``audio_duration`` on the plain datasets, as the JAX ``_crop_or_pad``;
  * ``IterationBatchSampler``'s batches over three epochs under the same
    ``np.random`` seed, with and without shuffle, and the runner's
    ``build_dataloader`` with ``num_samples`` batching through it."""

import json
import random

import numpy as np
import pytest

from audiocaption_tpu.data import dataset as jds
from audiocaption_tpu.data import kd_dataset as jkd

from audiocaption_tpu_torch.cli.run import build_dataloader
from audiocaption_tpu_torch.data import dataset as tds
from audiocaption_tpu_torch.data import kd_dataset as tkd
from audiocaption_tpu_torch.data.tokenizer import DictTokenizer

LENGTHS = (64000, 9600, 32000, 40000, 20000)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    import h5py
    root = tmp_path_factory.mktemp("kd_data")
    rng = np.random.RandomState(0)
    h5p = root / "wave.h5"
    with h5py.File(h5p, "w") as f:
        for i, n in enumerate(LENGTHS):
            f[f"aud{i}"] = rng.randn(n).astype(np.float32)
    (root / "wav.csv").write_text("audio_id\thdf5_path\n" + "".join(
        f"aud{i}\t{h5p}\n" for i in range(len(LENGTHS))))
    (root / "text.json").write_text(json.dumps({"audios": [
        {"audio_id": f"aud{i}", "captions": [
            {"tokens": f"w{i} w{i + 1}", "cap_id": str(c)}
            for c in range(2)]} for i in range(len(LENGTHS))]}))
    return root


CASES = [
    dict(target_sr=16000, teacher_target_sr=32000, audio_duration=0.5,
         teacher_duration=0.5),
    dict(target_sr=16000, teacher_target_sr=32000, audio_duration=1.0,
         teacher_duration=1.5),
    dict(target_sr=32000, teacher_target_sr=16000, audio_duration=0.75,
         teacher_duration=None),
    dict(target_sr=32000, teacher_target_sr=32000),
]


@pytest.mark.parametrize("kw", CASES, ids=["half_s", "teacher_longer",
                                           "teacher_16k_uncut", "no_crop"])
@pytest.mark.parametrize("kind", ["CaptionKdDataset", "InferKdDataset"])
def test_kd_dataset_items_equal_jax(corpus, kw, kind):
    feats = {"wav": str(corpus / "wav.csv")}
    extra = {"caption": str(corpus / "text.json")} \
        if kind == "CaptionKdDataset" else {}
    ours = getattr(tkd, kind)(feats, orig_sr=32000, **extra, **kw)
    theirs = getattr(jkd, kind)(feats, orig_sr=32000, **extra, **kw)
    assert len(ours) == len(theirs)
    for rep in range(2):
        for i in range(len(ours)):
            random.seed(100 * rep + i)
            a = ours[i]
            random.seed(100 * rep + i)
            b = theirs[i]
            assert set(a) == set(b)
            for k in a:
                if isinstance(a[k], np.ndarray):
                    assert a[k].dtype == b[k].dtype == np.float32, k
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                else:
                    assert a[k] == b[k], k
    if kw.get("audio_duration"):
        assert len(ours[0]["wav"]) == int(kw["audio_duration"]
                                          * kw["target_sr"])


@pytest.mark.parametrize("duration", [None, 0.5, 1.5])
def test_plain_dataset_crop_equals_jax(corpus, duration):
    feats = {"wav": str(corpus / "wav.csv")}
    ours = tds.CaptionDataset(feats, str(corpus / "text.json"),
                              orig_sr=32000, target_sr=16000,
                              audio_duration=duration)
    theirs = jds.CaptionDataset(feats, str(corpus / "text.json"),
                                orig_sr=32000, target_sr=16000,
                                audio_duration=duration)
    for i in range(len(ours)):
        random.seed(i)
        a = ours[i]
        random.seed(i)
        b = theirs[i]
        np.testing.assert_array_equal(a["wav"], b["wav"])
        assert a["cap"] == b["cap"]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("n,bs,num", [(5, 2, 8), (7, 3, 20), (4, 4, 4)])
def test_iteration_batch_sampler_equals_jax(shuffle, n, bs, num):
    np.random.seed(3)
    ours = tkd.IterationBatchSampler(list(range(n)), bs, num, shuffle)
    a = [list(ours) for _ in range(3)]
    np.random.seed(3)
    theirs = jkd.IterationBatchSampler(list(range(n)), bs, num, shuffle)
    b = [list(theirs) for _ in range(3)]
    assert a == b and len(ours) == len(theirs) == -(-num // bs)
    assert all(sum(map(len, ep)) == num for ep in a)


def test_build_dataloader_num_samples(corpus):
    tok = DictTokenizer()
    for i in range(len(LENGTHS) + 1):
        tok.add_word(f"w{i}")
    cfg = {"dataset": {"type": "CaptionKdDataset",
                       "args": {"features": {"wav": str(corpus / "wav.csv")},
                                "caption": str(corpus / "text.json"),
                                "audio_duration": 0.5}},
           "collate_fn": {"type": "TextCollate",
                          "args": {"pad_keys": ["wav"]}},
           "dataloader_args": {"batch_size": 4, "num_samples": 14,
                               "shuffle": True}}
    np.random.seed(5)
    loader = build_dataloader(cfg, tok)
    batches = list(loader)
    assert len(loader) == len(batches) == 4
    assert [len(b["audio_id"]) for b in batches] == [4, 4, 4, 2]
    np.random.seed(5)
    want = list(jkd.IterationBatchSampler(list(range(10)), 4, 14, True))
    np.random.seed(5)
    sampler = build_dataloader(cfg, tok).batch_sampler
    assert list(sampler) == want
    assert batches[0]["wav"].shape == (4, 16000)
    assert batches[0]["cap"].shape[0] == 4
