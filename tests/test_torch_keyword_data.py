"""The keyword datasets and the keyword recipe of the port against the JAX
package, on the CPU.

  * ``binarize_keyword``: every rule (None, a float threshold, ``"topK"``,
    ``"thr_topK"`` with more and with fewer than K above the threshold)
    equal to JAX's, values and dtype, ties included;
  * ``KeywordProbCaptionDataset`` / ``KeywordProbInferenceDataset``: the
    items equal to JAX's (audio id, caption, wave, keyword) over an h5
    corpus and an h5 keyword map (h5py is on this box), and the port's
    over ``.npy`` keyword rows equal to them too (the card machine has no
    h5py: ROADMAP Queue 3 J);
  * the collate and ``cli/run.py::to_device``: keywords as [B, C]
    float32, whatever the rule's dtype;
  * ``cli/recipes.py``: ``write_keyword_rows`` writes each clip's
    ground-truth events as a multi-hot row, and ``keyword_train`` is the
    ``cnn14rnn_trm`` recipe with a ``KeywordProbTransformerDecoder`` (527
    classes), scheduled sampling off and the keyword datasets, which the
    runner's dataset builder reads.
"""

import json

import h5py
import numpy as np
import pytest
import torch

from audiocaption_tpu.data import condition_dataset as JCD

from audiocaption_tpu_torch.cli import recipes
from audiocaption_tpu_torch.cli.run import build_dataset, to_device
from audiocaption_tpu_torch.data import condition_dataset as CD
from audiocaption_tpu_torch.data.collate import VarLenPadCollate
from audiocaption_tpu_torch.models.transformer_decoder import (
    KeywordProbTransformerDecoder)
from audiocaption_tpu_torch.utils.config import build_model_from_config

C = 12
RULES = [None, 0.5, 0.2, "top3", "top1", "0.5_top2", "0.9_top4",
         "0.05_top5"]


def vectors():
    rng = np.random.RandomState(0)
    v = rng.rand(4, C).astype(np.float32)
    v[1, [2, 5, 7]] = 0.75            # ties at the top
    v[2] = 0.0                        # all zero
    v[3, :6] = 0.5                    # ties at the threshold
    return v


@pytest.mark.parametrize("rule", RULES)
def test_binarize_keyword_matches_jax(rule):
    for v in vectors():
        want = JCD.binarize_keyword(v.copy(), rule)
        got = CD.binarize_keyword(v, rule)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # the rule reads a copy: the caller's probabilities stay as they were
    np.testing.assert_array_equal(v, vectors()[-1])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Six clips in an h5 (``hdf5_path`` rows), two captions each, and
    their keywords both as an h5 map and as ``.npy`` rows."""
    root = tmp_path_factory.mktemp("kw")
    rng = np.random.RandomState(1)
    ids = [f"clip{i}" for i in range(6)]
    h5 = root / "wav.h5"
    kw_h5 = root / "kw.h5"
    kws = {a: rng.rand(C).astype(np.float32) for a in ids}
    with h5py.File(h5, "w") as f, h5py.File(kw_h5, "w") as g:
        for i, a in enumerate(ids):
            f[a] = (rng.randn(8000 + 500 * i) * 0.1).astype(np.float32)
            g[a] = kws[a]
    (root / "wav.csv").write_text("audio_id\thdf5_path\n" + "".join(
        f"{a}\t{h5}\n" for a in ids))
    (root / "kw_h5.tsv").write_text("audio_id\thdf5_path\n" + "".join(
        f"{a}\t{kw_h5}\n" for a in ids))
    rows = []
    for a in ids:
        np.save(root / f"{a}.npy", kws[a])
        rows.append(f"{a}\t{root / (a + '.npy')}\n")
    (root / "kw_npy.tsv").write_text("audio_id\thdf5_path\n" + "".join(rows))
    (root / "text.json").write_text(json.dumps({"audios": [
        {"audio_id": a, "captions": [
            {"caption": f"sound {i} one", "tokens": f"sound {i} one",
             "cap_id": "0"},
            {"caption": f"sound {i} two", "tokens": f"sound {i} two",
             "cap_id": "1"}]} for i, a in enumerate(ids)]}))
    return root


def _same_items(got, want):
    assert len(got) == len(want)
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("rows", ["kw_h5.tsv", "kw_npy.tsv"])
@pytest.mark.parametrize("rule", [None, 0.5, "top2", "0.3_top3"])
def test_keyword_caption_dataset_matches_jax(corpus, rows, rule):
    feats = {"wav": str(corpus / "wav.csv")}
    want = JCD.KeywordProbCaptionDataset(
        feats, str(corpus / "text.json"), str(corpus / "kw_h5.tsv"),
        threshold=rule)
    got = CD.KeywordProbCaptionDataset(
        feats, str(corpus / "text.json"), str(corpus / rows),
        threshold=rule)
    _same_items(got, want)


@pytest.mark.parametrize("rows", ["kw_h5.tsv", "kw_npy.tsv"])
@pytest.mark.parametrize("rule", [None, "0.5_top1"])
def test_keyword_inference_dataset_matches_jax(corpus, rows, rule):
    feats = {"wav": str(corpus / "wav.csv")}
    want = JCD.KeywordProbInferenceDataset(
        feats, str(corpus / "kw_h5.tsv"), threshold=rule)
    got = build_dataset({"type": "KeywordProbInferenceDataset", "args": {
        "features": feats, "keyword_prob": str(corpus / rows),
        "threshold": rule}})
    _same_items(got, want)


@pytest.mark.parametrize("rule", [0.5, "top2", None])
def test_collate_and_to_device_give_float32_keywords(corpus, rule):
    ds = CD.KeywordProbInferenceDataset(
        {"wav": str(corpus / "wav.csv")}, str(corpus / "kw_npy.tsv"),
        threshold=rule)
    batch = VarLenPadCollate(pad_keys=["wav"])([ds[i] for i in range(4)])
    assert batch["keyword"].shape == (4, C)
    assert batch["keyword"].dtype == np.float32
    np.testing.assert_array_equal(
        batch["keyword"], np.stack([ds[i]["keyword"] for i in range(4)]))
    dev = to_device(dict(batch, event=batch["keyword"].astype(np.float64)),
                    torch.device("cpu"))
    for k in ("keyword", "event"):
        assert dev[k].dtype == torch.float32 and dev[k].shape == (4, C)


def test_keyword_recipe(tmp_path):
    """``write_keyword_rows``: a multi-hot row of each clip's events (527
    columns); ``keyword_train``: the recipe's model and data nodes."""
    sed = {"audios": [
        {"audio_id": "c0", "tag": 0, "segments": [[3, 0.5, 4.0]]},
        {"audio_id": "c1", "tag": 2, "segments": [[1, 0.4, 3.0],
                                                  [6, 4.0, 7.0]]}]}
    (tmp_path / "train_sed.json").write_text(json.dumps(sed))
    tsv = recipes.write_keyword_rows(str(tmp_path / "train_sed.json"),
                                     str(tmp_path / "kw"))
    assert tsv == str(tmp_path / "kw" / "train_keyword.tsv")
    rows = CD.load_dict_from_csv(tsv, ("audio_id", "hdf5_path"))
    for a in sed["audios"]:
        kw = np.load(rows[a["audio_id"]])
        assert kw.shape == (527,) and kw.dtype == np.float32
        assert set(np.flatnonzero(kw)) == {c for c, _, _ in a["segments"]}
        assert kw.sum() == len(a["segments"])
    cfg = recipes.keyword_train(str(tmp_path / "data"), str(tmp_path / "kw"))
    assert cfg["scheduled_sampling"]["use"] is False
    for split, kind in (("train", "KeywordProbCaptionDataset"),
                        ("val", "KeywordProbInferenceDataset")):
        node = cfg["data"][split]["dataset"]
        assert node["type"] == kind
        assert node["args"]["keyword_prob"] == str(
            tmp_path / "kw" / f"{split}_keyword.tsv")
        assert node["args"]["features"]["wav"].startswith(
            str(tmp_path / "data"))
    base = recipes.recipe("synthetic/cnn14rnn_trm.yaml", "d")
    assert cfg["model"]["encoder"] == base["model"]["encoder"]
    model, _ = build_model_from_config(cfg["model"], vocab_size=30)
    dec = model.decoder
    assert type(dec) is KeywordProbTransformerDecoder
    assert (dec.emb_dim, dec.nlayers, dec.dropout,
            dec.keyword_classes_num) == (256, 2, 0.2, 527)
    assert dec.keyword_proj.in_features == 527
