"""The port's corpus pipeline and caption score against the JAX
package's, on the synthetic corpus of ``audiocaption_tpu.cli.synthetic_corpus``
written to a temporary directory (32 kHz float16 clips of 1 s, five
references a clip, ``vocab.pkl``): ``DictTokenizer`` (encode, decode,
state), ``CaptionDataset`` / ``InferenceDataset`` resampled to 16 kHz,
``TextCollate`` / ``VarLenPadCollate`` (sort key, pad keys, the float16
wire dtype, buckets) give the same arrays; ``ptb_tokenize`` and
``CiderD`` give the same score, exactly."""

import numpy as np
import pytest

from audiocaption_tpu.cli.synthetic_corpus import generate
from audiocaption_tpu.data import collate as JCol
from audiocaption_tpu.data import dataset as JD
from audiocaption_tpu.data import tokenizer as JT
from audiocaption_tpu.metrics.cider import CiderD as JCiderD
from audiocaption_tpu.metrics.tokenize import ptb_tokenize as j_ptb

from audiocaption_tpu_torch.data import collate as TCol
from audiocaption_tpu_torch.data import dataset as TD
from audiocaption_tpu_torch.data import tokenizer as TT
from audiocaption_tpu_torch.metrics.cider import CiderD as TCiderD
from audiocaption_tpu_torch.metrics.tokenize import ptb_tokenize as t_ptb


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    return generate(str(root), n_train=6, n_val=4, n_test=1, sr=32000,
                    duration=1.0, seed=3)


def _assert_batches_equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert list(a[k]) == list(b[k]), k


def test_tokenizer_matches_jax(corpus):
    path = corpus["vocab"]["vocab"]
    j, t = JT.DictTokenizer(path, 20), TT.DictTokenizer(path, 20)
    assert t.loaded and j.loaded and len(t) == len(j) > 10
    assert t.state_dict() == j.state_dict()
    texts = ["a dog barks", "unseen words here and there", "",
             " ".join(["beep"] * 30)]
    _assert_batches_equal(t(texts), j(texts))
    ids = j(texts)["cap"]
    assert t.decode(ids) == j.decode(ids)
    assert (t.bos, t.eos, t.pad) == (j.bos, j.eos, j.pad) == (1, 2, 0)


@pytest.mark.parametrize("split", ["train", "val"])
def test_datasets_match_jax(corpus, split):
    kw = dict(features={"wav": corpus[split]["wav_csv"]}, orig_sr=32000,
              target_sr=16000)
    if split == "train":
        j = JD.CaptionDataset(caption=corpus[split]["text"], **kw)
        t = TD.CaptionDataset(caption=corpus[split]["text"], **kw)
    else:
        j, t = JD.InferenceDataset(**kw), TD.InferenceDataset(**kw)
    assert len(t) == len(j) > 0
    for i in range(len(j)):
        a, b = t[i], j[i]
        assert set(a) == set(b)
        assert a["wav"].shape == (16000,) and a["wav"].dtype == np.float32
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k]
    assert TD.load_caption_json(corpus[split]["text"]) == \
        JD.load_caption_json(corpus[split]["text"])


def test_collates_match_jax(corpus):
    kw = dict(features={"wav": corpus["train"]["wav_csv"]}, orig_sr=32000,
              target_sr=16000, caption=corpus["train"]["text"])
    items = [TD.CaptionDataset(**kw)[i] for i in (0, 7, 3, 12, 5)]
    for i, it in enumerate(items):       # ragged waves
        it["wav"] = it["wav"][:16000 - 1500 * i]
    tok_t = TT.DictTokenizer(corpus["vocab"]["vocab"])
    tok_j = JT.DictTokenizer(corpus["vocab"]["vocab"])
    args = dict(pad_keys=["wav", "cap"], sort_key="cap",
                buckets={"wav": 16000, "cap": 4},
                wire_dtype={"wav": "float16"})
    a = TCol.TextCollate(tok_t, **args)([dict(x) for x in items])
    b = JCol.TextCollate(tok_j, **args)([dict(x) for x in items])
    assert a["wav"].dtype == np.float16 and a["cap"].shape[1] % 4 == 0
    _assert_batches_equal(a, b)
    vargs = dict(pad_keys=["wav"], buckets={"wav": 4000})
    a = TCol.VarLenPadCollate(**vargs)([dict(x) for x in items])
    b = JCol.VarLenPadCollate(**vargs)([dict(x) for x in items])
    _assert_batches_equal(a, b)


def test_ptb_tokenize_and_cider_match_jax_exactly(corpus):
    refs = JD.load_caption_json(corpus["val"]["text"])
    keys = sorted(refs)
    preds = {k: [refs[keys[(i + 1) % len(keys)]][0] if i % 2
                 else refs[k][1] + ", loudly!"]
             for i, k in enumerate(keys)}
    preds[keys[0]] = ["The dog's bark (far away)... and a beep."]
    assert t_ptb(refs) == j_ptb(refs) and t_ptb(preds) == j_ptb(preds)
    t_score, t_each = TCiderD().compute_score(t_ptb(refs), t_ptb(preds))
    j_score, j_each = JCiderD().compute_score(j_ptb(refs), j_ptb(preds))
    assert t_score == j_score and 0 < t_score
    np.testing.assert_array_equal(t_each, j_each)
