"""The port's caption scorers against the JAX package's, on the same
inputs: seeded random word lists from numpy (words with shared stems, so
that the stem stages match, and repeated words, so that METEOR's chunk
search runs), the cases of ``tests/test_metric_goldens.py``, and the
synthetic corpora's own captions.  BLEU, ROUGE-L, CIDEr-D, ``meteor_py``,
``spice_py``, ``evaluate_captions`` (its keys, ``skipped_scorers`` and
``per_audio``), diversity, specificity, CLAP (gated) and the tools are
equal to 1e-12 (the same Python arithmetic in the same order; the bound
only allows for nothing).  The port's Porter stemmer gives nltk's stem
for every word of the synthetic corpora's vocabularies, the metric tests'
captions and the words of the repository's sources.  The scorers are
host Python: these tests run on the CPU (not on the card)."""

import re
from pathlib import Path

import numpy as np
import pytest
from nltk.stem.porter import PorterStemmer

from audiocaption_tpu.cli import synthetic_corpus
from audiocaption_tpu.metrics import bleu as j_bleu
from audiocaption_tpu.metrics import cider as j_cider
from audiocaption_tpu.metrics import diversity as j_div
from audiocaption_tpu.metrics import eval as j_eval
from audiocaption_tpu.metrics import extra as j_extra
from audiocaption_tpu.metrics import meteor as j_meteor
from audiocaption_tpu.metrics import rouge as j_rouge
from audiocaption_tpu.metrics import spice as j_spice
from audiocaption_tpu.metrics import tools as j_tools

from audiocaption_tpu_torch.metrics import bleu as t_bleu
from audiocaption_tpu_torch.metrics import cider as t_cider
from audiocaption_tpu_torch.metrics import diversity as t_div
from audiocaption_tpu_torch.metrics import eval as t_eval
from audiocaption_tpu_torch.metrics import extra as t_extra
from audiocaption_tpu_torch.metrics import meteor as t_meteor
from audiocaption_tpu_torch.metrics import rouge as t_rouge
from audiocaption_tpu_torch.metrics import spice as t_spice
from audiocaption_tpu_torch.metrics import tools as t_tools
from audiocaption_tpu_torch.metrics.porter import porter_stem

ROOT = Path(__file__).resolve().parent.parent
ATOL = 1e-12
WORDS = ("a the dog dogs barks barking barked bark water flows flowing "
         "flowed man speaks speaking speech music plays playing played "
         "loudly loud softly then after before while and with siren "
         "sirens rising rises tone tones hum humming engine engines "
         "running runs car cars passing passes bird birds chirping chirps "
         "someone is are of in on followed by together").split()
GOLDEN = [
    ({"d1": ["a b c"], "d2": ["x y z"]}, {"d1": ["a b d"], "d2": ["x y z"]}),
    ({"d1": ["a b c e"], "d2": ["p q r s"]},
     {"d1": ["a b d"], "d2": ["p q r s"]}),
    ({"k": ["a b c"]}, {"k": ["a c d e"]}),
    ({"k": ["a b c d"]}, {"k": ["a c d e"]}),
    ({"d1": ["a b c d"], "d2": ["a b x"]},
     {"d1": ["a b c d"], "d2": ["a b y"]}),
    ({"k": ["a b"]}, {"k": ["a b c d"]}),
    ({"k": ["A man's dog barks."]}, {"k": ["It isn't loud; it's quiet.",
                                           "a well-lit room"]}),
]
CASE_IDS = [f"golden{i}" for i in range(len(GOLDEN))] + [
    f"random{s}" for s in range(3)] + ["corpus_v1", "corpus_v2"]


def random_case(seed: int, n: int = 30, refs: int = 5):
    """n keys, a prediction and ``refs`` references each, 1-20 words
    drawn from WORDS (a small pool, so words repeat in a caption)."""
    rng = np.random.RandomState(seed)

    def caption():
        return " ".join(rng.choice(WORDS, rng.randint(1, 21)))
    keys = [f"k{i}" for i in range(n)]
    return ({k: [caption()] for k in keys},
            {k: [caption() for _ in range(refs)] for k in keys})


def corpus_case(version: int, n: int = 40):
    """Predictions and references from the synthetic corpora's caption
    generators: a prediction is one clip's caption, scored against
    another clip's five (and itself half the time)."""
    rng = np.random.RandomState(version)
    sc = synthetic_corpus
    preds, refs = {}, {}
    for i in range(n):
        if version == 1:
            caps = sc.captions_for(rng, sc.sample_events(rng))
            other = sc.captions_for(rng, sc.sample_events(rng))
        else:
            caps = sc.captions_for_v2(rng, sc.sample_events_v2(rng))
            other = sc.captions_for_v2(rng, sc.sample_events_v2(rng))
        preds[f"c{i}"] = [caps[0]]
        refs[f"c{i}"] = (caps if i % 2 else other)[:5]
    return preds, refs


def case(case_id: str):
    if case_id.startswith("golden"):
        return GOLDEN[int(case_id[6:])]
    if case_id.startswith("random"):
        return random_case(int(case_id[6:]))
    return corpus_case(int(case_id[-1]))


def assert_close(got, want):
    """Equal structure; floats within ATOL."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_close(got[k], want[k])
    elif isinstance(want, (list, tuple, np.ndarray)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_close(a, b)
    elif isinstance(want, float):
        assert abs(got - want) <= ATOL, (got, want)
    else:
        assert got == want


def vocabulary():
    """The synthetic corpora's words (event phrases, synonyms and every
    template), the metric tests' captions, and the words of the
    repository's Python and Markdown sources."""
    sc = synthetic_corpus
    text = []
    for name in dir(sc):
        value = getattr(sc, name)
        if name.startswith("TEMPLATES"):
            text += value
        elif name.startswith("EVENTS"):
            for phrases, _ in value:
                text += [phrases] if isinstance(phrases, str) else phrases
    for name in ("test_metrics.py", "test_spice_py.py",
                 "test_metric_goldens.py", "test_extra_metrics.py"):
        text.append((ROOT / "tests" / name).read_text())
    for path in list(ROOT.glob("*.md")) + list(
            (ROOT / "audiocaption_tpu").rglob("*.py")):
        text.append(path.read_text())
    return sorted(set(re.findall(r"[A-Za-z]+", " ".join(text))))


def test_porter_stemmer_is_nltks_word_for_word():
    nltk_stem = PorterStemmer().stem
    words = vocabulary()
    words += ["skies", "dying", "spied", "died", "flies", "generalli",
              "archaeology", "controlling", "yyyy", "syzygy"]
    assert len(words) > 2000
    bad = [(w, porter_stem(w), nltk_stem(w)) for w in words
           if porter_stem(w) != nltk_stem(w)]
    assert not bad, bad[:10]


def test_synthetic_vocabulary_stems_equal_in_meteor():
    sc = synthetic_corpus
    words = {w for ev in sc.EVENTS_V2 for p in ev[0] for w in p.split()}
    assert {w: t_meteor.stem(w) for w in words} == {
        w: j_meteor._stem(w) for w in words}


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_bleu(case_id):
    preds, refs = case(case_id)
    assert_close(t_bleu.corpus_bleu(preds, refs),
                 j_bleu.corpus_bleu(preds, refs))


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_rouge_l(case_id):
    preds, refs = case(case_id)
    assert_close(t_rouge.rouge_l(preds, refs), j_rouge.rouge_l(preds, refs))


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_cider_d(case_id):
    preds, refs = case(case_id)
    got = t_cider.CiderD().compute_score(refs, preds)
    want = j_cider.CiderD().compute_score(refs, preds)
    assert_close(float(got[0]), float(want[0]))
    assert_close(np.asarray(got[1], float).tolist(),
                 np.asarray(want[1], float).tolist())


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_meteor_py(case_id):
    preds, refs = case(case_id)
    assert_close(t_meteor.meteor_py(preds, refs),
                 j_meteor.meteor_py(preds, refs))


def test_meteor_py_past_its_budget():
    """A caption of one repeated word against a permuted reference runs
    the chunk search out of its budget: the best alignment seen."""
    hyp = ("dog barks " * 5 + "water dog " * 3).split()
    ref = ("barks dog " * 4 + "dog water " * 3 + "dog").split()
    assert t_meteor.meteor_pair(hyp, ref) == j_meteor.meteor_pair(hyp, ref)


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_spice_py(case_id):
    preds, refs = case(case_id)
    assert_close(t_spice.spice_py(preds, refs),
                 j_spice.spice_py(preds, refs))


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_evaluate_captions(case_id, capsys):
    """Every key (no Java here: the ``*_py`` keys), ``skipped_scorers``
    and its stderr line, and ``per_audio``."""
    preds, refs = case(case_id)
    got = t_eval.evaluate_captions(preds, refs, per_audio=True)
    port_err = capsys.readouterr().err
    want = j_eval.evaluate_captions(preds, refs, per_audio=True)
    jax_err = capsys.readouterr().err
    assert list(got) == list(want)
    assert {"meteor_py", "spice_py", "spider_py", "skipped_scorers",
            "per_audio"} <= set(got)
    assert_close(got, want)
    assert port_err == jax_err and "[metrics] skipped scorers" in port_err


def test_evaluate_captions_zh_and_java_off():
    preds, refs = random_case(5, n=8)
    for kw in (dict(zh=True), dict(use_java=False)):
        assert_close(t_eval.evaluate_captions(preds, refs, **kw),
                     j_eval.evaluate_captions(preds, refs, **kw))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("case_id", ["random0", "corpus_v2"])
def test_diversity(case_id, train):
    preds, refs = case(case_id)
    p = [v[0] for v in preds.values()]
    corpus = [c for caps in refs.values() for c in caps] if train else None
    for name in ("diversity_metrics", "instance_diversity_metrics"):
        assert_close(getattr(t_div, name)(p, corpus),
                     getattr(j_div, name)(p, corpus))


def test_specificity(tmp_path):
    preds, refs = random_case(6)
    corpus = [c for caps in refs.values() for c in caps]
    table = t_extra.build_word_specificity(corpus)
    assert_close(table, j_extra.build_word_specificity(corpus))
    tsv = tmp_path / "word.tsv"
    tsv.write_text("word\tspecificity\n" + "".join(
        f"{w}\t{s!r}\n" for w, s in list(table.items())[:20]))
    loaded = t_extra.load_word_specificity(str(tsv))
    assert_close(loaded, j_extra.load_word_specificity(str(tsv)))
    p = [v[0] for v in preds.values()]
    for tab in (table, loaded):
        assert_close(t_extra.specificity_score(p, tab),
                     j_extra.specificity_score(p, tab))


class _FakeTok:
    def __call__(self, texts, padding=True, return_tensors="pt"):
        return {"texts": list(texts)}


class _FakeClap:
    """A deterministic text tower: [word count, character sum mod 97]."""

    def eval(self):
        return self

    def get_text_features(self, texts):
        import torch
        return torch.tensor([[float(len(t.split())),
                              float(sum(map(ord, t)) % 97)] for t in texts])


def test_clap_scores_and_skip(monkeypatch):
    preds, refs = random_case(7, n=6)
    assert_close(t_extra.clap_text_similarity(preds, refs, _FakeClap(),
                                              _FakeTok()),
                 j_extra.clap_text_similarity(preds, refs, _FakeClap(),
                                              _FakeTok()))

    def no_weights(name):
        raise OSError("no weights")
    monkeypatch.setattr(t_extra, "_load_clap", no_weights)
    assert t_extra.clap_text_similarity(preds, refs) is None


def test_round_robin_scores():
    _, refs = corpus_case(2, n=12)
    assert_close(t_tools.round_robin_scores(refs),
                 j_tools.round_robin_scores(refs))


def test_aggregate_seed_results(tmp_path):
    rng = np.random.RandomState(8)
    for seed in (1, 2, 3):
        d = tmp_path / f"seed_{seed}" / "results"
        d.mkdir(parents=True)
        d.joinpath("scores.txt").write_text("".join(
            f"{k}: {rng.rand():.4f}\n" for k in ("bleu_4", "cider",
                                                 "spider_py")))
    assert_close(t_tools.aggregate_seed_results(str(tmp_path)),
                 j_tools.aggregate_seed_results(str(tmp_path)))


@pytest.mark.parametrize("metric", ["cider", "bleu_4", "meteor_py"])
def test_prediction_diff(metric):
    pa, refs = random_case(9, n=10)
    pb, _ = random_case(10, n=10)
    assert_close(t_tools.prediction_diff(pa, pb, refs, metric),
                 j_tools.prediction_diff(pa, pb, refs, metric))
