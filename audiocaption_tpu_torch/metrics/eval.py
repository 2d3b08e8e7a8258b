"""The caption evaluation aggregator, a copy of
``audiocaption_tpu/metrics/eval.py`` (the reference's
``_eval_prediction``): BLEU-1..4, ROUGE-L and CIDEr-D in Python; METEOR,
SPICE and SPIDEr = (CIDEr + SPICE) / 2 through pycocoevalcap's Java
scorers where ``java`` and ``pycocoevalcap`` are both present, else their
pure-Python approximations under their own keys (``meteor_py``,
``spice_py``, ``spider_py``); FENSE where its package and weights load.
Every scorer left out is named in ``skipped_scorers`` and on stderr.
"""

from __future__ import annotations

import shutil
import sys
from typing import Dict, List, Optional

from audiocaption_tpu_torch.metrics.bleu import corpus_bleu
from audiocaption_tpu_torch.metrics.cider import CiderD
from audiocaption_tpu_torch.metrics.meteor import meteor_py
from audiocaption_tpu_torch.metrics.rouge import rouge_l
from audiocaption_tpu_torch.metrics.spice import spice_py
from audiocaption_tpu_torch.metrics.tokenize import ptb_tokenize


def _java_available() -> bool:
    return shutil.which("java") is not None


def _try_pycoco():
    try:
        from pycocoevalcap.tokenizer.ptbtokenizer import PTBTokenizer
        return PTBTokenizer
    except ImportError:
        return None


def evaluate_captions(key2pred: Dict[str, List[str]],
                      key2refs: Dict[str, List[str]],
                      zh: bool = False,
                      use_java: Optional[bool] = None,
                      per_audio: bool = False) -> Dict:
    """-> {bleu_1..bleu_4, rouge_l, cider, then meteor, spice, spider or
    meteor_py, spice_py, spider_py, fense where it loads,
    skipped_scorers where any was left out, per_audio when asked}."""
    if use_java is None:
        use_java = _java_available() and _try_pycoco() is not None

    skipped: List[str] = []
    if not zh:
        # PTB-tokenized captions, by the Java tokenizer where it runs,
        # else by the regex normalisation, said so: scores over other
        # tokens are not comparable with pycocoevalcap's
        PTB = _try_pycoco() if use_java else None
        tokenized = False
        if PTB is not None:
            try:
                tok = PTB()
                fmt = lambda d: {k: [{"caption": c} for c in v]
                                 for k, v in d.items()}
                key2pred = tok.tokenize(fmt(key2pred))
                key2refs = tok.tokenize(fmt(key2refs))
                tokenized = True
            except Exception:
                pass
        if not tokenized:
            key2pred = ptb_tokenize(key2pred)
            key2refs = ptb_tokenize(key2refs)
            skipped.append("ptb_tokenizer (regex substitute — scores "
                           "not bit-comparable to pycocoevalcap)")

    result: Dict = {}
    bleu, bleu_per_key = corpus_bleu(key2pred, key2refs)
    for i, s in enumerate(bleu, 1):
        result[f"bleu_{i}"] = s
    result["rouge_l"], rouge_per_key = rouge_l(key2pred, key2refs)
    result["cider"], cider_scores = CiderD().compute_score(key2refs,
                                                           key2pred)

    if use_java:
        try:
            from pycocoevalcap.meteor.meteor import Meteor
            from pycocoevalcap.spice.spice import Spice
            result["meteor"], _ = Meteor().compute_score(key2refs, key2pred)
            result["spice"], _ = Spice().compute_score(key2refs, key2pred)
            result["spider"] = (result["cider"] + result["spice"]) / 2
        except Exception as e:
            skipped.append(f"meteor/spice/spider ({type(e).__name__})")
    else:
        result["meteor_py"], meteor_per_key = meteor_py(key2pred, key2refs)
        result["spice_py"], spice_per_key = spice_py(key2pred, key2refs)
        result["spider_py"] = (result["cider"] + result["spice_py"]) / 2
        skipped.append("meteor/spice/spider (no java/pycocoevalcap; "
                       "meteor_py/spice_py/spider_py are pure-Python "
                       "approximations)")

    try:
        from fense.evaluator import Evaluator
        fense_eval = Evaluator(device="cpu",
                               sbert_model="paraphrase-TinyBERT-L6-v2")
        keys = list(key2pred.keys())
        result["fense"] = float(fense_eval.corpus_score(
            [key2pred[k][0] for k in keys], [key2refs[k] for k in keys],
            agg_score="mean"))
    except Exception as e:
        skipped.append(f"fense ({type(e).__name__})")

    # never drop a scorer silently: a result without SPIDEr says so
    if skipped:
        result["skipped_scorers"] = skipped
        print(f"[metrics] skipped scorers: {', '.join(skipped)}",
              file=sys.stderr)

    if per_audio:
        result["per_audio"] = {
            k: {"cider": float(cider_scores[i]),
                "bleu_4": bleu_per_key[k][3],
                "rouge_l": rouge_per_key[k]}
            for i, k in enumerate(key2pred.keys())}
        if "meteor_py" in result:
            for k in result["per_audio"]:
                result["per_audio"][k]["meteor_py"] = meteor_per_key[k]
                result["per_audio"][k]["spice_py"] = spice_per_key[k]
    return result
