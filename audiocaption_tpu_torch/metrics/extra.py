"""Caption quality beyond the core scorers, a copy of
``audiocaption_tpu/metrics/extra.py``:

  * specificity: the mean over captions of the summed word specificity
    (reference ``python_scripts/eval/specificity.py``), from the -log
    unigram-frequency table the data tools write (TSV columns word,
    specificity); a word missing from the table counts 0;
  * CLAP text-text similarity (reference
    ``python_scripts/eval/clap_score.py``): the prediction's embedding
    dotted with each reference's, the mean over references, the mean over
    the corpus, through the ``transformers`` CLAP text tower
    ("laion/clap-htsat-unfused").  Gated on its weights: where they do
    not load, the score is None and the command line says it skipped.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np

CLAP_MODEL_NAME = "laion/clap-htsat-unfused"


def specificity_score(predictions: List[str],
                      word_specificity: Dict[str, float]) -> float:
    """The mean over captions of the summed per-word specificity."""
    totals = [sum(word_specificity.get(w, 0.0) for w in cap.split())
              for cap in predictions]
    return float(np.mean(totals)) if totals else 0.0


def load_word_specificity(path: str) -> Dict[str, float]:
    """The word / specificity TSV (``data_tools extract_specificity``)."""
    out: Dict[str, float] = {}
    with open(path) as f:
        header = f.readline().strip().split("\t")
        wi, si = header.index("word"), header.index("specificity")
        for line in f:
            cols = line.rstrip("\n").split("\t")
            if len(cols) > max(wi, si):
                out[cols[wi]] = float(cols[si])
    return out


def build_word_specificity(corpus: List[str]) -> Dict[str, float]:
    """-log(p(word)) over a caption corpus."""
    counts = Counter(w for cap in corpus for w in cap.split())
    total = sum(counts.values())
    return {w: float(-np.log(c / total)) for w, c in counts.items()}


def _load_clap(model_name: str):
    from transformers import AutoTokenizer, ClapModel
    return (ClapModel.from_pretrained(model_name),
            AutoTokenizer.from_pretrained(model_name))


def clap_text_similarity(predictions: Dict[str, List[str]],
                         references: Dict[str, List[str]],
                         model=None, tokenizer=None,
                         model_name: str = CLAP_MODEL_NAME,
                         ) -> Optional[Tuple[float, Dict[str, float]]]:
    """(corpus mean, per-key scores), or None where the CLAP weights do
    not load.  ``model`` / ``tokenizer`` may be handed in (a local
    checkpoint)."""
    import torch

    if model is None or tokenizer is None:
        try:
            model, tokenizer = _load_clap(model_name)
        except Exception:
            return None
    model.eval()

    def embed(texts: List[str]) -> torch.Tensor:
        inputs = tokenizer(texts, padding=True, return_tensors="pt")
        with torch.no_grad():
            return model.get_text_features(**inputs)

    per_key: Dict[str, float] = {}
    for k, preds in predictions.items():
        emb = embed(preds[:1] + list(references[k]))
        # a raw dot product, the mean over the references
        per_key[k] = float((emb[0:1] @ emb[1:].T).mean().item())
    avg = float(np.mean(list(per_key.values()))) if per_key else 0.0
    return avg, per_key
