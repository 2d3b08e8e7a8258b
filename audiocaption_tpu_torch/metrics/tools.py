"""Evaluation tools beyond the core scorers, a copy of
``audiocaption_tpu/metrics/tools.py``:

  * round-robin inter-annotator scores, the human ceiling (reference
    ``python_scripts/utils/eval_round_robin.py``): each annotator's caption
    scored against the others', averaged over annotators;
  * the mean and std of score files over seeds (reference
    ``python_scripts/utils/report_results.py``);
  * per-audio metric differences between two prediction sets (reference
    ``python_scripts/utils/model_eval_diff.py``).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from audiocaption_tpu_torch.metrics.eval import evaluate_captions


def round_robin_scores(key2refs: Dict[str, List[str]],
                       use_java: bool = False) -> Dict[str, float]:
    """Each annotator in turn is the system: caption i against the other
    references; every metric averaged over the rounds."""
    n_caps = min(len(v) for v in key2refs.values())
    rounds = []
    for i in range(n_caps):
        preds = {k: [v[i]] for k, v in key2refs.items()}
        refs = {k: v[:i] + v[i + 1:] for k, v in key2refs.items()}
        rounds.append(evaluate_captions(preds, refs, use_java=use_java))
    keys = [k for k, v in rounds[0].items() if isinstance(v, float)]
    return {k: float(np.mean([r[k] for r in rounds])) for k in keys}


def aggregate_seed_results(experiment_path: str,
                           score_file: str = "results/scores.txt"
                           ) -> Dict[str, Tuple[float, float]]:
    """``metric: value`` score files of every ``seed_*`` directory ->
    {metric: (mean, std)}."""
    values: Dict[str, List[float]] = {}
    for seed_dir in sorted(Path(experiment_path).glob("seed_*")):
        path = seed_dir / score_file
        if not path.exists():
            continue
        for line in path.read_text().splitlines():
            m = re.match(r"(\S+):\s*([-\d.]+)", line)
            if m:
                values.setdefault(m.group(1), []).append(float(m.group(2)))
    return {k: (float(np.mean(v)), float(np.std(v)))
            for k, v in values.items()}


def prediction_diff(pred_a: Dict[str, List[str]],
                    pred_b: Dict[str, List[str]],
                    key2refs: Dict[str, List[str]],
                    metric: str = "cider") -> List[Tuple[str, float]]:
    """Per-audio metric difference (A - B), largest |delta| first."""
    ra = evaluate_captions(pred_a, key2refs, use_java=False, per_audio=True)
    rb = evaluate_captions(pred_b, key2refs, use_java=False, per_audio=True)
    diffs = [(k, ra["per_audio"][k][metric] - rb["per_audio"][k][metric])
             for k in pred_a if k in rb.get("per_audio", {})]
    return sorted(diffs, key=lambda x: -abs(x[1]))
