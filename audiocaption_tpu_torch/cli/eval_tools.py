"""Evaluation tools (counterpart of ``audiocaption_tpu/cli/eval_tools.py``;
reference ``python_scripts/eval/*`` and ``python_scripts/utils/
{eval_round_robin,report_results}.py``):

    python -m audiocaption_tpu_torch.cli.eval_tools round_robin \\
        --caption text.json
    python -m audiocaption_tpu_torch.cli.eval_tools report \\
        --experiment_path EXP [--score_file results/scores.txt]
    python -m audiocaption_tpu_torch.cli.eval_tools diversity \\
        --predictions preds.json [--train_caption train.json] [--instance]
    python -m audiocaption_tpu_torch.cli.eval_tools score \\
        --predictions preds.json --caption text.json
    python -m audiocaption_tpu_torch.cli.eval_tools specificity \\
        --predictions preds.json --word_specificity word_spec.tsv
    python -m audiocaption_tpu_torch.cli.eval_tools clap \\
        --predictions preds.json --caption text.json

Predictions are a runner's ``{"predictions": [{filename, caption}]}`` or
a plain ``{audio_id: caption}`` json.  Every number prints as
``name: value``.
"""

from __future__ import annotations

import argparse
import json

from audiocaption_tpu_torch.data.dataset import load_caption_json


def _load_predictions(path: str):
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict) and "predictions" in data:
        return {p["filename"]: [p["caption"]] for p in data["predictions"]}
    return {k: [v] if isinstance(v, str) else v for k, v in data.items()}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="audiocaption_tpu_torch.cli.eval_tools")
    sub = p.add_subparsers(dest="command", required=True)
    rr = sub.add_parser("round_robin")
    rr.add_argument("--caption", required=True)
    rep = sub.add_parser("report")
    rep.add_argument("--experiment_path", required=True)
    rep.add_argument("--score_file", default="results/scores.txt")
    div = sub.add_parser("diversity")
    div.add_argument("--predictions", required=True)
    div.add_argument("--train_caption", default=None)
    div.add_argument("--instance", action="store_true",
                     help="per-caption distinct-n averaged over captions")
    sc = sub.add_parser("score")
    sc.add_argument("--predictions", required=True)
    sc.add_argument("--caption", required=True)
    sp = sub.add_parser("specificity")
    sp.add_argument("--predictions", required=True)
    sp.add_argument("--word_specificity", required=True,
                    help="TSV with word / specificity columns")
    cl = sub.add_parser("clap")
    cl.add_argument("--predictions", required=True)
    cl.add_argument("--caption", required=True)
    cl.add_argument("--model_name", default=None,
                    help="HF CLAP checkpoint (default "
                         "laion/clap-htsat-unfused)")
    args = p.parse_args(argv)

    if args.command == "round_robin":
        from audiocaption_tpu_torch.metrics.tools import round_robin_scores
        for k, v in round_robin_scores(
                load_caption_json(args.caption)).items():
            print(f"{k}: {v:.4f}")
    elif args.command == "report":
        from audiocaption_tpu_torch.metrics.tools import (
            aggregate_seed_results)
        agg = aggregate_seed_results(args.experiment_path, args.score_file)
        for k, (mean, std) in agg.items():
            print(f"{k}: {mean:.4f} +/- {std:.4f}")
    elif args.command == "diversity":
        from audiocaption_tpu_torch.metrics.diversity import (
            diversity_metrics, instance_diversity_metrics)
        preds = [v[0] for v in _load_predictions(args.predictions).values()]
        train = None
        if args.train_caption:
            refs = load_caption_json(args.train_caption)
            train = [c for caps in refs.values() for c in caps]
        fn = instance_diversity_metrics if args.instance \
            else diversity_metrics
        for k, v in fn(preds, train).items():
            print(f"{k}: {v:.4f}")
    elif args.command == "score":
        from audiocaption_tpu_torch.metrics.eval import evaluate_captions
        preds = _load_predictions(args.predictions)
        refs = load_caption_json(args.caption)
        refs = {k: v for k, v in refs.items() if k in preds}
        for k, v in evaluate_captions(preds, refs).items():
            if isinstance(v, float):
                print(f"{k}: {v:.4f}")
    elif args.command == "specificity":
        from audiocaption_tpu_torch.metrics.extra import (
            load_word_specificity, specificity_score)
        preds = [v[0] for v in _load_predictions(args.predictions).values()]
        table = load_word_specificity(args.word_specificity)
        print(f"specificity: {specificity_score(preds, table):.4f}")
    elif args.command == "clap":
        from audiocaption_tpu_torch.metrics.extra import (
            CLAP_MODEL_NAME, clap_text_similarity)
        preds = _load_predictions(args.predictions)
        refs = load_caption_json(args.caption)
        refs = {k: v for k, v in refs.items() if k in preds}
        result = clap_text_similarity(
            preds, refs, model_name=args.model_name or CLAP_MODEL_NAME)
        if result is None:
            print("clap: SKIPPED (CLAP weights unavailable — needs the "
                  "laion/clap-htsat-unfused checkpoint, see MIGRATION.md)")
        else:
            print(f"clap: {result[0]:.4f}")


if __name__ == "__main__":
    main()
