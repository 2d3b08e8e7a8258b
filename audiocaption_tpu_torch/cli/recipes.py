"""The repo's synthetic-corpus recipes, read from ``configs/`` with the
data directory moved, and a script that generates a corpus, trains on it
and scores the experiment.

Each function returns what ``utils/config.py::load_config`` gives for
its YAML, with the data directory ``d`` in place of the YAML's
``data/synthetic_*``:

  * :func:`flagship_train` -> ``configs/synthetic_v2/effb2_trm.yaml``
    (over ``train_data.yaml``), :func:`flagship_test` ->
    ``configs/synthetic_v2/test.yaml``;
  * :func:`sed_train` -> ``configs/synthetic_temporal/sed.yaml``,
    :func:`tempgru_train` -> ``tempgru.yaml`` (over ``train_data.yaml``),
    :func:`temporal_test` -> ``test.yaml``.

The script, on the card by default:

    python -m audiocaption_tpu_torch.cli.recipes flagship \\
        --data data/synthetic_v2 --results results/torch_h100/synthetic_v2
    python -m audiocaption_tpu_torch.cli.recipes temporal \\
        --data data/synthetic_temporal \\
        --results results/torch_h100/synthetic_temporal

``flagship`` generates corpus v2 at its recorded settings (3000 / 300 /
300 clips of 10 s at 32 kHz, seed 0; ``--sizes`` and ``--duration`` cut
it) unless ``--data`` holds it,
trains the flagship recipe (``Runner.train``), then scores its best and
SWA checkpoints on the test split at beam 3 (``Runner.evaluate``, the
flagship's ``target_sr: 16000``).  ``temporal`` generates the temporal
corpus (2000 / 200 / 200 clips, seed 0), trains the SED net
(``Runner.train_sed``) and the tag-conditioned captioner, then scores
the SWA checkpoint at beam 3 with the SED net's tags
(``Runner.evaluate_temporal``) and with the ground-truth tags
(``Runner.evaluate``).  Both profile a few train steps of the recipe on a
fresh model (the device's idle share) and copy each ``train.log`` and
score file into ``--results``, with ``run.json`` (the times of every
stage, the card, the peak memory).  ``key=value`` overrides after the
options apply to the training configs (``data.train.dataloader_args.
num_workers=6``, ``trainer.epochs=2``, ``device=cpu``); for ``temporal``,
those that start with ``sed.`` apply to the SED config alone
(``sed.trainer.epochs=2``).
"""

from __future__ import annotations

import argparse
import itertools
import json
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

import torch

from audiocaption_tpu_torch.utils.config import load_config

CONFIGS = Path(__file__).resolve().parents[2] / "configs"


def _moved(node, old: str, new: str):
    """``node`` with every string that starts with ``old`` starting with
    ``new`` instead."""
    if isinstance(node, dict):
        return {k: _moved(v, old, new) for k, v in node.items()}
    if isinstance(node, list):
        return [_moved(v, old, new) for v in node]
    if isinstance(node, str) and node.startswith(old):
        return new + node[len(old):]
    return node


def recipe(yaml_name: str, d: str) -> Dict:
    """``configs/{yaml_name}`` (``synthetic_v2/...`` or
    ``synthetic_temporal/...``) as ``load_config`` reads it, its data
    directory ``data/{corpus}/`` moved to ``d``."""
    corpus = yaml_name.split("/")[0]
    return _moved(load_config(str(CONFIGS / yaml_name)),
                  f"data/{corpus}/", d.rstrip("/") + "/")


def flagship_train(d: str = "data/synthetic_v2") -> Dict:
    return recipe("synthetic_v2/effb2_trm.yaml", d)


def flagship_test(d: str = "data/synthetic_v2") -> Dict:
    return recipe("synthetic_v2/test.yaml", d)


def sed_train(d: str = "data/synthetic_temporal") -> Dict:
    return recipe("synthetic_temporal/sed.yaml", d)


def tempgru_train(d: str = "data/synthetic_temporal") -> Dict:
    return recipe("synthetic_temporal/tempgru.yaml", d)


def temporal_test(d: str = "data/synthetic_temporal") -> Dict:
    return recipe("synthetic_temporal/test.yaml", d)


# -------------------------------------------------------- recipe runs --

def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the first card, or
    "cpu"."""
    if not torch.cuda.is_available():
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def profile_steps(cfg: Dict, overrides: List[str], steps: int = 6,
                  warmup: int = 2) -> Dict:
    """A fresh model of the recipe (its experiment directory under
    ``{experiment_path}/profile``) through ``steps`` train steps of the
    runner's loader and ``train_step`` after ``warmup``: wall ms a step
    (loader included) and the device's busy ms a step from a
    ``torch.profiler`` trace -> {step_ms, device_ms, idle_share} (empty
    off CUDA)."""
    from torch.profiler import ProfilerActivity, profile
    from audiocaption_tpu_torch.cli.run import Runner, to_device
    from audiocaption_tpu_torch.losses.loss import build_loss
    from audiocaption_tpu_torch.training.trainer import (
        create_train_state, train_step)
    run = Runner()._setup(cfg, list(overrides) + [
        f"experiment_path={cfg['experiment_path'].rstrip('/')}/profile"])
    if run.device.type != "cuda":
        return {}
    state = create_train_state(run.model, **run.opt)
    loss_fn = build_loss(run.cfg.get("loss", {}))
    gen = torch.Generator().manual_seed(run.seed + 1)
    ratio = torch.tensor(0.85)
    batches = itertools.islice(iter(run.train_loader), warmup + steps)

    def step(batch):
        train_step(state, loss_fn, to_device(batch, run.device),
                   ss_ratio=ratio, generator=gen)
    for batch in itertools.islice(batches, warmup):
        step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    # self times: a kernel's own, not again under the op that launched it
    device_ms = sum(getattr(ev, "self_device_time_total", None)
                    or getattr(ev, "self_cuda_time_total", 0)
                    for ev in prof.key_averages()) / 1e3 / steps
    return {"step_ms": wall, "device_ms": device_ms,
            "idle_share": 1 - device_ms / wall}


def _copy(src: Path, dst: Path) -> None:
    if src.exists():
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(src, dst)


def _corpus(kind: str, data: Path, sizes, duration: float,
            record: Dict) -> None:
    from audiocaption_tpu_torch.cli import synthetic_corpus as sc
    if (data / "test_text.json").exists():
        record["corpus_s"] = None
        return
    data.parent.mkdir(parents=True, exist_ok=True)
    record["disk_free_gb_before"] = shutil.disk_usage(
        data.parent).free / 2**30
    t0 = time.perf_counter()
    fn = sc.generate_v2 if kind == "flagship" else sc.generate_temporal
    fn(str(data), *sizes, sr=32000, duration=duration, seed=0)
    record["corpus_s"] = time.perf_counter() - t0
    record["disk_free_gb_after"] = shutil.disk_usage(
        data.parent).free / 2**30


def run_flagship(data: Path, results: Path, overrides: List[str],
                 sizes=(3000, 300, 300), duration: float = 10.0) -> Dict:
    from audiocaption_tpu_torch.cli.run import Runner
    record: Dict = {"card": card_name()}
    _corpus("flagship", data, sizes, duration, record)
    train_cfg = flagship_train(str(data))
    runner = Runner()
    t0 = time.perf_counter()
    exp = Path(runner.train(train_cfg, *overrides))
    record["train_s"] = time.perf_counter() - t0
    dev = [o for o in overrides if o.startswith("device=")]
    for resume in ("best", "swa"):
        t0 = time.perf_counter()
        scores = runner.evaluate(
            str(exp), flagship_test(str(data)), *dev,
            "data.test.dataset.args.target_sr=16000",
            f"resume={resume}.pth",
            f"caption_output=predictions/{resume}_beam3.json",
            f"score_output=results/{resume}_beam3.txt")
        record[f"test_{resume}"] = {k: v for k, v in scores.items()
                                    if isinstance(v, float)}
        record[f"evaluate_{resume}_s"] = time.perf_counter() - t0
        _copy(exp / f"results/{resume}_beam3.txt",
              results / f"effb2_trm/{resume}_beam3.txt")
    _copy(exp / "train.log", results / "effb2_trm/train.log")
    record["profile"] = profile_steps(train_cfg, overrides)
    return record


def run_temporal(data: Path, results: Path, overrides: List[str],
                 sizes=(2000, 200, 200), duration: float = 10.0) -> Dict:
    from audiocaption_tpu_torch.cli.run import Runner
    record: Dict = {"card": card_name()}
    _corpus("temporal", data, sizes, duration, record)
    dev = [o for o in overrides if o.startswith("device=")]
    sed_over = [o[len("sed."):] for o in overrides if o.startswith("sed.")]
    overrides = [o for o in overrides if not o.startswith("sed.")]
    runner = Runner()
    t0 = time.perf_counter()
    sed_exp = Path(runner.train_sed(sed_train(str(data)), *dev, *sed_over))
    record["train_sed_s"] = time.perf_counter() - t0
    _copy(sed_exp / "train.log", results / "sed/train.log")
    train_cfg = tempgru_train(str(data))
    t0 = time.perf_counter()
    exp = Path(runner.train(train_cfg, *overrides))
    record["train_s"] = time.perf_counter() - t0
    test = temporal_test(str(data))
    t0 = time.perf_counter()
    scores = runner.evaluate_temporal(
        str(exp), str(sed_exp), test, *dev,
        "caption_output=predictions/swa_beam3_sedtag.json",
        "score_output=results/swa_beam3_sedtag.txt")
    record["test_swa_sedtag"] = {k: v for k, v in scores.items()
                                 if isinstance(v, float)}
    record["evaluate_temporal_s"] = time.perf_counter() - t0
    scores = runner.evaluate(
        str(exp), test, *dev,
        "caption_output=predictions/swa_beam3_oracle.json",
        "score_output=results/swa_beam3_oracle.txt")
    record["test_swa_oracle"] = {k: v for k, v in scores.items()
                                 if isinstance(v, float)}
    for name in ("swa_beam3_sedtag.txt", "swa_beam3_oracle.txt",
                 "sed_tag_accuracy.txt"):
        _copy(exp / "results" / name, results / f"tempgru/{name}")
    _copy(exp / "train.log", results / "tempgru/train.log")
    record["profile"] = profile_steps(train_cfg, overrides)
    return record


def main(argv=None) -> Dict:
    parser = argparse.ArgumentParser(
        prog="audiocaption_tpu_torch.cli.recipes")
    parser.add_argument("recipe", choices=("flagship", "temporal"))
    parser.add_argument("--data", required=True)
    parser.add_argument("--results", required=True)
    parser.add_argument("--sizes", default=None,
                        help="train,val,test clips of a corpus to generate "
                             "(default: the recorded 3000,300,300 / "
                             "2000,200,200)")
    parser.add_argument("--duration", type=float, default=10.0)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_intermixed_args(argv)
    run = run_flagship if args.recipe == "flagship" else run_temporal
    kw = {"duration": args.duration}
    if args.sizes:
        kw["sizes"] = tuple(int(n) for n in args.sizes.split(","))
    t0 = time.perf_counter()
    record = run(Path(args.data), Path(args.results), args.overrides, **kw)
    record["total_s"] = time.perf_counter() - t0
    out = Path(args.results) / "run.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
