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
    :func:`temporal_test` -> ``test.yaml``;
  * :func:`aug_train` -> ``configs/synthetic_v2/cnn14rnn_trm.yaml`` with
    ``configs/synthetic/aug.yaml``'s ``data.train_aug`` and ``aug``
    nodes, its augmented corpus in a second directory;
  * :func:`m2_source_train` -> ``configs/synthetic/cnn14rnn_trm.yaml``
    (over ``train_data.yaml``: device-resident banks) and
    :func:`m2_source_test` -> ``configs/synthetic/test.yaml``, on corpus
    v1; :func:`m2_train` -> ``configs/synthetic/m2_trm.yaml`` and
    :func:`m2_test` -> ``test_m2.yaml``, on the features extracted from
    the source under ``{d}/features_cnn14rnn/{split}/``;
  * :func:`encoders_train` -> ``configs/synthetic/cnn14rnn_trm.yaml`` with
    ``model.encoder`` replaced by an item-8 encoder's node
    (:data:`ENCODER_NODES`: HTS-AT, MobileNetV3 mn10, UiT-xs,
    ESResNeXt-FBSP), :func:`encoders_test` -> ``synthetic/test.yaml``
    (both at 16 kHz for UiT);
  * :func:`keyword_train` -> ``configs/synthetic/cnn14rnn_trm.yaml`` on the
    temporal corpus with its decoder a ``KeywordProbTransformerDecoder``
    (527 keyword classes), scheduled sampling off and keyword datasets,
    the keywords each clip's ground-truth events
    (:func:`write_keyword_rows`).

The script, on the card by default:

    python -m audiocaption_tpu_torch.cli.recipes flagship \\
        --data data/synthetic_v2 --results results/torch_h100/synthetic_v2
    python -m audiocaption_tpu_torch.cli.recipes temporal \\
        --data data/synthetic_temporal \\
        --results results/torch_h100/synthetic_temporal
    python -m audiocaption_tpu_torch.cli.recipes aug \\
        --data data/synthetic_v2 --results results/torch_h100/synthetic_v2_aug
    python -m audiocaption_tpu_torch.cli.recipes m2 \\
        --data data/synthetic --results results/torch_h100/synthetic_m2
    python -m audiocaption_tpu_torch.cli.recipes encoders \\
        --data data/synthetic --results results/torch_h100/encoders \\
        [--encoders htsat,mobilenet_v3,uit_xs,esresnext]

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
(``Runner.evaluate``).  ``aug`` generates corpus v2 (unless ``--data``
holds it) and its speed-perturbed train split (``cli/data_tools.py
speed_perturb --compute``, 0.9 and 1.1, into ``--aug_data``, default
``{data}_aug``), trains the augmented recipe (``Runner.train_aug``), then
scores its best and SWA checkpoints on the test split at beam 3 (32
kHz); ``--stop_epoch N`` trains the first N epochs of the recipe's
schedules and scores the best checkpoint alone.  ``m2`` generates corpus
v1 (2000 / 200 / 200 clips of 10 s at 32 kHz, seed 0) unless ``--data``
holds it, trains ``cnn14rnn_trm`` on it and scores its SWA and best
checkpoints (beam 3), extracts the SWA checkpoint's encoder output from
all three splits (``cli/prepare_features.py --format npy``), trains the
M2 transformer on those features (``m2_trm.yaml``) and scores its SWA
and best checkpoints (``test_m2.yaml``); overrides that start with
``m2.`` apply to the M2 config alone (``m2.trainer.epochs=2``), the
others to the source's (``device=`` to both).  ``encoders`` generates
corpus v1 unless ``--data`` holds it, then trains each encoder's
captioner of ``--encoders`` (:func:`encoders_train`) and scores its SWA
and best checkpoints at beam 3.  Each profiles a few train steps of the recipe on a
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
import copy
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


def m2_source_train(d: str = "data/synthetic") -> Dict:
    return recipe("synthetic/cnn14rnn_trm.yaml", d)


def m2_source_test(d: str = "data/synthetic") -> Dict:
    return recipe("synthetic/test.yaml", d)


def m2_train(d: str = "data/synthetic") -> Dict:
    return recipe("synthetic/m2_trm.yaml", d)


def m2_test(d: str = "data/synthetic") -> Dict:
    return recipe("synthetic/test_m2.yaml", d)


# the item-8 encoders, each a ``model.encoder`` node of the JAX builder's
# types at its published settings (the builder's defaults)
ENCODER_NODES = {
    "htsat": {"type": "captioning.models.htsat.Htsat",
              "args": {"sample_rate": 32000}},
    "mobilenet_v3": {"type": "MobileNetV3Encoder",
                     "args": {"model_name": "mn10",
                              "pooling": "mean_max_fc",
                              "sample_rate": 32000}},
    "uit_xs": {"type": "UitEncoder", "args": {"model_name": "uit_xs"}},
    "esresnext": {"type": "ESResNeXtFBSPEncoder", "args": {}},
}
# the encoders over the 16 kHz log-mel: their data nodes resample to it
_ENCODERS_16K = ("uit_xs",)


def _at_16k(cfg: Dict, splits) -> Dict:
    for split in splits:
        cfg["data"][split]["dataset"]["args"]["target_sr"] = 16000
    return cfg


def encoders_train(d: str = "data/synthetic",
                   name: str = "htsat") -> Dict:
    """``configs/synthetic/cnn14rnn_trm.yaml`` on corpus v1 in ``d`` with
    ``model.encoder`` replaced by :data:`ENCODER_NODES`'s ``name`` (the
    rest of the recipe, its transformer decoder included, as it is; the
    decoder's memory width follows the encoder's, as flax infers it) and
    its experiment directory ``experiments/synthetic/{name}_trm/``; a
    16 kHz encoder's train and val data resampled to 16 kHz."""
    cfg = recipe("synthetic/cnn14rnn_trm.yaml", d)
    cfg["model"]["encoder"] = copy.deepcopy(ENCODER_NODES[name])
    cfg["experiment_path"] = f"experiments/synthetic/{name}_trm/"
    return _at_16k(cfg, ("train", "val")) if name in _ENCODERS_16K else cfg


def encoders_test(d: str = "data/synthetic",
                  name: str = "htsat") -> Dict:
    """``configs/synthetic/test.yaml`` for :func:`encoders_train`'s
    ``name`` (at 16 kHz for a 16 kHz encoder)."""
    cfg = recipe("synthetic/test.yaml", d)
    return _at_16k(cfg, ("test",)) if name in _ENCODERS_16K else cfg


def write_keyword_rows(sed_json: str, out_dir: str,
                       classes_num: int = 527) -> str:
    """The keywords of each clip of a temporal corpus's split: the
    multi-hot [classes_num] float32 of its ground-truth event classes
    (``{split}_sed.json``), one ``.npy`` per clip in ``out_dir``, and the
    tsv of ``audio_id`` -> ``hdf5_path`` rows that the keyword datasets
    read (``data/condition_dataset.py``) -> the tsv's path."""
    import numpy as np
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    split = Path(sed_json).name[:-len("_sed.json")]
    rows = ["audio_id\thdf5_path\n"]
    for a in json.loads(Path(sed_json).read_text())["audios"]:
        kw = np.zeros(classes_num, np.float32)
        kw[[int(c) for c, _, _ in a["segments"]]] = 1.0
        path = out / f"{a['audio_id']}.npy"
        np.save(path, kw)
        rows.append(f"{a['audio_id']}\t{path}\n")
    tsv = out / f"{split}_keyword.tsv"
    tsv.write_text("".join(rows))
    return str(tsv)


def keyword_train(d: str = "data/synthetic_temporal",
                  keywords: str = "data/synthetic_temporal/keywords"
                  ) -> Dict:
    """``configs/synthetic/cnn14rnn_trm.yaml`` (the Cnn14 + BiGRU encoder
    and its data nodes, moved to the temporal corpus in ``d``) with its
    decoder a ``KeywordProbTransformerDecoder`` (the JAX builder's
    defaults: emb 256, 2 layers, dropout 0.2, 527 keyword classes),
    scheduled sampling off (its forward would drop the condition: ROADMAP
    Queue 3 K), the train data a ``KeywordProbCaptionDataset`` and the val
    data a ``KeywordProbInferenceDataset`` over the rows of
    ``{keywords}/{split}_keyword.tsv`` (:func:`write_keyword_rows`), and
    its experiment directory ``experiments/synthetic_temporal/
    keyword_trm/``."""
    cfg = recipe("synthetic/cnn14rnn_trm.yaml", d)
    cfg["model"]["decoder"]["type"] = (
        "captioning.models.transformer_decoder."
        "KeywordProbTransformerDecoder")
    cfg["scheduled_sampling"] = {"use": False}
    cfg["experiment_path"] = "experiments/synthetic_temporal/keyword_trm/"
    for split, kind in (("train", "KeywordProbCaptionDataset"),
                        ("val", "KeywordProbInferenceDataset")):
        node = cfg["data"][split]["dataset"]
        node["type"] = kind
        node["args"]["keyword_prob"] = str(
            Path(keywords) / f"{split}_keyword.tsv")
    return cfg


def aug_train(d: str = "data/synthetic_v2",
              aug_d: str = "data/synthetic_v2_aug") -> Dict:
    """``configs/synthetic_v2/cnn14rnn_trm.yaml`` with the ``data.train_aug``
    and ``aug`` nodes of ``configs/synthetic/aug.yaml`` and its experiment
    directory (under ``experiments/synthetic_v2/``): corpus v2 in ``d``,
    its speed-perturbed copy in ``aug_d`` (aug.yaml's ``data/synthetic_aug/``;
    its vocabulary, aug.yaml's ``data/synthetic/vocab.pkl``, is ``d``'s).
    The one change from aug.yaml's node: its loader sends the waves as
    float16 (``collate_fn.args.wire_dtype``), as the train loader of
    ``synthetic_v2/train_data.yaml`` does, which is exact, since the copy
    holds float16 values (``write_wave``); a float32 aug batch (32 x 11.5
    s, 47 MB) takes ~0.5 s through the loader workers' pipe on the card's
    host, float16 ~0.09 s."""
    cfg = recipe("synthetic_v2/cnn14rnn_trm.yaml", d)
    aug = load_config(str(CONFIGS / "synthetic/aug.yaml"))
    train_aug = _moved(aug["data"]["train_aug"], "data/synthetic_aug/",
                       aug_d.rstrip("/") + "/")
    cfg["data"]["train_aug"] = _moved(train_aug, "data/synthetic/",
                                      d.rstrip("/") + "/")
    cfg["aug"] = aug["aug"]
    cfg["experiment_path"] = _moved(aug["experiment_path"],
                                    "experiments/synthetic/",
                                    "experiments/synthetic_v2/")
    cfg["data"]["train_aug"]["collate_fn"]["args"]["wire_dtype"] = {
        "wav": "float16"}
    return cfg


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
    runner's loader and ``train_step`` (with a ``data.train_aug`` node,
    ``aug_train_step`` on the interleaved loaders) after ``warmup``: wall
    ms a step (loader included) and the device's busy ms a step from a
    ``torch.profiler`` trace -> {step_ms, device_ms, idle_share} (empty
    off CUDA)."""
    from torch.profiler import ProfilerActivity, profile
    from audiocaption_tpu_torch.cli.run import (
        Runner, build_dataloader, to_device)
    from audiocaption_tpu_torch.losses.loss import build_loss
    from audiocaption_tpu_torch.training.aug_runner import (
        aug_train_step, interleave_loaders)
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
    if "train_aug" in run.cfg["data"]:
        batches = interleave_loaders(run.train_loader, build_dataloader(
            run.cfg["data"]["train_aug"], run.tokenizer))

        def step(pair):
            aug_train_step(state, loss_fn, to_device(pair[0], run.device),
                           to_device(pair[1], run.device), 0.5)
    else:
        batches = iter(run.train_loader)

        def step(batch):
            train_step(state, loss_fn, to_device(batch, run.device),
                       ss_ratio=ratio, generator=gen)
    batches = itertools.islice(batches, warmup + steps)
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
    fn = {"flagship": sc.generate_v2, "temporal": sc.generate_temporal,
          "v1": sc.generate}[kind]
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


def run_aug(data: Path, results: Path, overrides: List[str],
            sizes=(3000, 300, 300), duration: float = 10.0,
            aug_data: Path = None, stop_epoch: int = None) -> Dict:
    """Corpus v2 (generated unless ``data`` holds it), its speed-perturbed
    copy in ``aug_data`` (``cli/data_tools.py speed_perturb --compute`` of
    the train split, unless it is there), the augmented recipe
    (:func:`aug_train`) through ``Runner.train_aug``, then
    ``Runner.evaluate`` of ``best.pth`` and ``swa.pth`` at beam 3.  With
    ``stop_epoch``, the head of the run (``Runner.train_aug``'s
    ``stop_epoch``): only ``best.pth`` is scored, since ``swa.pth`` is
    not the recipe's, and no steps are profiled."""
    from audiocaption_tpu_torch.cli.data_tools import speed_perturb
    from audiocaption_tpu_torch.cli.run import Runner
    record: Dict = {"card": card_name(), "stop_epoch": stop_epoch}
    _corpus("flagship", data, sizes, duration, record)
    aug_data = aug_data or Path(f"{data}_aug")
    if (aug_data / "train_text.json").exists():
        record["aug_corpus_s"] = None
    else:
        t0 = time.perf_counter()
        out = speed_perturb(str(data), str(aug_data), compute=True,
                            wav_csv=str(data / "train_wav.csv"),
                            text_json=str(data / "train_text.json"))
        # the names aug.yaml's data.train_aug reads
        Path(out["wav_csv"]).replace(aug_data / "train_wav.csv")
        Path(out["text_json"]).replace(aug_data / "train_text.json")
        record["aug_corpus_s"] = time.perf_counter() - t0
        record["disk_free_gb_after_aug"] = shutil.disk_usage(
            aug_data).free / 2**30
    train_cfg = aug_train(str(data), str(aug_data))
    runner = Runner()
    t0 = time.perf_counter()
    exp = Path(runner.train_aug(train_cfg, *overrides,
                                stop_epoch=stop_epoch))
    record["train_s"] = time.perf_counter() - t0
    _copy(exp / "train.log", results / "train.log")
    dev = [o for o in overrides if o.startswith("device=")]
    for resume in ("best",) if stop_epoch else ("best", "swa"):
        t0 = time.perf_counter()
        scores = runner.evaluate(
            str(exp), flagship_test(str(data)), *dev,
            f"resume={resume}.pth",
            f"caption_output=predictions/{resume}_beam3.json",
            f"score_output=results/{resume}_beam3.txt")
        record[f"test_{resume}"] = {k: v for k, v in scores.items()
                                    if isinstance(v, float)}
        record[f"evaluate_{resume}_s"] = time.perf_counter() - t0
        _copy(exp / f"results/{resume}_beam3.txt",
              results / f"{resume}_beam3.txt")
        # what is done so far, should a time limit cut the run
        (results / "run.json").write_text(json.dumps(record, indent=1))
    if not stop_epoch:
        record["profile"] = profile_steps(train_cfg, overrides)
    return record


def _scores(runner, exp: Path, test_cfg: Dict, dev: List[str],
            results: Path, record: Dict, name: str) -> None:
    """``Runner.evaluate`` of ``exp``'s best and SWA checkpoints at beam 3
    into ``record`` and ``results/{name}/``."""
    for resume in ("swa", "best"):
        t0 = time.perf_counter()
        scores = runner.evaluate(
            str(exp), test_cfg, *dev, f"resume={resume}.pth",
            f"caption_output=predictions/{resume}_beam3.json",
            f"score_output=results/{resume}_beam3.txt")
        record[f"{name}_test_{resume}"] = {
            k: v for k, v in scores.items() if isinstance(v, float)}
        record[f"{name}_evaluate_{resume}_s"] = time.perf_counter() - t0
        _copy(exp / f"results/{resume}_beam3.txt",
              results / f"{name}/{resume}_beam3.txt")
    _copy(exp / "train.log", results / f"{name}/train.log")
    (results / "run.json").write_text(json.dumps(record, indent=1))


def run_m2(data: Path, results: Path, overrides: List[str],
           sizes=(2000, 200, 200), duration: float = 10.0) -> Dict:
    """Corpus v1, the source ``cnn14rnn_trm`` trained and scored, its
    features extracted (npy), the M2 transformer trained on them and
    scored (see the module docstring)."""
    from audiocaption_tpu_torch.cli.prepare_features import (
        experiment_encoder, write_features)
    from audiocaption_tpu_torch.cli.run import Runner
    from audiocaption_tpu_torch.device import resolve_device
    record: Dict = {"card": card_name()}
    results.mkdir(parents=True, exist_ok=True)
    (results / "card.txt").write_text(record["card"] + "\n")
    _corpus("v1", data, sizes, duration, record)
    dev = [o for o in overrides if o.startswith("device=")]
    m2_over = dev + [o[len("m2."):] for o in overrides
                     if o.startswith("m2.")]
    overrides = [o for o in overrides if not o.startswith("m2.")]
    runner = Runner()
    t0 = time.perf_counter()
    exp = Path(runner.train(m2_source_train(str(data)), *overrides))
    record["source_train_s"] = time.perf_counter() - t0
    _scores(runner, exp, m2_source_test(str(data)), dev, results, record,
            "cnn14rnn_trm")
    device = resolve_device(dev[-1][len("device="):] if dev else "cuda")
    t0 = time.perf_counter()
    encode, bucket = experiment_encoder(str(exp), "swa.pth", device)
    for split in ("train", "val", "test"):
        write_features(str(data / f"{split}_wav.csv"),
                       str(data / "features_cnn14rnn" / split), encode,
                       bucket, device, batch_size=32, fmt="npy")
    record["prepare_features_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    m2_exp = Path(runner.train(m2_train(str(data)), *m2_over))
    record["m2_train_s"] = time.perf_counter() - t0
    _scores(runner, m2_exp, m2_test(str(data)), dev, results, record, "m2_trm")
    return record


def run_encoders(data: Path, results: Path, overrides: List[str],
                 sizes=(2000, 200, 200), duration: float = 10.0,
                 names=tuple(ENCODER_NODES)) -> Dict:
    """Corpus v1, then for each encoder of ``names`` its
    :func:`encoders_train` captioner trained and its SWA and best
    checkpoints scored at beam 3 (:func:`encoders_test`)."""
    from audiocaption_tpu_torch.cli.run import Runner
    record: Dict = {"card": card_name()}
    results.mkdir(parents=True, exist_ok=True)
    _corpus("v1", data, sizes, duration, record)
    dev = [o for o in overrides if o.startswith("device=")]
    runner = Runner()
    for name in names:
        t0 = time.perf_counter()
        exp = Path(runner.train(encoders_train(str(data), name), *overrides))
        record[f"{name}_train_s"] = time.perf_counter() - t0
        _scores(runner, exp, encoders_test(str(data), name), dev, results,
                record, f"{name}_trm")
    return record


def main(argv=None) -> Dict:
    parser = argparse.ArgumentParser(
        prog="audiocaption_tpu_torch.cli.recipes")
    parser.add_argument("recipe", choices=("flagship", "temporal", "aug",
                                           "m2", "encoders"))
    parser.add_argument("--data", required=True)
    parser.add_argument("--aug_data", default=None,
                        help="aug: the speed-perturbed copy's directory "
                             "(default: DATA_aug)")
    parser.add_argument("--stop_epoch", type=int, default=None,
                        help="aug: end training after this epoch, the "
                             "schedules still those of all epochs")
    parser.add_argument("--results", required=True)
    parser.add_argument("--sizes", default=None,
                        help="train,val,test clips of a corpus to generate "
                             "(default: the recorded 3000,300,300 / "
                             "2000,200,200)")
    parser.add_argument("--duration", type=float, default=10.0)
    parser.add_argument("--encoders", default=",".join(ENCODER_NODES),
                        help="encoders: which of the item-8 encoders to "
                             "train, comma-separated")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_intermixed_args(argv)
    run = {"flagship": run_flagship, "temporal": run_temporal,
           "aug": run_aug, "m2": run_m2,
           "encoders": run_encoders}[args.recipe]
    kw = {"duration": args.duration}
    if args.recipe == "encoders":
        kw["names"] = tuple(args.encoders.split(","))
    if args.recipe == "aug":
        kw.update(stop_epoch=args.stop_epoch,
                  aug_data=Path(args.aug_data) if args.aug_data else None)
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
