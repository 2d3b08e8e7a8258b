"""The port's training and evaluation CLI (counterpart of
``audiocaption_tpu/cli/run.py``).

    python -m audiocaption_tpu_torch.cli.run train [--config] CONFIG \
        [key=value ...]

CONFIG is a reference-layout YAML (``configs/*/effb2_trm.yaml``): model,
data, optimizer, lr_scheduler, trainer, scheduled_sampling, loss and swa
nodes.  Overrides are dotted ``key=value`` pairs with YAML values.  The
run is on the card; ``device=cpu`` (an override, or a ``device:`` key in
the config) runs it on the CPU.  Written under
``{experiment_path}/seed_{seed}/``: ``config.yaml``, ``train.log`` (a
line an epoch: loss, val_cider, ss ratio), ``last.pth`` every epoch,
``best.pth`` when ``val_cider`` improves, and ``swa.pth`` at the end
(the average from epoch ``swa.start``, or the last weights without SWA).
Each epoch's line splits its time into steps (the loader's wait inside
them), val and the wait for the previous checkpoint, with the peak device
memory on CUDA.  A temporal captioner (``configs/synthetic_temporal/
tempgru.yaml``: ``TemporalBahAttnDecoder`` on a temporal-tag dataset)
trains on each batch's ``temporal_tag`` and its val score decodes with
the val set's tags.  A conditioned GRU decoder trains on each batch's
``condition`` (``ConditionCaptionDataset``), ``style`` or ``structure``;
its val score decodes with none, as the JAX runner's.  A conditioned
transformer decoder (``EventTransformerDecoder``,
``KeywordProbTransformerDecoder``) trains on each batch's ``event`` or
``keyword`` (``KeywordProbCaptionDataset``; the keyword rides the
decoder's ``event`` argument), and its val score, ``evaluate`` and
``predict`` decode it with no condition, as the JAX runner's do (ROADMAP
Queue 3 L); ``models/captioner.py::generate(..., cond_kwargs={"event":
...})`` is the conditioned decode.  A style captioner
(``StyleCaptionModel``) infers each caption's style from the caption
itself in training; its val score decodes with none (the decoder's
``fc_emb`` slot).

A model node of type ``ScstWrapper`` (``configs/*/scst.yaml``) trains
the wrapped model by self-critical sequence training instead
(``training/scst.py``), as the JAX runner's ``rl_train`` branch does: the
``rl:`` node's ``max_length`` and ``sample_temp``, rewards by the native
CIDEr-D scorer against the train captions, samples drawn from a
generator seeded with ``seed + 17``; the epoch's logged loss is minus the
mean sampled reward.  ``resume`` with ``trainer.finetune: True`` (the
recipe's) starts from an XE run's weights.  A GRU decoder's SCST runs on
the torch engine (no kernel decodes a GRU).

The validation score greedy-decodes the val set and scores CIDEr-D
(the native scorer) against its captions.  On CUDA the decode runs the
hand-written greedy kernel (``decoding/fused_greedy.py::
FusedGreedyDecoder``), its weights packed anew at each score because the
optimizer has moved them; on the CPU it runs the torch engine
(``models/captioner.py::generate``).  The SCST baseline runs the same
kernel on CUDA, one decoder re-packed before each step.

Knowledge distillation (the JAX runner's ``train_kd``):

    python -m audiocaption_tpu_torch.cli.run train_kd CONFIG [key=value ...]

CONFIG adds a ``kd:`` node (``configs/*/kd_token.yaml``): ``type`` token,
seq or enc; ``weight``; ``kd_loss`` (kl, l2, l1) and ``temperature`` for
token KD; ``teacher: {experiment_path, resume}``, an experiment directory
that either package wrote (its ``config.yaml`` and checkpoint); for enc
KD ``teacher_emb`` (an npz of audio_id -> embedding) or the teacher's
encoder on the fly, ``shared_dim`` and ``unsup``.  The teacher runs in
``eval()`` without autograd: teacher-forced logits for token KD, greedy
captions for seq KD (through the greedy kernel on CUDA, cached in
``pseudo_captions.json``), its pooled ``fc_emb`` for enc KD
(``training/distill.py``).  Written: ``train.log`` (``kd[type] epoch N:
loss ... val_cider ...``), ``last.pth``, ``best.pth`` and ``swa.pth``
(the last weights), with the JAX runner's payload.  The teacher reads
the student's wave, as the JAX runner's does; a KD dataset's
``teacher_wav`` is not used by it.

Evaluation and inference (the JAX runner's, with its flag forms):

    python -m audiocaption_tpu_torch.cli.run predict --experiment_path EXP \
        --eval_config configs/*/test.yaml [key=value ...]
    python -m audiocaption_tpu_torch.cli.run evaluate --experiment_path EXP \
        --eval_config configs/*/test.yaml [key=value ...]
    python -m audiocaption_tpu_torch.cli.run ensemble_predict \
        --eval_config configs/*/ensemble.yaml   # also ensemble_evaluate,
                                                # dcase_predict
    python -m audiocaption_tpu_torch.cli.run export_hf --experiment_path EXP \
        --output pytorch_model.bin [--resume swa.pth]
    python -m audiocaption_tpu_torch.cli.run debug --config CONFIG

``predict`` decodes ``data.test`` with the experiment's ``resume``
checkpoint (default ``swa.pth``) and ``inference_args`` (default beam 3)
and writes ``caption_output`` (``{"predictions": [{filename, caption}]}``)
under the experiment; ``evaluate`` adds ``metrics/eval.py::
evaluate_captions`` against ``data.test.caption`` into ``score_output``.
On CUDA the decode runs the hand-written kernels where they serve
(greedy; beam with temp 1 and at most 8 beams: ``decoding/select.py``),
on the CPU the torch engine.  The ensemble commands decode with the mean
per-step log-softmax of the members (``decoding/ensemble.py``, the torch
engine), the members paths or ``{path, resume}``; ``dcase_predict``
writes the ``file_name,caption_predicted`` csv.  ``export_hf`` writes an
EffB2-Transformer experiment as the HF checkpoint's state dict.  The
config's ``device`` (an override ``device=cpu``) picks the device, the
card by default.  The experiment loader is split so that a model can be
built without PyYAML: :func:`read_experiment` reads the directory,
:func:`experiment_model` builds from a config dict and a checkpoint.

The temporal-tag pipeline (the JAX runner's SED training and temporal
evaluation):

    python -m audiocaption_tpu_torch.cli.run train_sed CONFIG \
        [key=value ...]                 # configs/synthetic_temporal/sed.yaml
    python -m audiocaption_tpu_torch.cli.run evaluate_temporal \
        --experiment_path EXP --sed_experiment_path SED_EXP \
        --eval_config configs/synthetic_temporal/test.yaml [key=value ...]

``train_sed`` trains the Cnn8-RNN SED net framewise on the corpus's event
segments (``training/sed_trainer.py``: a float16 log-mel bank on the
device through the log-mel kernel, BCE, Adam), keeping ``best.pth`` by
the val tag accuracy of the host tag pipeline.  ``predict_temporal``
decodes with the tags the SED experiment's net gives each clip and, where
the dataset carries ground-truth tags, writes the tag accuracy to
``tag_output``; ``evaluate_temporal`` adds the caption metrics.

Every method that reads a config takes a path or a config dict.

Augmented training (the JAX runner's ``train_aug``):

    python -m audiocaption_tpu_torch.cli.run train_aug --config \
        configs/synthetic/aug.yaml [key=value ...]

CONFIG adds a ``data.train_aug`` loader (e.g. a speed-perturbed copy of
the train split, ``cli/data_tools.py speed_perturb --compute``) and an
``aug: {discount, mode}`` node; each step takes a real and an augmented
batch and one backward of ``real + discount * aug``
(``training/aug_runner.py``).  Written: ``train.log`` (``aug epoch N:
loss ... val_cider ... discount ...``), ``last.pth``, ``best.pth`` and
``swa.pth`` (the last weights).  A config's ``specaug: True`` applies
SpecAugment to the log-mel in ``train``'s XE steps (``ops/specaug.py``),
as the JAX runner does; a dataset's ``transforms`` build a chain of the
augment registry (``data/augment.py``), reseeded in each loader worker.

The input pipeline, as the JAX runner's: a loader with
``device_resident: True`` (``data.train``, ``data.val``,
``data.train_aug``) puts its whole corpus on the device once as a float16
bank (``data/device_bank.py``), its items then carry bank rows, gathered
on the device by the step and the val scorer; the train loops and the
val scorer take their batches through ``data/prefetch.py::
prefetch_to_device`` (a worker thread loads and copies the next batch
while the device runs this one).  A model over precomputed features
(``RnnEncoder``, ``AudioTransformerEncoder``, ``M2TransformerEncoder``:
``cli/prepare_features.py`` writes them) trains, scores and evaluates
through the same paths; without ``encoder.args.input_dim`` its input
width is read off the first train row (the log says which).  An
``EfficientNetB2`` encoder with ``args.prune_ratio`` is pruned after the
pretrained weights load (``utils/config.py::apply_pruning``), in training
and when an experiment is read back.

``resume`` with ``trainer.finetune: False`` is a full resume: besides the
weights, the epoch (training goes on from the next), the monitor's best,
``not_improve_cnt``, the update count ``lr_count`` (the learning rate
and, unlike the JAX runner, the scheduled-sampling ratio follow it) and,
where the checkpoint holds one (``trainer.include_optim_in_ckpt: True``
writes it), the optimizer's state.

Data parallelism: ``train`` run by ``torchrun`` (``torchrun
--nproc_per_node=N -m audiocaption_tpu_torch.cli.run train CONFIG``)
trains one replica a rank over NCCL on the cards (gloo for
``device=cpu``), as the JAX runner does over the devices it sees
(``audiocaption_tpu/cli/run.py:272-276, 394-396``): every rank's loader
yields the global batch (the ranks share rank 0's host RNG state at each
epoch), padded by repeating leading rows to a multiple of the world size
and sliced per rank (``parallel/mesh.py``); the step is the global
batch's (each mean of the loss over the global batch's count, the
per-row draws the global batch's, gradients summed, cross-rank batch
norm; ``training/trainer.py``); rank 0 alone scores, logs and writes the
checkpoints, and tells the others when to stop early.  Device-resident
banks are off under it, and SCST, KD, augmented and SED training refuse
it: they run in one process.  Each epoch line
ends with the host's resident-set size (``rss``), as the JAX runner's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import random
import shutil
import time
from pathlib import Path
from typing import (
    Callable, Dict, Iterable, Iterator, List, Optional, Tuple, Union)

import numpy as np
import torch

from audiocaption_tpu_torch.data.augment import build_transforms, seed_worker
from audiocaption_tpu_torch.data.collate import TextCollate, VarLenPadCollate
from audiocaption_tpu_torch.data.dataset import (
    CaptionDataset, InferenceDataset, WavCaptionDataset, load_caption_json)
from audiocaption_tpu_torch.data.device_bank import bank_rows, build_wav_bank
from audiocaption_tpu_torch.data.prefetch import prefetch_to_device
from audiocaption_tpu_torch.data.tokenizer import DictTokenizer
from audiocaption_tpu_torch.decoding.ensemble import ensemble_generate
from audiocaption_tpu_torch.decoding.select import (
    LoaderDecoder, decode_batches)
from audiocaption_tpu_torch.device import resolve_device
from audiocaption_tpu_torch.losses.kd import ContraEncoderKdHead
from audiocaption_tpu_torch.losses.loss import build_loss
from audiocaption_tpu_torch.metrics.eval import evaluate_captions
from audiocaption_tpu_torch.metrics.tokenize import ptb_tokenize
from audiocaption_tpu_torch.models.convert import load_reference_state_dict
from audiocaption_tpu_torch.models.transformer_decoder import (
    TransformerDecoder)
from audiocaption_tpu_torch.models.zoo import random_init
from audiocaption_tpu_torch.native import FastCiderD
from audiocaption_tpu_torch.optim.schedules import build_schedule
from audiocaption_tpu_torch.parallel.mesh import (
    data_parallel_context, init_distributed, launched_by_torchrun,
    pad_to_world, rank_and_size, shard_batch)
from audiocaption_tpu_torch.training.checkpoint import (
    AsyncCheckpointer, MetricImprover, load_checkpoint, merge_variables,
    model_variables, save_checkpoint)
from audiocaption_tpu_torch.training.distill import (
    encoder_kd_step, generate_pseudo_captions, teacher_captions,
    teacher_embedding, teacher_logits, token_kd_step)
from audiocaption_tpu_torch.training.scst import scst_step
from audiocaption_tpu_torch.training.swa import swa_init, swa_update
from audiocaption_tpu_torch.training.trainer import (
    batch_wav, create_train_state, train_step)
from audiocaption_tpu_torch.utils.profiling import host_rss_gb
from audiocaption_tpu_torch.utils.config import (
    apply_pruning, build_model_from_config, feature_input_dim, load_config,
    resolve_config, short_type)

Config = Union[str, Dict]


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def build_tokenizer(cfg: Dict) -> DictTokenizer:
    t = short_type(cfg.get("type", "DictTokenizer"))
    if t != "DictTokenizer":
        raise ValueError(f"tokenizer {t!r} is not ported yet")
    args = cfg.get("args", {}) or {}
    return DictTokenizer(args.get("tokenizer_path"),
                         args.get("max_length", 20))


def build_dataset(cfg: Dict):
    """A dataset node {type, args} -> the dataset.  ``args.transforms``
    (a flat list of {type, args}, or the reference's per-feature dict
    ``{wav: [...]}`` whose chains may be null) becomes one chain from the
    augment registry (``data/augment.py::build_transforms``)."""
    t = short_type(cfg["type"])
    args = dict(cfg.get("args", {}) or {})
    transforms = args.pop("transforms", None)
    if isinstance(transforms, dict):     # the reference's {wav: [...]}
        transforms = [s for chain in transforms.values() if chain
                      for s in chain]
    if transforms:
        args["transforms"] = build_transforms(transforms)
    if t == "CaptionDataset":
        return CaptionDataset(**args)
    if t == "InferenceDataset":
        return InferenceDataset(**args)
    if t in ("WavCaptionDataset", "CaptionWavReadDataset"):
        return WavCaptionDataset(**args)
    if t in ("CaptionKdDataset", "InferKdDataset"):
        from audiocaption_tpu_torch.data import kd_dataset
        return getattr(kd_dataset, t)(**args)
    if t in ("ConditionCaptionDataset", "RandomConditionDataset",
             "TemporalTagCaptionDataset", "TemporalTagInferenceDataset",
             "KeywordProbCaptionDataset", "KeywordProbInferenceDataset"):
        from audiocaption_tpu_torch.data import condition_dataset
        return getattr(condition_dataset, t)(**args)
    raise ValueError(f"dataset {t!r} is not ported yet")


def build_collate(cfg: Dict, tokenizer=None, wav_bucket: int = 16000):
    t = short_type(cfg["type"])
    args = dict(cfg.get("args", {}) or {})
    kw = dict(sort_key=args.get("sort_key"), buckets={"wav": wav_bucket},
              wire_dtype=args.get("wire_dtype"),
              feature_bucket=args.get("feature_bucket", 16))
    if t == "TextCollate":
        return TextCollate(tokenizer, text_key=args.get("text_key", "cap"),
                           pad_keys=args.get("pad_keys", []), **kw)
    if t == "VarLenPadCollate":
        return VarLenPadCollate(pad_keys=args.get("pad_keys", []), **kw)
    raise ValueError(f"collate {t!r} is not ported yet")


def build_dataloader(data_cfg: Dict, tokenizer=None, train: bool = True):
    from torch.utils.data import DataLoader
    dataset = build_dataset(data_cfg["dataset"])
    collate = build_collate(data_cfg["collate_fn"], tokenizer)
    dl_args = dict(data_cfg.get("dataloader_args", {}) or {})
    num_samples = dl_args.pop("num_samples", None)
    dl_args.setdefault("batch_size", 32)
    if getattr(dataset, "transforms", None):
        dl_args["worker_init_fn"] = seed_worker   # a stream per worker
    if train and num_samples:
        # a fixed number of samples an epoch, wraparound shuffle
        from audiocaption_tpu_torch.data.kd_dataset import (
            IterationBatchSampler)
        sampler = IterationBatchSampler(
            dataset, dl_args.pop("batch_size"), num_samples,
            shuffle=dl_args.pop("shuffle", True))
        return DataLoader(dataset, collate_fn=collate,
                          batch_sampler=sampler, **dl_args)
    if not train:
        dl_args["shuffle"] = False
    return DataLoader(dataset, collate_fn=collate, drop_last=train,
                      **dl_args)


def to_device(batch: Dict, device: torch.device,
              bank: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """A collated batch (numpy arrays or tensors, on the host or already
    on ``device``) -> the train step's tensors on ``device``: the wave
    (rows ``wav_idx`` of ``bank`` when the batch carries them) widened to
    float32 (a float16 wire as is, int16 / 32768), lengths, ids, temporal
    tags and structure ids as int64, a ``condition``, ``style``,
    ``event`` or ``keyword`` as float32 (the JAX runner's step keys)."""
    out = batch_wav(
        {"wav_idx": torch.as_tensor(batch["wav_idx"]).to(device),
         "wav_bank": bank} if "wav_idx" in batch
        else {"wav": torch.as_tensor(batch["wav"]).to(device)})
    for k in ("wav_len", "cap", "cap_len", "temporal_tag", "structure"):
        if k in batch:
            out[k] = torch.as_tensor(batch[k]).to(device, torch.long)
    for k in ("condition", "style", "event", "keyword"):
        if k in batch:
            v = batch[k]
            v = v if torch.is_tensor(v) else np.asarray(v, np.float32)
            out[k] = torch.as_tensor(v).to(device, torch.float32)
    return out


def _single_process(mode: str) -> None:
    """Refuse ``torchrun`` for a training ``mode`` that runs in one
    process, as the JAX runner's does."""
    if launched_by_torchrun():
        raise RuntimeError(f"{mode} runs in one process; only the XE "
                           "training of Runner.train runs under torchrun")


def _from_rank0(t: torch.Tensor) -> torch.Tensor:
    """Rank 0's copy of the host tensor ``t`` (through the card for
    NCCL)."""
    dev = t.cuda() if torch.distributed.get_backend() == "nccl" else t
    torch.distributed.broadcast(dev, src=0)
    return dev.cpu()


def _share_host_rng() -> None:
    """Every rank takes rank 0's host RNG state (the loader's shuffle
    draws from it, and rank 0 alone draws for its val loader)."""
    torch.set_rng_state(_from_rank0(torch.get_rng_state()))


def _broadcast_flag(flag: bool) -> bool:
    """Rank 0's ``flag``, on every rank."""
    return bool(_from_rank0(torch.tensor([int(flag)])).item())


def _make_logger(path: Path) -> Callable[[str], None]:
    def log(msg: str) -> None:
        line = f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] {msg}"
        print(line, flush=True)
        with open(path, "a") as f:
            f.write(line + "\n")
    return log


def unwrap_pretrained(ckpt, kind: str) -> Dict:
    """A pretrained file's contents -> the state dict of its part, by the
    JAX ``load_pretrained_into``'s adapters: ``{"model": sd}`` (PANNs; a
    COLA file's ``backbone.*`` keys, when it has any, with the prefix
    taken off and the rest dropped), ``{"state_dict": sd}`` (BLAT: the
    keys holding ``audio_encoder``, that word and its dot taken out), a
    plain state dict; for a ``decoder`` part a ``decoder.`` prefix on the
    first key is taken off the keys that have it (the rest dropped).  The
    port's modules carry the reference checkpoint keys that the JAX
    converters read, so the kinds ``cnn14``, ``effb2``, ``htsat``,
    ``esresnext`` and ``raw`` load as they are; ``uit`` goes under the
    ``UitEncoder``'s ``trunk.`` (position tables of another length are
    then skipped by shape, as the JAX ``convert_uit`` without a model
    leaves them to the shape-checked merge)."""
    if isinstance(ckpt, dict) and "model" in ckpt:
        sd = ckpt["model"]
        if any(k.startswith("backbone.") for k in sd):
            sd = {k[len("backbone."):]: v for k, v in sd.items()
                  if k.startswith("backbone.")}
    elif isinstance(ckpt, dict) and "state_dict" in ckpt:
        sd = {k.replace("audio_encoder.", ""): v
              for k, v in ckpt["state_dict"].items() if "audio_encoder" in k}
    else:
        sd = ckpt
    if kind == "decoder" and sd and next(iter(sd)).startswith("decoder."):
        sd = {k[len("decoder."):]: v for k, v in sd.items()
              if k.startswith("decoder.")}
    if kind == "uit":
        sd = {"trunk." + k: v for k, v in sd.items()}
    return sd


def load_pretrained(model, spec) -> int:
    """A pretrained spec (the dotted path of a submodule, e.g.
    ``encoder.cnn``, a checkpoint path, its kind) into the model: the
    file unwrapped (:func:`unwrap_pretrained`), then its entries of
    matching name and shape loaded.  Returns how many tensors it filled;
    a file that fills none raises."""
    part, path, kind = spec
    sd = unwrap_pretrained(torch.load(path, map_location="cpu",
                                      weights_only=False), kind)
    module = model.get_submodule(part)
    own = module.state_dict()
    hits = [k for k, v in sd.items() if k in own
            and tuple(np.shape(v)) == tuple(own[k].shape)]
    if not hits:
        raise ValueError(f"pretrained {path} fills none of the {len(own)} "
                         f"tensors of {part} ({kind}); its first keys: "
                         f"{list(sd)[:4]}")
    module.load_state_dict(merge_variables(own, sd))
    return len(hits)


def read_experiment(experiment_path: str, resume: str) -> Tuple[Dict, Dict]:
    """An experiment directory that either package wrote -> (its
    ``config.yaml`` as a dict, the checkpoint ``resume`` as
    ``load_checkpoint`` reads it).  Needs PyYAML."""
    exp_dir = Path(experiment_path)
    return (load_config(str(exp_dir / "config.yaml")),
            load_checkpoint(str(exp_dir / resume)))


def experiment_model(cfg: Dict, ckpt: Dict, device: torch.device
                     ) -> Tuple[torch.nn.Module, DictTokenizer]:
    """A config dict and a checkpoint payload -> (the model its ``model``
    node builds, with the checkpoint's weights, on ``device`` in
    ``eval()``; the checkpoint's tokenizer).  An ``ScstWrapper`` node is
    read as the model it wraps.  Needs no PyYAML."""
    tokenizer = DictTokenizer()
    if ckpt.get("tokenizer"):
        tokenizer.load_state_dict(ckpt["tokenizer"])
        tokenizer.loaded = True
    model, _ = build_model_from_config(
        cfg["model"], vocab_size=len(tokenizer),
        input_dim=checkpoint_input_dim(ckpt["variables"]))
    apply_pruning(model, cfg["model"])
    load_reference_state_dict(model, ckpt["variables"])
    return model.to(device).eval(), tokenizer


def checkpoint_input_dim(variables: Dict) -> Optional[int]:
    """The input width of a feature encoder's checkpoint (its first
    layer's weight), or None for any other encoder."""
    for key in ("encoder.input_proj.weight", "encoder.attn_proj_dense.weight",
                "encoder.network.weight_ih_l0"):
        if key in variables:
            return int(np.shape(variables[key])[1])
    return None


def host_copy(tree):
    """``tree`` (dicts, lists, tuples) with every tensor copied to the
    host now: a snapshot that later updates do not reach."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return tree


def bank_batches(batches: Iterable[Dict], bank: Optional[torch.Tensor]
                 ) -> Iterator[Dict]:
    """``batches`` with each ``wav`` gathered from ``bank`` by the batch's
    ``wav_idx`` (float32), or as they are without a bank."""
    for batch in batches:
        if bank is not None and "wav_idx" in batch:
            batch = dict(batch, wav=bank_rows(
                bank, torch.as_tensor(batch["wav_idx"])))
        yield batch


def export_hf_checkpoint(model, output: str) -> str:
    """An EffB2 + ``TransformerDecoder`` captioner -> the HF checkpoint's
    state dict (``model.model.encoder.backbone.eff_net.*`` and
    ``model.model.decoder.*``, the key space the model already has,
    tensor for tensor what the JAX ``export_hf`` writes), saved at
    ``output``; ``Effb2TrmCaptioningModel.load_torch_checkpoint`` of
    either package reads it.  Other families raise."""
    from audiocaption_tpu_torch.models.effb2 import EfficientNetB2
    if not (isinstance(model.encoder, EfficientNetB2)
            and type(model.decoder) is TransformerDecoder):
        raise ValueError(
            "export_hf supports the EffB2+TransformerDecoder family (the "
            f"HF zoo format); got {type(model.encoder).__name__}+"
            f"{type(model.decoder).__name__}")
    sd = model_variables(model)
    out_path = Path(output)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()}, out_path)
    print(f"exported {len(sd)} tensors to {out_path}")
    return str(out_path)


def write_scores(path: Path, result: Dict) -> None:
    """``metric: value`` lines, the float results only (the JAX runner's
    scores txt)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for k, v in result.items():
            if isinstance(v, float):
                f.write(f"{k}: {v:.4f}\n")


def _inference_args(eval_cfg: Dict) -> Dict:
    return dict(eval_cfg.get("inference_args",
                             {"sample_method": "beam", "beam_size": 3}))


class ValScorer:
    """Greedy-decodes the val set with the model's current weights and
    returns the CIDEr-D score by the native scorer (the JAX runner's
    ``_make_val_scorer``).
    The model is in ``eval()`` while it decodes and back in ``train()``
    after.  Batches come through ``prefetch_to_device``; a device-resident
    val set's rows are gathered from ``wav_bank``.  ``last_seq`` holds the
    ids that the last call decoded, an int array [B, max_length] per val
    batch in the loader's order."""

    def __init__(self, model, tokenizer, val_loader, key2refs: Dict,
                 device: torch.device,
                 wav_bank: Optional[torch.Tensor] = None):
        self.model, self.tokenizer = model, tokenizer
        self.val_loader, self.key2refs = val_loader, key2refs
        self.device, self.wav_bank = device, wav_bank
        self.scorer = FastCiderD()
        self.last_seq: List[np.ndarray] = []

    def __call__(self) -> float:
        model = self.model
        # a decoder anew each call: the optimizer has moved the weights
        decoder = LoaderDecoder(model, self.device)
        key2pred = decoder.decode_loader(
            self.tokenizer, bank_batches(prefetch_to_device(
                self.val_loader, self.device), self.wav_bank),
            sample_method="greedy", max_length=model.special.max_length)
        self.last_seq = decoder.last_seq
        model.train()
        refs = {k: v for k, v in self.key2refs.items() if k in key2pred}
        preds = {k: v for k, v in key2pred.items() if k in refs}
        return self.scorer.compute_score(ptb_tokenize(refs),
                                         ptb_tokenize(preds))[0]


@dataclasses.dataclass
class RunSetup:
    """What every training run of the runner starts from (``_setup``)."""
    cfg: Dict
    device: torch.device
    seed: int
    exp_dir: Path
    log: Callable[[str], None]
    tokenizer: DictTokenizer
    train_loader: object
    val_loader: object
    val_key2refs: Dict
    model: torch.nn.Module
    epochs: int
    total_iters: int
    # create_train_state's arguments after the model
    opt: Dict
    # device-resident banks by loader name (data.train, data.val, ...)
    banks: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def add_bank(self, name: str, loader) -> None:
        """The bank of ``data.{name}`` on the device, when the config asks
        for it (``device_resident``); its loader's items then carry bank
        rows."""
        if not self.cfg["data"][name].get("device_resident"):
            return
        t0 = time.time()
        bank, lens = build_wav_bank(loader.dataset, self.device)
        loader.dataset.enable_wav_index(lens)
        self.banks[name] = bank
        self.log(f"{name} wav bank on {self.device}: {tuple(bank.shape)} "
                 f"{bank.dtype} ({time.time() - t0:.1f}s)")

class EpochClock:
    """The bookkeeping of a training epoch that ``Runner.train`` and
    ``Runner.train_aug`` share: the loader wait (:meth:`batches`), the
    val score (``ValScorer``) against the monitor (:meth:`score`), the
    checkpoint job on the writer's thread (:meth:`save`) and the time
    split that ends the epoch's log line (:meth:`split`)."""

    def __init__(self, run: RunSetup, mode: str = "max"):
        self.run = run
        self.val_score = ValScorer(run.model, run.tokenizer, run.val_loader,
                                   run.val_key2refs, run.device,
                                   run.banks.get("val"))
        self.monitor = MetricImprover(mode)
        self.ckpt_writer = AsyncCheckpointer()
        if run.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(run.device)

    def batches(self, batches: Iterable) -> Iterator:
        """``batches``, the epoch's clock started and the wait for each
        summed."""
        self.t0, self.t_load = time.time(), 0.0
        it = iter(batches)
        while True:
            t_wait = time.time()
            batch = next(it, None)
            self.t_load += time.time() - t_wait
            if batch is None:
                return
            yield batch

    def score(self) -> Tuple[float, bool]:
        """The val score, and whether it beats the best so far."""
        self.t_steps = time.time() - self.t0
        score = self.val_score()
        self.t_val = time.time() - self.t0 - self.t_steps
        return score, self.monitor(score)

    def save(self, improved: bool,
             after_save: Optional[Callable[[Dict], None]] = None,
             **ckpt_kw) -> Dict:
        """A host copy of the weights now -> that copy; on the writer's
        thread it goes to ``last.pth`` (with ``ckpt_kw`` and the
        tokenizer), to ``best.pth`` when ``improved``, then to
        ``after_save``."""
        run = self.run
        snap = model_variables(run.model)
        tokenizer_state = run.tokenizer.state_dict()

        def job():
            save_checkpoint(str(run.exp_dir / "last.pth"), snap,
                            tokenizer_state=tokenizer_state, **ckpt_kw)
            if improved:
                shutil.copyfile(run.exp_dir / "last.pth",
                                run.exp_dir / "best.pth")
            if after_save is not None:
                after_save(snap)
        self.t_blocked = self.ckpt_writer.submit(job)
        return snap

    def split(self) -> str:
        """The epoch's time split (and the peak memory on CUDA) for its
        log line."""
        device = self.run.device
        peak = (", peak {:.2f} GiB".format(
            torch.cuda.max_memory_allocated(device) / 2**30)
            if device.type == "cuda" else "")
        return (f"{time.time() - self.t0:.1f}s: steps {self.t_steps:.1f} "
                f"(loader wait {self.t_load:.1f}) val {self.t_val:.1f} "
                f"ckpt_wait {self.t_blocked:.1f}{peak}")


class Runner:

    def _start(self, config: Config, overrides
               ) -> Tuple[Dict, torch.device, int, Path,
                          Callable[[str], None]]:
        """The config (a path or a dict) with the overrides -> (config,
        device, seed, experiment directory, its log): seeded, the
        directory made, ``config.yaml`` written into it.  Under
        ``torchrun`` the process joins the group here, and only rank 0
        writes and logs."""
        import yaml
        cfg = resolve_config(config, overrides)
        device = resolve_device(cfg.get("device", "cuda"))
        seed = cfg.get("seed", 1)
        set_seed(seed)
        exp_dir = Path(cfg["experiment_path"]) / f"seed_{seed}"
        exp_dir.mkdir(parents=True, exist_ok=True)
        if launched_by_torchrun():
            init_distributed(device=device)
        if rank_and_size()[0] == 0:
            with open(exp_dir / "config.yaml", "w") as f:
                yaml.safe_dump(cfg, f)
            log = _make_logger(exp_dir / "train.log")
        else:
            log = lambda msg: None      # noqa: E731
        return cfg, device, seed, exp_dir, log

    def _setup(self, config: Config, overrides) -> RunSetup:
        """:meth:`_start`, then the tokenizer (it must have a vocabulary)
        and the loaders, the model from the config (seeded random weights,
        then any pretrained parts, then the pruning of an EffB2 with
        ``prune_ratio``, on the device; an ``ScstWrapper`` node is the
        model it wraps), the optimiser's settings (Adam with L2 decay, the
        clip, the schedule with a fifth of warm-up) and the device-resident
        banks of ``data.train`` and ``data.val`` (not under
        ``torchrun``)."""
        cfg, device, seed, exp_dir, log = self._start(config, overrides)
        tokenizer = build_tokenizer(
            cfg["data"]["train"]["collate_fn"]["tokenizer"])
        if not tokenizer.loaded:
            raise ValueError("tokenizer has no vocabulary; point "
                             "tokenizer_path at a vocab.pkl")
        train_loader = build_dataloader(cfg["data"]["train"], tokenizer)
        val_cfg = cfg["data"]["val"]
        val_loader = build_dataloader(val_cfg, train=False)

        input_dim = feature_input_dim(cfg["model"], train_loader.dataset)
        if input_dim is not None:
            log(f"encoder input width {input_dim}, from the first row of "
                "data.train (the config gives no encoder.args.input_dim)")
        model, pretrained = build_model_from_config(
            cfg["model"], vocab_size=len(tokenizer), input_dim=input_dim)
        random_init(model, torch.Generator().manual_seed(seed))
        for spec in pretrained:
            n = load_pretrained(model, spec)
            log(f"{spec[0]}: {n} tensors from {spec[1]}")
        if apply_pruning(model, cfg["model"]):
            log("encoder pruned: prune_ratio "
                f"{cfg['model']['encoder']['args']['prune_ratio']}, "
                f"{sum(p.numel() for p in model.encoder.parameters())} "
                "encoder parameters")

        trainer_cfg = cfg.get("trainer", {})
        epochs = trainer_cfg.get("epochs", 25)
        total_iters = epochs * len(train_loader)
        opt_args = cfg.get("optimizer", {}).get("args", {})
        base_lr = opt_args.get("lr", 5e-4)
        run = RunSetup(
            cfg=cfg, device=device, seed=seed, exp_dir=exp_dir,
            log=log, tokenizer=tokenizer,
            train_loader=train_loader, val_loader=val_loader,
            val_key2refs=load_caption_json(val_cfg["caption"],
                                           zh=cfg.get("zh", False)),
            model=model.to(device), epochs=epochs, total_iters=total_iters,
            opt=dict(base_lr=base_lr,
                     schedule=build_schedule(cfg.get("lr_scheduler", {}),
                                             base_lr, total_iters,
                                             total_iters // 5),
                     weight_decay=opt_args.get("weight_decay", 0.0),
                     max_grad_norm=trainer_cfg.get("max_grad_norm", 1.0)))
        if launched_by_torchrun():
            if cfg["data"]["train"].get("device_resident") or \
                    val_cfg.get("device_resident"):
                log("device_resident ignored under data parallelism")
        else:
            run.add_bank("train", train_loader)
            run.add_bank("val", val_loader)
        return run

    def train(self, config: Config, *overrides: str,
              stop_epoch: Optional[int] = None) -> str:
        """Train from a config (a path or a dict); returns the experiment
        directory.  ``stop_epoch`` ends the run after that epoch, the
        schedules still those of all ``trainer.epochs`` (the head of a run
        that a full resume continues)."""
        run = self._setup(config, overrides)
        cfg, device, seed, exp_dir, log = (run.cfg, run.device, run.seed,
                                           run.exp_dir, run.log)
        tokenizer, train_loader, model = (run.tokenizer, run.train_loader,
                                          run.model)
        epochs, total_iters = run.epochs, run.total_iters
        trainer_cfg = cfg.get("trainer", {})
        # an ScstWrapper node trains the model it wraps by SCST
        rl_train = short_type(cfg["model"].get("type", "")) == "ScstWrapper"
        if rl_train:
            _single_process("SCST")
        # data parallelism under torchrun (see the module docstring)
        parallel = data_parallel_context(model, device)
        rank, world = rank_and_size()
        if parallel is not None:
            log(f"data parallel: {world} rank(s), "
                f"{torch.distributed.get_backend()}")
        shard = (None if parallel is None else
                 lambda b: shard_batch(pad_to_world(b, world), rank, world))
        state = create_train_state(model, **run.opt)
        # the condition loss's gumbel draws and its discriminator's device
        loss_fn = build_loss(cfg.get("loss", {}), generator=torch.Generator(
            device=device).manual_seed(seed + 3), device=device)

        # scheduled sampling: on, the step gets a tensor ratio (the cached
        # path even at 1.0); off, the float 1.0 (teacher forcing)
        ss_cfg = cfg.get("scheduled_sampling", {"use": False})
        use_ss = bool(ss_cfg.get("use"))
        linear_ss = ss_cfg.get("mode", "linear") == "linear"
        ss_per_iter = (1.0 - ss_cfg.get("final_ratio", 0.7)) / total_iters
        ss_ratio = 1.0
        ss_gen = torch.Generator().manual_seed(seed + 1)
        # SpecAugment on the log-mel (the JAX runner's ``specaug`` key)
        specaug = bool(cfg.get("specaug", False))
        specaug_gen = torch.Generator(device=device).manual_seed(seed + 2)

        swa_cfg = cfg.get("swa", {"use": False})
        swa_state = None
        not_improve = 0
        early_stop = trainer_cfg.get("early_stop", 10)

        # resume: the weights of a checkpoint (this package's or the JAX
        # package's), entries of matching name and shape ("finetune"); a
        # full resume also the counters (see the module docstring)
        start_epoch = 1
        resumed = None
        if cfg.get("resume"):
            ckpt = load_checkpoint(cfg["resume"])
            load_reference_state_dict(model, merge_variables(
                model_variables(model), ckpt["variables"]))
            if not trainer_cfg.get("finetune", True):
                resumed = ckpt
                start_epoch = ckpt.get("epoch", 0) + 1
                not_improve = ckpt.get("not_improve_cnt", 0)
                if ckpt.get("optimizer"):
                    state.optimizer.load_state_dict(ckpt["optimizer"])
                state.restore_count(ckpt.get("lr_count", 0))
                if use_ss:
                    ss_ratio = (1.0 - ss_per_iter * state.lr_count
                                if linear_ss else
                                0.01 ** (state.lr_count / total_iters))
                log(f"resumed from {cfg['resume']} (epoch {start_epoch})")
            else:
                log(f"weights from {cfg['resume']}")

        if rl_train:
            rl_cfg = cfg.get("rl", {}) or {}
            rl_len = rl_cfg.get("max_length", 20)
            rl_temp = rl_cfg.get("sample_temp", 1.0)
            train_key2refs = load_caption_json(
                cfg["data"]["train"]["dataset"]["args"]["caption"],
                zh=cfg.get("zh", False))
            rl_scorer = FastCiderD()
            rl_gen = torch.Generator(device=device).manual_seed(seed + 17)
            baseline = None
            # the greedy kernel decodes a transformer; a GRU, the engine
            if device.type == "cuda" and type(model.decoder) is \
                    TransformerDecoder:
                from audiocaption_tpu_torch.decoding.fused_greedy import (
                    FusedGreedyDecoder)
                baseline = FusedGreedyDecoder(model, rl_len, device=device)

        clock = EpochClock(
            run, trainer_cfg.get("monitor_metric", {}).get("mode", "max"))
        monitor = clock.monitor
        if resumed is not None and resumed.get("monitor_state"):
            monitor.load_state_dict(resumed["monitor_state"])
        with_optim = trainer_cfg.get("include_optim_in_ckpt", False)
        bank = run.banks.get("train")
        variables = model_variables(model)
        try:
            for epoch in range(start_epoch, min(stop_epoch or epochs,
                                                epochs) + 1):
                if parallel is not None:
                    _share_host_rng()
                losses = []
                for batch in clock.batches(prefetch_to_device(
                        train_loader, device, transform=shard)):
                    if rl_train:
                        metrics = scst_step(
                            state, to_device(batch, device, bank),
                            [str(k) for k in batch["audio_id"]],
                            train_key2refs, tokenizer.idx2word, rl_len,
                            rl_temp, rl_gen, rl_scorer, baseline)
                        losses.append(torch.tensor(
                            -metrics["reward_sample"]))
                        continue
                    if use_ss:
                        if linear_ss:
                            ss_ratio -= ss_per_iter
                        else:
                            ss_ratio *= 0.01 ** (1.0 / total_iters)
                    ss_arg = (torch.tensor(ss_ratio, dtype=torch.float32)
                              if use_ss else 1.0)
                    metrics = train_step(state, loss_fn,
                                         to_device(batch, device, bank),
                                         ss_ratio=ss_arg, generator=ss_gen,
                                         specaug=specaug,
                                         specaug_generator=specaug_gen,
                                         parallel=parallel)
                    losses.append(metrics["loss"])
                train_loss = (float(torch.stack(losses).mean())
                              if losses else float("nan"))
                if rank != 0:
                    # rank 0 scores, saves and logs; it says when to stop
                    if _broadcast_flag(False):
                        break
                    continue
                score, improved = clock.score()
                not_improve = 0 if improved else not_improve + 1
                swa_due = (swa_cfg.get("use")
                           and epoch >= swa_cfg.get("start", 21))

                def swa_job(snap):
                    nonlocal swa_state
                    if swa_state is None:
                        swa_state = swa_init(snap)
                    swa_state = swa_update(swa_state, snap)
                # a host copy now; pickling and SWA on the writer's thread
                variables = clock.save(
                    improved, swa_job if swa_due else None, epoch=epoch,
                    monitor_state=monitor.state_dict(),
                    not_improve_cnt=not_improve, lr_count=state.lr_count,
                    optimizer=(host_copy(state.optimizer.state_dict())
                               if with_optim else None))
                log(f"epoch {epoch}: loss {train_loss:.4f} "
                    f"val_cider {score:.4f} ss {ss_ratio:.3f} "
                    f"({clock.split()}) rss {host_rss_gb():.1f}G")
                stop = not_improve >= early_stop
                if parallel is not None:
                    _broadcast_flag(stop)
                if stop:
                    log(f"early stop at epoch {epoch}")
                    break
            clock.ckpt_writer.wait()
        finally:
            clock.ckpt_writer.close()
        if rank != 0:
            return str(exp_dir)
        final = swa_state[0] if swa_state is not None else variables
        save_checkpoint(str(exp_dir / "swa.pth"), final, epoch=epochs,
                        monitor_state=monitor.state_dict(),
                        tokenizer_state=tokenizer.state_dict())
        log(f"done; best val score {monitor.best:.4f}")
        return str(exp_dir)


    def _load_experiment(self, experiment_path: str, resume: str,
                         device: torch.device):
        """An experiment directory (either package's: ``config.yaml`` and
        the checkpoint ``resume``) -> (config, model on ``device`` in
        ``eval()``, tokenizer)."""
        cfg, ckpt = read_experiment(experiment_path, resume)
        return (cfg,) + experiment_model(cfg, ckpt, device)

    def train_kd(self, config: Config, *overrides: str) -> str:
        """Knowledge distillation from a config with a ``kd`` node (see
        the module docstring); returns the experiment directory."""
        _single_process("KD")
        run = self._setup(config, overrides)
        cfg, device, seed, exp_dir, log = (run.cfg, run.device, run.seed,
                                           run.exp_dir, run.log)
        tokenizer, train_loader, model = (run.tokenizer, run.train_loader,
                                          run.model)
        kd_cfg = cfg["kd"]
        kd_type = kd_cfg.get("type", "token")
        if kd_type not in ("token", "seq", "enc"):
            raise ValueError(f"kd.type {kd_type!r}: token, seq or enc")

        teacher = None
        if kd_cfg.get("teacher"):
            _, teacher, t_tok = self._load_experiment(
                kd_cfg["teacher"]["experiment_path"],
                kd_cfg["teacher"].get("resume", "swa.pth"), device)
            log(f"teacher from {kd_cfg['teacher']['experiment_path']}")

        if kd_type == "seq":
            if teacher is None:
                raise ValueError("seq KD needs kd.teacher")
            fused = None
            if device.type == "cuda":
                from audiocaption_tpu_torch.decoding.fused_greedy import (
                    FusedGreedyDecoder)
                fused = FusedGreedyDecoder(teacher,
                                           teacher.special.max_length,
                                           device=device)

            def teacher_generate(wav, wav_len):
                b = to_device({"wav": wav, "wav_len": wav_len}, device)
                seq = teacher_captions(teacher, b["wav"], b["wav_len"], fused)
                return t_tok.decode(seq.cpu().numpy())
            cache_path = exp_dir / "pseudo_captions.json"
            cache = (json.loads(cache_path.read_text())
                     if cache_path.exists() else {})
            cache = generate_pseudo_captions(
                teacher_generate,
                bank_batches(train_loader, run.banks.get("train")), cache)
            cache_path.write_text(json.dumps(cache, indent=1))
            log(f"{len(cache)} pseudo captions in {cache_path}")
            state = create_train_state(model, **run.opt)
            loss_fn = build_loss(cfg.get("loss", {}))

            def run_step(batch):
                b = to_device(batch, device, run.banks.get("train"))
                enc = tokenizer([cache[a] for a in batch["audio_id"]])
                b["cap"] = torch.as_tensor(enc["cap"]).to(device, torch.long)
                b["cap_len"] = torch.as_tensor(enc["cap_len"]).to(
                    device, torch.long)
                return train_step(state, loss_fn, b)
        elif kd_type == "enc":
            embs = None
            if kd_cfg.get("teacher_emb"):
                embs = dict(np.load(kd_cfg["teacher_emb"]))
                tchr_dim = next(iter(embs.values())).shape[-1]
            elif teacher is not None:
                tchr_dim = teacher.encoder.fc_emb_size
            else:
                raise ValueError(
                    "enc KD needs kd.teacher_emb (npz) or kd.teacher (an "
                    "experiment whose encoder embeds each batch)")
            head = ContraEncoderKdHead(
                model.encoder.fc_emb_size, tchr_dim,
                shared_dim=kd_cfg.get("shared_dim", 1024),
                generator=torch.Generator().manual_seed(seed)).to(device)
            state = create_train_state(model, head=head, **run.opt)
            unsup = kd_cfg.get("unsup", False)

            def run_step(batch):
                b = to_device(batch, device, run.banks.get("train"))
                if embs is not None:
                    b["tchr_emb"] = torch.as_tensor(np.stack(
                        [embs[a] for a in batch["audio_id"]])).to(
                            device, torch.float32)
                else:
                    b["tchr_emb"] = teacher_embedding(teacher, b["wav"],
                                                      b["wav_len"])
                return encoder_kd_step(state, head, b,
                                       kd_weight=kd_cfg.get("weight", 1.0),
                                       unsup=unsup)
        else:
            if teacher is None:
                raise ValueError("token KD needs kd.teacher")
            state = create_train_state(model, **run.opt)
            kd_args = dict(
                kd_weight=kd_cfg.get("weight", 0.5),
                kd_type=kd_cfg.get("kd_loss", "kl"),
                temperature=kd_cfg.get("temperature", 1.0),
                smoothing=cfg.get("loss", {}).get("args", {}).get(
                    "smoothing", 0.1))

            def run_step(batch):
                b = to_device(batch, device, run.banks.get("train"))
                b["teacher_logit"] = teacher_logits(teacher, b)
                return token_kd_step(state, b, **kd_args)

        monitor = MetricImprover("max")
        val_score = ValScorer(model, tokenizer, run.val_loader,
                              run.val_key2refs, device, run.banks.get("val"))
        ckpt_writer = AsyncCheckpointer()
        variables = model_variables(model)
        try:
            for epoch in range(1, run.epochs + 1):
                t0 = time.time()
                losses = [run_step(batch)["loss"] for batch in
                          prefetch_to_device(train_loader, device)]
                train_loss = (float(torch.stack(losses).mean())
                              if losses else float("nan"))
                score = val_score()
                improved = monitor(score)
                log(f"kd[{kd_type}] epoch {epoch}: loss {train_loss:.4f} "
                    f"val_cider {score:.4f} ({time.time() - t0:.0f}s) "
                    f"rss {host_rss_gb():.1f}G")
                variables = model_variables(model)

                def ckpt_job(snap=variables, epoch=epoch, improved=improved):
                    save_checkpoint(str(exp_dir / "last.pth"), snap,
                                    epoch=epoch,
                                    tokenizer_state=tokenizer.state_dict())
                    if improved:
                        shutil.copyfile(exp_dir / "last.pth",
                                        exp_dir / "best.pth")
                ckpt_writer.submit(ckpt_job)
            ckpt_writer.wait()
        finally:
            ckpt_writer.close()
        save_checkpoint(str(exp_dir / "swa.pth"), variables,
                        epoch=run.epochs,
                        tokenizer_state=tokenizer.state_dict())
        log(f"done; best val score {monitor.best:.4f}")
        return str(exp_dir)

    def train_aug(self, config: Config, *overrides: str,
                  stop_epoch: Optional[int] = None) -> str:
        """Augmented training (the JAX runner's ``train_aug``): each step a
        ``data.train`` batch and a ``data.train_aug`` batch (the aug
        loader restarts when it runs out), one backward of ``real +
        discount * aug`` (``training/aug_runner.py``), the discount from
        ``aug: {discount, mode}`` at the step's count.  Writes
        ``train.log`` (``aug epoch N: loss ... val_cider ... discount
        ...`` with the epoch's time split), ``last.pth`` every epoch,
        ``best.pth`` on a better val score, and ``swa.pth``, the last
        weights (no averaging, no early stop).  ``stop_epoch`` ends the
        run after that epoch, the learning rate and the discount still on
        the schedules of all ``trainer.epochs``: the head of a run that
        a time limit would cut.  Each loader with ``device_resident``
        (``data.train``, ``data.train_aug``, ``data.val``) has its bank;
        the pairs come through ``prefetch_to_device``."""
        from audiocaption_tpu_torch.training.aug_runner import (
            aug_train_step, discount_schedule, interleave_loaders)
        _single_process("augmented training")
        run = self._setup(config, overrides)
        cfg, device, exp_dir, log = run.cfg, run.device, run.exp_dir, run.log
        aug_loader = build_dataloader(cfg["data"]["train_aug"], run.tokenizer)
        run.add_bank("train_aug", aug_loader)
        state = create_train_state(run.model, **run.opt)
        loss_fn = build_loss(cfg.get("loss", {}))
        aug_cfg = cfg.get("aug", {}) or {}
        discount = discount_schedule(aug_cfg.get("mode", "linear"),
                                     aug_cfg.get("discount", 0.5),
                                     run.total_iters)
        clock = EpochClock(run)
        variables = model_variables(run.model)
        epochs = min(stop_epoch or run.epochs, run.epochs)
        it = 0
        try:
            for epoch in range(1, epochs + 1):
                losses = []
                for real, aug in clock.batches(prefetch_to_device(
                        interleave_loaders(run.train_loader, aug_loader),
                        device)):
                    metrics = aug_train_step(
                        state, loss_fn,
                        to_device(real, device, run.banks.get("train")),
                        to_device(aug, device, run.banks.get("train_aug")),
                        discount(it))
                    losses.append(metrics["loss"])
                    it += 1
                train_loss = (float(torch.stack(losses).mean())
                              if losses else float("nan"))
                score, improved = clock.score()
                variables = clock.save(improved, epoch=epoch)
                log(f"aug epoch {epoch}: loss {train_loss:.4f} "
                    f"val_cider {score:.4f} discount {discount(it):.3f} "
                    f"({clock.split()}) rss {host_rss_gb():.1f}G")
            clock.ckpt_writer.wait()
        finally:
            clock.ckpt_writer.close()
        save_checkpoint(str(exp_dir / "swa.pth"), variables, epoch=epochs,
                        tokenizer_state=run.tokenizer.state_dict())
        log(f"done; best val score {clock.monitor.best:.4f}")
        return str(exp_dir)

    # ------------------------------------------------------ evaluation --

    def predict(self, experiment_path: str, eval_config: Config,
                *overrides: str) -> Dict[str, List[str]]:
        """Decode the eval config's ``data.test`` with the experiment's
        checkpoint ``resume`` (default ``swa.pth``) and its
        ``inference_args`` (default beam 3); write ``{"predictions":
        [{filename, caption}]}`` to ``caption_output`` under the
        experiment."""
        eval_cfg = resolve_config(eval_config, overrides)
        device = resolve_device(eval_cfg.get("device", "cuda"))
        _, model, tokenizer = self._load_experiment(
            experiment_path, eval_cfg.get("resume", "swa.pth"), device)
        loader = build_dataloader(eval_cfg["data"]["test"], train=False)
        key2pred = LoaderDecoder(model, device).decode_loader(
            tokenizer, loader, **_inference_args(eval_cfg))
        out_path = Path(experiment_path) / eval_cfg.get(
            "caption_output", "predictions/predictions.json")
        out_path.parent.mkdir(parents=True, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({"predictions": [
                {"filename": k, "caption": v[0]}
                for k, v in key2pred.items()]}, f, indent=2)
        return key2pred

    def evaluate(self, experiment_path: str, eval_config: Config,
                 *overrides: str) -> Dict:
        """``predict``, then the caption metrics against ``data.test.
        caption``, written to ``score_output`` under the experiment."""
        eval_cfg = resolve_config(eval_config, overrides)
        key2pred = self.predict(experiment_path, eval_config, *overrides)
        key2refs = load_caption_json(eval_cfg["data"]["test"]["caption"])
        key2refs = {k: v for k, v in key2refs.items() if k in key2pred}
        result = evaluate_captions(key2pred, key2refs)
        write_scores(Path(experiment_path) / eval_cfg.get(
            "score_output", "results/scores.txt"), result)
        return result

    def export_hf(self, experiment_path: str, output: str,
                  resume: str = "swa.pth") -> str:
        """An experiment's checkpoint ``resume`` -> the HF checkpoint at
        ``output`` (:func:`export_hf_checkpoint`)."""
        _, model, _ = self._load_experiment(experiment_path, resume,
                                            torch.device("cpu"))
        return export_hf_checkpoint(model, output)

    def _load_ensemble(self, eval_cfg: Dict, device: torch.device):
        """The members of ``experiment_path``: paths (the global ``resume``
        applies) or ``{path, resume}`` mappings -> (models, the first
        member's tokenizer).  The members share one vocabulary."""
        default_resume = eval_cfg.get("resume", "swa.pth")
        models, tokenizer = [], None
        for member in eval_cfg["experiment_path"]:
            if isinstance(member, dict):
                path = member["path"]
                resume = member.get("resume", default_resume)
            else:
                path, resume = member, default_resume
            _, model, tok = self._load_experiment(path, resume, device)
            models.append(model)
            tokenizer = tokenizer or tok
        return models, tokenizer

    def ensemble_predict(self, eval_config: Config, *overrides: str,
                         dump_output: bool = True) -> Dict[str, List[str]]:
        """Decode ``data.test`` with the mean per-step log-softmax of the
        members (``decoding/ensemble.py``, the torch engine on the
        device); write ``{"predictions": [{filename, tokens}]}`` to
        ``caption_output`` under ``output_path``."""
        eval_cfg = resolve_config(eval_config, overrides)
        device = resolve_device(eval_cfg.get("device", "cuda"))
        models, tokenizer = self._load_ensemble(eval_cfg, device)
        loader = build_dataloader(eval_cfg["data"]["test"], train=False)
        key2pred = ensemble_decode_loader(models, tokenizer, loader, device,
                                          **_inference_args(eval_cfg))
        if dump_output:
            out_path = Path(eval_cfg["output_path"]) / eval_cfg.get(
                "caption_output", "predictions.json")
            out_path.parent.mkdir(parents=True, exist_ok=True)
            with open(out_path, "w") as f:
                json.dump({"predictions": [
                    {"filename": k, "tokens": v[0]}
                    for k, v in key2pred.items()]}, f, indent=2)
        return key2pred

    def ensemble_evaluate(self, eval_config: Config, *overrides: str) -> Dict:
        """``ensemble_predict``, then the caption metrics, written to
        ``score_output`` under ``output_path``."""
        eval_cfg = resolve_config(eval_config, overrides)
        key2pred = self.ensemble_predict(eval_config, *overrides)
        key2refs = load_caption_json(eval_cfg["data"]["test"]["caption"],
                                     zh=eval_cfg.get("zh", False))
        key2refs = {k: v for k, v in key2refs.items() if k in key2pred}
        result = evaluate_captions(key2pred, key2refs)
        write_scores(Path(eval_cfg["output_path"]) / eval_cfg.get(
            "score_output", "scores.txt"), result)
        return result

    def dcase_predict(self, eval_config: Config, *overrides: str) -> str:
        """The DCASE submission csv (``file_name,caption_predicted``) of
        the ensemble's predictions, at ``dcase_output`` under
        ``output_path``."""
        eval_cfg = resolve_config(eval_config, overrides)
        key2pred = self.ensemble_predict(eval_config, *overrides,
                                         dump_output=False)
        out = Path(eval_cfg["output_path"]) / eval_cfg.get(
            "dcase_output", "dcase_predictions.csv")
        out.parent.mkdir(parents=True, exist_ok=True)
        write_dcase_csv(out, key2pred)
        return str(out)

    # ---------------------------------------------------- temporal tags --

    def train_sed(self, config: Config, *overrides: str) -> str:
        """Train the Cnn8-RNN SED net framewise on a corpus with event
        segments (``data.{train,val}.sed``: ``{split}_sed.json`` of
        ``cli/synthetic_corpus.py::generate_temporal``), keeping
        ``best.pth`` by the val tag accuracy of the host tag pipeline (the
        JAX runner's ``train_sed``).  Audio: ``data.{split}.h5`` where
        that file exists (a JAX corpus, read with h5py), else
        ``data.{split}.wav_csv``, by default the corpus's
        ``{split}_wav.csv`` beside its ``{split}_sed.json``.  Returns the
        experiment directory."""
        from audiocaption_tpu_torch.models.sed import Cnn8RnnSedModel
        from audiocaption_tpu_torch.ops.frontend import (
            CNN14_MEL_32K, LogMelFrontend)
        from audiocaption_tpu_torch.training.sed_trainer import (
            build_lms_bank, evaluate_tags, framewise_targets,
            load_sed_annotations, sed_train_step)

        _single_process("SED training")
        cfg, device, seed, exp_dir, log = self._start(config, overrides)
        classes_num = cfg["model"]["args"].get("classes_num", 447)
        model = Cnn8RnnSedModel(classes_num=classes_num)
        random_init(model, torch.Generator().manual_seed(seed))
        model.to(device)
        frontend = LogMelFrontend(CNN14_MEL_32K)

        t0 = time.time()
        banks, targets, tags = {}, {}, {}
        for split in ("train", "val"):
            split_cfg = cfg["data"][split]
            ann = load_sed_annotations(split_cfg["sed"])
            ids = [a["audio_id"] for a in ann]
            banks[split] = build_lms_bank(_sed_audio(split_cfg), ids,
                                          frontend, device)
            n_frames = banks[split].shape[1]
            targets[split] = torch.from_numpy(np.stack(
                [framewise_targets(a["segments"], n_frames, classes_num)
                 for a in ann])).to(device)
            tags[split] = np.asarray([a["tag"] for a in ann], np.int32)
        log(f"lms banks on {device}: train {tuple(banks['train'].shape)} "
            f"val {tuple(banks['val'].shape)} float16 "
            f"({time.time() - t0:.1f}s)")

        lr = float(cfg.get("optimizer", {}).get("args", {}).get("lr", 1e-3))
        optimizer = torch.optim.Adam(model.parameters(), lr=lr)
        trainer_cfg = cfg.get("trainer", {})
        epochs = int(trainer_cfg.get("epochs", 15))
        bs = int(trainer_cfg.get("batch_size", 32))
        rng = np.random.RandomState(seed)
        n = banks["train"].shape[0]
        best_acc, best_epoch = -1.0, 0
        for epoch in range(1, epochs + 1):
            te = time.time()
            perm = rng.permutation(n)
            losses = [sed_train_step(
                model, optimizer, banks["train"], targets["train"],
                torch.from_numpy(perm[i:i + bs]).to(device))
                for i in range(0, n - bs + 1, bs)]
            t_steps = time.time() - te
            acc, _ = evaluate_tags(model, banks["val"], tags["val"])
            bce = (float(torch.stack(losses).mean()) if losses
                   else float("nan"))
            log(f"epoch {epoch}: bce {bce:.4f} "
                f"val_tag_acc {acc:.4f} ({time.time() - te:.1f}s: steps "
                f"{t_steps:.1f} val {time.time() - te - t_steps:.1f})")
            if acc > best_acc:
                best_acc, best_epoch = acc, epoch
                save_checkpoint(str(exp_dir / "best.pth"),
                                model.state_dict(), epoch=epoch,
                                extra={"classes_num": classes_num,
                                       "val_tag_acc": acc})
        save_checkpoint(str(exp_dir / "last.pth"), model.state_dict(),
                        epoch=epochs, extra={"classes_num": classes_num})
        log(f"done; best val tag accuracy {best_acc:.4f} "
            f"(epoch {best_epoch})")
        return str(exp_dir)

    def _load_sed(self, sed_experiment_path: str, resume: str,
                  device: torch.device):
        """An SED experiment's checkpoint (either package's) -> the
        ``Cnn8RnnSedModel`` on ``device`` in ``eval()``."""
        from audiocaption_tpu_torch.models.convert import load_known
        from audiocaption_tpu_torch.models.sed import Cnn8RnnSedModel
        ckpt = load_checkpoint(str(Path(sed_experiment_path) / resume))
        model = Cnn8RnnSedModel(classes_num=ckpt.get("classes_num", 447))
        load_known(model, ckpt["variables"])
        return model.to(device).eval()

    def predict_temporal(self, experiment_path: str,
                         sed_experiment_path: str, eval_config: Config,
                         *overrides: str) -> Dict[str, List[str]]:
        """Decode ``data.test`` with the tags the SED experiment's net
        gives each clip (log-mel, SED, double threshold, tag, the
        tag-conditioned decode: the temporal model's serving pipeline)
        from the experiments' checkpoints (``resume``, default
        ``swa.pth``; ``sed_resume``, default ``best.pth``).  Writes
        ``caption_output`` and, where the dataset carries ground-truth
        ``temporal_tag``, the SED tag accuracy to ``tag_output``, as the
        JAX runner does."""
        from audiocaption_tpu_torch.models.sed import (
            framewise_to_temporal_tags)
        from audiocaption_tpu_torch.ops.frontend import (
            CNN14_MEL_32K, LogMelFrontend)

        eval_cfg = resolve_config(eval_config, overrides)
        device = resolve_device(eval_cfg.get("device", "cuda"))
        _, model, tokenizer = self._load_experiment(
            experiment_path, eval_cfg.get("resume", "swa.pth"), device)
        sed = self._load_sed(sed_experiment_path,
                             eval_cfg.get("sed_resume", "best.pth"), device)
        sed_frontend = LogMelFrontend(CNN14_MEL_32K).to(device)
        loader = build_dataloader(eval_cfg["data"]["test"], train=False)
        inference_args = _inference_args(eval_cfg)
        inference_args.pop("temporal_tag", None)
        decoder = LoaderDecoder(model, device)

        key2pred: Dict[str, List[str]] = {}
        n_match = n_tag = 0
        for batch in loader:
            wav = torch.as_tensor(batch["wav"]).to(device).float()
            with torch.no_grad():
                framewise = sed(sed_frontend(wav))["framewise_output"]
            sed_tag = framewise_to_temporal_tags(framewise.cpu().numpy())
            if "temporal_tag" in batch:
                gt = np.asarray(batch["temporal_tag"], np.int32)
                n_match += int((sed_tag == gt).sum())
                n_tag += len(gt)
            seq = decoder(wav, torch.as_tensor(batch["wav_len"]).long(),
                          temporal_tag=torch.from_numpy(sed_tag).long(),
                          **inference_args)
            for aid, cap in zip(batch["audio_id"],
                                tokenizer.decode(seq.cpu().numpy())):
                key2pred.setdefault(aid, [cap])

        out_path = Path(experiment_path) / eval_cfg.get(
            "caption_output", "predictions/predictions_sedtag.json")
        out_path.parent.mkdir(parents=True, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({"predictions": [
                {"filename": k, "caption": v[0]}
                for k, v in key2pred.items()]}, f, indent=2)
        if n_tag:
            tag_path = Path(experiment_path) / eval_cfg.get(
                "tag_output", "results/sed_tag_accuracy.txt")
            tag_path.parent.mkdir(parents=True, exist_ok=True)
            with open(tag_path, "w") as f:
                f.write(f"sed_tag_accuracy: {n_match / n_tag:.4f} "
                        f"({n_match}/{n_tag})\n")
        return key2pred

    def evaluate_temporal(self, experiment_path: str,
                          sed_experiment_path: str, eval_config: Config,
                          *overrides: str) -> Dict:
        """``predict_temporal``, then the caption metrics against
        ``data.test.caption``, written to ``score_output``."""
        eval_cfg = resolve_config(eval_config, overrides)
        key2pred = self.predict_temporal(
            experiment_path, sed_experiment_path, eval_config, *overrides)
        key2refs = load_caption_json(eval_cfg["data"]["test"]["caption"])
        key2refs = {k: v for k, v in key2refs.items() if k in key2pred}
        result = evaluate_captions(key2pred, key2refs)
        write_scores(Path(experiment_path) / eval_cfg.get(
            "score_output", "results/scores_sedtag.txt"), result)
        return result

    def debug(self, config: Config, *overrides: str) -> float:
        """One batch of the train loader forward and backward through
        ``train_step`` (Adam 5e-4 with the config's schedule over 100
        steps), weights drawn from the config's seed; prints and returns
        the loss."""
        cfg = resolve_config(config, overrides)
        device = resolve_device(cfg.get("device", "cuda"))
        seed = cfg.get("seed", 1)
        set_seed(seed)
        tokenizer = build_tokenizer(
            cfg["data"]["train"]["collate_fn"]["tokenizer"])
        loader = build_dataloader(cfg["data"]["train"], tokenizer)
        model, _ = build_model_from_config(cfg["model"],
                                           vocab_size=len(tokenizer))
        random_init(model, torch.Generator().manual_seed(seed))
        state = create_train_state(
            model.to(device), 5e-4,
            build_schedule(cfg.get("lr_scheduler", {}), 5e-4, 100, 20))
        metrics = train_step(state, build_loss(cfg.get("loss", {})),
                             to_device(next(iter(loader)), device))
        print(f"debug: loss={float(metrics['loss']):.4f} "
              f"grad_norm={float(metrics['grad_norm']):.4f}")
        return float(metrics["loss"])


def _sed_audio(split_cfg: Dict) -> Callable[[str], np.ndarray]:
    """A ``train_sed`` split's audio reader: audio_id -> the stored wave
    (see :meth:`Runner.train_sed`)."""
    h5 = split_cfg.get("h5")
    if h5 and Path(h5).exists():
        from audiocaption_tpu_torch.data.dataset import _H5Cache
        cache = _H5Cache()
        return lambda aid: cache.read(h5, aid)
    wav_csv = split_cfg.get("wav_csv") or str(split_cfg["sed"]).replace(
        "_sed.json", "_wav.csv")
    return InferenceDataset(wav_csv).read


def ensemble_decode_loader(models, tokenizer, loader, device: torch.device,
                           **inference_args) -> Dict[str, List[str]]:
    """Every batch of ``loader`` through ``ensemble_generate`` on
    ``device`` -> {audio_id: [caption]} (``decoding/select.py::
    decode_batches``)."""
    def decode(wav, wav_len, temporal_tag=None):
        return ensemble_generate(models, wav.to(device), wav_len.to(device),
                                 **inference_args)["seq"]
    return decode_batches(decode, tokenizer, loader)[0]


def write_dcase_csv(path: Path, key2pred: Dict[str, List[str]]) -> None:
    import csv
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["file_name", "caption_predicted"])
        w.writeheader()
        for key, pred in key2pred.items():
            w.writerow({"file_name": key, "caption_predicted": pred[0]})


def main(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(prog="audiocaption_tpu_torch.cli.run")
    sub = parser.add_subparsers(dest="command", required=True)
    for name, text in (("train", "train from a YAML config"),
                       ("train_kd", "knowledge distillation from a YAML "
                                    "config with a kd node"),
                       ("debug", "one batch forward and backward"),
                       ("train_aug", "augmented training from a YAML "
                                     "config with data.train_aug and aug "
                                     "nodes"),
                       ("train_sed", "SED training from a YAML config")):
        p = sub.add_parser(name, help=text)
        # the config as the JAX runner takes it (--config) or positional
        p.add_argument("--config", dest="config_flag")
        p.add_argument("config", nargs="?")
        p.add_argument("overrides", nargs="*",
                       help="key.sub=value (YAML value), e.g. device=cpu")
    for name in ("predict", "evaluate", "predict_temporal",
                 "evaluate_temporal"):
        p = sub.add_parser(name)
        p.add_argument("--experiment_path", required=True)
        if name.endswith("temporal"):
            p.add_argument("--sed_experiment_path", required=True)
        p.add_argument("--eval_config", required=True)
        p.add_argument("overrides", nargs="*")
    for name in ("ensemble_predict", "ensemble_evaluate", "dcase_predict"):
        p = sub.add_parser(name)
        p.add_argument("--eval_config", required=True)
        p.add_argument("overrides", nargs="*")
    p = sub.add_parser("export_hf")
    p.add_argument("--experiment_path", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--resume", default="swa.pth")
    args = parser.parse_args(argv)

    runner = Runner()
    if args.command in ("train", "train_kd", "train_aug", "train_sed",
                        "debug"):
        overrides = args.overrides
        config = args.config
        if args.config_flag is not None:
            # with --config, a positional word is the first override
            overrides = ([config] if config else []) + overrides
            config = args.config_flag
        if config is None:
            parser.error(f"{args.command} needs a config")
        result = getattr(runner, args.command)(config, *overrides)
    elif args.command in ("predict", "evaluate"):
        result = getattr(runner, args.command)(
            args.experiment_path, args.eval_config, *args.overrides)
    elif args.command in ("predict_temporal", "evaluate_temporal"):
        result = getattr(runner, args.command)(
            args.experiment_path, args.sed_experiment_path,
            args.eval_config, *args.overrides)
    elif args.command == "export_hf":
        return runner.export_hf(args.experiment_path, args.output,
                                resume=args.resume)
    else:
        result = getattr(runner, args.command)(args.eval_config,
                                               *args.overrides)
    print(result)
    return result


if __name__ == "__main__":
    main()
