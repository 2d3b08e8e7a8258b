"""Precompute encoder features for the feature-input families
(counterpart of ``audiocaption_tpu/cli/prepare_features.py``):

    python -m audiocaption_tpu_torch.cli.prepare_features \\
        --wav_csv data/x/test_wav.csv --output_dir data/x/features/test \\
        --experiment experiments/x/cnn14rnn_trm/seed_1 [--resume swa.pth] \\
        [--format h5|npy] [--batch_size 16] [--device cpu]

extracts a trained captioner's encoder output (an experiment directory
of either package: its ``config.yaml`` and checkpoint), the way
``configs/synthetic/m2_trm.yaml``'s header does; or, with
``--encoder cnn14|cnn10|cnn6|effb2|htsat|panns_cnn10|panns_wavegram`` and
an optional torch ``--checkpoint`` (PANNs / COLA / BLAT layouts,
``cli/run.py::unwrap_pretrained``; without one the encoder's weights are
drawn from seed 0), a named encoder's over its log-mel (32 kHz, 16 kHz
for effb2).  ``panns_cnn10`` and ``panns_wavegram`` are the PANNs
classifiers (``models/panns.py``): their ``fc_feat`` and ``attn_feat``
become ``fc_emb`` and ``attn_emb``, the attn lengths ``feat_len //
ratio`` with the ratio read off the realised shapes (frames over attn
steps), and ``probs`` gets their AudioSet probabilities.

Each batch of ``--batch_size`` clips (read as ``data/dataset.py::
InferenceDataset`` reads a wav.csv, at their stored rate) is padded up to
a multiple of the encoder's sample rate (the JAX bucket rule; 16000 for a
feature-input experiment) and encoded in ``eval()`` without autograd; on
the card a 32 kHz encoder's log-mel runs the log-mel kernel.  Written,
in the JAX layout with ``--format h5`` (the default; needs h5py):
``fc.h5`` (audio_id -> ``fc_emb``), ``attn.h5`` (audio_id -> ``attn_emb``
cut to its length), ``probs.h5`` where the encoder yields
``clipwise_output``, ``features.csv`` (audio_id, fc_hdf5, attn_hdf5) and
``attn.csv`` (audio_id, hdf5_path: a dataset's ``features.wav``).  With
``--format npy``: one ``.npy`` per clip under ``fc/`` and ``attn/``
(``probs/`` where there are probabilities) and ``attn.csv`` / ``fc.csv``
with a ``file_name`` column, which the port's datasets read with
``numpy.load`` (the card machine has no h5py).  Asking for ``h5``
without h5py raises; the format never changes silently.  The card by
default.
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from audiocaption_tpu_torch.data.collate import pad_sequences
from audiocaption_tpu_torch.data.dataset import InferenceDataset
from audiocaption_tpu_torch.device import resolve_device

ENCODERS = ("cnn14", "cnn10", "cnn6", "effb2", "htsat", "panns_cnn10",
            "panns_wavegram")
EncodeFn = Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]


def experiment_encoder(experiment: str, resume: str, device: torch.device
                       ) -> tuple:
    """An experiment's captioner -> (its encode function, bucket rate)."""
    from audiocaption_tpu_torch.cli.run import (
        experiment_model, read_experiment)
    cfg, ckpt = read_experiment(experiment, resume)
    model, _ = experiment_model(cfg, ckpt, device)
    bucket = model.mel.sample_rate if model.input_mode == "mel" else 16000
    return model.encode, bucket


def named_encoder(name: str, checkpoint: Optional[str],
                  device: torch.device) -> tuple:
    """A named pretrained encoder over its log-mel -> (encode function,
    bucket rate)."""
    from audiocaption_tpu_torch.cli.run import unwrap_pretrained
    from audiocaption_tpu_torch.models import encoders_extra as EX
    from audiocaption_tpu_torch.models import panns
    from audiocaption_tpu_torch.models.cnn14 import Cnn14Encoder
    from audiocaption_tpu_torch.models.effb2 import EfficientNetB2
    from audiocaption_tpu_torch.models.htsat import HtsatEncoder
    from audiocaption_tpu_torch.models.zoo import random_init
    from audiocaption_tpu_torch.ops.frontend import (
        CNN14_MEL_32K, EFFB2_MEL_16K, LogMelFrontend)
    from audiocaption_tpu_torch.training.checkpoint import merge_variables
    if name not in ENCODERS:
        raise ValueError(f"unknown encoder {name!r}: one of {ENCODERS}")
    encoder, mel = {
        "cnn14": lambda: (Cnn14Encoder(), CNN14_MEL_32K),
        "cnn10": lambda: (EX.Cnn10Encoder(), CNN14_MEL_32K),
        "cnn6": lambda: (EX.Cnn6Encoder(), CNN14_MEL_32K),
        "effb2": lambda: (EfficientNetB2(), EFFB2_MEL_16K),
        "htsat": lambda: (HtsatEncoder(), CNN14_MEL_32K),
        "panns_cnn10": lambda: (panns.Cnn10(), CNN14_MEL_32K),
        "panns_wavegram": lambda: (panns.Wavegram_Logmel_Cnn14(),
                                   CNN14_MEL_32K)}[name]()
    random_init(encoder, torch.Generator().manual_seed(0))
    if checkpoint:
        sd = unwrap_pretrained(torch.load(checkpoint, map_location="cpu",
                                          weights_only=False), name)
        encoder.load_state_dict(merge_variables(encoder.state_dict(), sd))
    encoder.to(device).eval()
    frontend = LogMelFrontend(mel).to(device)

    def encode(wav, wav_len):
        lms, feat_len = frontend(wav), mel.feat_len(wav_len)
        if not name.startswith("panns_"):
            return encoder(lms, feat_len)
        out = encoder(wav, lms) if name == "panns_wavegram" else encoder(lms)
        ratio = max(1, lms.shape[1] // out["attn_feat"].shape[1])
        return {"fc_emb": out["fc_feat"], "attn_emb": out["attn_feat"],
                "attn_emb_len": torch.div(feat_len, ratio,
                                          rounding_mode="floor"),
                "clipwise_output": out["clipwise_output"]}
    return encode, mel.sample_rate


class _H5Writer:
    def __init__(self, out_dir: Path):
        try:
            import h5py
        except ImportError:
            raise RuntimeError("--format h5 needs h5py, which is not "
                               "installed: use --format npy") from None
        self.h5py, self.out_dir = h5py, out_dir
        self.files = {k: h5py.File(out_dir / f"{k}.h5", "w")
                      for k in ("fc", "attn")}

    def write(self, kind: str, aid: str, value: np.ndarray) -> str:
        if kind not in self.files:
            self.files[kind] = self.h5py.File(self.out_dir / f"{kind}.h5",
                                              "w")
        self.files[kind][aid] = value
        return str(self.out_dir / f"{kind}.h5")

    def close(self, rows: List[Dict[str, str]]) -> None:
        for f in self.files.values():
            f.close()
        _write_csv(self.out_dir / "features.csv",
                   ["audio_id", "fc_hdf5", "attn_hdf5"],
                   [(r["audio_id"], r["fc"], r["attn"]) for r in rows])
        _write_csv(self.out_dir / "attn.csv", ["audio_id", "hdf5_path"],
                   [(r["audio_id"], r["attn"]) for r in rows])


class _NpyWriter:
    def __init__(self, out_dir: Path):
        self.out_dir = out_dir

    def write(self, kind: str, aid: str, value: np.ndarray) -> str:
        path = self.out_dir / kind / f"{aid.replace('/', '_')}.npy"
        path.parent.mkdir(parents=True, exist_ok=True)
        np.save(path, value)
        return str(path)

    def close(self, rows: List[Dict[str, str]]) -> None:
        for kind in ("attn", "fc"):
            _write_csv(self.out_dir / f"{kind}.csv",
                       ["audio_id", "file_name"],
                       [(r["audio_id"], r[kind]) for r in rows])


def _write_csv(path: Path, header: List[str], rows) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(header)
        w.writerows(rows)


@torch.no_grad()
def write_features(wav_csv: str, output_dir: str, encode: EncodeFn,
                   bucket_sr: int, device: torch.device,
                   batch_size: int = 16, fmt: str = "h5") -> int:
    """Encode every clip of ``wav_csv`` in batches padded to a multiple of
    ``bucket_sr`` samples and write the features in ``fmt`` (see the
    module docstring) -> the number of clips."""
    if fmt not in ("h5", "npy"):
        raise ValueError(f"--format must be h5 or npy, not {fmt!r}")
    out_dir = Path(output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    writer = _H5Writer(out_dir) if fmt == "h5" else _NpyWriter(out_dir)
    ds = InferenceDataset({"wav": wav_csv})
    rows: List[Dict[str, str]] = []
    for i in range(0, len(ds), batch_size):
        items = [ds[j] for j in range(i, min(i + batch_size, len(ds)))]
        wav, lens = pad_sequences([it["wav"] for it in items],
                                  bucket=bucket_sr)
        out = encode(torch.from_numpy(wav).to(device),
                     torch.from_numpy(lens).long().to(device))
        fc = out["fc_emb"].float().cpu().numpy()
        attn = out["attn_emb"].float().cpu().numpy()
        alens = out["attn_emb_len"].cpu().numpy()
        probs = (out["clipwise_output"].float().cpu().numpy()
                 if "clipwise_output" in out else None)
        for k, it in enumerate(items):
            aid = it["audio_id"]
            row = {"audio_id": aid,
                   "fc": writer.write("fc", aid, fc[k]),
                   "attn": writer.write("attn", aid, attn[k, :alens[k]])}
            if probs is not None:
                writer.write("probs", aid, probs[k])
            rows.append(row)
    writer.close(rows)
    print(f"wrote features for {len(rows)} clips to {out_dir} ({fmt})")
    return len(rows)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="audiocaption_tpu_torch.cli.prepare_features")
    p.add_argument("--wav_csv", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--encoder", default="cnn14", choices=ENCODERS)
    p.add_argument("--checkpoint", default=None,
                   help="torch checkpoint of the named encoder")
    p.add_argument("--experiment", default=None,
                   help="a trained experiment directory (config.yaml + "
                        "checkpoint): its captioner's encoder")
    p.add_argument("--resume", default="swa.pth",
                   help="the checkpoint inside --experiment")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--format", default="h5", choices=("h5", "npy"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if args.experiment:
        encode, bucket = experiment_encoder(args.experiment, args.resume,
                                            device)
    else:
        encode, bucket = named_encoder(args.encoder, args.checkpoint, device)
    return write_features(args.wav_csv, args.output_dir, encode, bucket,
                          device, args.batch_size, args.format)


if __name__ == "__main__":
    main()
