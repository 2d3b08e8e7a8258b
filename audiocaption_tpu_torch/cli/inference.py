"""Batch captioning of wav files (counterpart of
``audiocaption_tpu/cli/inference.py``; reference
``python_scripts/inference/inference.py``):

    python -m audiocaption_tpu_torch.cli.inference \\
        --input WAV_OR_DIR_OR_CSV --output captions.json \\
        --checkpoint EXP/seed_1/swa.pth [--sample_method beam ...] \\
        [--device cpu]

Reads each wav (``scipy.io.wavfile``: 16/32-bit PCM, 8-bit unsigned,
float; channels averaged), resamples it to the model's rate, skips clips
shorter than 0.32 s (the reference's collate), pads each batch up to a
multiple of one second at the model's rate, decodes (``decoding/
select.py``: the CUDA kernels where they serve on the card, the torch
engine on the CPU) and writes ``{audio_id: caption}``.  The checkpoint's
directory holds the experiment's ``config.yaml``.  The card by default.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from audiocaption_tpu_torch.data.collate import pad_sequences
from audiocaption_tpu_torch.data.dataset import read_wav, resample
from audiocaption_tpu_torch.decoding.select import LoaderDecoder

MIN_SECONDS = 0.32


def collect_inputs(input_path: str) -> List[Tuple[str, str]]:
    """A wav file, a directory of them, or a tab-separated csv
    (``file_name`` or ``path``, optional ``audio_id``) -> [(audio_id,
    path)]."""
    p = Path(input_path)
    if p.is_dir():
        files = sorted(list(p.glob("*.wav")) + list(p.glob("*.WAV")))
        return [(f.name, str(f)) for f in files]
    if p.suffix.lower() == ".csv":
        import csv
        out = []
        with open(p) as f:
            for row in csv.DictReader(f, delimiter="\t"):
                fn = row.get("file_name") or row.get("path")
                out.append((row.get("audio_id", Path(fn).name), fn))
        return out
    return [(p.name, str(p))]


def load_waves(entries: Sequence[Tuple[str, str]], target_sr: int
               ) -> Tuple[List[str], List[np.ndarray]]:
    """Read and resample each entry; an unreadable file or a clip
    shorter than MIN_SECONDS is skipped with a line on stderr."""
    ids, wavs = [], []
    for aid, path in entries:
        try:
            sr, wav = read_wav(path)
        except Exception as e:      # a bad file is reported, not fatal
            print(f"skipping {path}: {e}", file=sys.stderr)
            continue
        wav = resample(wav, sr, target_sr)
        if len(wav) < MIN_SECONDS * target_sr:
            print(f"skipping {aid}: shorter than {MIN_SECONDS}s",
                  file=sys.stderr)
            continue
        ids.append(aid)
        wavs.append(wav)
    return ids, wavs


def caption_files(model, tokenizer, entries: Sequence[Tuple[str, str]],
                  device: torch.device, batch_size: int = 32,
                  **inference_args) -> Dict[str, str]:
    """The inference core: a loaded model (in ``eval()`` on ``device``)
    and [(audio_id, wav path)] -> {audio_id: caption}."""
    target_sr = model.mel.sample_rate
    ids, wavs = load_waves(entries, target_sr)
    decoder = LoaderDecoder(model, device)
    output: Dict[str, str] = {}
    for i in range(0, len(wavs), batch_size):
        padded, lens = pad_sequences(wavs[i:i + batch_size],
                                     bucket=target_sr)
        seq = decoder(torch.from_numpy(padded),
                      torch.from_numpy(lens).long(), **inference_args)
        for aid, cap in zip(ids[i:i + batch_size],
                            tokenizer.decode(seq.cpu().numpy())):
            output[aid] = cap
    return output


def main(argv=None) -> Dict[str, str]:
    parser = argparse.ArgumentParser(
        prog="audiocaption_tpu_torch.cli.inference")
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--sample_method", default="beam")
    parser.add_argument("--beam_size", type=int, default=3)
    parser.add_argument("--max_length", type=int, default=20)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from audiocaption_tpu_torch.cli.run import Runner
    from audiocaption_tpu_torch.device import resolve_device
    device = resolve_device(args.device)
    ckpt_path = Path(args.checkpoint)
    _, model, tokenizer = Runner()._load_experiment(
        str(ckpt_path.parent), ckpt_path.name, device)
    output = caption_files(model, tokenizer, collect_inputs(args.input),
                           device, args.batch_size,
                           sample_method=args.sample_method,
                           beam_size=args.beam_size,
                           max_length=args.max_length)
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    with open(args.output, "w") as f:
        json.dump(output, f, indent=2, ensure_ascii=False)
    print(f"wrote {len(output)} captions to {args.output}")
    return output


if __name__ == "__main__":
    main()
