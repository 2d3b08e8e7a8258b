"""Pack wav files into float16 HDF5 + waveform.csv (counterpart of
``audiocaption_tpu/cli/pack_waveform.py``; reference
python_scripts/utils/pack_waveform.py:60-104): parallel reading,
optional resampling and mono mixdown, multi-part sharding, tolerant of
corrupt files (pack_waveform.py:53-57).

    python -m audiocaption_tpu_torch.cli.pack_waveform \\
        --input wav_dir_or_csv --output_dir data/xyz \\
        [--sample_rate 32000] [--num_parts 1] [--workers 4]

The layout is the JAX tool's: ``waveform.h5`` (``waveform_{part}.h5``
with several parts), one float16 dataset per audio id, and
``waveform.csv`` (tab-separated ``audio_id``, ``hdf5_path``).  It needs
``h5py``; without it :func:`pack_waveform` raises an ``ImportError``
that names it (the card machine has none: the port's own corpora are wav
files with ``file_name`` rows).
"""

from __future__ import annotations

import argparse
import csv
import multiprocessing
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np


def _load_one(entry: Tuple[str, str], target_sr: Optional[int]
              ) -> Tuple[str, Optional[np.ndarray]]:
    """(audio id, path) -> (audio id, float16 wave, or None for a file
    that does not read: reported on stderr and left out)."""
    from audiocaption_tpu_torch.data.dataset import read_wav, resample
    aid, path = entry
    try:
        sr, wav = read_wav(path)
    except (OSError, ValueError) as e:
        print(f"error reading {path}: {e}", file=sys.stderr)
        return aid, None
    if target_sr and sr != target_sr:
        wav = resample(wav, sr, target_sr)
    return aid, wav.astype(np.float16)


def pack_waveform(entries: List[Tuple[str, str]], output_dir: str,
                  sample_rate: Optional[int] = None, num_parts: int = 1,
                  workers: int = 4) -> None:
    """Write ``entries`` [(audio id, wav path)] into ``num_parts`` h5
    shards (entry i into shard i % num_parts) and ``waveform.csv``, read
    by ``workers`` spawned processes and resampled to ``sample_rate``
    where given."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("pack_waveform writes HDF5 and needs h5py, which "
                          "is not installed") from e
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    shards = [entries[i::num_parts] for i in range(num_parts)]
    csv_rows = []
    ctx = multiprocessing.get_context("spawn")
    for part, shard in enumerate(shards):
        h5_path = out / (f"waveform_{part}.h5" if num_parts > 1
                         else "waveform.h5")
        with h5py.File(h5_path, "w") as store, \
                ProcessPoolExecutor(max_workers=workers,
                                    mp_context=ctx) as pool:
            for aid, wav in pool.map(_load_one, shard,
                                     [sample_rate] * len(shard)):
                if wav is None:
                    continue
                store[aid] = wav
                csv_rows.append((aid, str(h5_path)))
    with open(out / "waveform.csv", "w", newline="") as f:
        writer = csv.writer(f, delimiter="\t")
        writer.writerow(["audio_id", "hdf5_path"])
        writer.writerows(csv_rows)
    print(f"packed {len(csv_rows)}/{len(entries)} files into {output_dir}")


def collect_entries(input_path: str) -> List[Tuple[str, str]]:
    """A wav file, a directory of them or a tsv of paths -> [(audio id,
    path)] (``cli/inference.py::collect_inputs``)."""
    from audiocaption_tpu_torch.cli.inference import collect_inputs
    return collect_inputs(input_path)


def main(argv=None):
    p = argparse.ArgumentParser(prog="audiocaption_tpu_torch.cli.pack_waveform")
    p.add_argument("--input", required=True,
                   help="wav directory or tsv with audio_id/file_name")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--sample_rate", type=int, default=None)
    p.add_argument("--num_parts", type=int, default=1)
    p.add_argument("--workers", type=int, default=4)
    args = p.parse_args(argv)
    pack_waveform(collect_entries(args.input), args.output_dir,
                  args.sample_rate, args.num_parts, args.workers)


if __name__ == "__main__":
    main()
