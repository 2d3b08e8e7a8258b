"""Offline data tools (counterpart of ``audiocaption_tpu/cli/data_tools.py``;
reference ``data/augment/speed_perturb.py``).  Ported so far:
``speed_perturb``; the other tools are ROADMAP Queue 1 item 8c.

    python -m audiocaption_tpu_torch.cli.data_tools speed_perturb \\
        INPUT_DIR OUTPUT_DIR [--speeds 0.9 1.1] [--sr 16000] [--compute] \\
        [--wav_csv CSV] [--text_json JSON]

reads ``INPUT_DIR/wav.csv`` and ``INPUT_DIR/text.json`` (or the files
``--wav_csv`` and ``--text_json`` name, e.g. a corpus's
``train_wav.csv`` and ``train_text.json``) and writes into OUTPUT_DIR:

  * ``wav.csv``: one row per clip and speed, audio id ``sp{speed}-{id}``.
    With ``--compute``, the clip resampled by ``resample_poly`` at
    ``Fraction(1 / speed).limit_denominator(1000)`` (a slower clip is
    longer), its values rounded to float16 as the JAX tool stores them,
    written as a float32 wav file (exact) under ``OUTPUT_DIR/wav/``
    at the clip's own rate (``--sr`` for an h5 row), and a ``file_name``
    row for it; the card machine has no h5py, where the JAX tool writes
    ``waveform_sp.h5``.  Without ``--compute``, the JAX tool's
    ffmpeg / sox pipe rows;
  * ``text.json``: the input's items, then a copy of each clip's item
    under every perturbed id, as the JAX tool writes it.

A wav.csv row is read as the datasets read it: a ``file_name`` row from
its wav file, an ``hdf5_path`` row from the h5.
"""

from __future__ import annotations

import argparse
import csv
import json
from fractions import Fraction
from pathlib import Path
from typing import Dict, List, Optional, Sequence


def _read_rows(path: Path) -> List[Dict[str, str]]:
    with open(path) as f:
        return list(csv.DictReader(f, delimiter="\t"))


def speed_perturb(input_dir: str, output_dir: str,
                  speeds: Sequence[float] = (0.9, 1.1), sr: int = 16000,
                  compute: bool = False, wav_csv: Optional[str] = None,
                  text_json: Optional[str] = None) -> Dict[str, str]:
    """See the module docstring -> {wav_csv, text_json} written."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    rows = _read_rows(Path(wav_csv or Path(input_dir) / "wav.csv"))
    with open(text_json or Path(input_dir) / "text.json") as f:
        audios = json.load(f)["audios"]
    aid_to_item = {a["audio_id"]: a for a in audios}
    if compute:
        from scipy.signal import resample_poly
        from audiocaption_tpu_torch.cli.synthetic_corpus import write_wave
        from audiocaption_tpu_torch.data.dataset import _H5Cache, read_wav
        wav_dir = out / "wav"
        wav_dir.mkdir(exist_ok=True)
        h5 = _H5Cache()
        sp_rows = []
        for row in rows:
            if row.get("file_name"):
                rate, wav = read_wav(row["file_name"])
            else:
                rate, wav = sr, h5.read(row["hdf5_path"], row["audio_id"])
            for speed in speeds:
                sp_aid = f"sp{speed}-{row['audio_id']}"
                frac = Fraction(1.0 / speed).limit_denominator(1000)
                path = wav_dir / f"{sp_aid}.wav"
                write_wave(path, resample_poly(wav, frac.numerator,
                                               frac.denominator), rate)
                sp_rows.append([sp_aid, str(path)])
    else:
        sp_rows = [[f"sp{speed}-{row['audio_id']}",
                    f"ffmpeg -i {row.get('file_name') or row['hdf5_path']} "
                    f"-f wav -ar {sr} -ab 16 - | sox -t wav - -t wav - "
                    f"speed {speed} |"] for row in rows for speed in speeds]
    sp_items = []
    for row in rows:
        for speed in speeds:
            if row["audio_id"] in aid_to_item:
                item = json.loads(json.dumps(aid_to_item[row["audio_id"]]))
                item["audio_id"] = f"sp{speed}-{row['audio_id']}"
                sp_items.append(item)
    with open(out / "text.json", "w") as f:
        json.dump({"audios": audios + sp_items}, f, indent=4,
                  ensure_ascii=False)
    with open(out / "wav.csv", "w", newline="") as f:
        writer = csv.writer(f, delimiter="\t", lineterminator="\n")
        writer.writerow(["audio_id", "file_name"])
        writer.writerows(sp_rows)
    print(f"wrote {len(sp_rows)} perturbed rows to {out}")
    return {"wav_csv": str(out / "wav.csv"),
            "text_json": str(out / "text.json")}


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="audiocaption_tpu_torch.cli.data_tools")
    sub = parser.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("speed_perturb")
    s.add_argument("input_dir")
    s.add_argument("output_dir")
    s.add_argument("--speeds", type=float, nargs="+", default=[0.9, 1.1])
    s.add_argument("--sr", type=int, default=16000)
    s.add_argument("--compute", action="store_true")
    s.add_argument("--wav_csv", default=None)
    s.add_argument("--text_json", default=None)
    args = parser.parse_args(argv)
    return speed_perturb(args.input_dir, args.output_dir, args.speeds,
                         args.sr, args.compute, args.wav_csv,
                         args.text_json)


if __name__ == "__main__":
    main()
