"""Dataset preparation for Clotho and AudioCaps (counterpart of
``audiocaption_tpu/cli/prepare_dataset.py``; reference
data/create_dataset/prepare_{clotho,audiocaps}.py): the framework's data
files from locally downloaded corpora,

  text.json   {"audios": [{audio_id, captions: [{caption, tokens,
               cap_id}]}]}
  waveform.csv + waveform.h5   (``cli/pack_waveform.py``; needs h5py)
  vocab.pkl   (``data/tokenizer.py::build_vocab``)

    python -m audiocaption_tpu_torch.cli.prepare_dataset clotho \\
        --audio_dir development/ --caption_csv clotho_captions_dev.csv \\
        --output_dir data/clotho_v2/dev [--sample_rate 32000] [--no_pack]

    python -m audiocaption_tpu_torch.cli.prepare_dataset audiocaps \\
        --audio_dir audio/ --caption_csv train.csv --output_dir ...

Clotho audio ids are md5 hashes of the file names (the reference's
collision-proof renaming, prepare_clotho.py:21-39); AudioCaps uses the
"Y{youtube_id}.wav" convention.  Tokens are the lowercase PTB-style
normalisation of ``metrics/tokenize.py::ptb_tokenize_sentence`` (the
reference shells out to the Java PTBTokenizer).  ``--no_pack`` writes the
text files only.
"""

from __future__ import annotations

import argparse
import csv
import hashlib
import json
from pathlib import Path
from typing import Dict, List

from audiocaption_tpu_torch.data.tokenizer import build_vocab
from audiocaption_tpu_torch.metrics.tokenize import ptb_tokenize_sentence


def _finish(audios: List[Dict], entries, out: Path, sample_rate: int,
            pack: bool) -> None:
    with open(out / "text.json", "w") as f:
        json.dump({"audios": audios}, f)
    if pack:
        from audiocaption_tpu_torch.cli.pack_waveform import pack_waveform
        pack_waveform(entries, str(out), sample_rate=sample_rate)
    build_vocab(str(out / "text.json"), output_path=str(out / "vocab.pkl"))
    print(f"prepared {len(audios)} clips -> {out}")


def prepare_clotho(audio_dir: str, caption_csv: str, output_dir: str,
                   sample_rate: int = 32000, pack: bool = True) -> None:
    """Clotho csv columns: file_name, caption_1 .. caption_5."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    audios, entries = [], []
    with open(caption_csv, newline="") as f:
        for row in csv.DictReader(f):
            fname = row["file_name"]
            aid = hashlib.md5(fname.encode()).hexdigest()
            caps = []
            for i in range(1, 6):
                text = row.get(f"caption_{i}", "").strip()
                if text:
                    caps.append({"caption": text,
                                 "tokens": ptb_tokenize_sentence(text),
                                 "cap_id": str(i)})
            audios.append({"audio_id": aid, "captions": caps})
            entries.append((aid, str(Path(audio_dir) / fname)))
    _finish(audios, entries, out, sample_rate, pack)


def prepare_audiocaps(audio_dir: str, caption_csv: str, output_dir: str,
                      sample_rate: int = 32000, pack: bool = True) -> None:
    """AudioCaps csv columns: audiocap_id, youtube_id, start_time, caption
    (several rows per youtube_id)."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    by_audio: Dict[str, List[Dict]] = {}
    with open(caption_csv, newline="") as f:
        for row in csv.DictReader(f):
            aid = f"Y{row['youtube_id']}"
            text = row["caption"].strip()
            by_audio.setdefault(aid, []).append(
                {"caption": text, "tokens": ptb_tokenize_sentence(text),
                 "cap_id": str(row.get("audiocap_id", len(by_audio)))})
    audios = [{"audio_id": k, "captions": v} for k, v in by_audio.items()]
    entries = [(aid, str(Path(audio_dir) / f"{aid}.wav")) for aid in by_audio]
    _finish(audios, entries, out, sample_rate, pack)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="audiocaption_tpu_torch.cli.prepare_dataset")
    p.add_argument("dataset", choices=["clotho", "audiocaps"])
    p.add_argument("--audio_dir", required=True)
    p.add_argument("--caption_csv", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--sample_rate", type=int, default=32000)
    p.add_argument("--no_pack", action="store_true",
                   help="skip waveform packing (text files only)")
    args = p.parse_args(argv)
    fn = prepare_clotho if args.dataset == "clotho" else prepare_audiocaps
    fn(args.audio_dir, args.caption_csv, args.output_dir, args.sample_rate,
       pack=not args.no_pack)


if __name__ == "__main__":
    main()
