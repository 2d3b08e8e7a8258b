"""Interactive captioning demo (counterpart of
``audiocaption_tpu/cli/demo.py``; reference demo.py:27-85).

    python -m audiocaption_tpu_torch.cli.demo --checkpoint EXP/swa.pth \\
        [--beam_size 3] [--device cuda]

loads the experiment (``Runner._load_experiment``: ``config.yaml`` and the
checkpoint, either package's) on the card and captions each clip by beam
search on the torch engine (``models/captioner.py::generate``), as the
JAX demo does.  With gradio installed it serves the reference's UI
(audio upload -> caption); without it, a terminal loop reads one wav path
a line from stdin and prints its caption, or the error it met, until
end of input.  Input normalisation is demo.py:27-45's: int16 / int32 ->
[-1, 1], stereo mixdown, resampling to the model's rate.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Callable, Optional, TextIO

import numpy as np
import torch


def normalize_audio(sr: int, data: np.ndarray, target_sr: int
                    ) -> np.ndarray:
    """(rate, int16 / int32 / float samples, mono or [T, channels]) ->
    float32 mono at ``target_sr``."""
    from audiocaption_tpu_torch.data.dataset import resample
    if data.dtype == np.int16:
        data = data / 32768.0
    elif data.dtype == np.int32:
        data = data / 2147483648.0
    data = np.asarray(data, np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    return resample(data, sr, target_sr)


def load_captioner(checkpoint: str, beam_size: int = 3,
                   device: str = "cuda") -> Callable[[int, np.ndarray], str]:
    """The experiment of ``checkpoint`` (its directory and file name) on
    ``device`` -> ``caption(sr, data)``, the beam search's caption of one
    clip."""
    from audiocaption_tpu_torch.cli.run import Runner
    from audiocaption_tpu_torch.device import resolve_device
    from audiocaption_tpu_torch.models.captioner import generate
    dev = resolve_device(device)
    ckpt = Path(checkpoint)
    _, model, tokenizer = Runner()._load_experiment(str(ckpt.parent),
                                                    ckpt.name, dev)
    target_sr = model.mel.sample_rate

    def caption(sr: int, data: np.ndarray) -> str:
        wav = normalize_audio(sr, data, target_sr)
        with torch.no_grad():
            out = generate(model, torch.from_numpy(wav[None]).to(dev),
                           torch.tensor([len(wav)], device=dev),
                           sample_method="beam", beam_size=beam_size)
        return tokenizer.decode(out["seq"].cpu().numpy())[0]

    return caption


def repl(caption: Callable[[int, np.ndarray], str],
         stdin: Optional[TextIO] = None,
         stdout: Optional[TextIO] = None) -> None:
    """Read wav paths, one a line, from ``stdin`` (default ``sys.stdin``)
    and print each clip's caption to ``stdout``; a path that fails prints
    its error and the loop goes on.  Ends at end of input."""
    from audiocaption_tpu_torch.data.dataset import read_wav
    stdin = sys.stdin if stdin is None else stdin
    stdout = sys.stdout if stdout is None else stdout
    print("gradio not installed; file-path REPL (ctrl-d to exit)",
          file=stdout, flush=True)
    for line in stdin:
        path = line.strip()
        if not path:
            continue
        try:
            sr, data = read_wav(path)
            print(caption(sr, data), file=stdout, flush=True)
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=stdout, flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="audiocaption_tpu_torch.cli.demo")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--beam_size", type=int, default=3)
    parser.add_argument("--share", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    caption = load_captioner(args.checkpoint, args.beam_size, args.device)
    try:
        import gradio as gr
    except ImportError:
        repl(caption)
        return

    def infer(audio):
        sr, data = audio
        return caption(sr, data)

    gr.Interface(fn=infer, inputs=gr.Audio(label="audio"),
                 outputs=gr.Text(label="caption"),
                 title="audiocaption_tpu_torch demo").launch(share=args.share)


if __name__ == "__main__":
    main()
