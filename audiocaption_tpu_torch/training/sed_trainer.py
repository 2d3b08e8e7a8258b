"""Framewise sound-event-detection training of ``Cnn8RnnSedModel``
(counterpart of ``audiocaption_tpu/training/sed_trainer.py``).

The temporal-tag pipeline (SED framewise probabilities -> double
threshold -> segments -> tag) needs an SED net trained on the corpus's
event segments (``{split}_sed.json`` of ``cli/synthetic_corpus.py::
generate_temporal``).  The corpus's log-mels are computed on the device
once (``LogMelFrontend(CNN14_MEL_32K)``: the hand-written log-mel kernel
on CUDA) and kept as a float16 bank, as the JAX trainer keeps its bank
in HBM; a step gathers rows of it.  BCE at the model's segmentwise
resolution (T / 4), against targets max-pooled 4 -> 1.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from audiocaption_tpu_torch.models.sed import (
    Cnn8RnnSedModel, framewise_to_temporal_tags)
from audiocaption_tpu_torch.ops.frontend import LogMelFrontend


def load_sed_annotations(path: str) -> List[Dict]:
    """{split}_sed.json -> [{audio_id, tag, segments: [[cls, on, off]]}]."""
    with open(path) as f:
        return json.load(f)["audios"]


def framewise_targets(segments: Sequence[Sequence[float]], n_frames: int,
                      n_classes: int,
                      time_resolution: float = 0.01) -> np.ndarray:
    """[(class, onset s, offset s)] -> [n_frames, n_classes] {0, 1} int8."""
    y = np.zeros((n_frames, n_classes), np.int8)
    for cls, on, off in segments:
        s = int(round(on / time_resolution))
        e = int(round(off / time_resolution))
        y[s:min(e, n_frames), int(cls)] = 1
    return y


@torch.no_grad()
def build_lms_bank(read: Callable[[str], np.ndarray],
                   audio_ids: Sequence[str], frontend: LogMelFrontend,
                   device: torch.device, chunk: int = 64) -> torch.Tensor:
    """The log-mels of ``read(audio_id)`` (equal-length waves) for every
    id, ``chunk`` clips a frontend call, as a float16 [N, T, 64] bank on
    ``device``."""
    frontend = frontend.to(device)
    out = []
    for i in range(0, len(audio_ids), chunk):
        wav = np.stack([np.asarray(read(a), np.float32)
                        for a in audio_ids[i:i + chunk]])
        out.append(frontend(torch.from_numpy(wav).to(device)).half())
    return torch.cat(out)


def sed_loss(model: Cnn8RnnSedModel, lms: torch.Tensor, y: torch.Tensor
             ) -> torch.Tensor:
    """Mean BCE of the segmentwise output [B, T', C] against ``y`` [B, T,
    C] max-pooled over each ``interpolate_ratio`` frames; the output
    clipped to [1e-7, 1 - 1e-7] (a saturated sigmoid would make
    log1p(-seg) infinite)."""
    seg = model(lms)["segmentwise_output"]
    r = model.interpolate_ratio
    B, T4, C = seg.shape
    yseg = y[:, :T4 * r].reshape(B, T4, r, C).amax(2).float()
    seg = seg.clamp(1e-7, 1.0 - 1e-7)
    return -(yseg * torch.log(seg) + (1 - yseg) * torch.log1p(-seg)).mean()


def sed_train_step(model: Cnn8RnnSedModel, optimizer: torch.optim.Optimizer,
                   bank: torch.Tensor, targets: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """One Adam step on the bank rows ``idx`` (BN on batch statistics,
    dropout on) -> the loss, on the device."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    loss = sed_loss(model, bank[idx].float(), targets[idx])
    loss.backward()
    optimizer.step()
    return loss.detach()


@torch.no_grad()
def evaluate_tags(model: Cnn8RnnSedModel, bank: torch.Tensor,
                  gt_tags: np.ndarray, batch: int = 32,
                  time_resolution: float = 0.01
                  ) -> Tuple[float, np.ndarray]:
    """Tag accuracy of the whole host-side pipeline (double threshold ->
    segments -> temporal tag) against the ground truth -> (accuracy, the
    predicted tags)."""
    model.eval()
    n = bank.shape[0]
    pred = []
    for i in range(0, n, batch):
        fw = model(bank[i:i + batch].float())["framewise_output"]
        pred.append(framewise_to_temporal_tags(
            fw.cpu().numpy(), time_resolution=time_resolution))
    pred = np.concatenate(pred)
    return float((pred == gt_tags[:n]).mean()), pred
