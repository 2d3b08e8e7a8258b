"""Which decoder a ``Captioner`` decodes through, by its inference
arguments, for every entry point of the port that decodes: the APIs
(``hf_api.py``), the runner's predict / evaluate (``cli/run.py``) and
batch inference (``cli/inference.py``).

On CUDA, for a ``TransformerDecoder``:

  * ``sample_method: greedy`` -> the whole-loop greedy kernel
    (``FusedGreedyDecoder``);
  * ``beam`` with ``temp == 1`` and ``beam_size <= 8`` -> the whole-loop
    beam kernel (``FusedBeamDecoder``), its best beam;

every other method, any further argument (``n_best``, ``group_size``,
...), any other decoder, and the CPU go through the torch engine
(``models/captioner.py::generate``).  A kernel that fails to build or
launch raises; nothing falls back.  A batch's ``temporal_tag`` conditions
the temporal GRU decoder; other decoders take no tag.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from audiocaption_tpu_torch.models.captioner import generate
from audiocaption_tpu_torch.models.rnn_decoder import TemporalBahAttnDecoder
from audiocaption_tpu_torch.models.transformer_decoder import (
    TransformerDecoder)
from audiocaption_tpu_torch.utils.profiling import sync

DecodeFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def select_decoder(model, device: torch.device, sample_method: str = "beam",
                   beam_size: Optional[int] = 3,
                   max_length: Optional[int] = None, temp: float = 1.0,
                   **extra) -> DecodeFn:
    """-> fn(wav, wav_len) -> token ids on ``device``, [B, max_length] (the
    best beam of a beam search), or ``generate``'s [B, n, max_length] for
    "dbs".  ``extra`` goes to ``generate``.  A kernel decoder packs the
    weights once: build another after they change."""
    L = max_length if max_length is not None else model.special.max_length
    trm = type(model.decoder) is TransformerDecoder
    if device.type == "cuda" and trm and not extra:
        if sample_method == "greedy":
            from audiocaption_tpu_torch.decoding.fused_greedy import (
                FusedGreedyDecoder)
            return FusedGreedyDecoder(model, max_length=L, device=device)
        from audiocaption_tpu_torch.decoding.fused_beam import (
            MAX_BEAMS, FusedBeamDecoder)
        K = beam_size if beam_size is not None else 3
        if sample_method == "beam" and temp == 1.0 and K <= MAX_BEAMS:
            return FusedBeamDecoder(model, max_length=L, beam_size=K,
                                    device=device)

    def fn(wav: torch.Tensor, wav_len: torch.Tensor,
           temporal_tag: Optional[torch.Tensor] = None) -> torch.Tensor:
        return generate(model, wav, wav_len, sample_method=sample_method,
                        beam_size=beam_size, max_length=L, temp=temp,
                        temporal_tag=temporal_tag, **extra)["seq"]
    return fn


class LoaderDecoder:
    """Decodes batches with one model, one decoder kept per set of
    inference arguments (the weights do not move during evaluation, so a
    kernel decoder packs them once).  ``last_seq`` holds the token ids of
    the last ``decode_loader`` call, a [B, L] array a batch."""

    def __init__(self, model, device: torch.device):
        self.model = model.eval()
        self.device = device
        self._fns: Dict = {}
        self.last_seq: List[np.ndarray] = []

    def __call__(self, wav: torch.Tensor, wav_len: torch.Tensor,
                 temporal_tag: Optional[torch.Tensor] = None,
                 **inference_args) -> torch.Tensor:
        """Token ids [B, L] on the device (the first of an n-best
        layout), without a host sync; ``temporal_tag`` [B] conditions the
        temporal GRU decoder and is dropped for any other."""
        key = tuple(sorted(inference_args.items()))
        if key not in self._fns:
            self._fns[key] = select_decoder(self.model, self.device,
                                            **inference_args)
        cond = ({"temporal_tag": temporal_tag.to(self.device)}
                if temporal_tag is not None
                and isinstance(self.model.decoder, TemporalBahAttnDecoder)
                else {})
        with torch.no_grad():
            seq = self._fns[key](wav.to(self.device),
                                 wav_len.to(self.device), **cond)
        return seq[:, 0] if seq.dim() == 3 else seq

    def decode_loader(self, tokenizer, loader: Iterable[Dict],
                      **inference_args) -> Dict[str, List[str]]:
        """Every batch of ``loader`` -> {audio_id: [caption]}
        (:func:`decode_batches`, the JAX runner's ``_decode_loader``)."""
        key2pred, self.last_seq = decode_batches(
            functools.partial(self, **inference_args), tokenizer, loader)
        return key2pred


def decode_batches(decode: DecodeFn, tokenizer, loader: Iterable[Dict]
                   ) -> Tuple[Dict[str, List[str]], List[np.ndarray]]:
    """Every batch of ``loader`` ({audio_id, wav, wav_len}: numpy arrays or
    tensors; an int16 wave is read as / 32768) through ``decode(wav,
    wav_len)`` (a batch's ``temporal_tag`` as a third argument) ->
    ({audio_id: [caption]}, the first caption of an id kept; the token
    ids, a [B, L] array a batch, the first sequence of an n-best
    layout)."""
    key2pred: Dict[str, List[str]] = {}
    seqs: List[np.ndarray] = []
    for batch in loader:
        wav = torch.as_tensor(batch["wav"])
        if wav.dtype == torch.int16:
            wav = wav.float() / 32768.0
        tag = (() if batch.get("temporal_tag") is None
               else (torch.as_tensor(batch["temporal_tag"]).long(),))
        seq = decode(wav.float(), torch.as_tensor(batch["wav_len"]).long(),
                     *tag)
        if seq.dim() == 3:
            seq = seq[:, 0]
        with sync("decode_batches"):
            seq = seq.cpu().numpy()
        seqs.append(seq)
        for aid, cap in zip(batch["audio_id"], tokenizer.decode(seq)):
            key2pred.setdefault(aid, [cap])
    return key2pred, seqs
