"""Public inference API (counterpart of ``audiocaption_tpu/hf_api.py``),
mirroring the reference's HF ``trust_remote_code`` models:

    model = Effb2TrmCaptioningModel(Effb2TrmConfig(vocab_size=4981))
    model.load_torch_checkpoint("pytorch_model.bin")   # HF zoo weights
    ids = model(audio=wav_batch, audio_length=[n1, n2],
                sample_method="beam", beam_size=3)     # [N, 20] token ids

    model = Cnn14RnnTempAttnGruModel()                 # 32 kHz, temporal
    ids = model(audio=wav_batch, audio_length=[n1, n2],
                temporal_tag=[0, 2])                   # optional user tag

Audio is padded up to 1 s buckets (padding is masked by
``audio_length``).  EffB2-Transformer: on CUDA, greedy decodes and temp-1
beam decodes of at most 8 beams (the default beam 3) go through the
whole-loop CUDA kernels (``decoding/select.py``); on the CPU, and for
other settings, through the torch decoding engine.
Temporal model: the 32 kHz log-mel goes through the fused log-mel kernel
on CUDA (``ops/fused_logmel.py``) and is shared by the SED branch and the
captioner; decoding is the torch engine's, as in the JAX package.

``compute_dtype=torch.bfloat16`` serves either model in bf16, as the JAX
package's APIs do: the networks compute in bf16 (``models/layers.py``),
the log-mel stays float32, and on CUDA the EffB2 model's decode kernels
run with bf16 memory K/V and self-attention caches (``cache_bf16``, the
JAX "serving configuration"; bf16 kernel weights, ``weights_bf16``, are
an opt-in of ``FusedBeamDecoder``).  Parameters stay float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from torch import nn

from audiocaption_tpu_torch.decoding.select import select_decoder
from audiocaption_tpu_torch.device import DeviceLike, resolve_device
from audiocaption_tpu_torch.models.captioner import generate
from audiocaption_tpu_torch.models.convert import (
    load_known, load_reference_state_dict)
from audiocaption_tpu_torch.models.sed import (
    Cnn8RnnSedModel, framewise_to_temporal_tags)
from audiocaption_tpu_torch.models.zoo import (
    cnn14rnn_tempgru, effb2_trm, random_init)
from audiocaption_tpu_torch.utils.profiling import sync


def pad_bucket(audio: np.ndarray, sample_rate: int,
               bucket_s: float = 1.0) -> np.ndarray:
    """Pad the time axis up to the next bucket multiple."""
    n = audio.shape[1]
    bucket = int(sample_rate * bucket_s)
    target = max(bucket, (n + bucket - 1) // bucket * bucket)
    if target == n:
        return audio
    return np.pad(audio, ((0, 0), (0, target - n)))


def _as_2d_float(audio) -> np.ndarray:
    a = np.asarray(audio, np.float32)
    return a[None, :] if a.ndim == 1 else a


@dataclasses.dataclass
class Effb2TrmConfig:
    """The reference HF config defaults."""
    sample_rate: int = 16000
    fc_emb_dim: int = 1408
    attn_emb_dim: int = 1408
    decoder_n_layers: int = 2
    decoder_we_tie_weights: bool = True
    decoder_emb_dim: int = 256
    decoder_dropout: float = 0.2
    vocab_size: int = 4981


class Effb2TrmCaptioningModel:
    """EffB2 + 2-layer transformer captioner with the reference's
    forward(audio, audio_length, sample_method, beam_size, max_length,
    temp) -> token ids API.

    ``state_dict`` takes reference-key-space weights (see
    ``models/convert.py``); without it the weights are random, drawn
    from ``torch.Generator().manual_seed(seed)``.  ``compute_dtype``:
    float32 or bfloat16 (see the module docstring)."""

    def __init__(self, config: Effb2TrmConfig = Effb2TrmConfig(),
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 seed: int = 0, device: DeviceLike = "cuda",
                 compute_dtype: torch.dtype = torch.float32):
        self.device = resolve_device(device)
        self.config = config
        self.compute_dtype = compute_dtype
        self.model = effb2_trm(
            vocab_size=config.vocab_size,
            decoder_emb_dim=config.decoder_emb_dim,
            decoder_n_layers=config.decoder_n_layers,
            decoder_dropout=config.decoder_dropout,
            tie_weights=config.decoder_we_tie_weights,
            compute_dtype=compute_dtype)
        random_init(self.model, torch.Generator().manual_seed(seed))
        if state_dict is not None:
            load_reference_state_dict(self.model, state_dict)
        self.model.to(self.device).eval()
        self._decode: Dict = {}

    def load_torch_checkpoint(self, path: str) -> None:
        """Load an HF zoo checkpoint (a plain state dict, or one wrapped
        as ``{"state_dict": ...}``)."""
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(ckpt, dict) and "state_dict" in ckpt:
            ckpt = ckpt["state_dict"]
        self.load_torch_state_dict(ckpt)

    def load_torch_state_dict(self, sd: Mapping[str, torch.Tensor]) -> None:
        """Load reference-key-space weights.  The bf16 copies of the
        weights are made again from the new ones at their next use
        (``layers.as_compute``), and the fused decoders, which hold
        packed copies of the old ones, are dropped."""
        load_reference_state_dict(self.model, sd)
        self.model.to(self.device).eval()
        self._decode = {}   # drop decoders bound to the old weights

    def _decode_fn(self, key):
        """One decoder per (sample_method, beam_size, max_length, temp):
        on CUDA the fused kernels (``decoding/select.py``), in the mode
        the model's compute dtype implies (bf16 caches for a bf16 model)."""
        if key not in self._decode:
            sample_method, beam_size, max_length, temp = key
            self._decode[key] = select_decoder(
                self.model, self.device, sample_method=sample_method,
                beam_size=beam_size, max_length=max_length, temp=temp)
        return self._decode[key]

    @torch.no_grad()
    def decode(self, audio: torch.Tensor, audio_length: torch.Tensor,
               sample_method: str = "beam", beam_size: int = 3,
               max_length: int = 20, temp: float = 1.0) -> torch.Tensor:
        """Device tensors in, device token ids [B, max_length] out, with
        no host synchronisation (the serving path)."""
        fn = self._decode_fn((sample_method, beam_size, max_length, temp))
        return fn(audio.to(self.device), audio_length.to(self.device))

    def __call__(self, audio, audio_length, sample_method: str = "beam",
                 beam_size: int = 3, max_length: int = 20,
                 temp: float = 1.0) -> np.ndarray:
        audio = pad_bucket(_as_2d_float(audio), self.config.sample_rate)
        lens = torch.as_tensor(np.asarray(audio_length, np.int64))
        seq = self.decode(torch.from_numpy(audio), lens,
                          sample_method=sample_method, beam_size=beam_size,
                          max_length=max_length, temp=temp)
        with sync("api_tokens"):
            seq = seq.cpu()
        return seq.numpy().astype(np.int32)


@dataclasses.dataclass
class Cnn14RnnTempAttnGruConfig:
    """The reference HF config defaults (dropouts are training-only)."""
    sample_rate: int = 32000
    encoder_rnn_hidden_size: int = 256
    encoder_rnn_num_layers: int = 3
    encoder_rnn_dropout: float = 0.5
    decoder_emb_dim: int = 512
    decoder_d_model: int = 512
    decoder_dropout: float = 0.5
    vocab_size: int = 4981


class TemporalCaptionModel(nn.Module):
    """The temporal model's two networks under the reference checkpoint's
    names: ``cap_model`` (Cnn14-BiGRU captioner) and ``sed_model``."""

    def __init__(self, config: Cnn14RnnTempAttnGruConfig,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cap_model = cnn14rnn_tempgru(
            vocab_size=config.vocab_size, sample_rate=config.sample_rate,
            encoder_rnn_hidden_size=config.encoder_rnn_hidden_size,
            encoder_rnn_num_layers=config.encoder_rnn_num_layers,
            decoder_emb_dim=config.decoder_emb_dim,
            decoder_d_model=config.decoder_d_model,
            compute_dtype=compute_dtype)
        self.sed_model = Cnn8RnnSedModel(compute_dtype=compute_dtype)


class Cnn14RnnTempAttnGruModel:
    """Temporal-tag controllable captioner: one 32 kHz log-mel shared by a
    SED branch (framewise event probabilities -> host-side temporal tag)
    and a Cnn14-BiGRU captioner whose GRU decoder starts from the tag's
    embedding.  Tags: 0 single event, 1 simultaneous, 2 sequential,
    3 complex; a user tag is merged with the SED tag by ``min``.

    ``state_dict`` takes the reference checkpoint's key space (see
    ``models/convert.py``); without it the weights are random, drawn from
    ``torch.Generator().manual_seed(seed)``.  ``compute_dtype``: float32
    or bfloat16, for the Cnn14 and the SED network (the log-mel, the
    BiGRUs and the GRU decoder stay float32, as in the JAX package)."""

    def __init__(self, config: Cnn14RnnTempAttnGruConfig =
                 Cnn14RnnTempAttnGruConfig(),
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 seed: int = 0, device: DeviceLike = "cuda",
                 compute_dtype: torch.dtype = torch.float32):
        self.device = resolve_device(device)
        self.config = config
        self.compute_dtype = compute_dtype
        self.model = TemporalCaptionModel(config, compute_dtype)
        random_init(self.model, torch.Generator().manual_seed(seed))
        if state_dict is not None:
            self.load_torch_state_dict(state_dict)
        self.model.to(self.device).eval()
        self.mel = self.model.cap_model.mel

    def load_torch_checkpoint(self, path: str) -> None:
        """Load the reference checkpoint (a plain state dict: unlike the
        EffB2 class, no ``{"state_dict": ...}`` wrapper is unwrapped)."""
        self.load_torch_state_dict(
            torch.load(path, map_location="cpu", weights_only=False))

    def load_torch_state_dict(self, sd: Mapping[str, torch.Tensor]) -> None:
        """Load the reference key space; keys the model has no tensor for
        are dropped and a missing one raises (``convert.load_known``)."""
        load_known(self.model, sd)
        self.model.to(self.device).eval()

    @torch.no_grad()
    def log_mel(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, T] -> the shared log-mel [B, T // hop + 1, 64]."""
        return self.model.cap_model.frontend(wav.to(self.device))

    @torch.no_grad()
    def sed_tags(self, lms: torch.Tensor) -> np.ndarray:
        """Log-mel -> SED temporal tag per clip [B] (host numpy)."""
        framewise = self.model.sed_model(lms)["framewise_output"]
        with sync("sed_tags"):
            framewise = framewise.cpu()
        return framewise_to_temporal_tags(framewise.numpy())

    @torch.no_grad()
    def decode_lms(self, lms: torch.Tensor, audio_length, temporal_tag=None,
                   sample_method: str = "beam", beam_size: int = 3,
                   max_length: int = 20, temp: float = 1.0) -> torch.Tensor:
        """Captions of a computed log-mel -> device token ids [B, L].
        ``audio_length`` is a host sequence or a tensor of sample counts."""
        tag = self.sed_tags(lms)
        if temporal_tag is not None:
            tag = np.minimum(np.asarray(temporal_tag, np.int32), tag)
        lens = torch.as_tensor(audio_length if torch.is_tensor(audio_length)
                               else np.asarray(audio_length, np.int64))
        return generate(self.model.cap_model, lms=lms,
                        feat_len=self.mel.feat_len(lens.to(self.device)),
                        temporal_tag=torch.from_numpy(tag).to(self.device),
                        sample_method=sample_method, beam_size=beam_size,
                        max_length=max_length, temp=temp)["seq"]

    def __call__(self, audio, audio_length, temporal_tag=None,
                 sample_method: str = "beam", beam_size: int = 3,
                 max_length: int = 20, temp: float = 1.0) -> np.ndarray:
        audio = pad_bucket(_as_2d_float(audio), self.config.sample_rate)
        lms = self.log_mel(torch.from_numpy(audio))
        seq = self.decode_lms(lms, audio_length, temporal_tag,
                              sample_method=sample_method,
                              beam_size=beam_size, max_length=max_length,
                              temp=temp)
        with sync("api_tokens"):
            seq = seq.cpu()
        return seq.numpy().astype(np.int32)
