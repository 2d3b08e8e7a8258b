"""Model zoo constructors (counterpart of ``audiocaption_tpu/models/zoo.py``)."""

from __future__ import annotations

import math

import torch
from torch import nn

from audiocaption_tpu_torch.decoding.engine import SpecialTokens
from audiocaption_tpu_torch.models.captioner import Captioner
from audiocaption_tpu_torch.models.effb2 import EfficientNetB2
from audiocaption_tpu_torch.models.encoders_extra import (
    AudioTransformerEncoder, Cdur5Encoder)
from audiocaption_tpu_torch.models.hm_classifier import HmClassifier
from audiocaption_tpu_torch.models.htsat import WindowAttention
from audiocaption_tpu_torch.models.layers import MultiheadAttention
from audiocaption_tpu_torch.models.m2 import M2Attention
from audiocaption_tpu_torch.models.rnn_decoder import (
    Seq2SeqAttention, TemporalBahAttnDecoder)
from audiocaption_tpu_torch.models.rnn_encoder import Cnn14RnnEncoder
from audiocaption_tpu_torch.models.style import StyleBank, TextRefEncoder
from audiocaption_tpu_torch.models.transformer_decoder import (
    TransformerDecoder)
from audiocaption_tpu_torch.models.uit import UITBase
from audiocaption_tpu_torch.ops.frontend import (
    CNN14_MEL_16K, CNN14_MEL_32K, EFFB2_MEL_16K)


def effb2_trm(vocab_size: int = 4981, decoder_emb_dim: int = 256,
              decoder_n_layers: int = 2, decoder_dropout: float = 0.2,
              tie_weights: bool = True,
              compute_dtype: torch.dtype = torch.float32,
              max_length: int = 20) -> Captioner:
    """The HF Effb2TrmCaptioningModel dims: EffB2 encoder (16 kHz mel,
    drop-connect 0.2), 2-layer transformer decoder, emb 256, 4 heads,
    FFN 1024, tied.  ``compute_dtype`` goes to the encoder and the
    decoder (the log-mel frontend stays float32), as in the JAX zoo.
    Dropout and drop-connect act in ``train()`` only."""
    encoder = EfficientNetB2(compute_dtype=compute_dtype)
    decoder = TransformerDecoder(
        emb_dim=decoder_emb_dim, vocab_size=vocab_size,
        attn_emb_dim=encoder.fc_emb_size, nlayers=decoder_n_layers,
        tie_weights=tie_weights, dropout=decoder_dropout,
        compute_dtype=compute_dtype)
    return Captioner(encoder=encoder, decoder=decoder, mel=EFFB2_MEL_16K,
                     special=SpecialTokens(max_length=max_length))


def cnn14rnn_trm(vocab_size: int = 4368, sample_rate: int = 32000,
                 rnn_hidden_size: int = 256, rnn_num_layers: int = 3,
                 rnn_dropout: float = 0.5, decoder_emb_dim: int = 256,
                 decoder_n_layers: int = 2, decoder_dropout: float = 0.2,
                 freeze_cnn: bool = False, freeze_cnn_bn: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 max_length: int = 20) -> Captioner:
    """The reference's cnn14rnn_trm recipe (its second public
    architecture): Cnn14 -> 3-layer BiGRU(256) encoder (32 kHz mel),
    2-layer transformer decoder, emb 256, 4 heads, FFN 1024, memory width
    2 x 256, an untied classifier without bias.  Dropouts act in
    ``train()`` only; ``freeze_cnn`` / ``freeze_cnn_bn`` as
    ``Cnn14RnnEncoder``."""
    encoder = Cnn14RnnEncoder(
        rnn_hidden_size=rnn_hidden_size, rnn_num_layers=rnn_num_layers,
        rnn_dropout=rnn_dropout, freeze_cnn=freeze_cnn,
        freeze_cnn_bn=freeze_cnn_bn, compute_dtype=compute_dtype)
    decoder = TransformerDecoder(
        emb_dim=decoder_emb_dim, vocab_size=vocab_size,
        attn_emb_dim=encoder.fc_emb_size, nlayers=decoder_n_layers,
        tie_weights=False, dropout=decoder_dropout,
        compute_dtype=compute_dtype)
    mel = CNN14_MEL_32K if sample_rate == 32000 else CNN14_MEL_16K
    return Captioner(encoder=encoder, decoder=decoder, mel=mel,
                     special=SpecialTokens(max_length=max_length))


def cnn14rnn_tempgru(vocab_size: int = 4981, sample_rate: int = 32000,
                     encoder_rnn_hidden_size: int = 256,
                     encoder_rnn_num_layers: int = 3,
                     decoder_emb_dim: int = 512, decoder_d_model: int = 512,
                     compute_dtype: torch.dtype = torch.float32,
                     max_length: int = 20) -> Captioner:
    """The HF Cnn14RnnTempAttnGruModel captioner: Cnn14 -> 3-layer
    BiGRU(256) encoder (32 kHz mel), temporal Bahdanau-attention GRU
    decoder (emb 512, d_model 512, attention size d_model).
    ``compute_dtype`` goes to the encoder's Cnn14 only: the GRU decoder
    has none, as in the JAX zoo."""
    encoder = Cnn14RnnEncoder(rnn_hidden_size=encoder_rnn_hidden_size,
                              rnn_num_layers=encoder_rnn_num_layers,
                              compute_dtype=compute_dtype)
    decoder = TemporalBahAttnDecoder(
        emb_dim=decoder_emb_dim, vocab_size=vocab_size,
        fc_emb_dim=encoder.fc_emb_size, attn_emb_dim=encoder.fc_emb_size,
        d_model=decoder_d_model)
    mel = CNN14_MEL_32K if sample_rate == 32000 else CNN14_MEL_16K
    return Captioner(encoder=encoder, decoder=decoder, mel=mel,
                     special=SpecialTokens(max_length=max_length))


def kd_student_cdur5(vocab_size: int = 4981, sample_rate: int = 32000,
                     decoder_emb_dim: int = 128, decoder_n_layers: int = 1,
                     decoder_dropout: float = 0.2,
                     compute_dtype: torch.dtype = torch.float32,
                     max_length: int = 20) -> Captioner:
    """The KD student recipe (``configs/*/kd_token.yaml``): the Cdur5 CRNN
    encoder (memory width 256, a quarter of the log-mel frames) and a
    1-layer transformer decoder, emb 128, 2 heads, FFN 512, untied (2.1M
    parameters at V=4368).  ``compute_dtype`` is the decoder's; the
    Cdur5 runs in float32, as in the JAX zoo."""
    encoder = Cdur5Encoder()
    decoder = TransformerDecoder(
        emb_dim=decoder_emb_dim, vocab_size=vocab_size,
        attn_emb_dim=encoder.fc_emb_size, nlayers=decoder_n_layers,
        dropout=decoder_dropout, compute_dtype=compute_dtype)
    mel = CNN14_MEL_32K if sample_rate == 32000 else CNN14_MEL_16K
    return Captioner(encoder=encoder, decoder=decoder, mel=mel,
                     special=SpecialTokens(max_length=max_length))


@torch.no_grad()
def random_init(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights drawn from ``generator`` (random-init
    serving and tests): He-normal fan-out convs, torch-default uniform
    linears, Xavier-uniform embeddings and packed attention projections,
    torch-default uniform GRUs, a standard-normal additive-attention
    ``v``, Xavier-uniform CLS tokens (the style captioner's reference
    encoder's too) and discriminator word tables, the style bank's tokens
    from N(0, 0.02^2),
    identity normalisation; the M2 modules' linears Xavier-uniform with
    zero biases (``xavier_init``) and their memory slots from N(0, (1 /
    d_k)^2) and N(0, (1 / m)^2), as the JAX modules draw them; HTS-AT's
    relative position tables and UiT's position tables from N(0, 0.02^2),
    UiT's CLS token from N(0, (1e-6)^2) (the JAX initialisers; the FBSP
    filterbank and LayerScale keep their fixed starts).  The positional
    table stays sinusoidal."""
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d)):
            fan_out = m.out_channels * math.prod(m.kernel_size)
            m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear) and getattr(m, "xavier_init", False):
            _xavier_uniform(m.weight, generator)
            m.bias.zero_()
        elif isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.Embedding):
            _xavier_uniform(m.weight, generator)
        elif isinstance(m, MultiheadAttention):
            _xavier_uniform(m.in_proj_weight, generator)
            m.in_proj_bias.zero_()
        elif isinstance(m, nn.GRU):
            bound = 1.0 / math.sqrt(m.hidden_size)
            for p in m.parameters():
                p.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, Seq2SeqAttention):
            m.v.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, M2Attention) and m.n_memory:
            d_k = m.d_model // m.nhead
            m.m_k.normal_(0.0, 1.0 / d_k, generator=generator)
            m.m_v.normal_(0.0, 1.0 / m.n_memory, generator=generator)
        elif isinstance(m, (AudioTransformerEncoder, TextRefEncoder)):
            _xavier_uniform(m.cls_token, generator)
        elif isinstance(m, StyleBank):
            m.styles.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, HmClassifier):
            _xavier_uniform(m.word_embedding, generator)
        elif isinstance(m, WindowAttention):
            m.relative_position_bias_table.normal_(0.0, 0.02,
                                                   generator=generator)
        elif isinstance(m, UITBase):
            for p_ in (m.token_pos_embed, m.time_pos_embed,
                       m.freq_pos_embed):
                p_.normal_(0.0, 0.02, generator=generator)
            m.cls_token.normal_(0.0, 1e-6, generator=generator)
        elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if not isinstance(m, nn.LayerNorm):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return model


def _xavier_uniform(w: torch.Tensor, generator: torch.Generator) -> None:
    bound = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    w.uniform_(-bound, bound, generator=generator)
