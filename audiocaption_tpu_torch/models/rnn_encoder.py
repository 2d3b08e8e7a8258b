"""RNN sequence encoder and the Cnn14 -> GRU composition (counterpart of
``audiocaption_tpu/models/rnn_encoder.py``), with its training options:
dropout between the GRU layers, a frozen CNN and frozen CNN BN.

The GRU has the reference's pack-padded semantics (``layers.GRU``); its
parameters keep ``nn.GRU``'s names under ``network``, so the reference key
space ``encoder.rnn.network.weight_ih_l{k}[_reverse]`` loads as it is.

Packing needs the GRU's lengths on the host.  ``Cnn14RnnEncoder`` starts
their copy before the Cnn14 runs (``layers.HostLengths``: ``feat_len``
copied without blocking, mapped by ``Cnn14Encoder.out_len``), so the GRU
waits, in ``ac.sync.gru_lengths``, for the work queued before the call
and not for the Cnn14; the host goes on launching while the Cnn14 runs.
``RnnEncoder`` alone (features mode) hands the GRU its device lengths,
which the GRU reads itself (``ac.sync.gru_lengths_read``).

``compute_dtype`` is the Cnn14's only, as in the JAX package: the Cnn14
hands the GRU a float32 ``attn_emb``, so the BiGRU runs in float32 in
both modes (see ``layers.GRU``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from audiocaption_tpu_torch.models.cnn14 import Cnn14Encoder
from audiocaption_tpu_torch.models.layers import GRU, HostLengths
from audiocaption_tpu_torch.ops.masking import max_with_lens, mean_with_lens


def embedding_pooling(x: torch.Tensor, lens: torch.Tensor, pooling: str
                      ) -> torch.Tensor:
    """The reference's pooling options over the valid frames."""
    if pooling == "max":
        return max_with_lens(x, lens)
    if pooling == "mean":
        return mean_with_lens(x, lens)
    if pooling == "mean+max":
        return mean_with_lens(x, lens) + max_with_lens(x, lens)
    if pooling == "last":
        idx = (lens - 1).clamp(0, x.shape[1] - 1).long()
        return torch.gather(x, 1, idx.view(-1, 1, 1).expand(
            -1, 1, x.shape[-1]))[:, 0]
    raise ValueError(f"unknown pooling: {pooling}")


class RnnEncoder(nn.Module):
    """(Bi)directional GRU over attention features -> {attn_emb: GRU
    output, fc_emb: its pooling over the valid frames, attn_emb_len}.
    ``dropout`` acts between the GRU layers in ``train()`` only."""

    def __init__(self, input_size: int, hidden_size: int = 256,
                 num_layers: int = 3, bidirectional: bool = True,
                 dropout: float = 0.5, pooling: str = "mean"):
        super().__init__()
        self.network = GRU(input_size, hidden_size, num_layers=num_layers,
                           bidirectional=bidirectional, dropout=dropout)
        self.dropout, self.pooling = dropout, pooling
        self.out_size = self.fc_emb_size = hidden_size * (2 if bidirectional
                                                          else 1)

    def forward(self, attn: torch.Tensor, attn_len: torch.Tensor,
                host_len: Optional[HostLengths] = None
                ) -> Dict[str, torch.Tensor]:
        """``host_len``: ``attn_len`` brought to the host ahead of need,
        which the GRU packs by; without it the GRU reads ``attn_len``."""
        out = self.network(attn, attn_len if host_len is None else host_len)
        return {"attn_emb": out,
                "fc_emb": embedding_pooling(out, attn_len, self.pooling),
                "attn_emb_len": attn_len}


class Cnn14RnnEncoder(nn.Module):
    """Cnn14 -> RnnEncoder (the reference's ``CrnnEncoder`` /
    ``Cnn14RnnEncoder``; the HF temporal model's encoder).

    ``freeze_cnn`` detaches the CNN's output (no gradient reaches the
    CNN); ``freeze_cnn_bn`` keeps the whole CNN in ``eval()`` while the
    encoder trains (its BN on running statistics, not updated, and no
    dropout), as the JAX encoder runs its CNN with ``train=False``."""

    def __init__(self, rnn_hidden_size: int = 256, rnn_num_layers: int = 3,
                 rnn_bidirectional: bool = True, rnn_dropout: float = 0.5,
                 rnn_pooling: str = "mean", freeze_cnn: bool = False,
                 freeze_cnn_bn: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cnn = Cnn14Encoder(compute_dtype=compute_dtype)
        self.rnn = RnnEncoder(self.cnn.fc_emb_size, rnn_hidden_size,
                              rnn_num_layers, rnn_bidirectional, rnn_dropout,
                              rnn_pooling)
        self.freeze_cnn, self.freeze_cnn_bn = freeze_cnn, freeze_cnn_bn
        self.fc_emb_size = self.rnn.out_size

    def train(self, mode: bool = True) -> "Cnn14RnnEncoder":
        super().train(mode)
        if self.freeze_cnn_bn:
            self.cnn.train(False)
        return self

    def forward(self, lms: torch.Tensor, feat_len: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        # before any Cnn14 launch: the GRU then waits for the work queued
        # before this call, not for the Cnn14
        host_len = HostLengths(feat_len, self.cnn.out_len)
        cnn_out = self.cnn(lms, feat_len)
        attn = cnn_out["attn_emb"]
        if self.freeze_cnn:
            attn = attn.detach()
        return self.rnn(attn, cnn_out["attn_emb_len"], host_len)
