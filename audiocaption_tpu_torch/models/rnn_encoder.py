"""RNN sequence encoder and the Cnn14 -> BiGRU composition (counterpart of
``audiocaption_tpu/models/rnn_encoder.py``).

The GRU has the reference's pack-padded semantics (``layers.GRU``); its
parameters keep ``nn.GRU``'s names under ``network``, so the reference key
space ``encoder.rnn.network.weight_ih_l{k}[_reverse]`` loads as it is.

``compute_dtype`` is the Cnn14's only, as in the JAX package: the Cnn14
hands the GRU a float32 ``attn_emb``, so the BiGRU runs in float32 in
both modes (see ``layers.GRU``).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from audiocaption_tpu_torch.models.cnn14 import Cnn14Encoder
from audiocaption_tpu_torch.models.layers import GRU
from audiocaption_tpu_torch.ops.masking import mean_with_lens


class RnnEncoder(nn.Module):
    """Bidirectional GRU over attention features -> {attn_emb: GRU output,
    fc_emb: its length-masked mean, attn_emb_len}."""

    def __init__(self, input_size: int, hidden_size: int = 256,
                 num_layers: int = 3):
        super().__init__()
        self.network = GRU(input_size, hidden_size, num_layers=num_layers,
                           bidirectional=True)

    def forward(self, attn: torch.Tensor, attn_len: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        out = self.network(attn, attn_len)
        return {"attn_emb": out, "fc_emb": mean_with_lens(out, attn_len),
                "attn_emb_len": attn_len}


class Cnn14RnnEncoder(nn.Module):
    """Cnn14 -> RnnEncoder (the HF temporal model's encoder)."""

    def __init__(self, rnn_hidden_size: int = 256, rnn_num_layers: int = 3,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cnn = Cnn14Encoder(compute_dtype=compute_dtype)
        self.rnn = RnnEncoder(self.cnn.fc_emb_size, rnn_hidden_size,
                              rnn_num_layers)
        self.fc_emb_size = 2 * rnn_hidden_size

    def forward(self, lms: torch.Tensor, feat_len: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        cnn_out = self.cnn(lms, feat_len)
        return self.rnn(cnn_out["attn_emb"], cnn_out["attn_emb_len"])
