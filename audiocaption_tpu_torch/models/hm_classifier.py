"""The human / machine caption discriminator (counterpart of
``audiocaption_tpu/models/hm_classifier.py``) that the condition loss
(``losses/wrappers.py::condition_loss_wrapper``) reads: word embeddings
-> BiGRU over each caption's length -> masked mean -> one logit.  The
caption is token ids [B, L] or a soft one-hot [B, L, V] (what the loss
feeds it: a straight-through or gumbel relaxation of the decoder's
words).  Parameter names are the JAX tree's (``word_embedding``, a raw
[V, E] table; ``rnn``; ``classifier``).
"""

from __future__ import annotations

import torch
from torch import nn

from audiocaption_tpu_torch.models.layers import GRU
from audiocaption_tpu_torch.ops.masking import mean_with_lens


class HmClassifier(nn.Module):

    def __init__(self, vocab_size: int, emb_dim: int = 256,
                 hidden_size: int = 256):
        super().__init__()
        self.word_embedding = nn.Parameter(torch.empty(vocab_size, emb_dim))
        nn.init.xavier_uniform_(self.word_embedding)
        self.rnn = GRU(emb_dim, hidden_size, bidirectional=True)
        self.classifier = nn.Linear(2 * hidden_size, 1)

    def forward(self, cap: torch.Tensor, cap_len: torch.Tensor
                ) -> torch.Tensor:
        """cap [B, L] ids or [B, L, V] soft one-hot -> logits [B]."""
        emb = (cap @ self.word_embedding if cap.dim() == 3
               else self.word_embedding[cap])
        out = self.rnn(emb, cap_len)
        return self.classifier(mean_with_lens(out, cap_len))[:, 0]
