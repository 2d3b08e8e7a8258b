"""Knowledge-distillation losses and encoder-KD heads (counterpart of
``audiocaption_tpu/losses/kd.py``).

Token-level KD: the student's logits against the teacher's (KL at a
temperature, or L2 / L1 on the logits), length-masked; ``sup_kd_loss``
mixes the supervised loss with it.  Encoder KD: projection heads and a
contrastive (bidirectional InfoNCE, learnable logit scale) or MSE
objective on the student's pooled embedding and the teacher's.

The arithmetic is the JAX package's as written: the KL term is
``t_p * (log(max(t_p, 1e-10)) - log_softmax(s / T)) * T^2`` summed over
the vocabulary (``F.kl_div`` clamps and reduces otherwise), and the
InfoNCE takes ``log_softmax`` of both directions' logits.  The heads'
linears are ``nn.Linear`` with flax ``Dense``'s initialisation (LeCun
normal kernel, zero bias) where the JAX head draws its own weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from audiocaption_tpu_torch.ops.masking import length_mask


def token_kd_loss(student_logit: torch.Tensor, teacher_logit: torch.Tensor,
                  tgt_len: torch.Tensor, kd_type: str = "kl",
                  temperature: float = 1.0) -> torch.Tensor:
    """Length-masked token-level KD: the mean over the first ``tgt_len``
    positions of each row of the per-token divergence ("kl", "l2", "l1")."""
    mask = length_mask(tgt_len, student_logit.shape[1]).float()
    if kd_type == "kl":
        t = temperature
        s_lp = F.log_softmax(student_logit / t, dim=-1)
        t_p = F.softmax(teacher_logit / t, dim=-1)
        loss = torch.sum(t_p * (torch.log(t_p.clamp(min=1e-10)) - s_lp),
                         dim=-1) * (t * t)
    elif kd_type == "l2":
        loss = ((student_logit - teacher_logit) ** 2).mean(-1)
    elif kd_type == "l1":
        loss = (student_logit - teacher_logit).abs().mean(-1)
    else:
        raise ValueError(kd_type)
    return (loss * mask).sum() / mask.sum()


def sup_kd_loss(sup_loss: torch.Tensor, kd_loss: torch.Tensor,
                kd_weight: float = 0.5) -> torch.Tensor:
    """(1 - w) * supervised + w * KD."""
    return (1.0 - kd_weight) * sup_loss + kd_weight * kd_loss


def info_nce_loss(stdnt_emb: torch.Tensor, tchr_emb: torch.Tensor,
                  logit_scale: torch.Tensor) -> torch.Tensor:
    """Bidirectional InfoNCE over the batch: row i of the student matches
    row i of the teacher, L2-normalised, cosine logits times
    ``logit_scale``; the mean of both directions' cross entropies."""
    s = stdnt_emb / torch.linalg.norm(stdnt_emb, dim=-1, keepdim=True)
    t = tchr_emb / torch.linalg.norm(tchr_emb, dim=-1, keepdim=True)
    logits = logit_scale * (s @ t.T)
    labels = torch.arange(logits.shape[0], device=logits.device)[:, None]
    lp1 = F.log_softmax(logits, dim=-1)
    lp2 = F.log_softmax(logits.T, dim=-1)
    loss1 = -torch.gather(lp1, 1, labels).mean()
    loss2 = -torch.gather(lp2, 1, labels).mean()
    return (loss1 + loss2) / 2


def dense_init(layer: nn.Linear, generator: torch.Generator) -> nn.Linear:
    """flax ``Dense``'s default initialisation: kernel LeCun normal
    (a normal of std 1 / sqrt(fan_in) truncated at 2 std, rescaled as
    ``variance_scaling`` does), bias zero."""
    std = 1.0 / math.sqrt(layer.in_features) / 0.87962566103423978
    with torch.no_grad():
        w = torch.empty(layer.weight.shape)
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        layer.weight.copy_(w * std)
        layer.bias.zero_()
    return layer


class ContraEncoderKdHead(nn.Module):
    """Student and teacher projections to ``shared_dim`` and a logit scale
    (``log(1 / 0.07)``); ``forward(stdnt_fc_emb, tchr_emb)`` ->
    ``info_nce_loss(s, t, exp(logit_scale))``."""

    def __init__(self, stdnt_dim: int, tchr_dim: int, shared_dim: int = 1024,
                 generator: torch.Generator = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator()
        self.stdnt_proj = dense_init(nn.Linear(stdnt_dim, shared_dim), gen)
        self.tchr_proj = dense_init(nn.Linear(tchr_dim, shared_dim), gen)
        self.logit_scale = nn.Parameter(
            torch.tensor(math.log(1 / 0.07), dtype=torch.float32))

    def forward(self, stdnt_fc_emb: torch.Tensor, tchr_emb: torch.Tensor
                ) -> torch.Tensor:
        return info_nce_loss(self.stdnt_proj(stdnt_fc_emb),
                             self.tchr_proj(tchr_emb),
                             torch.exp(self.logit_scale))


class MseEncoderKdHead(nn.Module):
    """The student's embedding projected to the teacher's width (or both
    to ``shared_dim`` with ``use_tchr_proj``) and regressed:
    ``mean((s - t)^2)``."""

    def __init__(self, stdnt_dim: int, tchr_dim: int = 768,
                 use_tchr_proj: bool = False, shared_dim: int = 1024,
                 generator: torch.Generator = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator()
        out = shared_dim if use_tchr_proj else tchr_dim
        self.stdnt_proj = dense_init(nn.Linear(stdnt_dim, out), gen)
        self.tchr_proj = (dense_init(nn.Linear(tchr_dim, shared_dim), gen)
                          if use_tchr_proj else None)

    def forward(self, stdnt_fc_emb: torch.Tensor, tchr_emb: torch.Tensor
                ) -> torch.Tensor:
        s = self.stdnt_proj(stdnt_fc_emb)
        t = self.tchr_proj(tchr_emb) if self.tchr_proj is not None \
            else tchr_emb
        return ((s - t) ** 2).mean()


class WmlEncoderKdHead(nn.Module):
    """Weighted multi-layer distillation: softmax weights (initially
    equal) over ``n_layers`` per-layer mean distances."""

    def __init__(self, n_layers: int = 4):
        super().__init__()
        self.layer_weights = nn.Parameter(torch.zeros(n_layers))

    def forward(self, layer_dists: torch.Tensor) -> torch.Tensor:
        return torch.sum(torch.softmax(self.layer_weights, dim=0)
                         * layer_dists)
