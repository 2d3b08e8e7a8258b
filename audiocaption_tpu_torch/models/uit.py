"""UiT audio transformers (counterpart of ``audiocaption_tpu/models/uit.py``).

  * :class:`UITBase`: the 16 kHz log-mel (``UIT_MEL_16K``: n_fft 512, hop
    160, 64 htk mels, f_max 8000, dB with top_db 120) -> ``init_bn`` over
    the mel bins -> 16x16 / 16 conv patches -> separable time and
    frequency position tables (+ a CLS token for ``pooling="token"``) ->
    pre-norm transformer blocks -> LayerNorm -> (LayerNorm + linear) head
    with a sigmoid, pooled by "token", "mean" or "dm"; in ``eval()`` a
    clip longer than ``target_length`` frames is cut into windows of
    ``target_length`` (the last one ending at the clip's end) whose
    outputs are averaged ("mean") or maxed ("max");
  * :class:`BNeckAttention`: qkv into a dim // 4 bottleneck split over the
    heads, with the softmax scale (dim // heads)^-0.5 of the full width,
    a quirk of the reference that its checkpoints need;
  * :class:`Attention`: plain multi-head attention;
  * the published variants (:data:`UIT_VARIANTS`) and the zenodo
    checkpoints' sizes (:data:`UIT_PRETRAINED_KWARGS`);
  * :class:`UitEncoder`: a trunk as a captioning encoder, the time patches'
    tokens (frequency patches averaged) as ``attn_emb``.

LayerNorms use eps 1e-6 (flax ``nn.LayerNorm``'s default, which the JAX
module takes everywhere); GELU is the tanh approximation (flax
``nn.gelu``'s default).  No dropout.  Module names are the reference
checkpoint keys that the JAX ``convert_uit`` reads: ``init_bn.1``,
``patch_embed.proj``, ``cls_token``, ``token_pos_embed``,
``time_pos_embed`` [1, E, 1, grid_t], ``freq_pos_embed`` [1, E, grid_f,
1], ``blocks.{i}.{norm1, attn.{qkv, proj}, norm2, mlp.{fc1, fc2},
ls1.gamma, ls2.gamma}``, ``norm``, ``outputlayer.{0, 1}``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from audiocaption_tpu_torch.ops.frontend import LogMelFrontend, MelConfig
from audiocaption_tpu_torch.ops.masking import mean_with_lens

# its own constant, equal in value to EFFB2_MEL_16K
UIT_MEL_16K = MelConfig(sample_rate=16000, f_min=0.0, f_max=8000.0,
                        norm=None, mel_scale="htk", top_db=120.0)


class BNeckAttention(nn.Module):
    """Bottleneck attention: qkv -> 3 x dim // 4, the scale from the FULL
    per-head width (dim // heads)."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False):
        super().__init__()
        self.num_heads, self.inner = num_heads, dim // 4
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, self.inner * 3, bias=qkv_bias)
        self.proj = nn.Linear(self.inner, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _attend(self, x, self.inner)


class Attention(nn.Module):
    """Standard ViT attention, scale (dim // heads)^-0.5."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False):
        super().__init__()
        self.num_heads, self.inner = num_heads, dim
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _attend(self, x, self.inner)


def _attend(mod, x: torch.Tensor, inner: int) -> torch.Tensor:
    B, N, _ = x.shape
    H = mod.num_heads
    qkv = mod.qkv(x).reshape(B, N, 3, H, inner // H)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * mod.scale
    attn = torch.softmax(attn, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(B, N, inner)
    return mod.proj(out)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, act: str):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        h = F.relu(h) if self.act == "relu" else F.gelu(h, approximate="tanh")
        return self.fc2(h)


class Block(nn.Module):
    """Pre-norm transformer block; LayerScale when ``init_values`` is
    set (no drop path: every published variant has a rate of 0)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, init_values: Optional[float] = None,
                 act: str = "gelu", attention_type: str = "Attention"):
        super().__init__()
        attn_cls = (BNeckAttention if attention_type == "BNeckAttention"
                    else Attention)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = attn_cls(dim, num_heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), act)
        if init_values:
            self.ls1 = LayerScale(dim, init_values)
            self.ls2 = LayerScale(dim, init_values)
        self.layer_scale = bool(init_values)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.attn(self.norm1(x))
        x = x + (self.ls1(h) if self.layer_scale else h)
        h = self.mlp(self.norm2(x))
        return x + (self.ls2(h) if self.layer_scale else h)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, patch_stride: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(1, embed_dim, patch_size, stride=patch_stride)


class UITBase(nn.Module):
    """The reference UITBase: waveform [B, T] (16 kHz) -> class
    probabilities [B, outputdim].  ``classifier`` False leaves out the
    head (``outputlayer``): a captioning encoder's trunk has none, as the
    JAX encoder has no variables for it."""

    def __init__(self, outputdim: int = 527, patch_size: int = 16,
                 patch_stride: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 init_values: Optional[float] = None,
                 target_length: int = 1012, pooling: str = "mean",
                 n_mels: int = 64, act: str = "gelu",
                 attention_type: str = "Attention", eval_avg: str = "mean",
                 mel: MelConfig = UIT_MEL_16K, classifier: bool = True):
        super().__init__()
        if pooling not in ("mean", "token", "dm"):
            raise ValueError(f"unknown pooling {pooling!r}")
        self.patch_stride, self.embed_dim = patch_stride, embed_dim
        self.depth, self.target_length = depth, target_length
        self.pooling, self.eval_avg = pooling, eval_avg
        self.grid_f = n_mels // patch_stride
        self.grid_t = target_length // patch_stride
        self.frontend = LogMelFrontend(mel)
        self.init_bn = nn.Sequential(nn.Identity(), nn.BatchNorm2d(
            n_mels, momentum=0.01))
        self.patch_embed = PatchEmbed(patch_size, patch_stride, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.token_pos_embed = nn.Parameter(torch.zeros(1, embed_dim))
        self.time_pos_embed = nn.Parameter(
            torch.zeros(1, embed_dim, 1, self.grid_t))
        self.freq_pos_embed = nn.Parameter(
            torch.zeros(1, embed_dim, self.grid_f, 1))
        for p_, std in ((self.cls_token, 1e-6), (self.token_pos_embed, 0.02),
                        (self.time_pos_embed, 0.02),
                        (self.freq_pos_embed, 0.02)):
            nn.init.normal_(p_, std=std)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, init_values,
                  act, attention_type) for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
        if classifier:
            self.outputlayer = nn.Sequential(
                nn.LayerNorm(embed_dim, eps=1e-6),
                nn.Linear(embed_dim, outputdim))

    def normed_spectrogram(self, lms: torch.Tensor) -> torch.Tensor:
        """log-mel [B, T, M] -> ``init_bn``-normalised image [B, 1, M, T]."""
        x = self.init_bn[1](lms.transpose(1, 2).contiguous()[..., None])
        return x[..., 0][:, None]

    def forward_features(self, img: torch.Tensor) -> torch.Tensor:
        """[B, 1, M, T] -> tokens [B, (f t) (+ 1), E], f outer."""
        x = self.patch_embed.proj(img)                    # [B, E, f, t]
        t = x.shape[3]
        x = x + self.time_pos_embed[:, :, :, :t] + self.freq_pos_embed
        B, E, f, t = x.shape
        x = x.permute(0, 2, 3, 1).reshape(B, f * t, E)
        if self.pooling == "token":
            cls = (self.cls_token + self.token_pos_embed).expand(B, 1, E)
            x = torch.cat([cls, x], dim=1)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        if self.pooling == "token":
            pooled = x[:, 0]
        elif self.pooling == "mean":
            pooled = x.mean(dim=1)
        else:                                             # "dm"
            B, N, E = x.shape
            x = x.reshape(B, self.grid_f, N // self.grid_f, E).mean(dim=1)
            return torch.sigmoid(self.outputlayer(x)).mean(dim=1)
        return torch.sigmoid(self.outputlayer(pooled))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            lms = self.frontend(wav)
        img = self.normed_spectrogram(lms)
        T, tl = img.shape[3], self.target_length
        if self.training or T <= tl:
            return self.forward_head(self.forward_features(
                img[..., :min(T, tl)]))
        outs = []
        for s in range(0, T, tl):
            chunk = img[..., s:s + tl]
            if chunk.shape[3] != tl:                      # the last window
                chunk = img[..., T - tl:]
            outs.append(self.forward_head(self.forward_features(chunk)))
        stacked = torch.stack(outs, dim=-1)
        if self.eval_avg == "mean":
            return stacked.mean(dim=-1)
        if self.eval_avg == "max":
            return stacked.amax(dim=-1)
        raise ValueError(self.eval_avg)


_BNECK = dict(patch_size=16, embed_dim=128, num_heads=2, mlp_ratio=3.0,
              pooling="mean", act="relu", attention_type="BNeckAttention")
_H128 = dict(patch_size=16, embed_dim=128, num_heads=2, mlp_ratio=3.0,
             pooling="mean")


def _variant(**kw):
    def make(**overrides) -> UITBase:
        return UITBase(**dict(kw, **overrides))
    return make


UIT_VARIANTS = {
    "uit_xs": _variant(depth=12, **_BNECK),
    "uit_xxs": _variant(depth=6, **_BNECK),
    "uit_xxxs": _variant(depth=4, **_BNECK),
    "audio_transformer_h128_d4_m3": _variant(depth=4, **_H128),
    "audio_transformer_h128_d4_m3_relu": _variant(depth=4, act="relu",
                                                  **_H128),
    "audio_transformer_h128_d6_m3": _variant(depth=6, **_H128),
}

# the zenodo checkpoints' output width and target length
UIT_PRETRAINED_KWARGS = {"outputdim": 537, "target_length": 102}


class UitEncoder(nn.Module):
    """A UiT trunk as a captioning encoder: log-mel [B, T, 64] (16 kHz)
    cut to ``target_length`` frames -> tokens (the CLS token dropped) with
    the frequency patches averaged -> ``attn_emb`` [B, t, E],
    ``attn_emb_len = min(feat_len // patch_stride, t)`` (at least 1),
    ``fc_emb`` the masked mean."""

    def __init__(self, trunk: UITBase):
        super().__init__()
        self.trunk = trunk
        self.fc_emb_size = self.attn_emb_size = trunk.embed_dim

    def forward(self, lms: torch.Tensor, feat_len: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        tr = self.trunk
        img = tr.normed_spectrogram(lms)[..., :tr.target_length]
        tokens = tr.forward_features(img)
        if tr.pooling == "token":
            tokens = tokens[:, 1:]
        B, N, E = tokens.shape
        attn_emb = tokens.reshape(B, tr.grid_f, N // tr.grid_f, E).mean(dim=1)
        attn_emb_len = torch.clamp(torch.div(
            feat_len, tr.patch_stride, rounding_mode="floor"),
            min=1, max=attn_emb.shape[1])
        return {"fc_emb": mean_with_lens(attn_emb, attn_emb_len),
                "attn_emb": attn_emb, "attn_emb_len": attn_emb_len}
