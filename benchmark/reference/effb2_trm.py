"""Plain reference of ``effb2_trm``: the HF ``wsntxxn/effb2-trm-audiocaps
-captioning`` model.  A 16 kHz log-mel (torchaudio defaults: htk scale, no
norm, f_min 0, f_max 8 kHz, top_db 120) read as a one-channel image with
mel bins on H and time on W; EfficientNet-B2 (width 1.1, depth 1.2, swish,
squeeze-excitation 0.25, TF-SAME padding baked from the nominal 260 x 260
image as efficientnet_pytorch bakes it), the frequency mean of its 1408
channels as the memory, of length frames // 32; a 2-layer transformer
decoder, width 256, tied.  Parameter names are efficientnet_pytorch's
and the reference decoder's."""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from reference.common import Mel, TransformerDecoder, log_mel

MEL = Mel(sample_rate=16000, n_fft=512, hop=160, n_mels=64, f_min=0.0,
          f_max=8000.0, norm=None, mel_scale="htk", top_db=120.0)
# EfficientNet-B0 stages: (repeats, kernel, stride, expand, in, out)
B0 = [(1, 3, 1, 1, 32, 16), (2, 3, 2, 6, 16, 24), (2, 5, 2, 6, 24, 40),
      (3, 3, 2, 6, 40, 80), (3, 5, 1, 6, 80, 112), (4, 5, 2, 6, 112, 192),
      (1, 3, 1, 6, 192, 320)]


def round_filters(f: float, width: float = 1.1, divisor: int = 8) -> int:
    f *= width
    new = max(divisor, int(f + divisor / 2) // divisor * divisor)
    return int(new + divisor if new < 0.9 * f else new)


def same_pad(size: int, k: int, s: int):
    """(left, right, top, bottom) TF-SAME padding of a size x size image."""
    pad = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return (pad // 2, pad - pad // 2, pad // 2, pad - pad // 2)


def block_plan() -> List[Dict]:
    plan, size = [], math.ceil(260 / 2)
    for r, k, s, e, i, o in B0:
        i, o = round_filters(i), round_filters(o)
        for rep in range(int(math.ceil(1.2 * r))):
            stride = s if rep == 0 else 1
            plan.append(dict(cin=i if rep == 0 else o, cout=o, k=k,
                             stride=stride, expand=e, size=size))
            if stride > 1:
                size = math.ceil(size / stride)
    return plan


def bn(n: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(n, eps=1e-3)


class MBConv(nn.Module):
    def __init__(self, cin, cout, k, stride, expand, size):
        super().__init__()
        mid = cin * expand
        self.expand, self.skip = expand != 1, stride == 1 and cin == cout
        if self.expand:
            self._expand_conv = nn.Conv2d(cin, mid, 1, bias=False)
            self._bn0 = bn(mid)
        self.pad = same_pad(size, k, stride)
        self._depthwise_conv = nn.Conv2d(mid, mid, k, stride, groups=mid,
                                         bias=False)
        self._bn1 = bn(mid)
        sq = max(1, int(cin * 0.25))
        self._se_reduce = nn.Conv2d(mid, sq, 1)
        self._se_expand = nn.Conv2d(sq, mid, 1)
        self._project_conv = nn.Conv2d(mid, cout, 1, bias=False)
        self._bn2 = bn(cout)

    def forward(self, x):
        y = F.silu(self._bn0(self._expand_conv(x))) if self.expand else x
        y = F.silu(self._bn1(self._depthwise_conv(F.pad(y, self.pad))))
        s = y.mean(dim=(2, 3), keepdim=True)
        y = torch.sigmoid(self._se_expand(F.silu(self._se_reduce(s)))) * y
        y = self._bn2(self._project_conv(y))
        return y + x if self.skip else y


class EfficientNetB2(nn.Module):
    def __init__(self):
        super().__init__()
        stem = round_filters(32)
        self._conv_stem = nn.Conv2d(1, stem, 3, 2, bias=False)
        self._bn0 = bn(stem)
        self._blocks = nn.ModuleList(MBConv(**p) for p in block_plan())
        self._conv_head = nn.Conv2d(self._blocks[-1]._project_conv.out_channels,
                                    round_filters(1280), 1, bias=False)
        self._bn1 = bn(round_filters(1280))
        # the classifier head of the checkpoint; the captioner reads none
        self.fc_emb_size = round_filters(1280)

    def forward(self, lms, frames):
        x = lms.transpose(1, 2)[:, None]                     # [B, 1, F, T]
        x = F.silu(self._bn0(self._conv_stem(F.pad(x, same_pad(260, 3, 2)))))
        for block in self._blocks:
            x = block(x)
        x = F.silu(self._bn1(self._conv_head(x)))
        return x.mean(dim=2).transpose(1, 2), frames // 32


class Captioner(nn.Module):
    mel = MEL

    def __init__(self, config: Dict):
        super().__init__()
        self.encoder = EfficientNetB2()
        self.decoder = TransformerDecoder(
            config["decoder_emb_dim"], config["vocab_size"],
            self.encoder.fc_emb_size, config["decoder_n_layers"],
            config["decoder_tie_weights"], config["decoder_dropout"])

    def fixed(self) -> Dict[str, torch.Tensor]:
        return self.decoder.fixed("decoder.")

    def encode(self, wav: torch.Tensor, wav_len: torch.Tensor):
        """-> (memory [B, S, d], memory mask [B, S], True = padding)."""
        with torch.no_grad():
            lms = log_mel(wav, MEL)
        attn, attn_len = self.encoder(lms, MEL.frames(wav_len))
        return self.decoder.memory(attn, attn_len)
