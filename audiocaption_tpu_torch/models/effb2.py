"""EfficientNet-B2 audio encoder (counterpart of
``audiocaption_tpu/models/effb2.py``).

Spectrograms enter as one-channel images with mel bins on H and time on
W ('b t f -> b 1 f t').  The backbone is EfficientNet (width 1.1,
depth 1.2, head 1408, swish, SE 0.25) with static TF-SAME padding
computed from the nominal 260x260 image, tracked block by block, not
from the input size: efficientnet_pytorch bakes its padding that way.

Module names follow efficientnet_pytorch (``_conv_stem``, ``_bn0``,
``_blocks.{i}._expand_conv`` ...), so the encoder part of a reference
checkpoint loads with a plain ``load_state_dict``.

Output: {fc_emb [B, 1408], attn_emb [B, T // 32, 1408], attn_emb_len [B]}
with ``attn_emb`` the mean over the frequency axis and ``fc_emb`` the
length-masked mean of ``attn_emb``, both float32.  ``compute_dtype``
(float32 or bfloat16) is the convolutions' and the activations' dtype,
as in the JAX package (``layers.py``'s rules); the mean is taken in it
and cast to float32.

The pruned family (reference ``get_pruned_model``): ``build_pruned_effb2``
ranks and slices the filters of a full encoder into a
``PrunedEfficientNetB2``, whose blocks carry free expanded and squeeze
widths (``oup_override`` / ``squeeze_override``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiocaption_tpu_torch.models.layers import (
    BatchNorm2d, Conv2dSame, sigmoid, silu, widen)
from audiocaption_tpu_torch.ops.masking import mean_with_lens

# EfficientNet-B0 block args: (repeats, kernel, stride, expand, in, out)
_B0_BLOCKS = [
    (1, 3, 1, 1, 32, 16),
    (2, 3, 2, 6, 16, 24),
    (2, 5, 2, 6, 24, 40),
    (3, 3, 2, 6, 40, 80),
    (3, 5, 1, 6, 80, 112),
    (4, 5, 2, 6, 112, 192),
    (1, 3, 1, 6, 192, 320),
]
_SE_RATIO = 0.25
_BN_EPS = 1e-3
# torch momentum of every EffB2 BN: the JAX blocks' flax 0.99
# (audiocaption_tpu/models/effb2.py:89,174,190)
_BN_MOMENTUM = 0.01


def round_filters(filters: float, width: float, divisor: int = 8) -> int:
    """efficientnet_pytorch round_filters."""
    filters *= width
    new_f = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * filters:
        new_f += divisor
    return int(new_f)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def tf_same_padding(image_size: int, kernel: int, stride: int
                    ) -> Tuple[int, int, int, int]:
    """Static TF-SAME padding (top, bottom, left, right) for a square
    nominal image (efficientnet_pytorch Conv2dStaticSamePadding)."""
    oh = math.ceil(image_size / stride)
    pad = max((oh - 1) * stride + kernel - image_size, 0)
    lo, hi = pad // 2, pad - pad // 2
    return (lo, hi, lo, hi)


def b2_block_plan(width: float = 1.1, depth: float = 1.2,
                  image_size: int = 260) -> List[Dict]:
    """Per-block build plan for B2, tracking the nominal image size."""
    plan = []
    size = math.ceil(image_size / 2)  # after the stride-2 stem
    for (r, k, s, e, i, o) in _B0_BLOCKS:
        i_r, o_r = round_filters(i, width), round_filters(o, width)
        for rep in range(round_repeats(r, depth)):
            stride = s if rep == 0 else 1
            plan.append(dict(in_filters=i_r if rep == 0 else o_r,
                             out_filters=o_r, kernel=k, stride=stride,
                             nominal_size=size, expand_ratio=e))
            if stride > 1:
                size = math.ceil(size / stride)
    return plan


class MBConvBlock(nn.Module):
    """Inverted-residual block with squeeze-and-excitation, swish and
    drop-connect.

    ``oup_override`` / ``squeeze_override`` set the expanded and squeeze
    widths of a structurally pruned block (``build_pruned_effb2``);
    ``plan`` keeps the constructor's arguments but ``drop_rate``, which
    the encoder sets from the block's index.  In ``train()`` a skip
    block drops its residual branch per sample at ``drop_rate`` (the
    JAX block's mask ``floor(keep + U)``, branch scaled by 1 / keep)."""

    def __init__(self, in_filters: int, out_filters: int, kernel: int,
                 stride: int, expand_ratio: int, nominal_size: int,
                 oup_override: Optional[int] = None,
                 squeeze_override: Optional[int] = None,
                 drop_rate: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.drop_rate = drop_rate
        self.plan = dict(in_filters=in_filters, out_filters=out_filters,
                         kernel=kernel, stride=stride,
                         expand_ratio=expand_ratio, nominal_size=nominal_size,
                         oup_override=oup_override,
                         squeeze_override=squeeze_override)
        cd = self.compute_dtype = compute_dtype
        oup = (oup_override if oup_override is not None
               else in_filters * expand_ratio)
        self.has_expand = expand_ratio != 1
        self.has_skip = stride == 1 and in_filters == out_filters
        if self.has_expand:
            self._expand_conv = Conv2dSame(in_filters, oup, 1,
                                           compute_dtype=cd)
            self._bn0 = BatchNorm2d(oup, eps=_BN_EPS, momentum=_BN_MOMENTUM,
                                    compute_dtype=cd)
        self._depthwise_conv = Conv2dSame(
            oup, oup, kernel, stride=stride, groups=oup,
            padding4=tf_same_padding(nominal_size, kernel, stride),
            compute_dtype=cd)
        self._bn1 = BatchNorm2d(oup, eps=_BN_EPS, momentum=_BN_MOMENTUM,
                                compute_dtype=cd)
        # SE channel count comes from the block's *input* filters
        n_squeeze = (squeeze_override if squeeze_override is not None
                     else max(1, int(in_filters * _SE_RATIO)))
        self._se_reduce = Conv2dSame(oup, n_squeeze, 1, bias=True,
                                     compute_dtype=cd)
        self._se_expand = Conv2dSame(n_squeeze, oup, 1, bias=True,
                                     compute_dtype=cd)
        self._project_conv = Conv2dSame(oup, out_filters, 1, compute_dtype=cd)
        self._bn2 = BatchNorm2d(out_filters, eps=_BN_EPS,
                                momentum=_BN_MOMENTUM, compute_dtype=cd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inputs = x
        if self.has_expand:
            x = silu(self._bn0(self._expand_conv(x)))
        x = silu(self._bn1(self._depthwise_conv(x)))
        # SE mean over the whole padded map (not length-masked)
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self._se_expand(silu(self._se_reduce(s)))
        x = sigmoid(s) * x
        x = self._bn2(self._project_conv(x))
        if self.has_skip:
            if self.training and self.drop_rate > 0:
                x = drop_connect(x, self.drop_rate)
            x = x + inputs
        return x


def drop_connect(x: torch.Tensor, rate: float) -> torch.Tensor:
    """Per-sample drop of the residual branch ``x`` [B, C, H, W]: a
    sample's branch is zeroed with probability ``rate``, else scaled by
    1 / (1 - rate)."""
    keep = 1.0 - rate
    u = torch.rand(x.shape[0], 1, 1, 1, device=x.device, dtype=torch.float32)
    mask = torch.floor(keep + u)
    return x / keep * mask.to(x.dtype)


class EfficientNetB2(nn.Module):
    """EfficientNet-B2 feature extractor, one input channel, no top.

    The stem and head widths and the block plan default to B2's; the
    pruned family passes its own (``PrunedEfficientNetB2``).  Block
    ``idx`` of ``n`` drops its residual branch at ``drop_connect_rate *
    idx / n`` in ``train()``, as the JAX encoder does (its :184)."""

    downsample_ratio = 32

    def __init__(self, stem_filters: Optional[int] = None,
                 head_filters: Optional[int] = None,
                 block_plan: Optional[Sequence[Dict]] = None,
                 compute_dtype: torch.dtype = torch.float32,
                 drop_connect_rate: float = 0.2):
        super().__init__()
        cd = self.compute_dtype = compute_dtype
        stem = stem_filters or round_filters(32, 1.1)
        self._conv_stem = Conv2dSame(1, stem, 3, stride=2,
                                     padding4=tf_same_padding(260, 3, 2),
                                     compute_dtype=cd)
        self._bn0 = BatchNorm2d(stem, eps=_BN_EPS, momentum=_BN_MOMENTUM,
                                compute_dtype=cd)
        self.drop_connect_rate = drop_connect_rate
        plan = block_plan or b2_block_plan()
        self._blocks = nn.ModuleList(
            MBConvBlock(**a, compute_dtype=cd,
                        drop_rate=drop_connect_rate * idx / len(plan))
            for idx, a in enumerate(plan))
        head = head_filters or round_filters(1280, 1.1)
        self._conv_head = Conv2dSame(
            self._blocks[-1]._project_conv.out_channels, head, 1,
            compute_dtype=cd)
        self._bn1 = BatchNorm2d(head, eps=_BN_EPS, momentum=_BN_MOMENTUM,
                                compute_dtype=cd)
        self.fc_emb_size = head

    def forward(self, lms: torch.Tensor, feat_len: torch.Tensor,
                blocks: Optional[Sequence[Callable]] = None
                ) -> Dict[str, torch.Tensor]:
        """lms [B, T, n_mels], feat_len [B] -> encoder outputs.  ``blocks``,
        one callable per block, stands in for the block modules (the
        folded walk of ``ops/fused_mbconv.py``)."""
        x = lms.transpose(1, 2)[:, None]                  # [B, 1, F, T]
        x = silu(self._bn0(self._conv_stem(x)))
        for block in (self._blocks if blocks is None else blocks):
            x = block(x)
        x = silu(self._bn1(self._conv_head(x)))
        attn_emb = widen(x.mean(dim=2).transpose(1, 2))   # [B, T', C]
        out_len = torch.div(feat_len, self.downsample_ratio,
                            rounding_mode="floor")
        return {"fc_emb": mean_with_lens(attn_emb, out_len),
                "attn_emb": attn_emb, "attn_emb_len": out_len}


class PrunedEfficientNetB2(EfficientNetB2):
    """EfficientNet-B2 with explicit per-layer widths, as
    ``build_pruned_effb2`` produces it (reference ``get_pruned_model``)."""

    def __init__(self, stem_filters: int, head_filters: int,
                 block_plan: Sequence[Dict],
                 compute_dtype: torch.dtype = torch.float32,
                 drop_connect_rate: float = 0.2):
        super().__init__(stem_filters, head_filters, block_plan,
                         compute_dtype, drop_connect_rate)

    @property
    def block_plan(self) -> Tuple[Dict, ...]:
        return tuple(b.plan for b in self._blocks)


def _flax_view(weight: np.ndarray) -> np.ndarray:
    """torch conv weight [O, I, kh, kw] -> flax kernel [kh, kw, I, O]."""
    return np.ascontiguousarray(weight.transpose(2, 3, 1, 0))


@torch.no_grad()
def build_pruned_effb2(encoder: EfficientNetB2, prune_ratio: float,
                       prune_start_layer: int = 0, prune_se: bool = True,
                       method: str = "operator_norm", prune_head: bool = True
                       ) -> PrunedEfficientNetB2:
    """Structured filter pruning of a full ``EfficientNetB2`` (counterpart
    of the JAX ``build_pruned_effb2``; reference ``get_pruned_model``).

    The chain stem -> (expand -> depthwise -> se_reduce -> se_expand ->
    project)* -> head is walked as the reference walks it: each prunable
    conv keeps ``round(n * (1 - ratio))`` of its output filters, ranked on
    its full (unsliced) weight; the next conv's inputs follow the previous
    keep set; the depthwise inherits the previous keep set.  Blocks from
    ``max(prune_start_layer - 1, 0)`` on are pruned.  ``se_expand`` keeps
    the first ``oup`` of its own ranking and the projection's inputs follow
    that set, so the SE gate multiplies the depthwise channels by position.
    ``prune_head=False`` keeps the 1408-wide output.  Returns the pruned
    encoder, loaded, in eval mode, on ``encoder``'s device, in its
    ``compute_dtype``."""
    from audiocaption_tpu_torch.utils.pruning import select_filters

    sd = {k: v.detach().cpu().numpy() for k, v in encoder.state_dict().items()}
    plan = [b.plan for b in encoder._blocks]
    ratio = prune_ratio
    out: Dict[str, np.ndarray] = {}

    def rank(name: str) -> np.ndarray:
        return select_filters(_flax_view(sd[f"{name}.weight"]), ratio, method)

    def conv(name: str, keep_out, keep_in=None) -> None:
        w = sd[f"{name}.weight"][keep_out]
        out[f"{name}.weight"] = w if keep_in is None else w[:, keep_in]
        if f"{name}.bias" in sd:
            out[f"{name}.bias"] = sd[f"{name}.bias"][keep_out]

    def bn(name: str, keep) -> None:
        for p in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.{p}"] = sd[f"{name}.{p}"][keep]
        out[f"{name}.num_batches_tracked"] = sd[f"{name}.num_batches_tracked"]

    def n_out(name: str) -> int:
        return sd[f"{name}.weight"].shape[0]

    keep_prev = (rank("_conv_stem") if prune_start_layer <= 0
                 else np.arange(n_out("_conv_stem")))
    conv("_conv_stem", keep_prev)
    bn("_bn0", keep_prev)
    stem_filters = len(keep_prev)

    block_plan: List[Dict] = []
    for idx, args in enumerate(plan):
        tp = f"_blocks.{idx}"
        prune_this = (idx >= max(prune_start_layer - 1, 0)
                      if prune_start_layer > 0 else True)
        if args["expand_ratio"] != 1:
            keep = (rank(f"{tp}._expand_conv") if prune_this
                    else np.arange(n_out(f"{tp}._expand_conv")))
            conv(f"{tp}._expand_conv", keep, keep_prev)
            bn(f"{tp}._bn0", keep)
            keep_prev = keep
        # the depthwise inherits the previous conv's keep set
        conv(f"{tp}._depthwise_conv", keep_prev)
        bn(f"{tp}._bn1", keep_prev)
        oup = len(keep_prev)
        keep_sq = (rank(f"{tp}._se_reduce") if prune_se and prune_this
                   else np.arange(n_out(f"{tp}._se_reduce")))
        conv(f"{tp}._se_reduce", keep_sq, keep_prev)
        keep_se_out = (rank(f"{tp}._se_expand")[:oup] if prune_this
                       else np.arange(oup))
        conv(f"{tp}._se_expand", keep_se_out, keep_sq)
        keep_out = (rank(f"{tp}._project_conv") if prune_this
                    else np.arange(n_out(f"{tp}._project_conv")))
        conv(f"{tp}._project_conv", keep_out, keep_se_out)
        bn(f"{tp}._bn2", keep_out)
        block_plan.append(dict(
            in_filters=stem_filters if idx == 0
            else block_plan[-1]["out_filters"],
            out_filters=len(keep_out), kernel=args["kernel"],
            stride=args["stride"], expand_ratio=args["expand_ratio"],
            nominal_size=args["nominal_size"], oup_override=oup,
            squeeze_override=len(keep_sq)))
        keep_prev = keep_out

    keep_head = (rank("_conv_head") if prune_head
                 else np.arange(n_out("_conv_head")))
    conv("_conv_head", keep_head, keep_prev)
    bn("_bn1", keep_head)

    pruned = PrunedEfficientNetB2(stem_filters, len(keep_head), block_plan,
                                  encoder.compute_dtype,
                                  encoder.drop_connect_rate)
    pruned.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                            for k, v in out.items()})
    device = next(encoder.parameters()).device
    return pruned.to(device).eval()
