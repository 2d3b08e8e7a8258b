"""Fused stride-1 MBConv block with BatchNorm folded: the CUDA kernel
``csrc/fused_mbconv.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``audiocaption_tpu/ops/pallas_mbconv.py``
(``_mbconv_s1_kernel`` :102-159, wrapper ``fused_mbconv_s1`` :162-204;
folding ``fold_bn`` / ``pack_mbconv`` :54-91; XLA version ``xla_mbconv``
:207-234).  One EfficientNet block at inference:

    1x1 expand (BN folded) -> swish -> kxk depthwise (BN folded, static
    TF-SAME zero padding of the *expanded* map) -> swish -> SE (mean over
    the map, reduce, swish, expand, sigmoid, scale) -> 1x1 project (BN
    folded) -> + residual

Activations are the port's NCHW.  ``pack_mbconv`` folds a port
``MBConvBlock`` into the tensors the kernel reads, in the JAX package's
layouts (1x1 weights ``[in, out]``, depthwise ``[k, k, E]``) with 1-D
biases.  ``mbconv_plain`` computes the block from them for any stride;
``fused_mbconv_s1`` launches the kernel for a CUDA tensor (stride 1 only)
and runs ``mbconv_plain`` only for a CPU tensor.  ``folded_blocks`` walks
a whole (full or pruned) EffB2 encoder that way.

The JAX kernel zero-pads the block's *input* and expands the padded map,
so its border holds ``swish(b_exp)`` where the block pads the expanded map
with zeros; it agrees with the block only where the folded expand bias is
0 (flax's BN at init).  Both versions here compute the block's function,
which is ``xla_mbconv``'s.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from audiocaption_tpu_torch import cuda_build
from audiocaption_tpu_torch.models.effb2 import tf_same_padding


class MBConvSpec(NamedTuple):
    in_ch: int
    out_ch: int
    exp_ch: int
    kernel: int
    stride: int
    pad: Tuple[int, int, int, int]     # (top, bottom, left, right)
    has_expand: bool
    has_residual: bool


def spec_of(block) -> MBConvSpec:
    """The spec of a port ``MBConvBlock``, from its plan."""
    a = block.plan
    exp = (a["oup_override"] if a.get("oup_override") is not None
           else a["in_filters"] * a["expand_ratio"])
    return MBConvSpec(a["in_filters"], a["out_filters"], exp, a["kernel"],
                      a["stride"], tf_same_padding(a["nominal_size"],
                                                   a["kernel"], a["stride"]),
                      has_expand=a["expand_ratio"] != 1,
                      has_residual=block.has_skip)


def fold_bn(kernel: torch.Tensor, bias: Optional[torch.Tensor],
            bn: torch.nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold an eval BatchNorm into a conv kernel ``[..., O]`` (output
    channels last) and its bias ``[O]``, in float64, cast to float32."""
    scale = bn.weight.detach().double()
    shift = bn.bias.detach().double()
    mean = bn.running_mean.detach().double()
    var = bn.running_var.detach().double()
    inv = scale / torch.sqrt(var + bn.eps)
    k = kernel.detach().double() * inv
    b = torch.zeros_like(mean) if bias is None else bias.detach().double()
    b = (b - mean) * inv + shift
    return k.float().contiguous(), b.float().contiguous()


def pack_mbconv(block) -> Dict[str, torch.Tensor]:
    """A port ``MBConvBlock`` -> its folded tensors, on the block's device:
    ``w_exp`` [C, E], ``b_exp`` [E] (with expand), ``w_dw`` [k, k, E],
    ``b_dw`` [E], ``w_ser`` [E, S], ``b_ser`` [S], ``w_see`` [S, E],
    ``b_see`` [E], ``w_proj`` [E, Co], ``b_proj`` [Co]."""
    out: Dict[str, torch.Tensor] = {}

    def one_by_one(conv) -> torch.Tensor:          # [O, I, 1, 1] -> [I, O]
        return conv.weight.detach()[:, :, 0, 0].t()

    if block.has_expand:
        out["w_exp"], out["b_exp"] = fold_bn(one_by_one(block._expand_conv),
                                             None, block._bn0)
    out["w_dw"], out["b_dw"] = fold_bn(
        block._depthwise_conv.weight.detach()[:, 0].permute(1, 2, 0), None,
        block._bn1)
    for name, conv in (("ser", block._se_reduce), ("see", block._se_expand)):
        out[f"w_{name}"] = one_by_one(conv).float().contiguous()
        out[f"b_{name}"] = conv.bias.detach().float().contiguous()
    out["w_proj"], out["b_proj"] = fold_bn(one_by_one(block._project_conv),
                                           None, block._bn2)
    return out


def mbconv_plain(x: torch.Tensor, weights: Dict[str, torch.Tensor],
                 spec: MBConvSpec) -> torch.Tensor:
    """Plain PyTorch version of the folded block, any stride:
    x [B, C, H, W] -> [B, Co, Ho, Wo] (counterpart of ``xla_mbconv``)."""
    pt, pb, pl, pr = spec.pad
    e = x
    if spec.has_expand:
        e = F.silu(F.conv2d(x, weights["w_exp"].t()[:, :, None, None],
                            weights["b_exp"]))
    d = F.conv2d(F.pad(e, (pl, pr, pt, pb)),
                 weights["w_dw"].permute(2, 0, 1)[:, None], weights["b_dw"],
                 stride=spec.stride, groups=spec.exp_ch)
    d = F.silu(d)
    s = F.silu(d.mean(dim=(2, 3)) @ weights["w_ser"] + weights["b_ser"])
    g = torch.sigmoid(s @ weights["w_see"] + weights["b_see"])
    p = F.conv2d(d * g[:, :, None, None],
                 weights["w_proj"].t()[:, :, None, None], weights["b_proj"])
    return p + x if spec.has_residual else p


# -- the kernel ---------------------------------------------------------------

NT = 256                        # threads per block (csrc/fused_mbconv.cu)
SMEM_LIMIT = 232448             # bytes of shared memory a Hopper block can use
_PTRS = ("x", "out", "w_exp", "b_exp", "w_dw", "b_dw", "w_ser", "b_ser",
         "w_see", "b_see", "w_proj", "b_proj", "partial", "gate")
_INTS = ("C", "E", "S", "Co", "H", "W", "Ho", "Wo", "k", "pt", "pl",
         "has_expand", "has_residual", "TH", "TW", "Ec", "tiles_w", "n_tiles")


class _Params(ctypes.Structure):
    """Mirror of ``struct Params`` in ``csrc/fused_mbconv.cu``."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS]
                + [(n, ctypes.c_int) for n in _INTS])


_SIGNATURES = {
    "fused_mbconv_launch": ([ctypes.POINTER(_Params), ctypes.c_int,
                             ctypes.c_void_p], ctypes.c_int),
}


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def _out_hw(spec: MBConvSpec, H: int, W: int) -> Tuple[int, int]:
    """Output height and width of a stride-1 block on an H x W map."""
    pt, pb, pl, pr = spec.pad
    return H + pt + pb - spec.kernel + 1, W + pl + pr - spec.kernel + 1


class TilePlan(NamedTuple):
    TH: int          # output rows per tile
    TW: int          # output columns per tile
    Ec: int          # expanded channels per chunk (a multiple of 8)
    smem: int        # bytes of shared memory per block


def tile_smem(spec: MBConvSpec, H: int, W: int, TH: int, TW: int,
              Ec: int) -> int:
    """Shared memory of one block, as the kernel lays it out: the input
    tile with its halo clipped to the map (all C channels with expand, the
    chunk's otherwise), the chunk's expanded tile, its depthwise tile."""
    k = spec.kernel
    ph = _round4(min(TH + k - 1, H) * min(TW + k - 1, W))
    x_rows = spec.in_ch if spec.has_expand else Ec
    return 4 * (x_rows * ph + (Ec * ph if spec.has_expand else 0)
                + Ec * _round4(TH * TW))


@functools.lru_cache(maxsize=None)
def plan_tiles(spec: MBConvSpec, B: int, H: int, W: int) -> TilePlan:
    """Pick the tile (TH x TW output pixels) and channel chunk Ec for one
    block shape from a rough cost model of the kernel: per tile and pass,
    the expand over the clipped halo (recomputed in both passes), the
    depthwise, the projection, in thread steps; blocks per SM from shared
    memory (at most two of 256 threads by registers); waves over 132 SMs.
    The projection keeps one 8 x 4 tile of sums per thread, so
    ceil(Co / 8) * ceil(TH * TW / 4) <= 256."""
    k, C, E, Co = spec.kernel, spec.in_ch, spec.exp_ch, spec.out_ch
    Ho, Wo = _out_hw(spec, H, W)
    ths = sorted({-(-Ho // m) for m in range(1, Ho + 1)})
    tws = sorted({-(-Wo // m) for m in range(1, 17)})
    ecs = range(8, min(-(-E // 8) * 8, 512) + 1, 8)
    best, best_cost = None, math.inf
    for TH in ths:
        for TW in tws:
            p_pad = _round4(TH * TW)
            if -(-Co // 8) * (p_pad // 4) > NT:
                continue
            ph = _round4(min(TH + k - 1, H) * min(TW + k - 1, W))
            n_tiles = -(-Ho // TH) * -(-Wo // TW)
            for Ec in ecs:
                smem = tile_smem(spec, H, W, TH, TW, Ec)
                if smem > SMEM_LIMIT:
                    continue
                chunks = -(-E // Ec)
                expand = (-(-(Ec // 8) * (ph // 4) // NT) * C * 41
                          if spec.has_expand else 0)
                dw = -(-Ec * p_pad // NT) * 4 * k * k
                load = -(-(C if spec.has_expand else Ec) * ph // NT) * 8
                per_tile = (2 * load + chunks * (2 * (expand + dw) + Ec * 41)
                            + (0 if spec.has_expand else chunks * load))
                per_sm = max(1, min(2, SMEM_LIMIT // (smem + 1024)))
                waves = -(-B * n_tiles // (132 * per_sm))
                cost = waves * per_sm * per_tile / (1.0 if per_sm == 2
                                                    else 0.6)
                if cost < best_cost:
                    best, best_cost = TilePlan(TH, TW, Ec, smem), cost
    if best is None:
        raise ValueError(f"no tile of {spec} at {H}x{W} fits the kernel")
    return best


def fused_mbconv_s1(x: torch.Tensor, weights: Dict[str, torch.Tensor],
                    spec: MBConvSpec) -> torch.Tensor:
    """Stride-1 folded MBConv block, x [B, C, H, W] float32 -> [B, Co, Ho,
    Wo].  CUDA tensors launch ``csrc/fused_mbconv.cu`` (three launches: an
    SE partial-sum pass, the SE MLP, the output pass); CPU tensors run
    :func:`mbconv_plain`."""
    if spec.stride != 1:
        raise ValueError("fused_mbconv_s1 runs stride-1 blocks only")
    if x.ndim != 4 or x.shape[1] != spec.in_ch:
        raise ValueError(f"x must be [B, {spec.in_ch}, H, W], "
                         f"got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return mbconv_plain(x, weights, spec)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    names = (("w_exp", "b_exp") if spec.has_expand else ()) + _PTRS[4:12]
    if x.dtype != torch.float32 or not x.is_contiguous() or not all(
            weights[n].device == x.device and weights[n].dtype == torch.float32
            and weights[n].is_contiguous() for n in names):
        raise ValueError("x and the folded weights must be contiguous float32 "
                         "tensors on one CUDA device")
    B, C, H, W = x.shape
    E, Co = spec.exp_ch, spec.out_ch
    Ho, Wo = _out_hw(spec, H, W)
    if spec.has_residual and (Co != C or (Ho, Wo) != (H, W)):
        raise ValueError("a residual block keeps its shape")
    if not spec.has_expand and E != C:
        raise ValueError("a block without expand has exp_ch == in_ch")
    plan = plan_tiles(spec, B, H, W)
    tiles_w = -(-Wo // plan.TW)
    n_tiles = -(-Ho // plan.TH) * tiles_w
    out = torch.empty(B, Co, Ho, Wo, dtype=torch.float32, device=x.device)
    partial = torch.empty(B, n_tiles, E, dtype=torch.float32, device=x.device)
    gate = torch.empty(B, E, dtype=torch.float32, device=x.device)
    ptrs = dict(x=x, out=out, partial=partial, gate=gate, **weights)
    params = _Params(
        *[ptrs[n].data_ptr() if n in ptrs else None for n in _PTRS],
        C, E, weights["w_ser"].shape[1], Co, H, W, Ho, Wo, spec.kernel,
        spec.pad[0], spec.pad[2], int(spec.has_expand),
        int(spec.has_residual), plan.TH, plan.TW, plan.Ec, tiles_w, n_tiles)
    lib = cuda_build.load("fused_mbconv", _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.fused_mbconv_launch(ctypes.byref(params), B, stream)
    cuda_build.check(err, "fused_mbconv")
    fused_mbconv_s1.launches += 1
    return out


fused_mbconv_s1.launches = 0


def folded_blocks(encoder, kernel: bool = True) -> List[Callable]:
    """One callable per MBConv block of an EffB2 encoder (full or pruned),
    BN folded once here: stride-1 blocks through :func:`fused_mbconv_s1`
    when ``kernel``, every other block (and all of them otherwise) through
    :func:`mbconv_plain`.  Pass the list as ``encoder(lms, feat_len,
    blocks=...)``."""
    fns = []
    for block in encoder._blocks:
        spec = spec_of(block)
        fn = fused_mbconv_s1 if kernel and spec.stride == 1 else mbconv_plain
        fns.append(functools.partial(fn, weights=pack_mbconv(block),
                                     spec=spec))
    return fns
