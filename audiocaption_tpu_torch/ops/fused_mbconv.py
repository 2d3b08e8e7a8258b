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

The kernel stores the depthwise output once and runs both 1x1 products
on the tensor cores in a 3xTF32 split (float32 accuracy from TF32
operands); ``mbconv_split_tf32`` emulates that split on the CPU and
``plan_tiles`` picks the kernel's tiles, both in pure Python.

The work dtype is the input's, as in the TPU kernel (``wd =
x_ref.dtype``, ``pallas_mbconv.py:122``).  A bfloat16 ``x`` (the bf16
EffB2 encoder's) rounds where the TPU kernel rounds: the 1x1 expand is a
product of bf16 ``x`` and bf16 ``w_exp`` summed in float32, plus the bias,
swish in float32, then bf16; the depthwise sums bf16 products of that and
bf16 ``w_dw`` in bf16, term by term in (ki, kj) order; ``+ b_dw`` and
swish in float32; the SE all float32; ``d * gate`` rounded to bf16; the
projection a product of it and bf16 ``w_proj`` summed in float32, plus
the bias, rounded to bf16; the residual added to that (the TPU wrapper's
bf16 add).  The folded weights stay float32, as the JAX kernel receives
them: ``w_exp``, ``w_dw`` and ``w_proj`` are rounded to bf16 where they
are used (the kernel's ``astype(wd)``), the biases and the SE weights
never.  The output is bf16.

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


def _conv1x1(x: torch.Tensor, w: torch.Tensor,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
    """x [B, I, H, W], w [I, O] -> [B, O, H, W] (+ bias)."""
    return F.conv2d(x, w.t()[:, :, None, None], bias)


def _mbconv(x, weights, spec, expand: Callable, project: Callable):
    """The folded block with its two 1x1 products given: ``expand(x, w,
    b)`` and ``project(d, g, w, b)`` (``g`` the SE gate [B, E])."""
    pt, pb, pl, pr = spec.pad
    e = x
    if spec.has_expand:
        e = F.silu(expand(x, weights["w_exp"], weights["b_exp"]))
    d = F.conv2d(F.pad(e, (pl, pr, pt, pb)),
                 weights["w_dw"].permute(2, 0, 1)[:, None], weights["b_dw"],
                 stride=spec.stride, groups=spec.exp_ch)
    d = F.silu(d)
    s = F.silu(d.mean(dim=(2, 3)) @ weights["w_ser"] + weights["b_ser"])
    g = torch.sigmoid(s @ weights["w_see"] + weights["b_see"])
    p = project(d, g, weights["w_proj"], weights["b_proj"])
    return p + x if spec.has_residual else p


def mbconv_plain(x: torch.Tensor, weights: Dict[str, torch.Tensor],
                 spec: MBConvSpec) -> torch.Tensor:
    """Plain PyTorch version of the folded block, any stride:
    x [B, C, H, W] -> [B, Co, Ho, Wo] (counterpart of ``xla_mbconv``), in
    the work dtype of ``x``: float32, or bfloat16 with the TPU kernel's
    rounding points (:func:`mbconv_plain_bf16`)."""
    if x.dtype == torch.bfloat16:
        return mbconv_plain_bf16(x, weights, spec)
    return _mbconv(x, weights, spec, _conv1x1,
                   lambda d, g, w, b: _conv1x1(d * g[:, :, None, None], w, b))


def _bf16(v: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest bf16 value (ties to even), as float32."""
    return v.to(torch.bfloat16).float()


def mbconv_plain_bf16(x: torch.Tensor, weights: Dict[str, torch.Tensor],
                      spec: MBConvSpec) -> torch.Tensor:
    """The folded block in the bf16 work dtype (see the module docstring),
    any stride: x [B, C, H, W] bfloat16 -> bfloat16.  The 1x1 products of
    bf16 values run in float32 (each product exact, float32 sums), the
    depthwise's sum in bf16, term by term."""
    pt, pb, pl, pr = spec.pad
    s = spec.stride
    x32 = x.float()
    e = x
    if spec.has_expand:
        e = F.silu(_conv1x1(x32, _bf16(weights["w_exp"]), weights["b_exp"])
                   ).to(torch.bfloat16)
    e = F.pad(e, (pl, pr, pt, pb))
    k = spec.kernel
    Ho = (e.shape[2] - k) // s + 1
    Wo = (e.shape[3] - k) // s + 1
    w_dw = weights["w_dw"].to(torch.bfloat16)
    acc = None
    for ki in range(k):
        for kj in range(k):
            part = e[:, :, ki:ki + s * (Ho - 1) + 1:s,
                     kj:kj + s * (Wo - 1) + 1:s]
            term = part * w_dw[ki, kj][None, :, None, None]
            acc = term if acc is None else acc + term
    d = F.silu(acc.float() + weights["b_dw"][None, :, None, None])
    se = F.silu(d.mean(dim=(2, 3)) @ weights["w_ser"] + weights["b_ser"])
    g = torch.sigmoid(se @ weights["w_see"] + weights["b_see"])
    dg = _bf16(d * g[:, :, None, None])
    p = _bf16(_conv1x1(dg, _bf16(weights["w_proj"]), weights["b_proj"]))
    if spec.has_residual:
        p = p + x32
    return p.to(torch.bfloat16)


def round_tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32``: add half of the 13 dropped mantissa
    bits, then mask them."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """v -> (big, small): big = tf32(v), small = tf32(v - big)."""
    big = round_tf32(v)
    return big, round_tf32(v.float() - big)


def _einsum_3xtf32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's 3xTF32 product: a_small b_big + a_big b_small +
    a_big b_big, each product and sum in float32."""
    ab, as_ = split_tf32(a)
    bb, bs = split_tf32(b)
    return (torch.einsum(eq, as_, bb) + torch.einsum(eq, ab, bs)
            + torch.einsum(eq, ab, bb))


def mbconv_split_tf32(x: torch.Tensor, weights: Dict[str, torch.Tensor],
                      spec: MBConvSpec) -> torch.Tensor:
    """``mbconv_plain`` with both 1x1 products in the kernel's 3xTF32 split,
    the gate scaling ``w_proj`` as the kernel applies it: the CPU evidence
    that the tensor-core route keeps float32 accuracy."""
    def expand(v, w, b):
        return _einsum_3xtf32("bihw,io->bohw", v, w) + b[:, None, None]

    def project(d, g, w, b):
        return (_einsum_3xtf32("behw,beo->bohw", d, w[None] * g[:, :, None])
                + b[:, None, None])

    return _mbconv(x, weights, spec, expand, project)


# -- the kernel ---------------------------------------------------------------

NT = 256                        # threads per block (csrc/fused_mbconv.cu)
SE_NT = 1024                    # threads of the SE block
SMEM_LIMIT = 232448             # bytes of shared memory a Hopper block can use
KC = 32                         # projection: expanded channels per chunk
_PTRS = ("x", "out", "w_exp", "b_exp", "w_dw", "b_dw", "w_ser", "b_ser",
         "w_see", "b_see", "w_proj", "b_proj", "d", "partial", "gate")
_INTS = ("C", "E", "S", "Co", "H", "W", "Ho", "Wo", "k", "pt", "pl",
         "has_expand", "has_residual", "TH", "TW", "Ec", "Eg", "tiles_w",
         "n_tiles", "WM", "bf16")


class _Params(ctypes.Structure):
    """Mirror of ``struct MBConvParams`` in ``csrc/fused_mbconv.cu``."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS]
                + [(n, ctypes.c_int) for n in _INTS])


_SIGNATURES = {
    "fused_mbconv_launch": ([ctypes.POINTER(_Params), ctypes.c_int,
                             ctypes.c_void_p], ctypes.c_int),
}


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def _out_hw(spec: MBConvSpec, H: int, W: int) -> Tuple[int, int]:
    """Output height and width of a stride-1 block on an H x W map."""
    pt, pb, pl, pr = spec.pad
    return H + pt + pb - spec.kernel + 1, W + pl + pr - spec.kernel + 1


class TilePlan(NamedTuple):
    TH: int          # output rows per tile
    TW: int          # output columns per tile
    Ec: int          # expanded channels per chunk (a multiple of 16)
    Eg: int          # expanded channels per block (a multiple of Ec)
    WM: int          # projection: warps along the output channels (1, 2, 4)
    smem: int        # bytes of shared memory of the expand/depthwise block
    proj_smem: int   # bytes of shared memory of the projection block


def k_step(bf16: bool) -> int:
    """The mma's K step: 8 (TF32 m16n8k8), 16 (bf16 m16n8k16)."""
    return 16 if bf16 else 8


def tile_smem(spec: MBConvSpec, H: int, W: int, TH: int, TW: int,
              Ec: int, bf16: bool = False) -> int:
    """Shared memory of one expand/depthwise block, as the kernel lays it
    out (``Pass1Layout``): x over the largest clipped halo for all C
    channels (rounded to the mma's K step with expand), the chunk's
    expanded halo, two w_exp and two w_dw chunks, the depthwise's column
    sums; floats in both work dtypes (bf16 values are staged as floats)."""
    k, C = spec.kernel, spec.in_ch
    ld = _up(min(TH + k - 1, H) * min(TW + k - 1, W), 32) + 8
    c8 = _up(C, k_step(bf16))
    floats = (c8 * ld + Ec * ld + 2 * c8 * (Ec + 8) if spec.has_expand
              else C * ld)
    return 4 * (floats + 2 * k * k * Ec + Ec * TW)


def se_smem(spec: MBConvSpec, squeeze: int) -> int:
    """Shared memory of the SE block: the mean, the hidden layer and the
    reduce product's row-slice sums."""
    return 4 * (spec.exp_ch + squeeze + SE_NT)


def project_warps(spec: MBConvSpec) -> int:
    """Warps along the output channels of a projection block (the block
    tile is 16 WM x 32 (8 / WM))."""
    return 1 if spec.out_ch <= 16 else 2 if spec.out_ch <= 32 else 4


def project_smem(spec: MBConvSpec, WM: int) -> int:
    """Shared memory of one projection block: two w_proj and two d chunks
    of KC rows, the sample's gate."""
    return 4 * (2 * KC * (16 * WM + 8) + 2 * KC * (32 * (8 // WM) + 8)
                + _up(spec.exp_ch, KC))


def _pass1_cost(spec: MBConvSpec, B: int, H: int, W: int, TH: int, TW: int,
                Ec: int, G: int, smem: int, bf16: bool = False) -> float:
    """Rough time of the expand/depthwise launch, in warp instructions per
    SM scheduler: per block, x staged once and per chunk the expand (one
    16 x 32 warp tile takes ~60 instructions a k-step of 8: fragment loads,
    TF32 splits, 12 mma), the weights' copies and the depthwise (a thread
    a channel and column: ~k * k + 2 k + 30 instructions an output row);
    blocks per SM from shared memory (at most two by registers), waves
    over 132 SMs, and a penalty below 16 warps an SM."""
    k, C, E = spec.kernel, spec.in_ch, spec.exp_ch
    Ho, Wo = _out_hw(spec, H, W)
    ph = _up(min(TH + k - 1, H) * min(TW + k - 1, W), 32)
    c8 = _up(C, k_step(bf16))
    n_tiles = -(-Ho // TH) * -(-Wo // TW)
    chunks = -(-(-(-E // Ec)) // G)
    expand = (-(-(Ec // 16) * (ph // 32) // 8) * 8 * (c8 // 8) * 60
              if spec.has_expand else 0)
    dw = NT // 32 * -(-Ec * TW // NT) * (TH * (k * k + 2 * k + 30)
                                          + k * k + 10)
    weights = -(-((c8 * Ec if spec.has_expand else 0) + k * k * Ec) // NT) * 32
    stage = -(-(c8 if spec.has_expand else C) * (ph + 8) // NT) * 8 * 6
    per_block = stage + chunks * (expand + dw + weights + 200)
    per_sm = max(1, min(2, SMEM_LIMIT // (smem + 1024)))
    waves = -(-B * n_tiles * G // (132 * per_sm))
    return waves * per_sm * per_block / 4 / min(1.0, per_sm * 8 / 16)


@functools.lru_cache(maxsize=None)
def plan_tiles(spec: MBConvSpec, B: int, H: int, W: int,
               bf16: bool = False) -> TilePlan:
    """Pick the expand/depthwise tile (TH x TW output pixels), chunk Ec and
    channel group Eg of one block shape by :func:`_pass1_cost`, within
    shared memory (in the bf16 work dtype the expand's K padded to 16),
    and the projection's warp layout by the output width."""
    k, E = spec.kernel, spec.exp_ch
    Ho, Wo = _out_hw(spec, H, W)
    ths = sorted({-(-Ho // m) for m in range(1, min(Ho, 8) + 1)})
    tws = sorted({-(-Wo // m) for m in range(1, min(Wo, 16) + 1)})
    ecs = [e for e in (16, 32, 48, 64, 96, 128) if e <= _up(E, 16)]
    best, best_cost = None, math.inf
    for TH in ths:
        for TW in tws:
            for Ec in ecs:
                smem = tile_smem(spec, H, W, TH, TW, Ec, bf16)
                if smem > SMEM_LIMIT:
                    continue
                n_chunks = -(-E // Ec)
                for G in (1, 2, 3, 4, 6, 8, 12, 16):
                    if G > n_chunks:
                        break
                    Eg = -(-n_chunks // G) * Ec
                    cost = _pass1_cost(spec, B, H, W, TH, TW, Ec,
                                       -(-E // Eg), smem, bf16)
                    if cost < best_cost:
                        best, best_cost = (TH, TW, Ec, Eg, smem), cost
    if best is None:
        raise ValueError(f"no tile of {spec} at {H}x{W} fits the kernel")
    WM = project_warps(spec)
    return TilePlan(*best[:4], WM, best[4], project_smem(spec, WM))


def fused_mbconv_s1(x: torch.Tensor, weights: Dict[str, torch.Tensor],
                    spec: MBConvSpec) -> torch.Tensor:
    """Stride-1 folded MBConv block, x [B, C, H, W] float32 or bfloat16 (the
    work dtype, see the module docstring) -> [B, Co, Ho, Wo] in x's dtype;
    the folded weights float32.  CUDA tensors launch
    ``csrc/fused_mbconv.cu`` (three launches: expand + depthwise storing d
    and the SE partial sums, the SE MLP, the gated projection); CPU
    tensors run :func:`mbconv_plain`."""
    if spec.stride != 1:
        raise ValueError("fused_mbconv_s1 runs stride-1 blocks only")
    if spec.kernel not in (3, 5):
        raise ValueError("the MBConv kernel runs 3x3 and 5x5 depthwise "
                         f"convolutions, got {spec.kernel}")
    if x.ndim != 4 or x.shape[1] != spec.in_ch:
        raise ValueError(f"x must be [B, {spec.in_ch}, H, W], "
                         f"got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return mbconv_plain(x, weights, spec)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    names = (("w_exp", "b_exp") if spec.has_expand else ()) + _PTRS[4:12]
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            not x.is_contiguous() or not all(
                weights[n].device == x.device
                and weights[n].dtype == torch.float32
                and weights[n].is_contiguous() for n in names):
        raise ValueError("x (float32 or bfloat16) and the folded weights "
                         "(float32) must be contiguous tensors on one CUDA "
                         "device")
    bf16 = x.dtype == torch.bfloat16
    B, C, H, W = x.shape
    E, Co = spec.exp_ch, spec.out_ch
    Ho, Wo = _out_hw(spec, H, W)
    if spec.has_residual and (Co != C or (Ho, Wo) != (H, W)):
        raise ValueError("a residual block keeps its shape")
    if not spec.has_expand and E != C:
        raise ValueError("a block without expand has exp_ch == in_ch")
    plan = plan_tiles(spec, B, H, W, bf16)
    squeeze = weights["w_ser"].shape[1]
    if squeeze > SE_NT or max(plan.smem, plan.proj_smem,
                              se_smem(spec, squeeze)) > SMEM_LIMIT:
        raise ValueError(f"{spec} at {H}x{W} needs more shared memory (or "
                         "SE threads) than a block has")
    tiles_w = -(-Wo // plan.TW)
    n_tiles = -(-Ho // plan.TH) * tiles_w
    out = torch.empty(B, Co, Ho, Wo, dtype=x.dtype, device=x.device)
    d = torch.empty(B, E, Ho, Wo, dtype=torch.float32, device=x.device)
    partial = torch.empty(B, n_tiles, E, dtype=torch.float32, device=x.device)
    gate = torch.empty(B, E, dtype=torch.float32, device=x.device)
    ptrs = dict(x=x, out=out, d=d, partial=partial, gate=gate, **weights)
    params = _Params(
        *[ptrs[n].data_ptr() if n in ptrs else None for n in _PTRS],
        C, E, squeeze, Co, H, W, Ho, Wo, spec.kernel,
        spec.pad[0], spec.pad[2], int(spec.has_expand),
        int(spec.has_residual), plan.TH, plan.TW, plan.Ec, plan.Eg, tiles_w,
        n_tiles, plan.WM, int(bf16))
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
    blocks=...)``.  The work dtype is the activations': a bf16 encoder's
    blocks receive bf16 maps and run in the bf16 work dtype (the TPU
    kernel's, ``pallas_mbconv.py:122``).  BN is folded in float32 either
    way and the packed weights stay float32, as the JAX ``pack_mbconv``
    hands them to its kernel; the bf16 rounding of ``w_exp``, ``w_dw`` and
    ``w_proj`` happens at use (module docstring)."""
    fns = []
    for block in encoder._blocks:
        spec = spec_of(block)
        fn = fused_mbconv_s1 if kernel and spec.stride == 1 else mbconv_plain
        fns.append(functools.partial(fn, weights=pack_mbconv(block),
                                     spec=spec))
    return fns
