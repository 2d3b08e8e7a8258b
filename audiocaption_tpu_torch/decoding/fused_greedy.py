"""Whole-loop greedy decode: the CUDA kernel ``csrc/fused_greedy.cu``, its
plain PyTorch version, and the decoder that serves the API through them.

Replaces the TPU kernel ``audiocaption_tpu/decoding/fused_greedy.py``
(``_make_kernel`` :209-310, launched by ``_fused_decode_call`` :313-359;
host side ``pack_decoder_weights`` :113-171, ``FusedGreedyDecoder``
:362-530).

What bounds it on an H100: a step of one row needs ~3.2 M multiply-adds
against ~12.4 MB of float32 decoder weights at the flagship width (E=256,
FFN 1024, V=4981, 2 layers).  The first design gave one block one row and
streamed all 12.4 MB from L2 every step (8.1 ms at B=64, L=20).  The
kernel now splits every weight matrix across a thread block cluster of C
blocks (8 or 16) by output columns and gives the cluster a tile of R rows
(:func:`plan_clusters`): each block streams 1/C of the weights a step and
applies each tile of them to R rows on the FP64 tensor cores (exact
products, float64 sums: float32 parity).  The weights are packed once in
mma fragment order (:func:`kernel_weights`).  On the card this takes
3.1 ms at B=64: a step is 17 serial phases, ~72% of their time in the
products (bound by the FP64 pipe, not by L2) and ~24% in attention; a
cluster sync costs ~0.5 us (PERF.md; :func:`trace_phases` and
:func:`cluster_sync_ns` measure both).

The TPU kernel's lane-padded heads (HPAD=128) and VMEM chunking are TPU
constraints and are not copied: the layout here is unpadded, the
embedding is indexed directly, and the 1/sqrt(dh) scale is folded into
the query weights.

Modes (the TPU kernels' bf16 options).  ``cache_bf16`` stores the memory
K/V and the self-attention caches in bf16 (``fused_greedy.py:316-327``
there): each K/V value is rounded once where it is written, read back
widened, and every sum stays as in the float32 mode.  ``weights_bf16``
(the beam kernel's only, :mod:`fused_beam`) stores the ten large
matrices in bf16 and rounds the activations to bf16 at each product,
on the bf16 tensor cores (each 16-deep tile summed in float32, the tiles
added in float64).  In the bf16 modes the plain version follows the
kernels' float64 sums and float32 rounding points (``wide``).  Each mode
is its own instantiation of the kernel, with its own launch count
(``mode_launches``); a mode never falls back to another.

``fused_greedy_decode`` launches the kernel for CUDA tensors and runs
``fused_greedy_plain`` (same inputs, same outputs, vectorised over rows)
only for CPU tensors, in the same mode.  Semantics: greedy over
max_length steps; a row emits <eos> at every step after its first <eos>
(the kernel stops a tile once all its rows have); arg-max ties go to the
lower id; masked attention scores are -1e30.  :func:`greedy_pick_split`
is the kernel's split pick (arg-max per vocabulary slice, then the
merge) in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from audiocaption_tpu_torch import cuda_build
from audiocaption_tpu_torch.device import DeviceLike, resolve_device

MASKED = -1e30
CACHE_BF16 = 1       # DecodeArgs.mode bits (ACD_CACHE_BF16, ACD_WEIGHTS_BF16)
WEIGHTS_BF16 = 2


def decode_mode(cache_bf16: bool = False, weights_bf16: bool = False) -> int:
    return (CACHE_BF16 if cache_bf16 else 0) | (
        WEIGHTS_BF16 if weights_bf16 else 0)


def mode_name(mode: int) -> str:
    """"f32", "cache_bf16", "weights_bf16" or "cache_bf16+weights_bf16"."""
    names = [n for bit, n in ((CACHE_BF16, "cache_bf16"),
                              (WEIGHTS_BF16, "weights_bf16")) if mode & bit]
    return "+".join(names) or "f32"


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (to nearest even), kept in its dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


@dataclasses.dataclass
class PackedDecoder:
    """Decoder weights in the kernels' layout (float32, contiguous):
    ``emb`` [V, E], ``cls`` [V, E], ``pe`` [max_pos, E], ``layers``
    [nlayers, P] with the per-layer layout of ``csrc/decoder_common.cuh``."""
    emb: torch.Tensor
    cls: torch.Tensor
    pe: torch.Tensor
    layers: torch.Tensor
    nhead: int
    ffn: int
    # the kernels' fragment-packed weights (float32; bf16 for the
    # weights_bf16 mode) and the bf16 embedding, made at first launch
    frag: Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    frag_bf16: Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    emb_bf16: Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def emb_dim(self) -> int:
        return self.emb.shape[1]

    @property
    def vocab_size(self) -> int:
        return self.emb.shape[0]

    @property
    def nlayers(self) -> int:
        return self.layers.shape[0]

    def to(self, device) -> "PackedDecoder":
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device).contiguous()
                     for k in ("emb", "cls", "pe", "layers")})


def layer_offsets(E: int, F_: int) -> Dict[str, Tuple[int, Tuple[int, ...]]]:
    """name -> (offset, shape) in one packed layer row (decoder_common.cuh)."""
    shapes = [("wqkv", (3 * E, E)), ("bqkv", (3 * E,)), ("wo", (E, E)),
              ("bo", (E,)), ("xwq", (E, E)), ("xbq", (E,)), ("xwo", (E, E)),
              ("xbo", (E,)), ("w1", (F_, E)), ("b1", (F_,)), ("w2", (E, F_)),
              ("b2", (E,)), ("ln", (6, E))]
    out, p = {}, 0
    for name, shape in shapes:
        out[name] = (p, shape)
        p += math.prod(shape)
    out["size"] = (p, ())
    return out


def _layer_views(row: torch.Tensor, E: int, F_: int) -> Dict[str, torch.Tensor]:
    offs = layer_offsets(E, F_)
    return {k: row[o:o + math.prod(s)].view(s)
            for k, (o, s) in offs.items() if k != "size"}


@torch.no_grad()
def pack_decoder_weights(dec) -> PackedDecoder:
    """``TransformerDecoder`` -> kernel layout (on the decoder's device)."""
    E, H, F_ = dec.emb_dim, dec.nhead, dec.dim_feedforward
    scale = 1.0 / math.sqrt(E // H)
    rows = []
    for layer in dec.layers:
        sa, ca = layer.self_attn, layer.multihead_attn
        wqkv = sa.in_proj_weight.detach().float().clone()
        bqkv = sa.in_proj_bias.detach().float().clone()
        wqkv[:E] *= scale
        bqkv[:E] *= scale
        parts = [wqkv, bqkv, sa.out_proj.weight, sa.out_proj.bias,
                 ca.in_proj_weight[:E] * scale, ca.in_proj_bias[:E] * scale,
                 ca.out_proj.weight, ca.out_proj.bias,
                 layer.linear1.weight, layer.linear1.bias,
                 layer.linear2.weight, layer.linear2.bias,
                 layer.norm1.weight, layer.norm1.bias,
                 layer.norm2.weight, layer.norm2.bias,
                 layer.norm3.weight, layer.norm3.bias]
        rows.append(torch.cat([p.detach().float().reshape(-1) for p in parts]))
    layers = torch.stack(rows).contiguous()
    assert layers.shape[1] == layer_offsets(E, F_)["size"][0]
    return PackedDecoder(
        emb=dec.word_embedding.weight.detach().float().contiguous(),
        cls=dec.classifier_weight.detach().float().contiguous(),
        pe=dec.pe.detach().float().contiguous(), layers=layers,
        nhead=H, ffn=F_)


@torch.no_grad()
def memory_kv(dec, attn_emb: torch.Tensor, attn_emb_len: torch.Tensor,
              cache_bf16: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder output -> (memkv [nlayers, 2, B, S, E], float32 or, with
    ``cache_bf16``, bf16; mem_valid [B, S] uint8), the kernels'
    cross-attention inputs.  The projection runs in the decoder's
    compute dtype, as the JAX package's ``init_cache`` does."""
    static, _ = dec.init_cache(attn_emb, attn_emb_len, 1)
    memkv = torch.stack([torch.stack([static[f"mem_k{i}"], static[f"mem_v{i}"]])
                         for i in range(dec.nlayers)])
    memkv = memkv.to(torch.bfloat16 if cache_bf16 else torch.float32)
    return memkv.contiguous(), (~static["mem_kpm"]).to(torch.uint8).contiguous()


# ----------------------------------------------------------------- plain --

def _layer_norm(x, g, b, wide: bool = False):
    """LayerNorm (eps 1e-5) of x, in x's dtype; ``wide``: the mean, the
    variance and the normalisation in float64, rounded once (the
    kernels' arithmetic)."""
    dt = x.dtype
    if wide:
        x, g, b = x.double(), g.double(), b.double()
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return ((x - mean) * torch.rsqrt(var + 1e-5) * g + b).to(dt)


def _attend(q, k, v, valid, H, wide: bool = False):
    """q [B, R, E]; k/v [B, R, T, E] (bf16 ones read widened);
    valid [B, R, T] -> ctx [B, R, E].  ``wide``: as the kernels sum, the
    scores, the softmax's denominator and the context in float64, each
    rounded to q's dtype where the kernels store it."""
    B, R, E = q.shape
    T, dh = k.shape[2], E // H
    dt = q.dtype
    wd = torch.float64 if wide else dt
    k, v = k.to(wd), v.to(wd)
    qh = q.reshape(B, R, H, dh).to(wd)
    kh, vh = k.reshape(B, R, T, H, dh), v.reshape(B, R, T, H, dh)
    scores = torch.einsum("brhd,brthd->brht", qh, kh).to(dt)
    scores = scores.masked_fill(~valid[:, :, None, :], MASKED)
    m = scores.amax(-1, keepdim=True)
    e = torch.exp(scores - m).to(wd)
    attn = (e / e.sum(-1, keepdim=True)).to(dt).to(wd)
    ctx = torch.einsum("brht,brthd->brhd", attn, vh).to(dt)
    return ctx.reshape(B, R, E)


def product(x, w, b=None, weights_bf16: bool = False, wide: bool = False):
    """A layer product as the kernels take it, in x's dtype.  With
    ``weights_bf16`` the activation and the weight are rounded to bf16
    first (the TPU kernel's ``_dot``); ``wide``: the exact products
    summed in float64 and rounded once, as the kernels sum."""
    if weights_bf16:
        x, w = round_bf16(x), round_bf16(w)
    if not wide:
        return F.linear(x, w, b)
    y = F.linear(x.double(), w.double(), None if b is None else b.double())
    return y.to(x.dtype)


def decoder_rows_plain(packed: PackedDecoder, x, t: int, self_k, self_v,
                       self_valid, memkv, mem_valid,
                       weights_bf16: bool = False, wide: bool = False):
    """The kernels' per-step layer stack on rows x [B, R, E] at position t.
    self_k/self_v [nlayers, B, R, L, E] get this step's K/V at row t
    (rounded to bf16 where the caches are bf16); self_valid [B, R, L];
    memkv [nlayers, 2, B, S, E]; mem_valid [B, S].

    ``wide`` (the bf16 modes) follows the kernels' float64 sums and their
    float32 rounding points exactly.  A bf16 mode rounds values to bf16
    at many points; where two versions' float32 values differ by an ulp,
    the bf16 rounding flips now and then, and the flip (2^-8 relative)
    moves a beam's later choices: in the weights_bf16 mode at the
    flagship width the float32 plain version and its own float64 run
    differ in 39 of 3840 beam-3 tokens (chip_smoke.py phase 12)."""
    E, H, F_ = packed.emb_dim, packed.nhead, packed.ffn
    R = x.shape[1]
    mvalid = mem_valid.bool()[:, None].expand(-1, R, -1)

    def mm(a, w, b=None):
        return product(a, w, b, weights_bf16, wide)

    def ln(a, g, b):
        return _layer_norm(a, g, b, wide)

    for i in range(packed.nlayers):
        w = _layer_views(packed.layers[i], E, F_)
        g = w["ln"]
        qkv = mm(x, w["wqkv"], w["bqkv"])
        q, k, v = qkv[..., :E], qkv[..., E:2 * E], qkv[..., 2 * E:]
        self_k[i, :, :, t] = k
        self_v[i, :, :, t] = v
        ctx = _attend(q, self_k[i, :, :, :t + 1], self_v[i, :, :, :t + 1],
                      self_valid[:, :, :t + 1], H, wide)
        x = ln(x + mm(ctx, w["wo"], w["bo"]), g[0], g[1])
        xq = mm(x, w["xwq"], w["xbq"])
        mk = memkv[i, 0][:, None].expand(-1, R, -1, -1)
        mv = memkv[i, 1][:, None].expand(-1, R, -1, -1)
        ctx = _attend(xq, mk, mv, mvalid, H, wide)
        x = ln(x + mm(ctx, w["xwo"], w["xbo"]), g[2], g[3])
        h = torch.relu(mm(x, w["w1"], w["b1"]))
        x = ln(x + mm(h, w["w2"], w["b2"]), g[4], g[5])
    return x


@torch.no_grad()
def fused_greedy_plain(packed: PackedDecoder, memkv: torch.Tensor,
                       mem_valid: torch.Tensor, max_length: int,
                       bos: int = 1, eos: int = 2, pad: int = 0,
                       cache_bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the greedy kernel -> [B, L] int32.  With
    ``cache_bf16`` the self-attention caches are bf16 (memkv is too), and
    the sums follow the kernel's (``decoder_rows_plain``'s ``wide``)."""
    nl, _, B, S, E = memkv.shape
    L = max_length
    dev = memkv.device
    sqrt_e = math.sqrt(E)
    cache = dict(dtype=torch.bfloat16) if cache_bf16 else {}
    self_k = memkv.new_zeros(nl, B, 1, L, E, **cache)
    self_v = memkv.new_zeros(nl, B, 1, L, E, **cache)
    valid = torch.ones(B, 1, L, dtype=torch.bool, device=dev)
    word = torch.full((B,), bos, dtype=torch.long, device=dev)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    out = torch.full((B, L), eos, dtype=torch.int32, device=dev)
    for t in range(L):
        valid[:, 0, t] = word != pad
        x = (packed.emb[word] * sqrt_e + packed.pe[t])[:, None]
        x = decoder_rows_plain(packed, x, t, self_k, self_v, valid, memkv,
                               mem_valid, wide=cache_bf16)
        new_word = torch.argmax(product(x[:, 0], packed.cls, wide=cache_bf16),
                                dim=-1)
        out_word = torch.where(finished, torch.full_like(new_word, eos),
                               new_word)
        finished = finished | (new_word == eos)
        out[:, t] = out_word.to(torch.int32)
        word = out_word
    return out


# ---------------------------------------------------------------- kernel --

def check_inputs(packed: PackedDecoder, memkv: torch.Tensor,
                 mem_valid: torch.Tensor, max_length: int,
                 cache_bf16: bool = False, weights_bf16: bool = False
                 ) -> None:
    """Raise on inputs the kernels do not take (memkv is bf16 exactly
    when ``cache_bf16``)."""
    nl, two, B, S, E = memkv.shape
    if two != 2 or nl != packed.nlayers or E != packed.emb_dim:
        raise ValueError(f"memkv shape {tuple(memkv.shape)} does not match "
                         "the packed decoder")
    if tuple(mem_valid.shape) != (B, S) or mem_valid.dtype != torch.uint8:
        raise ValueError("mem_valid must be uint8 [B, S]")
    want = torch.bfloat16 if cache_bf16 else torch.float32
    if memkv.dtype != want:
        raise ValueError(f"memkv must be {want} (cache_bf16={cache_bf16})")
    if E % 4 or packed.ffn % 4 or E % packed.nhead:
        raise ValueError("the kernels need E and FFN multiples of 4 and "
                         "E divisible by the head count")
    if weights_bf16 and (E % 16 or packed.ffn % 16):
        raise ValueError("weights_bf16 needs E and FFN multiples of 16 "
                         "(the k depth of a bf16 mma)")
    if not 1 <= max_length <= packed.pe.shape[0]:
        raise ValueError(f"max_length {max_length} outside the PE table")
    tensors = [memkv, mem_valid, packed.emb, packed.cls, packed.pe,
               packed.layers]
    if any(x.device != memkv.device for x in tensors):
        raise ValueError("all inputs must be on one device")
    if memkv.device.type == "cuda" and not all(
            x.is_contiguous() for x in tensors):
        raise ValueError("the kernels need contiguous tensors")


# ------------------------------------------------- the kernels' layout --

NT = 256             # threads per block (ACD_NT in csrc/decoder_common.cuh)
NW = NT // 32
CMAX = 16            # most blocks in a cluster (ACD_CMAX)
RMAX = 32            # most rows in a tile (ACD_RMAX: 4 mma N tiles)
CLUSTERS = (16, 8)   # cluster sizes the planner tries
PHASES = 32          # trace slots a step (ACD_PHASES)
STAGES = 8           # weight tiles in flight a warp (ACD_STAGES)
SMEM_LIMIT = 232448  # shared memory a block can use on sm_90


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def frag_pack(w: torch.Tensor) -> torch.Tensor:
    """[N, K] -> the kernels' mma fragment order, flat, in w's dtype: N
    padded to 16 and K to 8 with zeros, then [N/16][K/8][32 lanes][4],
    where lane g*4 + t holds (g, t), (g+8, t), (g, t+4), (g+8, t+4) of its
    16 x 8 tile: the A fragments of the tile's four m8n8k4 products (rows
    g and g+8, k-halves t and t+4)."""
    N, K = w.shape
    wp = w.new_zeros(_up(N, 16), _up(K, 8))
    wp[:N, :K] = w
    t = wp.view(wp.shape[0] // 16, 2, 8, wp.shape[1] // 8, 2, 4)
    # [mt, row-half, g, kt, col-half, t] -> [mt, kt, g, t, col-half, row-half]
    return t.permute(0, 3, 2, 5, 4, 1).reshape(-1)


def frag_pack_bf16(w: torch.Tensor) -> torch.Tensor:
    """[N, K] -> bf16 in the A-fragment order of the bf16 mma
    (m16n8k16), flat: N and K padded to 16 with zeros, then
    [N/16][K/16][32 lanes][8], where lane g*4 + t holds its four 32-bit
    registers, each a pair of adjacent columns: (g, 2t..2t+1),
    (g+8, 2t..2t+1), (g, 2t+8..2t+9), (g+8, 2t+8..2t+9) of its 16 x 16
    tile.  A tile is 512 bytes, a lane's share 16 bytes, as for
    :func:`frag_pack`."""
    N, K = w.shape
    wp = torch.zeros(_up(N, 16), _up(K, 16), dtype=torch.bfloat16,
                     device=w.device)
    wp[:N, :K] = w
    t = wp.view(wp.shape[0] // 16, 2, 8, wp.shape[1] // 16, 2, 4, 2)
    # [mt, row-half, g, kt, col-half, t, pair]
    #   -> [mt, kt, g, t, col-half, row-half, pair]
    return t.permute(0, 3, 2, 5, 4, 1, 6).reshape(-1)


def frag_offsets(E: int, F_: int, bf16: bool = False) -> Dict[str, int]:
    """Offsets, in elements of the packed dtype, of one layer's packed
    matrices (FragOffsets in decoder_common.cuh counts the same in
    16-byte units); the vocabulary follows the last layer.  A tile is
    16 x 8 float32 values, or 16 x 16 bf16 ones with ``bf16``."""
    kw = 16 if bf16 else 8
    out, p = {}, 0
    for name, (n, k) in (("wqkv", (3 * E, E)), ("wo", (E, E)),
                         ("xwq", (E, E)), ("xwo", (E, E)), ("w1", (F_, E)),
                         ("w2", (E, F_))):
        out[name] = p
        p += _up(n, 16) * _up(k, kw)
    out["size"] = p
    return out


@torch.no_grad()
def kernel_weights(packed: PackedDecoder, bf16: bool = False
                   ) -> torch.Tensor:
    """The six matrices of every layer, then the tied vocabulary, in
    fragment order: float32 (:func:`frag_pack`) or, with ``bf16``, bf16
    (:func:`frag_pack_bf16`).  Made once per packed decoder and mode, on
    its device."""
    attr = "frag_bf16" if bf16 else "frag"
    if getattr(packed, attr) is None:
        pack = frag_pack_bf16 if bf16 else frag_pack
        E, F_ = packed.emb_dim, packed.ffn
        parts = []
        for i in range(packed.nlayers):
            w = _layer_views(packed.layers[i], E, F_)
            parts += [pack(w[k]) for k in ("wqkv", "wo", "xwq", "xwo",
                                           "w1", "w2")]
        parts.append(pack(packed.cls))
        frag = torch.cat(parts).contiguous()
        assert frag.numel() == (packed.nlayers
                                * frag_offsets(E, F_, bf16)["size"]
                                + _up(packed.vocab_size, 16)
                                * _up(E, 16 if bf16 else 8))
        setattr(packed, attr, frag)
    return getattr(packed, attr)


@torch.no_grad()
def kernel_embedding(packed: PackedDecoder, bf16: bool = False
                     ) -> torch.Tensor:
    """The embedding table the kernels gather from: float32, or a bf16
    copy (made once) for the weights_bf16 mode."""
    if not bf16:
        return packed.emb
    if packed.emb_bf16 is None:
        packed.emb_bf16 = packed.emb.to(torch.bfloat16).contiguous()
    return packed.emb_bf16


def block_tiles(n_out: int, C: int) -> List[Tuple[int, int]]:
    """Per block of a cluster of C, its range of 16-row m-tiles of a
    matrix with n_out output rows (block_tiles in decoder_common.cuh)."""
    mt = -(-n_out // 16)
    return [(c * mt // C, (c + 1) * mt // C) for c in range(C)]


def vocab_slices(V: int, C: int) -> List[Tuple[int, int]]:
    """Per block, its [v0, v1) slice of the vocabulary (its m-tiles)."""
    return [(min(V, 16 * a), min(V, 16 * b)) for a, b in block_tiles(V, C)]


def smem_bytes(R: int, E: int, F_: int, V: int, L: int, S: int, C: int,
               beam: bool) -> int:
    """Shared memory of one block (carve_smem in decoder_common.cuh).
    The same in every mode: the K/V caches and the memory K/V are read
    from global memory (L2), never staged, the activations stay float32
    (a bf16 product rounds them as it loads them), and a slot of the
    weight ring is 16 bytes a lane both for a float32 16 x 8 tile and for
    a bf16 16 x 16 one."""
    Rp = _up(R, 8)
    ldE, ldF = _up(E, 8) + 4, _up(F_, 8) + 4
    ldV = _up(-(-V // 16), C) // C * 16 + 4
    tmax = _up(max(L, S), 4)
    parts = [16 * NW * STAGES * 32, 4 * Rp * ldE, 4 * Rp * ldE, 4 * Rp * max(2 * ldE, ldF, ldV),
             8 * NW * 16 * Rp, 4 * NW * tmax, 4 * CMAX * Rp * 2,
             4 * CMAX * Rp * 2] + [4 * Rp] * 4 + [Rp * L] * 2
    if beam:
        parts += [Rp * L] * 2 + [4 * Rp] * 7 + [4 * Rp * L] * 3
    return sum(_up(p, 16) for p in parts)


class ClusterPlan(NamedTuple):
    C: int       # blocks in a cluster
    ns: int      # samples in a tile
    R: int       # rows in a tile (ns * beams)
    tiles: int   # clusters launched
    waves: int   # rounds of resident clusters
    smem: int    # bytes of shared memory a block


def plan_clusters(B: int, K: int, E: int, F_: int, V: int, L: int, S: int,
                  beam: bool, max_clusters: Callable[[int, int], int],
                  cluster: Optional[int] = None) -> ClusterPlan:
    """Tiles of whole samples (K rows each) for the decode kernels.  For
    each cluster size C (``cluster``, or each of CLUSTERS), the most
    samples a tile may hold (R <= RMAX rows within SMEM_LIMIT), hence the
    fewest waves of ``max_clusters(C, smem)`` resident clusters, then the
    samples spread evenly over every cluster of those waves.  Fewest waves wins, then fewer rows a tile
    (a step's phases are latency chains whose length grows with the rows;
    on an H100, 13 tiles of 5 rows at C=8 beat 7 tiles of 10 rows at C=16
    for greedy B=64), then the larger C (fewer weight bytes a block)."""
    best = None
    for C in ([cluster] if cluster else CLUSTERS):
        ns_fit = 0
        while ((ns_fit + 1) * K <= RMAX and smem_bytes(
                (ns_fit + 1) * K, E, F_, V, L, S, C, beam) <= SMEM_LIMIT):
            ns_fit += 1
        if ns_fit == 0:
            continue
        smem = smem_bytes(ns_fit * K, E, F_, V, L, S, C, beam)
        n_cl = max_clusters(C, smem)
        if n_cl < 1:
            continue
        waves = -(-(-(-B // ns_fit)) // n_cl)
        ns = -(-B // min(waves * n_cl, B))   # every wave full, R even
        tiles = -(-B // ns)
        plan = ClusterPlan(C, ns, ns * K, tiles, -(-tiles // n_cl),
                           smem_bytes(ns * K, E, F_, V, L, S, C, beam))
        if best is None or ((plan.waves, plan.R, -plan.C)
                            < (best.waves, best.R, -best.C)):
            best = plan
    if best is None:
        raise ValueError(f"no cluster plan fits B={B} K={K} E={E} FFN={F_} "
                         f"V={V} L={L} S={S} in {SMEM_LIMIT} bytes")
    return best


class DecodeArgs(ctypes.Structure):
    """Mirror of ``struct DecodeArgs`` in ``csrc/decoder_common.cuh``."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "emb", "pe", "layers", "frag", "memkv", "mem_valid", "cache",
        "out_seq", "out_score", "clocks")]
        + [(n, ctypes.c_int) for n in (
            "B", "S", "L", "E", "H", "F", "V", "nl", "K", "ns", "R", "C",
            "tiles", "bos", "eos", "pad", "mode")]
        + [("sqrt_e", ctypes.c_float)])


def signatures(name: str) -> Dict[str, Tuple[list, type]]:
    """ctypes signatures of a decode kernel's library."""
    args = ctypes.POINTER(DecodeArgs)
    return {f"{name}_launch": ([args, ctypes.c_void_p], ctypes.c_int),
            f"{name}_smem": ([args], ctypes.c_long),
            f"{name}_max_clusters": ([ctypes.c_int, ctypes.c_long,
                                      ctypes.c_int], ctypes.c_int),
            **({"fused_greedy_sync_probe": (
                [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2, ctypes.c_int)}
               if name == "fused_greedy" else {})}


_max_clusters_seen: Dict[Tuple[str, int, int, int], int] = {}


def max_clusters_on_card(name: str, mode: int = 0
                         ) -> Callable[[int, int], int]:
    """``max_clusters`` for :func:`plan_clusters`: what
    cudaOccupancyMaxActiveClusters says for the kernel ``name`` in
    ``mode``."""
    lib = cuda_build.load(name, signatures(name))

    def query(C: int, smem: int) -> int:
        key = (name, mode, C, smem)
        if key not in _max_clusters_seen:
            n = getattr(lib, f"{name}_max_clusters")(C, smem, mode)
            if n < 0:
                cuda_build.check(-n, f"{name} cluster occupancy")
            _max_clusters_seen[key] = n
        return _max_clusters_seen[key]
    return query


def launch_decode(name: str, packed: PackedDecoder, memkv: torch.Tensor,
                  mem_valid: torch.Tensor, max_length: int, K: int,
                  out_seq: torch.Tensor, out_score: Optional[torch.Tensor],
                  bos: int, eos: int, pad: int,
                  cluster: Optional[int] = None,
                  clocks: Optional[torch.Tensor] = None,
                  mode: int = 0) -> ClusterPlan:
    """Plan the tiles and launch the decode kernel ``name`` (fused_greedy
    or fused_beam) in ``mode`` (:func:`decode_mode`) on ``memkv``'s
    device -> the plan it ran.  ``cluster`` forces the cluster size (for
    measuring both).  ``clocks`` (int64 [max_length, PHASES], zeroed)
    receives the phase trace of the first block: the global timer in ns
    at each step's start (slot 0) and after each cluster sync (slots 1,
    2, ...)."""
    nl, _, B, S, E = memkv.shape
    L, V, F_ = max_length, packed.vocab_size, packed.ffn
    beam = name == "fused_beam"
    wbf16 = bool(mode & WEIGHTS_BF16)
    plan = plan_clusters(B, K, E, F_, V, L, S, beam,
                         max_clusters_on_card(name, mode), cluster)
    lib = cuda_build.load(name, signatures(name))
    frag = kernel_weights(packed, wbf16)
    emb = kernel_embedding(packed, wbf16)
    cache = torch.empty(nl * 2 * plan.tiles * plan.R * L * E,
                        dtype=torch.bfloat16 if mode & CACHE_BF16
                        else torch.float32, device=memkv.device)
    args = DecodeArgs(
        emb.data_ptr(), packed.pe.data_ptr(), packed.layers.data_ptr(),
        frag.data_ptr(), memkv.data_ptr(), mem_valid.data_ptr(),
        cache.data_ptr(), out_seq.data_ptr(),
        out_score.data_ptr() if out_score is not None else None,
        clocks.data_ptr() if clocks is not None else None,
        B, S, L, E, packed.nhead, F_, V, nl, K, plan.ns, plan.R, plan.C,
        plan.tiles, bos, eos, pad, mode, math.sqrt(E))
    stream = torch.cuda.current_stream(memkv.device).cuda_stream
    err = getattr(lib, f"{name}_launch")(ctypes.byref(args),
                                         ctypes.c_void_p(stream))
    cuda_build.check(err, name)
    return plan


def trace_phases(name: str, packed: PackedDecoder, memkv: torch.Tensor,
                 mem_valid: torch.Tensor, max_length: int, K: int = 1
                 ) -> torch.Tensor:
    """One traced launch of a decode kernel (the launch counts are not
    touched) -> microseconds of each phase of each step of the first tile,
    [steps run, phases] float64: the step's start to the first sync, then
    sync to sync; the last column ends at the step's end."""
    B = memkv.shape[2]
    dev = memkv.device
    clocks = torch.zeros(max_length, PHASES, dtype=torch.int64, device=dev)
    seq = torch.empty(B, K, max_length, dtype=torch.int32, device=dev)
    score = torch.empty(B, K, dtype=torch.float32, device=dev)
    launch_decode(name, packed, memkv, mem_valid, max_length, K, seq,
                  score if name == "fused_beam" else None, 1, 2, 0,
                  clocks=clocks)
    c = clocks.cpu()
    used = int((c[0] != 0).sum())
    c = c[(c[:, 0] != 0)][:, :used].double()
    return (c[:, 1:] - c[:, :-1]) / 1e3


def cluster_sync_ns(C: int, n4: int = 0, iters: int = 2000) -> float:
    """Mean ns of one round of the decode kernels' exchange on the card:
    each of C blocks writes n4 float4 values into every other block's
    shared memory, then one cluster sync (a probe kernel in
    csrc/fused_greedy.cu)."""
    lib = cuda_build.load("fused_greedy", signatures("fused_greedy"))
    out = torch.zeros(1, dtype=torch.int64, device="cuda")
    err = lib.fused_greedy_sync_probe(
        C, iters, n4, ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    cuda_build.check(err, "cluster sync probe")
    return float(out.item())


def greedy_pick_split(logits: torch.Tensor, C: int) -> torch.Tensor:
    """The greedy kernel's pick in plain PyTorch: arg-max of each block's
    vocabulary slice (first maximum), then the merge in slice order, a
    larger value or, on a tie, the lower id winning.  logits [R, V] ->
    ids [R]; equals ``argmax(logits, -1)``."""
    R, V = logits.shape
    best_v = torch.full((R,), -math.inf, dtype=logits.dtype,
                        device=logits.device)
    best_i = torch.full((R,), 2 ** 31 - 1, dtype=torch.long,
                        device=logits.device)
    for v0, v1 in vocab_slices(V, C):
        if v1 <= v0:
            continue
        v, i = logits[:, v0:v1].max(-1)
        i = i + v0
        take = (v > best_v) | ((v == best_v) & (i < best_i))
        best_v = torch.where(take, v, best_v)
        best_i = torch.where(take, i, best_i)
    return best_i


def fused_greedy_decode(packed: PackedDecoder, memkv: torch.Tensor,
                        mem_valid: torch.Tensor, max_length: int,
                        bos: int = 1, eos: int = 2, pad: int = 0,
                        cache_bf16: bool = False) -> torch.Tensor:
    """Greedy decode of every row -> token ids [B, max_length] int32.
    CUDA tensors launch ``csrc/fused_greedy.cu`` on the tiles that
    :func:`plan_clusters` picks; CPU tensors run :func:`fused_greedy_plain`.
    ``cache_bf16`` (memkv bf16) selects that mode on both.  ``launches``
    counts every launch, ``mode_launches[mode_name(...)]`` those of a
    mode."""
    check_inputs(packed, memkv, mem_valid, max_length, cache_bf16)
    if memkv.device.type == "cpu":
        return fused_greedy_plain(packed, memkv, mem_valid, max_length,
                                  bos, eos, pad, cache_bf16)
    if memkv.device.type != "cuda":
        raise ValueError(f"unsupported device {memkv.device}")
    B = memkv.shape[2]
    mode = decode_mode(cache_bf16)
    out = torch.empty(B, max_length, dtype=torch.int32, device=memkv.device)
    fused_greedy_decode.last_plan = launch_decode(
        "fused_greedy", packed, memkv, mem_valid, max_length, 1, out, None,
        bos, eos, pad, mode=mode)
    count_launch(fused_greedy_decode, mode)
    return out


def count_launch(wrapper, mode: int) -> None:
    wrapper.launches += 1
    name = mode_name(mode)
    wrapper.mode_launches[name] = wrapper.mode_launches.get(name, 0) + 1


def reset_launches(wrapper) -> None:
    """Set a decode wrapper's launch counts to 0."""
    wrapper.launches = 0
    wrapper.mode_launches = {}


reset_launches(fused_greedy_decode)
fused_greedy_decode.last_plan = None


class FusedGreedyDecoder:
    """Encoder + whole-loop greedy kernel for a ``Captioner``.

        fd = FusedGreedyDecoder(model, max_length=20)   # device="cuda"
        seq = fd(wav, wav_len)                          # [B, L] int32

    ``cache_bf16=None`` follows the decoder's compute dtype, as the JAX
    decoder does: a bf16 model (the serving configuration) decodes with
    bf16 memory K/V and caches; the kernel's weights stay float32.  The
    JAX decoder also doubles its kernel batch under bf16, which only
    frees TPU VMEM; here the planner tiles any batch, so nothing of that
    is copied."""

    def __init__(self, model, max_length: int = 20,
                 device: DeviceLike = "cuda",
                 cache_bf16: Optional[bool] = None):
        self.device = resolve_device(device)
        self.model = model
        self.max_length = max_length
        if cache_bf16 is None:
            cache_bf16 = model.decoder.compute_dtype == torch.bfloat16
        self.cache_bf16 = bool(cache_bf16)
        self.packed = pack_decoder_weights(model.decoder).to(self.device)

    @torch.no_grad()
    def __call__(self, wav: torch.Tensor, wav_len: torch.Tensor
                 ) -> torch.Tensor:
        enc = self.model.encode(wav.to(self.device), wav_len.to(self.device))
        memkv, mem_valid = memory_kv(self.model.decoder, enc["attn_emb"],
                                     enc["attn_emb_len"], self.cache_bf16)
        sp = self.model.special
        return fused_greedy_decode(self.packed, memkv, mem_valid,
                                   self.max_length, sp.bos, sp.eos, sp.pad,
                                   cache_bf16=self.cache_bf16)
