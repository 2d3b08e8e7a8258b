"""Whole-loop greedy decode: the CUDA kernel ``csrc/fused_greedy.cu``, its
plain PyTorch version, and the decoder that serves the API through them.

Replaces the TPU kernel ``audiocaption_tpu/decoding/fused_greedy.py``
(``_make_kernel`` :209-310, launched by ``_fused_decode_call`` :313-359;
host side ``pack_decoder_weights`` :113-171, ``FusedGreedyDecoder``
:362-530).

What bounds it on an H100: every step of every row reads all decoder
weights, about 12.5 MB in float32 at the flagship width (E=256, FFN
1024, V=4981, 2 layers), plus the row's memory K/V (2 * S * E floats per
layer) and its cache prefix.  Unique device-memory bytes per call are the
weights once plus the memory K/V, ~13 MB at B=64, S=31: about 4 us at
3.35 TB/s.  The weights fit the 50 MB L2, so the kernel streams them from
L2 B * L times; with one block per row it is bound by L2 bandwidth and
latency, far above that floor.  One block per row needs no grid-wide
synchronisation and keeps the hidden state in shared memory; reusing each
weight load across many rows per block (and ``wgmma``) is the way down.

The TPU kernel's lane-padded heads (HPAD=128) and VMEM chunking are TPU
constraints and are not copied: the layout here is unpadded, the
embedding is indexed directly, and the 1/sqrt(dh) scale is folded into
the query weights.

``fused_greedy_decode`` launches the kernel for CUDA tensors and runs
``fused_greedy_plain`` (same inputs, same outputs, vectorised over rows)
only for CPU tensors.  Semantics: greedy over max_length steps; a row
emits <eos> at every step after its first <eos> (the kernel stops that
row there); arg-max ties go to the lower id; masked attention scores are
-1e30.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from audiocaption_tpu_torch import cuda_build
from audiocaption_tpu_torch.device import DeviceLike, resolve_device

MASKED = -1e30


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
def memory_kv(dec, attn_emb: torch.Tensor, attn_emb_len: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder output -> (memkv [nlayers, 2, B, S, E] float32,
    mem_valid [B, S] uint8), the kernels' cross-attention inputs."""
    static, _ = dec.init_cache(attn_emb, attn_emb_len, 1)
    memkv = torch.stack([torch.stack([static[f"mem_k{i}"], static[f"mem_v{i}"]])
                         for i in range(dec.nlayers)]).float().contiguous()
    return memkv, (~static["mem_kpm"]).to(torch.uint8).contiguous()


# ----------------------------------------------------------------- plain --

def _layer_norm(x, g, b):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5) * g + b


def _attend(q, k, v, valid, H):
    """q [B, R, E]; k/v [B, R, T, E]; valid [B, R, T] -> ctx [B, R, E]."""
    B, R, E = q.shape
    T, dh = k.shape[2], E // H
    qh = q.reshape(B, R, H, dh)
    kh, vh = k.reshape(B, R, T, H, dh), v.reshape(B, R, T, H, dh)
    scores = torch.einsum("brhd,brthd->brht", qh, kh)
    scores = scores.masked_fill(~valid[:, :, None, :], MASKED)
    m = scores.amax(-1, keepdim=True)
    e = torch.exp(scores - m)
    attn = e / e.sum(-1, keepdim=True)
    return torch.einsum("brht,brthd->brhd", attn, vh).reshape(B, R, E)


def decoder_rows_plain(packed: PackedDecoder, x, t: int, self_k, self_v,
                       self_valid, memkv, mem_valid):
    """The kernels' per-step layer stack on rows x [B, R, E] at position t.
    self_k/self_v [nlayers, B, R, L, E] get this step's K/V at row t;
    self_valid [B, R, L]; memkv [nlayers, 2, B, S, E]; mem_valid [B, S]."""
    E, H, F_ = packed.emb_dim, packed.nhead, packed.ffn
    R = x.shape[1]
    mvalid = mem_valid.bool()[:, None].expand(-1, R, -1)
    for i in range(packed.nlayers):
        w = _layer_views(packed.layers[i], E, F_)
        ln = w["ln"]
        qkv = F.linear(x, w["wqkv"], w["bqkv"])
        q, k, v = qkv[..., :E], qkv[..., E:2 * E], qkv[..., 2 * E:]
        self_k[i, :, :, t] = k
        self_v[i, :, :, t] = v
        ctx = _attend(q, self_k[i, :, :, :t + 1], self_v[i, :, :, :t + 1],
                      self_valid[:, :, :t + 1], H)
        x = _layer_norm(x + F.linear(ctx, w["wo"], w["bo"]), ln[0], ln[1])
        xq = F.linear(x, w["xwq"], w["xbq"])
        mk = memkv[i, 0][:, None].expand(-1, R, -1, -1)
        mv = memkv[i, 1][:, None].expand(-1, R, -1, -1)
        ctx = _attend(xq, mk, mv, mvalid, H)
        x = _layer_norm(x + F.linear(ctx, w["xwo"], w["xbo"]), ln[2], ln[3])
        h = torch.relu(F.linear(x, w["w1"], w["b1"]))
        x = _layer_norm(x + F.linear(h, w["w2"], w["b2"]), ln[4], ln[5])
    return x


@torch.no_grad()
def fused_greedy_plain(packed: PackedDecoder, memkv: torch.Tensor,
                       mem_valid: torch.Tensor, max_length: int,
                       bos: int = 1, eos: int = 2, pad: int = 0
                       ) -> torch.Tensor:
    """Plain PyTorch version of the greedy kernel -> [B, L] int32."""
    nl, _, B, S, E = memkv.shape
    L = max_length
    dev = memkv.device
    sqrt_e = math.sqrt(E)
    self_k = memkv.new_zeros(nl, B, 1, L, E)
    self_v = memkv.new_zeros(nl, B, 1, L, E)
    valid = torch.ones(B, 1, L, dtype=torch.bool, device=dev)
    word = torch.full((B,), bos, dtype=torch.long, device=dev)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    out = torch.full((B, L), eos, dtype=torch.int32, device=dev)
    for t in range(L):
        valid[:, 0, t] = word != pad
        x = (packed.emb[word] * sqrt_e + packed.pe[t])[:, None]
        x = decoder_rows_plain(packed, x, t, self_k, self_v, valid, memkv,
                               mem_valid)
        new_word = torch.argmax(F.linear(x[:, 0], packed.cls), dim=-1)
        out_word = torch.where(finished, torch.full_like(new_word, eos),
                               new_word)
        finished = finished | (new_word == eos)
        out[:, t] = out_word.to(torch.int32)
        word = out_word
    return out


# ---------------------------------------------------------------- kernel --

def check_inputs(packed: PackedDecoder, memkv: torch.Tensor,
                 mem_valid: torch.Tensor, max_length: int) -> None:
    """Raise on inputs the kernels do not take."""
    nl, two, B, S, E = memkv.shape
    if two != 2 or nl != packed.nlayers or E != packed.emb_dim:
        raise ValueError(f"memkv shape {tuple(memkv.shape)} does not match "
                         "the packed decoder")
    if tuple(mem_valid.shape) != (B, S) or mem_valid.dtype != torch.uint8:
        raise ValueError("mem_valid must be uint8 [B, S]")
    if memkv.dtype != torch.float32:
        raise ValueError("memkv must be float32")
    if E % 4 or packed.ffn % 4 or E % packed.nhead:
        raise ValueError("the kernels need E and FFN multiples of 4 and "
                         "E divisible by the head count")
    if not 1 <= max_length <= packed.pe.shape[0]:
        raise ValueError(f"max_length {max_length} outside the PE table")
    tensors = [memkv, mem_valid, packed.emb, packed.cls, packed.pe,
               packed.layers]
    if any(x.device != memkv.device for x in tensors):
        raise ValueError("all inputs must be on one device")
    if memkv.device.type == "cuda" and not all(
            x.is_contiguous() for x in tensors):
        raise ValueError("the kernels need contiguous tensors")


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


_SIGNATURES = {"fused_greedy_launch": (
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
    + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int)}


def fused_greedy_decode(packed: PackedDecoder, memkv: torch.Tensor,
                        mem_valid: torch.Tensor, max_length: int,
                        bos: int = 1, eos: int = 2, pad: int = 0
                        ) -> torch.Tensor:
    """Greedy decode of every row -> token ids [B, max_length] int32.
    CUDA tensors launch ``csrc/fused_greedy.cu``; CPU tensors run
    :func:`fused_greedy_plain`."""
    check_inputs(packed, memkv, mem_valid, max_length)
    if memkv.device.type == "cpu":
        return fused_greedy_plain(packed, memkv, mem_valid, max_length,
                                  bos, eos, pad)
    if memkv.device.type != "cuda":
        raise ValueError(f"unsupported device {memkv.device}")
    nl, _, B, S, E = memkv.shape
    L = max_length
    fn = cuda_build.load("fused_greedy", _SIGNATURES).fused_greedy_launch
    out = torch.empty(B, L, dtype=torch.int32, device=memkv.device)
    self_kv = torch.empty(nl * 2 * B * L * E, dtype=torch.float32,
                          device=memkv.device)
    err = fn(_ptr(packed.emb), _ptr(packed.cls), _ptr(packed.pe),
             _ptr(packed.layers), _ptr(memkv), _ptr(mem_valid), _ptr(self_kv),
             _ptr(out), B, S, L, E, packed.nhead, packed.ffn,
             packed.vocab_size, nl, bos, eos, pad, math.sqrt(E),
             ctypes.c_void_p(
                 torch.cuda.current_stream(memkv.device).cuda_stream))
    cuda_build.check(err, "fused_greedy")
    fused_greedy_decode.launches += 1
    return out


fused_greedy_decode.launches = 0


class FusedGreedyDecoder:
    """Encoder + whole-loop greedy kernel for a ``Captioner``.

        fd = FusedGreedyDecoder(model, max_length=20)   # device="cuda"
        seq = fd(wav, wav_len)                          # [B, L] int32
    """

    def __init__(self, model, max_length: int = 20,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.max_length = max_length
        self.packed = pack_decoder_weights(model.decoder).to(self.device)

    @torch.no_grad()
    def __call__(self, wav: torch.Tensor, wav_len: torch.Tensor
                 ) -> torch.Tensor:
        enc = self.model.encode(wav.to(self.device), wav_len.to(self.device))
        memkv, mem_valid = memory_kv(self.model.decoder, enc["attn_emb"],
                                     enc["attn_emb_len"])
        sp = self.model.special
        return fused_greedy_decode(self.packed, memkv, mem_valid,
                                   self.max_length, sp.bos, sp.eos, sp.pad)
