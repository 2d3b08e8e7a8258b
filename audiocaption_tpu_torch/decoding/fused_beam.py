"""Whole-loop beam search: the CUDA kernel ``csrc/fused_beam.cu``, its plain
PyTorch version, and the decoder that serves the API through them.

Replaces the TPU kernel ``audiocaption_tpu/decoding/fused_beam.py``
(``_make_beam_kernel`` :126-384, launched by ``_fused_beam_call``
:387-447; host side ``FusedBeamDecoder`` :450-622).

What bounds it on an H100: as the greedy kernel, the layer products, now
on K rows a sample.  The first design gave one block a sample (K <= 4),
streamed all ~12.4 MB of float32 weights from L2 per sample and step, and
copied the cache prefix at every step (16.0 ms for beam 3 at B=64).  The
kernel now runs on thread block clusters that split the weights by output
columns (``fused_greedy.plan_clusters``; a tile holds whole samples with
all K <= 8 beams), picks on the split vocabulary (per-slice log-sum-exp
partials, local top-K, one merge: :func:`beam_pick_split` is the same in
plain PyTorch) and follows each beam's history through an ancestry table
instead of copying caches.  A step is 18 serial phases with a cluster
sync each; beam 3 takes 5.4 ms at B=64 on the card (PERF.md).

Semantics (temp 1): log-softmax plus running beam score; only beam 0
competes at t=0; top-K over [K*V] with ties to the lower flat index
k*V + w; parent gather of caches, sequences and pad flags; harvest of
ended beams with score * (1/(t+1)), every beam harvested at t=L-1;
best-K merge of done beams and candidates by strict ">" in slot order;
-1000 on ended beams.  Outputs: n-best sequences [B, K, L] int32 and
scores [B, K] float32.

Modes, as the TPU kernel's (``fused_beam.py:387-413`` there; see
:mod:`fused_greedy`): ``cache_bf16`` stores the memory K/V and the
caches in bf16; ``weights_bf16`` stores the ten large matrices
(``_BF16_KEYS`` there: the embedding, the tied classifier, wqkv, wo,
xwq, xwo, w1, w2) in bf16, gathers the embedding row from the bf16
table and rounds each product's activation to bf16 (the TPU kernel's
``_dot``), with float32 sums; biases, LayerNorm and the PE table stay
float32.  The kernel runs those products on the bf16 tensor cores
(``mma.sync`` m16n8k16, float32 accumulators).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from audiocaption_tpu_torch.decoding.fused_greedy import (
    PackedDecoder, check_inputs, count_launch, decode_mode,
    decoder_rows_plain, launch_decode, memory_kv, pack_decoder_weights,
    product, reset_launches, round_bf16, vocab_slices)
from audiocaption_tpu_torch.device import DeviceLike, resolve_device
from audiocaption_tpu_torch.utils.profiling import span

NEG = -3.0e38        # the TPU kernel's stand-in for float32's lowest value
MAX_BEAMS = 8        # ACD_KMAX in csrc/decoder_common.cuh; the TPU kernel's K8


@torch.no_grad()
def fused_beam_plain(packed: PackedDecoder, memkv: torch.Tensor,
                     mem_valid: torch.Tensor, max_length: int,
                     beam_size: int = 3, bos: int = 1, eos: int = 2,
                     pad: int = 0, steps: Optional[torch.Tensor] = None,
                     cache_bf16: bool = False, weights_bf16: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the beam kernel ->
    (seq [B, K, L] int32, score [B, K] float32), in the mode that
    ``cache_bf16`` (bf16 caches; memkv is bf16 too) and ``weights_bf16``
    select; in a bf16 mode the sums follow the kernel's
    (``decoder_rows_plain``'s ``wide``).  ``steps`` ([B] int64), if
    given, gets the number of steps each sample runs before it stops, as
    the kernel runs them (for counting the work a call needs)."""
    nl, _, B, S, E = memkv.shape
    K, L, V = beam_size, max_length, packed.vocab_size
    dev = memkv.device
    f32 = dict(dtype=torch.float32, device=dev)
    neg = torch.tensor(NEG, **f32)
    sqrt_e = math.sqrt(E)
    cache = dict(dtype=torch.bfloat16) if cache_bf16 else {}
    self_k = memkv.new_zeros(nl, B, K, L, E, **cache)
    self_v = memkv.new_zeros(nl, B, K, L, E, **cache)
    emb = round_bf16(packed.emb) if weights_bf16 else packed.emb
    wide = cache_bf16 or weights_bf16
    valid = torch.ones(B, K, L, dtype=torch.bool, device=dev)
    word = torch.full((B, K), bos, dtype=torch.long, device=dev)
    topk_lp = torch.zeros(B, K, **f32)
    seq = torch.full((B, K, L), eos, dtype=torch.long, device=dev)
    done_seq = seq.clone()
    done_score = torch.full((B, K), NEG, **f32)
    done_count = torch.zeros(B, dtype=torch.long, device=dev)
    stopped = torch.zeros(B, dtype=torch.bool, device=dev)
    rows = torch.arange(B, device=dev)

    for t in range(L):
        if steps is not None:
            steps += (~stopped).long()
        valid[:, :, t] = word != pad
        x = emb[word] * sqrt_e + packed.pe[t]
        x = decoder_rows_plain(packed, x, t, self_k, self_v, valid, memkv,
                               mem_valid, weights_bf16, wide)
        logits = product(x, packed.cls, None, weights_bf16, wide)  # [B, K, V]
        m = logits.amax(-1, keepdim=True)
        lp = logits - m - torch.log(torch.exp(logits - m).sum(-1, keepdim=True))
        total = lp + topk_lp[..., None]
        if t == 0:
            total[:, 1:] = NEG
        flat = total.reshape(B, K * V).clone()
        picks, new_lp = [], []
        for _ in range(K):
            i = torch.argmax(flat, dim=-1)
            picks.append(i)
            new_lp.append(flat[rows, i])
            flat[rows, i] = NEG
        idx, new_lp = torch.stack(picks, 1), torch.stack(new_lp, 1)
        prev_beam = torch.div(idx, V, rounding_mode="floor")
        new_word = idx % V

        # parent-beam gather (rows > t are identical across beams)
        g = prev_beam[None, :, :, None, None].expand(nl, B, K, L, E)
        self_k = torch.gather(self_k, 2, g)
        self_v = torch.gather(self_v, 2, g)
        valid = torch.gather(valid, 1, prev_beam[..., None].expand(B, K, L))
        seq = torch.gather(seq, 1, prev_beam[..., None].expand(B, K, L))
        seq[:, :, t] = new_word

        # harvest, then best-K merge of done beams and candidates
        inv_len = torch.tensor(1.0, **f32) / torch.tensor(float(t + 1), **f32)
        is_end = (new_word == eos) | (t == L - 1)
        harvest = is_end & ~stopped[:, None]
        cand = torch.where(harvest, new_lp * inv_len, neg)
        srcs = torch.cat([done_score, cand], 1)                   # [B, 2K]
        chosen = torch.zeros(B, 2 * K, dtype=torch.bool, device=dev)
        slot_src, slot_score = [], []
        for _ in range(K):
            c = torch.where(chosen, neg, srcs)
            best = torch.full((B,), NEG, **f32)
            best_src = torch.zeros(B, dtype=torch.long, device=dev)
            for s in range(2 * K):
                better = c[:, s] > best
                best = torch.where(better, c[:, s], best)
                best_src = torch.where(better, torch.full_like(best_src, s),
                                       best_src)
            slot_src.append(best_src)
            slot_score.append(best)
            chosen[rows, best_src] = True
        both = torch.cat([done_seq, seq], 1)                      # [B, 2K, L]
        sel = torch.stack(slot_src, 1)
        done_seq = torch.gather(both, 1, sel[..., None].expand(B, K, L))
        done_score = torch.stack(slot_score, 1)
        done_count = done_count + (cand > NEG / 2).sum(1)
        stopped = stopped | (done_count >= K)
        topk_lp = torch.where(is_end, new_lp - 1000.0, new_lp)
        word = new_word
    return done_seq.to(torch.int32), done_score


@torch.no_grad()
def sequence_scores_plain(packed: PackedDecoder, memkv: torch.Tensor,
                          mem_valid: torch.Tensor, seq: torch.Tensor,
                          bos: int = 1, eos: int = 2, pad: int = 0,
                          cache_bf16: bool = False, weights_bf16: bool = False
                          ) -> torch.Tensor:
    """The plain version's score of given sequences seq [B, K, L], fed
    one token a step (teacher forcing) in the same mode: each sequence's
    log-softmax summed up to and including its first <eos> (all L tokens
    without one), over that length, as the beam search harvests it ->
    [B, K].  It holds a kernel's n-best scores to the model along the
    kernel's own sequences, where a bf16 mode's rounding makes two
    searches part ways."""
    nl, _, B, S, E = memkv.shape
    K, L = seq.shape[1], seq.shape[2]
    dev = memkv.device
    wide = cache_bf16 or weights_bf16
    cache = dict(dtype=torch.bfloat16) if cache_bf16 else {}
    self_k = memkv.new_zeros(nl, B, K, L, E, **cache)
    self_v = memkv.new_zeros(nl, B, K, L, E, **cache)
    valid = torch.ones(B, K, L, dtype=torch.bool, device=dev)
    emb = round_bf16(packed.emb) if weights_bf16 else packed.emb
    word = torch.full((B, K), bos, dtype=torch.long, device=dev)
    total = torch.zeros(B, K, dtype=packed.emb.dtype, device=dev)
    length = torch.zeros(B, K, dtype=torch.long, device=dev)
    ended = torch.zeros(B, K, dtype=torch.bool, device=dev)
    for t in range(L):
        valid[:, :, t] = word != pad
        x = emb[word] * math.sqrt(E) + packed.pe[t]
        x = decoder_rows_plain(packed, x, t, self_k, self_v, valid, memkv,
                               mem_valid, weights_bf16, wide)
        logits = product(x, packed.cls, None, weights_bf16, wide)
        m = logits.amax(-1, keepdim=True)
        lp = logits - m - torch.log(torch.exp(logits - m).sum(-1, keepdim=True))
        tok = seq[:, :, t].long()
        total += torch.where(ended, 0.0, lp.gather(-1, tok[..., None])[..., 0])
        length += (~ended).long()
        ended |= tok == eos
        word = tok
    return total / length


def beam_totals(logits: torch.Tensor, topk_lp: torch.Tensor, t: int,
                C: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The beam kernel's candidate scores, from its split log-sum-exp.
    logits [ns, K, V], running scores topk_lp [ns, K] -> (lse [ns, K],
    total [ns, K, V]).  Each of the C vocabulary slices gives per row
    (max, sum exp(l - max)); the merge takes m = max and s = sum_c s_c
    exp(m_c - m) in slice order, lse = m + log s; a candidate scores
    ((l - m) - log s) + topk_lp, and only beam 0 competes at t=0."""
    slices = [(a, b) for a, b in vocab_slices(logits.shape[-1], C) if b > a]
    m_c = [logits[..., a:b].amax(-1) for a, b in slices]
    s_c = [torch.exp(logits[..., a:b] - m[..., None]).sum(-1)
           for (a, b), m in zip(slices, m_c)]
    m = torch.stack(m_c).amax(0)
    s = torch.zeros_like(m)
    for mc, sc in zip(m_c, s_c):
        s = s + sc * torch.exp(mc - m)
    log_s = torch.log(s)
    total = ((logits - m[..., None]) - log_s[..., None]) + topk_lp[..., None]
    if t == 0:
        total[:, 1:] = NEG
    return m + log_s, total


def _best_k(v: torch.Tensor, f: torch.Tensor, K: int):
    """The K best of each row by value, ties to the lower flat index."""
    order = torch.argsort(f, dim=-1, stable=True)
    v, f = v.gather(1, order), f.gather(1, order)
    top = torch.sort(v, dim=-1, descending=True, stable=True).indices[:, :K]
    return v.gather(1, top), f.gather(1, top)


def beam_pick_split(logits: torch.Tensor, topk_lp: torch.Tensor, t: int,
                    C: int) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The beam kernel's pick in plain PyTorch, on the vocabulary split
    over a cluster of C blocks: :func:`beam_totals`, then each slice's K
    best candidates by (value, then lower flat index k*V + w), then the
    C*K survivors merged in the same order, which is the global top-K.
    -> (lse [ns, K], values [ns, K], flat indices [ns, K])."""
    ns, K, V = logits.shape
    lse, total = beam_totals(logits, topk_lp, t, C)
    flat = (torch.arange(K, device=logits.device)[:, None] * V
            + torch.arange(V, device=logits.device)[None])      # [K, V]
    cand_v, cand_f = [], []
    for a, b in vocab_slices(V, C):
        if b > a:
            v, f = _best_k(total[..., a:b].reshape(ns, -1),
                           flat[:, a:b].reshape(-1).expand(ns, -1), K)
            cand_v.append(v)
            cand_f.append(f)
    v, f = _best_k(torch.cat(cand_v, 1), torch.cat(cand_f, 1), K)
    return lse, v, f


def fused_beam_decode(packed: PackedDecoder, memkv: torch.Tensor,
                      mem_valid: torch.Tensor, max_length: int,
                      beam_size: int = 3, bos: int = 1, eos: int = 2,
                      pad: int = 0, cache_bf16: bool = False,
                      weights_bf16: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search of every sample -> (seq [B, K, L] int32, score [B, K]).
    CUDA tensors launch ``csrc/fused_beam.cu``; CPU tensors run
    :func:`fused_beam_plain`, both in the mode ``cache_bf16`` (memkv
    bf16) and ``weights_bf16`` select.  K <= 8 on both, as the TPU
    kernel.  ``launches`` counts every launch, ``mode_launches`` those
    of each mode."""
    check_inputs(packed, memkv, mem_valid, max_length, cache_bf16,
                 weights_bf16)
    if not 1 <= beam_size <= MAX_BEAMS or beam_size > packed.vocab_size:
        raise ValueError(f"beam_size must be in [1, {MAX_BEAMS}]")
    if memkv.device.type == "cpu":
        return fused_beam_plain(packed, memkv, mem_valid, max_length,
                                beam_size, bos, eos, pad,
                                cache_bf16=cache_bf16,
                                weights_bf16=weights_bf16)
    if memkv.device.type != "cuda":
        raise ValueError(f"unsupported device {memkv.device}")
    B, K, L = memkv.shape[2], beam_size, max_length
    mode = decode_mode(cache_bf16, weights_bf16)
    seq = torch.empty(B, K, L, dtype=torch.int32, device=memkv.device)
    score = torch.empty(B, K, dtype=torch.float32, device=memkv.device)
    fused_beam_decode.last_plan = launch_decode(
        "fused_beam", packed, memkv, mem_valid, L, K, seq, score, bos, eos,
        pad, mode=mode)
    count_launch(fused_beam_decode, mode)
    return seq, score


reset_launches(fused_beam_decode)
fused_beam_decode.last_plan = None


class FusedBeamDecoder:
    """Encoder + whole-loop beam kernel for a ``Captioner``.

        fb = FusedBeamDecoder(model, beam_size=3)     # device="cuda"
        seq = fb(wav, wav_len)                        # [B, L], best beam
        seq, score = fb(wav, wav_len, n_best=True)    # [B, K, L], [B, K]

    The JAX decoder's defaults: ``cache_bf16=None`` follows the
    decoder's compute dtype (bf16 caches for a bf16 model), and
    ``weights_bf16`` is off unless asked for.
    """

    def __init__(self, model, max_length: int = 20, beam_size: int = 3,
                 device: DeviceLike = "cuda",
                 cache_bf16: Optional[bool] = None,
                 weights_bf16: Optional[bool] = None):
        self.device = resolve_device(device)
        self.model = model
        self.max_length = max_length
        self.beam_size = beam_size
        if cache_bf16 is None:
            cache_bf16 = model.decoder.compute_dtype == torch.bfloat16
        self.cache_bf16 = bool(cache_bf16)
        self.weights_bf16 = bool(weights_bf16)
        self.packed = pack_decoder_weights(model.decoder).to(self.device)

    @torch.no_grad()
    def __call__(self, wav: torch.Tensor, wav_len: torch.Tensor,
                 n_best: bool = False):
        enc = self.model.encode(wav.to(self.device), wav_len.to(self.device))
        with span("ac.decode.memory_kv"):
            memkv, mem_valid = memory_kv(self.model.decoder, enc["attn_emb"],
                                         enc["attn_emb_len"], self.cache_bf16)
        sp = self.model.special
        with span("ac.decode.search"):
            seq, score = fused_beam_decode(self.packed, memkv, mem_valid,
                                           self.max_length, self.beam_size,
                                           sp.bos, sp.eos, sp.pad,
                                           cache_bf16=self.cache_bf16,
                                           weights_bf16=self.weights_bf16)
        return (seq, score) if n_best else seq[:, 0]
