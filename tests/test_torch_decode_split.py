"""Host side of the cluster decode kernels (``csrc/fused_greedy.cu``,
``csrc/fused_beam.cu``): the split pick's plain twins, the tile and
cluster planner, and the fragment order of the packed weights.  torch
only; the kernels themselves are held against their plain versions on
the card by tests/test_torch_cuda.py.

The twins must pick exactly what the plain versions pick (ties across
slice boundaries, all-equal rows); the split log-sum-exp within 1e-6
relative of ``torch.logsumexp`` (the same sum in another order)."""

import math

import pytest
import torch

from audiocaption_tpu_torch.decoding import fused_beam as TB
from audiocaption_tpu_torch.decoding import fused_greedy as TG
from audiocaption_tpu_torch.models.transformer_decoder import (
    TransformerDecoder)
from audiocaption_tpu_torch.models.zoo import random_init

torch.set_num_threads(1)

SPLITS = [1, 2, 8, 16]
VOCABS = [48, 4981]


def planted_logits(rows: int, V: int, C: int, seed: int) -> torch.Tensor:
    """Random logits whose maximum is tied across a slice boundary in
    half the rows (the last id of one block's slice and the first of the
    next), with row 0 all equal."""
    gen = torch.Generator().manual_seed(seed)
    logits = torch.randn(rows, V, generator=gen)
    bounds = [b for _, b in TG.vocab_slices(V, C) if 0 < b < V] or [V // 2]
    for r in range(1, rows, 2):
        b = bounds[r % len(bounds)]
        top = float(logits[r].max()) + 1.0
        logits[r, b - 1] = top
        logits[r, b] = top
    logits[0] = 0.5
    return logits


@pytest.mark.parametrize("V", VOCABS)
@pytest.mark.parametrize("C", SPLITS)
def test_greedy_pick_split_equals_argmax(C, V):
    logits = planted_logits(24, V, C, seed=C * 7 + V)
    got = TG.greedy_pick_split(logits, C)
    assert torch.equal(got, torch.argmax(logits, -1))
    assert int(got[0]) == 0                      # all equal: the lowest id


def plain_top_k(total: torch.Tensor, K: int):
    """fused_beam_plain's selection: K rounds of argmax over [K*V], the
    picked entry set to NEG."""
    ns = total.shape[0]
    flat = total.reshape(ns, -1).clone()
    rows = torch.arange(ns)
    picks, values = [], []
    for _ in range(K):
        i = torch.argmax(flat, -1)
        picks.append(i)
        values.append(flat[rows, i])
        flat[rows, i] = TB.NEG
    return torch.stack(values, 1), torch.stack(picks, 1)


@pytest.mark.parametrize("V", VOCABS)
@pytest.mark.parametrize("C", SPLITS)
def test_beam_pick_split_equals_plain_top_k(C, V):
    for K, t in ((1, 3), (3, 0), (3, 4), (8, 2)):
        ns = 3
        logits = planted_logits(ns * K, V, C, seed=K * 31 + C + t).reshape(
            ns, K, V)
        gen = torch.Generator().manual_seed(K + t)
        topk_lp = torch.randn(ns, K, generator=gen) * 3
        if K > 1:                    # two beams tied row for row
            logits[1, 1] = logits[1, 0]
            topk_lp[1, 1] = topk_lp[1, 0]
        lse, v, f = TB.beam_pick_split(logits, topk_lp, t, C)
        _, total = TB.beam_totals(logits, topk_lp, t, C)
        want_v, want_f = plain_top_k(total, K)
        assert torch.equal(f, want_f), (K, t)
        assert torch.equal(v, want_v), (K, t)
        ref = torch.logsumexp(logits.double(), -1)
        assert float(((lse.double() - ref).abs() / ref.abs().clamp_min(1))
                     .max()) <= 1e-6
        # the totals are the plain version's log-softmax plus the running
        # score, up to the log-sum-exp's rounding
        lp = torch.log_softmax(logits.double(), -1) + topk_lp.double()[..., None]
        live = total > TB.NEG / 2
        assert float((total.double() - lp)[live].abs().max()) <= 1e-5


SHAPES = {"small": dict(E=128, F_=256, V=48, L=7, S=9),
          "flagship": dict(E=256, F_=1024, V=4981, L=20, S=31),
          "long_memory": dict(E=256, F_=1024, V=4981, L=30, S=187)}


def h100_like(C: int, smem: int) -> int:
    """Resident clusters at one block an SM, as cudaOccupancyMaxActiveClusters
    reports them on an H100 SXM (132 SMs)."""
    return {16: 7, 8: 15}.get(C, 0)


@pytest.mark.parametrize("B", [1, 7, 64, 128])
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_plan_covers_every_row_and_column_once(shape, B):
    dims = SHAPES[shape]
    E, F_, V = dims["E"], dims["F_"], dims["V"]
    for K, beam in [(1, False)] + [(k, True) for k in range(1, 9)]:
        plan = TG.plan_clusters(B, K, **dims, beam=beam,
                                max_clusters=h100_like)
        assert plan.C in TG.CLUSTERS and plan.R == plan.ns * K
        assert 1 <= plan.R <= TG.RMAX and plan.smem <= TG.SMEM_LIMIT
        assert plan.smem == TG.smem_bytes(plan.R, E, F_, V, dims["L"],
                                          dims["S"], plan.C, beam)
        assert plan.waves == math.ceil(plan.tiles / h100_like(plan.C, 0))
        # every sample in exactly one tile, every tile holding one
        tile_of = [b // plan.ns for b in range(B)]
        assert sorted(set(tile_of)) == list(range(plan.tiles))
        # every row (sample, beam) in one physical cache row
        rows = {(b // plan.ns) * plan.R + (b % plan.ns) * K + k
                for b in range(B) for k in range(K)}
        assert len(rows) == B * K and max(rows) < plan.tiles * plan.R
        # every output column of every matrix and every vocabulary id
        # owned by exactly one block of the cluster
        for n_out in (3 * E, E, F_, V):
            tiles = TG.block_tiles(n_out, plan.C)
            owned = [m for a, b in tiles for m in range(a, b)]
            assert owned == list(range(math.ceil(n_out / 16)))
        ids = [v for a, b in TG.vocab_slices(V, plan.C) for v in range(a, b)]
        assert ids == list(range(V))
        widest = math.ceil(math.ceil(V / 16) / plan.C) * 16
        assert all(b - a <= widest for a, b in TG.vocab_slices(V, plan.C))


def test_planner_fills_the_card_and_respects_a_forced_cluster():
    flag = SHAPES["flagship"]
    greedy = TG.plan_clusters(64, 1, **flag, beam=False,
                              max_clusters=h100_like)
    # fewer rows a tile wins over the larger cluster at equal waves
    assert (greedy.C, greedy.tiles, greedy.R, greedy.waves) == (8, 13, 5, 1)
    beam3 = TG.plan_clusters(64, 3, **flag, beam=True,
                             max_clusters=h100_like)
    assert beam3.waves == 1 and beam3.R == 3 * beam3.ns
    forced = TG.plan_clusters(64, 3, **flag, beam=True,
                              max_clusters=h100_like, cluster=16)
    assert forced.C == 16 and forced.tiles * forced.ns >= 64
    # more tiles than resident clusters: every wave full
    wide = TG.plan_clusters(128, 3, **flag, beam=True, max_clusters=h100_like)
    assert wide.waves == 2 and wide.tiles > h100_like(wide.C, 0)
    one = TG.plan_clusters(1, 1, **flag, beam=False, max_clusters=h100_like)
    assert (one.tiles, one.R) == (1, 1)
    with pytest.raises(ValueError):
        TG.plan_clusters(64, 1, **flag, beam=False,
                         max_clusters=lambda C, smem: 0)


def test_frag_pack_puts_each_weight_at_its_mma_fragment_slot():
    gen = torch.Generator().manual_seed(3)
    N, K = 37, 21                                 # ragged in both
    w = torch.randn(N, K, generator=gen)
    packed = TG.frag_pack(w)
    Mt, Kt = math.ceil(N / 16), math.ceil(K / 8)
    assert packed.numel() == Mt * 16 * Kt * 8
    tiles = packed.view(Mt, Kt, 32, 4)
    for mt in range(Mt):
        for kt in range(Kt):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                for i in range(4):
                    row = mt * 16 + g + 8 * (i & 1)
                    col = kt * 8 + t + 4 * (i >> 1)
                    want = float(w[row, col]) if row < N and col < K else 0.0
                    assert float(tiles[mt, kt, lane, i]) == want


def test_kernel_weights_follow_frag_offsets():
    E, H, F_, V, NL = 32, 2, 48, 40, 2
    dec = TransformerDecoder(E, V, 16, nlayers=NL, nhead=H,
                             dim_feedforward=F_, tie_weights=True)
    random_init(dec, torch.Generator().manual_seed(0))
    packed = TG.pack_decoder_weights(dec.eval())
    frag = TG.kernel_weights(packed)
    assert TG.kernel_weights(packed) is frag           # made once
    offs = TG.frag_offsets(E, F_)
    for i in range(NL):
        w = TG._layer_views(packed.layers[i], E, F_)
        for name in ("wqkv", "wo", "xwq", "xwo", "w1", "w2"):
            want = TG.frag_pack(w[name])
            at = i * offs["size"] + offs[name]
            assert torch.equal(frag[at:at + want.numel()], want), name
    cls = TG.frag_pack(packed.cls)
    assert torch.equal(frag[NL * offs["size"]:], cls)
    assert packed.to("cpu").frag is None               # not carried across


def test_frag_pack_bf16_puts_each_weight_at_its_mma_fragment_slot():
    """The bf16 mma's A fragments (m16n8k16): register j of lane g*4 + t
    holds columns 2t, 2t + 1 (+ 8 for j >= 2) of row g (+ 8 for odd j),
    the lower column in the lower half; every value rounded to bf16."""
    gen = torch.Generator().manual_seed(4)
    N, K = 37, 45                                 # ragged in both
    w = torch.randn(N, K, generator=gen)
    packed = TG.frag_pack_bf16(w)
    assert packed.dtype == torch.bfloat16
    Mt, Kt = math.ceil(N / 16), math.ceil(K / 16)
    assert packed.numel() == Mt * 16 * Kt * 16
    tiles = packed.view(Mt, Kt, 32, 4, 2)         # [.., lane, register, half]
    wb = w.to(torch.bfloat16)
    for mt in range(Mt):
        for kt in range(Kt):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                for j in range(4):
                    for half in range(2):
                        row = mt * 16 + g + 8 * (j & 1)
                        col = kt * 16 + 2 * t + half + 8 * (j >> 1)
                        want = (wb[row, col] if row < N and col < K
                                else torch.tensor(0, dtype=torch.bfloat16))
                        assert tiles[mt, kt, lane, j, half] == want


def test_bf16_kernel_weights_follow_frag_offsets():
    E, H, F_, V, NL = 32, 2, 48, 40, 2
    dec = TransformerDecoder(E, V, 16, nlayers=NL, nhead=H,
                             dim_feedforward=F_, tie_weights=True)
    random_init(dec, torch.Generator().manual_seed(1))
    packed = TG.pack_decoder_weights(dec.eval())
    frag = TG.kernel_weights(packed, bf16=True)
    assert frag.dtype == torch.bfloat16 and packed.frag is None
    assert TG.kernel_weights(packed, bf16=True) is frag   # made once
    offs = TG.frag_offsets(E, F_, bf16=True)
    for i in range(NL):
        w = TG._layer_views(packed.layers[i], E, F_)
        for name in ("wqkv", "wo", "xwq", "xwo", "w1", "w2"):
            want = TG.frag_pack_bf16(w[name])
            at = i * offs["size"] + offs[name]
            assert torch.equal(frag[at:at + want.numel()], want), name
    assert torch.equal(frag[NL * offs["size"]:], TG.frag_pack_bf16(packed.cls))
    emb = TG.kernel_embedding(packed, bf16=True)
    assert emb.dtype == torch.bfloat16
    assert torch.equal(emb, packed.emb.to(torch.bfloat16))
    assert TG.kernel_embedding(packed) is packed.emb


def test_decode_modes_are_named_as_the_kernels_take_them():
    assert TG.decode_mode() == 0 and TG.mode_name(0) == "f32"
    assert TG.decode_mode(cache_bf16=True) == TG.CACHE_BF16 == 1
    assert TG.decode_mode(weights_bf16=True) == TG.WEIGHTS_BF16 == 2
    assert TG.mode_name(3) == "cache_bf16+weights_bf16"
    names = [n for n, _ in TG.DecodeArgs._fields_]
    assert names[names.index("pad") + 1] == "mode"
