"""The port's CUDA kernels (decode loops, log-mel, MBConv) against their
plain PyTorch versions, on the card.  Every test here needs an NVIDIA GPU
and skips elsewhere (a CUDA kernel has no CPU mode).  This file imports
torch only, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerances: decode tokens exact at the small width; at the flagship
width at most 1% of tokens may differ (float32 sums in another order can
flip a near-tie); n-best beam scores of matching sequences within 1e-4;
log-mel within 1e-3 dB (an FFT against the plain version's dense DFT,
both float32), and within 0.05-0.1 dB on a wave with an 80 dB range;
MBConv within 1e-4 * max(1, max |plain|) (1x1 products in 3xTF32, ~2^-22
relative a product, and sums in another order than cuDNN's).  The decode
kernels' bf16 modes: see BF16_BEAM_MODES below.
"""

import numpy as np
import pytest
import torch

from audiocaption_tpu_torch.decoding import fused_beam as TB
from audiocaption_tpu_torch.decoding import fused_greedy as TG
from audiocaption_tpu_torch.models.effb2 import MBConvBlock
from audiocaption_tpu_torch.models.transformer_decoder import (
    TransformerDecoder)
from audiocaption_tpu_torch.models.zoo import random_init
from audiocaption_tpu_torch.ops import frontend as TF
from audiocaption_tpu_torch.ops import fused_logmel as FL
from audiocaption_tpu_torch.ops import fused_mbconv as FM

torch.set_num_threads(1)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from audiocaption_tpu_torch.device import set_parity_precision
    set_parity_precision()
    return torch.device("cuda")


def make_inputs(E, H, FFN, V, NL, B, S, seed, device):
    """Random jittered decoder (packed) and well-spread memory K/V."""
    gen = torch.Generator().manual_seed(seed)
    dec = TransformerDecoder(E, V, 32, nlayers=NL, nhead=H,
                             dim_feedforward=FFN, tie_weights=True)
    random_init(dec, gen)
    with torch.no_grad():
        for p in dec.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.3)
    packed = TG.pack_decoder_weights(dec.eval()).to(device)
    memkv = torch.randn(NL, 2, B, S, E, generator=gen).to(device)
    lens = torch.randint(0, S + 1, (B,), generator=gen)
    lens[0] = S
    valid = (torch.arange(S)[None] < lens[:, None]).to(torch.uint8).to(device)
    return packed, memkv, valid


SMALL = dict(E=128, H=2, FFN=256, V=48, NL=2, B=8, S=9)
FLAGSHIP = dict(E=256, H=4, FFN=1024, V=4981, NL=2, B=8, S=31)
# a 60 s clip's memory (S = 6001 // 32) and a longer caption
LONG = dict(E=256, H=4, FFN=1024, V=4981, NL=2, B=4, S=187)
CASES = [(SMALL, 7, 0.0), (FLAGSHIP, 20, 0.01), (LONG, 30, 0.01)]
CASE_IDS = ["small", "flagship", "long_memory"]
# one sample (one cluster, one row) and a tile that does not fill
ROWS = [(dict(SMALL, B=1), 7, 0.0), (dict(SMALL, B=7), 7, 0.0)]
ROW_IDS = ["batch1", "batch7"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,L,limit", CASES + ROWS,
                         ids=CASE_IDS + ROW_IDS)
def test_greedy_kernel_matches_plain(cuda, shape, L, limit):
    args = make_inputs(seed=1, device=cuda, **shape)
    n0 = TG.fused_greedy_decode.launches
    got = TG.fused_greedy_decode(*args, L)
    torch.cuda.synchronize()
    assert TG.fused_greedy_decode.launches == n0 + 1
    want = TG.fused_greedy_plain(*args, L)
    mismatch = (got != want).float().mean().item()
    assert mismatch <= limit, mismatch


@pytest.mark.cuda
@pytest.mark.parametrize("shape,L,limit,K",
                         [c + (3,) for c in CASES + ROWS]
                         + [(SMALL, 7, 0.0, k) for k in (1, 2, 4, 5, 8)],
                         ids=CASE_IDS + ROW_IDS
                         + ["beam1", "beam2", "beam4", "beam5", "beam8"])
def test_beam_kernel_matches_plain(cuda, shape, L, limit, K):
    args = make_inputs(seed=2, device=cuda, **shape)
    n0 = TB.fused_beam_decode.launches
    seq, score = TB.fused_beam_decode(*args, L, K)
    torch.cuda.synchronize()
    assert TB.fused_beam_decode.launches == n0 + 1
    want_seq, want_score = TB.fused_beam_plain(*args, L, K)
    assert (seq != want_seq).float().mean().item() <= limit
    same = (seq == want_seq).all(-1)
    np.testing.assert_allclose(score[same].cpu().numpy(),
                               want_score[same].cpu().numpy(), atol=1e-4)


@pytest.mark.cuda
def test_beam_kernel_batch128_matches_plain(cuda):
    """384 rows: more tiles than resident clusters.  On these inputs a
    few of the float32 plain version's own scores lie more than 1e-4 from
    the same search in float64, so a score passes within 1e-4 of the
    float32 plain version, or else no further from the float64 result
    than the float32 plain version is."""
    import dataclasses
    packed, memkv, valid = make_inputs(seed=2, device=cuda,
                                       **dict(FLAGSHIP, B=128))
    seq, score = TB.fused_beam_decode(packed, memkv, valid, 20, 3)
    want_seq, want_score = TB.fused_beam_plain(packed, memkv, valid, 20, 3)
    p64 = dataclasses.replace(packed, **{
        k: getattr(packed, k).double() for k in ("emb", "cls", "pe",
                                                  "layers")})
    seq64, score64 = TB.fused_beam_plain(p64, memkv.double(), valid, 20, 3)
    assert (seq != want_seq).float().mean().item() <= 0.01
    same = (seq == want_seq).all(-1) & (seq == seq64).all(-1)
    assert int(same.sum()) > 0.9 * same.numel()
    err = (score[same] - want_score[same]).abs().double()
    dev_kernel = (score[same].double() - score64[same]).abs()
    dev_plain = (want_score[same].double() - score64[same]).abs()
    assert bool(((err <= 1e-4) | (dev_kernel <= dev_plain)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("C", [8, 16])
def test_decode_kernels_at_each_cluster_size(cuda, C):
    """The planner picks C; both sizes must give the plain version's
    tokens (a forced C changes the split, not the result)."""
    args = make_inputs(seed=3, device=cuda, **dict(SMALL, B=13))
    got = torch.empty(13, 7, dtype=torch.int32, device=cuda)
    seq = torch.empty(13, 3, 7, dtype=torch.int32, device=cuda)
    score = torch.empty(13, 3, device=cuda)
    g_plan = TG.launch_decode("fused_greedy", *args, 7, 1, got, None,
                              1, 2, 0, cluster=C)
    b_plan = TG.launch_decode("fused_beam", *args, 7, 3, seq, score,
                              1, 2, 0, cluster=C)
    torch.cuda.synchronize()
    assert g_plan.C == C and b_plan.C == C
    assert torch.equal(got, TG.fused_greedy_plain(*args, 7))
    assert torch.equal(seq, TB.fused_beam_plain(*args, 7, 3)[0])


@pytest.mark.cuda
def test_smem_formula_matches_the_kernels(cuda):
    """decoding/fused_greedy.py::smem_bytes, which the planner uses,
    equals carve_smem in csrc/decoder_common.cuh."""
    import ctypes
    from audiocaption_tpu_torch import cuda_build
    for name in ("fused_greedy", "fused_beam"):
        lib = cuda_build.load(name, TG.signatures(name))
        for R, E, F_, V, L, S, C in [(1, 128, 256, 48, 7, 9, 16),
                                     (24, 256, 1024, 4981, 20, 31, 16),
                                     (20, 256, 1024, 4981, 30, 187, 8)]:
            a = TG.DecodeArgs()
            a.R, a.E, a.F, a.V, a.L, a.S, a.C = R, E, F_, V, L, S, C
            assert getattr(lib, f"{name}_smem")(ctypes.byref(a)) == \
                TG.smem_bytes(R, E, F_, V, L, S, C, name == "fused_beam")


# the bf16 modes (cache_bf16: bf16 memory K/V and caches; weights_bf16:
# bf16 matrices on the bf16 tensor cores), each against its plain version
# in the same mode.  cache_bf16 as the float32 kernels: the plain version
# follows the kernel's float64 sums, so tokens agree and scores within
# 1e-4.  weights_bf16 rounds every product's inputs to bf16, so the bf16
# mma's own float32 sums flip a rounding now and then and the searches
# part ways; it is held by its n-best scores against the float64 plain
# version's scores of its own sequences, within 2e-2 (chip_smoke.py's
# WEIGHTS_SCORE_ATOL, below the JAX package's 5e-2 for its bf16 beam).
BF16_BEAM_MODES = [dict(cache_bf16=True), dict(weights_bf16=True),
                   dict(cache_bf16=True, weights_bf16=True)]
BF16_MODE_IDS = ["cache_bf16", "weights_bf16", "both"]


def check_bf16_beam(args, L, K, mode, seq, score):
    import dataclasses
    packed, memkv, valid = args
    if not mode.get("weights_bf16"):
        want_seq, want_score = TB.fused_beam_plain(*args, L, K, **mode)
        assert torch.equal(seq, want_seq)
        np.testing.assert_allclose(score.cpu().numpy(),
                                   want_score.cpu().numpy(), atol=1e-4)
        return
    p64 = dataclasses.replace(packed, **{
        k: getattr(packed, k).double() for k in ("emb", "cls", "pe",
                                                  "layers")})
    mem64 = memkv if mode.get("cache_bf16") else memkv.double()
    rescored = TB.sequence_scores_plain(p64, mem64, valid, seq, **mode)
    real = score > -100
    assert bool(real.any())
    err = (score[real].double() - rescored[real]).abs().max().item()
    assert err <= 2e-2, err


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 64])
def test_greedy_cache_bf16_matches_plain(cuda, B):
    packed, memkv, valid = make_inputs(seed=1, device=cuda,
                                       **dict(SMALL, B=B))
    args = (packed, memkv.to(torch.bfloat16), valid)
    n0 = TG.fused_greedy_decode.mode_launches.get("cache_bf16", 0)
    got = TG.fused_greedy_decode(*args, 7, cache_bf16=True)
    torch.cuda.synchronize()
    assert TG.fused_greedy_decode.mode_launches["cache_bf16"] == n0 + 1
    assert torch.equal(got, TG.fused_greedy_plain(*args, 7, cache_bf16=True))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", BF16_BEAM_MODES, ids=BF16_MODE_IDS)
@pytest.mark.parametrize("B", [1, 7, 64])
def test_beam_bf16_modes_match_plain(cuda, B, mode):
    packed, memkv, valid = make_inputs(seed=2, device=cuda,
                                       **dict(SMALL, B=B))
    if mode.get("cache_bf16"):
        memkv = memkv.to(torch.bfloat16)
    name = TG.mode_name(TG.decode_mode(**mode))
    n0 = TB.fused_beam_decode.mode_launches.get(name, 0)
    seq, score = TB.fused_beam_decode(packed, memkv, valid, 7, 3, **mode)
    torch.cuda.synchronize()
    assert TB.fused_beam_decode.mode_launches[name] == n0 + 1
    check_bf16_beam((packed, memkv, valid), 7, 3, mode, seq, score)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [8, 16])
def test_bf16_modes_at_each_cluster_size(cuda, C):
    """Both cluster sizes in every bf16 mode (a forced C changes the
    split, not the result)."""
    packed, memkv, valid = make_inputs(seed=3, device=cuda,
                                       **dict(SMALL, B=13))
    mk16 = memkv.to(torch.bfloat16)
    got = torch.empty(13, 7, dtype=torch.int32, device=cuda)
    plan = TG.launch_decode("fused_greedy", packed, mk16, valid, 7, 1, got,
                            None, 1, 2, 0, cluster=C, mode=TG.CACHE_BF16)
    torch.cuda.synchronize()
    assert plan.C == C
    assert torch.equal(got, TG.fused_greedy_plain(packed, mk16, valid, 7,
                                                  cache_bf16=True))
    for mode in BF16_BEAM_MODES:
        mem = mk16 if mode.get("cache_bf16") else memkv
        seq = torch.empty(13, 3, 7, dtype=torch.int32, device=cuda)
        score = torch.empty(13, 3, device=cuda)
        plan = TG.launch_decode("fused_beam", packed, mem, valid, 7, 3, seq,
                                score, 1, 2, 0, cluster=C,
                                mode=TG.decode_mode(**mode))
        torch.cuda.synchronize()
        assert plan.C == C
        check_bf16_beam((packed, mem, valid), 7, 3, mode, seq, score)


@pytest.mark.cuda
def test_bf16_mode_errors_raise(cuda):
    """No fallback: a mode the greedy kernel lacks is refused at launch."""
    packed, memkv, valid = make_inputs(seed=1, device=cuda,
                                       **dict(SMALL, B=2))
    out = torch.empty(2, 7, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        TG.launch_decode("fused_greedy", packed, memkv, valid, 7, 1, out,
                         None, 1, 2, 0, mode=TG.WEIGHTS_BF16)


# n_fft 256 and 2048: the kernel takes any power of two in between
WIN_16K_256 = TF.MelConfig(sample_rate=16000, win_ms=16, f_min=0.0,
                           f_max=None, norm=None, mel_scale="htk")
WIN_32K_2048 = TF.MelConfig(sample_rate=32000, win_ms=64)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg,seconds", [
    (TF.CNN14_MEL_32K, 1.0), (TF.CNN14_MEL_32K, 2.3), (TF.EFFB2_MEL_16K, 1.7),
    (WIN_16K_256, 1.3), (WIN_32K_2048, 1.1)],
    ids=["32k_1s", "32k_ragged_tile", "16k_top_db", "n_fft_256",
         "n_fft_2048"])
def test_logmel_kernel_matches_plain(cuda, cfg, seconds):
    """n_fft 1024 and 512 (the presets), 256 and 2048; a ragged last tile
    and a half-silent clip (the 1e-10 floor, top_db at 16 kHz)."""
    gen = torch.Generator().manual_seed(3)
    wav = (torch.randn(3, int(seconds * cfg.sample_rate), generator=gen)
           * 0.1).to(cuda)
    wav[2, wav.shape[1] // 2:] = 0.0
    front = TF.LogMelFrontend(cfg).to(cuda)
    tables = (front.basis, front.mel_fb, cfg)
    n0 = FL.fused_logmel.launches
    got = FL.fused_logmel(wav, *tables)
    torch.cuda.synchronize()
    assert FL.fused_logmel.launches == n0 + 1
    want = FL.fused_logmel_plain(wav, *tables)
    assert got.shape == want.shape == (3, wav.shape[1] // cfg.hop + 1,
                                       cfg.n_mels)
    assert float((got - want).abs().max()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [TF.CNN14_MEL_32K, TF.EFFB2_MEL_16K],
                         ids=["32k", "16k"])
def test_logmel_kernel_wide_dynamic_range(cuda, cfg):
    """Three tones at 0 dB plus noise 80 dB down.  Float32 rounding spreads
    ~1e-7 of the tones' amplitude into every bin, ~1e-3 of the noise's, so
    the quietest mel bands of any float32 version (the kernel's FFT and
    the plain version's dense DFT alike) sit a few hundredths of a dB off
    a float64 reference.  Limits: 0.05 dB against float64, 0.1 dB against
    the plain version (the two float32 errors may add)."""
    sr = cfg.sample_rate
    t = np.arange(int(2.3 * sr)) / sr
    wav = sum(0.5 * np.sin(2 * np.pi * f * t + ph)
              for f, ph in ((440.0, 0.3), (1250.7, 1.1), (5003.3, 2.0))) / 3
    wav = wav + np.random.RandomState(7).randn(len(t)) * 0.5e-4
    wav = np.stack([wav, wav[::-1]])
    front = TF.LogMelFrontend(cfg)
    w64 = torch.from_numpy(wav)
    frames = torch.nn.functional.pad(
        w64[:, None], (cfg.n_fft // 2,) * 2, mode="reflect")[:, 0].unfold(
        1, cfg.n_fft, cfg.hop)
    spec = torch.fft.rfft(frames * torch.from_numpy(
        TF.hann_window(cfg.n_fft)).double(), dim=-1)
    ref = FL.amplitude_to_db(spec.abs() ** 2 @ front.mel_fb.double(),
                             cfg.top_db)
    front = front.to(cuda)
    x = w64.float().to(cuda)
    n0 = FL.fused_logmel.launches
    got = FL.fused_logmel(x, front.basis, front.mel_fb, cfg)
    torch.cuda.synchronize()
    assert FL.fused_logmel.launches == n0 + 1
    want = FL.fused_logmel_plain(x, front.basis, front.mel_fb, cfg)
    assert float(ref.min()) < -80.0 and float(ref.max()) > 10.0
    assert float((got.double().cpu() - ref).abs().max()) <= 0.05
    assert float((got - want).abs().max()) <= 0.1


@pytest.mark.cuda
def test_frontend_sends_32k_cuda_waveforms_to_the_kernel(cuda):
    wav = torch.randn(2, 32000, device=cuda) * 0.1
    n0 = FL.fused_logmel.launches
    TF.LogMelFrontend(TF.CNN14_MEL_32K).to(cuda)(wav)
    assert FL.fused_logmel.launches == n0 + 1
    TF.LogMelFrontend(TF.EFFB2_MEL_16K).to(cuda)(wav)   # plain version
    assert FL.fused_logmel.launches == n0 + 1


def jittered_block(seed, **kwargs):
    """An eval MBConvBlock with random weights and BN statistics (the
    folded expand bias is not zero)."""
    gen = torch.Generator().manual_seed(seed)
    block = MBConvBlock(**kwargs).eval()
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
        for m in block.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
                m.weight.add_(1.0)
    return block


@pytest.mark.cuda
@pytest.mark.parametrize("kwargs,shape", [
    (dict(in_filters=24, out_filters=24, kernel=3, stride=1, expand_ratio=6,
          nominal_size=65), (5, 24, 16, 63)),
    (dict(in_filters=48, out_filters=37, kernel=5, stride=1, expand_ratio=6,
          nominal_size=33, oup_override=203, squeeze_override=9),
     (3, 48, 7, 125)),
    (dict(in_filters=32, out_filters=16, kernel=3, stride=1, expand_ratio=1,
          nominal_size=130), (2, 32, 11, 31)),
    (dict(in_filters=208, out_filters=208, kernel=5, stride=1,
          expand_ratio=6, nominal_size=9), (4, 208, 2, 32))],
    ids=["expand_residual_k3", "pruned_k5_odd", "no_expand", "wide_late_k5"])
def test_mbconv_kernel_matches_plain(cuda, kwargs, shape):
    block = jittered_block(5, **kwargs).to(cuda)
    spec, weights = FM.spec_of(block), FM.pack_mbconv(block)
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(shape, generator=gen).to(cuda)
    n0 = FM.fused_mbconv_s1.launches
    got = FM.fused_mbconv_s1(x, weights, spec)
    torch.cuda.synchronize()
    assert FM.fused_mbconv_s1.launches == n0 + 1
    want = FM.mbconv_plain(x, weights, spec)
    with torch.no_grad():
        ref = block(x)
    assert got.shape == want.shape == ref.shape
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-4 * scale
    assert float((want - ref).abs().max()) <= 1e-4 * scale
