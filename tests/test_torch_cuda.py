"""The port's CUDA kernels (decode loops, log-mel, MBConv) against their
plain PyTorch versions, on the card.  Every test here needs an NVIDIA GPU
and skips elsewhere (a CUDA kernel has no CPU mode).  This file imports
torch only, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerances: decode tokens exact at the small width; at the flagship
width at most 1% of tokens may differ (float32 sums in another order can
flip a near-tie); n-best beam scores of matching sequences within 1e-4;
log-mel within 1e-3 dB (the kernel's float64 FFT against the plain
version's dense float32 DFT), within 0.05-0.1 dB on a wave with an 80 dB
range, and within 1e-5 dB of a float64 log-mel on quiet bands;
MBConv within 1e-4 * max(1, max |plain|) (1x1 products in 3xTF32, ~2^-22
relative a product, and sums in another order than cuDNN's), and in the
bf16 work dtype within 1e-2 * max(1, max |plain|) of ``mbconv_plain`` in
bf16 (a bf16 ulp where a float32 sum in another order flips a rounding).
The decode kernels' bf16 modes: see BF16_BEAM_MODES below.  Every test
here ran on the card (NVIDIA H100 80GB HBM3, 98 of 98 passing); without
a card they skip.
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
@pytest.mark.parametrize("noise", [1e-3, 1e-4])
def test_logmel_kernel_holds_quiet_bands_to_float64(cuda, noise):
    """A loud 5 kHz tone over noise 54 or 74 dB down (ROADMAP Queue 3 M's
    mechanism): the kernel, which computes in float64, within 1e-5 dB of
    the float64 log-mel, where the float32 plain version lies 1e-3 to
    1e-2 dB from it."""
    front = TF.LogMelFrontend(TF.CNN14_MEL_32K)
    cfg = front.config
    t = np.arange(2 * 32000) / 32000
    wav = torch.from_numpy((0.5 * np.sin(2 * np.pi * 5000 * t) + noise
                            * np.random.RandomState(0).randn(len(t)))
                           .astype(np.float32))[None]
    frames = torch.nn.functional.pad(
        wav.double()[:, None], (cfg.n_fft // 2,) * 2, mode="reflect")[
        :, 0].unfold(1, cfg.n_fft, cfg.hop)
    spec = torch.fft.rfft(frames * torch.hann_window(
        cfg.n_fft, dtype=torch.float64), dim=-1)
    ref = FL.amplitude_to_db(spec.abs() ** 2 @ front.mel_fb.double(),
                             cfg.top_db)
    front = front.to(cuda)
    got = FL.fused_logmel(wav.to(cuda), front.basis, front.mel_fb, cfg)
    plain = FL.fused_logmel_plain(wav.to(cuda), front.basis, front.mel_fb,
                                  cfg)
    err = float((got.double().cpu() - ref).abs().max())
    assert err <= 1e-5
    assert float((plain.double().cpu() - ref).abs().max()) >= 50 * err


@pytest.mark.cuda
def test_kernel_path_ignores_compute_dtype(cuda):
    """The JAX Pallas branch takes no ``compute_dtype``; nor does the
    kernel: a 32 kHz frontend given bf16 gives float32's log-mel."""
    wav = torch.randn(2, 32000, device=cuda) * 0.1
    n0 = FL.fused_logmel.launches
    got = TF.LogMelFrontend(TF.CNN14_MEL_32K,
                            compute_dtype=torch.bfloat16).to(cuda)(wav)
    assert FL.fused_logmel.launches == n0 + 1
    assert torch.equal(got, TF.LogMelFrontend(TF.CNN14_MEL_32K).to(cuda)(wav))


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
def test_mbconv_kernel_bf16_matches_plain(cuda, kwargs, shape):
    """The bf16 work dtype: the kernel (bf16 m16n8k16 products, the
    depthwise summed in bf16) against ``mbconv_plain`` in bf16 on the same
    bf16 input, within 1e-2 * max(1, max |plain|): a few bf16 ulps, where
    float32 sums in another order flip a rounding."""
    block = jittered_block(5, **kwargs).to(cuda)
    spec, weights = FM.spec_of(block), FM.pack_mbconv(block)
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(shape, generator=gen).to(cuda, torch.bfloat16)
    n0 = FM.fused_mbconv_s1.launches
    got = FM.fused_mbconv_s1(x, weights, spec)
    torch.cuda.synchronize()
    assert FM.fused_mbconv_s1.launches == n0 + 1 and got.dtype == x.dtype
    want = FM.mbconv_plain(x, weights, spec)
    scale = max(1.0, float(want.float().abs().max()))
    diff = (got.float() - want.float()).abs()
    assert float(diff.max()) <= 1e-2 * scale
    assert float((diff == 0).float().mean()) > 0.5


@pytest.mark.cuda
def test_prefetch_hands_batches_over_on_the_consumers_stream(cuda):
    """``prefetch_to_device``'s CUDA transfer: each batch comes in order,
    equal to the host batch, after the consumer's stream has waited on the
    side stream's copies; a kernel queued right after reads the copy."""
    from audiocaption_tpu_torch.data.prefetch import prefetch_to_device
    host = [{"wav": np.full((64, 4096), i, np.float32),
             "idx": np.arange(3) + i, "audio_id": [f"a{i}"],
             "on_card": torch.full((2,), i, device=cuda)}
            for i in range(6)]
    seen = []
    for i, b in enumerate(prefetch_to_device(iter(host), cuda, depth=3)):
        assert b["wav"].device.type == "cuda" and b["audio_id"] == [f"a{i}"]
        assert b["on_card"] is host[i]["on_card"]     # passed through
        seen.append(float(b["wav"].sum()))
        assert b["idx"].cpu().tolist() == [i, i + 1, i + 2]
    torch.cuda.synchronize()
    assert seen == [64 * 4096 * float(i) for i in range(6)]


def _train_twin(device, seed=0):
    """The narrow flagship (full EffB2, emb 64, vocab 50, dropout 0) with
    jittered BN statistics, its recipe's train state, on ``device``."""
    from audiocaption_tpu_torch.losses.loss import masked_token_loss
    from audiocaption_tpu_torch.models.zoo import effb2_trm
    from audiocaption_tpu_torch.optim.schedules import (
        exponential_decay_with_warmup)
    from audiocaption_tpu_torch.training.trainer import create_train_state
    gen = torch.Generator().manual_seed(seed)
    m = effb2_trm(vocab_size=50, decoder_emb_dim=64, decoder_dropout=0.0)
    for block in m.encoder._blocks:
        block.drop_rate = 0.0
    random_init(m, gen)
    with torch.no_grad():
        for mod in m.encoder.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                n = mod.num_features
                mod.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
                mod.running_var.copy_(0.5 + torch.rand(n, generator=gen))
    state = create_train_state(
        m.to(device), 5e-4, exponential_decay_with_warmup(5e-4, 5e-7, 100,
                                                          20), 1e-6, 1.0)
    return state, masked_token_loss("label_smoothing", 0.1)


def _train_batch(device):
    rng = np.random.RandomState(0)
    cap = torch.tensor([[1, 5, 9, 11, 2, 0], [1, 7, 2, 0, 0, 0],
                        [1, 30, 31, 32, 33, 2]])
    return {"wav": torch.from_numpy((rng.randn(3, 32000) * 0.1).astype(
                np.float32)).to(device),
            "wav_len": torch.tensor([32000, 20000, 16000]).to(device),
            "cap": cap.to(device), "cap_len": torch.tensor([5, 3, 6]).to(
                device)}


@pytest.mark.cuda
def test_train_step_card_matches_cpu(cuda):
    """Two train steps (scheduled sampling at 1.0, then 0.0) of the same
    weights on the card and on the CPU: loss within 1e-4 relative, raw
    gradient norm within 1e-3, the NaN skip on the card."""
    from audiocaption_tpu_torch.training.trainer import train_step
    cpu, loss_fn = _train_twin(torch.device("cpu"))
    card, _ = _train_twin(cuda)
    for ss in (1.0, 0.0):
        got = train_step(card, loss_fn, _train_batch(cuda),
                         torch.tensor(ss), torch.Generator())
        want = train_step(cpu, loss_fn, _train_batch(torch.device("cpu")),
                          torch.tensor(ss), torch.Generator())
        assert not got["skipped"] and not want["skipped"]
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(got["grad_norm"]),
                                   float(want["grad_norm"]), rtol=1e-3)
    before = {k: v.clone() for k, v in card.model.state_dict().items()}
    bad = _train_batch(cuda)
    bad["wav"][0, 7] = float("nan")
    assert train_step(card, loss_fn, bad, torch.tensor(0.5),
                      torch.Generator())["skipped"]
    after = card.model.state_dict()
    assert all(torch.equal(v, after[k]) for k, v in before.items())


@pytest.mark.cuda
def test_val_score_launches_the_greedy_kernel(cuda):
    from audiocaption_tpu_torch.cli.run import ValScorer
    from audiocaption_tpu_torch.data.tokenizer import DictTokenizer
    state, _ = _train_twin(cuda)
    tok = DictTokenizer()
    for i in range(4, 50):
        tok.add_word(f"w{i}")
    b = _train_batch(cuda)
    loader = [{"audio_id": ["a", "b", "c"], "wav": b["wav"],
               "wav_len": b["wav_len"]}]
    refs = {k: [c] for k, c in zip("abc", tok.decode(b["cap"].cpu()))}
    TG.reset_launches(TG.fused_greedy_decode)
    score = ValScorer(state.model, tok, loader, refs, cuda)()
    assert np.isfinite(score) and TG.fused_greedy_decode.launches == 1
    assert state.model.training


def _untied_decoder(V: int, seed: int, device):
    """The cnn14rnn_trm decoder (E=256, memory width 512, an untied
    classifier), jittered, in eval."""
    gen = torch.Generator().manual_seed(seed)
    dec = TransformerDecoder(256, V, 512, tie_weights=False)
    random_init(dec, gen)
    with torch.no_grad():
        for p in dec.parameters():
            if p.dim() == 2:
                p.add_(torch.randn(p.shape, generator=gen) * 0.3)
    return dec.to(device).eval()


@pytest.mark.cuda
def test_greedy_kernel_untied_vocab_4368_matches_plain(cuda):
    """The SCST baseline's shapes: B=32, V=4368, untied classifier."""
    dec = _untied_decoder(4368, 3, cuda)
    packed = TG.pack_decoder_weights(dec).to(cuda)
    assert not torch.equal(packed.cls, packed.emb)
    gen = torch.Generator().manual_seed(4)
    memkv = torch.randn(2, 2, 32, 31, 256, generator=gen).to(cuda)
    lens = torch.randint(1, 32, (32,), generator=gen)
    valid = (torch.arange(31)[None] < lens[:, None]).to(torch.uint8).to(cuda)
    got = TG.fused_greedy_decode(packed, memkv, valid, 20)
    want = TG.fused_greedy_plain(packed, memkv, valid, 20)
    assert int((got != want).sum()) <= 0.01 * want.numel()
    assert len(torch.unique(want)) > 10


@pytest.mark.cuda
def test_refresh_repacks_into_the_same_buffers(cuda):
    """After a weight change, ``refresh()`` re-packs into the buffers the
    kernel reads, and decodes as a decoder packed anew does."""
    from audiocaption_tpu_torch.models.zoo import cnn14rnn_trm
    model = cnn14rnn_trm(vocab_size=300)
    random_init(model, torch.Generator().manual_seed(5))
    model.decoder.load_state_dict(_untied_decoder(300, 6, "cpu")
                                  .state_dict())
    model.to(cuda).eval()
    fd = TG.FusedGreedyDecoder(model, 12, device=cuda)
    gen = torch.Generator().manual_seed(7)
    enc = {"attn_emb": torch.randn(6, 9, 512, generator=gen).to(cuda),
           "attn_emb_len": torch.tensor([9, 8, 5, 3, 9, 1], device=cuda)}
    before = fd.decode_enc(enc)
    ptrs = [t.data_ptr() for t in (fd.packed.emb, fd.packed.cls,
                                   fd.packed.layers, fd.packed.frag)]
    with torch.no_grad():
        for p in model.decoder.parameters():
            if p.dim() == 2:
                p.add_(torch.randn(p.shape, generator=gen).to(cuda) * 0.3)
    fd.refresh()
    after = fd.decode_enc(enc)
    assert ptrs == [t.data_ptr() for t in (fd.packed.emb, fd.packed.cls,
                                           fd.packed.layers, fd.packed.frag)]
    fresh = TG.FusedGreedyDecoder(model, 12, device=cuda).decode_enc(enc)
    assert torch.equal(after, fresh) and not torch.equal(after, before)


@pytest.mark.cuda
def test_scst_step_on_card(cuda):
    """One SCST step of cnn14rnn_trm on the card with the kernel baseline:
    the cuDNN GRU's backward runs (the grad pass keeps it in train mode),
    the grad pass's log-probabilities equal the sampler's within 1e-4,
    BN statistics stay, the greedy kernel launches once; the rewards come
    from the native scorer, built with g++ where the test runs."""
    from audiocaption_tpu_torch.models.zoo import cnn14rnn_trm
    from audiocaption_tpu_torch.optim.schedules import (
        exponential_decay_with_warmup)
    from audiocaption_tpu_torch.training.scst import scst_step
    from audiocaption_tpu_torch.training.trainer import (
        bn_buffers, create_train_state)
    model = cnn14rnn_trm(vocab_size=300)
    random_init(model, torch.Generator().manual_seed(8))
    model.to(cuda)
    state = create_train_state(
        model, 5e-5, exponential_decay_with_warmup(5e-5, 5e-7, 10, 2), 1e-6,
        1.0)
    gen = torch.Generator(device=cuda).manual_seed(9)
    batch = {"wav": torch.randn(4, 32000, generator=gen, device=cuda) * 0.1,
             "wav_len": torch.tensor([32000, 30000, 20000, 12000],
                                     device=cuda)}
    refs = {k: ["w5 w6 w7", "w8 w9 w10"] for k in "abcd"}
    bn = [b.clone() for b in bn_buffers(model)]
    TG.reset_launches(TG.fused_greedy_decode)
    m = scst_step(state, batch, list("abcd"), refs,
                  {i: f"w{i}" for i in range(300)}, max_length=12,
                  generator=gen, baseline=TG.FusedGreedyDecoder(
                      model, 12, device=cuda))
    assert np.isfinite(m["loss"]) and TG.fused_greedy_decode.launches == 1
    mask = m["mask"] > 0
    assert float((m["token_logprob"] - m["sampled_logprob"])[mask]
                 .abs().max()) <= 1e-4
    assert all(torch.equal(a, b) for a, b in zip(bn, bn_buffers(model)))



def _student_decoder(seed: int, device):
    """The KD student's decoder (E=128, 2 heads, FFN 512, one layer,
    memory width 256, V=4368 untied), jittered, in eval."""
    gen = torch.Generator().manual_seed(seed)
    dec = TransformerDecoder(128, 4368, 256, nlayers=1, tie_weights=False)
    random_init(dec, gen)
    with torch.no_grad():
        for p in dec.parameters():
            if p.dim() == 2:
                p.add_(torch.randn(p.shape, generator=gen) * 0.3)
    return dec.to(device).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 32, 64])
def test_greedy_kernel_kd_student_shapes_match_plain(cuda, B):
    """The KD student's val score: E=128 over a cluster of 8 or 16
    blocks, one layer, a memory of S=250 (10 s through the Cdur5),
    V=4368 untied; at most 1% of tokens differ, one launch."""
    dec = _student_decoder(10, cuda)
    packed = TG.pack_decoder_weights(dec).to(cuda)
    assert (packed.emb_dim, packed.nhead, packed.ffn, packed.nlayers) == \
        (128, 2, 512, 1)
    gen = torch.Generator().manual_seed(11 + B)
    memkv = torch.randn(1, 2, B, 250, 128, generator=gen).to(cuda)
    lens = torch.randint(1, 251, (B,), generator=gen)
    lens[0] = 250
    valid = (torch.arange(250)[None] < lens[:, None]).to(torch.uint8).to(cuda)
    n0 = TG.fused_greedy_decode.launches
    got = TG.fused_greedy_decode(packed, memkv, valid, 20)
    torch.cuda.synchronize()
    assert TG.fused_greedy_decode.launches == n0 + 1
    want = TG.fused_greedy_plain(packed, memkv, valid, 20)
    assert int((got != want).sum()) <= 0.01 * want.numel()
    assert B == 1 or len(torch.unique(want)) > 10


def _kd_twin(device):
    """A KD student (V=300, dropout 0) and a cnn14rnn_trm teacher with
    their recipe's train state, the same seeded weights on any device."""
    from audiocaption_tpu_torch.models.zoo import (
        cnn14rnn_trm, kd_student_cdur5)
    from audiocaption_tpu_torch.optim.schedules import (
        exponential_decay_with_warmup)
    from audiocaption_tpu_torch.training.trainer import create_train_state
    student = kd_student_cdur5(vocab_size=300, decoder_dropout=0.0)
    student.encoder.dropout = 0.0
    random_init(student, torch.Generator().manual_seed(12))
    teacher = cnn14rnn_trm(vocab_size=300)
    random_init(teacher, torch.Generator().manual_seed(13))
    state = create_train_state(
        student.to(device), 5e-4,
        exponential_decay_with_warmup(5e-4, 5e-7, 100, 20), 1e-6, 1.0)
    return state, teacher.to(device).eval()


@pytest.mark.cuda
def test_token_kd_step_card_matches_cpu(cuda):
    """Two token-KD steps (KL at T=2, weight 0.5) of the same student and
    teacher on the card and on the CPU: loss within 1e-4 relative, raw
    gradient norm within 1e-3; the teacher's log-mel goes through the
    kernel on the card."""
    from audiocaption_tpu_torch.training.distill import (
        teacher_logits, token_kd_step)
    cpu = _kd_twin(torch.device("cpu"))
    card = _kd_twin(cuda)
    FL.fused_logmel.launches = 0
    for _ in range(2):
        out = {}
        for name, (state, teacher), dev in (("card", card, cuda),
                                            ("cpu", cpu, torch.device("cpu"))):
            b = _train_batch(dev)
            b["teacher_logit"] = teacher_logits(teacher, b)
            out[name] = token_kd_step(state, b, kd_weight=0.5,
                                      temperature=2.0)
        np.testing.assert_allclose(float(out["card"]["loss"]),
                                   float(out["cpu"]["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(out["card"]["grad_norm"]),
                                   float(out["cpu"]["grad_norm"]), rtol=1e-3)
    assert FL.fused_logmel.launches == 4


def plain64(packed, memkv):
    """The plain version's inputs in float64 (float32 values are exact
    there): the search without float32 rounding."""
    import dataclasses
    return dataclasses.replace(packed, **{
        k: getattr(packed, k).double() for k in ("emb", "cls", "pe",
                                                  "layers")}), memkv.double()


@pytest.mark.cuda
@pytest.mark.parametrize("K", [3, 5])
@pytest.mark.parametrize("B", [1, 32, 64])
@pytest.mark.parametrize("family", ["cnn14rnn_trm", "kd_student"])
def test_beam_kernel_eval_shapes_match_plain(cuda, family, B, K):
    """The evaluation path's beam search at the two trained families'
    decoder shapes: cnn14rnn_trm (E=256, 4 heads, 2 layers, V=4368 with
    an untied classifier, memory S=31: 10 s through the Cnn14) and the
    KD student (E=128, 2 heads, FFN 512, one layer, V=4368 untied, S=250:
    10 s through the Cdur5).  One launch; held against the plain version
    run in float64 on the same values: at most 1% of tokens differ, and
    the n-best scores of matching sequences lie within 1e-4.  Not against
    the float32 plain version: at the cnn14rnn_trm shapes its own scores
    lie further than 1e-4 from the float64 search and its beam-5 tokens
    part from it in more than 1%, where the kernel (float64 products)
    stays close to the float64 search (the test prints both distances;
    PERF.md §6 has them from the H100).  Ran on the card (H100)."""
    if family == "cnn14rnn_trm":
        dec, S, nl, E_ = _untied_decoder(4368, 20, cuda), 31, 2, 256
    else:
        dec, S, nl, E_ = _student_decoder(21, cuda), 250, 1, 128
    packed = TG.pack_decoder_weights(dec).to(cuda)
    assert not torch.equal(packed.cls, packed.emb)
    gen = torch.Generator().manual_seed(22 + B + K)
    memkv = torch.randn(nl, 2, B, S, E_, generator=gen).to(cuda)
    lens = torch.randint(1, S + 1, (B,), generator=gen)
    lens[0] = S
    valid = (torch.arange(S)[None] < lens[:, None]).to(torch.uint8).to(cuda)
    n0 = TB.fused_beam_decode.launches
    seq, score = TB.fused_beam_decode(packed, memkv, valid, 20, K)
    torch.cuda.synchronize()
    assert TB.fused_beam_decode.launches == n0 + 1
    p64, mem64 = plain64(packed, memkv)
    want_seq, want_score = TB.fused_beam_plain(p64, mem64, valid, 20, K)
    f32_seq, f32_score = TB.fused_beam_plain(packed, memkv, valid, 20, K)
    same = (seq == want_seq).all(-1)
    err = (score[same].double() - want_score[same]).abs()
    f32_same = (f32_seq == want_seq).all(-1)
    f32_err = (f32_score[f32_same].double() - want_score[f32_same]).abs()
    # the distances from the float64 search (pytest -s prints them)
    print(f"{family} B={B} beam {K}: kernel vs float64 plain "
          f"{int((seq != want_seq).sum())}/{seq.numel()} tokens, scores max "
          f"{float(err.max()):.3g}; float32 plain vs float64 plain "
          f"{int((f32_seq != want_seq).sum())} tokens, scores max "
          f"{float(f32_err.max()):.3g}")
    assert int((seq != want_seq).sum()) <= 0.01 * want_seq.numel()
    assert B == 1 or len(torch.unique(want_seq)) > 10
    assert bool(same.any())
    assert float(err.max()) <= 1e-4, float(err.max())


@pytest.mark.cuda
def test_runner_decode_on_card_matches_engine(cuda, tmp_path):
    """The runner's evaluation decode (``cli/run.py::experiment_model``,
    ``decoding/select.py::LoaderDecoder``) on one small experiment: a
    Cdur5 + 1-layer decoder (V=300) from a config node, its checkpoint
    written by ``save_checkpoint`` and read back without PyYAML; two
    batches of 32 kHz clips.  Beam 3 runs the beam kernel and greedy the
    greedy kernel, once a batch each, the log-mel kernel once a batch and
    method; at most 1% of tokens differ from the torch engine's on the
    same card.  Ran on the card (H100)."""
    from audiocaption_tpu_torch.cli.run import experiment_model
    from audiocaption_tpu_torch.data.tokenizer import DictTokenizer
    from audiocaption_tpu_torch.decoding.select import LoaderDecoder
    from audiocaption_tpu_torch.models.captioner import generate
    from audiocaption_tpu_torch.training.checkpoint import (
        load_checkpoint, model_variables, save_checkpoint)
    from audiocaption_tpu_torch.utils.config import build_model_from_config
    node = {"encoder": {"type": "Cdur5Encoder", "args": {}},
            "decoder": {"type": "TransformerDecoder",
                        "args": {"emb_dim": 128, "nlayers": 1}}}
    tok = DictTokenizer()
    for i in range(4, 300):
        tok.add_word(f"w{i}")
    model, _ = build_model_from_config(node, vocab_size=len(tok))
    random_init(model, torch.Generator().manual_seed(30))
    gen = torch.Generator().manual_seed(31)
    rng = np.random.RandomState(32)
    batches = []
    for j in range(2):
        wav = (rng.randn(5, 64000) * np.linspace(0.05, 0.5, 5)[:, None]
               ).astype(np.float32)
        lens = np.asarray([64000, 50000, 40000, 33000, 64000])
        batches.append({"audio_id": [f"c{j}{i}" for i in range(5)],
                        "wav": wav, "wav_len": lens})
    model.train()
    with torch.no_grad():         # BN statistics of one batch
        for m in model.encoder.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.reset_running_stats()
                m.momentum = None
        model.encode(torch.from_numpy(batches[0]["wav"]),
                     torch.from_numpy(batches[0]["wav_len"]))
        for p in model.decoder.parameters():
            if p.dim() == 2:
                p.add_(torch.randn(p.shape, generator=gen) * 0.3)
    save_checkpoint(str(tmp_path / "best.pth"), model_variables(model),
                    tokenizer_state=tok.state_dict())
    model, tok2 = experiment_model({"model": node},
                                   load_checkpoint(str(tmp_path / "best.pth")),
                                   cuda)
    assert len(tok2) == len(tok) and not model.training
    decoder = LoaderDecoder(model, cuda)
    for args in (dict(sample_method="beam", beam_size=3, max_length=12),
                 dict(sample_method="greedy", max_length=12)):
        TB.reset_launches(TB.fused_beam_decode)
        TG.reset_launches(TG.fused_greedy_decode)
        FL.fused_logmel.launches = 0
        got = [decoder(torch.from_numpy(b["wav"]),
                       torch.from_numpy(b["wav_len"]), **args).cpu()
               for b in batches]
        kernel = TB.fused_beam_decode if args["sample_method"] == "beam" \
            else TG.fused_greedy_decode
        assert kernel.launches == 2 and FL.fused_logmel.launches == 2
        want = [generate(model, torch.from_numpy(b["wav"]).to(cuda),
                         torch.from_numpy(b["wav_len"]).to(cuda),
                         **args)["seq"].cpu() for b in batches]
        mis = sum(int((g != w).sum()) for g, w in zip(got, want))
        assert mis <= 0.01 * sum(w.numel() for w in want), mis
        assert len(torch.unique(torch.cat(want))) > 5
    preds = decoder.decode_loader(tok2, batches, sample_method="beam",
                                  beam_size=3, max_length=12)
    assert list(preds) == [a for b in batches for a in b["audio_id"]]


def _tempgru_twin(device):
    """A narrow tag-conditioned captioner (the ``tempgru.yaml`` node at
    GRU 16, decoder 24; CNN BN frozen, dropout 0) and its recipe's train
    state on ``device``."""
    from audiocaption_tpu_torch.losses.loss import masked_token_loss
    from audiocaption_tpu_torch.optim.schedules import (
        exponential_decay_with_warmup)
    from audiocaption_tpu_torch.training.trainer import create_train_state
    from audiocaption_tpu_torch.utils.config import build_model_from_config
    node = {"type": "TemporalSeq2SeqAttnModel",
            "encoder": {"type": "Cnn14RnnEncoder",
                        "args": {"freeze_cnn_bn": True},
                        "rnn": {"args": {"bidirectional": True,
                                         "hidden_size": 16, "num_layers": 1,
                                         "dropout": 0.0}}},
            "decoder": {"type": "TemporalBahAttnDecoder",
                        "args": {"emb_dim": 16, "d_model": 24,
                                 "dropout": 0.0}}}
    m, _ = build_model_from_config(node, vocab_size=50)
    random_init(m, torch.Generator().manual_seed(0))
    state = create_train_state(
        m.to(device), 5e-4, exponential_decay_with_warmup(5e-4, 5e-7, 100,
                                                          20), 1e-6, 1.0)
    return state, masked_token_loss("label_smoothing", 0.1)


@pytest.mark.cuda
def test_tempgru_ss_step_card_matches_cpu(cuda):
    """The GRU decoder's scheduled-sampling step (phase 25's training
    path) with temporal tags, on the card and on the CPU, ss 1.0 then
    0.0: loss within 1e-4 relative, raw gradient norm within 1e-3; the
    log-mel kernel launches once a step."""
    from audiocaption_tpu_torch.training.trainer import train_step
    cpu, loss_fn = _tempgru_twin(torch.device("cpu"))
    card, _ = _tempgru_twin(cuda)
    FL.fused_logmel.launches = 0
    for ss in (1.0, 0.0):
        batches = [dict(_train_batch(d), temporal_tag=torch.tensor(
            [0, 2, 3]).to(d)) for d in (cuda, torch.device("cpu"))]
        got = train_step(card, loss_fn, batches[0], torch.tensor(ss),
                         torch.Generator())
        want = train_step(cpu, loss_fn, batches[1], torch.tensor(ss),
                          torch.Generator())
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(got["grad_norm"]),
                                   float(want["grad_norm"]), rtol=1e-3)
    assert FL.fused_logmel.launches == 2


@pytest.mark.cuda
def test_greedy_kernel_after_training_steps_matches_engine(cuda):
    """Phase 24's check at the narrow flagship: after 30 train steps the
    greedy kernel decodes as the torch engine does, or diverges only at a
    near tie (the engine's log-probabilities of the two words within
    1e-4)."""
    import torch.nn.functional as F
    from audiocaption_tpu_torch.models.captioner import generate
    from audiocaption_tpu_torch.training.trainer import train_step
    state, loss_fn = _train_twin(cuda)
    for _ in range(30):
        train_step(state, loss_fn, _train_batch(cuda), torch.tensor(0.9),
                   torch.Generator())
    model = state.model.eval()
    b = _train_batch(cuda)
    with torch.no_grad():
        enc = model.encode(b["wav"], b["wav_len"])
        ref = generate(model, enc=enc, sample_method="greedy",
                       max_length=12)["seq"]
        got = TG.FusedGreedyDecoder(model, max_length=12,
                                    device=cuda).decode_enc(enc)
        for r in torch.nonzero((got != ref).any(-1)).flatten().tolist():
            t = int(torch.nonzero(got[r] != ref[r])[0])
            prefix = torch.cat([ref.new_full((1,), 1), ref[r, :t]])[None]
            lp = F.log_softmax(model.decoder(
                prefix, enc["attn_emb"][r:r + 1], enc["attn_emb_len"][r:r + 1],
                cap_padding_mask=prefix == 0)["logit"][0, -1].double(), -1)
            assert float(lp[ref[r, t]] - lp[got[r, t]]) <= 1e-4


@pytest.mark.cuda
def test_sed_bank_is_the_logmel_kernel_in_float16(cuda):
    """Phase 25's bank: ``build_lms_bank`` on the card gives the log-mel
    kernel's values rounded to float16, and the kernel lies within 1e-3 dB
    of ``fused_logmel_plain``; the SED train step runs on it."""
    from audiocaption_tpu_torch.models.sed import Cnn8RnnSedModel
    from audiocaption_tpu_torch.training.sed_trainer import (
        build_lms_bank, framewise_targets, sed_train_step)
    rng = np.random.RandomState(0)
    waves = {f"c{i}": (rng.randn(320000) * 0.1).astype(np.float32)
             for i in range(5)}
    front = TF.LogMelFrontend(TF.CNN14_MEL_32K)
    FL.fused_logmel.launches = 0
    bank = build_lms_bank(waves.__getitem__, list(waves), front, cuda,
                          chunk=4)
    assert FL.fused_logmel.launches == 2 and bank.dtype == torch.float16
    wav = torch.from_numpy(np.stack(list(waves.values()))).to(cuda)
    with torch.no_grad():
        kernel = front(wav)
        plain = FL.fused_logmel_plain(wav, front.basis, front.mel_fb,
                                      front.config)
    assert float((kernel - plain).abs().max()) <= 1e-3
    assert torch.equal(bank, kernel.half())
    model = Cnn8RnnSedModel(classes_num=8).to(cuda)
    y = torch.from_numpy(np.stack([framewise_targets(
        [[i % 8, 1.0, 4.0]], bank.shape[1], 8) for i in range(5)])).to(cuda)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    losses = [float(sed_train_step(model, opt, bank, y,
                                   torch.arange(5, device=cuda)))
              for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 32])
def test_decode_kernels_cnn14trm_shapes_match_plain(cuda, B):
    """The Cnn14Transformer captioner's decode (``chip_smoke.py`` phase
    27(d)): the cnn14rnn_trm decoder (E=256, 4 heads, 2 layers, untied),
    a corpus-sized vocabulary (V=300) and a memory of 31 frames + the CLS
    token (S=32).  Greedy: at most 1% of tokens differ from plain; beam
    3: held against the plain search in float64, at most 1% of tokens
    differ and the n-best scores of matching sequences within 1e-4."""
    dec = _untied_decoder(300, 31, cuda)
    packed = TG.pack_decoder_weights(dec).to(cuda)
    gen = torch.Generator().manual_seed(32 + B)
    memkv = torch.randn(2, 2, B, 32, 256, generator=gen).to(cuda)
    lens = torch.randint(1, 33, (B,), generator=gen)
    lens[0] = 32
    valid = (torch.arange(32)[None] < lens[:, None]).to(torch.uint8).to(cuda)
    got = TG.fused_greedy_decode(packed, memkv, valid, 20)
    want = TG.fused_greedy_plain(packed, memkv, valid, 20)
    assert int((got != want).sum()) <= 0.01 * want.numel()
    seq, score = TB.fused_beam_decode(packed, memkv, valid, 20, 3)
    p64, mem64 = plain64(packed, memkv)
    want_seq, want_score = TB.fused_beam_plain(p64, mem64, valid, 20, 3)
    same = (seq == want_seq).all(-1)
    assert int((seq != want_seq).sum()) <= 0.01 * want_seq.numel()
    assert bool(same.any())
    err = (score[same].double() - want_score[same]).abs()
    assert float(err.max()) <= 1e-4, float(err.max())


def _gru_twin(device, dec_type="BahAttnAddFcDecoder", num_layers=2):
    """A Cnn6 + GRU-decoder captioner from a config node (emb and d_model
    32, dropout 0) and its train state on ``device``."""
    from audiocaption_tpu_torch.losses.loss import masked_token_loss
    from audiocaption_tpu_torch.optim.schedules import (
        exponential_decay_with_warmup)
    from audiocaption_tpu_torch.training.trainer import create_train_state
    from audiocaption_tpu_torch.utils.config import build_model_from_config
    node = {"encoder": {"type": "Cnn6Encoder", "args": {}},
            "decoder": {"type": dec_type,
                        "args": {"emb_dim": 32, "d_model": 32,
                                 "num_layers": num_layers, "dropout": 0.0}}}
    m, _ = build_model_from_config(node, vocab_size=50)
    random_init(m, torch.Generator().manual_seed(0))
    state = create_train_state(
        m.to(device), 5e-4, exponential_decay_with_warmup(5e-4, 5e-7, 100,
                                                          20), 1e-6, 1.0)
    return state, masked_token_loss("label_smoothing", 0.1)


@pytest.mark.cuda
def test_gru_stack_ss_step_card_matches_cpu(cuda, monkeypatch):
    """A 2-layer ``BahAttnAddFcDecoder`` over a Cnn6 (phase 27(b)'s pair,
    narrow): train steps with scheduled sampling at 1.0, then 0.0, on the
    card and on the CPU (the encoder's dropout off): loss within 1e-4
    relative, raw gradient norm within 1e-3; the log-mel kernel launches
    once a step."""
    import torch.nn.functional as F
    from audiocaption_tpu_torch.training.trainer import train_step
    monkeypatch.setattr(F, "dropout", lambda t, p=0.5, training=True,
                        inplace=False: t)
    cpu, loss_fn = _gru_twin(torch.device("cpu"))
    card, _ = _gru_twin(cuda)
    FL.fused_logmel.launches = 0
    for ss in (1.0, 0.0):
        got = train_step(card, loss_fn, _train_batch(cuda), torch.tensor(ss),
                         torch.Generator())
        want = train_step(cpu, loss_fn, _train_batch(torch.device("cpu")),
                          torch.tensor(ss), torch.Generator())
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(got["grad_norm"]),
                                   float(want["grad_norm"]), rtol=1e-3)
    assert FL.fused_logmel.launches == 2


@pytest.mark.cuda
def test_gru_scst_step_on_card(cuda):
    """SCST of a 2-layer GRU decoder on the card: the sample pass on the
    torch engine (no kernel), the grad pass's log-probabilities of the
    sampled words equal to the sampler's within 1e-4 on the masked
    positions, a finite loss, no decode kernel launched."""
    from audiocaption_tpu_torch.training.scst import scst_step
    state, _ = _gru_twin(cuda)
    b = _train_batch(cuda)
    refs = {"a": ["w5 w9"], "b": ["w7 w8"], "c": ["w30 w31 w32"]}
    n0 = TG.fused_greedy_decode.launches, TB.fused_beam_decode.launches
    m = scst_step(state, {"wav": b["wav"], "wav_len": b["wav_len"]},
                  ["a", "b", "c"], refs, {i: f"w{i}" for i in range(50)},
                  12, generator=torch.Generator(device=cuda).manual_seed(0))
    assert np.isfinite(m["loss"])
    assert (TG.fused_greedy_decode.launches,
            TB.fused_beam_decode.launches) == n0
    mask = m["mask"] > 0
    np.testing.assert_allclose(
        m["token_logprob"][mask].cpu().numpy(),
        m["sampled_logprob"][mask].cpu().numpy(), atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [32, 62, 7], ids=["htsat", "uit_xs",
                                               "esresnext"])
@pytest.mark.parametrize("B", [1, 32])
def test_decode_kernels_item8_shapes_match_plain(cuda, S, B):
    """The item-8 captioners' decode (``chip_smoke.py`` phase 29): the
    cnn14rnn_trm decoder (E=256, 4 heads, 2 layers, untied, V=300) over
    the memory lengths of HTS-AT and MobileNetV3 at 10 s (32), UiT-xs
    (62) and ESResNeXt-FBSP (7).  Greedy: at most 1% of tokens differ
    from plain; beam 3 against the plain search in float64: at most 1% of
    tokens differ, n-best scores of matching sequences within 1e-4."""
    dec = _untied_decoder(300, 29, cuda)
    packed = TG.pack_decoder_weights(dec).to(cuda)
    gen = torch.Generator().manual_seed(S + B)
    memkv = torch.randn(2, 2, B, S, 256, generator=gen).to(cuda)
    lens = torch.randint(1, S + 1, (B,), generator=gen)
    lens[0] = S
    valid = (torch.arange(S)[None] < lens[:, None]).to(torch.uint8).to(cuda)
    got = TG.fused_greedy_decode(packed, memkv, valid, 20)
    want = TG.fused_greedy_plain(packed, memkv, valid, 20)
    assert int((got != want).sum()) <= 0.01 * want.numel()
    seq, score = TB.fused_beam_decode(packed, memkv, valid, 20, 3)
    p64, mem64 = plain64(packed, memkv)
    want_seq, want_score = TB.fused_beam_plain(p64, mem64, valid, 20, 3)
    same = (seq == want_seq).all(-1)
    assert int((seq != want_seq).sum()) <= 0.01 * want_seq.numel()
    assert bool(same.any())
    err = (score[same].double() - want_score[same]).abs()
    assert float(err.max()) <= 1e-4, float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mobilenet_v3", "htsat", "uit_xs",
                                  "esresnext", "panns_cnn10",
                                  "panns_wavegram"])
def test_item8_encoder_card_matches_cpu(cuda, name):
    """Each item-8 encoder and PANNs classifier (``chip_smoke.item8_model``:
    published width, seeded weights, BN statistics jittered) on 2 clips of
    3 s that fill their length, the card against a CPU copy of the same
    weights (the 32 kHz log-mel through the kernel on the card, the plain
    version on the CPU): every output within 1e-3 * max(1, max |CPU|);
    the log-mel kernel launched for the 32 kHz log-mel models only."""
    import copy
    import chip_smoke
    from audiocaption_tpu_torch.models.uit import UIT_MEL_16K
    cpu_m, sr = chip_smoke.item8_model(name)
    card_m = copy.deepcopy(cpu_m).to(cuda)
    front = TF.LogMelFrontend(UIT_MEL_16K if sr == 16000
                              else TF.CNN14_MEL_32K)
    wav = torch.randn(2, 3 * sr, generator=torch.Generator().manual_seed(
        3)) * 0.1
    wav_len = torch.full((2,), 3 * sr, dtype=torch.long)

    def run(m, device):
        with torch.no_grad():
            return chip_smoke.item8_forward(name, m, front.to(device),
                                            wav.to(device),
                                            wav_len.to(device))
    FL.fused_logmel.launches = 0
    got = run(card_m, cuda)
    assert FL.fused_logmel.launches == (1 if sr == 32000 and
                                        name != "esresnext" else 0)
    want = run(cpu_m, torch.device("cpu"))
    for k, w in want.items():
        g = got[k].cpu()
        if not torch.is_floating_point(w):
            assert torch.equal(g, w), k
            continue
        assert bool(torch.isfinite(g).all()), k
        err = float((g.double() - w.double()).abs().max())
        assert err <= 1e-3 * max(1.0, float(w.abs().max())), (k, err)


@pytest.mark.cuda
def test_decode_search_span_holds_the_beam_kernel_alone(cuda):
    """Under the benchmark's profiler (``benchmark/harness/trace.py``) a
    ``FusedBeamDecoder`` call of the flagship (seeded weights, 2 clips of
    2 s) ties the beam kernel, and nothing else, to its
    ``ac.decode.search`` span, and the memory K/V products to
    ``ac.decode.memory_kv``."""
    import sys
    from pathlib import Path
    bench = str(Path(__file__).resolve().parent.parent / "benchmark")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    from harness.trace import Spans, profile
    from audiocaption_tpu_torch.models.zoo import effb2_trm
    model = random_init(effb2_trm(vocab_size=4981),
                        torch.Generator().manual_seed(4)).to(cuda).eval()
    dec = TB.FusedBeamDecoder(model, beam_size=3, device=cuda)
    wav = torch.randn(2, 32000, generator=torch.Generator().manual_seed(
        5)).to(cuda) * 0.1
    wav_len = torch.full((2,), 32000, dtype=torch.long, device=cuda)
    dec(wav, wav_len)
    torch.cuda.synchronize()
    holder = {}
    with profile(Spans(False), holder):
        dec(wav, wav_len)
    tr = holder["trace"]
    beam = sum(min(e, tr.t1) - max(s, tr.t0) for s, e, name, _ in tr.device
               if "fused_beam_kernel" in name) / 1e9
    assert beam > 0
    assert tr.device_s("ac.decode.search") == pytest.approx(beam, rel=1e-9)
    assert tr.device_s("ac.decode.memory_kv") > 0
    assert tr.span_count("ac.decode.search") == 1
    assert tr.span_count("ac.decode.memory_kv") == 1


def _clotho_batch(cuda, B: int = 32, seed: int = 40):
    """train_clotho's shape: B clips of 15-30 s at 32 kHz (lengths drawn
    from a seeded generator, the longest padded), on the card."""
    gen = torch.Generator().manual_seed(seed)
    wav_len = (15 + 15 * torch.rand(B, generator=gen)).mul(32000).long()
    wav = torch.randn(B, int(wav_len.max()), generator=gen) * 0.1
    return wav.to(cuda), wav_len.to(cuda), gen


@pytest.mark.cuda
def test_cnn14_rnn_encoder_launches_past_the_cnn14(cuda):
    """``Cnn14RnnEncoder.forward`` at train_clotho's shape (B=32, 15-30 s,
    train mode at the recipe's dropouts, the CNN frozen) under
    ``set_sync_debug_mode("error")``: no synchronising call (the GRU
    waits on an event recorded before the Cnn14, which torch does not
    count); when it returns, an event recorded right after the Cnn14's
    launches is not complete, so the host launched the whole BiGRU while
    the card still ran the Cnn14.  Its outputs equal the Cnn14 and GRU
    run apart, the GRU reading its lengths, bit for bit (one dropout
    seed)."""
    from audiocaption_tpu_torch.models.rnn_encoder import Cnn14RnnEncoder
    from audiocaption_tpu_torch.ops.frontend import CNN14_MEL_32K
    wav, wav_len, gen = _clotho_batch(cuda)
    feat_len = CNN14_MEL_32K.feat_len(wav_len)
    lms = (torch.randn(32, int(feat_len.max()), 64, generator=gen) * 10
           - 40).to(cuda)
    enc = random_init(Cnn14RnnEncoder(freeze_cnn=True, freeze_cnn_bn=True),
                      torch.Generator().manual_seed(41)).to(cuda).train()
    # the first call sets cuDNN up and draws the GRU's dropout state; a
    # call right after torch.manual_seed draws it anew with a blocking
    # read of a seed (torch's ``get_dropout_state``), so none is made here
    enc(lms, feat_len)
    torch.cuda.synchronize()
    cnn_end = torch.cuda.Event()
    hook = enc.cnn.register_forward_hook(lambda *args: cnn_end.record())
    torch.cuda.set_sync_debug_mode("error")
    try:
        enc(lms, feat_len)
        assert not cnn_end.query()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        hook.remove()
    torch.cuda.synchronize()
    torch.manual_seed(42)
    got = enc(lms, feat_len)
    torch.manual_seed(42)
    cnn_out = enc.cnn(lms, feat_len)
    want = enc.rnn(cnn_out["attn_emb"].detach(), cnn_out["attn_emb_len"])
    for key in ("attn_emb", "fc_emb", "attn_emb_len"):
        assert torch.equal(got[key], want[key]), key


@pytest.mark.cuda
def test_train_step_span_order_on_card(cuda):
    """One scheduled-sampling train step of cnn14rnn_trm at train_clotho's
    shape under a profiler: ``ac.train.forward`` holds the frontend, the
    encoder (holding the GRU's wait ``ac.sync.gru_lengths``) and the SS
    loop; then ``ac.train.backward``; then ``ac.train.optimizer`` holding
    ``ac.sync.finite_check``; each once, and no GRU read
    (``ac.sync.gru_lengths_read``)."""
    from audiocaption_tpu_torch.losses.loss import build_loss
    from audiocaption_tpu_torch.models.zoo import cnn14rnn_trm
    from audiocaption_tpu_torch.optim.schedules import (
        exponential_decay_with_warmup)
    from audiocaption_tpu_torch.training.trainer import (create_train_state,
                                                         train_step)
    wav, wav_len, gen = _clotho_batch(cuda)
    cap_len = torch.randint(10, 23, (32,), generator=gen)
    cap = torch.randint(3, 4368, (32, int(cap_len.max())), generator=gen)
    cap[:, 0] = 1
    cap[torch.arange(32), cap_len - 1] = 2
    cap[torch.arange(cap.shape[1])[None] >= cap_len[:, None]] = 0
    batch = {"wav": wav, "wav_len": wav_len, "cap": cap.to(cuda),
             "cap_len": cap_len.to(cuda)}
    model = random_init(cnn14rnn_trm(freeze_cnn=True, freeze_cnn_bn=True),
                        torch.Generator().manual_seed(43)).to(cuda)
    state = create_train_state(
        model, 5e-4, exponential_decay_with_warmup(5e-4, 5e-7, 100, 20),
        1e-6, 1.0)
    loss_fn = build_loss({"type": "LabelSmoothingLoss",
                          "args": {"smoothing": 0.1}})

    def step():
        return train_step(state, loss_fn, batch, ss_ratio=torch.tensor(0.85),
                          generator=torch.Generator().manual_seed(44))

    step()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = step()
    assert np.isfinite(float(out["loss"])) and not out["skipped"]
    spans = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.is_user_annotation()
                    and e.name().startswith("ac.")), key=lambda s: s[1])
    names = [s[0] for s in spans]
    for name in ("ac.train.forward", "ac.frontend", "ac.encoder",
                 "ac.sync.gru_lengths", "ac.ss_loop", "ac.train.backward",
                 "ac.train.optimizer", "ac.sync.finite_check"):
        assert names.count(name) == 1, (name, names)
    assert "ac.sync.gru_lengths_read" not in names
    by = {s[0]: s for s in spans}

    def inside(inner, outer):
        return by[outer][1] <= by[inner][1] and by[inner][2] <= by[outer][2]

    for inner in ("ac.frontend", "ac.encoder", "ac.ss_loop"):
        assert inside(inner, "ac.train.forward"), inner
    assert inside("ac.sync.gru_lengths", "ac.encoder")
    assert inside("ac.sync.finite_check", "ac.train.optimizer")
    assert by["ac.train.forward"][2] <= by["ac.train.backward"][1]
    assert by["ac.train.backward"][2] <= by["ac.train.optimizer"][1]
