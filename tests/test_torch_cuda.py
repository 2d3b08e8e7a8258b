"""The port's CUDA kernels (decode loops, log-mel, MBConv) against their
plain PyTorch versions, on the card.  Every test here needs an NVIDIA GPU
and skips elsewhere (a CUDA kernel has no CPU mode).  This file imports
torch only, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerances: greedy tokens exact at the small width; at the flagship
width at most 1% of tokens may differ (float32 sums in another order can
flip a near-tie); n-best beam scores of matching sequences within 1e-4;
log-mel within 1e-3 dB (1024-term float32 DFT sums in another order);
MBConv within 1e-4 * max(1, max |plain|) (float32 1x1 and depthwise sums
in another order than cuDNN's).
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,L,limit", CASES, ids=CASE_IDS)
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
                         [c + (3,) for c in CASES]
                         + [(SMALL, 7, 0.0, k) for k in (1, 2, 4)],
                         ids=CASE_IDS + ["beam1", "beam2", "beam4"])
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
@pytest.mark.parametrize("preset,seconds", [
    ("CNN14_MEL_32K", 1.0), ("CNN14_MEL_32K", 2.3), ("EFFB2_MEL_16K", 1.7)],
    ids=["32k_1s", "32k_ragged_tile", "16k_top_db"])
def test_logmel_kernel_matches_plain(cuda, preset, seconds):
    cfg = getattr(TF, preset)
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
          nominal_size=130), (2, 32, 11, 31))],
    ids=["expand_residual_k3", "pruned_k5_odd", "no_expand"])
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
