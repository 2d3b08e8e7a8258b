#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``audiocaption_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases, each of which must pass (none is caught and skipped):

  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the port from ``csrc/`` with nvcc (one
     process per source, all started together), printing ``-Xptxas -v``
     (registers, shared memory, spills) for every kernel;
  3. hold each decode kernel against its plain PyTorch version on the
     card, at the flagship decoder width (E=256, 4 heads, 2 layers,
     V=4981), L=20, S=31, B=64, on random jittered decoder weights and
     random well-spread memory K/V: greedy and beams 3, 5 and 8.  Limits:
     at most 1% of tokens differ; n-best scores of matching sequences
     within 1e-4 (beam 3), and for beams 5 and 8 within 1e-4 or, where the
     float32 plain version itself lies further than that from the same
     search in float64, no further from the float64 result than the
     float32 plain version is (``float64_floor_check``);
  4. drive the EffB2 serving path end to end through
     ``Effb2TrmCaptioningModel`` at flagship width (random weights from a
     seed, decoder jittered, BN statistics jittered so the encoder output
     does not collapse): 8 clips of 10 s with mixed lengths, greedy, beam 3
     and beam 5, and compare with the torch-engine path on the same card
     (at most 1% of tokens differ);
  5. serve 16 clips through ``MicroBatchServer``; the answers must equal a
     direct decode of the same batch;
  6. time each decode kernel warm and with the L2 cold (a 64 MB buffer
     written before each call), its device time (``torch.profiler``), its
     plain version, both cluster sizes and one sample (B=1), at B=64,
     S=31; print a step's phase trace and the cost of one cluster
     exchange and sync; compute each kernel's bound from its inputs; time
     beams 5 and 8, and end-to-end clips/s for greedy and beam 3 at B=64
     on 10 s clips and the latency of one clip;
  7. hold the log-mel kernel against its plain version at B=64 x 10 s, for
     the 32 kHz Cnn14 preset and the 16 kHz EffB2 preset (the kernel is
     config-general: any power-of-two n_fft from 256 to 2048).  Limit
     1e-3 dB: the JAX package holds its own kernel to 2e-4 dB of its conv
     path, and here a float32 FFT is held against the plain version's
     dense float32 DFT, on 10 s of audio instead of 1 s;
  8. drive the temporal path end to end through
     ``Cnn14RnnTempAttnGruModel`` at full width (vocab 4981; random weights
     from a seed, decoder jittered, BN statistics jittered): 8 clips of
     10 s at 32 kHz with mixed lengths (each >= 1 s), greedy and beam 3,
     with and without a user temporal tag, and compare with the same
     modules fed by the plain log-mel on the same card.  Limits: at most 1%
     of tokens differ; SED framewise probabilities within 1e-4;
  9. time the log-mel kernel (its wrapper's call, as the path runs it;
     its device time alone from a ``torch.profiler`` trace), its plain
     version, the same log-mel through cuFFT (``torch.stft``,
     its library yardstick, held to the plain version within 1e-3 dB
     first) and its bound at B=64 x 10 s (a real FFT's operations against
     the bytes in and out), the split of one
     temporal-model batch (frontend, SED network, host tag step, captioner
     encoder, decode), and end-to-end clips/s, greedy and beam 3;
 10. walk the flagship EffB2 encoder of phase 4 (BN jittered, so the
     folded expand biases are not zero) block by block on folded weights
     at B=64 x 10 s: the 19 stride-1 blocks through the MBConv kernel, the
     4 stride-2 blocks through ``mbconv_plain``.  Each kernel block is
     held against ``mbconv_plain`` on the same input (1e-4 * max(1,
     max |plain|)), the walk's ``attn_emb`` against the unfolded cuDNN
     encoder (1e-3 * max |ref|), and greedy and beam-3 captions of 8
     mixed-length clips from both encoder outputs (at most 1% of tokens
     differ).  The same block checks on the pruned encoder
     (``build_pruned_effb2``, ratio 0.3, 1408-wide head);
 11. time, per stride-1 block and summed over the 19 at B=64 x 10 s, the
     kernel (its wrapper's call; the device time of each of its three
     launches from a ``torch.profiler`` trace), ``mbconv_plain``, the
     port's cuDNN ``MBConvBlock`` (its library yardstick) and the bound
     (``mbconv_work``: the 1x1 products at the 3xTF32 tensor-core rate,
     the rest at the float32 rate, against the bytes; the float32-only
     bound printed beside it), and the walked encoder against the cuDNN
     encoder;
 12. hold the decode kernels' bf16 modes against their plain versions in
     the same mode at the width of phase 3: greedy and beams 3, 5, 8 with
     ``cache_bf16`` (at most 1% of tokens differ; scores within 1e-4 or
     ``float64_floor_check`` in the same mode), and beam 3 with
     ``weights_bf16``.  In that mode every product rounds its inputs to
     bf16, so a float32-level difference between two versions (the bf16
     mma's own float32 sums) flips a rounding now and then and two
     searches part ways (the float32 plain version and its own float64
     run differ in a few percent of tokens too); it is held by the
     kernel's n-best scores against the float64 plain version's scores
     of the kernel's own sequences (``sequence_scores_plain``, limit
     WEIGHTS_SCORE_ATOL, below the JAX package's own 5e-2), and the
     share of differing tokens is printed;
 13. drive ``Effb2TrmCaptioningModel(compute_dtype=torch.bfloat16)`` (the
     weights of phase 4) end to end: 8 clips, greedy, beam 3 and beam 5,
     against the bf16 torch engine (at most 1% of tokens differ, or no
     more than the float32 engine differs from the bf16 one: the fused
     decoders run the decoder's products in float32, as the JAX
     package's do); greedy against the plain version on the same bf16
     memory K/V (at most 1%); the opt-in ``FusedBeamDecoder(weights_bf16=
     True)`` on the float32 model; 16 clips through ``MicroBatchServer``
     (equal to a direct decode); no float32 kernel may launch there;
 14. drive ``Cnn14RnnTempAttnGruModel(compute_dtype=torch.bfloat16)`` as
     phase 8 (kernel log-mel vs plain log-mel; SED within 1e-4 or the
     float32-vs-bf16 gap; tokens at most 1% or the float32-vs-bf16
     count); the log-mel kernel must launch there;
 15. time each bf16 mode's kernel (warm, cold L2, B=1) beside the float32
     kernel, its plain version and its bound (``decode_bound_ms`` at the
     mode's product rate, bytes with 2-byte K/V and weights); bf16
     clips/s of both models at B=64 x 10 s beside float32, greedy and
     beam 3; the bf16 EffB2 encode beside the float32 one.

Every kernel's launch counter is set to 0 just before each path is
driven (phases 4-5, the EffB2 serving path; phase 8, the temporal path;
phase 10, the folded encoder walks; phase 13, the bf16 EffB2 path, whose
counts by mode fill the bf16 entries; phase 14, the bf16 temporal path)
and read just after; the run fails if a kernel of that path was not
launched there.  The second-to-last line
is the kernels JSON object, the last line ``{"ok": true, "device":
{...}}``.

The script imports nothing of JAX.  It exits non-zero, printing no
result, where CUDA is unavailable or the package is not beside it.
"""

from __future__ import annotations

import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
E, NHEAD, FFN, V, NLAYERS = 256, 4, 1024, 4981, 2
B_KERNEL, S_KERNEL, L = 64, 31, 20
BEAMS = (3, 5, 8)             # phase 3: beam sizes held against plain
SR = 16000
SR_32K, B_LOGMEL = 32000, 64
MISMATCH_LIMIT = 0.01
SCORE_ATOL = 1e-4
LOGMEL_DB_ATOL = 1e-3
SED_ATOL = 1e-4
MBCONV_RTOL = 1e-4            # kernel vs plain, times max(1, max |plain|)
ENCODER_RTOL = 1e-3           # walked vs cuDNN attn_emb, times max |ref|
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 non-tensor FLOP/s,
# and float32 products through the TF32 tensor cores in a 3xTF32 split
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32X3_FLOPS = 495e12 / 3
BF16_FLOPS = 989e12           # dense bf16 tensor-core peak
# phase 12, weights_bf16: a kernel n-best score against the plain version's
# float64 score of the same sequence (see bf16_kernels)
WEIGHTS_SCORE_ATOL = 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_split(fn, iters: int = 5) -> dict:
    """Device time per kernel (ms per call of ``fn``), from a
    ``torch.profiler`` trace of ``iters`` calls after one warm-up: the
    launches of a multi-kernel call apart, and the kernels' time without
    the host's.  Empty if the profiler records no device time."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if us > 0:
            names = re.findall(r"[A-Za-z_]\w*_kernel\b", ev.key)
            name = names[0] if names else ev.key[:40]
            out[name] = out.get(name, 0.0) + us / 1e3 / iters
    return {k: round(v, 4) for k, v in sorted(out.items(),
                                              key=lambda kv: -kv[1])}


def jittered_decoder_inputs(device):
    """Random decoder weights (seeded, jittered as the parity tests do),
    packed for the kernels, and random well-spread memory K/V."""
    import torch
    from audiocaption_tpu_torch.decoding.fused_greedy import (
        pack_decoder_weights)
    from audiocaption_tpu_torch.models.transformer_decoder import (
        TransformerDecoder)
    from audiocaption_tpu_torch.models.zoo import random_init
    gen = torch.Generator().manual_seed(SEED)
    dec = TransformerDecoder(E, V, 1408, nlayers=NLAYERS, nhead=NHEAD,
                             dim_feedforward=FFN, tie_weights=True)
    random_init(dec, gen)
    with torch.no_grad():
        for p in dec.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.4)
    packed = pack_decoder_weights(dec.eval()).to(device)
    memkv = torch.randn(NLAYERS, 2, B_KERNEL, S_KERNEL, E,
                        generator=gen).to(device)
    lens = torch.randint(1, S_KERNEL + 1, (B_KERNEL,), generator=gen)
    lens[0], lens[1] = S_KERNEL, 0          # full and fully-masked memory
    valid = (torch.arange(S_KERNEL)[None] < lens[:, None]).to(torch.uint8)
    return packed, memkv, valid.to(device)


def decode_flops(E_, F_, V_, S_valid, steps_per_row, rows_per_sample):
    """(product ops, attention ops) one decode needs: per executed step and
    row, the layer and vocabulary products (weights times the row), and
    self attention over t+1 keys plus cross attention over the valid
    memory (2 ops per multiply-add)."""
    per_step_weights = NLAYERS * 2 * (6 * E_ * E_ + 2 * E_ * F_) + 2 * V_ * E_
    mm = attn = 0
    for s_valid, steps in zip(S_valid, steps_per_row):
        keys = s_valid if s_valid > 0 else S_KERNEL
        for t in range(steps):
            mm += rows_per_sample * per_step_weights
            attn += rows_per_sample * NLAYERS * 2 * 2 * E_ * ((t + 1) + keys)
    return mm, attn


def float64_floor_check(packed, memkv, valid, K, seq, score, p_seq,
                        p_score, **mode) -> bool:
    """Beam scores of the wider beams against the float32 plain version,
    with the float32 floor beside them.  At the flagship width with these
    jittered weights some of the float32 plain version's own n-best scores
    lie more than 1e-4 from the same search run in float64 (beam 5; this
    function prints by how much), so no kernel can hold all of them to
    1e-4.  A score of a sequence that the kernel,
    the plain version and the float64 plain version share passes if it is
    within SCORE_ATOL of the float32 plain version, or else no further
    from the float64 result than the float32 plain version is."""
    import dataclasses
    import torch
    from audiocaption_tpu_torch.decoding import fused_beam as FB
    p64 = dataclasses.replace(packed, **{
        k: getattr(packed, k).double() for k in ("emb", "cls", "pe",
                                                  "layers")})
    mem64 = memkv if mode.get("cache_bf16") else memkv.double()
    s64, sc64 = FB.fused_beam_plain(p64, mem64, valid, L, K, **mode)
    same = (seq == p_seq).all(-1) & (seq == s64).all(-1)
    err = (score[same].double() - p_score[same].double()).abs()
    dev_k = (score[same].double() - sc64[same]).abs()
    dev_p = (p_score[same].double() - sc64[same]).abs()
    ok = (err <= SCORE_ATOL) | (dev_k <= dev_p)
    log(f"beam {K} {mode or ''} scores on {int(same.sum())} shared "
        f"sequences: kernel vs "
        f"float32 plain max {float(err.max()):.3g}; float32 plain vs float64 "
        f"plain max {float(dev_p.max()):.3g} ({int((dev_p > SCORE_ATOL).sum())}"
        f" above {SCORE_ATOL}); kernel vs float64 plain max "
        f"{float(dev_k.max()):.3g}; {int((~ok).sum())} fail")
    return bool(ok.all()) and int(same.sum()) > 0


def decode_bound_ms(mm: int, attn: int, nbytes: int,
                    mm_flops: float = FP32_FLOPS):
    """(bound ms, bound ms with the products at the 3xTF32 rate, bound_by):
    the bytes at the HBM rate against the operations at the float32 peak,
    67 TFLOP/s, which is also the FP64 tensor-core rate that the kernels'
    products run at (float32 products are exact in float64).  The 3xTF32
    figure is what the products would need at a third of the TF32 peak.
    ``mm_flops``: the products' rate (BF16_FLOPS for weights_bf16)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (mm / mm_flops + attn / FP32_FLOPS) * 1e3
    t_tf32 = (mm / TF32X3_FLOPS + attn / FP32_FLOPS) * 1e3
    return (max(t_bytes, t_ops), max(t_bytes, t_tf32),
            "bytes" if t_bytes >= t_ops else "operations")


def cold_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` with the L2 cold: a 64 MB buffer is
    written before each call (as the encoder does between decodes on the
    serving path), and only the call is timed."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    total = 0.0
    for i in range(iters):
        flush.fill_(i & 0xff)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def input_bytes(packed, memkv, valid, out_bytes, weights_bf16=False):
    """Each input read once (the tied classifier is the embedding),
    each output written once.  The memory K/V at their element size (2
    bytes with cache_bf16); with weights_bf16 the embedding and the layer
    matrices at 2 bytes (biases and LayerNorm stay 4)."""
    wb = 2 if weights_bf16 else 4
    E_, F_ = packed.emb_dim, packed.ffn
    # wqkv, wo, xwq, xwo, w1, w2 of every layer
    n_mat = packed.nlayers * (6 * E_ * E_ + 2 * E_ * F_)
    n = packed.emb.numel() * wb + n_mat * wb
    n += (packed.layers.numel() - n_mat) * 4
    if packed.cls.data_ptr() != packed.emb.data_ptr():
        n += packed.cls.numel() * wb
    n += L * packed.pe.shape[1] * 4 + memkv.numel() * memkv.element_size()
    return n + valid.numel() + out_bytes


def jitter_model(api, gen) -> None:
    """Jitter the decoder and give every BN non-identity statistics."""
    import torch
    with torch.no_grad():
        for p in api.model.decoder.parameters():
            p.add_(torch.randn(p.shape, generator=gen).to(p.device) * 0.1)
        for m in api.model.encoder.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
                m.weight.copy_(1 + 0.2 * torch.randn(n, generator=gen))
                m.bias.copy_(0.2 * torch.randn(n, generator=gen))
    api._decode = {}


def jitter_temporal(api, gen) -> None:
    """Jitter the temporal decoder, sharpen the SED classifier (so SED tags
    vary and a user tag changes them) and give every BN (captioner encoder
    and SED) non-identity statistics."""
    import torch
    with torch.no_grad():
        for p in api.model.cap_model.decoder.parameters():
            # 0.1: larger jitters make the decoder GRU chaotic, so that
            # float32 rounding alone flips tokens late in a caption
            p.add_(torch.randn(p.shape, generator=gen).to(p.device) * 0.1)
        api.model.sed_model.fc_audioset.weight.mul_(2.7)
        for m in api.model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
                m.weight.copy_(1 + 0.2 * torch.randn(n, generator=gen))
                m.bias.copy_(0.2 * torch.randn(n, generator=gen))


def logmel_work(front, batch: int, samples: int):
    """(float ops, bytes) the log-mel function needs, whatever algorithm
    computes it.  Per frame: the window product (n_fft), a real FFT
    (2.5 n_fft log2 n_fft, the usual count), the power of the bins that
    carry mel weight (3 each), the mel product over the filterbank's
    nonzero weights (2 each) and the dB conversion (2 per mel).  Bytes:
    the wave read once, the window and the nonzero mel weights read once,
    the log-mel written once."""
    cfg = front.config
    n = cfg.n_fft
    n_frames = samples // cfg.hop + 1
    nonzero = front.mel_fb != 0
    nnz, bins = int(nonzero.sum()), int(nonzero.any(1).sum())
    per_frame = n + 2.5 * n * math.log2(n) + 3 * bins + 2 * nnz \
        + 2 * cfg.n_mels
    flops = int(batch * n_frames * per_frame)
    nbytes = 4 * (batch * samples + n + nnz + batch * n_frames * cfg.n_mels)
    return flops, nbytes


def stft_logmel(wav, front):
    """The library yardstick: the same log-mel with the spectrum from
    cuFFT (``torch.stft``: center, reflect pad, periodic Hann), then the
    mel product and dB.  Timed and checked here only; the port never
    calls it."""
    import torch
    from audiocaption_tpu_torch.ops.fused_logmel import amplitude_to_db
    cfg = front.config
    spec = torch.stft(wav, cfg.n_fft, cfg.hop,
                      window=torch.hann_window(cfg.n_fft, device=wav.device),
                      center=True, pad_mode="reflect", return_complex=True)
    power = (spec.real ** 2 + spec.imag ** 2).transpose(1, 2)
    return amplitude_to_db(torch.matmul(power, front.mel_fb), cfg.top_db)


def float64_logmel(wav, front):
    """The log-mel in float64 (``torch.fft.rfft`` of the reflect-padded,
    windowed frames): the yardstick of both float32 versions' rounding."""
    import torch
    from audiocaption_tpu_torch.ops.fused_logmel import amplitude_to_db
    cfg = front.config
    frames = torch.nn.functional.pad(
        wav.double()[:, None], (cfg.n_fft // 2,) * 2, mode="reflect")[:, 0]
    frames = frames.unfold(1, cfg.n_fft, cfg.hop) * torch.hann_window(
        cfg.n_fft, dtype=torch.float64, device=wav.device)
    power = torch.fft.rfft(frames, dim=-1).abs() ** 2
    return amplitude_to_db(power @ front.mel_fb.double(), cfg.top_db)


def logmel_check(dev, card):
    """Phase 7: the log-mel kernel against its plain version at
    B=64 x 10 s, 32 kHz and 16 kHz presets -> max |diff| per preset."""
    import torch
    from audiocaption_tpu_torch.ops import frontend as TF
    from audiocaption_tpu_torch.ops import fused_logmel as FL
    gen = torch.Generator().manual_seed(SEED + 2)
    errs = {}
    for name in ("CNN14_MEL_32K", "EFFB2_MEL_16K"):
        cfg = getattr(TF, name)
        front = TF.LogMelFrontend(cfg).to(dev)
        wav = torch.randn(B_LOGMEL, 10 * cfg.sample_rate, generator=gen) * 0.1
        wav[-1, wav.shape[1] // 2:] = 0.0          # silence: the 1e-10 floor
        wav = wav.to(dev)
        got = FL.fused_logmel(wav, front.basis, front.mel_fb, cfg)
        want = FL.fused_logmel_plain(wav, front.basis, front.mel_fb, cfg)
        ref = float64_logmel(wav, front)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        errs[name] = err
        log(f"log-mel kernel vs plain, {name}, B={B_LOGMEL} x 10 s "
            f"{tuple(got.shape)}: max |diff| {err:.3g} dB (limit "
            f"{LOGMEL_DB_ATOL}); against a float64 FFT: kernel "
            f"{float((got.double() - ref).abs().max()):.3g} dB, plain "
            f"{float((want.double() - ref).abs().max()):.3g} dB on {card}")
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        assert err <= LOGMEL_DB_ATOL, f"log-mel kernel disagrees on {name}"
    return errs


def temporal_path(dev, card, rng):
    """Phase 8: the temporal captioner end to end, kernel log-mel vs the
    same modules fed by the plain log-mel -> (api, launches)."""
    import numpy as np
    import torch
    from audiocaption_tpu_torch.decoding import fused_beam as FB
    from audiocaption_tpu_torch.decoding import fused_greedy as FG
    from audiocaption_tpu_torch.hf_api import (
        Cnn14RnnTempAttnGruConfig, Cnn14RnnTempAttnGruModel, pad_bucket)
    from audiocaption_tpu_torch.ops import fused_logmel as FL
    api = Cnn14RnnTempAttnGruModel(Cnn14RnnTempAttnGruConfig(vocab_size=V),
                                   seed=SEED, device="cuda")
    jitter_temporal(api, torch.Generator().manual_seed(SEED + 3))
    sr = SR_32K
    lens = np.asarray([10 * sr, 9 * sr, 7 * sr + 123, 5 * sr, 3 * sr + 7,
                       2 * sr, sr, sr + 4000])
    audio = (rng.randn(8, 10 * sr) * 0.1).astype(np.float32)
    for i, n in enumerate(lens):
        audio[i, n:] = 0.0                        # zero-padded clips
    user_tag = np.asarray([0, 1, 2, 3, 3, 2, 1, 0], np.int32)
    runs = [(m, t) for m in ("greedy", "beam") for t in (None, user_tag)]
    FG.reset_launches(FG.fused_greedy_decode)
    FG.reset_launches(FB.fused_beam_decode)
    FL.fused_logmel.launches = 0
    out = {}
    for method, tag in runs:
        out[method, tag is None] = api(audio, lens, temporal_tag=tag,
                                       sample_method=method, beam_size=3,
                                       max_length=L)
    launches = {"fused_greedy": FG.fused_greedy_decode.launches,
                "fused_beam": FB.fused_beam_decode.launches,
                "fused_logmel": FL.fused_logmel.launches}
    log(f"temporal-path launches: {launches}")
    assert launches["fused_logmel"] > 0, "the log-mel kernel was not launched"

    wav = torch.from_numpy(pad_bucket(audio, sr)).to(dev)
    front = api.model.cap_model.frontend
    lms_kernel = api.log_mel(wav)
    lms_plain = FL.fused_logmel_plain(wav, front.basis, front.mel_fb, api.mel)
    with torch.no_grad():
        fw_k = api.model.sed_model(lms_kernel)["framewise_output"]
        fw_p = api.model.sed_model(lms_plain)["framewise_output"]
        lens_t = torch.from_numpy(lens).to(dev)
        enc_k = api.model.cap_model.encode_lms(lms_kernel,
                                               api.mel.feat_len(lens_t))
        enc_p = api.model.cap_model.encode_lms(lms_plain,
                                               api.mel.feat_len(lens_t))
    enc_err = float((enc_k["attn_emb"] - enc_p["attn_emb"]).abs().max())
    sed_err = float((fw_k - fw_p).abs().max())
    tags = api.sed_tags(lms_kernel)
    log(f"temporal path: kernel vs plain log-mel: SED framewise max |diff| "
        f"{sed_err:.3g} (limit {SED_ATOL}), captioner attn_emb max |diff| "
        f"{enc_err:.3g}; SED tags {tags.tolist()}, "
        f"user tags {user_tag.tolist()}, merged "
        f"{np.minimum(user_tag, tags).tolist()} on {card}")
    assert sed_err <= SED_ATOL, "SED output disagrees"
    np.testing.assert_array_equal(tags, api.sed_tags(lms_plain))
    for (method, no_tag), ids in out.items():
        assert ids.shape == (8, L) and ((ids >= 0) & (ids < V)).all()
        ref = api.decode_lms(lms_plain, lens, None if no_tag else user_tag,
                             sample_method=method, beam_size=3,
                             max_length=L).cpu().numpy()
        mis = int((ids != ref).sum())
        log(f"temporal end to end {method}, "
            f"{'SED tag' if no_tag else 'user tag'}: kernel log-mel vs "
            f"plain log-mel {mis}/{ids.size} tokens differ; first caption "
            f"{ids[0][:8]} on {card}")
        assert mis <= MISMATCH_LIMIT * ids.size, f"{method} path disagrees"
    assert len(np.unique(np.concatenate(list(out.values())))) > 10, \
        "degenerate temporal captions"
    return api, launches


def temporal_times(api, dev, card):
    """Phase 9: log-mel kernel, plain, library yardstick and bound; the
    split of one temporal batch; end-to-end clips/s.  B=64 x 10 s."""
    import numpy as np
    import torch
    from audiocaption_tpu_torch.models.captioner import generate
    from audiocaption_tpu_torch.models.sed import framewise_to_temporal_tags
    from audiocaption_tpu_torch.ops import fused_logmel as FL
    front, B = api.model.cap_model.frontend, B_LOGMEL
    tables = (front.basis, front.mel_fb, api.mel)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    wav = torch.randn(B, 10 * SR_32K, generator=gen, device=dev) * 0.1
    lens = torch.full((B,), 10 * SR_32K, dtype=torch.long, device=dev)
    with torch.no_grad():
        lib_err = float((stft_logmel(wav, front)
                         - FL.fused_logmel_plain(wav, *tables)).abs().max())
        log(f"library yardstick (torch.stft + mel matmul) vs plain: max "
            f"|diff| {lib_err:.3g} dB (limit {LOGMEL_DB_ATOL})")
        assert lib_err <= LOGMEL_DB_ATOL, "the yardstick computes another function"
        k_ms = cuda_ms(lambda: FL.fused_logmel(wav, *tables), 10)
        p_ms = cuda_ms(lambda: FL.fused_logmel_plain(wav, *tables), 5,
                       warmup=1)
        lib_ms = cuda_ms(lambda: stft_logmel(wav, front), 10)
        k_ms2 = cuda_ms(lambda: FL.fused_logmel(wav, *tables), 10)
    flops, nbytes = logmel_work(front, B, wav.shape[1])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    log(f"fused_logmel device time by kernel (torch.profiler): "
        f"{device_split(lambda: FL.fused_logmel(wav, *tables))}")
    log(f"fused_logmel: {k_ms:.4f} ms/call (again {k_ms2:.4f}; plain "
        f"{p_ms:.3f} ms, torch.stft yardstick {lib_ms:.4f} ms, bound "
        f"{max(t_bytes, t_ops):.4f} ms: {nbytes} bytes, {flops} fp32 ops) "
        f"B={B} x 10 s 32 kHz on {card}")
    timing = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
              "bound_ms": max(t_bytes, t_ops),
              "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

    with torch.no_grad():
        lms = api.log_mel(wav)
        feat_len = api.mel.feat_len(lens)
        sed_ms = cuda_ms(lambda: api.model.sed_model(lms), 3, warmup=1)
        framewise = api.model.sed_model(lms)["framewise_output"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tags = framewise_to_temporal_tags(framewise.cpu().numpy())
        host_ms = (time.perf_counter() - t0) * 1e3
        enc_ms = cuda_ms(lambda: api.model.cap_model.encode_lms(lms,
                                                                feat_len),
                         3, warmup=1)
        enc = api.model.cap_model.encode_lms(lms, feat_len)
        tag_t = torch.from_numpy(tags).to(dev)
        dec_ms = {}
        for method in ("greedy", "beam"):
            dec_ms[method] = cuda_ms(lambda: generate(
                api.model.cap_model, enc=enc, temporal_tag=tag_t,
                sample_method=method, beam_size=3, max_length=L), 2,
                warmup=1)
    log(f"temporal batch split, B={B} x 10 s: frontend (log-mel kernel) "
        f"{k_ms:.3f} ms, SED network {sed_ms:.2f} ms, host tag step "
        f"{host_ms:.1f} ms (tags {np.bincount(tags, minlength=4).tolist()}), "
        f"captioner encoder {enc_ms:.2f} ms, decode greedy "
        f"{dec_ms['greedy']:.2f} ms / beam 3 {dec_ms['beam']:.2f} ms "
        f"on {card}")
    for method in ("greedy", "beam"):
        def fn():
            return api.decode_lms(api.log_mel(wav), lens,
                                  sample_method=method, beam_size=3,
                                  max_length=L)
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reps = 2
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / reps
        log(f"temporal end to end {method}: {B / dt:.1f} clips/s "
            f"({dt * 1e3:.1f} ms per batch of {B} x 10 s) on {card}")
    return timing


def mbconv_work(spec, batch: int, H: int, W: int, squeeze: int):
    """(1x1 product ops, other float ops, bytes) one folded MBConv block
    with ``squeeze`` SE channels needs on a [batch, C, H, W] input,
    whatever algorithm computes it: the expand and project products once
    (a multiply-add is 2 ops); besides them the bias adds (1), swish and
    sigmoid (4 each), the depthwise, the SE mean and the gate (1 per
    expanded value), the residual, and per sample the SE MLP.  Bytes: x
    read once, the output written once, the folded weights read once."""
    C, E, Co, k, S = spec.in_ch, spec.exp_ch, spec.out_ch, spec.kernel, \
        squeeze
    pt, pb, pl, pr = spec.pad
    Ho = (H + pt + pb - k) // spec.stride + 1
    Wo = (W + pl + pr - k) // spec.stride + 1
    mm_px = (2 * C * E if spec.has_expand else 0) + 2 * E * Co
    other_px = (5 * E if spec.has_expand else 0) + 2 * k * k * E + 5 * E \
        + 2 * E + Co + (Co if spec.has_residual else 0)
    per_sample = 2 * E * S + 5 * S + 2 * S * E + 5 * E
    mm = batch * Ho * Wo * mm_px
    other = batch * (Ho * Wo * other_px + per_sample)
    n_weights = (C * E + E if spec.has_expand else 0) + k * k * E + E \
        + E * S + S + S * E + E + E * Co + Co
    nbytes = 4 * (batch * C * H * W + batch * Co * Ho * Wo + n_weights)
    return mm, other, nbytes


def mbconv_bound_ms(mm: int, other: int, nbytes: int):
    """(bound ms, bound ms with every op at the float32 CUDA-core rate,
    bound_by): the larger of the bytes at the HBM rate and the operations,
    the 1x1 products at the 3xTF32 tensor-core rate (the kernel's route)
    and the rest at the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (mm / TF32X3_FLOPS + other / FP32_FLOPS) * 1e3
    t_fp32 = (mm + other) / FP32_FLOPS * 1e3
    return (max(t_bytes, t_ops), max(t_bytes, t_fp32),
            "bytes" if t_bytes >= t_ops else "operations")


def checked_walk(encoder, lms, feat_len, errs, inputs=None):
    """Walk ``encoder`` on folded weights: each stride-1 block through the
    kernel, held against ``mbconv_plain`` on the same input (max |diff|
    and max |plain| appended to ``errs``; each block's input kept in
    ``inputs`` when given); stride-2 blocks through ``mbconv_plain``."""
    import functools
    import torch
    from audiocaption_tpu_torch.ops import fused_mbconv as FM

    def check(x, fn, weights, spec):
        if inputs is not None:
            inputs.append(x)
        got = fn(x, weights=weights, spec=spec)
        want = FM.mbconv_plain(x, weights, spec)
        errs.append((float((got - want).abs().max()),
                     float(want.abs().max())))
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        return got

    blocks = []
    for fn in FM.folded_blocks(encoder):
        if fn.func is FM.fused_mbconv_s1:
            fn = functools.partial(check, fn=fn.func, **fn.keywords)
        blocks.append(fn)
    with torch.no_grad():
        return encoder(lms, feat_len, blocks=blocks)


def folded_path(api, wav64, len64, audio, lens, dev, card):
    """Phase 10: the EffB2 encoders walked on folded weights, stride-1
    blocks through the MBConv kernel -> (launches, max |diff|, inputs of
    the stride-1 blocks, lms, feat_len)."""
    import numpy as np
    import torch
    from audiocaption_tpu_torch.hf_api import pad_bucket
    from audiocaption_tpu_torch.models.captioner import generate
    from audiocaption_tpu_torch.models.effb2 import build_pruned_effb2
    from audiocaption_tpu_torch.ops import fused_mbconv as FM
    model, enc = api.model, api.model.encoder
    pruned = build_pruned_effb2(enc, prune_ratio=0.3, prune_head=False)
    with torch.no_grad():
        lms = model.frontend(wav64)
        feat_len = model.mel.feat_len(len64)
        ref = enc(lms, feat_len)
        pruned_ref = pruned(lms, feat_len)
        wav8 = torch.from_numpy(pad_bucket(audio, SR)).to(dev)
        len8 = torch.from_numpy(lens).to(dev)
        lms8, feat8 = model.frontend(wav8), model.mel.feat_len(len8)
        ref8 = enc(lms8, feat8)
    torch.cuda.synchronize()

    FM.fused_mbconv_s1.launches = 0
    errs, inputs, pruned_errs = [], [], []
    got = checked_walk(enc, lms, feat_len, errs, inputs)
    got8 = checked_walk(enc, lms8, feat8, [])
    got_pruned = checked_walk(pruned, lms, feat_len, pruned_errs)
    torch.cuda.synchronize()
    launches = FM.fused_mbconv_s1.launches
    log(f"folded-path launches: fused_mbconv {launches}")
    assert launches > 0, "the MBConv kernel was not launched"

    for name, e in (("flagship", errs), ("pruned 0.3", pruned_errs)):
        rel = [d / max(1.0, m) for d, m in e]
        log(f"MBConv kernel vs plain, {name} EffB2, {len(e)} stride-1 blocks "
            f"at B={lms.shape[0]} x 10 s: max |diff| per block "
            f"{[f'{d:.3g}' for d, _ in e]}, max relative {max(rel):.3g} "
            f"(limit {MBCONV_RTOL}) on {card}")
        assert len(e) == 19 and max(rel) <= MBCONV_RTOL, \
            f"MBConv kernel disagrees ({name})"
    for name, a, b in (("flagship", got, ref), ("pruned", got_pruned,
                                                pruned_ref),
                       ("flagship, 8 clips", got8, ref8)):
        err = float((a["attn_emb"] - b["attn_emb"]).abs().max())
        scale = float(b["attn_emb"].abs().max())
        log(f"walked encoder ({name}) vs cuDNN encoder: attn_emb "
            f"{tuple(a['attn_emb'].shape)} max |diff| {err:.3g}, max |ref| "
            f"{scale:.3g} (limit {ENCODER_RTOL} relative)")
        assert scale > 0.1 and err <= ENCODER_RTOL * scale, \
            f"walked encoder disagrees ({name})"
    for method in ("greedy", "beam"):
        ids = {}
        for name, e in (("walked", got8), ("cuDNN", ref8)):
            ids[name] = generate(model, enc=e, sample_method=method,
                                 beam_size=3, max_length=L)["seq"]
        ids = {k: v.cpu().numpy() for k, v in ids.items()}
        mis = int((ids["walked"] != ids["cuDNN"]).sum())
        log(f"captions from the walked vs cuDNN encoder, {method}: "
            f"{mis}/{ids['cuDNN'].size} tokens differ; "
            f"{len(np.unique(ids['cuDNN']))} distinct tokens; first caption "
            f"{ids['walked'][0][:8]} on {card}")
        assert mis <= MISMATCH_LIMIT * ids["cuDNN"].size, \
            f"{method} captions disagree"
    return launches, max(d for d, _ in errs), inputs, lms, feat_len


def mbconv_times(api, inputs, lms, feat_len, card):
    """Phase 11: per stride-1 block and summed over the 19, at B=64 x 10 s:
    the kernel, ``mbconv_plain``, the cuDNN block and the bound; the walked
    encoder against the cuDNN encoder."""
    import torch
    from audiocaption_tpu_torch.ops import fused_mbconv as FM
    enc = api.model.encoder
    blocks = [b for b in enc._blocks if b.plan["stride"] == 1]
    tot = dict(ms=0.0, plain=0.0, lib=0.0, bound=0.0, fp32=0.0, mm=0,
               other=0, nbytes=0)
    with torch.no_grad():
        for block, x in zip(blocks, inputs):
            spec, weights = FM.spec_of(block), FM.pack_mbconv(block)
            k_ms = cuda_ms(lambda: FM.fused_mbconv_s1(x, weights, spec), 10)
            p_ms = cuda_ms(lambda: FM.mbconv_plain(x, weights, spec), 10)
            c_ms = cuda_ms(lambda: block(x), 10)
            mm, other, nbytes = mbconv_work(spec, x.shape[0], x.shape[2],
                                            x.shape[3],
                                            weights["w_ser"].shape[1])
            bound, fp32, by = mbconv_bound_ms(mm, other, nbytes)
            idx = list(enc._blocks).index(block)
            plan = FM.plan_tiles(spec, x.shape[0], x.shape[2], x.shape[3])
            split = device_split(lambda: FM.fused_mbconv_s1(x, weights,
                                                             spec))
            log(f"fused_mbconv block {idx} {tuple(x.shape)} E={spec.exp_ch} "
                f"k={spec.kernel}: {k_ms:.4f} ms (plain {p_ms:.4f}, cuDNN "
                f"block {c_ms:.4f}, bound {bound:.4f} ms by {by}, float32-"
                f"only bound {fp32:.4f} ms: {nbytes} bytes, {mm} 1x1 ops, "
                f"{other} other ops; plan {tuple(plan)}; device ms by "
                f"launch {split})")
            for key, v in (("ms", k_ms), ("plain", p_ms), ("lib", c_ms),
                           ("bound", bound), ("fp32", fp32), ("mm", mm),
                           ("other", other), ("nbytes", nbytes)):
                tot[key] += v
        folded = FM.folded_blocks(enc)
        plain = FM.folded_blocks(enc, kernel=False)
        walk_ms = cuda_ms(lambda: enc(lms, feat_len, blocks=folded), 5)
        plain_walk_ms = cuda_ms(lambda: enc(lms, feat_len, blocks=plain), 5)
        cudnn_ms = cuda_ms(lambda: enc(lms, feat_len), 5)
    B = lms.shape[0]
    _, _, by = mbconv_bound_ms(tot["mm"], tot["other"], tot["nbytes"])
    log(f"fused_mbconv, 19 stride-1 blocks summed, B={B} x 10 s: "
        f"{tot['ms']:.3f} ms (plain {tot['plain']:.3f}, cuDNN blocks "
        f"{tot['lib']:.3f}, bound {tot['bound']:.4f} ms, float32-only "
        f"bound {tot['fp32']:.4f} ms; {tot['mm']} 1x1 ops, {tot['other']} "
        f"other ops, {tot['nbytes']} bytes) on {card}")
    log(f"EffB2 encoder, B={B} x 10 s log-mel in: walked with the "
        f"kernel {walk_ms:.3f} ms, walked all plain {plain_walk_ms:.3f} ms, "
        f"cuDNN modules {cudnn_ms:.3f} ms on {card}")
    return {"ms": tot["ms"], "plain_ms": tot["plain"],
            "library_ms": tot["lib"], "bound_ms": tot["bound"],
            "bound_by": by}


def decode_times(packed, memkv, valid, g_kernel, beams, launches,
                 greedy_err, score_err, card):
    """Phase 6: each decode kernel warm and with a cold L2, its device time
    (torch.profiler), its plain version, its bound from this run's inputs
    (operations at the float32 / FP64 tensor-core peak, the 3xTF32 figure
    beside it), both cluster sizes, wider beams, one-sample latency, the
    phase trace of a step and the cost of one cluster exchange and sync ->
    the decode kernels' JSON entries."""
    import torch
    from audiocaption_tpu_torch.decoding import fused_beam as FB
    from audiocaption_tpu_torch.decoding import fused_greedy as FG

    inputs = {B_KERNEL: (memkv, valid),
              1: (memkv[:, :, :1].contiguous(), valid[:1].contiguous())}

    def greedy(B=B_KERNEL, C=None):
        if C is None:
            return FG.fused_greedy_decode(packed, *inputs[B], L)
        out = torch.empty(B, L, dtype=torch.int32, device=memkv.device)
        return FG.launch_decode("fused_greedy", packed, *inputs[B], L, 1,
                                out, None, 1, 2, 0, C)

    def beam(K=3, B=B_KERNEL, C=None):
        if C is None:
            return FB.fused_beam_decode(packed, *inputs[B], L, K)
        seq = torch.empty(B, K, L, dtype=torch.int32, device=memkv.device)
        score = torch.empty(B, K, device=memkv.device)
        return FG.launch_decode("fused_beam", packed, *inputs[B], L, K, seq,
                                score, 1, 2, 0, C)

    s_valid = valid.sum(1).tolist()
    eos_pos = [(row == 2).nonzero() for row in g_kernel.cpu()]
    g_steps = [int(p[0]) + 1 if len(p) else L for p in eos_pos]
    work = {"fused_greedy": decode_flops(E, FFN, V, s_valid, g_steps, 1)}
    work["fused_beam"] = decode_flops(E, FFN, V, s_valid,
                                      beams[3]["steps"].tolist(), 3)
    nbytes = {"fused_greedy": input_bytes(packed, memkv, valid,
                                          g_kernel.numel() * 4),
              "fused_beam": input_bytes(packed, memkv, valid,
                                        beams[3]["seq"].numel() * 4
                                        + beams[3]["score"].numel() * 4)}
    fns = {"fused_greedy": (greedy, lambda: FG.fused_greedy_plain(
               packed, memkv, valid, L), greedy_err,
               "audiocaption_tpu/decoding/fused_greedy.py:209"),
           "fused_beam": (beam, lambda: FB.fused_beam_plain(
               packed, memkv, valid, L, 3), score_err,
               "audiocaption_tpu/decoding/fused_beam.py:126")}
    kernels = []
    for name, (fn, plain, err, replaces) in fns.items():
        fn()
        plan = (FG.fused_greedy_decode if name == "fused_greedy"
                else FB.fused_beam_decode).last_plan
        ms = cuda_ms(fn, 10)
        cold = cold_ms(fn, 10)
        plain_ms = cuda_ms(plain, 3, warmup=1)
        ms2 = cuda_ms(fn, 10)
        by_c = {C: cuda_ms(functools.partial(fn, C=C), 10) for C in (16, 8)}
        one = cuda_ms(functools.partial(fn, B=1), 10)
        split = device_split(fn)
        trace = FG.trace_phases(name, packed, memkv, valid, L,
                                1 if name == "fused_greedy" else 3)
        log(f"{name} phase trace (us per step, mean of {trace.shape[0]} "
            f"steps; slots in csrc/decoder_common.cuh::stamp): "
            f"{[round(v, 2) for v in trace.mean(0).tolist()]}, step "
            f"{float(trace.sum(1).mean()):.2f}")
        mm, attn = work[name]
        bound, tf32x3, by = decode_bound_ms(mm, attn, nbytes[name])
        log(f"{name}: {ms:.4f} ms/call warm (again {ms2:.4f}), {cold:.4f} "
            f"ms with the L2 cold (64 MB written before each call); by "
            f"cluster size {by_c}; B=1 {one:.4f} ms; device ms by kernel "
            f"{split}; plain {plain_ms:.3f} ms; bound {bound:.4f} ms by {by} "
            f"(3xTF32 products {tf32x3:.4f}: {nbytes[name]} bytes, {mm} product "
            f"ops, {attn} attention ops); plan {plan}; B={B_KERNEL} "
            f"S={S_KERNEL} L={L}" + (" beam 3" if name == "fused_beam" else "")
            + f" on {card}")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"audiocaption_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None})
    for C in (8, 16):
        resident = FG.max_clusters_on_card("fused_beam")(
            C, FB.fused_beam_decode.last_plan.smem)
        log(f"one cluster exchange and sync, C={C}: " + ", ".join(
            f"{16 * n4} bytes to each peer {FG.cluster_sync_ns(C, n4):.0f} ns"
            for n4 in (0, 16, 64, 256)) + f"; {resident} clusters of {C} "
            f"resident at once on {card}")
    for K in BEAMS[1:]:
        k_ms = cuda_ms(functools.partial(beam, K), 5)
        log(f"fused_beam, beam {K}: {k_ms:.4f} ms/call (plan "
            f"{FB.fused_beam_decode.last_plan}) B={B_KERNEL} on {card}")
    return kernels


def bf16_kernels(packed, memkv, valid, card):
    """Phase 12: the bf16 modes of the decode kernels against their plain
    versions in the same mode, flagship width, B=64, S=31, L=20 ->
    {name: dict(err, plain inputs ...)} for the JSON line and phase 15."""
    import dataclasses
    import torch
    from audiocaption_tpu_torch.decoding import fused_beam as FB
    from audiocaption_tpu_torch.decoding import fused_greedy as FG
    mk16 = memkv.to(torch.bfloat16)
    out = {}
    g = FG.fused_greedy_decode(packed, mk16, valid, L, cache_bf16=True)
    gp = FG.fused_greedy_plain(packed, mk16, valid, L, cache_bf16=True)
    torch.cuda.synchronize()
    mis = int((g != gp).sum())
    log(f"fused_greedy[cache_bf16] vs plain, B={B_KERNEL} S={S_KERNEL} L={L} "
        f"V={V}: {mis}/{g.numel()} tokens differ (plan "
        f"{FG.fused_greedy_decode.last_plan}) on {card}")
    assert mis <= MISMATCH_LIMIT * g.numel(), "greedy cache_bf16 disagrees"
    assert len(torch.unique(gp)) > 10, "degenerate greedy trajectories"
    out["fused_greedy[cache_bf16]"] = dict(err=float((g - gp).abs().max()),
                                           seq=g, mem=mk16, cache_bf16=True,
                                           weights_bf16=False)
    for K in BEAMS:
        seq, score = FB.fused_beam_decode(packed, mk16, valid, L, K,
                                          cache_bf16=True)
        steps = torch.zeros(B_KERNEL, dtype=torch.long, device=memkv.device)
        p_seq, p_score = FB.fused_beam_plain(packed, mk16, valid, L, K,
                                             steps=steps, cache_bf16=True)
        torch.cuda.synchronize()
        mis = int((seq != p_seq).sum())
        same = (seq == p_seq).all(-1)
        err = float((score[same] - p_score[same]).abs().max())
        log(f"fused_beam[cache_bf16] beam {K} vs plain: {mis}/{seq.numel()} "
            f"tokens differ, max |score diff| on matching sequences "
            f"{err:.3g} (plan {FB.fused_beam_decode.last_plan}) on {card}")
        assert mis <= MISMATCH_LIMIT * seq.numel(), \
            f"beam-{K} cache_bf16 disagrees"
        assert err <= SCORE_ATOL or float64_floor_check(
            packed, mk16, valid, K, seq, score, p_seq, p_score,
            cache_bf16=True), f"beam-{K} cache_bf16 scores disagree"
        if K == 3:
            out["fused_beam[cache_bf16]"] = dict(
                err=err, seq=seq, score=score, steps=steps, mem=mk16,
                cache_bf16=True, weights_bf16=False)

    # weights_bf16: every activation is rounded to bf16 at each product,
    # so a float32-level difference between two versions (here the bf16
    # mma's own float32 sums) flips a rounding now and then and the two
    # beams part ways.  Held: each kernel n-best score against the plain
    # version's float64 score of the kernel's own sequence.
    seq, score = FB.fused_beam_decode(packed, memkv, valid, L, 3,
                                      weights_bf16=True)
    steps = torch.zeros(B_KERNEL, dtype=torch.long, device=memkv.device)
    p_seq, p_score = FB.fused_beam_plain(packed, memkv, valid, L, 3,
                                         steps=steps, weights_bf16=True)
    p64 = dataclasses.replace(packed, **{
        k: getattr(packed, k).double() for k in ("emb", "cls", "pe",
                                                  "layers")})
    s64, sc64 = FB.fused_beam_plain(p64, memkv.double(), valid, L, 3,
                                    weights_bf16=True)
    rescored = FB.sequence_scores_plain(p64, memkv.double(), valid, seq,
                                        weights_bf16=True)
    torch.cuda.synchronize()
    real = score > -100               # not a -1000 beam filling a slot
    r_err = float((score[real].double() - rescored[real]).abs().max())
    mis = int((seq != p_seq).sum())
    same = (seq == p_seq).all(-1)
    err = float((score[same] - p_score[same]).abs().max())
    mis64 = int((p_seq != s64).sum())
    log(f"fused_beam[weights_bf16] beam 3 vs plain: {mis}/{seq.numel()} "
        f"tokens differ (the float32 plain version vs its float64 run: "
        f"{mis64}), max |score diff| on matching sequences {err:.3g}; "
        f"kernel scores vs the float64 plain version's scores of the "
        f"kernel's {int(real.sum())} sequences: max |diff| {r_err:.3g} "
        f"(limit {WEIGHTS_SCORE_ATOL}); best-beam mean score kernel "
        f"{float(score[:, 0].mean()):.4f}, plain "
        f"{float(p_score[:, 0].mean()):.4f}"
        f" (plan {FB.fused_beam_decode.last_plan}) on {card}")
    assert int(real.sum()) > 0 and r_err <= WEIGHTS_SCORE_ATOL, \
        "beam-3 weights_bf16 scores disagree with the model"
    out["fused_beam[weights_bf16]"] = dict(
        err=r_err, seq=seq, score=score, steps=steps, mem=memkv,
        cache_bf16=False, weights_bf16=True)
    return out


def same_weights(api, compute_dtype):
    """A second API of the same class and weights in ``compute_dtype``."""
    other = type(api)(api.config, seed=SEED, device="cuda",
                      compute_dtype=compute_dtype)
    other.model.load_state_dict(api.model.state_dict())
    return other


def bf16_effb2_path(api32, audio, lens, dev, card, rng):
    """Phase 13: ``Effb2TrmCaptioningModel(compute_dtype=bf16)`` end to end
    on 8 clips (greedy, beam 3, beam 5), the opt-in bf16-weight beam
    decoder (``FusedBeamDecoder(weights_bf16=True)`` on the float32
    model), and 16 clips through ``MicroBatchServer`` -> (api, launches
    by kernel and mode)."""
    import dataclasses
    import numpy as np
    import torch
    from audiocaption_tpu_torch.decoding import fused_beam as FB
    from audiocaption_tpu_torch.decoding import fused_greedy as FG
    from audiocaption_tpu_torch.hf_api import pad_bucket
    from audiocaption_tpu_torch.models.captioner import generate
    from audiocaption_tpu_torch.serving import MicroBatchServer, wire_decoder
    api = same_weights(api32, torch.bfloat16)
    wav = torch.from_numpy(pad_bucket(audio, SR)).to(dev)
    lens_t = torch.from_numpy(lens).to(dev)
    FG.reset_launches(FG.fused_greedy_decode)
    FG.reset_launches(FB.fused_beam_decode)
    ids = {}
    for method, K in (("greedy", 3), ("beam", 3), ("beam", 5)):
        ids[method, K] = api(audio, lens, sample_method=method, beam_size=K,
                             max_length=L)
    fb_w = FB.FusedBeamDecoder(api32.model, max_length=L, beam_size=3,
                               device="cuda", weights_bf16=True)
    assert fb_w.weights_bf16 and not fb_w.cache_bf16
    w_seq, w_score = fb_w(wav, lens_t, n_best=True)

    clips = [(rng.randn(n) * 0.1).astype(np.float32)
             for n in rng.randint(SR, 10 * SR + 1, 16)]
    serve_fn = wire_decoder(functools.partial(
        api.decode, sample_method="beam", beam_size=3, max_length=L),
        "f32", device="cuda")
    with MicroBatchServer(serve_fn, max_batch=16, max_wait_ms=5000.0,
                          max_samples=10 * SR) as srv:
        futs = [srv.submit(c) for c in clips]
        served = np.stack([f.result(timeout=300) for f in futs])
        n_batches = srv.dispatched_batches
    batch = np.zeros((16, 10 * SR), np.float32)
    for i, c in enumerate(clips):
        batch[i, :len(c)] = c
    direct = serve_fn(batch, np.asarray([len(c) for c in clips],
                                        np.int32)).cpu().numpy()
    torch.cuda.synchronize()
    launches = {f"fused_greedy[{k}]": n for k, n in
                FG.fused_greedy_decode.mode_launches.items()}
    launches.update({f"fused_beam[{k}]": n for k, n in
                     FB.fused_beam_decode.mode_launches.items()})
    log(f"bf16 EffB2-path launches: {launches}")
    for name in ("fused_greedy[cache_bf16]", "fused_beam[cache_bf16]",
                 "fused_beam[weights_bf16]"):
        assert launches.get(name, 0) > 0, f"{name} was not launched"
    assert "fused_greedy[f32]" not in launches and \
        "fused_beam[f32]" not in launches, "a bf16 path ran a float32 kernel"
    log(f"bf16 serving: 16 clips in {n_batches} dispatch(es); "
        f"{int((served != direct).sum())} tokens differ from direct decode")
    assert n_batches == 1 and np.array_equal(served, direct)

    # held: the kernel path against the plain version in the same mode on
    # the same bf16 encoder output.  Printed: the bf16 and the float32
    # torch engines, and the float32 engine against the bf16 one.  The
    # fused decoders, as the JAX package's, run the decoder's products in
    # float32 on bf16 memory K/V and caches, where the bf16 engine rounds
    # every layer: two other functions, whose captions part at near ties.
    with torch.no_grad():
        enc = api.model.encode(wav, lens_t)
        memkv, mem_valid = FG.memory_kv(api.model.decoder, enc["attn_emb"],
                                        enc["attn_emb_len"], cache_bf16=True)
        packed = FG.pack_decoder_weights(api.model.decoder)
        plain = {("greedy", 3): FG.fused_greedy_plain(
            packed, memkv, mem_valid, L, cache_bf16=True)}
        for K in (3, 5):
            plain["beam", K] = FB.fused_beam_plain(
                packed, memkv, mem_valid, L, K, cache_bf16=True)[0][:, 0]
    for (method, K), got in ids.items():
        assert got.shape == (8, L) and ((got >= 0) & (got < V)).all()
        with torch.no_grad():
            ref16, ref32 = (generate(a.model, wav, lens_t, sample_method=method,
                                     beam_size=K, max_length=L)["seq"]
                            .cpu().numpy() for a in (api, api32))
        want = plain[method, K].cpu().numpy()
        mis = int((got != want).sum())
        log(f"bf16 end to end {method} {K}: kernel path vs plain version in "
            f"the same mode {mis}/{got.size} tokens differ (limit "
            f"{MISMATCH_LIMIT}); vs the bf16 torch engine "
            f"{int((got != ref16).sum())}, vs the float32 engine "
            f"{int((got != ref32).sum())}, float32 vs bf16 engine "
            f"{int((ref32 != ref16).sum())}; first caption {got[0][:8]} "
            f"on {card}")
        assert mis <= MISMATCH_LIMIT * got.size, \
            f"bf16 {method} {K} path disagrees"

    # the bf16-weight decoder: its n-best scores against the float64 plain
    # version's scores of its own sequences (see bf16_kernels)
    with torch.no_grad():
        enc32 = api32.model.encode(wav, lens_t)
        mem32, valid32 = FG.memory_kv(api32.model.decoder,
                                      enc32["attn_emb"], enc32["attn_emb_len"])
        p64 = dataclasses.replace(fb_w.packed, **{
            k: getattr(fb_w.packed, k).double()
            for k in ("emb", "cls", "pe", "layers")})
        rescored = FB.sequence_scores_plain(p64, mem32.double(), valid32,
                                            w_seq, weights_bf16=True)
        w_plain = FB.fused_beam_plain(fb_w.packed, mem32, valid32, L, 3,
                                      weights_bf16=True)[0]
    real = w_score > -100
    r_err = float((w_score[real].double() - rescored[real]).abs().max())
    log(f"bf16-weight beam 3 decoder on the float32 model: n-best scores vs "
        f"the float64 plain version's scores of its sequences max |diff| "
        f"{r_err:.3g} (limit {WEIGHTS_SCORE_ATOL}); "
        f"{int((w_seq != w_plain).sum())}/{w_seq.numel()} tokens differ "
        f"from the plain version in the same mode on {card}")
    assert int(real.sum()) > 0 and r_err <= WEIGHTS_SCORE_ATOL, \
        "the bf16-weight decoder's scores disagree with the model"
    return api, launches


def bf16_temporal_path(api32, dev, card, rng):
    """Phase 14: ``Cnn14RnnTempAttnGruModel(compute_dtype=bf16)`` end to
    end, kernel log-mel vs the same bf16 modules fed by the plain log-mel
    -> (api, log-mel launches)."""
    import numpy as np
    import torch
    from audiocaption_tpu_torch.hf_api import pad_bucket
    from audiocaption_tpu_torch.ops import fused_logmel as FL
    api = same_weights(api32, torch.bfloat16)
    sr = SR_32K
    lens = np.asarray([10 * sr, 9 * sr, 7 * sr + 123, 5 * sr, 3 * sr + 7,
                       2 * sr, sr, sr + 4000])
    audio = (rng.randn(8, 10 * sr) * 0.1).astype(np.float32)
    for i, n in enumerate(lens):
        audio[i, n:] = 0.0
    user_tag = np.asarray([0, 1, 2, 3, 3, 2, 1, 0], np.int32)
    runs = [(m, t) for m in ("greedy", "beam") for t in (None, user_tag)]
    FL.fused_logmel.launches = 0
    out = {}
    for method, tag in runs:
        out[method, tag is None] = api(audio, lens, temporal_tag=tag,
                                       sample_method=method, beam_size=3,
                                       max_length=L)
    launches = FL.fused_logmel.launches
    log(f"bf16 temporal-path launches: fused_logmel {launches}")
    assert launches > 0, "the log-mel kernel was not launched"

    wav = torch.from_numpy(pad_bucket(audio, sr)).to(dev)
    front = api.model.cap_model.frontend
    lms_kernel = api.log_mel(wav)
    lms_plain = FL.fused_logmel_plain(wav, front.basis, front.mel_fb, api.mel)
    with torch.no_grad():
        fw_k = api.model.sed_model(lms_kernel)["framewise_output"]
        fw_p = api.model.sed_model(lms_plain)["framewise_output"]
        fw_32 = api32.model.sed_model(lms_kernel)["framewise_output"]
    sed_err = float((fw_k - fw_p).abs().max())
    sed_floor = float((fw_k - fw_32).abs().max())
    log(f"bf16 temporal path: SED framewise, kernel vs plain log-mel max "
        f"|diff| {sed_err:.3g} (limit {SED_ATOL}, or the float32-vs-bf16 "
        f"gap {sed_floor:.3g}) on {card}")
    assert sed_err <= max(SED_ATOL, sed_floor), "bf16 SED output disagrees"
    for (method, no_tag), ids in out.items():
        tag = None if no_tag else user_tag
        assert ids.shape == (8, L) and ((ids >= 0) & (ids < V)).all()
        ref = api.decode_lms(lms_plain, lens, tag, sample_method=method,
                             beam_size=3, max_length=L).cpu().numpy()
        ref32 = api32.decode_lms(lms_kernel, lens, tag, sample_method=method,
                                 beam_size=3, max_length=L).cpu().numpy()
        mis, floor = int((ids != ref).sum()), int((ids != ref32).sum())
        log(f"bf16 temporal end to end {method}, "
            f"{'SED tag' if no_tag else 'user tag'}: kernel vs plain log-mel "
            f"{mis}/{ids.size} tokens differ; float32 vs bf16 {floor}/"
            f"{ids.size}; first caption {ids[0][:8]} on {card}")
        assert mis <= max(MISMATCH_LIMIT * ids.size, floor), \
            f"bf16 temporal {method} path disagrees"
    return api, launches


def e2e_clips_per_s(decode, wav, lens, method, reps):
    """Clips/s of ``decode`` on a batch, greedy or beam 3, after a warm-up."""
    import torch
    fn = functools.partial(decode, wav, lens, sample_method=method,
                           beam_size=3, max_length=L)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    return wav.shape[0] / dt, dt * 1e3


def bf16_times(packed, memkv, valid, checks, f32_kernels, api16, api32,
               t_api16, t_api32, wav64, len64, launches, card):
    """Phase 15: each bf16 mode's kernel (warm, cold L2, B=1) beside the
    float32 kernel and its bound; bf16 clips/s of both models at B=64 x
    10 s beside float32; the bf16 EffB2 encode beside float32 -> JSON
    entries of the bf16 modes."""
    import torch
    from audiocaption_tpu_torch.decoding import fused_beam as FB
    from audiocaption_tpu_torch.decoding import fused_greedy as FG
    f32_ms = {k["name"]: k["ms"] for k in f32_kernels}
    kernels = []
    for name, c in checks.items():
        base = name.split("[")[0]
        cache_bf16, weights_bf16 = c["cache_bf16"], c["weights_bf16"]
        mem = c["mem"]
        one = (mem[:, :, :1].contiguous(), valid[:1].contiguous())
        if base == "fused_greedy":
            def fn(m=mem, v=valid):
                return FG.fused_greedy_decode(packed, m, v, L,
                                              cache_bf16=cache_bf16)

            def plain():
                return FG.fused_greedy_plain(packed, mem, valid, L,
                                             cache_bf16=cache_bf16)
            seq = c["seq"]
            eos_pos = [(row == 2).nonzero() for row in seq.cpu()]
            steps = [int(p[0]) + 1 if len(p) else L for p in eos_pos]
            K, out_bytes = 1, seq.numel() * 4
        else:
            def fn(m=mem, v=valid):
                return FB.fused_beam_decode(packed, m, v, L, 3,
                                            cache_bf16=cache_bf16,
                                            weights_bf16=weights_bf16)

            def plain():
                return FB.fused_beam_plain(packed, mem, valid, L, 3,
                                           cache_bf16=cache_bf16,
                                           weights_bf16=weights_bf16)
            steps = c["steps"].tolist()
            K = 3
            out_bytes = c["seq"].numel() * 4 + c["score"].numel() * 4
        ms = cuda_ms(fn, 10)
        cold = cold_ms(fn, 10)
        b1 = cuda_ms(functools.partial(fn, *one), 10)
        plain_ms = cuda_ms(plain, 2, warmup=1)
        mm, attn = decode_flops(E, FFN, V, valid.sum(1).tolist(), steps, K)
        nbytes = input_bytes(packed, mem, valid, out_bytes, weights_bf16)
        bound, _, by = decode_bound_ms(
            mm, attn, nbytes, BF16_FLOPS if weights_bf16 else FP32_FLOPS)
        log(f"{name}: {ms:.4f} ms/call warm ({base} float32 "
            f"{f32_ms[base]:.4f}), {cold:.4f} ms with the L2 cold, B=1 "
            f"{b1:.4f} ms; plain {plain_ms:.3f} ms; bound {bound:.4f} ms by "
            f"{by} ({nbytes} bytes, {mm} product ops at "
            f"{'the bf16' if weights_bf16 else 'the FP64 / float32'} rate, "
            f"{attn} attention ops); B={B_KERNEL} S={S_KERNEL} L={L} on "
            f"{card}")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"audiocaption_tpu_torch/csrc/{base}.cu",
            "replaces": ("audiocaption_tpu/decoding/fused_greedy.py:209"
                         if base == "fused_greedy" else
                         "audiocaption_tpu/decoding/fused_beam.py:126"),
            "launches": launches.get(name, 0),
            "max_abs_err": c["err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None})

    with torch.no_grad():
        enc32 = cuda_ms(lambda: api32.model.encode(wav64, len64), 5)
        enc16 = cuda_ms(lambda: api16.model.encode(wav64, len64), 5)
    log(f"encode (log-mel + EffB2), B=64 x 10 s: bf16 {enc16:.2f} ms, "
        f"float32 {enc32:.2f} ms on {card}")
    for label, api in (("bf16", api16), ("float32", api32)):
        with torch.no_grad():
            split = device_split(lambda: api.model.encode(wav64, len64), 3)
        log(f"encode device ms by kernel, {label}: total "
            f"{sum(split.values()):.2f}; {dict(list(split.items())[:10])}")
    for method in ("greedy", "beam"):
        for label, api in (("bf16", api16), ("float32", api32)):
            cps, ms = e2e_clips_per_s(api.decode, wav64, len64, method, 5)
            log(f"EffB2 end to end {method}, {label}: {cps:.1f} clips/s "
                f"({ms:.2f} ms per batch of 64 x 10 s) on {card}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    wav = torch.randn(64, 10 * SR_32K, generator=gen, device="cuda") * 0.1
    lens = torch.full((64,), 10 * SR_32K, dtype=torch.long, device="cuda")

    def temporal(api):
        def decode(w, n, **kw):
            return api.decode_lms(api.log_mel(w), n, **kw)
        return decode
    for method in ("greedy", "beam"):
        for label, api in (("bf16", t_api16), ("float32", t_api32)):
            cps, ms = e2e_clips_per_s(temporal(api), wav, lens, method, 2)
            log(f"temporal end to end {method}, {label}: {cps:.1f} clips/s "
                f"({ms:.1f} ms per batch of 64 x 10 s) on {card}")
    return kernels


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "audiocaption_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (the "
              "audiocaption_tpu_torch package is not beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from audiocaption_tpu_torch import cuda_build
    from audiocaption_tpu_torch.decoding import fused_beam as FB
    from audiocaption_tpu_torch.decoding import fused_greedy as FG
    from audiocaption_tpu_torch.device import set_parity_precision
    from audiocaption_tpu_torch.hf_api import (
        Effb2TrmCaptioningModel, Effb2TrmConfig, pad_bucket)
    from audiocaption_tpu_torch.models.captioner import generate
    from audiocaption_tpu_torch.serving import MicroBatchServer, wire_decoder

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    set_parity_precision()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device_count {torch.cuda.device_count()}")

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    # registers, shared memory and spills (-Xptxas -v) of every kernel
    cuda_build.build_all(verbose=True)
    log(f"build: {time.perf_counter() - t0:.2f} s for {list(cuda_build.KERNELS)}")

    # -- 3. kernels vs plain versions --------------------------------------
    packed, memkv, valid = jittered_decoder_inputs(dev)
    g_kernel = FG.fused_greedy_decode(packed, memkv, valid, L)
    g_plain = FG.fused_greedy_plain(packed, memkv, valid, L)
    torch.cuda.synchronize()
    g_mis = int((g_kernel != g_plain).sum())
    greedy_err = float((g_kernel - g_plain).abs().max())
    log(f"kernel vs plain, B={B_KERNEL} S={S_KERNEL} L={L} V={V}: greedy "
        f"{g_mis}/{g_kernel.numel()} tokens differ (plan "
        f"{FG.fused_greedy_decode.last_plan})")
    assert g_mis <= MISMATCH_LIMIT * g_kernel.numel(), "greedy kernel disagrees"
    assert len(torch.unique(g_plain)) > 10, "degenerate greedy trajectories"
    beams = {}
    for K in BEAMS:
        b_seq, b_score = FB.fused_beam_decode(packed, memkv, valid, L, K)
        plan = FB.fused_beam_decode.last_plan
        steps = torch.zeros(B_KERNEL, dtype=torch.long, device=dev)
        p_seq, p_score = FB.fused_beam_plain(packed, memkv, valid, L, K,
                                             steps=steps)
        torch.cuda.synchronize()
        b_mis = int((b_seq != p_seq).sum())
        same = (b_seq == p_seq).all(-1)
        err = float((b_score[same] - p_score[same]).abs().max()) \
            if bool(same.any()) else float("inf")
        beams[K] = dict(seq=b_seq, score=b_score, steps=steps, err=err)
        log(f"kernel vs plain, beam {K}: {b_mis}/{b_seq.numel()} tokens "
            f"differ, max |score diff| on matching sequences {err:.3g} "
            f"(plan {plan})")
        assert b_mis <= MISMATCH_LIMIT * b_seq.numel(), \
            f"beam-{K} kernel disagrees"
        if K == 3:
            assert err <= SCORE_ATOL, f"beam-{K} kernel scores disagree"
        else:
            assert float64_floor_check(packed, memkv, valid, K, b_seq, b_score,
                                       p_seq, p_score), \
                f"beam-{K} kernel scores disagree"
    score_err = max(b["err"] for b in beams.values())

    # -- 4. serving path end to end --------------------------------------
    api = Effb2TrmCaptioningModel(Effb2TrmConfig(vocab_size=V), seed=SEED,
                                  device="cuda")
    jitter_model(api, torch.Generator().manual_seed(SEED + 1))
    rng = np.random.RandomState(SEED)
    audio = (rng.randn(8, 10 * SR) * 0.1).astype(np.float32)
    lens = np.asarray([10 * SR, 9 * SR, 7 * SR + 123, 5 * SR, 3 * SR + 7,
                       2 * SR, 16000, 4000])
    FG.reset_launches(FG.fused_greedy_decode)
    FG.reset_launches(FB.fused_beam_decode)
    e2e = {}
    for method in ("greedy", "beam"):
        ids = api(audio, lens, sample_method=method, beam_size=3,
                  max_length=L)
        assert ids.shape == (8, L) and ((ids >= 0) & (ids < V)).all()
        wav = torch.from_numpy(pad_bucket(audio, SR)).to(dev)
        ref = generate(api.model, wav, torch.from_numpy(lens).to(dev),
                       sample_method=method, beam_size=3,
                       max_length=L)["seq"].cpu().numpy()
        mis = int((ids != ref).sum())
        e2e[method] = mis
        log(f"end to end {method}: kernel path vs torch engine on the card: "
            f"{mis}/{ids.size} tokens differ; first caption {ids[0][:8]}")
        assert mis <= MISMATCH_LIMIT * ids.size, f"{method} path disagrees"
    ids = api(audio, lens, sample_method="beam", beam_size=5, max_length=L)
    ref = generate(api.model, wav, torch.from_numpy(lens).to(dev),
                   sample_method="beam", beam_size=5,
                   max_length=L)["seq"].cpu().numpy()
    mis = int((ids != ref).sum())
    log(f"end to end beam 5: kernel path vs torch engine on the card: "
        f"{mis}/{ids.size} tokens differ; first caption {ids[0][:8]}")
    assert ids.shape == (8, L) and mis <= MISMATCH_LIMIT * ids.size, \
        "beam-5 path disagrees"

    # -- 5. micro-batching server ----------------------------------------
    clips = [(rng.randn(n) * 0.1).astype(np.float32)
             for n in rng.randint(SR, 10 * SR + 1, 16)]
    serve_fn = wire_decoder(functools.partial(
        api.decode, sample_method="beam", beam_size=3, max_length=L),
        "f32", device="cuda")
    with MicroBatchServer(serve_fn, max_batch=16, max_wait_ms=5000.0,
                          max_samples=10 * SR) as srv:
        futs = [srv.submit(c) for c in clips]
        served = np.stack([f.result(timeout=300) for f in futs])
        n_batches = srv.dispatched_batches
    batch = np.zeros((16, 10 * SR), np.float32)
    for i, c in enumerate(clips):
        batch[i, :len(c)] = c
    direct = serve_fn(batch, np.asarray([len(c) for c in clips],
                                        np.int32)).cpu().numpy()
    log(f"serving: 16 clips in {n_batches} dispatch(es); "
        f"{int((served != direct).sum())} tokens differ from direct decode")
    assert n_batches == 1 and np.array_equal(served, direct)
    launches = {"fused_greedy": FG.fused_greedy_decode.launches,
                "fused_beam": FB.fused_beam_decode.launches}
    log(f"serving-path launches: {launches}")
    assert all(n > 0 for n in launches.values()), "a kernel was not launched"

    # -- 6. times ------------------------------------------------------------
    kernels = decode_times(packed, memkv, valid, g_kernel, beams, launches,
                           greedy_err, score_err, card)

    wav64 = torch.from_numpy((rng.randn(64, 10 * SR) * 0.1).astype(
        np.float32)).to(dev)
    len64 = torch.full((64,), 10 * SR, dtype=torch.long, device=dev)
    with torch.no_grad():
        enc_ms = cuda_ms(lambda: api.model.encode(wav64, len64), 5)
    log(f"encode (log-mel + EffB2, float32): {enc_ms:.2f} ms per batch of "
        f"64 x 10 s on {card}")
    for method in ("greedy", "beam"):
        fn = functools.partial(api.decode, wav64, len64, sample_method=method,
                               beam_size=3, max_length=L)
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / reps
        log(f"end to end {method}: {64 / dt:.1f} clips/s ({dt * 1e3:.2f} "
            f"ms per batch of 64 x 10 s) on {card}")
        one = cuda_ms(functools.partial(api.decode, wav64[:1], len64[:1],
                                        sample_method=method, beam_size=3,
                                        max_length=L), 5)
        log(f"end to end {method}, one 10 s clip: {one:.2f} ms on {card}")

    # -- 7. log-mel kernel vs its plain version ---------------------------
    logmel_errs = logmel_check(dev, card)

    # -- 8. temporal path end to end ---------------------------------------
    temporal_api, t_launches = temporal_path(dev, card, rng)

    # -- 9. times on the temporal path -------------------------------------
    timing = temporal_times(temporal_api, dev, card)
    kernels.append({
        "name": "fused_logmel", "route": "cuda",
        "source": "audiocaption_tpu_torch/csrc/fused_logmel.cu",
        "replaces": "audiocaption_tpu/ops/pallas_logmel.py:44",
        "launches": t_launches["fused_logmel"],
        "max_abs_err": logmel_errs["CNN14_MEL_32K"], **timing})

    # -- 10. the folded EffB2 encoders through the MBConv kernel -----------
    m_launches, m_err, m_inputs, lms64, feat64 = folded_path(
        api, wav64, len64, audio, lens, dev, card)

    # -- 11. MBConv times --------------------------------------------------
    m_timing = mbconv_times(api, m_inputs, lms64, feat64, card)
    kernels.append({
        "name": "fused_mbconv", "route": "cuda",
        "source": "audiocaption_tpu_torch/csrc/fused_mbconv.cu",
        "replaces": "audiocaption_tpu/ops/pallas_mbconv.py:102",
        "launches": m_launches, "max_abs_err": m_err, **m_timing})

    # -- 12. the decode kernels' bf16 modes vs their plain versions -------
    checks = bf16_kernels(packed, memkv, valid, card)

    # -- 13. the bf16 EffB2 serving path end to end ------------------------
    api16, b_launches = bf16_effb2_path(api, audio, lens, dev, card, rng)

    # -- 14. the bf16 temporal path end to end -----------------------------
    t_api16, _ = bf16_temporal_path(temporal_api, dev, card, rng)

    # -- 15. bf16 times ----------------------------------------------------
    kernels += bf16_times(packed, memkv, valid, checks, kernels, api16, api,
                          t_api16, temporal_api, wav64, len64, b_launches,
                          card)

    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
