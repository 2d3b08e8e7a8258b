#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``audiocaption_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases, each of which must pass (none is caught and skipped):

  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the serving path from ``csrc/`` with nvcc
     (one process per source, all started together);
  3. hold each kernel against its plain PyTorch version on the card, at
     the flagship decoder width (E=256, 4 heads, 2 layers, V=4981),
     L=20, S=31, B=64, on random jittered decoder weights and random
     well-spread memory K/V.  Limits: at most 1% of tokens differ; n-best
     beam scores of matching sequences within 1e-4;
  4. drive the serving path end to end through ``Effb2TrmCaptioningModel``
     at flagship width (random weights from a seed, decoder jittered, BN
     statistics jittered so the encoder output does not collapse): 8
     clips of 10 s with mixed lengths, greedy and beam 3, and compare with
     the torch-engine path on the same card (at most 1% of tokens differ);
  5. serve 16 clips through ``MicroBatchServer``; the answers must equal a
     direct decode of the same batch;
  6. time each kernel and its plain version (CUDA events, after warm-up,
     B=64, S=31), compute each kernel's bound from its inputs, and time
     end-to-end clips/s for greedy and beam 3 at B=64 on 10 s clips.

Every kernel's launch counter is set to 0 just before phases 4-5 (the
serving path) and read just after; the run fails if a kernel of the path
was not launched there.  The second-to-last line is the kernels JSON
object, the last line ``{"ok": true, "device": {...}}``.

The script imports nothing of JAX.  It exits non-zero, printing no
result, where CUDA is unavailable or the package is not beside it.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
E, NHEAD, FFN, V, NLAYERS = 256, 4, 1024, 4981, 2
B_KERNEL, S_KERNEL, L = 64, 31, 20
SR = 16000
MISMATCH_LIMIT = 0.01
SCORE_ATOL = 1e-4
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 non-tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


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
    """Float ops one decode needs: per executed step and row, the layer
    matvecs, self attention over t+1 keys, cross attention over the valid
    memory, and the vocabulary projection (2 ops per multiply-add)."""
    per_step_weights = NLAYERS * 2 * (6 * E_ * E_ + 2 * E_ * F_) + 2 * V_ * E_
    total = 0
    for s_valid, steps in zip(S_valid, steps_per_row):
        keys = s_valid if s_valid > 0 else S_KERNEL
        for t in range(steps):
            attn = NLAYERS * 2 * 2 * E_ * ((t + 1) + keys)
            total += rows_per_sample * (per_step_weights + attn)
    return total


def input_bytes(packed, memkv, valid, out_bytes):
    """Each input read once (the tied classifier is the embedding),
    each output written once."""
    n = packed.emb.numel() * 4 + packed.layers.numel() * 4
    if packed.cls.data_ptr() != packed.emb.data_ptr():
        n += packed.cls.numel() * 4
    n += L * packed.pe.shape[1] * 4 + memkv.numel() * 4 + valid.numel()
    return n + out_bytes


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
    cuda_build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for {list(cuda_build.KERNELS)}")

    # -- 3. kernels vs plain versions --------------------------------------
    packed, memkv, valid = jittered_decoder_inputs(dev)
    g_kernel = FG.fused_greedy_decode(packed, memkv, valid, L)
    g_plain = FG.fused_greedy_plain(packed, memkv, valid, L)
    b_seq, b_score = FB.fused_beam_decode(packed, memkv, valid, L, 3)
    beam_steps = torch.zeros(B_KERNEL, dtype=torch.long, device=dev)
    p_seq, p_score = FB.fused_beam_plain(packed, memkv, valid, L, 3,
                                         steps=beam_steps)
    torch.cuda.synchronize()
    g_mis = int((g_kernel != g_plain).sum())
    b_mis = int((b_seq != p_seq).sum())
    same = (b_seq == p_seq).all(-1)
    score_err = float((b_score[same] - p_score[same]).abs().max()) \
        if bool(same.any()) else float("inf")
    greedy_err = float((g_kernel - g_plain).abs().max())
    log(f"kernel vs plain, B={B_KERNEL} S={S_KERNEL} L={L} V={V}: greedy "
        f"{g_mis}/{g_kernel.numel()} tokens differ; beam-3 {b_mis}/"
        f"{b_seq.numel()} tokens differ, max |score diff| on matching "
        f"sequences {score_err:.3g}")
    assert g_mis <= MISMATCH_LIMIT * g_kernel.numel(), "greedy kernel disagrees"
    assert b_mis <= MISMATCH_LIMIT * b_seq.numel(), "beam kernel disagrees"
    assert score_err <= SCORE_ATOL, "beam kernel scores disagree"
    assert len(torch.unique(g_plain)) > 10, "degenerate greedy trajectories"

    # -- 4. serving path end to end --------------------------------------
    api = Effb2TrmCaptioningModel(Effb2TrmConfig(vocab_size=V), seed=SEED,
                                  device="cuda")
    jitter_model(api, torch.Generator().manual_seed(SEED + 1))
    rng = np.random.RandomState(SEED)
    audio = (rng.randn(8, 10 * SR) * 0.1).astype(np.float32)
    lens = np.asarray([10 * SR, 9 * SR, 7 * SR + 123, 5 * SR, 3 * SR + 7,
                       2 * SR, 16000, 4000])
    FG.fused_greedy_decode.launches = 0
    FB.fused_beam_decode.launches = 0
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
    g_ms = cuda_ms(lambda: FG.fused_greedy_decode(packed, memkv, valid, L), 10)
    g_plain_ms = cuda_ms(lambda: FG.fused_greedy_plain(packed, memkv, valid,
                                                       L), 3, warmup=1)
    b_ms = cuda_ms(lambda: FB.fused_beam_decode(packed, memkv, valid, L, 3),
                   10)
    b_plain_ms = cuda_ms(lambda: FB.fused_beam_plain(packed, memkv, valid, L,
                                                     3), 3, warmup=1)
    s_valid = valid.sum(1).tolist()
    eos_pos = [(row == 2).nonzero() for row in g_kernel.cpu()]
    g_steps = [int(p[0]) + 1 if len(p) else L for p in eos_pos]
    g_flops = decode_flops(E, FFN, V, s_valid, g_steps, 1)
    b_flops = decode_flops(E, FFN, V, s_valid, beam_steps.tolist(), 3)
    g_bytes = input_bytes(packed, memkv, valid, g_kernel.numel() * 4)
    b_bytes = input_bytes(packed, memkv, valid,
                          b_seq.numel() * 4 + b_score.numel() * 4)
    kernels = []
    for name, ms, plain_ms, flops, nbytes, err, replaces in (
            ("fused_greedy", g_ms, g_plain_ms, g_flops, g_bytes, greedy_err,
             "audiocaption_tpu/decoding/fused_greedy.py:209"),
            ("fused_beam", b_ms, b_plain_ms, b_flops, b_bytes, score_err,
             "audiocaption_tpu/decoding/fused_beam.py:126")):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS * 1e3
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"audiocaption_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})
        log(f"{name}: {ms:.4f} ms/call (plain {plain_ms:.3f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms: {nbytes} bytes, {flops} fp32 ops) "
            f"B={B_KERNEL} S={S_KERNEL} L={L} on {card}")

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

    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
