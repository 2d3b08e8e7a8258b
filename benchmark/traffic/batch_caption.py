"""Batch captioning, closed loop: batches of a seeded pool of distinct
clips, held in pinned host memory, go to the cell's entry with
``in_flight`` batches outstanding; each batch's token ids are copied
back to the host.

Parameters (``benchmark/workloads/<cell>.json``, ``params``):
  batch, pool_batches, lengths (``seeded.clip_lengths``), in_flight,
  entry ("hf_api": ``Effb2TrmCaptioningModel.decode``; "loader":
  ``LoaderDecoder``, the recipe's evaluation decode), check_batches
  (completed batches compared with the reference), trace_seconds.

Each batch is padded as ``hf_api.pad_bucket`` pads: to its longest
clip, rounded up to whole seconds.  ``clips_per_s`` is every clip whose
ids reached the host over the time from the first call to the last
completion."""

from __future__ import annotations

import collections
import time
from typing import Dict, List

import numpy as np
import torch

from harness import capture, judge, models, seeded, trace
from roofline import flops, work
from reference.common import mel_filterbank


def make_pool(ctx) -> List[Dict]:
    cfg, p = ctx.config, ctx.params
    sr, B, P = cfg["sample_rate"], p["batch"], p["pool_batches"]
    lengths = seeded.clip_lengths(P * B, p["lengths"], sr, ctx.seed)
    gen = seeded.device_gen(ctx.seed, "audio", ctx.device)
    pool = []
    for i in range(P):
        lens = lengths[i * B:(i + 1) * B]
        width = seeded.bucket_samples(int(lens.max()), sr)
        wav = seeded.audio(lens, width, sr, gen).cpu()
        pool.append({"wav": wav.pin_memory() if ctx.cuda else wav,
                     "lens": torch.as_tensor(lens).to(ctx.device),
                     "lens_host": lens, "width": width})
    return pool


def build(ctx, weights):
    """-> (entry fn(wav, lens) -> ids on the device, the captioner)."""
    cfg, K, L = ctx.config, ctx.config["beam_size"], ctx.config["max_length"]
    if ctx.params["entry"] == "hf_api":
        api = models.hf_api_model(cfg, weights, ctx.device)
        return (lambda wav, lens: api.decode(wav, lens, "beam", K, L)), \
            api.model
    from audiocaption_tpu_torch.decoding.select import LoaderDecoder
    model = models.program_model(cfg, weights, ctx.device)
    dec = LoaderDecoder(model, ctx.device)
    return (lambda wav, lens: dec(wav, lens, sample_method="beam",
                                  beam_size=K)), model


def run(ctx) -> Dict:
    with capture.best_scores([]) as scores:
        return _run(ctx, scores)


def _run(ctx, scores: List[torch.Tensor]) -> Dict:
    cfg, p = ctx.config, ctx.params
    ctx.log("imports done")
    weights = models.seeded_weights(cfg, ctx.seed, ctx.device)
    ctx.log("weights made")
    pool = make_pool(ctx)
    ctx.log("pool made")
    entry, model = build(ctx, weights)
    weights = {k: v.cpu() for k, v in weights.items()}
    ctx.log("program built")
    ctx.spans.hook(model.frontend, "frontend")
    ctx.spans.hook(model.encoder, "encoder")

    def call(i):
        b = pool[i % len(pool)]
        wav = b["wav"].to(ctx.device, non_blocking=True)
        t = time.perf_counter()
        with ctx.spans.span("entry"):
            seq = entry(wav, b["lens"])
        host_s = time.perf_counter() - t
        score = scores[-1] if scores else None
        scores.clear()
        out = torch.empty(seq.shape, dtype=seq.dtype,
                          pin_memory=ctx.cuda)
        out.copy_(seq, non_blocking=True)
        done = ctx.event()
        return {"i": i, "pool": i % len(pool), "out": out, "done": done,
                "host_s": host_s, "score": score}

    # warm-up: every padded width the pool holds, twice
    for _ in range(2):
        seen = set()
        for i, b in enumerate(pool):
            if b["width"] not in seen:
                seen.add(b["width"])
                call(i)["done"].synchronize()

    ctx.log(f"set-up done: {len(pool)} pool batches")
    ctx.sync()
    completed, inflight, host_s, traced = [], collections.deque(), [], []
    holder: Dict = {}
    profiling = None
    t_start = ctx.window_start()
    if ctx.trace:
        profiling = trace.profile(ctx.spans, holder)
        profiling.__enter__()
    t_prof_end = None
    i = 0
    while True:
        now = time.perf_counter()
        if profiling is not None and now - t_start >= p["trace_seconds"]:
            profiling.__exit__(None, None, None)
            profiling, t_prof_end = None, time.perf_counter()
        if now - t_start >= ctx.seconds:
            break
        rec = call(i)
        host_s.append(rec["host_s"])
        if profiling is not None:
            traced.append(rec["pool"])
        inflight.append(rec)
        i += 1
        if len(inflight) >= p["in_flight"]:
            done = inflight.popleft()
            done["done"].synchronize()
            done["t"] = time.perf_counter()
            completed.append(done)
    if profiling is not None:
        profiling.__exit__(None, None, None)
        t_prof_end = time.perf_counter()
    while inflight:
        done = inflight.popleft()
        done["done"].synchronize()
        done["t"] = time.perf_counter()
        completed.append(done)
    t_end = completed[-1]["t"]
    B = p["batch"]
    clips = B * len(completed)
    peak = ctx.memory_peak()
    ctx.log(f"window: {len(completed)} batches in {t_end - t_start:.3f} s, "
            f"peak {peak}")
    del entry, model
    ctx.free()

    # the reference, over a seeded sample of completed batches (the
    # longest padded width among them) and, traced, every pool batch
    ref = models.reference_model(cfg, weights, ctx.device)
    rng = seeded.host_rng(ctx.seed, "sample")
    pick = list(rng.choice(len(completed), min(p["check_batches"],
                                               len(completed)),
                           replace=False))
    widest = max(range(len(completed)),
                 key=lambda j: pool[completed[j]["pool"]]["width"])
    if widest not in pick:
        pick[-1] = widest
    found, steps = [], {}
    for j in pick:
        rec = completed[j]
        b = pool[rec["pool"]]
        found.append(judge.compare_captions(
            ref, b["wav"].to(ctx.device), b["lens"], rec["out"], rec["score"],
            cfg["beam_size"], cfg["max_length"]))
        steps[rec["pool"]] = found[-1]["steps"].cpu().numpy()
    checks = judge.caption_checks(found, cfg)
    for k in sorted(set(traced) - set(steps)):
        steps[k] = judge.search_steps(ref, pool[k]["wav"].to(ctx.device),
                                      pool[k]["lens"], cfg["beam_size"],
                                      cfg["max_length"]).cpu().numpy()

    info = {"host_entry_s": host_s, "traced": traced,
            "peak_flops": cfg["peak_flops"], "dtype": cfg["compute_dtype"]}
    if ctx.trace:
        info.update(work_of(ctx, pool, traced, steps))
        after = [r for r in completed if t_prof_end and r["t"] > t_prof_end]
        if len(after) >= 2:
            span = after[-1]["t"] - t_prof_end
            mean_steps = float(np.mean(np.concatenate(list(steps.values()))))
            info["model_flops_per_s"] = sum(
                pool[r["pool"]]["lens"].shape[0] * flops.caption_flops(
                    cfg, pool[r["pool"]]["width"], mean_steps)
                for r in after) / span
    return {"e2e": {"clips_per_s": clips / (t_end - t_start),
                    "setup_s": t_start - ctx.t0},
            "attempted": B * i, "failed": B * i - clips, "checks": checks,
            "info": info, "trace": holder.get("trace"),
            "memory_peak_bytes": peak}


def work_of(ctx, pool, traced, steps) -> Dict:
    """(ops, bytes) of each traced call's frontend and decode."""
    cfg = ctx.config
    mel = models.reference_module(cfg).MEL
    fb = mel_filterbank(mel)
    dims = flops.dims(cfg)
    front, dec = [], []
    for k in traced:
        b = pool[k]
        B = b["lens"].shape[0]
        front.append(work.logmel_work(mel.n_fft, mel.hop, mel.n_mels, fb, B,
                                      b["width"]))
        S = mel.frames(b["width"]) // 32
        valid = [mel.frames(int(n)) // 32 for n in b["lens_host"]]
        dec.append(work.decode_work(dims, B, S, valid, steps[k]))
    return {"frontend_work": front, "decode_work": dec}


def control(ctx) -> List:
    """The control's numbers: the reference's beam search in TF32 in the
    program's place, on the first ``check_batches`` pool batches."""
    cfg, p = ctx.config, ctx.params
    weights = models.seeded_weights(cfg, ctx.seed, ctx.device)
    pool = make_pool(ctx)
    ref = models.reference_model(cfg, weights, ctx.device)
    found = []
    for b in pool[:p["check_batches"]]:
        wav = b["wav"].to(ctx.device)
        seq, score = judge.control_captions(ref, wav, b["lens"],
                                            cfg["beam_size"],
                                            cfg["max_length"])
        found.append(judge.compare_captions(ref, wav, b["lens"], seq, score,
                                            cfg["beam_size"],
                                            cfg["max_length"]))
    return judge.caption_checks(found, cfg)
