"""Online serving, open loop: single clips arrive at the exponential gaps
of a Poisson process at a fixed rate and are submitted, as 16-bit PCM,
to ``serving.MicroBatchServer(wire_decoder(model.decode, "i16"))``.

Parameters (``benchmark/workloads/<cell>.json``, ``params``):
  rate (requests a second), pool_clips, lengths (``seeded.clip_lengths``),
  server (``MicroBatchServer``'s arguments), check_requests, grace_s,
  trace_seconds.

Every seed offers the same gaps (fixed quantiles of the exponential
distribution) in its own order.  A request's latency runs from when it
was due to when its token row reached its future; one that fails or has
not come ``grace_s`` after the window closes counts as missing, with the
time it was waited for.  ``serve_p95_ms`` is the 95th percentile over
every request due in the window."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from harness import capture, judge, models, seeded, trace


def setup(ctx, captured: List) -> Dict:
    """The model, its server, the clip pool; every batch bucket warmed.
    ``captured`` is where ``capture.best_scores`` puts each search's
    scores."""
    from audiocaption_tpu_torch.serving import MicroBatchServer, wire_decoder
    cfg, p = ctx.config, ctx.params
    sv = p["server"]
    ctx.log("imports done")
    weights = models.seeded_weights(cfg, ctx.seed, ctx.device)
    api = models.hf_api_model(cfg, weights, ctx.device)
    ctx.log("program built")
    weights = {k: v.cpu() for k, v in weights.items()}
    width = sv["max_samples"]
    clips, lengths = make_clips(ctx)
    K, L = cfg["beam_size"], cfg["max_length"]
    decode = wire_decoder(lambda w, n: api.decode(w, n, "beam", K, L),
                          sv["wire"], ctx.device)
    calls: List = []

    def recorded(wav, lens):
        """The decode, its search's scores kept with the count of real
        rows (padding rows have length 1); the collector dispatches the
        queue's requests in order, so call k serves the next rows."""
        out = decode(wav, lens)
        calls.append((int((np.asarray(lens) > 1).sum()),
                      captured[-1] if captured else None))
        captured.clear()
        return out
    server = MicroBatchServer(recorded, max_batch=sv["max_batch"],
                              max_wait_ms=sv["max_wait_ms"],
                              max_samples=width, wire=sv["wire"],
                              max_inflight=sv["max_inflight"])
    for _ in range(2):
        for b in server.buckets:
            decode(np.zeros((b, width), np.int16),
                   np.full(b, width, np.int32)).cpu()
    calls.clear()
    return {"api": api, "server": server, "clips": clips, "weights": weights,
            "lengths": lengths, "calls": calls, "captured": captured}


def make_clips(ctx):
    """-> (the pool's 16-bit PCM clips, each of its own length; lengths)."""
    cfg, p = ctx.config, ctx.params
    sr, P, width = cfg["sample_rate"], p["pool_clips"], \
        p["server"]["max_samples"]
    lengths = seeded.clip_lengths(P, p["lengths"], sr, ctx.seed)
    gen = seeded.device_gen(ctx.seed, "audio", ctx.device)
    pcm = torch.cat([seeded.to_int16(seeded.audio(
        lengths[a:a + 64], width, sr, gen)).cpu() for a in range(0, P, 64)])
    return [pcm[i, :lengths[i]].numpy() for i in range(P)], lengths


def padded(clips, rows, width: int):
    """Clips as the server pads them: zeros to ``width``, float32."""
    wav = np.zeros((len(rows), width), np.float32)
    lens = np.zeros(len(rows), np.int64)
    for j, c in enumerate(clips[r] for r in rows):
        wav[j, :len(c)] = c.astype(np.float32) / 32768.0
        lens[j] = len(c)
    return torch.from_numpy(wav), torch.from_numpy(lens)


def offered(rate: float, seconds: float, seed: int, pool: int):
    """(due times from the window's start [n], clip index [n])."""
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    gaps = gaps[seeded.host_rng(seed, "arrivals").permutation(n)]
    due = np.cumsum(gaps) - gaps[0]
    clip = seeded.host_rng(seed, "order").integers(0, pool, n)
    return due, clip


def window(state: Dict, rate: float, seconds: float, seed: int,
           grace_s: float, on_start=None, on_tick=None) -> Dict:
    """Offer ``rate`` requests a second for ``seconds`` -> latencies (s,
    the wait so far for a missing one), outputs, lateness, counts."""
    server, clips = state["server"], state["clips"]
    due, clip = offered(rate, seconds, seed, len(clips))
    n = len(due)
    done = np.full(n, np.nan)
    outs: List = [None] * n
    errors = [0]
    lateness = np.zeros(n)
    first_batch = server.dispatched_batches

    def finish(i):
        def cb(fut):
            if fut.exception() is None:
                outs[i] = fut.result()
                done[i] = time.perf_counter()
            else:
                errors[0] += 1
        return cb

    t0 = time.perf_counter()
    if on_start:
        on_start()
    futs = []
    for i in range(n):
        target = t0 + due[i]
        # sleep, never spin: a spinning generator would hold the GIL that
        # the server's collector and resolver threads need
        wait = target - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        lateness[i] = time.perf_counter() - target
        fut = server.submit(clips[clip[i]])
        fut.add_done_callback(finish(i))
        futs.append(fut)
        if on_tick:
            on_tick(time.perf_counter() - t0)
    t_close = t0 + seconds
    deadline = max(t_close, time.perf_counter()) + grace_s
    for fut in futs:
        left = deadline - time.perf_counter()
        if left <= 0:
            break
        try:
            fut.result(timeout=left)
        except Exception:           # counted by the callback
            pass
    t_wait = time.perf_counter()
    lat = np.where(np.isnan(done), t_wait - (t0 + due), done - (t0 + due))
    return {"latency": lat, "done": ~np.isnan(done), "outs": outs,
            "lateness": lateness, "due": due, "clip": clip,
            "batches": server.dispatched_batches - first_batch,
            "seconds": seconds}


def backlog_trend(res: Dict) -> float:
    """Slope of latency over due time, ms per second of the window: near 0
    where the server keeps up, about 1000 times the overload where the
    queue grows."""
    ok = res["done"]
    if ok.sum() < 2:
        return float("inf")
    slope = np.polyfit(res["due"][ok], res["latency"][ok], 1)[0]
    return float(1e3 * slope)


def request_scores(calls: List, n: int) -> List:
    """Each request's search score (None where none was recorded), by the
    order in which the collector dispatched the queue."""
    out, at = [None] * n, 0
    for rows, score in calls:
        for j in range(rows):
            if at < n and score is not None:
                out[at] = score[j]
            at += 1
    return out


def run(ctx) -> Dict:
    with capture.best_scores([]) as captured:
        return _run(ctx, captured)


def _run(ctx, captured: List) -> Dict:
    cfg, p = ctx.config, ctx.params
    state = setup(ctx, captured)
    holder: Dict = {}
    prof = {"cm": None}

    def on_start():
        ctx.t_window = time.perf_counter()
        if ctx.trace:
            prof["cm"] = trace.profile(ctx.spans, holder)
            prof["cm"].__enter__()

    def on_tick(elapsed):
        if prof["cm"] is not None and elapsed >= p["trace_seconds"]:
            prof["cm"].__exit__(None, None, None)
            prof["cm"] = None

    ctx.sync()
    ctx.log(f"set-up done: {len(state['clips'])} clips")
    res = window(state, p["rate"], ctx.seconds, ctx.seed, p["grace_s"],
                 on_start, on_tick)
    if prof["cm"] is not None:
        prof["cm"].__exit__(None, None, None)
    state["server"].stop()
    peak = ctx.memory_peak()
    lat = res["latency"]
    ctx.log(f"window: {len(lat)} requests, {int(res['done'].sum())} served "
            f"in {res['batches']} batches; generator lateness mean "
            f"{1e3 * res['lateness'].mean():.3f} ms, p95 "
            f"{1e3 * np.quantile(res['lateness'], 0.95):.3f} ms, max "
            f"{1e3 * res['lateness'].max():.3f} ms; backlog trend "
            f"{backlog_trend(res):.3f} ms/s; peak {peak}")
    weights, lengths = state["weights"], state["lengths"]
    clips = state["clips"]
    scores = request_scores(state["calls"], len(lat))
    del state
    ctx.free()

    # the reference over a seeded sample of served requests, the longest
    # clip among the served ones in it
    served = np.flatnonzero(res["done"])
    rng = seeded.host_rng(ctx.seed, "sample")
    pick = list(rng.choice(served, min(p["check_requests"], len(served)),
                           replace=False))
    longest = served[np.argmax(lengths[res["clip"][served]])]
    if longest not in pick:
        pick[-1] = longest
    ref = models.reference_model(cfg, weights, ctx.device)
    width = p["server"]["max_samples"]
    found = []
    for a in range(0, len(pick), 64):
        rows = pick[a:a + 64]
        wav, lens = padded(clips, [res["clip"][r] for r in rows], width)
        served_ids = torch.as_tensor(np.stack([res["outs"][r] for r in rows]))
        got = [scores[r] for r in rows]
        score = (None if any(s is None for s in got)
                 else torch.stack([s.float().cpu() for s in got]))
        found.append(judge.compare_captions(
            ref, wav.to(ctx.device), lens.to(ctx.device), served_ids, score,
            cfg["beam_size"], cfg["max_length"]))
    if not found:
        found = [{"score_gap": torch.full((1,), float("inf")),
                  "miss": torch.ones(1, dtype=torch.bool)}]
    checks = judge.caption_checks(found, cfg)
    missing = int((~res["done"]).sum())
    info = {"served": int(res["done"].sum()), "batches": res["batches"]}
    return {"e2e": {"serve_p95_ms": 1e3 * float(np.quantile(lat, 0.95)),
                    "setup_s": ctx.t_window - ctx.t0},
            "attempted": len(lat), "failed": missing, "checks": checks,
            "info": info, "trace": holder.get("trace"),
            "memory_peak_bytes": peak}


def control(ctx) -> List:
    """The control's number: the reference's beam search in TF32 in the
    program's place, on ``check_requests`` pool clips padded as served."""
    cfg, p = ctx.config, ctx.params
    weights = models.seeded_weights(cfg, ctx.seed, ctx.device)
    clips, _ = make_clips(ctx)
    ref = models.reference_model(cfg, weights, ctx.device)
    rows = list(seeded.host_rng(ctx.seed, "sample").choice(
        len(clips), min(p["check_requests"], len(clips)), replace=False))
    found = []
    for a in range(0, len(rows), 64):
        wav, lens = padded(clips, rows[a:a + 64], p["server"]["max_samples"])
        wav, lens = wav.to(ctx.device), lens.to(ctx.device)
        seq, score = judge.control_captions(ref, wav, lens, cfg["beam_size"],
                                            cfg["max_length"])
        found.append(judge.compare_captions(ref, wav, lens, seq, score,
                                            cfg["beam_size"],
                                            cfg["max_length"]))
    return judge.caption_checks(found, cfg)
