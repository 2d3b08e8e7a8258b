"""Training steps, closed loop: ``training.trainer.train_step`` on batches
of a seeded pool of distinct clips (16-bit PCM in pinned host memory,
widened by the program) with captions, one step after another.

Parameters (``benchmark/workloads/<cell>.json``, ``params``):
  pool_batches, lengths (``seeded.clip_lengths``), words ([lo, hi] of a
  caption), ss_ratio (the scheduled-sampling ratio the step is given),
  lr_count (updates already applied, which set the learning rate),
  check_steps (steps the reference follows), trace_seconds.

Set-up builds one train state (model, Adam, schedule) from the seed,
runs the first ``check_steps`` steps on distinct batches through the
same call as the window (the reference follows them after the window;
the default generators are seeded before the first of them, and again
before the reference's, so that the recipe's dropouts draw the same
masks on both sides),
then one step on every other pool batch (every padded shape), then
hands the same state to the window.  ``train_clips_per_s`` is the clips
of every step in the window over the window's time."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from harness import judge, models, seeded, trace
from reference.common import mel_filterbank
from roofline import flops, work


def make_pool(ctx) -> List[Dict]:
    cfg, p = ctx.config, ctx.params
    sr, B, P = cfg["sample_rate"], cfg["batch_size"], p["pool_batches"]
    lengths = seeded.clip_lengths(P * B, p["lengths"], sr, ctx.seed)
    caps, cap_lens = seeded.captions(P * B, tuple(p["words"]),
                                     cfg["vocab_size"], ctx.seed)
    gen = seeded.device_gen(ctx.seed, "audio", ctx.device)
    pool = []
    for i in range(P):
        rows = slice(i * B, (i + 1) * B)
        lens = lengths[rows]
        width = int(lens.max())
        wav = seeded.to_int16(seeded.audio(lens, width, sr, gen)).cpu()
        lc = int(cap_lens[rows].max())
        pool.append({"wav": wav.pin_memory() if ctx.cuda else wav,
                     "wav_len": torch.as_tensor(lens),
                     "cap": torch.as_tensor(caps[rows, :lc]),
                     "cap_len": torch.as_tensor(cap_lens[rows]),
                     "width": width})
    return pool


def to_device(b: Dict, device) -> Dict:
    return {k: b[k].to(device, non_blocking=True)
            for k in ("wav", "wav_len", "cap", "cap_len")}


def hyper(cfg: Dict, p: Dict) -> Dict:
    per_epoch = cfg["train_pairs"] // cfg["batch_size"]   # drop_last
    total = cfg["epochs"] * per_epoch
    return {"lr": cfg["lr"], "final_lr": cfg["final_lr"],
            "total_iters": total, "warmup_iters": total // 5,
            "lr_count": p["lr_count"], "weight_decay": cfg["weight_decay"],
            "max_grad_norm": cfg["max_grad_norm"],
            "label_smoothing": cfg["label_smoothing"]}


def coins(seed: int, pool: List[Dict], steps: int, ratio: float):
    """The scheduled-sampling coins of the first ``steps`` steps, drawn as
    the program draws them: one float32 U[0, 1) a position from a host
    generator seeded like the one the program is given."""
    gen = torch.Generator().manual_seed(seeded.sub_seed(seed, "coins"))
    r = torch.tensor(ratio, dtype=torch.float32)
    return [[bool(torch.rand((), generator=gen, dtype=torch.float32) < r)
             for _ in range(pool[k]["cap"].shape[1] - 1)]
            for k in range(steps)]


def dropout_seed(seed: int) -> int:
    """The default generators' seed before the first step, on both sides."""
    return seeded.sub_seed(seed, "dropout")


def adam_grad(state, prm, beta1: float) -> float:
    """The norm of the gradient Adam took at its first step, from its first
    moment (0 where it holds none: the step did not reach it)."""
    m = state.optimizer.state.get(prm, {}).get("exp_avg")
    return 0.0 if m is None else float(m.double().norm()) / (1 - beta1)


def run(ctx) -> Dict:
    from audiocaption_tpu_torch.losses.loss import build_loss
    from audiocaption_tpu_torch.optim.schedules import build_schedule
    from audiocaption_tpu_torch.training.trainer import (create_train_state,
                                                         train_step)
    cfg, p = ctx.config, ctx.params
    h = hyper(cfg, p)
    ctx.log("imports done")
    weights = models.seeded_weights(cfg, ctx.seed, ctx.device)
    ctx.log("weights made")
    pool = make_pool(ctx)
    ctx.log("pool made")
    model = models.program_model(cfg, weights, ctx.device)
    ctx.log("program built")
    ctx.spans.hook(model.frontend, "frontend")
    schedule = build_schedule(
        {"type": "ExponentialDecayScheduler",
         "args": {"final_lrs": cfg["final_lr"]}},
        cfg["lr"], h["total_iters"], h["warmup_iters"])
    state = create_train_state(model, cfg["lr"], schedule,
                               weight_decay=cfg["weight_decay"],
                               max_grad_norm=cfg["max_grad_norm"])
    state.restore_count(p["lr_count"])
    loss_fn = build_loss({"type": "LabelSmoothingLoss",
                          "args": {"smoothing": cfg["label_smoothing"]}})
    ss_gen = torch.Generator().manual_seed(seeded.sub_seed(ctx.seed, "coins"))
    ratio = torch.tensor(p["ss_ratio"], dtype=torch.float32)
    names = {id(prm): n for n, prm in model.named_parameters()}

    def step(k, mark=None):
        return train_step(state, loss_fn, to_device(pool[k % len(pool)],
                                                    ctx.device),
                          ss_ratio=ratio, generator=ss_gen, mark=mark)

    # the steps the reference follows, on distinct batches, their dropout
    # drawn from a seeded default generator
    torch.manual_seed(dropout_seed(ctx.seed))
    prog = {"loss": []}
    beta1 = state.optimizer.defaults["betas"][0]
    for k in range(p["check_steps"]):
        prog["loss"].append(float(step(k)["loss"]))
        if k == 0:
            prog["grad"] = {names[id(prm)]: adam_grad(state, prm, beta1)
                            for prm in state.params}
    prog["change"] = {n: float((prm.detach() - weights[n]).double().norm())
                      for n, prm in model.named_parameters()}
    weights = {k: v.cpu() for k, v in weights.items()}
    # every other padded shape once
    for k in range(p["check_steps"], len(pool)):
        step(k)

    ctx.sync()
    ctx.log(f"set-up done: {len(pool)} batches, check losses {prog['loss']}")
    marks: List[Dict] = []
    holder: Dict = {}
    profiling, t_prof_end, traced = None, None, []
    t_start = ctx.window_start()
    if ctx.trace:
        profiling = trace.profile(ctx.spans, holder)
        profiling.__enter__()
    k, done_t, skipped = 0, [], 0
    while time.perf_counter() - t_start < ctx.seconds:
        if profiling is not None and \
                time.perf_counter() - t_start >= p["trace_seconds"]:
            profiling.__exit__(None, None, None)
            profiling, t_prof_end = None, time.perf_counter()
        mark = None
        if ctx.trace and ctx.cuda:
            ev = {"start": ctx.event(timing=True)}
            marks.append(ev)

            def mark(name, ev=ev):
                ev[name] = ctx.event(timing=True)
        if profiling is not None:
            traced.append(k % len(pool))
        if step(k, mark)["skipped"]:
            skipped += 1
        done_t.append(time.perf_counter())
        k += 1
    if profiling is not None:
        profiling.__exit__(None, None, None)
        t_prof_end = time.perf_counter()
    ctx.sync()
    t_end = time.perf_counter()
    B = cfg["batch_size"]
    peak = ctx.memory_peak()
    info = {"peak_flops": cfg["peak_flops"], "dtype": cfg["compute_dtype"]}
    if ctx.trace:
        for name in ("forward", "backward"):
            prev = "start" if name == "forward" else "forward"
            ms = [m[prev].elapsed_time(m[name]) for m in marks if name in m]
            info[f"{name}_ms"] = sum(ms) / len(ms) if ms else None
        mel = models.reference_module(cfg).MEL
        fb = mel_filterbank(mel)
        info["frontend_work"] = [
            work.logmel_work(mel.n_fft, mel.hop, mel.n_mels, fb, B,
                             pool[i]["width"]) for i in traced]
        after = [j for j, t in enumerate(done_t) if t_prof_end and
                 t > t_prof_end]
        if len(after) >= 2:
            total = sum(B * flops.train_flops(
                cfg, pool[j % len(pool)]["width"],
                pool[j % len(pool)]["cap"].shape[1] - 1) for j in after[1:])
            info["model_flops_per_s"] = total / (done_t[after[-1]]
                                                 - done_t[after[0]])
    ctx.log(f"window: {k} steps in {t_end - t_start:.3f} s, peak {peak}")
    if k > 2:
        gaps = np.diff(np.asarray([t_start] + done_t)) * 1e3
        ctx.log("step ms: median {:.2f}, p10 {:.2f}, p90 {:.2f}, max {:.2f}; "
                "{:.3f} s in steps over twice the median".format(
                    np.median(gaps), *np.percentile(gaps, [10, 90]),
                    gaps.max(), gaps[gaps > 2 * np.median(gaps)].sum() / 1e3))
    del state, model
    ctx.free()

    ref = models.reference_model(cfg, weights, ctx.device)
    batches = [to_device(pool[j], ctx.device) for j in range(p["check_steps"])]
    draws = coins(ctx.seed, pool, p["check_steps"], p["ss_ratio"])
    r = judge.reference_train(ref, batches, draws, h, dropout_seed(ctx.seed))
    ctx.log(f"reference losses {r['loss']}")
    checks = judge.train_checks(prog, r, cfg["limits"])
    return {"e2e": {"train_clips_per_s": B * k / (t_end - t_start),
                    "setup_s": t_start - ctx.t0},
            "attempted": B * k, "failed": B * skipped, "checks": checks,
            "info": info, "trace": holder.get("trace"), "memory_peak_bytes": peak}


def control(ctx) -> List:
    """The control's numbers: the reference computed in TF32 in the
    program's place, on the same batches, judged as the program is."""
    cfg, p = ctx.config, ctx.params
    h = hyper(cfg, p)
    weights = {k: v.cpu() for k, v in
               models.seeded_weights(cfg, ctx.seed, ctx.device).items()}
    pool = make_pool(ctx)
    batches = [to_device(pool[j], ctx.device) for j in range(p["check_steps"])]
    draws = coins(ctx.seed, pool, p["check_steps"], p["ss_ratio"])
    low = judge.reference_train(models.reference_model(cfg, weights,
                                                       ctx.device),
                                batches, draws, h, dropout_seed(ctx.seed),
                                tf32=True)
    ref = judge.reference_train(models.reference_model(cfg, weights,
                                                       ctx.device),
                                batches, draws, h, dropout_seed(ctx.seed))
    return judge.train_checks(low, ref, cfg["limits"])
