"""One traced run of a cell, as ``run.py --trace 1`` makes it, with the
traced window broken down by the program's own spans.

    python3 benchmark/span_breakdown.py --workload <cell> --seed <n> \
        --seconds <s> [--all-threads 1] [--out <file.json>]

Prints the run's result line, then a table per unit of work (a train
step, a caption batch, a served batch): for each program span (``ac.*``,
else the benchmark's ``entry``; ``harness/program_spans.py``) how often
it opened, its host ms, the device ms launched with it innermost and the
idle ms of the gaps such a launch ended, and the traced unit's time
(window over units) and the idle time before the window's first work.  ``--all-threads 1`` records every thread's spans
(the server's collector and resolver open theirs on their own threads,
which the benchmark's profiler leaves out) and prints the server's
counters.  ``--out`` writes all of it as JSON.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run  # noqa: E402  (sets the cache paths before torch loads)
from harness import env, program_spans  # noqa: E402


def units_of(kind: str, info, trace):
    """Units of work in the traced window, from what the traffic records
    on every commit (a step's log-mel work, a traced batch), or the
    program's own dispatch spans for the server."""
    if kind == "train_step":
        return len(info.get("frontend_work") or [])
    if kind == "batch_caption":
        return len(info.get("traced") or [])
    return trace.span_count("ac.serve.dispatch")


def traced_run(cell: str, seed: int, seconds: float,
               all_threads: bool = False, **run_cell_args):
    """-> the report of one traced run of ``cell`` (``run_cell_args`` go
    to ``run.run_cell``: the tests run small cells on the CPU)."""
    import torch
    from audiocaption_tpu_torch import serving
    kept, servers = {}, []
    profile, init = torch.profiler.profile, serving.MicroBatchServer.__init__
    load = env.traffic_kind

    def profile_all(*a, **k):
        return profile(*a, experimental_config=torch._C._profiler.
                       _ExperimentalConfig(profile_all_threads=True), **k)

    def keep_server(self, *a, **k):
        servers.append(self)
        init(self, *a, **k)

    def traffic_kind(kind):
        module = load(kind)
        traffic_run = module.run

        def keep_out(ctx):
            kept["out"], kept["kind"] = traffic_run(ctx), kind
            return kept["out"]
        module.run = keep_out
        return module
    if all_threads:
        torch.profiler.profile = profile_all
    serving.MicroBatchServer.__init__ = keep_server
    env.traffic_kind = traffic_kind
    try:
        line, _ = run.run_cell(cell, seed, seconds, True, **run_cell_args)
    finally:
        torch.profiler.profile = profile
        serving.MicroBatchServer.__init__ = init
        env.traffic_kind = load
    trace = kept["out"]["trace"]
    units = units_of(kept["kind"], kept["out"]["info"], trace) \
        if trace is not None else 0
    busy = trace.busy_intervals() if trace is not None else []
    return {"result": line, "card": env.card_power_limit(), "units": units,
            "window_s": trace.window_s if trace is not None else None,
            "first_gap_ms": (busy[0][0] - trace.t0) / 1e6 if busy else None,
            "unit_ms": 1e3 * trace.window_s / units if units else None,
            "spans": program_spans.breakdown(trace, units) if units else [],
            "servers": [{k: getattr(s, k, None) for k in (
                "dispatched_batches", "served_requests", "padded_rows",
                "queue_wait_s")} for s in servers]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--all-threads", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    report = traced_run(args.workload, args.seed, args.seconds,
                        bool(args.all_threads))
    print(json.dumps(report["result"]))
    print(f"{args.workload} seed {args.seed}, {report['card']}: "
          f"{report['units']} units traced in {report['window_s']} s, "
          f"{report['unit_ms']} ms a unit; the window's first "
          f"{report['first_gap_ms']} ms idle (in the table's rows)")
    print(f"{'span':28s} {'count':>7s} {'host_ms':>9s} {'device_ms':>9s} "
          f"{'idle_ms':>9s}")
    for r in report["spans"]:
        print(f"{r['span']:28s} {r['count']:7.2f} {r['host_ms']:9.3f} "
              f"{r['device_ms']:9.3f} {r['idle_ms']:9.3f}")
    for s in report["servers"]:
        print("server (whole window):", json.dumps(s))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
