"""Find the serving cell's knee: the highest offered rate the server
sustains without a growing backlog.  One process, one model and server;
each offered rate runs for ``--seconds`` and reports its completed share,
backlog trend (``serve_poisson.backlog_trend``) and latency percentiles.

    python3 benchmark/sweep_knee.py --workload effb2_trm.serve_poisson \
        --seed 7 --seconds 10 --rates 1000,1500,2000,2500,3000
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import env  # noqa: E402

env.set_cache_dirs()


def main() -> int:
    import numpy as np
    import run
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args()
    files = env.cell_files(args.workload)
    env.require_cards(files["cell"]["chips"])
    from audiocaption_tpu_torch import cuda_build
    cuda_build.build_all(files["workload"]["kernels"])
    ctx = run.Context(files, args.seed, args.seconds, False, "cuda")
    kind = env.traffic_kind(files["workload"]["kind"])
    state = kind.setup(ctx, [])
    print(f"card: {env.card_power_limit()}", flush=True)
    rows = []
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        res = kind.window(state, rate, args.seconds, args.seed + i, 30.0)
        lat, ok = res["latency"], res["done"]
        in_window = ok & (res["latency"] + res["due"] <= args.seconds + 0.0)
        row = {"rate": rate, "offered": len(lat),
               "completed_share": float(ok.mean()),
               "done_in_window_share": float(in_window.mean()),
               "backlog_ms_per_s": kind.backlog_trend(res),
               "p50_ms": 1e3 * float(np.quantile(lat, 0.5)),
               "p95_ms": 1e3 * float(np.quantile(lat, 0.95)),
               "batch_mean": float(ok.sum() / max(res["batches"], 1)),
               "lateness_p95_ms": 1e3 * float(np.quantile(res["lateness"],
                                                          0.95))}
        rows.append(row)
        print(json.dumps(row), flush=True)
    state["server"].stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
