"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's entry in ``BENCHMARK.json`` names its configuration and
traffic; ``benchmark/workloads/<cell>.json`` gives the traffic kind, its
parameters and the kernels to build; ``benchmark/traffic/<kind>.py``
builds the program from the seed, warms up the cell's shapes, drives it
for ``--seconds`` and checks what it produced against the plain
reference.  ``--trace 1`` records the window with ``torch.profiler`` and
reports the cell's per-layer metrics (``benchmark/metrics/<name>.py``)
instead of its end-to-end ones.  The run needs as many CUDA cards as the
cell asks for, and fails without them.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import env  # noqa: E402

env.set_cache_dirs()


class Context:
    """What a traffic kind is given: the cell's files, the seed, the
    window, the device and its helpers."""

    def __init__(self, files, seed: int, seconds: float, trace: bool,
                 device: str):
        import torch
        from harness.trace import Spans
        self.cell = files["cell"]["name"]
        self.config, self.workload = files["config"], files["workload"]
        self.params = self.workload["params"]
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.spans = Spans(False)
        self.t0 = T0

    def log(self, msg: str) -> None:
        print(f"[{time.perf_counter() - T0:8.3f} s] {msg}", file=sys.stderr,
              flush=True)

    def event(self, timing: bool = False):
        """A marker on the device's stream; ``synchronize()`` waits for it
        (``timing``: one that ``elapsed_time`` can read)."""
        import torch
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=timing)
            ev.record()
            return ev
        return _Done()

    def sync(self) -> None:
        import torch
        if self.cuda:
            torch.cuda.synchronize()

    def window_start(self) -> float:
        self.sync()
        return time.perf_counter()

    def memory_peak(self) -> int:
        import torch
        return int(torch.cuda.max_memory_allocated()) if self.cuda else 0

    def free(self) -> None:
        import torch
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


class _Done:
    def synchronize(self) -> None:
        pass


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", config=None, params=None):
    """-> (result line as a dict, checks).  ``config`` / ``params`` update
    the cell's files (tests run small cells on the CPU)."""
    files = env.cell_files(cell)
    files["config"].update(config or {})
    files["workload"]["params"].update(params or {})
    if device == "cuda":
        env.require_cards(files["cell"]["chips"])
    import torch
    ctx = Context(files, seed, seconds, trace, device)
    if ctx.cuda:
        from audiocaption_tpu_torch import cuda_build
        ctx.log("card reached")
        cuda_build.build_all(files["workload"]["kernels"])
        torch.cuda.reset_peak_memory_stats()
        ctx.log("kernels built")
    kind = env.traffic_kind(files["workload"]["kind"])
    out = kind.run(ctx)
    spec = files["spec"]
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in env.cell_metrics(spec, cell, section):
        if trace:
            value = env.metric_reader(m["name"]).read(out["info"],
                                                      out["trace"])
        else:
            value = out["e2e"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if ctx.cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(ctx.device)
                            if ctx.cuda else "cpu"),
                   "count": files["cell"]["chips"],
                   "memory_peak_bytes": out["memory_peak_bytes"]}
    breakdown = None
    if trace and out["trace"] is not None:
        tr = out["trace"]
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.device_ops(),
                     "idle_gaps": tr.idle_gaps()}
    from harness.report import passed
    line = {"correct": passed(out["checks"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    return line, out["checks"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    line, checks = run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace))
    loaded = env.forbidden_modules()
    if loaded:
        print(f"JAX or the JAX package was loaded: {loaded}",
              file=sys.stderr)
        return 3
    from harness.report import emit
    emit(line, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
