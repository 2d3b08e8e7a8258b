"""The readings a cell's limits are set from, one process for every seed
given.  ``--read control`` (the default): the plain reference, put in
the program's place and computed one precision below the
configuration's (TF32 products and convolutions for float32 with TF32
off), judged by the same comparison as the program; its numbers have to
fail the cell's limits.  ``--read sound``: the cell as it runs, with a
window of ``--seconds``.  ``--read <fault>``: the same with a fault
planted in the program (``harness/faults.py``).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--read control|sound|<fault>] [--seconds 2]
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import env, faults  # noqa: E402

env.set_cache_dirs()


def control_checks(cell: str, seed: int, device: str = "cuda",
                   config=None, params=None):
    import run
    files = env.cell_files(cell)
    files["config"].update(config or {})
    files["workload"]["params"].update(params or {})
    ctx = run.Context(files, seed, 0.0, False, device)
    return env.traffic_kind(files["workload"]["kind"]).control(ctx)


def fault_checks(cell: str, seed: int, fault: str, seconds: float,
                 device: str = "cuda", config=None, params=None):
    """A run of the cell with ``fault`` planted ("sound": none) -> its
    checks."""
    import contextlib
    import run
    files = env.cell_files(cell)
    planted = (contextlib.nullcontext() if fault == "sound"
               else faults.plant(fault, files["config"]))
    with planted:
        _, checks = run.run_cell(cell, seed, seconds, False, device,
                                 config, params)
    return checks


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--read", default="control",
                    choices=["control", "sound"] + sorted(faults.FAULTS))
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    env.require_cards(1)
    for seed in (int(s) for s in args.seeds.split(",")):
        try:
            if args.read == "control":
                checks = control_checks(args.workload, seed)
            else:
                checks = fault_checks(args.workload, seed, args.read,
                                      args.seconds)
        except Exception as exc:      # a reading that fails sets no limit
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "read": args.read, "error": repr(exc)}),
                  flush=True)
            continue
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "read": args.read,
                          "numbers": {n: v for n, v, _ in checks},
                          "limits": {n: lim for n, _, lim in checks}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
