"""Paths, the files a run is driven by, the card check and the check
that no JAX module was loaded.

Everything a cell needs is found by name: ``BENCHMARK.json`` at the
checkout's root names the cell's configuration, traffic and chips, its
metrics and their cells; ``benchmark/workloads/<cell>.json`` holds the
traffic kind, the kernels it builds and its parameters;
``benchmark/configs/<config>.json`` the model;
``benchmark/traffic/<kind>.py`` drives the kind;
``benchmark/metrics/<metric>.py`` reads one per-layer metric.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
# top-level module names that may not be loaded in a run (whole names:
# the port's ``audiocaption_tpu_torch`` only begins with the last one)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "audiocaption_tpu")


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its CUDA kernels into ``build/kernels`` itself), and
    libraries kept from loading JAX.  Call before importing torch."""
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> Dict:
    return read_json(ROOT / "BENCHMARK.json")


def cell_files(cell: str) -> Dict:
    """-> {spec, cell, workload, config}: ``BENCHMARK.json``, the cell's
    entry there, its workload file and its configuration file.  A cell
    that ``BENCHMARK.json`` does not list yet is named
    ``<config>.<traffic>`` and takes one chip."""
    spec = benchmark_spec()
    path = BENCH / "workloads" / f"{cell}.json"
    if not path.exists():
        raise SystemExit(f"unknown workload {cell!r}")
    entry = next((w for w in spec["workloads"] if w["name"] == cell), None)
    if entry is None:
        config, traffic = cell.split(".", 1)
        entry = {"name": cell, "config": config, "traffic": traffic,
                 "chips": 1}
    config = read_json(BENCH / "configs" / f"{entry['config']}.json")
    return {"spec": spec, "cell": entry, "workload": read_json(path),
            "config": config}


def load_file(path: Path, name: Optional[str] = None) -> ModuleType:
    """Import a file of the benchmark by its path (file names may hold
    dots, as metric names do)."""
    mod_name = name or "bench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def traffic_kind(kind: str) -> ModuleType:
    return load_file(BENCH / "traffic" / f"{kind}.py")


def metric_reader(metric: str) -> ModuleType:
    return load_file(BENCH / "metrics" / f"{metric}.py")


def cell_metrics(spec: Dict, cell: str, section: str) -> List[Dict]:
    """The metrics of ``section`` ("end_to_end" or "per_layer") that
    ``cell`` reports: those that list it, and those that list no cells."""
    return [m for m in spec[section]
            if cell in m.get("workloads", [cell])]


def require_cards(count: int) -> None:
    """Exit without a result unless ``count`` CUDA cards are visible."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark measures the card "
                         "and has no CPU mode")
    if torch.cuda.device_count() < count:
        raise SystemExit(f"the cell needs {count} CUDA devices, "
                         f"{torch.cuda.device_count()} visible")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def card_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the first card, or ""."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""
