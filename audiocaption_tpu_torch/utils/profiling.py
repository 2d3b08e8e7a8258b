"""Profiling helpers (counterpart of ``audiocaption_tpu/utils/profiling.py``):

  * ``host_rss_gb``: the host's resident-set size, logged in the runner's
    epoch lines;
  * ``trace``: a ``torch.profiler`` trace of the host and the card, as a
    Chrome trace file (TensorBoard or chrome://tracing);
  * ``StepTimer``: step time, its moving average and items per second;
  * ``flops_estimate``: the FLOPs and bytes of one call of a function;
  * ``device_peak_flops`` and ``mfu``: model FLOPs utilisation against the
    card's dense bf16 rate.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


def host_rss_gb() -> float:
    """The host's resident-set size in GB (0.0 where /proc is absent): a
    leaking input pipeline shows in the epoch logs long before the OOM
    killer."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1e6
    except OSError:
        pass
    return 0.0


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` trace (host, and the card where there is one)
    of the block, written to ``logdir/trace.json`` at its end."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


class StepTimer:
    """Host-clock step timer with an exponential moving average.  Time a
    step on the card only around work that ends in a synchronise."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, items: int = 1) -> Dict[str, float]:
        dt = time.perf_counter() - self._t0
        self.avg = dt if self.avg is None else \
            self.ema * self.avg + (1 - self.ema) * dt
        return {"step_time_s": dt, "step_time_ema_s": self.avg,
                "items_per_sec": items / max(dt, 1e-9)}


class _BytesCounter(TorchDispatchMode):
    """Sums the bytes of every tensor operand and result of each ATen
    operation run under it."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten((args, kwargs or {}, out))[0]:
            if isinstance(t, torch.Tensor):
                self.bytes += t.numel() * t.element_size()
        return out


def flops_estimate(fn: Callable, *args) -> Dict[str, float]:
    """FLOPs and bytes of one call ``fn(*args)``, run eagerly.

    ``flops`` is ``torch.utils.flop_counter.FlopCounterMode``'s count: two
    per multiply-add of the matrix products, convolutions and attention
    it has formulas for (their backward too, where the call runs one),
    and nothing for elementwise operations, reductions or normalisation.
    ``bytes_accessed`` sums every ATen operation's tensor operands and
    results once each, as each operation would move them through memory
    with nothing fused.  Each is -1.0 where nothing was counted, as in
    the JAX package.

    The JAX package's ``flops_estimate`` reads XLA's cost analysis of the
    compiled program: it counts elementwise operations too, counts the
    bytes of the fused program, and counts the body of a ``while`` loop
    once.  For a network of convolutions and products the two FLOP
    counts agree to the share of elementwise work."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = _BytesCounter()
    flop_mode = FlopCounterMode(display=False)
    with flop_mode, counter:
        fn(*args)
    flops = flop_mode.get_total_flops()
    return {"flops": float(flops) if flops > 0 else -1.0,
            "bytes_accessed": float(counter.bytes) if counter.bytes > 0
            else -1.0}


# peak dense bf16 tensor-core throughput per card, FLOP/s (NVIDIA's data
# sheets), keyed on torch.cuda.get_device_name; used to anchor MFU numbers
_PEAK_BF16_FLOPS = (
    ("H100 80GB HBM3", 989e12),     # H100 SXM
    ("H200", 989e12),
)


def device_peak_flops(device=None) -> Optional[float]:
    """The card's dense bf16 FLOP/s by its name, or None for the CPU or a
    card not in the table."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available()
        else torch.device("cpu"))
    if dev.type != "cuda":
        return None
    name = torch.cuda.get_device_name(dev)
    for key, peak in _PEAK_BF16_FLOPS:
        if key in name:
            return peak
    return None


def mfu(flops: float, seconds: float, device=None) -> Optional[float]:
    """Model FLOPs utilisation: FLOPs / (seconds * the card's peak), or
    None where the peak is unknown or an argument is not positive."""
    peak = device_peak_flops(device)
    if not peak or seconds <= 0 or flops <= 0:
        return None
    return flops / seconds / peak
