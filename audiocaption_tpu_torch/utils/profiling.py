"""Profiling helpers (counterpart of ``audiocaption_tpu/utils/profiling.py``):

  * ``span`` and ``sync``: the program's own named ranges on its hot
    path (``ac.*``), recorded only while a ``torch.profiler`` session
    records, and free otherwise (one flag read, no ``record_function``);
  * ``host_rss_gb``: the host's resident-set size, logged in the runner's
    epoch lines;
  * ``trace``: a ``torch.profiler`` trace of the host and the card, as a
    Chrome trace file (TensorBoard or chrome://tracing), with the spans;
  * ``flops_estimate``: the FLOPs and bytes of one call of a function;
  * ``device_peak_flops`` and ``mfu``: model FLOPs utilisation against the
    card's dense bf16 rate.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Callable, Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether a ``torch.profiler`` (or ``torch.autograd.profiler``)
    session records: the module flag torch sets at a session's start and
    clears at its end, read in about 0.1 us, where a ``record_function``
    costs about 12 us even with no session (torch 2.13, CPU); torch's own
    query where the flag is absent."""
    flag = getattr(_autograd_profiler, "_is_profiler_enabled", None)
    return torch.autograd._profiler_enabled() if flag is None else flag


def span(name: str):
    """A context manager around one part of the program's work: a
    ``torch.profiler.record_function(name)`` range (a user annotation on
    the profiler's clock, to which the card's work launched inside it is
    tied by launch correlation) while a session records, else a shared
    no-op.  Names start with ``ac.``; a span never nests inside one of
    its own name."""
    if not recording():
        return _OFF
    return torch.profiler.record_function(name)


def sync(site: str):
    """``span("ac.sync." + site)``: around a deliberate device-to-host
    read, whose span then lasts as long as the host waited for the card."""
    return span("ac.sync." + site)


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
    of the block, written to ``logdir/trace.json`` at its end: the
    operator's way to see the program's spans (:func:`span`), each
    beside the card's work launched inside it.  Every thread is recorded
    where torch can (``MicroBatchServer``'s collector and resolver open
    their spans on their own threads)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities, **_all_threads()) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


def _all_threads() -> Dict:
    """``torch.profiler.profile``'s keyword that records the spans of
    every thread, not only of those that started the session (and
    autograd's), or nothing where this torch lacks it."""
    try:
        return {"experimental_config": torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)}
    except (AttributeError, TypeError):
        return {}


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
