"""Spans from the benchmark's own files and the device trace.

``Spans`` opens ``torch.profiler.record_function`` ranges around the
calls of a cell's entry and, by forward pre/post hooks, around a model's
submodules.  ``profile`` records the host and the card with
``torch.profiler`` (CUPTI) and reduces the trace to a ``Trace``: each
device activity (kernel, copy, set) is tied to the host call that
launched it by the profiler's launch correlation, and so to the spans
open on that thread at that moment.
"""

from __future__ import annotations

import bisect
import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple



class Spans:
    """Named host ranges, recorded only while ``enabled``."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._open: Dict[int, list] = defaultdict(list)

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def hook(self, module, name: str) -> None:
        """A span around every forward call of ``module``."""
        def pre(_mod, _args):
            if self.enabled:
                rf = self.span(name)
                rf.__enter__()
                self._open[threading.get_ident()].append(rf)

        def post(_mod, _args, _out):
            stack = self._open[threading.get_ident()]
            if self.enabled and stack:
                stack.pop().__exit__(None, None, None)
        module.register_forward_pre_hook(pre)
        module.register_forward_hook(post)


class Trace:
    """A reduced device trace of the window ``[t0, t1]`` (ns, the
    profiler's clock)."""

    def __init__(self, device: List[Tuple[int, int, str, int]],
                 launches: Dict[int, Tuple[int, int]],
                 spans: Dict[str, List[Tuple[int, int, int]]],
                 ops: Dict[int, List[Tuple[int, int, str]]],
                 t0: int, t1: int):
        self.device = sorted(device)               # (start, end, name, corr)
        self.launches = launches                   # corr -> (host ns, thread)
        self.spans = spans                         # name -> (start, end, tid)
        self.ops = {tid: sorted(v) for tid, v in ops.items()}
        self._op_starts = {tid: [o[0] for o in v] for tid, v in self.ops.items()}
        self.t0, self.t1 = t0, t1

    # ----------------------------------------------------------- time --
    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def _clip(self, s: int, e: int) -> int:
        return max(0, min(e, self.t1) - max(s, self.t0))

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of device activity, clipped to the window."""
        out: List[List[int]] = []
        for s, e, _, _ in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    # ---------------------------------------------------- attribution --
    def _in_span(self, name: str, host_ns: int, tid: int) -> bool:
        for s, e, t in self.spans.get(name, ()):
            if t == tid and s <= host_ns <= e:
                return True
        return False

    def span_count(self, name: str) -> int:
        return sum(1 for s, e, _ in self.spans.get(name, ())
                   if s >= self.t0 and e <= self.t1)

    def device_s(self, inside: str, outside: Sequence[str] = ()) -> float:
        """Device seconds of the activity launched inside a span named
        ``inside`` and inside none of the spans named in ``outside``."""
        index = {n: self._index(n) for n in (inside, *outside)}
        total = 0
        for s, e, _, corr in self.device:
            launch = self.launches.get(corr)
            if launch is None:
                continue
            host, tid = launch
            if not index[inside](host, tid):
                continue
            if any(index[n](host, tid) for n in outside):
                continue
            total += self._clip(s, e)
        return total / 1e9

    def _index(self, name: str):
        by_tid: Dict[int, Tuple[list, list]] = {}
        for s, e, t in sorted(self.spans.get(name, ())):
            starts, ends = by_tid.setdefault(t, ([], []))
            starts.append(s)
            ends.append(e)

        def contains(host: int, tid: int) -> bool:
            if tid not in by_tid:
                return False
            starts, ends = by_tid[tid]
            i = bisect.bisect_right(starts, host) - 1
            # spans of one name do not nest, so the last to start is it
            return i >= 0 and ends[i] >= host
        return contains

    def host_op_at(self, host: int, tid: int) -> Optional[str]:
        """The innermost host operation running at ``host`` on ``tid``."""
        ops = self.ops.get(tid)
        if not ops:
            return None
        i = bisect.bisect_right(self._op_starts[tid], host) - 1
        for j in range(i, max(-1, i - 200), -1):
            s, e, name = ops[j]
            if s <= host <= e:
                return name
        return None

    # ------------------------------------------------------ breakdown --
    def device_ops(self, top: int = 10) -> List[List]:
        """The device activities that took the most time, by name."""
        by_name: Dict[str, int] = defaultdict(int)
        for s, e, name, _ in self.device:
            by_name[name] += self._clip(s, e)
        best = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:160], ns / 1e9] for name, ns in best]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle device time grouped by what the host was doing when it
        launched the work that ended the gap (the innermost host
        operation around that launch)."""
        busy = self.busy_intervals()
        firsts = {}
        for s, e, name, corr in self.device:
            firsts.setdefault(s, corr)
        starts = sorted(firsts)
        by_label: Dict[str, int] = defaultdict(int)
        edges = [(self.t0, busy[0][0] if busy else self.t1)] + [
            (busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
        if busy:
            edges.append((busy[-1][1], self.t1))
        for gs, ge in edges:
            if ge <= gs:
                continue
            label = "window end"
            i = bisect.bisect_left(starts, ge)
            if ge < self.t1 and i < len(starts):
                launch = self.launches.get(firsts[starts[i]])
                label = "unknown launch"
                if launch is not None:
                    label = self.host_op_at(*launch) or "host runtime"
            by_label[label] += ge - gs
        best = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:160], ns / 1e9] for name, ns in best]


@contextlib.contextmanager
def profile(spans: Spans, holder: Dict):
    """Record the block with ``torch.profiler`` (host and CUDA) and put its
    ``Trace`` in ``holder["trace"]``."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    spans.enabled = True
    prof = torch_profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA])
    prof.__enter__()
    t0 = time.time_ns()
    try:
        yield
    finally:
        torch.cuda.synchronize()
        t1 = time.time_ns()
        spans.enabled = False
        prof.__exit__(None, None, None)
    holder["trace"] = reduce(prof.profiler.kineto_results.events(), t0, t1)


def reduce(events: Iterable, t0: int, t1: int) -> Trace:
    """Kineto events -> ``Trace``."""
    from torch.autograd import DeviceType
    device, launches = [], {}
    spans: Dict[str, List] = defaultdict(list)
    ops: Dict[int, List] = defaultdict(list)
    annotations = set()
    raw = list(events)
    for ev in raw:
        if ev.device_type() == DeviceType.CPU and ev.is_user_annotation():
            annotations.add(ev.name())
    for ev in raw:
        name, start = ev.name(), ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if ev.is_user_annotation() or name in annotations:
                continue
            device.append((start, end, name, ev.correlation_id()))
        elif ev.is_user_annotation():
            spans[name].append((start, end, ev.start_thread_id()))
        elif name.startswith("cuda") and ev.correlation_id():
            launches[ev.correlation_id()] = (start, ev.start_thread_id())
        elif ev.correlation_id() or name.startswith("aten::"):
            ops[ev.start_thread_id()].append((start, end, name))
    return Trace(device, launches, dict(spans), dict(ops), t0, t1)
