"""Readings of the program's own spans in a ``Trace``.

The port opens ``torch.profiler.record_function`` ranges named ``ac.*``
on its hot path while a profiler records
(``audiocaption_tpu_torch/utils/profiling.py::span``); ``trace.reduce``
keeps them as spans beside the benchmark's own ``entry``, ``frontend``
and ``encoder``.  Host syncs are the spans named ``ac.sync.<site>``.  A
program without them (an older commit) records none, and the readers
built on this module then return nothing.

Attribution across threads: device work, or an idle gap, belongs to a
span by the host time of the launch (the launch that ended the gap, as
``Trace.idle_gaps`` finds it), whatever thread made the launch.  The
backward's launches come from autograd's device thread while the step's
span is open on the main thread.  Where the launching thread has a span
open, its innermost one is taken; else the innermost one open on another
thread, those with the most spans first.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

PREFIX = "ac."
SYNC = "ac.sync."
# the benchmark's own span that the table falls back to (its ``frontend``
# and ``encoder`` hooks lie inside the program's ``ac.frontend`` and
# ``ac.encoder`` and would hide them)
OUTER = ("entry",)


def instrumented(trace) -> bool:
    """Whether the traced program recorded any span of its own."""
    return trace is not None and any(n.startswith(PREFIX)
                                     for n in trace.spans)


def _union(intervals: Sequence[Tuple[int, int]]) -> List[List[int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clip(trace, s: int, e: int) -> int:
    return max(0, min(e, trace.t1) - max(s, trace.t0))


def host_s(trace, prefix: str, within: Optional[str] = None) -> float:
    """Host seconds inside the spans whose name starts with ``prefix``
    (their union over threads, clipped to the window); with ``within``,
    only those that lie inside a span of that name on their own thread."""
    outer = defaultdict(list)
    if within is not None:
        for s, e, t in trace.spans.get(within, ()):
            outer[t].append((s, e))
    picked = []
    for name, items in trace.spans.items():
        if not name.startswith(prefix):
            continue
        for s, e, t in items:
            if within is None or any(a <= s and e <= b for a, b in outer[t]):
                picked.append((s, e))
    return sum(_clip(trace, s, e) for s, e in _union(picked)) / 1e9


def idle_gaps(trace) -> List[Tuple[int, Optional[Tuple[int, int]]]]:
    """Each idle gap of the window as ``Trace.idle_gaps`` finds it: (ns,
    the (host ns, thread) of the launch that ended it, or None for the
    window's end and a launch the trace does not hold)."""
    busy = trace.busy_intervals()
    firsts: Dict[int, int] = {}
    for s, _, _, corr in trace.device:
        firsts.setdefault(s, corr)
    starts = sorted(firsts)
    edges = [(trace.t0, busy[0][0] if busy else trace.t1)] + [
        (busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    if busy:
        edges.append((busy[-1][1], trace.t1))
    out = []
    for gs, ge in edges:
        if ge <= gs:
            continue
        launch = None
        i = bisect.bisect_left(starts, ge)
        if ge < trace.t1 and i < len(starts):
            launch = trace.launches.get(firsts[starts[i]])
        out.append((ge - gs, launch))
    return out


def _open_on_any_thread(trace, name: str) -> Callable[[int], bool]:
    """-> fn(host ns): whether a span ``name`` is open then, on any
    thread."""
    merged = _union([(s, e) for s, e, _ in trace.spans.get(name, ())])
    starts = [s for s, _ in merged]

    def inside(host: int) -> bool:
        i = bisect.bisect_right(starts, host) - 1
        return i >= 0 and merged[i][1] >= host
    return inside


def idle_s_ended_in(trace, name: str) -> float:
    """Idle seconds of the gaps ended by a launch made while a span
    ``name`` was open (on any thread: see the module docstring)."""
    inside = _open_on_any_thread(trace, name)
    return sum(ns for ns, launch in idle_gaps(trace)
               if launch is not None and inside(launch[0])) / 1e9


def _timeline(spans: List[Tuple[int, int, str]]):
    """Nested spans of one thread -> (times, names): from ``times[i]`` on,
    the innermost open span is ``names[i]`` (None: none)."""
    times: List[int] = []
    names: List[Optional[str]] = []
    stack: List[Tuple[int, str]] = []

    def close_until(t) -> None:
        while stack and stack[-1][0] <= t:
            end, _ = stack.pop()
            times.append(max(end, times[-1]))
            names.append(stack[-1][1] if stack else None)
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        close_until(s)
        times.append(s)
        names.append(name)
        stack.append((e, name))
    close_until(float("inf"))
    return times, names


class Innermost:
    """The innermost program span (``ac.*``, else ``OUTER``) open at a
    launch, by the rule of the module docstring."""

    def __init__(self, trace):
        by_tid: Dict[int, list] = defaultdict(list)
        for name, items in trace.spans.items():
            if name.startswith(PREFIX) or name in OUTER:
                for s, e, t in items:
                    by_tid[t].append((s, e, name))
        self._lines = {t: _timeline(v) for t, v in by_tid.items()}
        self._order = sorted(by_tid, key=lambda t: -len(by_tid[t]))

    def _on(self, tid: int, host: int) -> Optional[str]:
        times, names = self._lines[tid]
        i = bisect.bisect_right(times, host) - 1
        return names[i] if i >= 0 else None

    def at(self, host: int, tid: int) -> Optional[str]:
        if tid in self._lines:
            name = self._on(tid, host)
            if name is not None:
                return name
        for t in self._order:
            if t != tid:
                name = self._on(t, host)
                if name is not None:
                    return name
        return None


def breakdown(trace, units: int) -> List[Dict]:
    """Per program span, per unit of work (step, batch): how often it
    opened, its host ms (inclusive), the device ms launched with it
    innermost, and the idle ms of the gaps a launch with it innermost
    ended.  Rows by idle time, the gaps no span claims last ("none")."""
    inner = Innermost(trace)
    rows: Dict[str, Dict] = defaultdict(lambda: {
        "count": 0.0, "host_ms": 0.0, "device_ms": 0.0, "idle_ms": 0.0})
    for name, items in trace.spans.items():
        if name.startswith(PREFIX) or name in OUTER:
            rows[name]["count"] = trace.span_count(name) / units
            rows[name]["host_ms"] = sum(
                _clip(trace, s, e) for s, e, _ in items) / 1e6 / units
    for s, e, _, corr in trace.device:
        launch = trace.launches.get(corr)
        label = (inner.at(*launch) if launch else None) or "none"
        rows[label]["device_ms"] += _clip(trace, s, e) / 1e6 / units
    for ns, launch in idle_gaps(trace):
        label = (inner.at(*launch) if launch else None) or "none"
        rows[label]["idle_ms"] += ns / 1e6 / units
    return [dict(span=k, **v) for k, v in
            sorted(rows.items(), key=lambda kv: (kv[0] == "none",
                                                  -kv[1]["idle_ms"]))]
