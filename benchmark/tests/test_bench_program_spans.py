"""The readers of the program's own spans (``harness/program_spans.py``
and the metrics built on it) on small recorded traces."""

import pytest

from harness import env, program_spans
from harness.trace import Trace

MS = 1_000_000
MAIN, AUTOGRAD, OTHER = 1, 2, 3


def read(name, trace, info=None):
    return env.metric_reader(name).read(info or {}, trace)


def train_trace(spans_on: bool = True):
    """Two 100 ms steps in a 200 ms window.  A step: the forward (0-40 ms)
    holds the encoder (2-20) with the GRU's sync (10-18) and the SS loop
    (22-38); backward 40-70; optimizer 70-90 with the finite check
    (72-75).  Launches: 5 ms in the encoder, 25 ms in the loop, 30 ms in
    the loop from another thread, 45 ms from autograd's thread (no span of
    its own), 80 ms in the optimizer; their work runs at 6-9, 26-27,
    30-31, 50-60 and 80-85."""
    spans, launches, device = {}, {}, []
    for k in range(2):
        t = 100 * k * MS
        for name, s, e in (("ac.train.forward", 0, 40), ("ac.encoder", 2, 20),
                           ("ac.sync.gru_lengths", 10, 18),
                           ("ac.ss_loop", 22, 38),
                           ("ac.train.backward", 40, 70),
                           ("ac.train.optimizer", 70, 90),
                           ("ac.sync.finite_check", 72, 75)):
            if spans_on:
                spans.setdefault(name, []).append((t + s * MS, t + e * MS,
                                                   MAIN))
        for j, (host, tid, s, e) in enumerate(((5, MAIN, 6, 9),
                                               (25, MAIN, 26, 27),
                                               (30, OTHER, 30, 31),
                                               (45, AUTOGRAD, 50, 60),
                                               (80, MAIN, 80, 85))):
            corr = 10 * k + j + 1
            launches[corr] = (t + host * MS, tid)
            device.append((t + s * MS, t + e * MS, f"k{j}", corr))
    return Trace(device, launches, spans, {}, 0, 200 * MS)


def caption_trace(spans_on: bool = True):
    """Two entry calls (0-40 and 100-140 ms).  The first holds the
    frontend, the encoder with the GRU's sync (15-24), the memory K/V
    products (25-27, their work at 50-52) and the search (27-30, the
    kernel at 60-65); the second the same without the sync.  A sync
    outside the entry calls (45-48) is the caller's."""
    spans = {"entry": [(0, 40 * MS, MAIN), (100 * MS, 140 * MS, MAIN)]}
    launches, device = {}, []
    if spans_on:
        for t in (0, 100 * MS):
            for name, s, e in (("ac.frontend", 1, 5), ("ac.encoder", 5, 25),
                               ("ac.decode.memory_kv", 25, 27),
                               ("ac.decode.search", 27, 30)):
                spans.setdefault(name, []).append((t + s * MS, t + e * MS,
                                                   MAIN))
        spans["ac.sync.gru_lengths"] = [(15 * MS, 24 * MS, MAIN)]
        spans["ac.sync.decode_batches"] = [(45 * MS, 48 * MS, MAIN)]
    for k, t in enumerate((0, 100 * MS)):
        launches[2 * k + 1] = (t + 26 * MS, MAIN)
        launches[2 * k + 2] = (t + 28 * MS, MAIN)
        device += [(t + 50 * MS, t + 52 * MS, "memkv", 2 * k + 1),
                   (t + 60 * MS, t + 65 * MS, "beam", 2 * k + 2)]
    return Trace(device, launches, spans, {}, 0, 200 * MS)


def test_train_readers():
    tr = train_trace()
    # (8 + 3) ms of sync a step
    assert read("host_sync_ms.train", tr) == pytest.approx(11.0)
    # gaps 9-26 and 27-30 a step; the second ended by another thread's
    # launch while the main thread's loop span was open
    assert read("ss_loop_idle_ms.train", tr) == pytest.approx(20.0)


def test_idle_gaps_follow_the_trace_rule():
    tr = train_trace()
    gaps = program_spans.idle_gaps(tr)
    assert sum(ns for ns, _ in gaps) == pytest.approx(
        (tr.window_s - tr.busy_s) * 1e9)
    assert gaps[-1] == (15 * MS, None)                     # window end
    assert gaps[0] == (6 * MS, (5 * MS, MAIN))


def test_breakdown_takes_the_launching_thread_else_another():
    rows = {r["span"]: r for r in program_spans.breakdown(train_trace(), 2)}
    # the autograd thread's launch at 45 ms falls to the main thread's
    # backward span; the first step's first gap (6 ms) and the second's
    # (85-106 ms) to the encoder
    assert rows["ac.train.backward"]["idle_ms"] == pytest.approx(19.0)
    assert rows["ac.train.backward"]["device_ms"] == pytest.approx(10.0)
    assert rows["ac.encoder"]["idle_ms"] == pytest.approx(13.5)
    assert rows["ac.ss_loop"]["idle_ms"] == pytest.approx(20.0)
    assert rows["ac.ss_loop"]["device_ms"] == pytest.approx(2.0)
    assert rows["ac.train.optimizer"]["idle_ms"] == pytest.approx(20.0)
    assert rows["none"]["idle_ms"] == pytest.approx(7.5)
    assert rows["ac.train.forward"]["count"] == 1.0
    assert rows["ac.train.forward"]["host_ms"] == pytest.approx(40.0)
    # the innermost span: a launch in the loop is not the forward's
    assert rows["ac.train.forward"]["idle_ms"] == 0.0


def test_innermost_prefers_the_launching_threads_own_span():
    spans = {"ac.serve.dispatch": [(0, 10 * MS, MAIN)],
             "ac.serve.resolve": [(2 * MS, 8 * MS, OTHER)]}
    inner = program_spans.Innermost(Trace([], {}, spans, {}, 0, 10 * MS))
    assert inner.at(5 * MS, OTHER) == "ac.serve.resolve"
    assert inner.at(5 * MS, MAIN) == "ac.serve.dispatch"
    assert inner.at(9 * MS, OTHER) == "ac.serve.dispatch"
    assert inner.at(11 * MS, MAIN) is None


def test_caption_readers():
    tr = caption_trace()
    # the GRU's 9 ms inside the first call, none in the second; the
    # caller's sync outside both is not the entry's
    assert read("host_sync_ms.caption", tr) == pytest.approx(4.5)
    # the kernel's 5 ms a search, without the memory K/V products
    assert read("beam_ms.caption", tr) == pytest.approx(5.0)


def test_caption_without_a_sync_reads_zero():
    tr = caption_trace()
    del tr.spans["ac.sync.gru_lengths"]
    assert read("host_sync_ms.caption", tr) == 0.0


def test_a_program_without_spans_reads_nothing():
    assert not program_spans.instrumented(caption_trace(spans_on=False))
    for name in ("host_sync_ms.caption", "beam_ms.caption"):
        assert read(name, caption_trace(spans_on=False)) is None, name
    for name in ("host_sync_ms.train", "ss_loop_idle_ms.train"):
        assert read(name, train_trace(spans_on=False)) is None, name
