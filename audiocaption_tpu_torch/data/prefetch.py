"""Background prefetch to the device (counterpart of
``audiocaption_tpu/data/prefetch.py``).

A worker thread takes the source's batches in order, runs ``transform``
(host-side preparation), then ``transfer`` (the copy to the device), and
keeps up to ``depth`` batches ahead of the consumer, so that the next
batch's loading and copy overlap the device's work on this one.

The default transfer copies every numeric array of a batch dict (numpy
arrays and host tensors; ids, strings and tensors already on a device
pass through) to the device.  On
CUDA it copies from pinned memory with ``non_blocking=True`` on a side
stream and records an event after the copies; the consumer's stream
waits on that event before the batch is handed out (and each tensor is
recorded on the consumer's stream, so that the allocator does not reuse
its memory while the consumer's kernels read it), and the worker keeps
the pinned host copies alive until the event has completed.  On the CPU
the arrays become tensors, without a copy.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

_DONE = object()


class _WorkerError:
    """An exception of the worker thread, re-raised in the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _numeric(v) -> bool:
    return (torch.is_tensor(v) or
            (isinstance(v, np.ndarray) and v.dtype.kind in "biuf"))


class _CudaTransfer:
    """The default transfer to a CUDA device (see the module docstring):
    ``__call__`` on the worker thread -> (batch on the device, event)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.in_flight = collections.deque()    # (event, pinned host copies)

    def __call__(self, batch: dict):
        while self.in_flight and self.in_flight[0][0].query():
            self.in_flight.popleft()
        out, hosts = {}, []
        with torch.cuda.stream(self.stream):
            for k, v in batch.items():
                if _numeric(v) and torch.as_tensor(v).device.type == "cpu":
                    host = torch.as_tensor(v).pin_memory()
                    out[k] = host.to(self.device, non_blocking=True)
                    hosts.append(host)
                else:
                    out[k] = v          # ids, strings, device tensors
            event = torch.cuda.Event()
            event.record(self.stream)
        self.in_flight.append((event, hosts))
        return out, event


def _cpu_transfer(batch: dict):
    return {k: torch.as_tensor(v) if _numeric(v) else v
            for k, v in batch.items()}, None


def _hand_over(batch: dict, event, device: torch.device) -> dict:
    """The consumer's side of a CUDA transfer: its stream waits on the
    copies, and each tensor is recorded on it."""
    if event is None:
        return batch
    stream = torch.cuda.current_stream(device)
    stream.wait_event(event)
    for v in batch.values():
        if torch.is_tensor(v) and v.device.type == "cuda":
            v.record_stream(stream)
    return batch


def prefetch_to_device(source: Iterable, device: torch.device,
                       transform: Optional[Callable[[Any], Any]] = None,
                       transfer: Optional[Callable[[dict], dict]] = None,
                       depth: int = 2) -> Iterator:
    """Iterate ``source`` on a worker thread, up to ``depth`` batches on
    ``device`` ahead of the consumer.  Per batch the worker applies
    ``transform``, then ``transfer`` (a dict -> its device copy; the
    default is the module docstring's).  A tuple of dicts (the aug
    runner's ``(real, aug)`` pairs) is transferred element by element.
    Batches come in the source's order; an exception of the worker is
    re-raised here, where its batch would have come.  A consumer that
    stops early (``break``, an exception, the generator closed) stops the
    worker: it never blocks on a full queue for good, and is a daemon."""
    device = torch.device(device)
    if transfer is not None:
        xfer = lambda b: (transfer(b), None)     # noqa: E731
    elif device.type == "cuda":
        xfer = _CudaTransfer(device)
    else:
        xfer = _cpu_transfer

    def apply(b):
        if transform is not None:
            b = transform(b)
        if isinstance(b, tuple):
            return tuple(xfer(x) for x in b)
        return xfer(b)

    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in source:
                if not put(apply(b)):
                    return
        except BaseException as exc:      # noqa: BLE001 (re-raised below)
            put(_WorkerError(exc))
            return
        put(_DONE)

    thread = threading.Thread(target=worker, daemon=True,
                              name="prefetch_to_device")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, _WorkerError):
                raise item.exc
            if isinstance(item, tuple) and isinstance(item[0], tuple):
                yield tuple(_hand_over(b, e, device) for b, e in item)
            else:
                yield _hand_over(item[0], item[1], device)
    finally:
        stop.set()
