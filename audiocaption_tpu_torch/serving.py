"""Micro-batching serve loop (counterpart of ``audiocaption_tpu/serving.py``).

``MicroBatchServer`` batches single-clip caption requests into one
decode per batch:

* a **collector** thread gathers submitted clips until ``max_batch``
  requests wait or the oldest has waited ``max_wait_ms``, pads them to
  one shape (bucketed batch sizes) and dispatches one batched decode;
* dispatch is asynchronous (CUDA launches return before the card
  finishes), so the collector goes back to gathering while the card
  works;
* a **resolver** thread moves each result to the host (``.cpu()``, which
  waits for the card) and fans the token rows back to per-request
  futures, in submission order;
* at most ``max_inflight`` batches are outstanding.  While every slot is
  busy the collector keeps absorbing arrivals into the current batch, so
  batch size grows with load.

Backpressure: ``submit`` blocks once ``max_queue`` clips are waiting.

Wire formats shrink the waveform on the submitting thread; the decode
side dequantizes on the device: ``"f32"`` (4 B/sample, lossless),
``"f16"`` (2 B), ``"i16"`` (2 B, lossless for 16-bit PCM), ``"mulaw"``
(1 B, G.711 mu-law).  Wrap the decode with :func:`wire_decoder`.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from audiocaption_tpu_torch.device import DeviceLike, resolve_device

__all__ = ["MicroBatchServer", "encode_wire", "decode_wire_device",
           "wire_dtype", "wire_decoder"]

WIRE_FORMATS = ("f32", "f16", "i16", "mulaw")
_MU = 255.0


def wire_dtype(wire: str) -> np.dtype:
    """Numpy dtype a wire format travels as."""
    return {"f32": np.dtype(np.float32), "f16": np.dtype(np.float16),
            "i16": np.dtype(np.int16), "mulaw": np.dtype(np.uint8)}[wire]


def encode_wire(wav: np.ndarray, wire: str) -> np.ndarray:
    """Host side: one float waveform (about [-1, 1]) -> its wire format.
    int16 input passes through unscaled on the ``i16`` wire."""
    if wire == "f32":
        return np.asarray(wav, np.float32)
    if wire == "f16":
        return np.asarray(wav, np.float16)
    if wire == "i16":
        if np.asarray(wav).dtype == np.int16:
            return np.asarray(wav)
        x = np.clip(np.asarray(wav, np.float32), -1.0, 1.0)
        return np.round(x * 32767.0).astype(np.int16)
    if wire == "mulaw":
        x = np.clip(np.asarray(wav, np.float32), -1.0, 1.0)
        y = np.sign(x) * np.log1p(_MU * np.abs(x)) / np.log1p(_MU)
        return np.round((y + 1.0) * 127.5).astype(np.uint8)
    raise ValueError(f"unknown wire format {wire!r}; "
                     f"expected one of {WIRE_FORMATS}")


def decode_wire_device(wav: torch.Tensor, wire: str) -> torch.Tensor:
    """Device side: wire-format tensor -> float32 waveform."""
    if wire in ("f32", "f16"):
        return wav.float()
    if wire == "i16":
        return wav.float() / 32768.0
    if wire == "mulaw":
        y = wav.float() / 127.5 - 1.0
        return torch.sign(y) * (torch.expm1(y.abs() * float(np.log1p(_MU)))
                                / _MU)
    raise ValueError(f"unknown wire format {wire!r}")


def wire_decoder(decode_fn: Callable, wire: str = "f32",
                 device: DeviceLike = "cuda") -> Callable:
    """Wrap ``decode_fn(wav_f32 [B, T], lens [B])`` (device tensors in,
    device token ids out, e.g. ``Effb2TrmCaptioningModel.decode``) so it
    takes the server's numpy wire batch: the batch is copied to
    ``device`` in its wire dtype and dequantized there."""
    if wire not in WIRE_FORMATS:
        raise ValueError(f"unknown wire format {wire!r}")
    dev = resolve_device(device)

    def wrapped(wav: np.ndarray, lens: np.ndarray):
        w = torch.from_numpy(np.ascontiguousarray(wav)).to(dev, non_blocking=True)
        n = torch.from_numpy(np.asarray(lens, np.int64)).to(dev)
        return decode_fn(decode_wire_device(w, wire), n)
    return wrapped


def _default_buckets(max_batch: int) -> Tuple[int, ...]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 4
    out.append(max_batch)
    return tuple(out)


def _to_host(out) -> np.ndarray:
    """Result -> numpy; for a CUDA tensor this waits for the card."""
    if torch.is_tensor(out):
        return out.cpu().numpy()
    return np.asarray(out)


class MicroBatchServer:
    """Batch single-clip caption requests into batched decodes.

    Parameters
    ----------
    decode_fn:
        ``decode_fn(wav [B, T] wire dtype, wav_len [B] int32) -> tokens``,
        typically ``wire_decoder(model.decode, wire)``.  Must accept every
        bucketed batch size; the result is a tensor (CUDA or CPU) or
        anything ``np.asarray`` takes.
    max_batch:
        largest dispatch batch.
    max_wait_ms:
        latency budget a lone request spends waiting for company.
    max_samples:
        waveform length every clip is padded or cropped to.
    batch_buckets:
        dispatch batch sizes.  Default: 1, 4, 16, 64, ..., max_batch.
    max_queue:
        bound on clips waiting for dispatch (backpressure).
    wire:
        waveform wire format (module docstring).
    max_inflight:
        outstanding-dispatch window; 1 serializes.
    """

    def __init__(self, decode_fn: Callable, *, max_batch: int = 128,
                 max_wait_ms: float = 5.0, max_samples: int = 160000,
                 batch_buckets: Optional[Sequence[int]] = None,
                 max_queue: int = 4096, wire: str = "f32",
                 max_inflight: int = 2):
        self._decode = decode_fn
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1e3
        self.max_samples = int(max_samples)
        if wire not in WIRE_FORMATS:
            raise ValueError(f"unknown wire format {wire!r}; "
                             f"expected one of {WIRE_FORMATS}")
        self.wire = wire
        self._wire_np = wire_dtype(wire)
        self.buckets = tuple(sorted(set(
            batch_buckets or _default_buckets(self.max_batch))))
        assert self.buckets[-1] == self.max_batch
        self.dispatched_batches = 0
        # wire encoding of silence (mulaw's zero is not the zero byte)
        self._pad = encode_wire(np.zeros(1, np.float32), self.wire)[0]
        self._pending: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._inflight: "queue.Queue" = queue.Queue()
        self._slots = threading.BoundedSemaphore(int(max_inflight))
        self._stop = threading.Event()
        self._collector = threading.Thread(
            target=self._collect_loop, name="serve-collect", daemon=True)
        self._resolver = threading.Thread(
            target=self._resolve_loop, name="serve-resolve", daemon=True)
        self._collector.start()
        self._resolver.start()

    # ------------------------------------------------------------- API
    def submit(self, wav: np.ndarray) -> Future:
        """Enqueue one clip; returns a Future of its token row."""
        fut: Future = Future()
        wav = encode_wire(np.asarray(wav).ravel(), self.wire)
        self._pending.put((wav, fut))
        return fut

    def stop(self, timeout: float = 30.0) -> None:
        """Drain in-flight work and stop the threads."""
        self._stop.set()
        self._collector.join(timeout)
        self._inflight.put(None)
        self._resolver.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # ----------------------------------------------------------- loops
    def _collect_loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._pending.get(timeout=0.05)
            except queue.Empty:
                continue
            batch: List[Tuple[np.ndarray, Future]] = [first]
            deadline = time.perf_counter() + self.max_wait
            while len(batch) < self.max_batch:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    batch.append(self._pending.get(timeout=left))
                except queue.Empty:
                    break
            while not self._slots.acquire(timeout=0.002):
                while len(batch) < self.max_batch:
                    try:
                        batch.append(self._pending.get_nowait())
                    except queue.Empty:
                        break
            self._dispatch(batch)
        leftover: List[Tuple[np.ndarray, Future]] = []
        while True:
            try:
                leftover.append(self._pending.get_nowait())
            except queue.Empty:
                break
        for i in range(0, len(leftover), self.max_batch):
            self._slots.acquire()
            self._dispatch(leftover[i:i + self.max_batch])

    def _dispatch(self, batch: List[Tuple[np.ndarray, Future]]) -> None:
        """Dispatch one batch.  Caller holds a ``_slots`` permit; the
        resolver releases it (or this method, on a dispatch error)."""
        n = len(batch)
        bucket = next(b for b in self.buckets if b >= n)
        wav = np.full((bucket, self.max_samples), self._pad, self._wire_np)
        lens = np.ones(bucket, np.int32)
        for i, (w, _) in enumerate(batch):
            w = w[:self.max_samples]
            wav[i, :w.shape[0]] = w
            lens[i] = max(1, w.shape[0])
        try:
            out = self._decode(wav, lens)
        except Exception as e:              # resolve errors per request
            self._slots.release()
            for _, fut in batch:
                fut.set_exception(e)
            return
        self.dispatched_batches += 1
        self._inflight.put((out, [f for _, f in batch]))

    def _resolve_loop(self) -> None:
        while True:
            item = self._inflight.get()
            if item is None:
                return
            out, futs = item
            try:
                tokens = _to_host(out)
            except Exception as e:
                self._slots.release()
                for fut in futs:
                    fut.set_exception(e)
                continue
            self._slots.release()
            for i, fut in enumerate(futs):
                fut.set_result(tokens[i])
