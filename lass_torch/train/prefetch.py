"""The trainer's device prefetcher (counterpart of lass_tpu/train/loop.py's
``_DevicePrefetcher``): one producer thread runs ``prepare(i, batch)`` on
each host batch a few batches ahead of the step, so that the upload (and,
in text-only conditioning, the caption embed) of the next batches
overlaps the step on the main thread.

On a card the producer works on its own ``torch.cuda.Stream``: ``prepare``
copies the host batch from pinned memory with ``non_blocking=True`` (see
``upload``) and the producer records an event after its work and hands
the item over without waiting for it (the thread never blocks on the
card). The consumer's stream waits on that event, and every tensor it
takes over is marked as used on the consumer's stream
(``record_stream``), so that the caching allocator does not hand its
memory to the producer's stream while the step still reads it.

``span(key)`` inside ``prepare`` times a part of its work into the
prefetcher's ``timing[key]`` (seconds): on a card, the producer stream's
time between two CUDA events around the part (the host's part of it, and
the part's kernels and copies, with any wait of theirs for the card's
engines while the step runs), read on the consumer's thread once the
events have completed; on the CPU, the producer's wall time of the part.
Only items handed over are counted.

Grad mode, inference mode and autocast are per thread: the producer runs
``prepare`` under ``torch.no_grad`` and sets the card of the prefetcher's
device as its current one. ``prepare`` must run no collective: a
collective on the producer thread would interleave with the step's on the
main thread in another order on each rank. Errors of ``prepare`` or of the
source re-raise from ``__next__``; ``close`` stops and joins the thread.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch


def upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: through pinned memory and a
    non-blocking copy on the current stream on a card, as it is on the
    CPU."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _tensors(item: Any):
    if isinstance(item, torch.Tensor):
        yield item
    elif isinstance(item, dict):
        for v in item.values():
            yield from _tensors(v)
    elif isinstance(item, (list, tuple)):
        for v in item:
            yield from _tensors(v)


DEPTH = 2  # items made ahead of the consumer, as lass_tpu's

# the producer thread's stream and the spans of the item it is making
_producer = threading.local()


@contextlib.contextmanager
def span(key: str):
    """Time the block's work into the prefetcher's ``timing[key]`` (see
    the module docstring); outside a producer thread, nothing."""
    spans = getattr(_producer, "spans", None)
    if spans is None:
        yield
        return
    stream = _producer.stream
    if stream is None:
        t0 = time.perf_counter()
        yield
        spans.append((key, time.perf_counter() - t0))
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    yield
    end.record(stream)
    spans.append((key, (start, end)))


class DevicePrefetcher:
    """An iterator of ``prepare(i, batch)`` over ``source``'s batches, made
    DEPTH items ahead on one producer thread; ``timing`` takes the seconds
    of ``prepare``'s spans."""

    def __init__(self, source: Iterable, prepare: Callable[[int, Any], Any],
                 device: torch.device,
                 timing: Optional[Dict[str, float]] = None):
        self.device = torch.device(device)
        self.timing = timing if timing is not None else {}
        self._spans = []  # (key, (start, end)) handed over, not yet read
        if self.device.type == "cuda" and self.device.index is None:
            # the producer makes this thread's current card its own
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._q: queue.Queue = queue.Queue(maxsize=DEPTH)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._source, self._prepare = source, prepare
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="device-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, i: int, batch):
        _producer.spans = spans = []
        if self._stream is None:
            return self._prepare(i, batch), None, spans
        with torch.cuda.stream(self._stream):
            item = self._prepare(i, batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return item, event, spans

    def _run(self) -> None:
        _producer.stream = self._stream
        try:
            if self._stream is not None:
                torch.cuda.set_device(self.device)
            with torch.no_grad():
                for i, batch in enumerate(self._source):
                    if self._stop.is_set() or not self._put(
                            self._produce(i, batch)):
                        return
        except Exception as exc:  # surfaced at the next __next__
            self._err = exc
        self._put(None)

    def __iter__(self):
        return self

    def __next__(self):
        wrapped = self._q.get()
        if wrapped is None:
            self._q.put(None)  # later calls end too
            if self._err is not None:
                raise RuntimeError("device prefetch failed") from self._err
            raise StopIteration
        item, event, spans = wrapped
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in _tensors(item):
                if t.device.type == "cuda":
                    t.record_stream(stream)
        self._spans += spans
        self._read_spans(wait=False)
        return item

    def _read_spans(self, wait: bool) -> None:
        """Add the spans of the items handed over to ``timing``: those
        whose events have completed, or (``wait``) all of them."""
        pending = []
        for key, t in self._spans:
            if isinstance(t, tuple):  # CUDA events
                start, end = t
                if not (wait or end.query()):
                    pending.append((key, t))
                    continue
                end.synchronize()
                t = start.elapsed_time(end) / 1000.0
            self.timing[key] = self.timing.get(key, 0.0) + t
        self._spans = pending

    def close(self, timeout: float = 30.0) -> None:
        """Stop the producer, drop what it made, join it; the spans of the
        items handed over go to ``timing``."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("device prefetch thread did not stop")
        self._read_spans(wait=True)

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
