"""Host input pipeline (counterpart of lass_tpu/data/datamodule.py):
shuffled epochs, decoding on a thread pool, safe collate, and a
background producer thread a few batches ahead.

Each epoch's order is ``np.random.default_rng(seed + epoch)``'s shuffle
and each clip's crop draws from ``np.random.default_rng((seed, epoch,
index))``, the same numpy calls as the JAX package, so both order and
crop batches identically for one seed. Items that fail to load are
skipped and the batch is topped up from the rest of the epoch, so every
batch is full.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np


def collate(items: List[Dict]) -> Dict:
    """Non-None dataset items -> {'audio_text': {'text': [...], 'waveform':
    (B, 1, L), 'modality', 'original_audiopath': [...]}}."""
    out = {
        "text": [it["text"] for it in items],
        "waveform": np.stack([it["waveform"] for it in items]),
        "modality": "audio_text",
        "original_audiopath": [it["original_audiopath"] for it in items],
    }
    return {"audio_text": out}


class DataModule:
    def __init__(self, train_dataset, batch_size: int, num_workers: int = 8,
                 seed: int = 1234, prefetch: int = 4):
        self.train_dataset = train_dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + epoch)
        idx = np.arange(len(self.train_dataset))
        rng.shuffle(idx)
        return idx

    def _iter_batches(self, skip_batches: int = 0) -> Iterator[Dict]:
        epoch = 0
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            while True:
                indices = self._epoch_indices(epoch)
                n = len(indices)
                # resume fast-forward: skip whole batches without decoding
                # (exact unless items were dropped in the skipped region)
                per_epoch = n // self.batch_size
                if per_epoch == 0:
                    raise ValueError(f"{n} clips cannot fill a batch of "
                                     f"{self.batch_size}")
                if skip_batches >= per_epoch:
                    skip_batches -= per_epoch
                    epoch += 1
                    continue
                cursor = skip_batches * self.batch_size
                skip_batches = 0

                def fetch(i, epoch=epoch):
                    return self.train_dataset.__getitem__(
                        int(i), rng=np.random.default_rng(
                            (self.seed, epoch, int(i))))

                while cursor + self.batch_size <= n:
                    want = indices[cursor:cursor + self.batch_size]
                    cursor += self.batch_size
                    items = [r for r in pool.map(fetch, want)
                             if r is not None]
                    while len(items) < self.batch_size and cursor < n:
                        extra = fetch(indices[cursor])
                        cursor += 1
                        if extra is not None:
                            items.append(extra)
                    if len(items) == self.batch_size:
                        yield collate(items)
                epoch += 1
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    def train_dataloader(self, skip_batches: int = 0) -> "BatchLoader":
        """Infinite batch iterator fed by a producer thread; close() it
        (or use it as a context manager) to stop and join the thread.
        skip_batches fast-forwards past already-trained steps on resume."""
        return BatchLoader(self._iter_batches(skip_batches), self.prefetch)


class BatchLoader:
    """Runs a batch generator on a daemon thread, ``depth`` batches ahead.
    Errors of the producer re-raise from ``__next__``."""

    def __init__(self, source: Iterator[Dict], depth: int):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._err = None
        self._source = source
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="batch-loader")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        try:
            for batch in self._source:
                if not self._put((batch,)):
                    break
        except Exception as exc:  # surfaced at the next __next__
            self._err = exc
        finally:
            self._source.close()
            self._put(None)

    def __iter__(self):
        return self

    def __next__(self) -> Dict:
        item = self._q.get()
        if item is None:
            self._q.put(None)  # later calls end too
            if self._err is not None:
                raise RuntimeError("batch loader failed") from self._err
            raise StopIteration
        return item[0]

    def close(self, timeout: float = 30.0) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("batch loader thread did not stop")

    def __enter__(self) -> "BatchLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
