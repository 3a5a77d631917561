"""Shuffled, prefetching batch loader (the port's copy of
gan3d_tpu/data/loader.py, without the device prefetcher).

Replaces the reference's ``DataLoader(batch_size, shuffle=True,
num_workers=4, drop_last=True)`` + ``inf_train_gen`` infinite wrapper
(reference: trainer.py:84, 95-98). Batches are assembled by a thread pool
(npz decompression releases the GIL inside zlib) and prefetched ahead of the
training step so host IO overlaps device compute. ``drop_last=False`` (the
tournament's and the calibration's pass) also yields the last partial
batch.

Yields float32 arrays of shape [B, D, H, W] in [-1, 1]; the trainer prepends
the channel axis (NCDHW), as the reference does at trainer.py:300.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

PREFETCH = 2  # batches assembled ahead of the consumer


class Loader:
    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 shuffle: bool = True, drop_last: bool = True,
                 num_workers: int = 4):
        if drop_last and len(dataset) < batch_size:
            raise ValueError(f"{len(dataset)} samples make no batch of "
                             f"{batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.num_workers = max(1, num_workers)
        self._stops: list = []  # stop events of live infinite() producers

    def _epoch_indices(self) -> np.ndarray:
        """An epoch's sample order, cut to whole batches with drop_last."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        if self.drop_last:
            idx = idx[:(len(idx) // self.batch_size) * self.batch_size]
        return idx

    def __iter__(self) -> Iterator[np.ndarray]:
        """One epoch (the evaluation CLIs' pass,
        gan3d_tpu/data/loader.py:53-60)."""
        idx = self._epoch_indices()
        for i in range(0, len(idx), self.batch_size):
            yield self.dataset.batch(idx[i:i + self.batch_size])

    def __len__(self) -> int:
        n, b = len(self.dataset), self.batch_size
        return n // b if self.drop_last else -(-n // b)

    def infinite(self) -> Iterator[np.ndarray]:
        """Infinite shuffled batches with background prefetch.

        Equivalent of the reference's inf_train_gen (trainer.py:95-98), with
        an explicit prefetch queue instead of worker processes. The producer
        thread exits promptly once the consumer stops (generator .close(),
        GC, or Loader.close()): every blocking queue operation is bounded by
        a timeout + stop-flag check, so no thread or queue is leaked when a
        Trainer is constructed repeatedly in one process.
        """
        q: "queue.Queue[np.ndarray]" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()
        self._stops = [s for s in self._stops if not s.is_set()]
        self._stops.append(stop)

        def _put(item) -> bool:
            """Bounded put: returns False if stopped while waiting."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            pool = ThreadPoolExecutor(max_workers=self.num_workers)
            try:
                while not stop.is_set():
                    idx = self._epoch_indices()
                    batches = [
                        idx[i : i + self.batch_size]
                        for i in range(0, len(idx), self.batch_size)
                    ]
                    for fut in [pool.submit(self.dataset.batch, b) for b in batches]:
                        if not _put(fut.result()):
                            return
            finally:
                pool.shutdown(wait=False)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                try:
                    item = q.get(timeout=5.0)
                except queue.Empty:
                    if not t.is_alive():
                        raise RuntimeError("Loader producer thread died")
                    continue
                yield item
        finally:
            stop.set()

    def close(self) -> None:
        """Stop all producer threads started by infinite()."""
        for s in self._stops:
            s.set()
        self._stops.clear()
