"""Threaded prefetching data loader.

Counterpart of `preworld_tpu/data/loader.py`. The reference uses torch's
DataLoader with 2 worker processes per GPU (`apis/train.py:207-219`).
Here a thread pool decodes and augments samples (PIL and numpy release the
GIL for the heavy parts) and a bounded queue prefetches collated numpy
batches; the train loop and the evaluation move them to the model's
device.

Multi-process: `process_index` / `process_count` shard every GLOBAL batch
by rank-striding its indices (the DistributedSampler analog, reference
`apis/train.py:207-219`): each process loads batch_size / process_count
samples. All processes draw the same seeded permutation, so the global
batch composition is identical to a single-process run.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Sequence

import numpy as np


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    out = {}
    for k in samples[0]:
        out[k] = np.stack([s[k] for s in samples], axis=0)
    return out


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 4,
        prefetch: int = 2,
        drop_last: bool = True,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
    ):
        assert batch_size % process_count == 0, (batch_size, process_count)
        assert 0 <= process_index < process_count
        # a trailing partial batch would stride unevenly across hosts
        assert process_count == 1 or drop_last, "multi-host requires drop_last"
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0

    @property
    def local_batch_size(self) -> int:
        return self.batch_size // self.process_count

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        if self.drop_last:
            idx = idx[: len(self) * self.batch_size]
        return idx

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._indices()
        batches = [
            idx[i : i + self.batch_size][self.process_index :: self.process_count]
            for i in range(0, len(idx), self.batch_size)
        ]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put(item) -> bool:
            """Bounded put that keeps checking the stop event: an abandoned
            consumer (early break from the batch loop) must not park this
            thread in q.put() forever."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # dataset errors (corrupt file, missing npz) are shipped to the
            # consumer and re-raised there — a dead producer that never
            # enqueues its sentinel would block the train loop forever
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__, b))
                        if not _put(collate(samples)):
                            return
                _put(None)
            except BaseException as e:  # noqa: BLE001 - forwarded, not hidden
                _put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain one slot so a producer blocked in _put can observe stop
            try:
                q.get_nowait()
            except queue.Empty:
                pass
