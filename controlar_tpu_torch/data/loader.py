"""Sharded, prefetching data loader: the port's copy of the JAX package's
`data/loader.py` (which imports no JAX).

Host-side: each process reads its shard of indices; a thread pool
prefetches and batches numpy arrays, which the trainer moves to the device
(`train/trainer.Trainer.put_batch`). Deterministic per-epoch shuffling
matches DistributedSampler semantics (seed + epoch).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np


class ShardedLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        process_index: int = 0,
        process_count: int = 1,
        num_workers: int = 4,
        prefetch: int = 4,
        collate: Optional[Callable] = None,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.collate = collate or dataset.make_batch
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.ds)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        # pad to a multiple of world batch (DistributedSampler-style wrap)
        world_batch = self.batch_size * self.process_count
        if self.drop_last:
            idx = idx[: (n // world_batch) * world_batch]
        else:
            pad = (-len(idx)) % world_batch
            idx = np.concatenate([idx, idx[:pad]])
        return idx[self.process_index:: self.process_count]

    def __len__(self):
        return len(self._indices()) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._indices()
        batches = [
            idx[i: i + self.batch_size]
            for i in range(0, len(idx) - self.batch_size + 1, self.batch_size)
        ]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        # single producer thread with internal item parallelism keeps order
        from concurrent.futures import ThreadPoolExecutor

        def producer():
            with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
                for b in batches:
                    if stop.is_set():
                        break
                    items = list(ex.map(lambda i: self.ds[int(i)], b))
                    q.put(self.collate(items))
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item
        finally:
            stop.set()
