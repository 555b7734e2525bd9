"""Threaded prefetching data loader.

Sample loading is numpy I/O + light math that releases the GIL, so a
thread pool gives worker parallelism without process-spawn overhead and
without pickling batches. Under a process group each data index loads
its slice of every global batch; the spatial ranks of one data index
load the same samples (each keeps its lat band on the device).
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch.distributed as dist

from py4cast_tpu_torch.datasets.base import ItemBatch, collate_fn

_STOP = object()


class DataLoader:
    """Iterable over ItemBatches with background prefetch.

    Each epoch re-shuffles when ``shuffle`` (seeded, epoch-salted).
    ``drop_last`` keeps batch shapes equal across the epoch. Inference
    loaders use ``drop_last=False, pad_last=True``: the final short batch
    is padded to ``batch_size`` by repeating its last sample and
    ``ItemBatch.num_valid`` marks the real row count of the global batch.
    """

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        num_workers: int = 2,
        shuffle: bool = False,
        prefetch: int = 2,
        seed: int = 0,
        drop_last: bool = True,
        pad_last: bool = False,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        """``batch_size`` is the GLOBAL batch. Data index ``process_index``
        of ``process_count`` loads only its ``batch_size / process_count``
        rows of every batch; the seeded shuffle is the same on every rank,
        so the slices are disjoint. Both default to the process group's
        rank and world size (0 and 1 without one); under spatial > 1 pass
        the mesh's ``data_index`` and ``data``, as ``Trainer`` does."""
        if process_count is None:
            group = dist.is_available() and dist.is_initialized()
            process_count = dist.get_world_size() if group else 1
            process_index = dist.get_rank() if group else 0
        elif process_index is None:
            process_index = 0
        if batch_size % process_count:
            raise ValueError(
                f"Global batch size {batch_size} is not divisible by the "
                f"process count ({process_count})"
            )
        self.dataset = dataset
        self.batch_size = batch_size
        self.process_index = process_index
        self.process_count = process_count
        self.local_batch_size = batch_size // process_count
        self.num_workers = max(1, num_workers)
        self.shuffle = shuffle
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self.drop_last = drop_last
        self.pad_last = pad_last
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self) -> List[Tuple[np.ndarray, int]]:
        """Per batch: (THIS rank's sample indices, number of REAL samples
        in the GLOBAL batch)."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            # the same global order on every rank: disjoint slices
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        out = []
        lo = self.process_index * self.local_batch_size
        for i in range(len(self)):
            b = idx[i * self.batch_size : (i + 1) * self.batch_size]
            nv = len(b)
            if self.pad_last and nv < self.batch_size:
                b = np.concatenate([b, np.full(self.batch_size - nv, b[-1], b.dtype)])
            local = b[lo : lo + self.local_batch_size]
            if len(local) == 0:
                continue  # a short unpadded tail wholly on earlier ranks
            out.append((local, nv))
        return out

    def __iter__(self) -> Iterator[ItemBatch]:
        batches = self._batch_indices()
        self._epoch += 1
        if not batches:
            return iter(())
        return _PrefetchIterator(self, batches)


class _ProducerState:
    """Everything the producer thread touches, kept apart from the
    consumer-facing iterator so that dropping the iterator garbage-collects
    it and shuts the producer down."""

    def __init__(self, loader: DataLoader, batches: List[Tuple[np.ndarray, int]]):
        self.loader = loader
        self.batches = batches
        self.out: "queue.Queue" = queue.Queue(maxsize=loader.prefetch)
        self.pool = ThreadPoolExecutor(max_workers=loader.num_workers)
        self.error: Optional[BaseException] = None
        self._closed = threading.Event()
        self.thread = threading.Thread(target=self._producer, daemon=True)
        self.thread.start()

    def _put(self, item) -> bool:
        """Blocking put that gives up once the iterator is closed."""
        while not self._closed.is_set():
            try:
                self.out.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _collate(self, entry) -> ItemBatch:
        futures, num_valid = entry
        return collate_fn(
            [f.result() for f in futures],
            num_valid=None if num_valid == self.loader.batch_size else num_valid,
        )

    def _producer(self):
        window = self.loader.prefetch + self.loader.num_workers
        in_flight: deque = deque()  # one entry per batch: list of futures
        dataset = self.loader.dataset
        try:
            for indices, num_valid in self.batches:
                if self._closed.is_set():
                    break
                # per-sample futures: workers parallelize inside a batch too
                in_flight.append(
                    ([self.pool.submit(dataset.__getitem__, int(i)) for i in indices],
                     num_valid)
                )
                # submission order == consumption order: deterministic
                if len(in_flight) >= window and not self._put(
                    self._collate(in_flight.popleft())
                ):
                    break
            while in_flight and not self._closed.is_set():
                if not self._put(self._collate(in_flight.popleft())):
                    break
        except BaseException as e:  # handed to the consumer, re-raised there
            self.error = e
        finally:
            for futures, _ in in_flight:
                for fut in futures:
                    fut.cancel()
            self._put(_STOP)
            self.pool.shutdown(wait=False)

    def close(self):
        """Stop the producer and release the worker pool."""
        self._closed.set()
        # drain so a producer blocked on put() drops its reference
        try:
            while True:
                self.out.get_nowait()
        except queue.Empty:
            pass

    def next(self) -> ItemBatch:
        while True:
            try:
                item = self.out.get(timeout=0.5)
                break
            except queue.Empty:
                if self._closed.is_set() or not self.thread.is_alive():
                    if self.error is not None:
                        raise self.error
                    raise StopIteration
        if item is _STOP:
            if self.error is not None:
                raise self.error
            raise StopIteration
        return item


class _PrefetchIterator:
    """Ordered prefetch with a bounded in-flight window of
    ``prefetch + num_workers`` batches. An abandoned iterator shuts its
    producer down through ``close()``, called explicitly or from
    ``__del__``."""

    def __init__(self, loader: DataLoader, batches: List[Tuple[np.ndarray, int]]):
        self._state = _ProducerState(loader, batches)

    def close(self):
        self._state.close()

    def __del__(self):  # abandoned mid-epoch
        self.close()

    def __iter__(self):
        return self

    def __next__(self) -> ItemBatch:
        return self._state.next()
