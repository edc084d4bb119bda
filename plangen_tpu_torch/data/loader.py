"""Batch iteration: per-flow loaders + min-size multi-flow combination.

A copy of `plangen_tpu/data/loader.py`, which the port cannot import:
`plangen_tpu/data/__init__.py` imports `preprocess.py`, which imports jax.
tests/test_torch_data.py holds the two copies' batches equal.


Replaces the reference's torch DataLoader + Lightning `CombinedLoader
(mode="min_size")` (plangen_base.py:1040) with a numpy batcher:
shuffled epoch order per flow, one dict of flow batches per step, epoch ends
when the SHORTEST flow is exhausted (min_size semantics). Data-parallel
sharding happens downstream by device_put with a NamedSharding — each batch
is globally sized (per-flow batch_size x dp) like the reference's per-process
loaders combined.

Async input (the torch `num_workers` role): `BatchLoader(workers=N)` fetches
a batch's samples through a thread pool, and `PrefetchLoader` keeps a bounded
queue of ready batches filled by a producer thread, hiding host input time
behind the device step. Threads (not processes): PIL decode and the native
C++ resize (native/plangen_data.cc) release the GIL, so a pool captures most
of the multiprocess win with none of the pickling constraints.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np


class BatchLoader:
    """Shuffling epoch iterator yielding lists of samples."""

    def __init__(
        self,
        dataset: Any,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        workers: int = 0,  # >0: fetch each batch's samples via a thread pool
        # multi-host data parallelism (reference: torch DistributedSampler):
        # process `shard_id` of `num_shards` iterates a disjoint stride of the
        # SAME shuffled epoch order, so the union of all processes' batches is
        # the global batch and epochs stay aligned across hosts
        num_shards: int = 1,
        shard_id: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.workers = workers
        assert 0 <= shard_id < num_shards
        self.num_shards = num_shards
        self.shard_id = shard_id
        self._epoch = 0
        self._pool = None
        if workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="plangen-data"
            )

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _fetch(self, idxs) -> List[Any]:
        if self._pool is not None:
            return list(self._pool.map(self.dataset.__getitem__, idxs))
        return [self.dataset[int(i)] for i in idxs]

    def __iter__(self) -> Iterator[List[Any]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self._epoch)
            rng.shuffle(order)
        self._epoch += 1
        if self.num_shards > 1:
            # strided shard of the shared order; truncate so every shard
            # yields the same number of batches (keeps hosts in lockstep)
            order = order[self.shard_id :: self.num_shards]
            order = order[: len(self.dataset) // self.num_shards]
        n = len(order)
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for s in range(0, end, self.batch_size):
            yield self._fetch([int(i) for i in order[s : s + self.batch_size]])


class CombinedLoader:
    """min_size combination of several flow loaders: yields
    {flow_id: batch} until the shortest flow is exhausted."""

    def __init__(self, loaders: Dict[int, BatchLoader]):
        self.loaders = loaders

    def __len__(self):
        return min(len(l) for l in self.loaders.values())

    def __iter__(self):
        iters = {fid: iter(l) for fid, l in self.loaders.items()}
        while True:
            out = {}
            try:
                for fid, it in iters.items():
                    out[fid] = next(it)
            except StopIteration:
                return
            yield out


class PrefetchLoader:
    """Bounded-queue batch prefetch: a producer thread iterates the wrapped
    loader ahead of the consumer by up to `depth` batches, so host-side
    sample loading overlaps the device step (the reference gets this from
    torch DataLoader worker prefetch). Yields exactly the wrapped loader's
    batches in order; producer exceptions re-raise in the consumer."""

    _END = object()

    def __init__(self, loader: Any, depth: int = 2):
        self.loader = loader
        self.depth = max(1, depth)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        err: List[BaseException] = []

        def produce():
            try:
                for batch in self.loader:
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # propagate to the consumer
                err.append(e)
            finally:
                while not stop.is_set():
                    try:
                        q.put(self._END, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=produce, daemon=True, name="plangen-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._END:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()


def infinite(loader) -> Iterator:
    """Endless epochs (the reference steps a fixed max_train_steps)."""
    while True:
        yield from loader
