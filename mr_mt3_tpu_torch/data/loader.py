"""Threaded prefetching data loader (copy of mr_mt3_tpu/data/loader.py;
the train CLI keeps shard_rank / shard_count at 0 / 1: one card).

Replaces torch DataLoader + collate (reference: train.py:49-60,
dataset/dataset_2_random.py:496-499): items from `batch_size` songs are
concatenated along the row axis into one flat batch. Tokenization is
CPU-bound Python, so a thread pool with per-epoch shuffling and bounded
prefetch keeps the accelerator fed; per-song caches (in the datasets) make
epochs after the first cheap.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List

import numpy as np


def collate_batch(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Concatenate per-song row stacks into one flat batch."""
    items = [it for it in items if it is not None]
    if not items:
        raise ValueError('all items in batch were None')
    keys = items[0].keys()
    return {k: np.concatenate([it[k] for it in items], axis=0) for k in keys}


class DataLoader:
    """Iterates batches of `batch_size` dataset items, prefetched by threads.

    Each epoch reshuffles item order (unless shuffle=False). Failed items
    (None) are dropped; a batch with no valid items is skipped.
    """

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = True,
                 num_workers: int = 4, prefetch: int = 4, seed: int = 0,
                 drop_last: bool = False,
                 shard_rank: int = 0, shard_count: int = 1):
        """shard_rank/shard_count: multihost data sharding — every process
        shuffles the SAME order (same seed) and takes a disjoint stride of
        the batch list, so the global epoch covers each item once. With
        shard_count > 1 a failed item raises instead of shrinking the
        batch: processes must keep identical batch shapes or the global
        array assembly diverges."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.shard_rank = shard_rank
        self.shard_count = max(1, shard_count)
        self._rng = np.random.default_rng(seed)

    def _num_global_batches(self) -> int:
        n = len(self.dataset)
        if self.drop_last or self.shard_count > 1:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __len__(self) -> int:
        n = self._num_global_batches()
        if self.shard_count > 1:
            # every rank gets exactly the same batch count (see _batches)
            return n // self.shard_count
        return n

    def _batches(self) -> List[List[int]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        batches = [order[i:i + self.batch_size].tolist()
                   for i in range(0, len(order), self.batch_size)]
        drop_last = self.drop_last or self.shard_count > 1
        if drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        if self.shard_count > 1:
            # SPMD invariant: every process must execute the same number
            # of identically-shaped train steps, or the gradient
            # all-reduce deadlocks (a rank with an extra batch blocks in
            # a collective the others never enter). So under sharding the
            # global partial batch is always dropped (regardless of
            # drop_last) and the batch list is truncated to a multiple of
            # shard_count before striding — each rank sees exactly
            # len(batches) // shard_count batches, all full-size.
            batches = batches[:len(batches)
                              - len(batches) % self.shard_count]
            batches = batches[self.shard_rank::self.shard_count]
        return batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._batches()
        out_q: 'queue.Queue' = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        expected_rows = [None]  # first batch's row count (sharded mode)

        def put_checking_stop(item) -> bool:
            # never block forever on a full queue: an abandoned iterator
            # (consumer stopped mid-epoch) sets `stop`, and the producer
            # must notice even while waiting for queue space
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            # single producer thread driving a pool keeps batch order
            import concurrent.futures
            try:
                with concurrent.futures.ThreadPoolExecutor(
                        max_workers=self.num_workers) as pool:
                    for batch_ids in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__,
                                              batch_ids))
                        kept = [it for it in items if it is not None]
                        if self.shard_count > 1 and len(kept) != len(items):
                            # a silently shrunk batch would desync the
                            # global array shapes across processes
                            raise RuntimeError(
                                f'{len(items) - len(kept)} dataset item(s) '
                                'failed under multihost sharding')
                        batch = collate_batch(kept) if kept else None
                        if batch is not None and self.shard_count > 1:
                            # beyond failed items, a song with fewer
                            # windows than num_rows_per_batch also yields
                            # fewer ROWS (reference parity,
                            # dataset_2_random.py:395-400) — under SPMD
                            # that means divergent global shapes and a
                            # collective hang on the OTHER ranks, so
                            # fail fast here with the offending batch
                            rows = next(iter(batch.values())).shape[0]
                            if expected_rows[0] is None:
                                expected_rows[0] = rows
                            elif rows != expected_rows[0]:
                                raise RuntimeError(
                                    f'batch of {rows} rows != first '
                                    f'batch of {expected_rows[0]} under '
                                    'multihost sharding (a short song? '
                                    'every process must contribute '
                                    'identical shapes each step — drop '
                                    'songs shorter than '
                                    'num_rows_per_batch windows)')
                        if not put_checking_stop(batch):
                            return
            except BaseException as e:  # forward to the consumer
                put_checking_stop(e)
                return
            put_checking_stop(StopIteration)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is StopIteration:
                    return
                if isinstance(item, BaseException):
                    raise item
                if item is not None:
                    yield item
        finally:
            stop.set()
