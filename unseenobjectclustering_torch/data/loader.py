"""Batching data loader with background prefetch.

A copy of ``unseenobjectclustering_tpu/data/loader.py`` for the port:
a thread-pool prefetcher in place of torch.utils.data.DataLoader(shuffle,
num_workers=4) (the reference's tools/train_net.py:96-99).  Item assembly
is numpy (GIL-releasing); batches are stacked into contiguous numpy
arrays.  The shuffle is RandomState(seed + epoch), the same order as the
device-resident path, so a run can switch between the two on resume.
Under data parallelism (mesh=) each process reads only its rows of each
global batch, in that same order; a sample's augmentation draws belong to
the sample, not to the process, so the ranks' rows together are the one
process's batch.
"""

from __future__ import annotations

import collections
import concurrent.futures as futures
from typing import Any, Iterator, Optional, Sequence

import numpy as np


def stack_samples(samples: Sequence[dict]) -> dict:
    """Stack a list of sample dicts into one batch dict (arrays get a leading
    batch axis; non-array fields become lists)."""
    out: dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        else:
            out[key] = vals
    return out


class DataLoader:
    """Iterates a dataset in shuffled (or sequential) batches with prefetch.

    Args:
      dataset: indexable with __len__ returning sample dicts.
      batch_size: samples per batch.
      shuffle: reshuffle every epoch (seeded; epoch advances the seed).
      num_workers: prefetch threads (0 = synchronous).
      drop_last: drop the trailing partial batch (required for static-shape
        jit and even mesh sharding; default True when shuffle).
      prefetch: number of batches assembled ahead.
      mesh: a parallel.Mesh: batch_size is the global batch (a multiple of
        the world size) and each batch holds this rank's rows of it.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, drop_last: Optional[bool] = None,
                 seed: int = 3, prefetch: int = 2, mesh=None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.num_workers = int(num_workers)
        self.drop_last = drop_last if drop_last is not None else shuffle
        self.seed = seed
        self.prefetch = max(int(prefetch), 1)
        self.epoch = 0
        self.mesh = mesh
        if mesh is not None:
            mesh.batch_slice(self.batch_size)  # raises unless it divides
            if not self.drop_last:
                raise ValueError("a sharded loader drops the trailing "
                                 "partial batch (drop_last=True)")

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle/augmentation epoch (resume support).

        A resumed run (start_epoch > 0) must call this so data order and
        augmentation draws continue from the absolute epoch rather than
        replaying epoch 0 — matching train_epochs_resident's
        RandomState(seed + epoch) scheme.
        """
        self.epoch = int(epoch)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> list[np.ndarray]:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        nb = len(self)
        rows = (slice(None) if self.mesh is None
                else self.mesh.batch_slice(self.batch_size))
        return [idx[i * self.batch_size:(i + 1) * self.batch_size][rows]
                for i in range(nb)]

    def __iter__(self) -> Iterator[dict]:
        batches = self._index_batches()
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.epoch)  # fresh augmentation draws
        self.epoch += 1
        if self.num_workers <= 0:
            for b in batches:
                yield stack_samples([self.dataset[int(i)] for i in b])
            return

        pool = futures.ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            pending: collections.deque = collections.deque()

            def assemble(b):
                return stack_samples([self.dataset[int(i)] for i in b])

            it = iter(batches)
            for _ in range(self.prefetch):
                nb = next(it, None)
                if nb is not None:
                    pending.append(pool.submit(assemble, nb))
            while pending:
                batch = pending.popleft().result()
                nb = next(it, None)
                if nb is not None:
                    pending.append(pool.submit(assemble, nb))
                yield batch
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
