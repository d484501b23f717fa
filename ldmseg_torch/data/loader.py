"""A plain single-process loader (the port's counterpart of
``ldmseg_tpu/data/loader.py:Loader``, without its threads and process
sharding): a per-epoch seeded shuffle (``shuffle``), then ``collate`` of
``batch_size`` samples at a time; the last partial batch is dropped, or
yielded short with ``drop_last=False``. Nothing runs ahead of the consumer,
so an epoch that is left part-way leaves nothing behind."""

from __future__ import annotations

from typing import Iterator

import numpy as np

from .collate import collate


class Loader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed

    def indices(self, epoch: int) -> np.ndarray:
        """The epoch's sample order: the JAX loader's per-epoch shuffle, or
        the dataset's own order without ``shuffle``."""
        idx = np.arange(len(self.ds))
        if self.shuffle:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch]))
            rng.shuffle(idx)
        return idx

    def __len__(self) -> int:
        if self.drop_last:
            return len(self.ds) // self.batch_size
        return -(-len(self.ds) // self.batch_size)

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        idx = self.indices(epoch)
        for i in range(len(self)):
            chunk = idx[i * self.batch_size:(i + 1) * self.batch_size]
            yield collate([self.ds.__getitem__(int(j), epoch=epoch)
                           for j in chunk])

    def __iter__(self) -> Iterator[dict]:
        return self.epoch(0)
