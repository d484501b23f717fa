"""A threaded, prefetching loader (the port's counterpart of
``ldmseg_tpu/data/loader.py:Loader`` and ``make_loader``).

A per-epoch seeded shuffle (``shuffle``), padded so that every one of
``num_shards`` shards sees the same count (``DistributedSampler``'s
padding; ``pad=False`` leaves it out, so that an evaluation counts each
sample once) and cut to ``shard_id``'s share, then ``collate`` of
``batch_size`` samples at a time; the last partial batch is dropped, or
yielded short with ``drop_last=False``. ``num_threads`` workers (default
min(8, cores)) decode batches ahead of the consumer, at most ``prefetch +
num_threads`` batches ahead; batches come out in order, and an exception in
a worker is raised in the consumer. When the epoch's generator is closed
or collected, or the loader's :meth:`Loader.close` is called, the workers
stop and are joined: an epoch left part-way leaves no thread behind (the
JAX loader's workers live on there).
"""

from __future__ import annotations

import os
import queue
import threading
import weakref
from typing import Iterator, Optional

import numpy as np

from .collate import collate


class _Epoch:
    """The workers of one epoch and the state they share."""

    def __init__(self, loader: "Loader", epoch: int, batches: list):
        self.loader, self.epoch = loader, epoch
        self.work: queue.Queue = queue.Queue()
        for bi, b in enumerate(batches):
            self.work.put((bi, b))
        self.done: dict = {}
        self.cond = threading.Condition()
        self.consumed = 0
        self.stopped = False
        # bound the batches decoded ahead of the consumer; admission is
        # monotone in the batch index, so the earliest one always runs
        self.window = max(loader.prefetch, 1) + loader.num_threads
        n = min(loader.num_threads, max(len(batches), 1))
        self.threads = [threading.Thread(target=self._work, daemon=True)
                        for _ in range(n)]
        for t in self.threads:
            t.start()

    def _work(self) -> None:
        ds = self.loader.ds
        while True:
            try:
                bi, b = self.work.get_nowait()
            except queue.Empty:
                return
            with self.cond:
                while bi >= self.consumed + self.window and \
                        not self.stopped:
                    self.cond.wait()
                if self.stopped:
                    return
            try:
                batch = collate([ds.__getitem__(int(i), epoch=self.epoch)
                                 for i in b])
            except BaseException as e:  # raised on the consumer's side
                batch = e
            with self.cond:
                self.done[bi] = batch
                self.cond.notify_all()

    def take(self, bi: int):
        with self.cond:
            while bi not in self.done:
                self.cond.wait()
            batch = self.done.pop(bi)
            self.consumed = bi + 1
            self.cond.notify_all()
        if isinstance(batch, BaseException):
            raise batch
        return batch

    def stop(self) -> None:
        with self.cond:
            self.stopped = True
            self.done.clear()
            self.cond.notify_all()
        for t in self.threads:
            if t is not threading.current_thread():
                t.join()


class Loader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_threads: Optional[int] = None,
                 prefetch: int = 4, seed: int = 0, shard_id: int = 0,
                 num_shards: int = 1, pad: bool = True):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} not in [0, {num_shards})")
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_threads = (min(8, os.cpu_count() or 1)
                            if num_threads is None else max(1, num_threads))
        self.prefetch = prefetch
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.pad = pad
        self._epochs: "weakref.WeakSet[_Epoch]" = weakref.WeakSet()

    def indices(self, epoch: int) -> np.ndarray:
        """This shard's sample order in ``epoch``: the JAX loader's
        per-epoch shuffle (or the dataset's order without ``shuffle``),
        padded from its start to a multiple of ``num_shards`` (with
        ``pad``)."""
        n = len(self.ds)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch]))
            rng.shuffle(idx)
        if self.pad:
            per = -(-n // self.num_shards)
            idx = np.concatenate([idx, idx[:per * self.num_shards - n]])
        return idx[self.shard_id::self.num_shards]

    def __len__(self) -> int:
        n = len(self.ds)
        per = (-(-n // self.num_shards) if self.pad else
               len(range(self.shard_id, n, self.num_shards)))
        if self.drop_last:
            return per // self.batch_size
        return -(-per // self.batch_size)

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        idx = self.indices(epoch)
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(len(self))]
        return self._run(epoch, batches)

    def _run(self, epoch: int, batches: list) -> Iterator[dict]:
        if not batches:
            return
        ep = _Epoch(self, epoch, batches)
        self._epochs.add(ep)
        try:
            for bi in range(len(batches)):
                yield ep.take(bi)
        finally:
            ep.stop()

    def close(self) -> None:
        """Stop and join the workers of every epoch still running."""
        for ep in list(self._epochs):
            ep.stop()

    def __iter__(self) -> Iterator[dict]:
        return self.epoch(0)


def make_loader(dataset, batch_size: int, mesh=None, **kwargs) -> Loader:
    """A :class:`Loader` on this data rank's shard: ``batch_size`` is the
    global batch, of which each of the mesh's ``data`` ranks loads
    ``batch_size / data`` samples a step (refused unless it divides), from
    shard ``data_rank`` of ``data`` (not the global rank, so that ranks
    along a model axis read the same rows). ``mesh`` defaults to the
    initialised process group's (``parallel/mesh.py:make_mesh``); one
    process reads everything. JAX's ``make_loader`` takes ``batch_size``
    per process instead."""
    if mesh is None:
        from ..parallel.mesh import make_mesh
        mesh = make_mesh()
    kwargs.setdefault("shard_id", mesh.data_rank)
    kwargs.setdefault("num_shards", mesh.data)
    return Loader(dataset, mesh.local_batch(batch_size), **kwargs)


# numpy kinds the H2D prefetch moves to the device (uint8 the only unsigned)
_DEVICE_KINDS = "bif"


def prefetch_to_device(batches, device, size: int = 2) -> Iterator[dict]:
    """Double-buffered H2D (JAX ``parallel/mesh.py:prefetch_to_device``):
    each host batch's numeric numpy arrays are pinned and copied
    ``non_blocking`` on a side stream while the device works on the batch
    before; a batch is yielded once ``size`` are in flight (or the input
    ends), after the consumer's stream waits on its copy's event, and its
    tensors are recorded on that stream so that the allocator keeps them
    until the consumer's work is done. Other values pass through. On a
    device other than CUDA the host batches pass through as they are.
    Closing the generator closes ``batches``."""
    import collections

    import torch
    device = torch.device(device)
    try:
        if device.type != "cuda":
            yield from batches
            return
        side = torch.cuda.Stream(device=device)
        pending: collections.deque = collections.deque()

        def put(host: dict) -> None:
            out = {}
            with torch.cuda.stream(side):
                for k, v in host.items():
                    if isinstance(v, np.ndarray) and (
                            v.dtype.kind in _DEVICE_KINDS
                            or v.dtype == np.uint8):
                        pinned = torch.from_numpy(
                            np.ascontiguousarray(v)).pin_memory()
                        v = pinned.to(device, non_blocking=True)
                    out[k] = v
                ready = torch.cuda.Event()
                ready.record(side)
            pending.append((out, ready))

        def get() -> dict:
            out, ready = pending.popleft()
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(ready)
            for v in out.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(consumer)
            return out

        for host in batches:
            put(host)
            if len(pending) >= size:
                yield get()
        while pending:
            yield get()
    finally:
        close = getattr(batches, "close", None)
        if close is not None:
            close()
