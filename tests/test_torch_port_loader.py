"""The port's threaded loader against the JAX package's ``Loader`` on the
CPU, its error path and its shutdown, ``make_loader``'s shard and the H2D
prefetch's CPU pass-through.

- Every batch equal to JAX's, in JAX's order, for several ``(seed, epoch,
  shard_id, num_shards, drop_last, shuffle)``, on a counting dataset and on
  the synthetic DVPS frames; with one worker and with several.
- An exception in a worker is raised in the consumer.
- ``threading.active_count()`` is back to its start, and no worker of the
  port is alive, after an epoch left part-way is collected, after
  ``close()``, and after an error (the JAX loader's workers live on after
  an abandoned epoch). A JAX worker of an earlier test that ends meanwhile
  may take the count below its start.
"""

import gc
import threading

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from ldmseg_tpu.data.loader import Loader as JLoader  # noqa: E402
from ldmseg_tpu.data.synthetic import SyntheticDVPS as JSynthetic  # noqa
from ldmseg_torch.data import SyntheticDVPS  # noqa: E402
from ldmseg_torch.data.loader import (Loader, make_loader,  # noqa: E402
                                      prefetch_to_device)


class Counting:
    """Sample i of epoch e: its index, epoch and a few derived arrays."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i, epoch=0):
        if i == self.fail_at:
            raise KeyError(f"sample {i} is unreadable")
        return {"image": np.full((2, 3, 3), i + 0.5 * epoch, np.float32),
                "semseg": np.arange(6, dtype=np.int32).reshape(2, 3) + i,
                "meta": {"image_id": i, "epoch": epoch}}


def _eq(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _eq(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def _workers():
    return sum(1 for t in threading.enumerate() if getattr(
        getattr(t, "_target", None), "__qualname__", "") == "_Epoch._work")


def _back_to(start):
    assert _workers() == 0
    assert threading.active_count() <= start


def _same(ours, ref):
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        _eq(a, b)


@pytest.mark.parametrize("seed,epoch,shard,shards,drop_last,shuffle", [
    (0, 0, 0, 1, True, True), (3, 2, 0, 1, False, True),
    (1, 1, 1, 3, True, True), (1, 1, 2, 3, False, True),
    (5, 0, 1, 2, False, False), (7, 4, 3, 4, True, False)])
@pytest.mark.parametrize("threads", [1, 3])
def test_batches_equal_jax(seed, epoch, shard, shards, drop_last, shuffle,
                           threads):
    ds = Counting(23)
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=seed,
              shard_id=shard, num_shards=shards)
    ref = list(JLoader(ds, 4, num_threads=2, **kw).epoch(epoch))
    loader = Loader(ds, 4, num_threads=threads, prefetch=1, **kw)
    assert len(loader) == len(JLoader(ds, 4, **kw))
    _same(list(loader.epoch(epoch)), ref)
    np.testing.assert_array_equal(loader.indices(epoch),
                                  JLoader(ds, 4, **kw)._indices(epoch))


def test_synthetic_frames_equal_jax():
    kw = dict(length=6, size=(32, 64), num_bits=5)
    ref = list(JLoader(JSynthetic(**kw), 2, seed=4).epoch(1))
    _same(list(Loader(SyntheticDVPS(**kw), 2, seed=4).epoch(1)), ref)


def test_worker_error_is_raised_in_the_consumer():
    start = threading.active_count()
    loader = Loader(Counting(12, fail_at=5), 2, shuffle=False,
                    num_threads=3)
    got = []
    with pytest.raises(KeyError, match="sample 5"):
        for batch in loader.epoch(0):
            got.append(batch["meta"][0]["image_id"])
    assert got == [0, 2]
    _back_to(start)


def test_no_thread_outlives_an_abandoned_epoch():
    start = threading.active_count()
    loader = Loader(Counting(40), 2, num_threads=4, prefetch=2)
    gen = loader.epoch(0)
    next(gen)
    assert _workers() == 4
    del gen
    gc.collect()
    _back_to(start)
    # an epoch still referenced stops on close()
    held = loader.epoch(1)
    next(held)
    assert _workers() == 4
    loader.close()
    _back_to(start)
    del held
    # a fresh epoch runs to its end and leaves nothing either
    assert len(list(loader.epoch(2))) == 20
    _back_to(start)


def test_defaults_are_jax_s():
    ours, ref = Loader(Counting(3), 1), JLoader(Counting(3), 1)
    assert (ours.num_threads, ours.prefetch) == (ref.num_threads,
                                                 ref.prefetch)


def test_make_loader_takes_its_shard_from_torch_distributed(monkeypatch):
    import torch.distributed as dist
    assert make_loader(Counting(8), 2).num_shards == 1
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 2)
    monkeypatch.setattr(dist, "get_world_size", lambda: 3)
    # batch_size is the global batch: each of the 3 data ranks loads 2
    loader = make_loader(Counting(8), 6, shuffle=False)
    assert (loader.shard_id, loader.num_shards) == (2, 3)
    assert loader.batch_size == 2
    ref = JLoader(Counting(8), 2, shuffle=False, shard_id=2, num_shards=3)
    _same(list(loader.epoch(0)), list(ref.epoch(0)))
    with pytest.raises(ValueError, match="does not split over 3"):
        make_loader(Counting(8), 2)


def test_prefetch_passes_host_batches_on_the_cpu():
    start = threading.active_count()
    loader = Loader(Counting(10), 2, shuffle=False, num_threads=2)
    src = loader.epoch(0)
    out = prefetch_to_device(src, torch.device("cpu"))
    first = next(out)
    assert isinstance(first["image"], np.ndarray)
    _same([first], [next(iter(Loader(Counting(10), 2, shuffle=False)))])
    out.close()
    _back_to(start)
