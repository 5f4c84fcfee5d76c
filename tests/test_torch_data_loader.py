"""The port's loaders (``horovod_tpu_torch/data/data_loader.py``) held
against the JAX package's (``horovod_tpu/data/data_loader.py``) on the
CPU.

- ``ShardedArrayLoader``: for W in {1, 2, 4} and two epochs, with and
  without shuffling and with a transform, the W ranks' rows concatenate
  bitwise to the JAX loader's global batches (the JAX loader on a
  one-device mesh, read back with ``np.asarray``);
- ``AsyncDataLoaderMixin``: prefetch, an error raised by the producer
  reaching the consumer, and an early-stopping consumer releasing the
  producer thread;
- the loaders' metrics (names, kinds and help text) equal JAX's.
"""

import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from horovod_tpu import metrics as JM
from horovod_tpu.data import data_loader as jdl
from horovod_tpu_torch import metrics as M
from horovod_tpu_torch.data import data_loader as dl


def _arrays(n=44, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, 3, 2).astype(np.float32),
            rng.randint(0, 10, size=(n,)).astype(np.int32)]


def _jax_batches(arrays, batch, epoch, **kw):
    mesh = Mesh(np.array(jax.devices()[:1]), ("hvd",))
    loader = jdl.ShardedArrayLoader(arrays, batch, mesh=mesh, **kw)
    loader.set_epoch(epoch)
    return [tuple(np.asarray(x) for x in b) for b in loader]


def _port_batches(arrays, batch, epoch, rank, world, **kw):
    loader = dl.ShardedArrayLoader(arrays, batch, device="cpu", rank=rank,
                                   world=world, **kw)
    loader.set_epoch(epoch)
    return [tuple(x.numpy() for x in b) for b in loader]


def _double(x, y):
    return x * 2.0, y + 1


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("kw", [{}, {"shuffle": False, "seed": 5},
                                {"seed": 3, "transform": _double}],
                         ids=["shuffled", "ordered", "transform"])
def test_rank_slices_concatenate_to_the_jax_global_batches(world, kw):
    arrays = _arrays()
    for epoch in (0, 1):
        want = _jax_batches(arrays, 8, epoch, **kw)
        ranks = [_port_batches(arrays, 8, epoch, r, world, **kw)
                 for r in range(world)]
        assert len(want) == 5 and all(len(b) == 5 for b in ranks)
        for i, global_batch in enumerate(want):
            for col, g in enumerate(global_batch):
                got = np.concatenate([ranks[r][i][col]
                                      for r in range(world)])
                assert got.dtype == g.dtype
                np.testing.assert_array_equal(got, g)


def test_epochs_reshuffle_and_tensor_arrays_match_numpy():
    """Two epochs give two orders; CPU tensors (the form that carries
    bfloat16 host data) give the rows their numpy form gives."""
    arrays = _arrays()
    e0 = _port_batches(arrays, 8, 0, 0, 1)
    e1 = _port_batches(arrays, 8, 1, 0, 1)
    assert not np.array_equal(e0[0][1], e1[0][1])
    as_tensors = [torch.from_numpy(a) for a in arrays]
    for r in range(2):
        a = _port_batches(arrays, 8, 1, r, 2)
        b = _port_batches(as_tensors, 8, 1, r, 2)
        for x, y in zip(a, b):
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)


def test_batch_that_the_world_does_not_divide_is_refused():
    with pytest.raises(ValueError, match="divide by the world size 4"):
        dl.ShardedArrayLoader(_arrays(), 6, device="cpu", rank=0, world=4)
    with pytest.raises(ValueError, match="outside a world"):
        dl.ShardedArrayLoader(_arrays(), 8, device="cpu", rank=2, world=2)


def test_loader_device_takes_the_card_unless_asked(monkeypatch):
    """No card here: the default device raises, ``device="cpu"`` and
    ``HVD_TPU_FORCE_CPU=1`` take the CPU."""
    monkeypatch.delenv("HVD_TPU_FORCE_CPU", raising=False)
    with pytest.raises(RuntimeError, match="is_available"):
        dl.ShardedArrayLoader(_arrays(), 8, rank=0, world=1)
    assert dl.loader_device("cpu").type == "cpu"
    monkeypatch.setenv("HVD_TPU_FORCE_CPU", "1")
    loader = dl.ShardedArrayLoader(_arrays(), 8, rank=0, world=1)
    assert loader.device.type == "cpu"
    assert next(iter(loader))[0].device.type == "cpu"


class _Async(dl.AsyncDataLoaderMixin, dl.ShardedArrayLoader):
    pass


class _JaxAsync(jdl.AsyncDataLoaderMixin, jdl.ShardedArrayLoader):
    pass


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_async_prefetch_yields_the_sync_batches(depth):
    arrays = _arrays()
    for world in (1, 2):
        for r in range(world):
            sync = _port_batches(arrays, 8, 1, r, world)
            loader = _Async(arrays, 8, device="cpu", rank=r, world=world,
                            prefetch_depth=depth)
            loader.set_epoch(1)
            got = [tuple(x.numpy() for x in b) for b in loader]
            assert len(got) == len(sync)
            for a, b in zip(got, sync):
                for u, v in zip(a, b):
                    np.testing.assert_array_equal(u, v)
    mesh = Mesh(np.array(jax.devices()[:1]), ("hvd",))
    jloader = _JaxAsync(arrays, 8, mesh=mesh, prefetch_depth=depth)
    jloader.set_epoch(1)
    want = [np.asarray(b[0]) for b in jloader]
    got = [b[0].numpy() for b in _iter_epoch(
        _Async(arrays, 8, device="cpu", rank=0, world=1,
               prefetch_depth=depth), 1)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _iter_epoch(loader, epoch):
    loader.set_epoch(epoch)
    return list(loader)


class _FailingLoader(dl.BaseDataLoader):
    def __len__(self):
        return 3

    def _iterate(self):
        yield torch.zeros(1)
        yield torch.ones(1)
        raise KeyError("source broke")


class _Failing(dl.AsyncDataLoaderMixin, _FailingLoader):
    pass


def test_async_producer_error_reaches_the_consumer():
    got = []
    with pytest.raises(KeyError, match="source broke"):
        for b in _Failing(prefetch_depth=1):
            got.append(float(b))
    assert got == [0.0, 1.0]


class _EndlessLoader(dl.BaseDataLoader):
    made = 0

    def __len__(self):
        return 10 ** 9

    def _iterate(self):
        while True:
            self.made += 1
            yield torch.full((1,), float(self.made))


class _Endless(dl.AsyncDataLoaderMixin, _EndlessLoader):
    pass


def test_early_stopping_consumer_releases_the_producer():
    before = threading.active_count()
    loader = _Endless(prefetch_depth=2)
    it = iter(loader)
    assert [float(next(it)) for _ in range(3)] == [1.0, 2.0, 3.0]
    it.close()                                  # consumer stops early
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() <= before, "producer thread leaked"
    # bounded: the producer made at most depth + 2 beyond what was taken
    assert loader.made <= 3 + 2 + 2


def _metric(snap, name):
    m = snap[name]
    return m["kind"], m["help"]


def test_metrics_names_and_help_equal_jax():
    arrays = _arrays()
    list(_Async(arrays, 8, device="cpu", rank=0, world=1))
    mesh = Mesh(np.array(jax.devices()[:1]), ("hvd",))
    list(_JaxAsync(arrays, 8, mesh=mesh))
    port, jaxs = M.metrics_snapshot(), JM.metrics_snapshot()
    for name in ("hvd_data_prefetch_depth", "hvd_data_batches_total"):
        assert _metric(port, name) == _metric(jaxs, name)
