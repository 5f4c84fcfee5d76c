"""The port's loader placement (``data/data_loader.PinnedStager``) on a
card.

Every test here is marked ``cuda`` and skips when
``torch.cuda.is_available()`` is False, which it is on the CPU machines
that run the suite. The module imports neither jax nor the JAX package,
so on a machine with an H100 (and no JAX) it runs with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_data.py

- the pinned-staged copy on the copy stream gives, bitwise, what a plain
  ``.to(device)`` of the same host rows gives (float32, bfloat16, int64);
- a staging buffer is not written again before its copy's event has
  completed: the copy stream is held back by a sleep kernel after every
  batch, so copies queue behind it, and a slow consumer with prefetch
  depth 2 checks every one of 64 batches;
- the prefetch thread places on the loader's device (the last card),
  not on card 0, and leaves the consumer's current device alone;
- where pyarrow is installed, the Parquet loader's rows on the card are
  its rows on the CPU.
"""

import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu_torch.data import data_loader as dl


class _Async(dl.AsyncDataLoaderMixin, dl.ShardedArrayLoader):
    pass


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _host(n=96, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, 64, 33).astype(np.float32),
            torch.from_numpy(rng.randn(n, 7).astype(np.float32)
                             ).to(torch.bfloat16),
            rng.randint(0, 1000, size=(n,)).astype(np.int64)]


def _expected(arrays, loader, b):
    order = np.arange(loader.n)
    if loader.shuffle:
        np.random.RandomState(loader.seed + loader.epoch).shuffle(order)
    idx = order[b * loader.batch_size:(b + 1) * loader.batch_size]
    idx = idx[loader.rank * loader.local_batch:
              (loader.rank + 1) * loader.local_batch]
    return [a[torch.from_numpy(idx)] if torch.is_tensor(a)
            else torch.from_numpy(a[idx]) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 2])
def test_staged_placement_is_bitwise_a_plain_copy(world):
    _need_card()
    arrays = _host()
    for rank in range(world):
        for cls in (dl.ShardedArrayLoader, _Async):
            loader = cls(arrays, 16, device="cuda", rank=rank, world=world,
                         seed=4)
            loader.set_epoch(1)
            got = list(loader)
            assert len(got) == 6
            for b, batch in enumerate(got):
                want = [t.to("cuda") for t in _expected(arrays, loader, b)]
                for g, w in zip(batch, want):
                    assert g.device == w.device and g.dtype == w.dtype
                    assert torch.equal(g, w)


@pytest.mark.cuda
def test_staging_buffer_is_not_rewritten_before_its_copy_completes():
    _need_card()
    rng = np.random.RandomState(1)
    # 64 batches of 2 MiB each: distinct contents, so a batch copied from
    # a rewritten buffer shows as another batch's rows
    x = rng.randn(64 * 8, 256, 256).astype(np.float32)
    loader = _Async([x], 8, device="cuda", shuffle=False, rank=0, world=1,
                    prefetch_depth=2)
    seen = 0
    for b, (batch,) in enumerate(loader):
        stream = loader._stager._stream
        assert stream is not None
        # hold the copy stream back: the copies the producer issues next
        # queue behind this kernel while it refills its slots
        with torch.cuda.stream(stream):
            torch.cuda._sleep(2_000_000)
        time.sleep(0.002)                            # a slow consumer
        want = torch.from_numpy(x[b * 8:(b + 1) * 8]).to("cuda")
        assert torch.equal(batch, want), f"batch {b} was corrupted"
        seen += 1
    assert seen == 64
    assert all(buf is None or all(t.is_pinned() for t in buf)
               for buf in loader._stager._bufs)


@pytest.mark.cuda
def test_prefetch_thread_places_on_the_loaders_card():
    _need_card()
    target = torch.device("cuda", torch.cuda.device_count() - 1)
    before = torch.cuda.current_device()
    arrays = _host()
    placed_on = []

    class WatchingLoader(dl.ShardedArrayLoader):
        def _iterate(self):
            for item in super()._iterate():
                placed_on.append((threading.current_thread().name,
                                  item.tensors[0].device))
                yield item

    class Watching(dl.AsyncDataLoaderMixin, WatchingLoader):
        pass

    loader = Watching(arrays, 16, device=target, rank=0, world=1)
    got = list(loader)
    assert torch.cuda.current_device() == before
    assert len(got) == 6
    for batch in got:
        assert all(t.device == target for t in batch)
    assert loader._stager._stream.device == target
    assert len(placed_on) == 6
    assert all(dev == target for _, dev in placed_on)
    assert all(name != threading.main_thread().name
               for name, _ in placed_on)
    loader.set_epoch(0)
    for b, batch in enumerate(got):
        for g, w in zip(batch, _expected(arrays, loader, b)):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_parquet_rows_on_the_card_are_the_cpu_loaders(tmp_path):
    """Where pyarrow is installed, ``ParquetShardedLoader`` on the card
    yields bitwise the rows it yields on the CPU, for each of 2 ranks."""
    _need_card()
    pytest.importorskip("pyarrow")
    from horovod_tpu_torch.data import parquet_loader as pl
    rng = np.random.RandomState(3)
    pl.write_parquet_dataset(
        str(tmp_path / "ds"),
        {"features": rng.randn(600, 5).astype(np.float32),
         "label": rng.randint(0, 9, size=600).astype(np.int64)},
        rows_per_file=100)
    for rank in range(2):
        rows = {}
        for dev in ("cpu", "cuda"):
            loader = pl.ParquetShardedLoader(
                str(tmp_path / "ds"), ["features", "label"], batch_size=64,
                device=dev, rank=rank, world=2, read_chunk_rows=48)
            loader.set_epoch(1)
            rows[dev] = list(loader)
        assert len(rows["cuda"]) == len(rows["cpu"]) > 0
        for g, w in zip(rows["cuda"], rows["cpu"]):
            for a, b in zip(g, w):
                assert a.is_cuda and torch.equal(a.cpu(), b)
