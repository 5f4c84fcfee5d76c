"""Data-loader base classes and the sharded array loader of the port: the
counterpart of ``horovod_tpu/data/data_loader.py``.

Reference parity: horovod/data/data_loader_base.py, ``BaseDataLoader``
(:18, abstract __iter__/__len__) and ``AsyncDataLoaderMixin`` (:60: a
background thread and a bounded queue prefetching batches while the
device computes).

``ShardedArrayLoader`` shuffles the GLOBAL index order exactly as the JAX
loader does (``np.random.RandomState(seed + epoch)``), so the global
batches are bitwise the JAX loader's; where the JAX loader places a
global batch on the mesh sharded over its batch dimension, rank ``r`` of
``W`` here yields its rows ``[r*b/W, (r+1)*b/W)`` of each global batch on
its own device (every rank of the port is a process).

Placement on a card (``PinnedStager``): a host batch is copied into a
pinned staging buffer, copied to the card with ``non_blocking=True`` on a
copy stream of its own, and handed over with the copy's event; the
consuming thread makes its current stream wait on that event and marks
every tensor with ``record_stream`` on it, so the caching allocator
keeps the memory until the consumer's kernels are done. A staging buffer
is written again only after the event of its previous copy has
completed. Under ``AsyncDataLoaderMixin`` the copies run on the prefetch
thread, so they overlap the previous steps' kernels.

Loaders run on the card unless the caller passes ``device="cpu"`` or
``HVD_TPU_FORCE_CPU=1`` is set; a loader never moves to the CPU on its
own.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Any, Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from horovod_tpu_torch.utils.device import resolve_device


def loader_device(device=None) -> torch.device:
    """The device a loader (or a worker of the integrations) places on:
    ``device`` if given, else the initialized runtime's device, else the
    card; ``HVD_TPU_FORCE_CPU=1`` turns a CUDA device into the CPU, as it
    does for ``init``. Raises for a CUDA device without a card."""
    if device is None:
        from horovod_tpu_torch.runtime import context
        device = (context.get_context().device if context.is_initialized()
                  else "cuda")
    if os.environ.get("HVD_TPU_FORCE_CPU") == "1" and \
            torch.device(device).type == "cuda":
        device = "cpu"
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _world(rank: Optional[int], world: Optional[int]):
    from horovod_tpu_torch.runtime import context
    if world is None:
        world = context.size() if context.is_initialized() else 1
    if rank is None:
        rank = context.rank() if context.is_initialized() else 0
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    return int(rank), int(world)


def _as_tensor(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x
    a = np.ascontiguousarray(x)
    if not a.flags.writeable:          # e.g. a zero-copy Arrow column
        a = a.copy()
    return torch.from_numpy(a)


class _Staged:
    """A batch whose copy to the card was issued on the copy stream:
    ``tensors`` are not to be read before ``event`` on another stream."""

    __slots__ = ("tensors", "event")

    def __init__(self, tensors, event):
        self.tensors = tensors
        self.event = event


class PinnedStager:
    """Host batches to one card through ``SLOTS`` pinned staging buffers
    and a copy stream (the module docstring gives the protocol).
    ``stage`` runs on the producing thread, ``finish`` on the consuming
    one; on a CPU device both are plain conversions."""

    # copies in flight at once; a fifth waits for the first one's event
    SLOTS = 4

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._bufs: List[Optional[List[torch.Tensor]]] = [None] * self.SLOTS
        self._events: List[Optional[torch.cuda.Event]] = [None] * self.SLOTS
        self._next = 0
        self._stream = None

    def stage(self, batch: Sequence[Any]):
        tensors = [_as_tensor(x) for x in batch]
        if self.device.type != "cuda":
            return tuple(t.to(self.device) for t in tensors)
        # The current device is per thread: the prefetch thread selects
        # the loader's card before it allocates or copies anything.
        with torch.cuda.device(self.device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            slot = self._next
            self._next = (slot + 1) % self.SLOTS
            if self._events[slot] is not None:
                # the slot's previous copy may still be reading it
                self._events[slot].synchronize()
            bufs = self._bufs[slot]
            if bufs is None or [(b.shape, b.dtype) for b in bufs] != \
                    [(t.shape, t.dtype) for t in tensors]:
                bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                        for t in tensors]
                if not all(b.is_pinned() for b in bufs):
                    raise RuntimeError("staging buffers are not pinned")
                self._bufs[slot] = bufs
            for b, t in zip(bufs, tensors):
                b.copy_(t)
            event = torch.cuda.Event()
            with torch.cuda.stream(self._stream):
                out = tuple(b.to(self.device, non_blocking=True)
                            for b in bufs)
                event.record(self._stream)
            self._events[slot] = event
        return _Staged(out, event)

    def finish(self, item):
        if not isinstance(item, _Staged):
            return item
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(item.event)
        for t in item.tensors:
            t.record_stream(stream)
        return item.tensors


class BaseDataLoader:
    """Abstract loader (ref data_loader_base.py:18). ``_iterate`` yields
    items on the producing thread; ``_finish`` turns one into the batch
    the consumer gets, on the consuming thread."""

    def __len__(self) -> int:
        raise NotImplementedError

    def _iterate(self) -> Iterator[Any]:
        raise NotImplementedError

    def _finish(self, item: Any) -> Any:
        return item

    def __iter__(self) -> Iterator[Any]:
        for item in self._iterate():
            yield self._finish(item)


class AsyncDataLoaderMixin:
    """Background-thread prefetch (ref data_loader_base.py:60: spawns a
    thread writing batches into a bounded queue; ``async_loading_pool_size``
    -> here ``prefetch_depth``). Mix in BEFORE a BaseDataLoader subclass:

        class MyAsyncLoader(AsyncDataLoaderMixin, MyLoader): ...
    """

    def __init__(self, *args, prefetch_depth: int = 2, **kwargs):
        self.prefetch_depth = prefetch_depth
        super().__init__(*args, **kwargs)

    def __iter__(self) -> Iterator[Any]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        sentinel = object()
        stop = threading.Event()
        err: list = []

        def worker():
            from horovod_tpu_torch.tracing import spans as trace

            def traced_iter():
                # Span per produced batch: how long the loader took to
                # BUILD each item; a widening data.prefetch next to a
                # starving train.step is the input-bound signature.
                it = super(AsyncDataLoaderMixin, self)._iterate()
                while True:
                    with trace.span("data.prefetch", cat=trace.CAT_DATA):
                        try:
                            item = next(it)
                        except StopIteration:
                            return
                    yield item

            try:
                src = traced_iter() if trace.enabled() else \
                    super(AsyncDataLoaderMixin, self)._iterate()
                for item in src:
                    # bounded put with a stop check so an abandoned
                    # consumer (break / exception in the training loop)
                    # releases the thread instead of pinning prefetched
                    # batches forever
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # propagate into consumer
                err.append(e)
            finally:
                while True:
                    try:
                        q.put(sentinel, timeout=0.1)
                        break
                    except queue.Full:
                        if stop.is_set():
                            break

        from horovod_tpu_torch import metrics as M
        m_depth = M.gauge(
            "hvd_data_prefetch_depth",
            "Batches sitting ready in the async loader's prefetch queue")
        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                m_depth.set(q.qsize())
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield self._finish(item)
        finally:
            stop.set()


class ShardedArrayLoader(BaseDataLoader):
    """Shard (features, labels, ...) arrays across ranks and stream this
    rank's rows of each global batch onto its device.

    Each epoch: optional deterministic shuffle of the global index order
    (seeded by ``seed + epoch``, identical on all ranks: the
    DistributedSampler contract), drop-remainder split into global
    batches of ``batch_size`` rows, and rank ``rank`` of ``world`` keeps
    rows ``[rank*b/world, (rank+1)*b/world)`` of each. ``arrays`` are
    numpy arrays or CPU tensors (for dtypes numpy lacks, such as
    bfloat16). ``transform(*batch)`` sees the global batch, as in the JAX
    loader. ``rank``/``world`` default to the runtime's (0 and 1 before
    ``init``); ``device`` as :func:`loader_device`."""

    def __init__(self, arrays: Sequence[Any], batch_size: int,
                 device=None, shuffle: bool = True, seed: int = 0,
                 transform: Optional[Callable[..., tuple]] = None,
                 rank: Optional[int] = None, world: Optional[int] = None):
        self.arrays = [a if torch.is_tensor(a) else np.asarray(a)
                       for a in arrays]
        n = self.arrays[0].shape[0]
        for a in self.arrays:
            if a.shape[0] != n:
                raise ValueError("arrays must share the sample dim")
        self.n = n
        self.batch_size = int(batch_size)
        self.rank, self.world = _world(rank, world)
        if self.batch_size % self.world:
            raise ValueError(
                f"batch_size={batch_size} must divide by the world size "
                f"{self.world} (each rank takes its rows of a global "
                f"batch)")
        self.local_batch = self.batch_size // self.world
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.transform = transform
        self.device = loader_device(device)
        self._stager = PinnedStager(self.device)

    def set_epoch(self, epoch: int) -> None:
        """Reseed shuffling (the DistributedSampler.set_epoch contract)."""
        self.epoch = epoch

    def __len__(self) -> int:
        return self.n // self.batch_size

    def _rows(self, idx: np.ndarray) -> tuple:
        return tuple(a[torch.from_numpy(idx)] if torch.is_tensor(a)
                     else a[idx] for a in self.arrays)

    def _finish(self, item):
        return self._stager.finish(item)

    def _iterate(self):
        from horovod_tpu_torch import metrics as M
        m_batches = M.counter(
            "hvd_data_batches_total",
            "Global batches served onto the mesh by the sharded loader")
        order = np.arange(self.n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        lo = self.rank * self.local_batch
        hi = lo + self.local_batch
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            if self.transform:
                batch = tuple(x[lo:hi] for x in
                              self.transform(*self._rows(idx)))
            else:
                batch = self._rows(idx[lo:hi])
            m_batches.inc()
            yield self._stager.stage(batch)
