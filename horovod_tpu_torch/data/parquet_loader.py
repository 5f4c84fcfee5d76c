"""Streaming Parquet loader, the estimator's data plane: the counterpart
of ``horovod_tpu/data/parquet_loader.py``.

Reference parity: the Spark estimators materialize a DataFrame to Parquet
through the Store and STREAM it into remote trainers via Petastorm readers
(reference: spark/common/estimator.py:25 ``_get_or_create_dataset``,
spark/common/store.py saving paths, spark/keras/remote.py reader loop):
training never holds the full dataset in memory.

The loader walks the dataset's files and row groups with
``ParquetFile.iter_batches`` and packs fixed-size batches of this
process's rows, the JAX loader's rows for the same process bitwise: the
round-robin assignment of row groups from footer metadata, the
per-process rng ``(seed + epoch) * nproc + pidx``, the windowed shuffle
and the epoch capped at the thinnest shard are the JAX loader's, with
``hvd.size()``/``hvd.rank()`` where it reads ``jax.process_count()``/
``jax.process_index()``. Each batch goes to this rank's device through
the pinned staging of ``data_loader.PinnedStager``. Peak host memory is
O(read chunk + one batch); ``max_buffered_rows`` exposes the high-water
mark. ``pyarrow`` is imported inside the functions, so the package
imports where it is absent.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Sequence

import numpy as np

from horovod_tpu_torch.data.data_loader import (BaseDataLoader, PinnedStager,
                                                _world, loader_device)


def _column_to_numpy(batch, name: str) -> np.ndarray:
    """Arrow column -> numpy rows. Primitive columns convert zero-copy;
    (fixed-size) list columns, the usual feature-vector encoding, convert
    row-wise."""
    col = batch.column(name)
    try:
        arr = col.to_numpy(zero_copy_only=False)
    except Exception:
        return np.asarray(col.to_pylist())
    if arr.dtype == object:             # list column -> (rows, dim) matrix
        return np.stack(arr)
    return arr


def list_parquet_files(path: str) -> List[str]:
    """The dataset's data files, sorted for determinism. Accepts a directory
    (non-recursive, ``*.parquet`` plus Spark-style ``part-*`` files) or a
    single file."""
    if os.path.isfile(path):
        return [path]
    files = sorted(
        set(glob.glob(os.path.join(path, "*.parquet")))
        | {f for f in glob.glob(os.path.join(path, "part-*"))
           if os.path.isfile(f)})
    if not files:
        raise FileNotFoundError(f"no parquet files under {path!r}")
    return files


class ParquetShardedLoader(BaseDataLoader):
    """Stream this process's batches of a Parquet dataset onto its device.

    Row groups are round-robin sharded across processes from footer
    metadata (the Petastorm ``cur_shard``/``shard_count`` role): each
    process reads ONLY its row groups, so aggregate read bandwidth is
    O(dataset), not O(world x dataset). Each epoch a process visits its
    row groups in a seed+epoch-shuffled order and rows are shuffled within
    each read chunk (a windowed shuffle, the streaming trade-off Petastorm
    makes too), then packs drop-remainder batches of
    ``batch_size / world`` rows. ``rank``/``world`` default to the
    runtime's; ``device`` as :func:`data_loader.loader_device`."""

    def __init__(self, path: str, columns: Sequence[str], batch_size: int,
                 device=None, shuffle: bool = True, seed: int = 0,
                 read_chunk_rows: Optional[int] = None,
                 rank: Optional[int] = None, world: Optional[int] = None):
        import pyarrow.parquet as pq
        self.path = path
        self.columns = list(columns)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self._files = list_parquet_files(path)
        self._chunk_rows = int(read_chunk_rows or max(self.batch_size * 4,
                                                      1024))
        self._pidx, self._nproc = _world(rank, world)
        if self.batch_size % self._nproc:
            raise ValueError(
                f"batch_size={batch_size} must divide by the process count "
                f"{self._nproc} (each process reads its shard's rows)")
        self._local_batch = self.batch_size // self._nproc
        # Row-group index from footer metadata only, no data read here.
        # Every process computes the same table, so shard assignment and
        # the epoch length agree across hosts without communication.
        self._row_groups: List[tuple] = []           # (file, rg_idx, rows)
        for f in self._files:
            md = pq.ParquetFile(f).metadata
            for rg in range(md.num_row_groups):
                self._row_groups.append(
                    (f, rg, md.row_group(rg).num_rows))
        self.n = sum(rows for _, _, rows in self._row_groups)
        per_proc = [sum(rows for _, _, rows
                        in self._row_groups[p::self._nproc])
                    for p in range(self._nproc)]
        # Drop-remainder epoch length, limited by the thinnest shard so all
        # processes yield the same number of batches.
        self._batches = min(per_proc) // self._local_batch
        if self._batches == 0:
            # A silent zero-length epoch would "train" to loss 0.0 with no
            # steps run (e.g. fewer row groups than processes, or heavy
            # row-group skew leaving one shard under a local batch).
            raise ValueError(
                f"ParquetLoader epoch is EMPTY: dataset has "
                f"{len(self._row_groups)} row group(s) across "
                f"{self._nproc} process(es); the thinnest shard holds "
                f"{min(per_proc)} row(s) < local batch "
                f"{self._local_batch}. Write the dataset with more/"
                f"smaller row groups (>= one per process, each >= the "
                f"local batch), or lower batch_size. Spark-written "
                f"datasets: the row-group layout follows the DataFrame "
                f"partitioning — df.repartition(>= "
                f"{2 * self._nproc}).write.parquet(...) before training")
        self._my_row_groups = self._row_groups[self._pidx::self._nproc]
        self.max_buffered_rows = 0      # streaming high-water mark
        self.device = loader_device(device)
        self._stager = PinnedStager(self.device)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self._batches

    def first_batch_numpy(self):
        """One read-ahead batch of host rows (for model init shapes);
        reads a single chunk, never the dataset."""
        import pyarrow.parquet as pq
        pf = pq.ParquetFile(self._files[0])
        rb = next(pf.iter_batches(batch_size=min(self.batch_size,
                                                 self._chunk_rows),
                                  columns=self.columns))
        return tuple(_column_to_numpy(rb, c) for c in self.columns)

    def _finish(self, item):
        return self._stager.finish(item)

    def _iterate(self):
        import pyarrow.parquet as pq
        # Per-process rng: row order diverges across processes by design
        # (each shuffles its own shard); the batch COUNT stays aligned.
        rng = np.random.RandomState(
            (self.seed + self.epoch) * self._nproc + self._pidx)
        row_groups = list(self._my_row_groups)
        if self.shuffle:
            rng.shuffle(row_groups)
        buffers: List[List[np.ndarray]] = [[] for _ in self.columns]
        buffered = 0
        emitted = 0

        def pop_batch():
            nonlocal buffered, emitted
            cols = [np.concatenate(b) if len(b) > 1 else b[0]
                    for b in buffers]
            batch = tuple(c[:self._local_batch] for c in cols)
            for i, c in enumerate(cols):
                buffers[i] = [c[self._local_batch:]]
            buffered -= self._local_batch
            emitted += 1
            return self._stager.stage(batch)

        for f, rg, _rows in row_groups:
            if emitted >= self._batches:
                # Epoch cap reached (shard skew: this shard has more rows
                # than the thinnest one): stop READING too, not just
                # yielding, or the excess rows would all buffer in memory.
                return
            pf = pq.ParquetFile(f)
            for rb in pf.iter_batches(batch_size=self._chunk_rows,
                                      row_groups=[rg],
                                      columns=self.columns):
                cols = [_column_to_numpy(rb, c) for c in self.columns]
                if self.shuffle:
                    perm = rng.permutation(len(cols[0]))
                    cols = [c[perm] for c in cols]
                for i, c in enumerate(cols):
                    buffers[i].append(c)
                buffered += len(cols[0])
                self.max_buffered_rows = max(self.max_buffered_rows,
                                             buffered)
                while buffered >= self._local_batch \
                        and emitted < self._batches:
                    yield pop_batch()
        # remainder rows are dropped (drop-remainder contract, matching
        # ShardedArrayLoader and the reference's steps_per_epoch rounding);
        # emitted is capped at the epoch length so every process yields
        # the same number of batches regardless of shard skew.


def write_parquet_dataset(path: str, columns: dict, rows_per_file: int,
                          ) -> List[str]:
    """Write {name: array} as a multi-file Parquet dataset (tests and the
    estimator's local materialization helper). Feature matrices are stored
    as list columns, the encoding Spark/Petastorm produce."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    os.makedirs(path, exist_ok=True)
    names = list(columns)
    n = len(next(iter(columns.values())))
    paths = []
    for start in range(0, n, rows_per_file):
        arrays = []
        for name in names:
            a = np.asarray(columns[name])[start:start + rows_per_file]
            arrays.append(pa.array(list(a)) if a.ndim > 1 else pa.array(a))
        table = pa.table(dict(zip(names, arrays)))
        out = os.path.join(path, f"part-{start // rows_per_file:05d}.parquet")
        pq.write_table(table, out)
        paths.append(out)
    return paths
