"""The port's streaming Parquet loader
(``horovod_tpu_torch/data/parquet_loader.py``) held against the JAX
package's (``horovod_tpu/data/parquet_loader.py``) on the CPU.

For each process ``p`` of N in {1, 2} the port's rows are bitwise the JAX
loader's rows of process ``p``. The JAX loader reads its process from
``jax.process_count``/``jax.process_index`` and places rows on the mesh
(``_place``); the test emulates process ``p`` by patching those two and
the instance's ``_place`` (which then returns the process's host rows),
in the test only. Also: the epoch reshuffle, the empty-epoch error,
``max_buffered_rows``, and ``write_parquet_dataset`` round-tripping
between the packages.
"""

import jax
import numpy as np
import pytest
import pyarrow.parquet as pq
from jax.sharding import Mesh

from horovod_tpu.data import parquet_loader as jpl
from horovod_tpu_torch.data import parquet_loader as pl


def _write(mod, path, n=512, dim=4, rows_per_file=128, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, dim).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.int64)
    mod.write_parquet_dataset(str(path), {"features": x, "label": y},
                              rows_per_file=rows_per_file)
    return x, y


def _jax_rows(monkeypatch, path, p, n, epoch, **kw):
    monkeypatch.setattr(jax, "process_count", lambda: n)
    monkeypatch.setattr(jax, "process_index", lambda: p)
    mesh = Mesh(np.array(jax.devices()[:1]), ("hvd",))
    loader = jpl.ParquetShardedLoader(str(path), ["features", "label"],
                                      mesh=mesh, **kw)
    loader._place = lambda sh, cols: tuple(np.asarray(c) for c in cols)
    loader.set_epoch(epoch)
    rows = list(loader)
    monkeypatch.undo()
    return rows, loader


def _port_rows(path, p, n, epoch, **kw):
    loader = pl.ParquetShardedLoader(str(path), ["features", "label"],
                                     device="cpu", rank=p, world=n, **kw)
    loader.set_epoch(epoch)
    return [tuple(t.numpy() for t in b) for b in loader], loader


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("kw", [
    dict(batch_size=64),
    dict(batch_size=32, read_chunk_rows=48, seed=7),
    dict(batch_size=64, shuffle=False)], ids=["default", "chunked", "ordered"])
def test_each_process_rows_bitwise_the_jax_loaders(tmp_path, monkeypatch,
                                                   world, kw):
    _write(pl, tmp_path / "ds", n=600, rows_per_file=100)
    for epoch in (0, 1):
        for p in range(world):
            want, jl = _jax_rows(monkeypatch, tmp_path / "ds", p, world,
                                 epoch, **kw)
            got, ptl = _port_rows(tmp_path / "ds", p, world, epoch, **kw)
            assert len(got) == len(want) == len(jl) == len(ptl) > 0
            for a, b in zip(got, want):
                for u, v in zip(a, b):
                    assert u.dtype == v.dtype
                    np.testing.assert_array_equal(u, v)
            assert ptl.max_buffered_rows == jl.max_buffered_rows


def test_streams_all_rows_and_reshuffles_per_epoch(tmp_path):
    x, y = _write(pl, tmp_path / "ds", n=512, rows_per_file=128)
    rows, loader = _port_rows(tmp_path / "ds", 0, 1, 0, batch_size=64)
    assert loader.n == 512 and len(loader) == 8
    got = np.concatenate([b[0] for b in rows])
    np.testing.assert_array_equal(np.sort(got.ravel()), np.sort(x.ravel()))
    np.testing.assert_array_equal(np.sort(np.concatenate(
        [b[1] for b in rows])), np.sort(y))
    again, _ = _port_rows(tmp_path / "ds", 0, 1, 0, batch_size=64)
    other, _ = _port_rows(tmp_path / "ds", 0, 1, 1, batch_size=64)
    np.testing.assert_array_equal(rows[0][0], again[0][0])
    assert not np.array_equal(rows[0][0], other[0][0])


def test_never_materializes_the_dataset(tmp_path):
    _write(pl, tmp_path / "ds", n=4096, rows_per_file=256)
    _, loader = _port_rows(tmp_path / "ds", 0, 1, 0, batch_size=32,
                           read_chunk_rows=128)
    assert loader.max_buffered_rows <= 128 + 128 + 32


def test_empty_epoch_raises_the_jax_error(tmp_path, monkeypatch):
    _write(pl, tmp_path / "tiny", n=32, rows_per_file=32)
    with pytest.raises(ValueError, match="EMPTY") as port:
        pl.ParquetShardedLoader(str(tmp_path / "tiny"),
                                ["features", "label"], batch_size=64,
                                device="cpu", rank=0, world=1)
    mesh = Mesh(np.array(jax.devices()[:1]), ("hvd",))
    with pytest.raises(ValueError, match="EMPTY") as ref:
        jpl.ParquetShardedLoader(str(tmp_path / "tiny"),
                                 ["features", "label"], batch_size=64,
                                 mesh=mesh)
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="process count 2"):
        pl.ParquetShardedLoader(str(tmp_path / "tiny"),
                                ["features", "label"], batch_size=3,
                                device="cpu", rank=0, world=2)


def test_list_parquet_files_as_jax(tmp_path):
    _write(pl, tmp_path / "ds", n=256, rows_per_file=64)
    assert pl.list_parquet_files(str(tmp_path / "ds")) == \
        jpl.list_parquet_files(str(tmp_path / "ds"))
    assert len(pl.list_parquet_files(str(tmp_path / "ds"))) == 4
    with pytest.raises(FileNotFoundError):
        pl.list_parquet_files(str(tmp_path / "empty"))


@pytest.mark.parametrize("writer,reader", [(pl, jpl), (jpl, pl)],
                         ids=["port-to-jax", "jax-to-port"])
def test_write_parquet_dataset_round_trips_between_packages(tmp_path, writer,
                                                            reader):
    x, y = _write(writer, tmp_path / "ds", n=200, rows_per_file=64)
    files = reader.list_parquet_files(str(tmp_path / "ds"))
    assert len(files) == 4
    xs, ys = [], []
    for f in files:
        for rb in pq.ParquetFile(f).iter_batches(batch_size=50):
            xs.append(reader._column_to_numpy(rb, "features"))
            ys.append(reader._column_to_numpy(rb, "label"))
            np.testing.assert_array_equal(
                pl._column_to_numpy(rb, "features"),
                jpl._column_to_numpy(rb, "features"))
    np.testing.assert_array_equal(np.concatenate(xs), x)
    np.testing.assert_array_equal(np.concatenate(ys), y)
    assert np.concatenate(xs).dtype == np.float32


def test_first_batch_numpy_as_jax(tmp_path):
    _write(pl, tmp_path / "ds", n=256, rows_per_file=64)
    _, ptl = _port_rows(tmp_path / "ds", 0, 1, 0, batch_size=32)
    mesh = Mesh(np.array(jax.devices()[:1]), ("hvd",))
    jl = jpl.ParquetShardedLoader(str(tmp_path / "ds"),
                                  ["features", "label"], batch_size=32,
                                  mesh=mesh)
    for a, b in zip(ptl.first_batch_numpy(), jl.first_batch_numpy()):
        np.testing.assert_array_equal(a, b)
