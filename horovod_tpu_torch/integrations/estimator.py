"""Estimator / Model API: fit/predict over a distributed backend. The
counterpart of ``horovod_tpu/integrations/estimator.py``.

Reference: Spark ML estimators (reference: spark/common/estimator.py:25
``HorovodEstimator.fit(df) -> HorovodModel``; keras/torch/lightning
remote trainers spark/keras/remote.py etc.): wrap a model + optimizer +
loss, fit on a distributed dataset, return a servable model.

``fit`` runs the training loop through ``TpuExecutor`` (a persistent pool
of ranks, one card each, or Ray actors). The model is an ``nn.Module``,
broadcast from rank 0; the optimizer a factory ``params ->
torch.optim.Optimizer`` (default ``Adam(lr)``), wrapped in
``DistributedOptimizer(op=Average)``; a callback that retunes the
learning rate (``logs['lr']``) sets the optimizer's ``param_groups``.
Three data planes: in-memory arrays (``fit``) through
``ShardedArrayLoader``; a Parquet dataset directory on shared storage
(``fit_on_parquet``) streamed inside each worker through
``ParquetShardedLoader``; and ``fit_on_dataframe``, the reference's
actual entry point (``HorovodEstimator.fit(df)``), which materializes a
pandas/Spark DataFrame to the Store as Parquet and then streams it (ref
spark/common/estimator.py:25, util.py ``prepare_data``). Each rank
trains on its rows of every global batch; ``history`` is the mean loss
over the GLOBAL batch (each epoch's mean is averaged over the ranks), as
the JAX estimator reports it. The trained ``TpuModel`` predicts on the
card unless asked for the CPU.

Models reach the workers by cloudpickle where it is installed and by
pickle otherwise, so a model class must then be importable there (not
defined in ``__main__``).
"""

from __future__ import annotations

import copy
from typing import Any, List, Optional

import numpy as np

try:
    import cloudpickle as _pickle
except ImportError:
    import pickle as _pickle


def _set_learning_rate(optimizer, lr: float) -> None:
    """Apply an LR-schedule callback's ``logs['lr']`` to every param
    group (the role ``optax.inject_hyperparams`` plays in the JAX
    estimator)."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def _loss_fn(model, loss_spec):
    import torch.nn.functional as F
    if callable(loss_spec):
        # loss(model, batch) -> scalar: arbitrary user objective.
        return lambda batch: loss_spec(model, batch)
    if loss_spec == "classification":
        def loss_fn(batch):
            bx, by = batch
            return F.cross_entropy(model(bx).float(), by.long())
    else:
        def loss_fn(batch):
            bx, by = batch
            return ((model(bx).float() - by) ** 2).mean()
    return loss_fn


def _host_state(model) -> dict:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def _fit_worker(model_bytes: bytes, data, batch_size: int, epochs: int,
                lr: float, seed: int, validation: float = 0.0,
                store_bytes: Optional[bytes] = None,
                run_id: Optional[str] = None):
    """Runs inside each pool worker: DP training with the framework path.
    With a store, rank 0 checkpoints per epoch and tracks the best by
    validation loss (ref keras BestModelCheckpoint + spark/common
    estimator checkpointing via the Store).

    ``data`` is ("arrays", (x, y)), in memory, or ("parquet", spec) with
    spec = {path, features_col, label_col, val_path?}: workers then STREAM
    the dataset from shared storage through ParquetShardedLoader instead
    of receiving it pickled (the reference's Store-materialized Parquet +
    Petastorm reader path, spark/common/estimator.py:25,
    spark/keras/remote.py)."""
    import torch

    import horovod_tpu_torch as htt
    from horovod_tpu_torch.callbacks import CallbackList
    from horovod_tpu_torch.data.data_loader import ShardedArrayLoader
    from horovod_tpu_torch.data.parquet_loader import ParquetShardedLoader
    from horovod_tpu_torch.runtime import context

    torch.manual_seed(seed)
    dev = context.get_context().device
    (model, loss_spec, opt_spec, user_step,
     callbacks) = _pickle.loads(model_bytes)
    model.to(dev)
    kind, payload = data
    val_batches = None                  # callable -> iterator of host pairs
    if kind == "arrays":
        x, y = payload
        n_val = int(len(x) * validation)
        if n_val:
            x, y, xv, yv = x[:-n_val], y[:-n_val], x[-n_val:], y[-n_val:]

            def val_batches():
                for s in range(0, len(xv), batch_size):
                    yield xv[s:s + batch_size], yv[s:s + batch_size]
        loader = ShardedArrayLoader([x, y], batch_size=batch_size,
                                    device=dev)
    elif kind == "parquet":
        columns = [payload["features_col"], payload["label_col"]]
        loader = ParquetShardedLoader(payload["path"], columns,
                                      batch_size=batch_size, device=dev)
        if payload.get("val_path"):
            def val_batches():
                import pyarrow.parquet as pq

                from horovod_tpu_torch.data.parquet_loader import (
                    _column_to_numpy, list_parquet_files)
                for f in list_parquet_files(payload["val_path"]):
                    for rb in pq.ParquetFile(f).iter_batches(
                            batch_size=batch_size, columns=columns):
                        yield (_column_to_numpy(rb, columns[0]),
                               _column_to_numpy(rb, columns[1]))
    else:
        raise ValueError(f"unknown data kind {kind!r}")
    htt.broadcast_parameters(model, root_rank=0)
    params = list(model.parameters())
    inner = (opt_spec(params) if opt_spec is not None
             else torch.optim.Adam(params, lr=lr))
    opt = htt.DistributedOptimizer(inner, op=htt.Average)
    loss_fn = _loss_fn(model, loss_spec)

    def step(batch):
        if user_step is not None:
            # train_step(model, optimizer, loss_fn, batch) -> loss: a full
            # custom step (the reference's remote trainers likewise run
            # user training code).
            return user_step(model, opt, loss_fn, batch)
        loss = loss_fn(batch)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss

    cbs = CallbackList(list(callbacks or []))
    # The store travels pickled so custom Store subclasses keep their
    # behavior inside workers (only rank 0 writes).
    store = (_pickle.loads(store_bytes)
             if store_bytes and htt.rank() == 0 else None)

    history, val_history = [], []
    best = (float("inf"), -1)
    logs = {"metrics": {}, "lr": lr}
    cbs.on_train_begin(logs)
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        lr_before = logs["lr"]
        cbs.on_epoch_begin(epoch, logs)
        # Apply ONLY when a callback changed logs['lr']: the optimizer
        # (default or user-supplied) already carries its own initial rate,
        # which must not be stomped by the estimator's lr argument.
        if logs["lr"] != lr_before:
            _set_learning_rate(inner, logs["lr"])
        total = torch.zeros((), dtype=torch.float64, device=dev)
        n = 0
        for batch in loader:
            total += step(batch).detach().double()
            n += 1
        mean = total / max(n, 1)
        if htt.size() > 1:
            mean = htt.allreduce(mean, op=htt.Average)
        history.append(float(mean))
        record = {"epoch": epoch, "loss": history[-1]}
        if val_batches is not None and htt.rank() == 0:
            # Rank 0 only (loss_fn has no collectives), evaluated in
            # train-sized batches so a large split cannot exhaust the
            # card's memory.
            tot, m = 0.0, 0
            with torch.no_grad():
                for bxv, byv in val_batches():
                    tot += float(loss_fn((torch.from_numpy(bxv).to(dev),
                                          torch.from_numpy(byv).to(dev))
                                         )) * len(bxv)
                    m += len(bxv)
            vl = tot / max(m, 1)
            val_history.append(vl)
            record["val_loss"] = vl
        logs["metrics"] = dict(record)
        logs["state"] = model
        cbs.on_epoch_end(epoch, logs)
        metric = record.get("val_loss", record["loss"])
        is_best = metric < best[0]
        if is_best:
            best = (metric, epoch)
        if store is not None:
            host = _host_state(model)
            store.save_checkpoint(run_id, f"epoch{epoch:04d}", host)
            store.append_log(run_id, record)
            if is_best:
                store.save_checkpoint(run_id, "best", host)
    return {"params": _host_state(model) if htt.rank() == 0 else None,
            "history": history, "val_history": val_history,
            "best_epoch": best[1], "rank": htt.rank()}


def _predict(model, params, x: np.ndarray, device) -> np.ndarray:
    import torch
    model.load_state_dict(params)
    model.to(device)
    with torch.no_grad():
        out = model(torch.from_numpy(np.ascontiguousarray(x)).to(device))
    return out.float().cpu().numpy()


def _transform_worker(payload: bytes, spec: dict):
    """Runs inside each pool worker: predict this rank's row-group shard
    and write one output Parquet part file (ref the reference's
    cluster-side HorovodModel.transform / keras remote inference)."""
    import os

    import pyarrow as pa
    import pyarrow.parquet as pq

    import horovod_tpu_torch as htt
    from horovod_tpu_torch.data.parquet_loader import (_column_to_numpy,
                                                       list_parquet_files)
    from horovod_tpu_torch.runtime import context

    model, params = _pickle.loads(payload)
    dev = context.get_context().device
    rank, world = htt.rank(), htt.size()
    row_groups = []
    for f in list_parquet_files(spec["path"]):
        for rg in range(pq.ParquetFile(f).metadata.num_row_groups):
            row_groups.append((f, rg))
    mine = row_groups[rank::world]
    os.makedirs(spec["output_path"], exist_ok=True)
    out_file = os.path.join(spec["output_path"],
                            f"part-{rank:05d}.parquet")
    writer = None
    rows = 0
    try:
        for f, rg in mine:
            pf = pq.ParquetFile(f)
            for rb in pf.iter_batches(batch_size=spec["batch_size"],
                                      row_groups=[rg]):
                feats = _column_to_numpy(rb, spec["features_col"])
                pred = _predict(model, params, feats, dev)
                tbl = pa.Table.from_batches([rb])
                col = (pa.array(list(pred)) if pred.ndim > 1
                       else pa.array(pred))
                tbl = tbl.append_column(spec["prediction_col"], col)
                if writer is None:
                    writer = pq.ParquetWriter(out_file, tbl.schema)
                writer.write_table(tbl)
                rows += len(feats)
    finally:
        if writer is not None:
            writer.close()
    return {"rank": rank, "rows": rows,
            "file": out_file if writer is not None else None}


class TpuModel:
    """Servable trained model (ref HorovodModel transformer,
    spark/common/estimator.py): the module and its trained state (a
    ``state_dict`` of CPU tensors)."""

    def __init__(self, model, params, history: List[float],
                 val_history: Optional[List[float]] = None,
                 best_epoch: int = -1):
        self.model = model
        self.params = params
        self.history = history
        self.val_history = val_history or []
        self.best_epoch = best_epoch

    def predict(self, x: np.ndarray, device=None) -> np.ndarray:
        """The model's outputs on ``x`` as float32 numpy; on the card
        unless ``device="cpu"`` (or ``HVD_TPU_FORCE_CPU=1``)."""
        from horovod_tpu_torch.data.data_loader import loader_device
        return _predict(self.model, self.params, x, loader_device(device))

    # -- store round-trip (ref HorovodModel save/load via the Store) --------
    SAVE_FORMAT_VERSION = 1

    def save(self, store, run_id: str) -> None:
        """Serialize model definition + params with format versioning (ref
        spark/common/estimator.py model serialization with wrapped
        state; versioning lets future formats evolve loadably)."""
        from horovod_tpu_torch.version import __version__
        store.save_checkpoint(run_id, "model", {
            "format_version": self.SAVE_FORMAT_VERSION,
            "library_version": __version__,
            "model": self.model, "params": self.params,
            "history": self.history, "val_history": self.val_history,
            "best_epoch": self.best_epoch})

    @staticmethod
    def load(store, run_id: str, checkpoint: str = "model") -> "TpuModel":
        d = store.load_checkpoint(run_id, checkpoint)
        if isinstance(d, dict) and "model" in d:
            version = d.get("format_version", 0)
            if version > TpuModel.SAVE_FORMAT_VERSION:
                raise ValueError(
                    f"checkpoint format v{version} is newer than this "
                    f"library supports (v{TpuModel.SAVE_FORMAT_VERSION}); "
                    f"saved by horovod_tpu_torch "
                    f"{d.get('library_version', '?')}")
            return TpuModel(d["model"], d["params"], d["history"],
                            d.get("val_history"), d.get("best_epoch", -1))
        raise ValueError(
            f"checkpoint {checkpoint!r} holds raw params, not a saved "
            f"TpuModel — use store.load_checkpoint + the original model")

    # -- distributed inference (ref HorovodModel.transform adding a
    #    prediction column cluster-side, spark/common/estimator.py) ---------
    def transform(self, path: str, output_path: str,
                  features_col: str = "features",
                  prediction_col: str = "prediction",
                  batch_size: int = 1024, num_workers: int = 2,
                  executor: Optional[Any] = None) -> str:
        """Batched distributed inference over a Parquet dataset directory:
        workers shard row groups, stream batches through the model, and
        write output Parquet shards carrying every input column plus
        ``prediction_col``. Returns ``output_path``."""
        import glob
        import os

        from horovod_tpu_torch.data.parquet_loader import list_parquet_files
        from horovod_tpu_torch.integrations.executor import TpuExecutor
        list_parquet_files(path)      # fail in the driver, not N workers
        # A re-run with fewer workers must not leave stale shards from a
        # previous transform mixed into the output.
        for stale in glob.glob(os.path.join(output_path, "part-*.parquet")):
            os.remove(stale)
        payload = _pickle.dumps((_cpu_copy(self.model), self.params))
        spec = {"path": path, "output_path": output_path,
                "features_col": features_col,
                "prediction_col": prediction_col,
                "batch_size": int(batch_size)}
        own = executor is None
        ex = executor or TpuExecutor(num_workers).start()
        try:
            ex.run(_transform_worker, args=(payload, spec))
        finally:
            if own:
                ex.shutdown()
        return output_path


def _cpu_copy(model):
    """A copy of ``model`` on the CPU: what is pickled to the workers,
    which place it on their own cards."""
    return copy.deepcopy(model).cpu()


class TpuEstimator:
    """fit(x, y) -> TpuModel over a distributed worker pool
    (ref HorovodEstimator.fit, spark/common/estimator.py:25; params mirror
    the reference's model/optimizer/loss/batch_size/epochs surface, plus
    ``validation`` split and a ``store`` for per-epoch + best-model
    checkpoints, ref spark/common/store.py + keras BestModelCheckpoint).

    Call ``fit`` under ``if __name__ == "__main__":``: the worker pool
    uses spawn processes (see TpuExecutor)."""

    def __init__(self, model, loss: Any = "classification",
                 batch_size: int = 32, epochs: int = 2, lr: float = 1e-3,
                 num_workers: int = 2, seed: int = 0,
                 validation: float = 0.0, store: Optional[Any] = None,
                 run_id: str = "run0",
                 executor: Optional[Any] = None,
                 optimizer: Optional[Any] = None,
                 train_step: Optional[Any] = None,
                 callbacks: Optional[List[Any]] = None):
        """``model``: an ``nn.Module`` (its parameters are what rank 0
        broadcasts). ``loss``: "classification" | "regression" | callable
        ``loss(model, batch) -> scalar``. ``optimizer``: a factory
        ``params -> torch.optim.Optimizer`` (default ``Adam(params,
        lr)``). ``train_step``: full custom step ``train_step(model,
        optimizer, loss_fn, batch) -> loss`` that runs the backward and
        the optimizer itself. ``callbacks``:
        horovod_tpu_torch.callbacks.Callback list, fired in every worker
        (rank-gated callbacks gate themselves, like the reference's keras
        estimator callbacks, spark/keras/remote.py). ``seed`` seeds each
        worker's torch generator."""
        if not callable(loss) and loss not in ("classification",
                                               "regression"):
            raise ValueError(f"unknown loss kind {loss!r}")
        if not 0.0 <= validation < 1.0:
            raise ValueError(f"validation must be in [0, 1), "
                             f"got {validation}")
        self.model = model
        self.loss = loss
        self.optimizer = optimizer
        self.train_step = train_step
        self.callbacks = list(callbacks or [])
        self.batch_size = batch_size
        self.epochs = epochs
        self.lr = lr
        self.num_workers = num_workers
        self.seed = seed
        self.validation = validation
        self.store = store
        self.run_id = run_id
        self._executor = executor

    def fit(self, x: np.ndarray, y: np.ndarray) -> TpuModel:
        """In-memory arrays (pickled into the workers)."""
        return self._fit(("arrays", (x, y)))

    def fit_on_parquet(self, path: str, features_col: str = "features",
                       label_col: str = "label",
                       val_path: Optional[str] = None) -> TpuModel:
        """Fit from a Parquet dataset directory on shared storage: workers
        STREAM their batches through ParquetShardedLoader; the dataset is
        never pickled to them nor materialized in memory (ref
        HorovodEstimator.fit's Store-materialized Parquet + Petastorm
        reader, spark/common/estimator.py:25, spark/keras/remote.py).
        ``val_path`` is a separate Parquet dir evaluated on rank 0 per
        epoch (streaming makes a fractional split ill-defined; the
        reference likewise takes validation as its own reader)."""
        from horovod_tpu_torch.data.parquet_loader import list_parquet_files
        list_parquet_files(path)        # fail in the driver, not N workers
        if val_path:
            list_parquet_files(val_path)
        elif self.validation:
            raise ValueError(
                "validation fraction is only defined for in-memory fit(); "
                "streaming Parquet validation takes its own dataset — pass "
                "val_path=")
        return self._fit(("parquet", {
            "path": path, "features_col": features_col,
            "label_col": label_col, "val_path": val_path}))

    def fit_on_dataframe(self, df, features_col: Any = "features",
                         label_col: str = "label",
                         val_df: Optional[Any] = None,
                         rows_per_file: Optional[int] = None) -> TpuModel:
        """The reference's actual entry point, ``HorovodEstimator.fit(df)``
        (spark/common/estimator.py:25, util.py ``prepare_data``): the
        DataFrame is materialized to the Store as a Parquet dataset, then
        training streams it via :meth:`fit_on_parquet`.

        ``df``: a pandas DataFrame, anything with ``toPandas()`` (a Spark
        DataFrame on a small dataset), or anything with
        ``.write.parquet(path)`` (a Spark DataFrame at scale: the write
        happens cluster-side, nothing is collected to the driver).

        ``features_col``: one column holding array-likes, or a LIST of
        numeric columns assembled into a feature vector (the reference's
        VectorAssembler convention) and written as ``"features"``.

        The Parquet lands in ``store.train_data_path(run_id)`` when the
        estimator has a store that hosts files, else a temp directory.
        """
        import os
        import shutil
        import tempfile

        base = self.store.train_data_path(self.run_id) if self.store else None
        tmp_base = None
        if base is None:
            if self.store is not None:
                from horovod_tpu_torch.utils.logging import get_logger
                get_logger().warning(
                    "store %s does not host worker-streamable files "
                    "(train_data_path is None) — materializing the "
                    "DataFrame to a driver-local temp dir; workers must "
                    "share this host's filesystem", type(self.store).__name__)
            tmp_base = tempfile.mkdtemp(prefix="tpu_est_")
            base = os.path.join(tmp_base, "data")
        try:
            train_path = os.path.join(base, "train")
            written_col = self._materialize_dataframe(
                df, train_path, features_col, label_col, rows_per_file)
            val_path = None
            if val_df is not None:
                val_path = os.path.join(base, "val")
                self._materialize_dataframe(
                    val_df, val_path, features_col, label_col,
                    rows_per_file)
            return self.fit_on_parquet(
                train_path, features_col=written_col, label_col=label_col,
                val_path=val_path)
        finally:
            if tmp_base is not None:       # nothing references it after fit
                shutil.rmtree(tmp_base, ignore_errors=True)

    def _materialize_dataframe(self, df, path, features_col, label_col,
                               rows_per_file) -> str:
        """DataFrame -> Parquet dataset at ``path``; returns the features
        column name in the written dataset."""
        import math
        import os
        import shutil

        from horovod_tpu_torch.data.parquet_loader import (
            write_parquet_dataset)

        if os.path.isdir(path):
            shutil.rmtree(path)       # a re-fit must not mix stale parts
        # Spark-at-scale path: cluster-side write, nothing collected.
        if hasattr(df, "write") and not hasattr(df, "to_numpy") \
                and not isinstance(features_col, (list, tuple)):
            self._reject_vector_udt(df, features_col)
            # Row-group layout control: each Spark partition becomes >=
            # one Parquet file, and ParquetShardedLoader needs >= one row
            # group per worker (ideally ~2 for skew slack) or its epoch
            # comes up empty. A DataFrame arriving in fewer partitions
            # than that (e.g. a narrow source or a coalesce upstream) is
            # repartitioned before the write.
            target_parts = 2 * max(self.num_workers, 1)
            n_parts = None
            try:
                n_parts = df.rdd.getNumPartitions()
            except Exception:
                pass                       # non-Spark writer double; skip
            if hasattr(df, "repartition") and (n_parts is None
                                               or n_parts < target_parts):
                try:
                    df = df.repartition(target_parts)
                except Exception:
                    from horovod_tpu_torch.utils.logging import get_logger
                    get_logger().warning(
                        "could not repartition the DataFrame to %d "
                        "partitions before the Parquet write; if the "
                        "loader later reports an EMPTY epoch, run "
                        "df.repartition(%d) before fit()", target_parts,
                        target_parts)
            df.write.mode("overwrite").parquet(path)
            return features_col
        if hasattr(df, "toPandas") and not hasattr(df, "to_numpy"):
            df = df.toPandas()
        if isinstance(features_col, (list, tuple)):
            feats = np.column_stack(
                [np.asarray(df[c], np.float32) for c in features_col])
            name = "features"
        else:
            arr = np.asarray(df[features_col])
            feats = np.stack([np.asarray(v) for v in arr]) \
                if arr.dtype == object else arr
            name = features_col
        labels = np.asarray(df[label_col])
        n = len(labels)
        if rows_per_file is None:
            # Invariants the streaming loader needs: >= one file per
            # worker (file count n/rows_per_file >= W) and every shard >=
            # the PER-PROCESS batch (batch_size/W, not the global batch:
            # the loader raises loudly otherwise). ~2 files per worker
            # for a little skew slack, floored at the local batch.
            local_batch = math.ceil(self.batch_size
                                    / max(self.num_workers, 1))
            rows_per_file = min(
                max(local_batch, math.ceil(n / max(2 * self.num_workers,
                                                   1))),
                max(n // max(self.num_workers, 1), 1))
        write_parquet_dataset(path, {name: feats, label_col: labels},
                              rows_per_file=rows_per_file)
        return name

    @staticmethod
    def _reject_vector_udt(df, features_col) -> None:
        """Spark ML VectorUDT columns serialize to Parquet as a
        type/size/indices/values struct the streaming loader cannot read:
        reject with the standard conversion (the reference's prepare_data
        does this conversion itself, util.py)."""
        schema = getattr(df, "schema", None)
        if schema is None:
            return
        try:
            field = schema[features_col]
            type_name = str(getattr(field, "dataType", "")).lower()
        except Exception:
            return
        if "vector" in type_name:
            raise ValueError(
                f"column {features_col!r} is a Spark ML vector (VectorUDT)"
                f", which Parquet stores as a struct the worker-side "
                f"loader cannot read. Convert first: df.withColumn("
                f"{features_col!r}, pyspark.ml.functions.vector_to_array("
                f"df[{features_col!r}]))")

    def _fit(self, data) -> TpuModel:
        from horovod_tpu_torch.integrations.executor import TpuExecutor
        model = _cpu_copy(self.model)
        model_bytes = _pickle.dumps((model, self.loss, self.optimizer,
                                     self.train_step, self.callbacks))
        own_executor = self._executor is None
        ex = self._executor or TpuExecutor(self.num_workers).start()
        store_bytes = (_pickle.dumps(self.store)
                       if self.store is not None else None)
        if self.store is not None:
            # The estimator owns the run_id: a re-fit starts the run fresh
            # (stale epoch checkpoints / appended logs from a previous fit
            # would otherwise mix into this run's artifacts). Artifacts
            # only: fit_on_dataframe may have just materialized the
            # training Parquet under this run's train_data_path.
            self.store.delete_run_artifacts(self.run_id)
        try:
            results = ex.run(_fit_worker,
                             args=(model_bytes, data, self.batch_size,
                                   self.epochs, self.lr, self.seed,
                                   self.validation, store_bytes,
                                   self.run_id))
        finally:
            if own_executor:
                ex.shutdown()
        root = next(r for r in results if r["params"] is not None)
        fitted = TpuModel(model, root["params"], root["history"],
                          root.get("val_history"),
                          root.get("best_epoch", -1))
        if self.store is not None:
            fitted.save(self.store, self.run_id)
        return fitted
