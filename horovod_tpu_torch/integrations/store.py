"""Artifact store for estimators: checkpoints, logs, run metadata. The
counterpart of ``horovod_tpu/integrations/store.py``.

Reference parity: ``horovod.spark.common.store.Store`` (reference:
spark/common/store.py: LocalStore/HDFSStore/S3Store/DBFS abstraction with
``get_checkpoint_path``/``get_logs_path`` per run and saving-path
management). ``FilesystemStore`` covers any mounted path (local disk,
NFS, gcsfuse); ``FsspecStore`` covers remote blob URLs (s3://, gs://,
hdfs://, memory://: any installed fsspec protocol), the role the
reference's HDFSStore/S3Store/DBFSLocalStore fill; ``fsspec`` is imported
when one is made. ``Store.create`` dispatches on the prefix like the
reference's factory. Objects are written with cloudpickle where it is
installed and with pickle otherwise; the estimator stores host tensors
and numpy arrays.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

try:
    import cloudpickle as _pickle
except ImportError:               # pragma: no cover
    import pickle as _pickle


class Store:
    """Abstract artifact store (ref store.py Store)."""

    @staticmethod
    def create(prefix_path: str) -> "Store":
        """Factory mirroring the reference's ``Store.create`` dispatch
        (store.py Store.create: HDFS/S3/DBFS by URL, local otherwise):
        a URL with a protocol goes to the fsspec backend, a plain path to
        the local filesystem."""
        if "://" in prefix_path:
            return FsspecStore(prefix_path)
        return FilesystemStore(prefix_path)

    # -- paths ---------------------------------------------------------------
    def checkpoint_path(self, run_id: str) -> str:
        raise NotImplementedError

    def logs_path(self, run_id: str) -> str:
        raise NotImplementedError

    def train_data_path(self, run_id: str) -> Optional[str]:
        """Directory where ``fit_on_dataframe`` materializes the training
        Parquet (ref store.py get_train_data_path — the DataFrame->Store
        bridge of HorovodEstimator.fit). None = store cannot host
        worker-streamable files (the estimator falls back to a temp dir)."""
        return None

    def delete_run_artifacts(self, run_id: str) -> None:
        """Clear a run's checkpoints + logs. Subclasses that host
        materialized training data (train_data_path not None) MUST
        override to preserve it — the default falls back to delete_run,
        which is only safe when there is no train data to lose."""
        if self.train_data_path(run_id) is not None:
            raise NotImplementedError(
                f"{type(self).__name__} overrides train_data_path but "
                f"not delete_run_artifacts — a delete_run fallback would "
                f"destroy the just-materialized training data")
        self.delete_run(run_id)

    # -- artifacts -----------------------------------------------------------
    def save_checkpoint(self, run_id: str, name: str, obj: Any) -> str:
        raise NotImplementedError

    def load_checkpoint(self, run_id: str, name: str) -> Any:
        raise NotImplementedError

    def exists(self, run_id: str, name: str) -> bool:
        raise NotImplementedError

    def list_checkpoints(self, run_id: str) -> List[str]:
        raise NotImplementedError


class FilesystemStore(Store):
    """Store rooted at a directory (ref LocalStore / FilesystemStore)."""

    def __init__(self, prefix_path: str):
        self.prefix_path = os.path.abspath(prefix_path)

    def checkpoint_path(self, run_id: str) -> str:
        return os.path.join(self.prefix_path, run_id, "checkpoints")

    def logs_path(self, run_id: str) -> str:
        return os.path.join(self.prefix_path, run_id, "logs")

    def train_data_path(self, run_id: str) -> str:
        return os.path.join(self.prefix_path, run_id, "train_data")

    def _ckpt_file(self, run_id: str, name: str) -> str:
        return os.path.join(self.checkpoint_path(run_id), f"{name}.pkl")

    def save_checkpoint(self, run_id: str, name: str, obj: Any) -> str:
        path = self._ckpt_file(run_id, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            _pickle.dump(obj, f)
        os.replace(tmp, path)       # atomic: readers never see partials
        return path

    def load_checkpoint(self, run_id: str, name: str) -> Any:
        with open(self._ckpt_file(run_id, name), "rb") as f:
            return _pickle.load(f)

    def exists(self, run_id: str, name: str) -> bool:
        return os.path.exists(self._ckpt_file(run_id, name))

    def list_checkpoints(self, run_id: str) -> List[str]:
        d = self.checkpoint_path(run_id)
        if not os.path.isdir(d):
            return []
        return sorted(f[:-4] for f in os.listdir(d) if f.endswith(".pkl"))

    # -- run logs ------------------------------------------------------------
    def append_log(self, run_id: str, record: Dict) -> None:
        d = self.logs_path(run_id)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "history.jsonl"), "a") as f:
            f.write(json.dumps(record) + "\n")

    def read_logs(self, run_id: str) -> List[Dict]:
        path = os.path.join(self.logs_path(run_id), "history.jsonl")
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return [json.loads(ln) for ln in f if ln.strip()]

    def delete_run(self, run_id: str) -> None:
        shutil.rmtree(os.path.join(self.prefix_path, run_id),
                      ignore_errors=True)

    def delete_run_artifacts(self, run_id: str) -> None:
        shutil.rmtree(self.checkpoint_path(run_id), ignore_errors=True)
        shutil.rmtree(self.logs_path(run_id), ignore_errors=True)


class FsspecStore(Store):
    """Store rooted at a remote URL through fsspec (ref HDFSStore/S3Store/
    DBFSLocalStore, spark/common/store.py): s3://bucket/prefix,
    gs://bucket/prefix, hdfs://namenode/prefix, memory://prefix (tests).
    Credentials/endpoints come from the protocol's normal environment
    configuration, like the reference's storage-options passthrough."""

    def __init__(self, prefix_url: str, **storage_options):
        import fsspec
        self.prefix_url = prefix_url.rstrip("/")
        self._fs, self._root = fsspec.core.url_to_fs(self.prefix_url,
                                                     **storage_options)
        # Pickled into workers (rank 0 checkpoints from inside the pool);
        # the filesystem object may hold live connections, so it is rebuilt
        # on unpickle.
        self._storage_options = storage_options

    def __getstate__(self):
        return {"prefix_url": self.prefix_url,
                "storage_options": self._storage_options}

    def __setstate__(self, state):
        self.__init__(state["prefix_url"], **state["storage_options"])

    # -- paths ---------------------------------------------------------------
    def checkpoint_path(self, run_id: str) -> str:
        return f"{self._root}/{run_id}/checkpoints"

    def logs_path(self, run_id: str) -> str:
        return f"{self._root}/{run_id}/logs"

    def _ckpt_file(self, run_id: str, name: str) -> str:
        return f"{self.checkpoint_path(run_id)}/{name}.pkl"

    # -- artifacts -----------------------------------------------------------
    def save_checkpoint(self, run_id: str, name: str, obj: Any) -> str:
        path = self._ckpt_file(run_id, name)
        self._fs.makedirs(self.checkpoint_path(run_id), exist_ok=True)
        # Same atomicity contract as FilesystemStore (tmp + rename: readers
        # never see partials) — fsspec file:// / NFS writes are not
        # atomic-on-close; on object stores mv degrades to copy+delete,
        # which is still write-then-publish.
        tmp = f"{path}.tmp.{os.getpid()}"
        with self._fs.open(tmp, "wb") as f:
            _pickle.dump(obj, f)
        # Try rename-over-existing first so an overwrite (re-saving 'best'
        # is the normal flow) never leaves a window with no checkpoint at
        # the key. Some backends (hdfs) refuse rename onto an existing key
        # — only those pay the brief rm+mv gap.
        try:
            self._fs.mv(tmp, path)
        except Exception:
            if not self._fs.exists(path):
                raise
            self._fs.rm(path)
            self._fs.mv(tmp, path)
        return path

    def load_checkpoint(self, run_id: str, name: str) -> Any:
        with self._fs.open(self._ckpt_file(run_id, name), "rb") as f:
            return _pickle.load(f)

    def exists(self, run_id: str, name: str) -> bool:
        return self._fs.exists(self._ckpt_file(run_id, name))

    def list_checkpoints(self, run_id: str) -> List[str]:
        d = self.checkpoint_path(run_id)
        if not self._fs.isdir(d):
            return []
        names = [p.rsplit("/", 1)[-1] for p in self._fs.ls(d, detail=False)]
        return sorted(n[:-4] for n in names if n.endswith(".pkl"))

    # -- run logs ------------------------------------------------------------
    def append_log(self, run_id: str, record: Dict) -> None:
        d = self.logs_path(run_id)
        self._fs.makedirs(d, exist_ok=True)
        path = f"{d}/history.jsonl"
        # Object stores have no true append; read-modify-write keeps the
        # same jsonl contract (one writer — rank 0 — so no races).
        prev = b""
        if self._fs.exists(path):
            with self._fs.open(path, "rb") as f:
                prev = f.read()
        with self._fs.open(path, "wb") as f:
            f.write(prev + (json.dumps(record) + "\n").encode())

    def read_logs(self, run_id: str) -> List[Dict]:
        path = f"{self.logs_path(run_id)}/history.jsonl"
        if not self._fs.exists(path):
            return []
        with self._fs.open(path, "rb") as f:
            return [json.loads(ln) for ln in f.read().decode().splitlines()
                    if ln.strip()]

    def delete_run(self, run_id: str) -> None:
        d = f"{self._root}/{run_id}"
        if self._fs.exists(d):
            self._fs.rm(d, recursive=True)

    def delete_run_artifacts(self, run_id: str) -> None:
        for d in (self.checkpoint_path(run_id), self.logs_path(run_id)):
            if self._fs.exists(d):
                self._fs.rm(d, recursive=True)

    def train_data_path(self, run_id: str) -> Optional[str]:
        """None: the streaming ParquetShardedLoader reads via local glob,
        so a remote URL cannot host worker-streamable training data yet —
        fit_on_dataframe falls back to a driver-local temp dir (and warns;
        single-host pools only)."""
        return None


# Back-compat alias matching the reference's most-used concrete name.
LocalStore = FilesystemStore
