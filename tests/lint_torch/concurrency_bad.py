"""hvdlint-torch fixture: concurrency violations (HVD3xx) around a c10d
store. NOT imported at runtime."""

import datetime
import signal
import threading

import torch.distributed as dist


class StoreBarrier:
    def __init__(self, store):
        self._store = store
        self._lock = threading.Lock()
        self._worker = threading.Thread(target=self.wait_all, args=([],),
                                        daemon=True)

    def wait_all(self, keys):
        self._store.wait(keys)                              # HVD305

    def wait_long(self, keys):
        self._store.wait(keys, datetime.timedelta(minutes=10))  # HVD305

    def read(self, key):
        return self._store.get(key)                         # HVD305

    def stop(self):
        with self._lock:
            self._worker.join()                             # HVD302


class TeardownOnSignal:
    def __init__(self):
        signal.signal(signal.SIGTERM, self._on_term)

    def _on_term(self, signum, frame):
        dist.destroy_process_group()                        # HVD304
