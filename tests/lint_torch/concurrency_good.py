"""hvdlint-torch fixture: bounded c10d store waits — zero findings
expected."""

import datetime
import signal
import threading


class StoreBarrier:
    def __init__(self, store):
        self._store = store
        self._lock = threading.Lock()
        self._worker = threading.Thread(target=self.wait_all, args=([],),
                                        daemon=True)

    def wait_all(self, keys):
        self._store.wait(keys, datetime.timedelta(seconds=30))

    def budgeted(self, keys, budget):
        self._store.wait(keys, budget)       # non-literal: the caller's

    def read(self, key):
        # a bounded wait first: the get then finds the key
        self._store.wait([key], datetime.timedelta(seconds=30))
        return self._store.get(key)

    def try_read(self, key):
        if not self._store.check([key]):
            return None
        return self._store.get(key)

    def stop(self):
        self._worker.join(timeout=5)         # bounded, and no lock held


class RetryingKV:
    """The registered retry layer is exempt: its per-attempt calls are
    what retry_call composes into a budgeted wait."""

    def __init__(self, store):
        self.store = store

    def get(self, key):
        return self.store.get(key)


class FlagOnlySignalHandler:
    def __init__(self):
        self._pending = None
        signal.signal(signal.SIGTERM, self._on_term)

    def _on_term(self, signum, frame):
        self._pending = signum
