"""Shared access to the c10d store of the default process group.

The port's counterpart of ``horovod_tpu/utils/kvstore.py``, which wraps
the jax.distributed coordination service. Here the multi-rank
control-plane transport is the store ``torch.distributed`` rendezvoused
the world on (a ``TCPStore`` under ``init_method="env://"``): it is
reachable exactly when cross-rank synchronization is needed.

Every consumer goes through :func:`distributed_kv`, which returns the raw
:class:`DistributedKV` wrapped in ``resilience.faults.RetryingKV`` under
the caller's named call-site policy (``site=``). Chaos injection
(``resilience.chaos.on_kv``) happens HERE, beneath the retry layer, so
the chaos drills exercise the production recovery machinery.

The c10d store's semantics differ from the coordination service's, and
:class:`DistributedKV` maps them onto the JAX wrapper's:

- ``set`` on a c10d store always overwrites, while the coordination
  service is write-once by default. A write-once ``set`` is
  ``compare_set(key, "", value)``: it writes only a missing key and
  returns what the key holds; anything else than ``value`` raises
  ``ALREADY_EXISTS``.
- the blocking ``get`` is ``wait([key], timeout)`` then ``get``; the
  ``DistStoreError`` of a timeout becomes :class:`KVDeadlineExceeded`
  (``DEADLINE_EXCEEDED``), which the retry layer never retries.
- ``try_get`` is ``check`` then ``get`` (None for a missing key).
- ``delete`` is ``delete_key``, best effort.
- a ``DistNetworkError`` (the store's server is gone) becomes a
  ``ConnectionError`` carrying ``UNAVAILABLE``, which the retry layer
  retries.
"""

from __future__ import annotations

import datetime
import threading
from typing import Optional, Set

from horovod_tpu_torch.utils.logging import get_logger

logger = get_logger("horovod_tpu_torch.utils.kvstore")

# delete() failures are logged once per key-class (the key minus its
# last path component) and counted always.
_delete_warned: Set[str] = set()
_delete_warned_lock = threading.Lock()


class KVDeadlineExceeded(TimeoutError):
    """A blocking get's key did not appear within its timeout. Not a
    transport failure: retrying it would silently double the caller's
    wait."""


def _key_class(key: str) -> str:
    return key.rsplit("/", 1)[0] if "/" in key else key


def _chaos():
    from horovod_tpu_torch.resilience import chaos
    return chaos


def _text(v) -> str:
    return v.decode() if isinstance(v, (bytes, bytearray)) else str(v)


def _transport(fn):
    """Run a store call, turning the store's network failure into the
    transient ``UNAVAILABLE`` the retry layer knows."""
    import torch.distributed as dist
    try:
        return fn()
    except dist.DistNetworkError as e:
        raise ConnectionError(f"UNAVAILABLE: c10d store: {e}") from e


class DistributedKV:
    """Thin wrapper over a c10d ``Store``: write-once or overwriting set,
    blocking get, non-blocking try_get, best-effort delete."""

    def __init__(self, store):
        self._store = store

    @property
    def store(self):
        return self._store

    def set(self, key: str, value: str, overwrite: bool = False) -> None:
        """Write a key. Write-once unless ``overwrite=True`` (for
        periodically republished keys): a key that already holds another
        value raises ``ALREADY_EXISTS``."""
        _chaos().on_kv("set", key)
        if overwrite:
            _transport(lambda: self._store.set(key, value))
            return
        got = _text(_transport(
            lambda: self._store.compare_set(key, "", value)))
        if got != value:
            raise ValueError(f"ALREADY_EXISTS: {key} holds {got!r}")

    def get(self, key: str, timeout_s: float) -> str:
        """Blocking fetch; raises :class:`KVDeadlineExceeded` on
        timeout."""
        import torch.distributed as dist
        _chaos().on_kv("get", key)
        try:
            _transport(lambda: self._store.wait(
                [key], datetime.timedelta(seconds=float(timeout_s))))
        except dist.DistStoreError as e:
            raise KVDeadlineExceeded(
                f"DEADLINE_EXCEEDED: {key} not set within {timeout_s}s"
            ) from e
        return _text(_transport(lambda: self._store.get(key)))

    def try_get(self, key: str) -> Optional[str]:
        """Non-blocking fetch; None when the key does not exist yet.
        Transport failures propagate: they must not masquerade as 'peer
        not there yet'."""
        _chaos().on_kv("try_get", key)
        if not _transport(lambda: self._store.check([key])):
            return None
        return _text(_transport(lambda: self._store.get(key)))

    def delete(self, key: str) -> None:
        """Best-effort cleanup. Failures never raise, but each is counted
        (``hvd_kvstore_delete_failures_total``) and the first per
        key-class is logged."""
        try:
            _chaos().on_kv("delete", key)
            self._store.delete_key(key)
        except Exception:
            kc = _key_class(key)
            try:
                from horovod_tpu_torch import metrics as M
                M.counter(
                    "hvd_kvstore_delete_failures_total",
                    "Best-effort KV deletes that errored (cleanup only "
                    "— keys leak until the store goes away)",
                    labelnames=("key_class",)).labels(key_class=kc).inc()
            except Exception:       # metrics plane not up
                pass
            with _delete_warned_lock:
                first = kc not in _delete_warned
                if first:
                    _delete_warned.add(kc)
            if first:
                logger.warning(
                    "KV delete failed for key class %r (logged once per "
                    "class; every failure counts toward "
                    "hvd_kvstore_delete_failures_total)", kc,
                    exc_info=True)


def root_store(store):
    """The store under every ``PrefixStore`` layer of ``store``: the
    namespace of the server's own keys. ``init_process_group`` prefixes
    the default store's keys (``default_pg``, the group's name), and how
    depends on the torch release; a key a launcher writes on the server it
    hosts is read here."""
    import torch.distributed as dist
    while isinstance(store, dist.PrefixStore):
        store = store.underlying_store
    return store


def distributed_kv(site: str = "kv", own_connection: bool = False,
                   root: bool = False):
    """The default process group's store wrapped in the ``site``'s retry
    policy (resilience.faults.RetryingKV), or None in a world of one or
    without ``torch.distributed`` (there is no peer to agree with).

    ``root=True`` wraps :func:`root_store` of it: the keys of the
    launcher that hosts the store (the elastic hosts-updated mirror).

    ``own_connection=True`` wraps a ``clone`` of the store: a new client
    connection to the same server. A c10d client runs one operation at a
    time, so a thread that blocks in a long ``wait`` (the checkpoint
    commit barrier) takes its own, and the other threads' calls do not
    queue behind it.

    The SchedulerHooks seam may inject a substitute store; the wrapper
    stack (retry policy, NOT_FOUND mapping, best-effort delete) is the
    same real code either way."""
    from horovod_tpu_torch.resilience.faults import RetryingKV
    from horovod_tpu_torch.utils import schedhooks
    store = schedhooks.hooks().kv_client()
    if store is None:
        if schedhooks.process_world()[1] <= 1:
            return None
        import torch.distributed as dist
        store = dist.distributed_c10d._get_default_store()
    if root:
        store = root_store(store)
    if own_connection:
        store = store.clone()
    return RetryingKV(DistributedKV(store), site=site)
