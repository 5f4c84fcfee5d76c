"""Elastic worker state + the ``elastic.run`` wrapper.

The counterpart of ``horovod_tpu/elastic/state.py``. Reference:
horovod/common/elastic.py — ``State`` (:26: save/restore/commit/
check_host_updates/on_reset), ``ObjectState`` (:116), ``run_fn`` (:151:
the retry loop catching HorovodInternalError / HostsUpdatedInterrupt);
horovod/torch/elastic/state.py — ``TorchState`` with its model, optimizer
and sampler handlers.

``TorchState`` snapshots the model's and the optimizer's ``state_dict``
tensors to the CPU on commit (the card's memory goes with a process that
is respawned) and restores them by writing into the live tensors, then
broadcasting rank 0's, so the same object works across worlds of any
size.
"""

from __future__ import annotations

import os
import pickle
import queue
import sys
from typing import Any, Callable, Dict, List, Optional

import torch

from horovod_tpu_torch.elastic.exceptions import (HorovodInternalError,
                                                  HostsUpdatedInterrupt,
                                                  PreemptionInterrupt)


class State:
    """Base elastic state (ref common/elastic.py:26)."""

    def __init__(self, **kwargs):
        self._host_messages: "queue.Queue" = queue.Queue()
        self._last_updated_timestamp = 0.0
        self._reset_callbacks: List[Callable[[], None]] = []
        self._last_kv_fallback_poll = 0.0
        import time as _time
        self._created_wall_time = _time.time()

    def register_reset_callbacks(self, callbacks) -> None:
        """Callbacks replayed after every reset (e.g. rescale LR to the new
        world size — ref common/elastic.py:40)."""
        self._reset_callbacks.extend(callbacks)

    def on_reset(self) -> None:
        from horovod_tpu_torch.tracing import spans as trace
        with trace.span("elastic.reset", cat=trace.CAT_ELASTIC):
            self.reset()
            for cb in self._reset_callbacks:
                cb()

    def on_reset_generation(self) -> None:
        """Replay reset callbacks in a respawned elastic worker: generation
        >= 2 means this process exists because the world was re-formed, so
        user callbacks (e.g. rescale LR to the new world size) must fire
        exactly as the reference's on_reset does after an in-process
        reset."""
        if int(os.environ.get("HVD_ELASTIC_GENERATION", "1")) > 1:
            self.on_reset()

    def on_hosts_updated(self, timestamp: float,
                         update_res: int = 0) -> None:
        """Driver notification entry point (thread-safe)."""
        self._host_messages.put((timestamp, update_res))

    def commit(self) -> None:
        """Save + raise HostsUpdatedInterrupt if topology changed
        (ref common/elastic.py:60), or PreemptionInterrupt if this host
        has an armed preemption handler (resilience/preemption.py) — the
        state was just persisted, so the commit boundary is exactly where
        a maintenance-evicted worker can exit resumable without losing
        work."""
        self.save()
        self.check_host_updates()
        self.check_preemption()

    def check_preemption(self) -> None:
        from horovod_tpu_torch.resilience import preemption as _preemption
        h = _preemption.active_handler()
        if h is not None and h.requested:
            raise PreemptionInterrupt(h.reason or "preemption requested")

    def check_host_updates(self) -> None:
        """Drain driver notifications; interrupt if any arrived
        (ref common/elastic.py:75-96). Also polls the driver's KV-store
        mirror (throttled): when a socket push was dropped, the mirror is
        how the update still lands."""
        self._poll_kv_fallback()
        from horovod_tpu_torch.elastic.discovery import HostUpdateResult
        updated = False
        skip_sync = True
        while True:
            try:
                timestamp, res = self._host_messages.get_nowait()
            except queue.Empty:
                break
            if timestamp > self._last_updated_timestamp:
                self._last_updated_timestamp = timestamp
                updated = True
                # Pure removals leave the survivors' state intact, so sync
                # can be skipped; any ADDED/MIXED change brings new workers
                # that need rank-0 state (ref common/elastic.py:96).
                skip_sync = skip_sync and res == HostUpdateResult.REMOVED
        if updated:
            raise HostsUpdatedInterrupt(skip_sync=skip_sync)

    def _poll_kv_fallback(self) -> None:
        """Best-effort read of the driver's hosts-updated KV mirror
        (elastic/driver._mirror_hosts_updated_kv), throttled to one try a
        second; a fresh event is enqueued like a socket-delivered one.
        Events wall-stamped before this process started are ignored: the
        mirror persists in the store, and a worker respawned BY that very
        update must not re-consume it and restart forever."""
        import time as _time
        now = _time.monotonic()
        if now - self._last_kv_fallback_poll < 1.0:
            return
        self._last_kv_fallback_poll = now
        try:
            from horovod_tpu_torch.resilience import faults
            from horovod_tpu_torch.utils.kvstore import distributed_kv
            kv = distributed_kv(site="elastic_notification", root=True)
            if kv is None:
                return
            dom = faults.fault_domain()
            if "elastic_notification" in dom.shed_sites():
                # degraded: this poll sits on the commit path, so the
                # probe that heals the site is ONE bounded attempt
                if faults.should_shed("elastic_notification"):
                    return
                try:
                    raw = kv.inner.try_get("hvd/elastic/hosts_updated")
                except Exception:
                    return
                dom.record_success("elastic_notification")
            else:
                raw = kv.try_get("hvd/elastic/hosts_updated")
            if not raw:
                return
            import json as _json
            msg = _json.loads(raw)
            if float(msg.get("wall_time", 0.0)) < self._created_wall_time:
                return                      # stale: predates this process
            if float(msg["timestamp"]) > self._last_updated_timestamp:
                self._host_messages.put(
                    (float(msg["timestamp"]), int(msg.get("res", 0))))
        except Exception:
            # A fallback for a fallback: never break the commit path.
            from horovod_tpu_torch.utils.logging import get_logger
            get_logger("horovod_tpu_torch.elastic").debug(
                "hosts-updated KV fallback poll failed", exc_info=True)

    # subclass interface
    def save(self) -> None:
        raise NotImplementedError

    def restore(self) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class ObjectState(State):
    """Plain-attribute state (ref common/elastic.py:116): arbitrary Python
    values stored as attributes, snapshotted on commit, broadcast on sync."""

    def __init__(self, **kwargs):
        super().__init__()
        self._saved: Dict[str, Any] = dict(kwargs)
        for k, v in kwargs.items():
            setattr(self, k, v)

    def save(self) -> None:
        self._saved = {k: getattr(self, k) for k in self._saved}

    def restore(self) -> None:
        for k, v in self._saved.items():
            setattr(self, k, v)

    def sync(self) -> None:
        from horovod_tpu_torch.functions import broadcast_object
        self._saved = broadcast_object(self._saved, root_rank=0)
        self.restore()


def _to_cpu(tree: Any) -> Any:
    """A copy of a ``state_dict`` with every tensor cloned to the CPU."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _load_optimizer(opt: torch.optim.Optimizer, snap: Dict[str, Any]) -> None:
    """Write an optimizer ``state_dict`` snapshot into ``opt``: tensors of
    the same shape and dtype are written in place (objects that hold them
    keep seeing the live values), others are placed on the parameter's
    device; hyperparameters come from the snapshot's param groups."""
    params = [p for g in opt.param_groups for p in g["params"]]
    ids = [i for g in snap["param_groups"] for i in g["params"]]
    with torch.no_grad():
        for p, i in zip(params, ids):
            src = snap["state"].get(i)
            if src is None:
                opt.state.pop(p, None)
                continue
            dst = opt.state[p]
            for k in [k for k in dst if k not in src]:
                del dst[k]
            for k, v in src.items():
                t = dst.get(k)
                if torch.is_tensor(v) and torch.is_tensor(t) and \
                        t.shape == v.shape and t.dtype == v.dtype:
                    t.copy_(v)
                elif torch.is_tensor(v):
                    dst[k] = v.to(p.device if v.dim() else v.device,
                                  copy=True)
                else:
                    dst[k] = v
    for g, sg in zip(opt.param_groups, snap["param_groups"]):
        g.update({k: v for k, v in sg.items() if k != "params"})


class TorchState(ObjectState):
    """Model, optimizer and sampler state (ref torch/elastic/state.py:27
    TorchState with ModelStateHandler/OptimizerStateHandler/
    SamplerStateHandler); the counterpart of the JAX package's
    ``TpuState``.

    ``model`` (an ``nn.Module``) and ``optimizer`` (a
    ``torch.optim.Optimizer``, or a wrapper with ``.optimizer`` such as
    ``DistributedOptimizer``) are committed as CPU copies of their
    ``state_dict`` and restored into the live tensors; ``sampler`` (an
    :class:`ElasticSampler`) through its own ``state_dict``. Any other
    keyword is a plain attribute, as in :class:`ObjectState`.
    """

    def __init__(self, model=None, optimizer=None, sampler=None,
                 checkpoint_dir: Optional[str] = None, **kwargs):
        self.model = model
        self.optimizer = optimizer
        self.sampler = sampler
        # On-disk commit store for the elastic restart protocol (the
        # reset is a controlled process respawn — see
        # runner/elastic_run.py — so committed state must outlive the
        # process). Defaults to the launcher's HVD_ELASTIC_STATE_DIR.
        from horovod_tpu_torch.elastic import worker as _worker
        self._checkpoint_dir = checkpoint_dir or _worker.state_dir()
        super().__init__(**kwargs)
        self._array_snapshots: Dict[str, Any] = {}
        self._sampler_snapshot = None
        # Initial in-memory snapshot WITHOUT persisting: writing first would
        # clobber the previous generation's on-disk commit before
        # _load_committed can adopt it (a respawned worker would then
        # retrain from scratch).
        self._persist_enabled = False
        self.save()
        self._persist_enabled = True
        self._load_committed()

    def _optimizer(self) -> Optional[torch.optim.Optimizer]:
        return getattr(self.optimizer, "optimizer", self.optimizer)

    # -- disk commit store ---------------------------------------------------
    def _ckpt_path(self) -> Optional[str]:
        if not self._checkpoint_dir:
            return None
        from horovod_tpu_torch.elastic import worker as _worker
        host, lrank = _worker.slot_identity()
        return os.path.join(self._checkpoint_dir,
                            f"state-{host}-{lrank}.pkl")

    def _persist(self) -> None:
        path = self._ckpt_path()
        if not path or not self._persist_enabled:
            return
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = {"objects": self._saved,
                   "arrays": self._array_snapshots,
                   "sampler": self._sampler_snapshot}
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f)
        os.replace(tmp, path)      # atomic commit

    def _load_committed(self) -> None:
        """Adopt the previous generation's committed snapshot (respawned
        worker). Fresh workers on new hosts have no file: their state
        converges to root's at the first sync()."""
        path = self._ckpt_path()
        if not path or not os.path.exists(path):
            return
        with open(path, "rb") as f:
            payload = pickle.load(f)
        self._saved = payload["objects"]
        self._array_snapshots = payload["arrays"]
        self._sampler_snapshot = payload["sampler"]

    def save(self) -> None:
        super().save()
        if self.model is not None:
            self._array_snapshots["model"] = _to_cpu(self.model.state_dict())
        opt = self._optimizer()
        if opt is not None:
            self._array_snapshots["optimizer"] = _to_cpu(opt.state_dict())
        if self.sampler is not None:
            self._sampler_snapshot = self.sampler.state_dict()
        self._persist()

    def restore(self) -> None:
        """Write the committed snapshot into the live model and optimizer,
        then make every rank's rank 0's (a broadcast, when the runtime is
        up in a world larger than one)."""
        super().restore()
        snap = self._array_snapshots
        if self.model is not None and "model" in snap:
            self.model.load_state_dict(snap["model"])
        opt = self._optimizer()
        if opt is not None and "optimizer" in snap:
            _load_optimizer(opt, snap["optimizer"])
        import horovod_tpu_torch as htt
        if htt.is_initialized() and htt.size() > 1:
            from horovod_tpu_torch.functions import (
                broadcast_optimizer_state, broadcast_parameters)
            if self.model is not None:
                broadcast_parameters(self.model, root_rank=0)
            if opt is not None:
                broadcast_optimizer_state(opt, root_rank=0)
        if self.sampler is not None and self._sampler_snapshot is not None:
            self.sampler.load_state_dict(self._sampler_snapshot)

    def sync(self) -> None:
        """Re-agree on the committed state across the (possibly new)
        world: root's objects and tensors win, as in the reference's
        rank-0 broadcast.

        The sampler snapshot is special: the sampler records *per-rank*
        ``processed_indices``, so broadcasting only root's snapshot would
        discard every other rank's progress and those samples would be
        seen twice. Each rank's processed set is allgathered and unioned
        before the broadcast (``resize.merge_sampler_states``)."""
        from horovod_tpu_torch.elastic.resize import merge_sampler_states
        from horovod_tpu_torch.functions import (allgather_object,
                                                 broadcast_object)
        sampler_snap = self._sampler_snapshot
        if sampler_snap is not None:
            sampler_snap = merge_sampler_states(
                allgather_object(sampler_snap))
        payload = {"objects": self._saved, "sampler": sampler_snap}
        payload = broadcast_object(payload, root_rank=0)
        self._saved = payload["objects"]
        self._sampler_snapshot = payload["sampler"]
        self.restore()


def run(func: Callable) -> Callable:
    """``elastic.run`` decorator (ref common/elastic.py:151 run_fn):

        @elastic.run
        def train(state, ...): ...

    Loop: state.sync() -> func; on HorovodInternalError: reset the runtime
    (shutdown + init), restore the committed state, retry; on
    HostsUpdatedInterrupt: reset and retry without a sync when only
    hosts were removed. ``reset_limit`` caps the resets (ref elastic
    driver reset-limit test). Under the elastic launcher
    (``HVD_ELASTIC_RUN``) a reset is a respawn instead: the worker exits
    with RESTART_EXIT_CODE (73), or 75 on a preemption.
    """

    def wrapper(state: State, *args, reset_limit: Optional[int] = None,
                **kwargs):
        from horovod_tpu_torch.elastic import worker as _worker
        if _worker.is_elastic_worker():
            return _run_elastic_worker(func, state, args, kwargs)
        reset_count = 0
        skip_sync = False
        while True:
            if not skip_sync:
                state.sync()
            failed = False
            try:
                return func(state, *args, **kwargs)
            except HorovodInternalError:
                from horovod_tpu_torch import metrics as _M
                _M.counter("hvd_elastic_failures_total",
                           "Recoverable collective failures caught by "
                           "elastic.run (state restored)").inc()
                failed = True
                skip_sync = False
            except HostsUpdatedInterrupt as e:
                skip_sync = e.skip_sync
            reset_count += 1
            from horovod_tpu_torch import metrics as _M
            _M.counter("hvd_elastic_resets_total",
                       "Runtime resets (shutdown + re-init on a new "
                       "topology) performed by elastic.run").inc()
            if reset_limit is not None and reset_count > reset_limit:
                raise RuntimeError(
                    f"exceeded reset limit {reset_limit}; aborting")
            _reset_runtime()
            if failed:
                # after the reset: restore broadcasts over the new world,
                # never over the one whose collective just failed
                state.restore()
            state.on_reset()

    return wrapper


def _run_elastic_worker(func, state, args, kwargs):
    """Worker body under the elastic launcher (runner/elastic_run.py):
    register for driver notifications, sync committed state onto the new
    world, run; on a topology interrupt or internal error exit with
    RESTART_EXIT_CODE so the launcher re-forms the world with the state
    this process committed to disk."""
    from horovod_tpu_torch.elastic import worker as _worker
    ctx = _worker.ElasticWorkerContext(state)
    try:
        state.sync()
        ctx.report_ready()
        state.on_reset_generation()
        result = func(state, *args, **kwargs)
        return result
    except (HostsUpdatedInterrupt, HorovodInternalError):
        # commit() already persisted (or, mid-step, the disk store holds
        # the last commit for the respawned generation to restore). Hand
        # the world back to the launcher with a HARD exit: a graceful exit
        # would run the process group's teardown, which can block on the
        # very peer whose death triggered this interrupt.
        ctx.close()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(_worker.RESTART_EXIT_CODE)
    except PreemptionInterrupt:
        # State is committed; tell the launcher this was a deliberate
        # preemption quiesce (no blacklist, restore-latest on respawn).
        from horovod_tpu_torch.resilience.preemption import \
            RESUMABLE_EXIT_CODE
        ctx.close()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(RESUMABLE_EXIT_CODE)
    finally:
        ctx.close()


def _reset_runtime() -> None:
    """Shutdown + re-init the runtime on the same device type (the
    reference's shutdown + rendezvous + init cycle, common/elastic.py:166).

    Outstanding eager handles are resolved FIRST with ResizeInterrupt
    (``eager.reset_outstanding``): a wait on a work of the destroyed
    process group would otherwise hang or fail obscurely."""
    import horovod_tpu_torch as htt
    device = "cuda"
    if htt.is_initialized():
        from horovod_tpu_torch import eager
        from horovod_tpu_torch.runtime.context import get_context
        device = get_context().device.type
        eager.reset_outstanding()
        htt.shutdown()
    htt.init(device=device)
