"""Input-pipeline compute service: dedicated data-producing processes
serving batches to training ranks over sockets. The counterpart of
``horovod_tpu/data/compute_service.py``.

Reference parity: the tf.data-service integration:
``TfDataServiceConfig`` / ``tf_data_service`` / ``send_to_data_service``
(reference: tensorflow/data/compute_service.py:33-142), the compute-side
worker main (tensorflow/data/compute_worker.py:26) and the registry
service (runner/common/service/compute_service.py).

Both planes are owned: a ``ComputeService`` registry (dispatcher/worker
registration + shutdown, HMAC-authenticated JSON RPC like the elastic
notification service) and ``DataWorker`` batch servers that stream
pickled numpy batches over length-prefixed TCP frames. The wire is the
JAX package's, byte for byte (the frames, the signed requests, the
pickled numpy responses), so a JAX worker serves a port consumer and the
other way round. Training ranks call ``data_service(config, rank)`` /
``distribute(...)`` to pull host batches, which then go to the rank's
card (``data_loader.PinnedStager``). Data workers are host processes by
design: they serve numpy and create no CUDA context.

Sharding model ("distributed_epoch" analogue): every worker instantiates
``dataset_fn(worker_index, num_workers)`` (source-level sharding) and
consumers drain ALL workers of their dispatcher concurrently,
first-come-first-served, so faster consumers take more batches (dynamic
load balancing) while each sample is produced exactly once per job.
A new ``job`` name starts a fresh pass (epoch) over every worker's shard.
``ResilientDataIterator`` is the deterministic consumer: batches defined
by a sampler, index-addressed workers, and a reshard in index order when
a worker dies (the ``data_worker_kill`` chaos drill).
"""

from __future__ import annotations

import dataclasses
import hmac
import json
import os
import pickle
import queue
import socket
import socketserver
import struct
import threading
import time
from pathlib import Path
from tempfile import NamedTemporaryFile
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from horovod_tpu_torch.elastic.notification import _sign, resolve_secret
from horovod_tpu_torch.utils.logging import get_logger

logger = get_logger("horovod_tpu_torch.data.compute_service")

_LEN = struct.Struct("!Q")
_END = "__end_of_shard__"

# Address to advertise in the registry when bound to 0.0.0.0 (multi-host:
# set to this host's reachable name/IP; reference analogue is the NIC
# discovery of runner/driver/driver_service.py).
ADVERTISE_ENV = "HVD_TPU_ADVERTISE_HOST"


def _advertise_host() -> str:
    host = os.environ.get(ADVERTISE_ENV)
    if host:
        return host
    try:
        addr = socket.gethostbyname(socket.gethostname())
        if not addr.startswith("127."):
            return addr
    except OSError:
        pass
    return "127.0.0.1"


# --------------------------------------------------------------------------
# Config (ref TfDataServiceConfig compute_service.py:33-86)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ComputeConfig:
    """Serializable description of a running compute service, written by
    the service owner and read by workers/consumers (ref
    TfDataServiceConfig.to_dict/from_dict/write/read)."""
    dispatchers: int
    workers_per_dispatcher: int
    dispatcher_side: str                  # "compute" | "training"
    address: Tuple[str, int]              # the ComputeService registry
    key: bytes
    timeout: float = 60.0

    def __post_init__(self):
        if self.dispatchers < 1:
            raise ValueError(f"dispatchers must be >= 1, "
                             f"got {self.dispatchers}")
        if self.workers_per_dispatcher < 1:
            raise ValueError(f"workers_per_dispatcher must be >= 1, "
                             f"got {self.workers_per_dispatcher}")
        if self.dispatcher_side not in ("compute", "training"):
            raise ValueError(f"dispatcher_side must be 'compute' or "
                             f"'training', got {self.dispatcher_side!r}")

    def compute_client(self) -> "ComputeClient":
        return ComputeClient(self.address, self.key, timeout=self.timeout)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["key"] = self.key.hex()
        d["address"] = list(self.address)
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ComputeConfig":
        return ComputeConfig(
            dispatchers=int(d["dispatchers"]),
            workers_per_dispatcher=int(d["workers_per_dispatcher"]),
            dispatcher_side=d["dispatcher_side"],
            address=(d["address"][0], int(d["address"][1])),
            key=bytes.fromhex(d["key"]),
            timeout=float(d.get("timeout", 60.0)))

    def write(self, filename: str) -> None:
        """Atomic write (temp file + rename, ref compute_service.py:67-76)
        so readers polling with ``wait_for_file_creation`` never see a
        partial config."""
        path = Path(filename)
        with NamedTemporaryFile("w", dir=str(path.parent),
                                prefix=path.name, delete=False) as w:
            w.write(json.dumps(self.to_dict()))
        os.rename(w.name, filename)

    @staticmethod
    def read(filename: str,
             wait_for_file_creation: bool = False,
             timeout: float = 60.0) -> "ComputeConfig":
        deadline = time.monotonic() + timeout
        while wait_for_file_creation and not os.path.exists(filename):
            if time.monotonic() > deadline:
                raise TimeoutError(f"config file {filename} never appeared")
            time.sleep(0.1)
        with open(filename) as r:
            return ComputeConfig.from_dict(json.load(r))


# --------------------------------------------------------------------------
# Registry service (ref runner/common/service/compute_service.py)
# --------------------------------------------------------------------------

class ComputeService:
    """Tracks dispatcher addresses and worker readiness; broadcasts
    shutdown. One per job, usually on the launcher/driver host.

    Liveness supervision: workers heartbeat on a
    ``HOROVOD_FAULT_HEARTBEAT_SECONDS`` cadence; a worker silent for
    longer than ``HOROVOD_FAULT_WORKER_DEADLINE`` is declared dead —
    ``get_workers`` separates it into a ``dead`` list so consumers stop
    assigning it work and reshard deterministically."""

    def __init__(self, dispatchers: int, workers_per_dispatcher: int,
                 key: Optional[bytes] = None):
        self._key = resolve_secret(key)
        self._lock = threading.Condition()
        self._dispatchers = dispatchers
        self._workers_per_dispatcher = workers_per_dispatcher
        # dispatcher_id -> list of (host, port) worker batch servers
        self._dispatcher_addresses: Dict[int, Tuple[str, int]] = {}
        self._workers: Dict[int, List[Tuple[str, int]]] = {}
        # (host, port) -> monotonic time of last heartbeat/registration
        self._worker_seen: Dict[Tuple[str, int], float] = {}
        self._shutdown = False
        self._server: Optional[socketserver.ThreadingTCPServer] = None

    # -- server side --------------------------------------------------------
    def start(self, port: int = 0) -> Tuple[str, int]:
        svc = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                line = self.rfile.readline()
                if not line:
                    return
                try:
                    msg = json.loads(line)
                    payload_raw = json.dumps(msg["payload"]).encode()
                    if not hmac.compare_digest(
                            _sign(svc._key, payload_raw),
                            msg.get("sig", "")):
                        return
                    resp = svc._handle(msg["payload"])
                except Exception as exc:     # malformed request
                    resp = {"ok": False, "error": str(exc)}
                self.wfile.write((json.dumps(resp) + "\n").encode())

        self._server = socketserver.ThreadingTCPServer(("0.0.0.0", port),
                                                       Handler)
        self._server.daemon_threads = True
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        host, prt = self._server.server_address[:2]
        return (_advertise_host() if host == "0.0.0.0" else host, prt)

    def _handle(self, p: Dict[str, Any]) -> Dict[str, Any]:
        op = p.get("op")
        with self._lock:
            if op == "register_dispatcher":
                did = int(p["dispatcher_id"])
                if not 0 <= did < self._dispatchers:
                    return {"ok": False,
                            "error": f"dispatcher id {did} out of range"}
                self._dispatcher_addresses[did] = (p["host"], int(p["port"]))
                self._lock.notify_all()
                return {"ok": True}
            if op == "get_dispatcher":
                addr = self._dispatcher_addresses.get(int(p["dispatcher_id"]))
                return {"ok": True, "address": addr,
                        "shutdown": self._shutdown}
            if op == "register_worker":
                did = int(p["dispatcher_id"])
                if not 0 <= did < self._dispatchers:
                    return {"ok": False,
                            "error": f"dispatcher id {did} out of range"}
                addr = (p["host"], int(p["port"]))
                self._workers.setdefault(did, []).append(addr)
                self._lock.notify_all()
                return {"ok": True}
            if op == "heartbeat":
                self._worker_seen[(p["host"], int(p["port"]))] = \
                    time.monotonic()
                return {"ok": True, "shutdown": self._shutdown}
            if op == "get_workers":
                did = int(p["dispatcher_id"])
                from horovod_tpu_torch.resilience.faults import worker_deadline_s
                deadline = worker_deadline_s()
                now = time.monotonic()
                live, dead = [], []
                for addr in self._workers.get(did, []):
                    # Deadline supervision applies only to workers that
                    # have EVER heartbeat: legacy workers registered via
                    # the lower-level DataWorker.start()+register path
                    # (no heartbeat loop) must not be declared dead just
                    # for predating the supervision feature — their
                    # failures still surface as socket errors.
                    seen = self._worker_seen.get(tuple(addr))
                    is_dead = seen is not None and now - seen > deadline
                    (dead if is_dead else live).append(list(addr))
                return {"ok": True,
                        "workers": live,
                        "dead": dead,
                        "expected": self._workers_per_dispatcher,
                        "shutdown": self._shutdown}
            if op == "shutdown":
                self._shutdown = True
                self._lock.notify_all()
                return {"ok": True}
            if op == "poll_shutdown":
                return {"ok": True, "shutdown": self._shutdown}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def stop(self) -> None:
        if self._server:
            self._server.shutdown()
            self._server.server_close()


class ComputeClient:
    """RPC client to the registry (ref ComputeClient
    runner/common/service/compute_service.py)."""

    def __init__(self, address: Tuple[str, int], key: Optional[bytes] = None,
                 timeout: float = 60.0):
        self.address = tuple(address)
        self._key = resolve_secret(key)
        self.timeout = timeout

    def _call(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        raw = json.dumps(payload).encode()
        msg = json.dumps({"payload": payload,
                          "sig": _sign(self._key, raw)}) + "\n"
        with socket.create_connection(self.address, timeout=10.0) as s:
            s.sendall(msg.encode())
            resp = json.loads(s.makefile().readline())
        if not resp.get("ok"):
            raise RuntimeError(f"compute service: {resp.get('error')}")
        return resp

    def register_dispatcher(self, dispatcher_id: int, host: str,
                            port: int) -> None:
        self._call({"op": "register_dispatcher",
                    "dispatcher_id": dispatcher_id,
                    "host": host, "port": port})

    def wait_for_dispatcher_registration(
            self, dispatcher_id: int,
            timeout: Optional[float] = None) -> Tuple[str, int]:
        deadline = time.monotonic() + (timeout or self.timeout)
        while True:
            resp = self._call({"op": "get_dispatcher",
                               "dispatcher_id": dispatcher_id})
            if resp.get("address"):
                return tuple(resp["address"])
            if resp.get("shutdown"):
                raise RuntimeError("compute service shut down while waiting")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"dispatcher {dispatcher_id} never registered")
            time.sleep(0.1)

    def register_worker_for_dispatcher(self, dispatcher_id: int, host: str,
                                       port: int) -> None:
        self._call({"op": "register_worker", "dispatcher_id": dispatcher_id,
                    "host": host, "port": port})

    def heartbeat(self, host: str, port: int) -> bool:
        """Worker liveness beat; returns the registry's shutdown flag so
        the heartbeat loop doubles as a shutdown poll."""
        return bool(self._call({"op": "heartbeat", "host": host,
                                "port": port}).get("shutdown"))

    def worker_health(self, dispatcher_id: int) -> Dict[str, Any]:
        """{'workers': live addrs, 'dead': deadline-expired addrs}."""
        resp = self._call({"op": "get_workers",
                           "dispatcher_id": dispatcher_id})
        return {"workers": [tuple(w) for w in resp["workers"]],
                "dead": [tuple(w) for w in resp.get("dead", [])]}

    def wait_for_dispatcher_worker_registration(
            self, dispatcher_id: int,
            timeout: Optional[float] = None) -> List[Tuple[str, int]]:
        deadline = time.monotonic() + (timeout or self.timeout)
        while True:
            resp = self._call({"op": "get_workers",
                               "dispatcher_id": dispatcher_id})
            workers = [tuple(w) for w in resp["workers"]]
            if len(workers) >= resp["expected"]:
                return workers
            if resp.get("shutdown"):
                raise RuntimeError("compute service shut down while waiting")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"dispatcher {dispatcher_id}: "
                    f"{len(workers)}/{resp['expected']} workers registered")
            time.sleep(0.1)

    def shutdown(self) -> None:
        self._call({"op": "shutdown"})

    def wait_for_shutdown(self, poll: float = 0.5) -> None:
        while not self._call({"op": "poll_shutdown"})["shutdown"]:
            time.sleep(poll)


# --------------------------------------------------------------------------
# Data plane: worker batch servers + consumer iterator
# --------------------------------------------------------------------------

def _send_raw(sock: socket.socket, data: bytes) -> None:
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_raw(sock: socket.socket) -> bytearray:
    hdr = b""
    while len(hdr) < _LEN.size:
        chunk = sock.recv(_LEN.size - len(hdr))
        if not chunk:
            raise ConnectionError("peer closed")
        hdr += chunk
    (n,) = _LEN.unpack(hdr)
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        m = sock.recv_into(view[got:], n - got)
        if not m:
            raise ConnectionError("peer closed mid-frame")
        got += m
    return buf


def _send_request(sock: socket.socket, key: bytes,
                  payload: Dict[str, Any]) -> None:
    """Requests are HMAC-signed JSON — the worker never unpickles anything
    from the network, so an unauthenticated peer cannot execute code."""
    raw = json.dumps(payload).encode()
    _send_raw(sock, json.dumps({"payload": payload,
                                "sig": _sign(key, raw)}).encode())


def _recv_request(sock: socket.socket, key: bytes) -> Dict[str, Any]:
    msg = json.loads(bytes(_recv_raw(sock)))
    raw = json.dumps(msg["payload"]).encode()
    if not hmac.compare_digest(_sign(key, raw), msg.get("sig", "")):
        raise PermissionError("bad request signature")
    return msg["payload"]


def _send_batch(sock: socket.socket, obj: Any) -> None:
    _send_raw(sock, pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))


def _recv_batch(sock: socket.socket) -> Any:
    # The consumer initiated this connection to a registry-vouched worker
    # address; pickle.loads accepts the bytearray directly (no copy).
    return pickle.loads(_recv_raw(sock))


class DataWorker:
    """One data-producing server: owns this worker's dataset shard and
    streams batches to authenticated consumers, one shared pass per job
    name (the reference's tf.data WorkerServer analogue, but the iteration
    is ours). Requests are HMAC-signed JSON; only responses (numpy batches
    flowing worker->consumer) use pickle.

    ``random_access=True`` additionally serves the index-addressed
    ``get_items`` op: ``dataset_fn(worker_index, num_workers)`` must then
    return a random-access sequence over the FULL dataset (``__getitem__``
    by global sample index) — sharding becomes advisory load-balancing,
    which is what makes deterministic reshard-on-death possible: any
    surviving worker can serve any index, so batch composition is defined
    by the sampler, never by which worker happened to answer
    (:class:`ResilientDataIterator`)."""

    def __init__(self, dataset_fn: Callable[[int, int], Any],
                 worker_index: int, num_workers: int,
                 key: Optional[bytes] = None,
                 random_access: bool = False):
        self._dataset_fn = dataset_fn
        self._index = worker_index
        self._num_workers = num_workers
        self._key = resolve_secret(key)
        self._lock = threading.Lock()
        self._jobs: Dict[str, Iterator] = {}
        self._finished_jobs: set = set()
        self._server: Optional[socketserver.ThreadingTCPServer] = None
        self._random_access = random_access
        self._data: Any = None
        self._served = 0
        self._dead = False
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None

    def _next_batch(self, job: str) -> Any:
        with self._lock:
            if job in self._finished_jobs:
                return _END
            it = self._jobs.get(job)
            if it is None:
                it = iter(self._dataset_fn(self._index, self._num_workers))
                self._jobs[job] = it
            try:
                return next(it)
            except StopIteration:
                self._finished_jobs.add(job)
                del self._jobs[job]
                return _END

    def _get_items(self, indices: List[int]) -> List[Any]:
        if not self._random_access:
            raise ValueError("worker not started in random_access mode")
        # Lock covers ONLY the lazy dataset build: reads are concurrent,
        # so one consumer's large slice cannot serialize every other
        # connection's batch behind a worker-wide mutex.
        data = self._data
        if data is None:
            with self._lock:
                if self._data is None:
                    self._data = self._dataset_fn(self._index,
                                                  self._num_workers)
                data = self._data
        return [data[int(i)] for i in indices]

    def _chaos_check(self) -> None:
        """data_worker_kill injection: die ABRUPTLY (server torn down,
        sockets reset, no goodbye) so consumers exercise the real
        failure shape."""
        from horovod_tpu_torch.resilience import chaos
        with self._lock:
            self._served += 1
            served = self._served
        if self._dead or chaos.on_data_request(self._index, served):
            self.kill()
            raise ConnectionResetError(
                f"data worker {self._index} died (chaos)")

    def kill(self) -> None:
        """Abrupt death (chaos/data-worker-kill drill): stop serving and
        close the listening socket WITHOUT draining connections — unlike
        ``stop()``, in-flight consumers see resets, exactly like a
        process crash. Heartbeats stop too, so the registry's deadline
        supervision declares this worker dead."""
        self._dead = True
        self._hb_stop.set()
        srv = self._server
        if srv is not None:
            # shutdown() must not be called from a handler thread of the
            # same server (deadlock); a side thread tears it down.
            threading.Thread(target=srv.shutdown, daemon=True).start()
            try:
                srv.server_close()
            except OSError:
                pass

    # -- liveness -----------------------------------------------------------
    def start_heartbeats(self, client: "ComputeClient", host: str,
                         port: int) -> None:
        """Beat to the registry on the HOROVOD_FAULT_HEARTBEAT_SECONDS
        cadence until stopped/killed (worker supervision)."""
        from horovod_tpu_torch.resilience.faults import heartbeat_interval_s

        def loop():
            while not self._hb_stop.wait(heartbeat_interval_s()):
                try:
                    if client.heartbeat(host, port):
                        return               # registry says shutdown
                except Exception:
                    logger.warning("data-worker heartbeat failed",
                                   exc_info=True)

        self._hb_thread = threading.Thread(
            target=loop, name=f"hvd-data-hb-{self._index}", daemon=True)
        self._hb_thread.start()

    def start(self, port: int = 0) -> Tuple[str, int]:
        worker = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                # Persistent connection: loop get-requests until close.
                try:
                    while True:
                        req = _recv_request(self.request, worker._key)
                        worker._chaos_check()
                        if req.get("op") == "get":
                            _send_batch(self.request,
                                        worker._next_batch(req["job"]))
                        elif req.get("op") == "get_items":
                            _send_batch(self.request, worker._get_items(
                                req.get("indices", [])))
                        else:
                            _send_batch(self.request, _END)
                except PermissionError:
                    return           # unauthenticated peer: drop silently
                except (ConnectionError, OSError):
                    # Consumer hang-ups at close are routine — a debug
                    # line, no failure counter (counting them would
                    # drown real failures in disconnect noise).
                    from horovod_tpu_torch.utils.logging import get_logger
                    get_logger("horovod_tpu_torch.data").debug(
                        "data-service connection closed", exc_info=True)
                except (ValueError, KeyError):
                    # A malformed request is a real failure: the puller
                    # waiting on this socket starves — warn and count.
                    from horovod_tpu_torch import metrics as M
                    from horovod_tpu_torch.utils.logging import get_logger
                    M.counter(
                        "hvd_data_service_handler_failures_total",
                        "Data-service connections dropped on malformed "
                        "requests").inc()
                    get_logger("horovod_tpu_torch.data").warning(
                        "data-service connection dropped on a malformed "
                        "request", exc_info=True)

        self._server = socketserver.ThreadingTCPServer(("0.0.0.0", port),
                                                       Handler)
        self._server.daemon_threads = True
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        host, prt = self._server.server_address[:2]
        return (_advertise_host() if host == "0.0.0.0" else host, prt)

    def stop(self) -> None:
        self._hb_stop.set()
        if self._server and not self._dead:
            self._server.shutdown()
            self._server.server_close()


class DataServiceIterator:
    """Consumer-side iterator: drains all workers of one dispatcher
    concurrently (one puller thread per worker feeding a bounded queue —
    the prefetch pipeline), first-come-first-served like
    processing_mode='distributed_epoch'.

    Supports early exit: ``close()`` (or leaving a ``with`` block, or a
    ``break`` followed by GC) stops the puller threads and closes their
    sockets. Note that like a tf.data-service job, an abandoned job leaves
    each worker's shard iterator mid-pass — use a fresh job name per epoch
    rather than resuming an abandoned one."""

    def __init__(self, workers: List[Tuple[str, int]], job: str,
                 prefetch: int = 4, key: Optional[bytes] = None):
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._errors: "queue.Queue" = queue.Queue()
        self._key = resolve_secret(key)
        self._live = len(workers)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._socks: List[socket.socket] = []
        self._threads = [
            threading.Thread(target=self._pull, args=(addr, job),
                             daemon=True)
            for addr in workers]
        for t in self._threads:
            t.start()

    def _put_retrying(self, item) -> None:
        """Blocking put that stays responsive to close(): retry while the
        bounded queue is full, bail once the stop flag is set (close()
        drains the queue, so a blocked producer always observes the flag)."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.25)
                return
            except queue.Full:
                continue

    def _pull(self, addr: Tuple[str, int], job: str) -> None:
        try:
            with socket.create_connection(addr, timeout=60.0) as s:
                with self._lock:
                    if self._stop.is_set():
                        return
                    self._socks.append(s)
                while not self._stop.is_set():
                    _send_request(s, self._key, {"op": "get", "job": job})
                    batch = _recv_batch(s)
                    if isinstance(batch, str) and batch == _END:
                        break
                    self._put_retrying(batch)
        except Exception as exc:
            if not self._stop.is_set():
                self._errors.put(exc)
        finally:
            with self._lock:
                self._live -= 1
                last = self._live == 0
            if last:
                # The queue being full here is normal (the consumer may lag
                # by up to `prefetch` batches), so the sentinel must retry
                # like batch puts do — dropping it would leave the consumer
                # blocked forever in __next__ after draining the batches.
                self._put_retrying(_END)

    def close(self) -> None:
        """Stop pulling: unblock producer threads and close sockets."""
        self._stop.set()
        for s in list(self._socks):
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        # Drain so any producer blocked on put() observes the stop flag.
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self._stop.set()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if isinstance(item, str) and item == _END:
            if not self._errors.empty():
                raise self._errors.get()
            raise StopIteration
        return item


class ResilientDataIterator:
    """Deterministic, fault-tolerant consumer: batch composition is
    defined by an :class:`ElasticSampler`'s seeded index order — NEVER by
    worker timing — and workers are index-addressed ``random_access``
    servers, so a worker dying mid-epoch triggers a
    *deterministic* reshard: the dead worker's pending indices are
    reassigned to survivors in index order, the items land in the same
    batches in the same order, and the training trajectory is
    bitwise-identical to an uninterrupted run (chaos tier proves it
    end-to-end).

    Assignment: index ``k``-th of a batch goes to ``live[k % len(live)]``
    — pure load balancing; which worker serves an item never changes what
    the item is. Worker death is detected by socket errors (resets,
    refused connections) and by the registry's heartbeat deadline when a
    ``client`` is provided; each death increments
    ``hvd_data_worker_deaths_total`` and the reshard
    ``hvd_data_reshards_total``.

    The sampler records each completed batch (``record_batch``), so an
    elastic world resize mid-epoch repartitions only the unprocessed
    remainder (elastic/sampler.py state carryover).
    """

    def __init__(self, workers: List[Tuple[str, int]], sampler: Any,
                 batch_size: int, key: Optional[bytes] = None,
                 client: Optional["ComputeClient"] = None,
                 dispatcher_id: int = 0,
                 connect_timeout: Optional[float] = None):
        from horovod_tpu_torch.resilience.faults import worker_deadline_s
        if not workers:
            raise ValueError("no data workers")
        self._workers = [tuple(w) for w in workers]
        self._alive = {w: True for w in self._workers}
        self._sampler = sampler
        self._batch_size = int(batch_size)
        self._key = resolve_secret(key)
        self._client = client
        self._dispatcher_id = dispatcher_id
        self._timeout = (connect_timeout if connect_timeout is not None
                         else worker_deadline_s())
        self._socks: Dict[Tuple[str, int], socket.socket] = {}
        self._state_lock = threading.Lock()   # _alive/_socks mutations
        self._batch_idx = 0

    # -- worker transport ---------------------------------------------------
    def _sock(self, addr: Tuple[str, int]) -> socket.socket:
        s = self._socks.get(addr)
        if s is None:
            s = socket.create_connection(addr, timeout=self._timeout)
            self._socks[addr] = s
        return s

    def _fetch_from(self, addr: Tuple[str, int],
                    indices: List[int]) -> List[Any]:
        s = self._sock(addr)
        _send_request(s, self._key, {"op": "get_items",
                                     "indices": [int(i) for i in indices]})
        out = _recv_batch(s)
        if not isinstance(out, list) or len(out) != len(indices):
            raise ConnectionError(
                f"worker {addr} returned {type(out).__name__} "
                f"instead of {len(indices)} items")
        return out

    def _mark_dead(self, addr: Tuple[str, int], why: str) -> None:
        with self._state_lock:
            if not self._alive.get(addr):
                return
            self._alive[addr] = False
            s = self._socks.pop(addr, None)
        if s is not None:
            try:
                s.close()
            except OSError:
                pass
        from horovod_tpu_torch import metrics as M
        M.counter("hvd_data_worker_deaths_total",
                  "Data-service workers declared dead by a consumer "
                  "(socket failure or heartbeat deadline)").inc()
        logger.warning("data worker %s declared dead (%s); resharding "
                       "its pending work onto %d survivors", addr, why,
                       sum(self._alive.values()))

    def _check_registry_health(self) -> None:
        """Fold the registry's heartbeat-deadline view in (when a client
        was provided): a hung-but-connected worker is declared dead here
        rather than stalling the epoch on its socket timeout."""
        if self._client is None:
            return
        try:
            dead = self._client.worker_health(self._dispatcher_id)["dead"]
        except Exception:
            return                  # registry unreachable: rely on sockets
        for addr in dead:
            self._mark_dead(tuple(addr), "heartbeat deadline")

    # -- deterministic fetch ------------------------------------------------
    def _live_workers(self) -> List[Tuple[str, int]]:
        return [w for w in self._workers if self._alive[w]]

    def _fetch(self, indices: List[int]) -> List[Any]:
        results: Dict[int, Any] = {}
        pending = list(indices)
        while pending:
            live = self._live_workers()
            if not live:
                raise RuntimeError(
                    f"all {len(self._workers)} data workers are dead; "
                    f"{len(pending)} samples of the current batch cannot "
                    f"be served — restart the compute service")
            assignment: Dict[Tuple[str, int], List[int]] = {}
            for k, idx in enumerate(pending):
                assignment.setdefault(live[k % len(live)], []).append(idx)
            # One thread per worker slice: batch wall time is the
            # SLOWEST worker's serve time, not the sum of all round
            # trips. Determinism is untouched — results are keyed by
            # sample index, and each worker's cached socket is used by
            # exactly one thread per round. Non-transport exceptions
            # (bad payloads, programming errors) are collected and
            # re-raised on the calling thread — swallowing one would
            # leave its indices pending and spin this loop forever.
            resharded = [False]
            errors: List[BaseException] = []

            def fetch_one(addr, idxs):
                try:
                    for idx, item in zip(idxs,
                                         self._fetch_from(addr, idxs)):
                        results[idx] = item
                except (ConnectionError, OSError) as e:
                    self._mark_dead(addr, str(e) or type(e).__name__)
                    resharded[0] = True
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    errors.append(e)

            if len(assignment) == 1:
                addr, idxs = next(iter(assignment.items()))
                fetch_one(addr, idxs)
            else:
                threads = [threading.Thread(target=fetch_one,
                                            args=(addr, idxs), daemon=True)
                           for addr, idxs in assignment.items()]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
            if errors:
                raise errors[0]
            pending = [i for i in indices if i not in results]
            if resharded[0] and pending:
                from horovod_tpu_torch import metrics as M
                M.counter("hvd_data_reshards_total",
                          "Deterministic reassignments of a dead data "
                          "worker's pending samples onto survivors").inc()
                self._check_registry_health()
        return [results[i] for i in indices]

    # -- iterator protocol --------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self) -> List[Any]:
        start = self._batch_idx * self._batch_size
        indices = [int(i) for i in
                   self._sampler.indices[start:start + self._batch_size]]
        if not indices:
            raise StopIteration
        batch = self._fetch(indices)
        self._sampler.record_batch(self._batch_idx, self._batch_size)
        self._batch_idx += 1
        return batch

    def close(self) -> None:
        for s in self._socks.values():
            try:
                s.close()
            except OSError:
                pass
        self._socks.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# --------------------------------------------------------------------------
# User entry points (ref tf_data_service / send_to_data_service /
# compute_worker_fn)
# --------------------------------------------------------------------------

def compute_worker_fn(config: ComputeConfig,
                      dataset_fn: Callable[[int, int], Any],
                      index: int, size: int,
                      random_access: bool = False) -> None:
    """Run on each compute process: optionally host this dispatcher's
    registry entry, start the batch server + liveness heartbeats, serve
    until shutdown (ref compute_worker_fn
    tensorflow/data/compute_service.py:148-207)."""
    client = config.compute_client()
    dispatcher_index = index // config.workers_per_dispatcher
    if not 0 <= dispatcher_index < config.dispatchers:
        raise ValueError(
            f"worker index {index} maps to dispatcher {dispatcher_index}, "
            f"out of range for {config.dispatchers} dispatchers x "
            f"{config.workers_per_dispatcher} workers")

    if (config.dispatcher_side == "compute"
            and index % config.workers_per_dispatcher == 0):
        # Dispatcher here is a logical registration: the registry itself
        # brokers addresses; batch flow is direct consumer->worker.
        client.register_dispatcher(dispatcher_index, "127.0.0.1", 0)
        logger.info("registered dispatcher %d", dispatcher_index)

    client.wait_for_dispatcher_registration(dispatcher_index, config.timeout)

    worker = DataWorker(dataset_fn, worker_index=index, num_workers=size,
                        key=config.key, random_access=random_access)
    host, port = worker.start()
    client.register_worker_for_dispatcher(dispatcher_index, host, port)
    worker.start_heartbeats(client, host, port)
    logger.info("worker %d serving dispatcher %d at %s:%d",
                index, dispatcher_index, host, port)
    try:
        client.wait_for_shutdown()
    finally:
        worker.stop()


class data_service:
    """Training-side context manager: resolves this rank's dispatcher and
    waits for its workers (ref tf_data_service compute_service.py:88-123).
    Yields the worker address list to build iterators from."""

    def __init__(self, config: ComputeConfig, rank: int):
        self._config = config
        self._rank = rank
        self._client = config.compute_client()

    def __enter__(self) -> List[Tuple[str, int]]:
        cfg = self._config
        dispatcher_id = self._rank if cfg.dispatchers > 1 else 0
        if not 0 <= dispatcher_id < cfg.dispatchers:
            raise ValueError(
                f"rank {self._rank} needs dispatcher {dispatcher_id}, but "
                f"the service has {cfg.dispatchers} dispatchers — with "
                f"dispatchers > 1 there must be one per training rank")
        if cfg.dispatcher_side == "training" and (
                cfg.dispatchers > 1 or self._rank == 0):
            self._client.register_dispatcher(dispatcher_id, "127.0.0.1", 0)
        self._client.wait_for_dispatcher_registration(dispatcher_id,
                                                      cfg.timeout)
        return self._client.wait_for_dispatcher_worker_registration(
            dispatcher_id, cfg.timeout)

    def __exit__(self, *exc) -> None:
        return None


def distribute(config: ComputeConfig, rank: int, job: str = "job0",
               prefetch: int = 4) -> DataServiceIterator:
    """One-call consumer entry (ref send_to_data_service
    compute_service.py:125-142): resolve workers, return a streaming
    batch iterator for ``job``."""
    with data_service(config, rank) as workers:
        return DataServiceIterator(workers, job=job, prefetch=prefetch,
                                   key=config.key)
