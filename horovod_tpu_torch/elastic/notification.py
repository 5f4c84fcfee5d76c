"""Worker notification RPC: the port's copy of
``horovod_tpu/elastic/notification.py`` (stdlib only; ref
horovod/runner/elastic/worker.py WorkerNotificationService/Client/
Manager: the driver pushes HostsUpdated
events to each worker over an authenticated socket; the worker's manager
fans them into registered State listeners).

Minimal TCP implementation: newline-delimited JSON with a shared-secret
HMAC, one server thread per worker process.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import secrets as _secrets
import socket
import socketserver
import threading
from typing import Callable, List, Optional, Tuple

# Env var carrying the per-run secret (hex) from driver to workers — the
# analogue of the reference's launcher-generated secret key
# (runner/common/util/secret.py make_secret_key passed via env).
SECRET_ENV = "HVD_TPU_SECRET"
# Static fallback for single-process tests only; any launched run gets a
# random per-run key from make_secret().
_TEST_SECRET = b"hvd-tpu"


def make_secret() -> bytes:
    """Random per-run secret, generated at driver/launcher startup."""
    return _secrets.token_bytes(32)


def resolve_secret(secret: Optional[bytes] = None) -> bytes:
    """Explicit secret > HVD_TPU_SECRET env (set by the launcher for worker
    processes) > static test fallback."""
    if secret is not None:
        return secret
    hexs = os.environ.get(SECRET_ENV)
    if hexs:
        return bytes.fromhex(hexs)
    return _TEST_SECRET


def _sign(secret: bytes, payload: bytes) -> str:
    return hmac.new(secret, payload, hashlib.sha256).hexdigest()


class WorkerNotificationService:
    """Listens for driver events; dispatches to registered listeners
    (ref worker.py WorkerNotificationService + Manager merged: the manager
    indirection exists for torch/tf session plumbing we don't need)."""

    def __init__(self, secret: Optional[bytes] = None):
        self._secret = resolve_secret(secret)
        self._listeners: List[Callable[[float, int], None]] = []
        self._server: Optional[socketserver.ThreadingTCPServer] = None
        self._thread: Optional[threading.Thread] = None

    def register_listener(self, fn: Callable[[float, int], None]) -> None:
        self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        self._listeners.remove(fn)

    @property
    def address(self) -> Tuple[str, int]:
        assert self._server is not None, "service not started"
        return self._server.server_address  # type: ignore[return-value]

    def start(self, port: int = 0) -> Tuple[str, int]:
        listeners = self._listeners
        secret = self._secret

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                line = self.rfile.readline()
                if not line:
                    return
                try:
                    msg = json.loads(line)
                    payload = json.dumps(msg["payload"]).encode()
                    if not hmac.compare_digest(
                            _sign(secret, payload), msg.get("sig", "")):
                        return
                    p = msg["payload"]
                    if p.get("type") == "hosts_updated":
                        for fn in list(listeners):
                            fn(p["timestamp"], p.get("res", 0))
                    self.wfile.write(b'{"ok": true}\n')
                except Exception:
                    # A swallowed listener/parse error here means a
                    # worker silently missed a topology change and will
                    # keep training with a stale world — log it and
                    # count it so /metrics shows the drop.
                    from horovod_tpu_torch import metrics as M
                    from horovod_tpu_torch.utils.logging import get_logger
                    M.counter(
                        "hvd_elastic_notification_failures_total",
                        "Worker notification deliveries that errored"
                    ).inc()
                    get_logger("horovod_tpu_torch.elastic").warning(
                        "worker notification handling failed; the "
                        "driver will see ok=false and retry",
                        exc_info=True)
                    self.wfile.write(b'{"ok": false}\n')

        self._server = socketserver.ThreadingTCPServer(
            ("127.0.0.1", port), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self.address

    def stop(self) -> None:
        if self._server:
            self._server.shutdown()
            self._server.server_close()


class WorkerNotificationClient:
    """Driver-side sender (ref worker.py WorkerNotificationClient)."""

    def __init__(self, address: Tuple[str, int],
                 secret: Optional[bytes] = None, timeout: float = 5.0):
        self.address = tuple(address)
        self._secret = resolve_secret(secret)
        self.timeout = timeout

    def notify_hosts_updated(self, timestamp: float, res: int = 0) -> bool:
        payload = {"type": "hosts_updated", "timestamp": timestamp,
                   "res": res}
        raw = json.dumps(payload).encode()
        msg = json.dumps({"payload": payload,
                          "sig": _sign(self._secret, raw)}) + "\n"
        try:
            with socket.create_connection(self.address,
                                          timeout=self.timeout) as s:
                s.sendall(msg.encode())
                resp = s.makefile().readline()
                return json.loads(resp).get("ok", False)
        except (OSError, ValueError):
            return False
