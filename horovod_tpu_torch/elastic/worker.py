"""Worker-side elastic bootstrap: the port's copy of
``horovod_tpu/elastic/worker.py`` (ref horovod/runner/elastic/worker.py
WorkerNotificationManager + runner/task_fn.py worker registration).

An elastically-launched worker (env ``HVD_ELASTIC_RUN=1``, set by the
elastic launcher) on entering ``hvd.elastic.run``:

1. starts its WorkerNotificationService (HMAC'd, per-run secret),
2. registers the service address with the launcher's DriverService,
3. wires driver pushes into ``State.on_hosts_updated``, and
4. reports readiness after the first successful ``state.sync()``.

The reset protocol (see runner/elastic_run.py): on HostsUpdatedInterrupt /
HorovodInternalError the worker exits with ``RESTART_EXIT_CODE`` after
committing state to the on-disk store, and the launcher respawns the next
generation with a fresh ``MASTER_PORT``. torch could re-form a world in
process, but an NCCL communicator whose peer died can hang in
``destroy_process_group``: the hard exit is the safe path, and it is the
reference's contract.
"""

from __future__ import annotations

import json
import os
import socket
from typing import Optional, Tuple

from horovod_tpu_torch.elastic.notification import (WorkerNotificationService,
                                              resolve_secret, _sign)

# Voluntary-restart exit code: "re-rendezvous me with the new world".
# Its sibling is resilience.preemption.RESUMABLE_EXIT_CODE (75): "I
# committed a final preemption snapshot — respawn me WITHOUT
# blacklisting my host and restore latest". The launcher's reap loop
# and ElasticDriver.record_worker_exit distinguish the two.
RESTART_EXIT_CODE = 73

ENV_RUN = "HVD_ELASTIC_RUN"
ENV_DRIVER_ADDR = "HVD_ELASTIC_DRIVER_ADDR"
ENV_HOSTNAME = "HVD_ELASTIC_HOSTNAME"
ENV_LOCAL_RANK = "HVD_ELASTIC_LOCAL_RANK"
ENV_STATE_DIR = "HVD_ELASTIC_STATE_DIR"


def is_elastic_worker() -> bool:
    return bool(os.environ.get(ENV_RUN))


def slot_identity() -> Tuple[str, int]:
    return (os.environ.get(ENV_HOSTNAME, socket.gethostname()),
            int(os.environ.get(ENV_LOCAL_RANK, "0")))


def state_dir() -> Optional[str]:
    return os.environ.get(ENV_STATE_DIR) or None


def _driver_request(payload: dict, timeout: float = 10.0) -> bool:
    """One signed JSON request to the launcher's DriverService."""
    addr = os.environ.get(ENV_DRIVER_ADDR)
    if not addr:
        return False
    host, port = addr.rsplit(":", 1)
    raw = json.dumps(payload).encode()
    msg = json.dumps({"payload": payload,
                      "sig": _sign(resolve_secret(None), raw)}) + "\n"
    try:
        with socket.create_connection((host, int(port)),
                                      timeout=timeout) as s:
            s.sendall(msg.encode())
            resp = s.makefile().readline()
            return json.loads(resp).get("ok", False)
    except (OSError, ValueError):
        return False


class ElasticWorkerContext:
    """Per-worker elastic plumbing, created by the hvd.elastic.run wrapper."""

    def __init__(self, state):
        self.state = state
        self.hostname, self.local_rank = slot_identity()
        self.service = WorkerNotificationService()
        host, port = self.service.start()
        self.service.register_listener(state.on_hosts_updated)
        _driver_request({"type": "register",
                         "hostname": self.hostname,
                         "local_rank": self.local_rank,
                         "notif_host": host, "notif_port": port})

    def report_ready(self) -> None:
        _driver_request({"type": "ready", "hostname": self.hostname,
                         "local_rank": self.local_rank})

    def close(self) -> None:
        try:
            self.service.stop()
        except Exception:
            # Best-effort teardown, but not silent: a notification
            # service that would not stop usually means its thread is
            # wedged — worth a line in the log of a worker that is
            # about to restart anyway.
            from horovod_tpu_torch.utils.logging import get_logger
            get_logger("horovod_tpu_torch.elastic").warning(
                "worker notification service did not stop cleanly",
                exc_info=True)
