"""Persistent distributed worker pool, the actor substrate for the Ray
and Spark integrations: the counterpart of
``horovod_tpu/integrations/executor.py``.

Reference analogue: ``RayExecutor`` (reference: ray/runner.py:168) keeps N
long-lived actor workers, each ``hvd.init()``-ed into one world, and
ships pickled functions to them repeatedly (``run``/``run_remote``/
``execute``). Here each worker is a spawned process that joins the world
through the launcher's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT`` of a ``TCPStore`` this
process binds, as ``run(fn, np=N)`` does) and calls ``init()``: one card
per worker by local rank, over NCCL. The workers stay alive between
calls, which keeps the world, its NCCL communicators and the built
kernels.

Unlike the JAX pool, which forces its workers onto the CPU, this pool
runs on the cards unless the caller asks for the CPU (``device="cpu"``,
or ``HVD_TPU_FORCE_CPU=1`` in the environment or in ``env``: then the
world is gloo). It must be ``spawn``: a forked child of a process that
holds a CUDA context cannot use CUDA.

Functions are shipped with cloudpickle where it is installed (closures
and lambdas work, like Ray's own serializer) and with pickle otherwise
(functions defined at module top level).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import socket
import time
import traceback
from multiprocessing import connection as mp_connection
from typing import Any, Callable, Dict, List, Optional, Sequence

try:
    import cloudpickle as _pickle
except ImportError:
    import pickle as _pickle


def find_free_port() -> int:
    """A TCP port free on this host at the time of the call."""
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _send(conn, status: str, value: Any) -> None:
    # Pickled here, not by the connection: multiprocessing's pickler
    # would hand tensors over through shared memory tied to this process.
    conn.send_bytes(_pickle.dumps((status, value)))


def _recv(conn):
    return _pickle.loads(conn.recv_bytes())


def _pool_worker(rank: int, np_: int, port: int, device: str,
                 env: Dict[str, str], conn) -> None:
    """Long-lived worker: join the world once, then serve function calls
    (the actor loop; ref ray worker BaseHorovodWorker.execute)."""
    try:
        from horovod_tpu_torch.runner.launch import rank_env
        os.environ.update(env)
        os.environ.update(rank_env(rank, np_, rank, np_, "127.0.0.1", port))
        os.environ["TORCHELASTIC_USE_AGENT_STORE"] = "True"
        os.environ["TORCHELASTIC_RESTART_COUNT"] = "0"
        import horovod_tpu_torch as htt
        htt.init(device=device)
        _send(conn, "up", rank)
        while True:
            msg = conn.recv()
            if msg is None:                      # shutdown sentinel
                break
            try:
                fn, args, kwargs = _pickle.loads(msg)
                result = fn(*args, **kwargs)
                _send(conn, "ok", result)
            except BaseException:
                _send(conn, "error", traceback.format_exc())
        htt.shutdown()
        _send(conn, "down", rank)
    except BaseException:
        try:
            _send(conn, "error", traceback.format_exc())
        except Exception:
            pass
    finally:
        conn.close()


class TpuExecutor:
    """Persistent N-worker executor (ref RayExecutor surface:
    start/run/run_remote/execute/shutdown, ray/runner.py:283-420).

    ``device`` is what each worker's ``init`` is given (``"cuda"``: card
    ``LOCAL_RANK``; ``"cpu"``: a gloo world). Workers are spawned
    processes, so a user script calling ``start()`` /
    ``TpuEstimator.fit`` at import time must use the standard
    ``if __name__ == "__main__":`` guard (the spawn bootstrap re-imports
    the main module)."""

    def __init__(self, num_workers: int,
                 env: Optional[Dict[str, str]] = None,
                 start_timeout: float = 120.0, device: str = "cuda"):
        self.num_workers = num_workers
        self.env = dict(env or {})
        self.start_timeout = start_timeout
        self.device = device
        self._procs: List[Any] = []
        self._conns: List[Any] = []
        self._store = None
        self._started = False

    # -- lifecycle (ref RayExecutor.start) -----------------------------------
    def start(self) -> "TpuExecutor":
        if self._started:
            return self
        from horovod_tpu_torch.runner.launch import bind_store
        self._store = bind_store()
        ctx = mp.get_context("spawn")
        for rank in range(self.num_workers):
            parent, child = ctx.Pipe(duplex=True)
            p = ctx.Process(target=_pool_worker,
                            args=(rank, self.num_workers, self._store.port,
                                  self.device, self.env, child),
                            daemon=True)
            p.start()
            child.close()
            self._procs.append(p)
            self._conns.append(parent)
        deadline = time.monotonic() + self.start_timeout
        for rank, conn in enumerate(self._conns):
            if not conn.poll(max(deadline - time.monotonic(), 0.1)):
                self.shutdown(force=True)
                raise TimeoutError(f"worker {rank} did not start")
            status, value = _recv(conn)
            if status != "up":
                self.shutdown(force=True)
                raise RuntimeError(f"worker {rank} failed to start:\n{value}")
        self._started = True
        return self

    # -- calls (ref RayExecutor.run / run_remote / execute) ------------------
    def run(self, fn: Callable, args: Sequence = (),
            kwargs: Optional[Dict] = None) -> List[Any]:
        """Ship fn to every worker; blocks; returns rank-ordered results."""
        self.run_remote(fn, args, kwargs)
        return self.fetch()

    def run_remote(self, fn: Callable, args: Sequence = (),
                   kwargs: Optional[Dict] = None) -> None:
        """Non-blocking dispatch to all workers (results via fetch())."""
        if not self._started:
            raise RuntimeError("executor not started; call start()")
        payload = _pickle.dumps((fn, tuple(args), dict(kwargs or {})))
        for conn in self._conns:
            conn.send(payload)

    def fetch(self, timeout: float = 600.0) -> List[Any]:
        results: List[Any] = [None] * self.num_workers
        errors: List[str] = []
        pending = {c: r for r, c in enumerate(self._conns)}
        deadline = time.monotonic() + timeout
        while pending:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                errors.append(f"timeout; ranks {sorted(pending.values())} "
                              f"pending")
                break
            for conn in mp_connection.wait(list(pending), timeout=remaining):
                rank = pending.pop(conn)
                try:
                    status, value = _recv(conn)
                except EOFError:
                    errors.append(f"rank {rank}: worker died")
                    continue
                if status == "ok":
                    results[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
        if errors:
            self.shutdown(force=True)
            raise RuntimeError("executor run failed:\n" + "\n".join(errors))
        return results

    def execute(self, fn: Callable) -> List[Any]:
        """Alias of run() for the reference's execute(lambda _: ...)."""
        return self.run(fn)

    def execute_single(self, fn: Callable, rank: int = 0) -> Any:
        """Run fn only on one worker (ref RayExecutor.execute_single)."""
        payload = _pickle.dumps((fn, (), {}))
        self._conns[rank].send(payload)
        status, value = _recv(self._conns[rank])
        if status != "ok":
            raise RuntimeError(f"rank {rank}:\n{value}")
        return value

    def shutdown(self, force: bool = False) -> None:
        for conn in self._conns:
            try:
                conn.send(None)
            except Exception:
                pass
        for p in self._procs:
            p.join(timeout=1 if force else 30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        for conn in self._conns:
            conn.close()
        self._procs, self._conns = [], []
        self._store = None
        self._started = False

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()
