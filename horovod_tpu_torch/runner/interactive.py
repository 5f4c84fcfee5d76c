"""In-process launcher: ``run(fn, np=N)``.

The counterpart of ``horovod_tpu/runner/interactive.py`` (reference:
``horovod.run``, runner/__init__.py:95): launch ``fn`` on N ranks from
inside a Python program or notebook and return the per-rank results,
without a training script or the CLI launcher.

Each rank is a spawned process that joins the world through the
launcher's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT`` of a ``TCPStore`` this process binds, with
``TORCHELASTIC_USE_AGENT_STORE=True``), calls ``init()``, runs ``fn`` and
``shutdown()``. Rank r takes card r, and ``np`` defaults to
``torch.cuda.device_count()``. The ranks run on the CPU (gloo) only when
``env`` sets ``HVD_TPU_FORCE_CPU=1``; without a card and without that,
``init`` raises.

``fn`` must be picklable (defined at module top level), like the
reference's cloudpickled payload.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import time
import traceback
from multiprocessing import connection as mp_connection
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


def _child_main(payload: bytes, rank: int, np_: int, port: int,
                env: Dict[str, str], conn) -> None:
    """Rank worker body (spawned process): the per-slot env of the
    reference's gloo launcher (gloo_run.py:66-103)."""
    try:
        from horovod_tpu_torch.runner.launch import rank_env
        os.environ.update(env)
        os.environ.update(rank_env(rank, np_, rank, np_, "127.0.0.1", port))
        os.environ["TORCHELASTIC_USE_AGENT_STORE"] = "True"
        os.environ["TORCHELASTIC_RESTART_COUNT"] = "0"
        fn, args, kwargs = pickle.loads(payload)
        import horovod_tpu_torch as htt
        htt.init()
        try:
            result = fn(*args, **kwargs)
        finally:
            htt.shutdown()
        conn.send(("ok", result))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def run(
    fn: Callable,
    args: Sequence = (),
    kwargs: Optional[Dict] = None,
    np: Optional[int] = None,
    env: Optional[Dict[str, str]] = None,
    start_timeout: float = 120.0,
) -> List[Any]:
    """Run ``fn(*args, **kwargs)`` on ``np`` ranks (default: one per
    card); returns results in rank order (ref runner/__init__.py:95 run
    signature: func, args, kwargs, np, env, ...). Raises RuntimeError with
    the failing rank's traceback if any rank errors."""
    from horovod_tpu_torch.runner.launch import bind_store
    if np is None:
        import torch
        np = torch.cuda.device_count()
        if np < 1:
            raise RuntimeError(
                "run: no CUDA device to take a rank; pass np and "
                "env={'HVD_TPU_FORCE_CPU': '1'} for a CPU world")
    kwargs = kwargs or {}
    payload = pickle.dumps((fn, tuple(args), dict(kwargs)))
    store = bind_store()
    base_env = dict(env or {})

    ctx = mp.get_context("spawn")
    procs: List[Tuple[mp.Process, Any]] = []
    for rank in range(np):
        parent, child = ctx.Pipe(duplex=False)
        p = ctx.Process(
            target=_child_main,
            args=(payload, rank, np, store.port, base_env, child),
            daemon=True)
        p.start()
        child.close()
        procs.append((p, parent))

    results: List[Any] = [None] * np
    errors: List[str] = []
    pending = {conn: rank for rank, (p, conn) in enumerate(procs)}
    deadline = time.monotonic() + start_timeout
    # Wait on ALL pipes together: one rank's early failure must surface
    # immediately (the others are likely blocked in its collective).
    while pending and not errors:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            for rank in sorted(pending.values()):
                errors.append(
                    f"rank {rank}: no result within {start_timeout}s")
            break
        for conn in mp_connection.wait(list(pending), timeout=remaining):
            rank = pending.pop(conn)
            try:
                status, value = conn.recv()
            except EOFError:
                errors.append(f"rank {rank}: process died without a result")
                continue
            if status == "ok":
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
    if errors:
        # Tear the world down: surviving ranks are blocked in collectives.
        for p, _ in procs:
            if p.is_alive():
                p.terminate()
    for p, _ in procs:
        p.join(timeout=30)
        if p.is_alive():
            p.kill()
    del store
    if errors:
        raise RuntimeError("run failed:\n" + "\n".join(errors))
    return results
