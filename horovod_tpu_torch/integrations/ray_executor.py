"""RayExecutor: API parity with the reference's Ray integration. The
counterpart of ``horovod_tpu/integrations/ray_executor.py``.

Reference: ``RayExecutor`` (reference: ray/runner.py:168): placement-group
actor workers, a Coordinator computing each worker's rank env (:45), and
start/run/run_remote/execute/execute_single/shutdown.

Here: when ``ray`` is importable and initialized, each worker is a Ray
actor that joins the torch world through the launcher's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` on worker 0's
host, ``MASTER_PORT``) and calls ``init()``; without Ray the same API
runs on the local persistent pool (integrations/executor.py), so code
written against RayExecutor works in both environments. With
``use_gpu`` Ray gives each actor one card (``CUDA_VISIBLE_DEVICES``);
the workers run on the cards unless ``env`` sets ``HVD_TPU_FORCE_CPU=1``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

try:
    import ray
    HAS_RAY = True
except ImportError:
    ray = None
    HAS_RAY = False

from horovod_tpu_torch.integrations.executor import (TpuExecutor,
                                                     find_free_port)


class RayExecutor:
    """ref ray/runner.py:168 RayExecutor surface."""

    def __init__(self, num_workers: int,
                 cpus_per_worker: int = 1,
                 use_gpu: bool = False,
                 env: Optional[Dict[str, str]] = None,
                 placement_group_timeout_s: float = 100.0):
        self.num_workers = num_workers
        self.cpus_per_worker = cpus_per_worker
        self.use_gpu = use_gpu
        self.env = dict(env or {})
        self.pg_timeout = placement_group_timeout_s
        self._actors: List[Any] = []
        self._local: Optional[TpuExecutor] = None

    # -- start ---------------------------------------------------------------
    def start(self) -> "RayExecutor":
        if HAS_RAY and ray.is_initialized():
            self._start_ray()
        else:
            # Local fallback: identical semantics on the in-host pool.
            self._local = TpuExecutor(self.num_workers, env=self.env)
            self._local.start()
        return self

    def _start_ray(self) -> None:
        @ray.remote(num_cpus=self.cpus_per_worker,
                    num_gpus=1 if self.use_gpu else 0)
        class _Worker:
            def __init__(self, rank, np_, env):
                self.rank, self.np_, self.env = rank, np_, env

            def setup(self, master_addr, master_port, local_rank,
                      local_size):
                import os

                from horovod_tpu_torch.runner.launch import rank_env
                os.environ.update(self.env)
                os.environ.update(rank_env(self.rank, self.np_, local_rank,
                                           local_size, master_addr,
                                           master_port))
                import horovod_tpu_torch as htt
                htt.init()
                return self.rank

            def execute(self, fn, args, kwargs):
                return fn(*args, **kwargs)

            def ip(self):
                import socket
                return socket.gethostbyname(socket.gethostname())

        self._actors = [
            _Worker.remote(rank, self.num_workers, self.env)
            for rank in range(self.num_workers)
        ]
        # The store on worker 0's host (the reference's Coordinator
        # computes the rendezvous host the same way, ray/runner.py:45);
        # a worker's local rank is its position among its host's workers.
        hosts = ray.get([a.ip.remote() for a in self._actors])
        port = find_free_port()
        ray.get([a.setup.remote(hosts[0], port, hosts[:r].count(hosts[r]),
                                hosts.count(hosts[r]))
                 for r, a in enumerate(self._actors)])

    # -- calls ---------------------------------------------------------------
    def run(self, fn: Callable, args: Sequence = (),
            kwargs: Optional[Dict] = None) -> List[Any]:
        if self._local is not None:
            return self._local.run(fn, args, kwargs)
        return ray.get([a.execute.remote(fn, tuple(args), dict(kwargs or {}))
                        for a in self._actors])

    def run_remote(self, fn: Callable, args: Sequence = (),
                   kwargs: Optional[Dict] = None):
        if self._local is not None:
            self._local.run_remote(fn, args, kwargs)
            return self._local
        return [a.execute.remote(fn, tuple(args), dict(kwargs or {}))
                for a in self._actors]

    def execute(self, fn: Callable) -> List[Any]:
        return self.run(fn)

    def execute_single(self, fn: Callable) -> Any:
        if self._local is not None:
            return self._local.execute_single(fn)
        return ray.get(self._actors[0].execute.remote(fn, (), {}))

    def shutdown(self) -> None:
        if self._local is not None:
            self._local.shutdown()
            self._local = None
        for a in self._actors:
            ray.kill(a)
        self._actors = []
