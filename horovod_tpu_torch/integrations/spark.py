"""horovod.spark analogue: run a training fn on Spark executors. The
counterpart of ``horovod_tpu/integrations/spark.py``.

Reference: ``horovod.spark.run`` (reference: spark/runner.py:200), a Spark
job with one barrier task per executor; tasks register with the driver,
which computes rank assignments and the rendezvous, then each task runs
the user fn under the formed world; ``run_elastic`` (:312).

A pyspark **barrier stage** (one task per worker) is the natural fit:
barrier tasks start simultaneously and expose
``BarrierTaskContext.getTaskInfos`` (every task's address), so rank 0's
host is ``MASTER_ADDR`` of the torch world, the task partition id is the
rank and a task's position among the tasks of its host its
``LOCAL_RANK`` (its card); no separate driver service is needed. Without
pyspark installed the entry raises with guidance (the reference likewise
requires a Spark env); the env/rank helpers are importable and
unit-testable standalone.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Sequence

try:
    import cloudpickle as _pickle
except ImportError:
    import pickle as _pickle

# The world's store port on rank 0's host, unless ``extra_env`` names
# another ``MASTER_PORT``.
COORDINATOR_PORT = 9873

# Worker-side marker distinguishing exceptions raised by the user fn from
# infrastructure failures (executor loss, barrier timeout). Spark surfaces
# the task's Python traceback text inside the driver-side exception, so the
# marker survives the Py4J round trip.
USER_ERROR_MARKER = "HVD_TPU_USER_ERROR"


def _worker_env(rank: int, num_proc: int, master_addr: str,
                local_rank: int, local_size: int,
                extra_env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Per-task env wiring (ref spark/gloo_run.py slot env building): the
    torch world's variables, ``MASTER_PORT`` from ``extra_env`` or
    :data:`COORDINATOR_PORT`."""
    from horovod_tpu_torch.runner.launch import rank_env
    env = dict(extra_env or {})
    port = int(env.get("MASTER_PORT", COORDINATOR_PORT))
    env.update(rank_env(rank, num_proc, local_rank, local_size,
                        master_addr, port))
    return env


def _barrier_mapper(payload: bytes, num_proc: int,
                    extra_env: Optional[Dict[str, str]]):
    """Body of one barrier task (ref spark/task/__init__.py task body)."""
    def mapper(iterator):
        from pyspark import BarrierTaskContext
        ctx = BarrierTaskContext.get()
        rank = ctx.partitionId()
        hosts = [info.address.split(":")[0] for info in ctx.getTaskInfos()]
        local_rank = hosts[:rank].count(hosts[rank])
        os.environ.update(_worker_env(rank, num_proc, hosts[0], local_rank,
                                      hosts.count(hosts[rank]), extra_env))
        import horovod_tpu_torch as htt
        from horovod_tpu_torch.elastic import HorovodInternalError
        htt.init()
        fn, args, kwargs = _pickle.loads(payload)
        try:
            result = fn(*args, **kwargs)
        except HorovodInternalError:
            raise                 # communication failure: retryable
        except Exception as e:
            # Tag deterministic user-code failures so run_elastic can
            # surface them immediately instead of burning generations
            # re-running them (the reference's elastic loop likewise only
            # retries HorovodInternalError, torch/elastic/__init__.py).
            # Infrastructure failures (executor loss, barrier timeout)
            # never carry this marker.
            raise RuntimeError(
                f"{USER_ERROR_MARKER}[{type(e).__name__}] {e}") from e
        finally:
            htt.shutdown()
        ctx.barrier()
        yield rank, result
    return mapper


def run(fn: Callable, args: Sequence = (), kwargs: Optional[Dict] = None,
        num_proc: Optional[int] = None,
        extra_env: Optional[Dict[str, str]] = None,
        spark_context=None) -> List[Any]:
    """Run ``fn`` on Spark executors; returns rank-ordered results
    (ref spark/runner.py:200 run signature: fn, args, kwargs, num_proc,
    extra_env...)."""
    try:
        import pyspark  # noqa: F401
        from pyspark.sql import SparkSession
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.integrations.spark.run requires pyspark. "
            "In a non-Spark environment use horovod_tpu_torch.run "
            "(in-process), TpuExecutor (persistent pool), or "
            "RayExecutor.") from e
    if spark_context is None:
        spark_context = SparkSession.builder.getOrCreate().sparkContext
    if num_proc is None:
        num_proc = spark_context.defaultParallelism
    payload = _pickle.dumps((fn, tuple(args), dict(kwargs or {})))
    rdd = spark_context.parallelize(range(num_proc), num_proc).barrier()
    out = rdd.mapPartitions(
        _barrier_mapper(payload, num_proc, extra_env)).collect()
    return [r for _, r in sorted(out)]


def run_elastic(fn: Callable, args: Sequence = (),
                kwargs: Optional[Dict] = None,
                num_proc: Optional[int] = None,
                min_np: int = 1, max_np: Optional[int] = None,
                extra_env: Optional[Dict[str, str]] = None,
                spark_context=None,
                max_generations: int = 10) -> List[Any]:
    """Elastic Spark run (ref spark/runner.py:312 run_elastic signature:
    fn/args/kwargs/num_proc/min_np/max_np).

    Spark barrier stages pin the task count for the stage's lifetime, so
    elasticity happens BETWEEN generations, exactly like the generation
    protocol of runner/elastic_run.py: each generation submits one barrier
    job sized to the cluster's current parallelism (clamped to
    [min_np, max_np]); when a worker fails mid-stage the whole barrier job
    fails, and the job is resubmitted against whatever parallelism the
    cluster now offers. The user fn resumes from its committed elastic
    state (``elastic.TorchState``), the same contract as
    ``htt.elastic.run``. Workers see their generation in
    ``HVD_TPU_ELASTIC_GENERATION``.
    """
    try:
        from pyspark.sql import SparkSession
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.integrations.spark.run_elastic requires "
            "pyspark. In a non-Spark environment use hvdrun-torch "
            "--host-discovery-script (runner/elastic_run.py).") from e
    if spark_context is None:
        spark_context = SparkSession.builder.getOrCreate().sparkContext
    last_exc: Optional[BaseException] = None
    for generation in range(max_generations):
        # num_proc is the INITIAL request only; after a failure each
        # resubmission sizes to whatever the cluster now offers (clamped
        # to [min_np, max_np]): pinning num_proc forever would retry the
        # impossible world size on a shrunken cluster.
        available = spark_context.defaultParallelism
        if generation == 0 and num_proc:
            available = num_proc
        np_now = min(available, max_np) if max_np else available
        if np_now < min_np:
            raise RuntimeError(
                f"elastic spark run: only {np_now} slots available, "
                f"min_np={min_np}" + (f" (last failure: {last_exc})"
                                      if last_exc else ""))
        env = dict(extra_env or {})
        env["HVD_TPU_ELASTIC_GENERATION"] = str(generation)
        try:
            return run(fn, args=args, kwargs=kwargs, num_proc=np_now,
                       extra_env=env, spark_context=spark_context)
        except Exception as e:
            if USER_ERROR_MARKER in str(e):
                # Deterministic user-code failure: re-running it for
                # max_generations would just mask the real error behind
                # generation churn. Surface it now.
                raise RuntimeError(
                    "elastic spark run: user fn raised (not an "
                    f"infrastructure failure), not retrying: {e}") from e
            last_exc = e           # barrier stage failed: next generation
    raise RuntimeError(
        f"elastic spark run failed after {max_generations} generations"
        f": {last_exc}")
