"""The port's integrations (``horovod_tpu_torch/integrations/``) held
against the JAX package's (``horovod_tpu/integrations/``) on the CPU.

- the executor: several calls on one persistent world (gloo here,
  ``device="cpu"``), a worker's traceback, ``HVD_TPU_FORCE_CPU=1``;
- Ray: the local fallback and the actor branch on ``tests/fake_cluster``'s
  ray double;
- Spark: the barrier stage and elastic generations on its pyspark double;
- the store: round trip, fsspec's ``memory://``, the delete guard;
- the estimator: ``history`` and ``val_history`` equal to the JAX
  estimator's (rtol 1e-4) at ``num_workers`` 1 and 2, Adam in float32
  over 2 epochs on 256 x 8 rows, both starting from the JAX model's
  ``init(PRNGKey(0), sample)`` parameters (the port's MLP loads them by
  name); ``fit_on_parquet`` equal to ``fit_on_dataframe``; a custom loss,
  optimizer, step and callbacks; ``transform`` equal to ``predict``; the
  save format's versioning; a vector UDT refused.

The worker functions and models live in the jax-free
``test_torch_integration_workers`` module. One pool of each size is
shared by the module (the executor tests that end a pool make their
own). The module runs under a time limit of its own (``LIMIT_S``).
"""

import os
import signal

import numpy as np
import pytest

import fake_cluster
import test_torch_integration_workers as tw
from horovod_tpu.integrations import TpuEstimator as JEstimator
from horovod_tpu.integrations import TpuExecutor as JExecutor
from horovod_tpu_torch.integrations import TpuEstimator, TpuExecutor
from horovod_tpu_torch.integrations.estimator import TpuModel
from horovod_tpu_torch.integrations.executor import find_free_port
from horovod_tpu_torch.integrations.store import (FsspecStore, LocalStore,
                                                  Store)
from horovod_tpu_torch.models.mlp import MLP
from horovod_tpu_torch.models.resnet import variables_from_numpy

LIMIT_S = 300
FORCE_CPU = {"HVD_TPU_FORCE_CPU": "1"}


@pytest.fixture(scope="module", autouse=True)
def _module_time_limit():
    def expired(signum, frame):
        raise TimeoutError(f"{__name__} ran past its {LIMIT_S} s limit")

    prev = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


@pytest.fixture(scope="module")
def pools():
    """Port pools of 1 and 2 CPU workers and JAX pools of 1 and 2,
    started together."""
    made = {("port", 1): TpuExecutor(1, device="cpu"),
            ("port", 2): TpuExecutor(2, device="cpu"),
            ("jax", 1): JExecutor(1), ("jax", 2): JExecutor(2)}
    try:
        for ex in made.values():
            ex.start()
        yield made
    finally:
        for ex in made.values():
            ex.shutdown()


def _task(n=256, dim=8, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, dim).astype(np.float32)
    y = (x[:, :dim // 2].sum(1) > x[:, dim // 2:].sum(1)).astype(np.int32)
    return x, y


# -- the executor ------------------------------------------------------------

def test_executor_persistent_pool_multiple_calls(pools):
    ex = pools[("port", 2)]
    assert ex.run(tw.world_info) == [(0, 2, "cpu"), (1, 2, "cpu")]
    # a second call on the SAME world: a real cross-process collective
    assert ex.run(tw.gather_rank) == [[0, 1], [0, 1]]
    factor = 7
    assert ex.run(lambda: factor * 6) == [42, 42]      # closures travel
    assert ex.execute_single(lambda: "solo") == "solo"
    assert ex.execute(tw.world_info)[1][:2] == (1, 2)


def test_executor_error_propagates_with_traceback():
    with TpuExecutor(num_workers=1, env=FORCE_CPU) as ex:
        assert ex.run(tw.world_info) == [(0, 1, "cpu")]
        with pytest.raises(RuntimeError, match="boom"):
            ex.run(lambda: (_ for _ in ()).throw(ValueError("boom")))
    assert ex._procs == [] and not ex._started


# -- Ray ---------------------------------------------------------------------

def test_ray_executor_local_fallback():
    from horovod_tpu_torch.integrations.ray_executor import RayExecutor
    ex = RayExecutor(num_workers=2, env=FORCE_CPU).start()
    try:
        assert ex._local is not None
        assert ex.run(tw.world_info) == [(0, 2, "cpu"), (1, 2, "cpu")]
        assert ex.execute_single(lambda: 5) == 5
    finally:
        ex.shutdown()


def test_ray_executor_actor_branch(monkeypatch):
    from horovod_tpu_torch.integrations import ray_executor as rx
    monkeypatch.setattr(rx, "ray", fake_cluster.FakeRay())
    monkeypatch.setattr(rx, "HAS_RAY", True)
    ex = rx.RayExecutor(num_workers=2, env=FORCE_CPU).start()
    try:
        assert ex._local is None            # actor branch, not the pool
        assert ex.run(tw.world_info) == [(0, 2, "cpu"), (1, 2, "cpu")]
        assert ex.execute_single(lambda: 7) == 7
    finally:
        ex.shutdown()


# -- Spark -------------------------------------------------------------------

def test_spark_worker_env_helper():
    from horovod_tpu_torch.integrations.spark import (COORDINATOR_PORT,
                                                      _worker_env)
    env = _worker_env(3, 8, "10.0.0.1", 1, 4, {"X": "1"})
    assert (env["RANK"], env["WORLD_SIZE"], env["LOCAL_RANK"],
            env["LOCAL_WORLD_SIZE"], env["MASTER_ADDR"]) == (
        "3", "8", "1", "4", "10.0.0.1")
    assert env["MASTER_PORT"] == str(COORDINATOR_PORT) and env["X"] == "1"
    assert _worker_env(0, 1, "h", 0, 1, {"MASTER_PORT": "5"})[
        "MASTER_PORT"] == "5"


def test_spark_run_requires_pyspark():
    from horovod_tpu_torch.integrations import spark
    with pytest.raises(ImportError, match="pyspark"):
        spark.run(lambda: None, num_proc=2)


def test_spark_run_executes_barrier_stage(monkeypatch):
    fake_cluster.install_fake_pyspark(monkeypatch)
    from horovod_tpu_torch.integrations import spark
    env = dict(FORCE_CPU, MASTER_PORT=str(find_free_port()))
    results = spark.run(tw.world_info, extra_env=env,
                        spark_context=fake_cluster.FakeSparkContext(2))
    assert results == [(0, 2, "cpu"), (1, 2, "cpu")]


def test_spark_run_elastic_generations(monkeypatch, tmp_path):
    """Generation 0 loses its tasks (not a user error): the job is
    resubmitted as generation 1, which completes; a user error is not
    retried, and min_np is enforced."""
    fake_cluster.install_fake_pyspark(monkeypatch)
    from horovod_tpu_torch.integrations import spark
    sc = fake_cluster.FakeSparkContext(default_parallelism=2)
    env = dict(FORCE_CPU, MASTER_PORT=str(find_free_port()))
    results = spark.run_elastic(tw.elastic_worker, args=(str(tmp_path),),
                                extra_env=env, spark_context=sc, min_np=1)
    assert results == [(1, 0, 2), (1, 1, 2)]
    assert sorted(os.listdir(tmp_path)) == ["g1.r0", "g1.r1"]
    with pytest.raises(RuntimeError, match="min_np"):
        spark.run_elastic(lambda: None, spark_context=sc, min_np=4)


# -- the store ---------------------------------------------------------------

def test_store_checkpoint_roundtrip_and_logs(tmp_path):
    store = Store.create(str(tmp_path / "artifacts"))
    assert isinstance(store, LocalStore)
    obj = {"w": np.arange(4.0)}
    store.save_checkpoint("run1", "epoch0000", obj)
    assert store.exists("run1", "epoch0000")
    np.testing.assert_array_equal(
        store.load_checkpoint("run1", "epoch0000")["w"], obj["w"])
    store.append_log("run1", {"epoch": 0, "loss": 1.5})
    store.append_log("run1", {"epoch": 1, "loss": 1.2})
    assert [r["loss"] for r in store.read_logs("run1")] == [1.5, 1.2]
    assert store.list_checkpoints("run1") == ["epoch0000"]
    store.delete_run("run1")
    assert not store.exists("run1", "epoch0000")


def test_fsspec_store_memory_protocol():
    import pickle
    store = Store.create("memory://port-est-test")
    assert isinstance(store, FsspecStore)
    store.save_checkpoint("run1", "epoch0000", {"w": np.arange(4.0)})
    assert store.exists("run1", "epoch0000")
    store.append_log("run1", {"epoch": 0, "loss": 1.5})
    store.append_log("run1", {"epoch": 1, "loss": 1.2})
    assert [r["loss"] for r in store.read_logs("run1")] == [1.5, 1.2]
    assert store.list_checkpoints("run1") == ["epoch0000"]
    store.save_checkpoint("run1", "epoch0000", {"w": np.arange(5.0)})
    assert len(store.load_checkpoint("run1", "epoch0000")["w"]) == 5
    store2 = pickle.loads(pickle.dumps(store))
    assert store2.prefix_url == store.prefix_url
    store.delete_run("run1")
    assert not store.exists("run1", "epoch0000")


def test_store_delete_run_artifacts_guard():
    class HostingStore(Store):
        def train_data_path(self, run_id):
            return "/nonexistent/train"

    with pytest.raises(NotImplementedError, match="delete_run_artifacts"):
        HostingStore().delete_run_artifacts("r")


# -- the estimator -----------------------------------------------------------

def _jax_init(x):
    """The JAX estimator's initial parameters (its _fit_worker l.106)."""
    import jax
    import jax.numpy as jnp
    from horovod_tpu.models.mlp import MLP as JMLP
    params = JMLP(features=(16,), num_classes=2).init(
        jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    return jax.tree.map(np.asarray, params)


def _port_mlp(x):
    model = MLP(features=(16,), num_classes=2, in_features=x.shape[1],
                device="cpu")
    variables_from_numpy(model, _jax_init(x))
    return model


@pytest.mark.parametrize("workers", [1, 2])
def test_estimator_history_equals_jax(pools, tmp_path, workers):
    from horovod_tpu.integrations.store import Store as JStore
    from horovod_tpu.models.mlp import MLP as JMLP
    x, y = _task()
    kw = dict(loss="classification", batch_size=32, epochs=2, lr=5e-3,
              num_workers=workers, validation=0.25)
    ref = JEstimator(JMLP(features=(16,), num_classes=2),
                     executor=pools[("jax", workers)],
                     store=JStore.create(str(tmp_path / "jax")), **kw
                     ).fit(x, y)
    store = Store.create(str(tmp_path / "port"))
    got = TpuEstimator(_port_mlp(x), executor=pools[("port", workers)],
                       store=store, run_id="exp", **kw).fit(x, y)
    assert len(got.history) == len(got.val_history) == 2
    np.testing.assert_allclose(got.history, ref.history, rtol=1e-4)
    np.testing.assert_allclose(got.val_history, ref.val_history, rtol=1e-4)
    assert got.best_epoch == ref.best_epoch
    np.testing.assert_allclose(got.predict(x[:16], device="cpu"),
                               ref.predict(x[:16]), rtol=1e-3, atol=1e-4)
    # per-epoch + best checkpoints, the logs and the fitted model
    names = store.list_checkpoints("exp")
    assert {"epoch0000", "epoch0001", "best", "model"} <= set(names)
    assert [r["epoch"] for r in store.read_logs("exp")] == [0, 1]
    loaded = TpuModel.load(store, "exp")
    np.testing.assert_array_equal(loaded.predict(x[:8], device="cpu"),
                                  got.predict(x[:8], device="cpu"))


def test_estimator_fit_on_parquet_equals_fit_on_dataframe(pools, tmp_path):
    import pandas as pd
    from horovod_tpu_torch.data.parquet_loader import write_parquet_dataset
    x, y = _task(512)
    y = y.astype(np.int64)
    df = pd.DataFrame({"features": list(x), "label": y})

    def make_est(run_id, store_dir):
        return TpuEstimator(_port_mlp(x), loss="classification",
                            batch_size=32, epochs=2, lr=5e-3,
                            num_workers=2, executor=pools[("port", 2)],
                            store=Store.create(str(tmp_path / store_dir)),
                            run_id=run_id)

    model = make_est("df-run", "a").fit_on_dataframe(df, rows_per_file=128)
    assert model.history[-1] < model.history[0]
    write_parquet_dataset(str(tmp_path / "manual"),
                          {"features": x, "label": y}, rows_per_file=128)
    model2 = make_est("pq-run", "b").fit_on_parquet(str(tmp_path / "manual"))
    np.testing.assert_array_equal(model.history, model2.history)
    np.testing.assert_array_equal(model.predict(x[:8], device="cpu"),
                                  model2.predict(x[:8], device="cpu"))
    assert os.path.isdir(tmp_path / "a" / "df-run" / "train_data" / "train")
    # validation streams from its own dataset; a fraction is refused
    write_parquet_dataset(str(tmp_path / "val"),
                          {"features": x[:64], "label": y[:64]},
                          rows_per_file=64)
    est = make_est("v", "c")
    fitted = est.fit_on_parquet(str(tmp_path / "manual"),
                                val_path=str(tmp_path / "val"))
    assert len(fitted.val_history) == 2
    est.validation = 0.2
    with pytest.raises(ValueError, match="val_path"):
        est.fit_on_parquet(str(tmp_path / "manual"))
    with pytest.raises(FileNotFoundError):
        est.fit_on_parquet(str(tmp_path / "nope"))


def test_estimator_custom_loss_optimizer_step_callbacks_and_transform(
        pools, tmp_path):
    import glob

    import pyarrow.parquet as pq

    from horovod_tpu_torch.callbacks import LearningRateScheduleCallback
    from horovod_tpu_torch.data.parquet_loader import write_parquet_dataset
    rng = np.random.RandomState(0)
    x = rng.randn(192, 6).astype(np.float32)
    y = (x @ rng.randn(6).astype(np.float32)).astype(np.float32)
    ex = pools[("port", 2)]
    model = TpuEstimator(tw.TwoLayer(), loss=tw.huber_loss,
                         optimizer=tw.clipped_sgd, batch_size=32, epochs=3,
                         num_workers=2, executor=ex).fit(x, y)
    assert model.history[-1] < model.history[0]
    stepped = TpuEstimator(
        tw.TwoLayer(), loss=tw.huber_loss, optimizer=tw.clipped_sgd,
        train_step=tw.decayed_step, batch_size=32, epochs=3, num_workers=2,
        executor=ex, callbacks=[LearningRateScheduleCallback(
            5e-2, lambda epoch: 0.5 ** epoch)]).fit(x, y)
    assert stepped.history[-1] < stepped.history[0]
    assert stepped.history != model.history
    # distributed transform over a Parquet dir == local predict, row by row
    write_parquet_dataset(str(tmp_path / "in"),
                          {"idx": np.arange(len(x)), "features": x},
                          rows_per_file=48)
    model.transform(str(tmp_path / "in"), str(tmp_path / "out"),
                    executor=ex)
    got = {}
    for f in sorted(glob.glob(str(tmp_path / "out" / "part-*.parquet"))):
        d = pq.read_table(f).to_pydict()
        got.update({int(i): float(p)
                    for i, p in zip(d["idx"], d["prediction"])})
    assert len(got) == len(x)
    local = model.predict(x, device="cpu")
    np.testing.assert_allclose([got[i] for i in range(len(x))], local,
                               rtol=1e-5, atol=1e-6)


def test_model_save_format_versioning(tmp_path):
    store = Store.create(str(tmp_path / "s"))
    mlp = MLP(features=(4,), num_classes=2, in_features=3, device="cpu")
    m = TpuModel(mlp, mlp.state_dict(), [1.0])
    m.save(store, "r1")
    saved = store.load_checkpoint("r1", "model")
    assert saved["format_version"] == TpuModel.SAVE_FORMAT_VERSION
    assert "library_version" in saved
    assert TpuModel.load(store, "r1").history == [1.0]
    saved["format_version"] = 99                         # future format
    store.save_checkpoint("r1", "model", saved)
    with pytest.raises(ValueError, match="newer"):
        TpuModel.load(store, "r1")
    store.save_checkpoint("r1", "raw", {"w": np.ones(2)})
    with pytest.raises(ValueError, match="raw params"):
        TpuModel.load(store, "r1", "raw")


def test_estimator_refuses_bad_arguments_and_vector_udt():
    mlp = MLP(features=(4,), num_classes=2, in_features=3, device="cpu")
    with pytest.raises(ValueError, match="validation"):
        TpuEstimator(mlp, validation=1.5)
    with pytest.raises(ValueError, match="loss kind"):
        TpuEstimator(mlp, loss="hinge")

    class FakeField:
        dataType = "VectorUDT"

    class FakeSchema:
        def __getitem__(self, name):
            return FakeField()

    class FakeVectorDF:
        schema = FakeSchema()

        class write:                                  # noqa: N801
            @staticmethod
            def mode(m):
                raise AssertionError("must reject before writing")

    with pytest.raises(ValueError, match="vector_to_array"):
        TpuEstimator(mlp, num_workers=2).fit_on_dataframe(FakeVectorDF())
