"""The port's data compute service
(``horovod_tpu_torch/data/compute_service.py``) held against the JAX
package's (``horovod_tpu/data/compute_service.py``) on the CPU.

- the cases of ``tests/test_compute_service.py``, against the port;
- the wire across packages: a JAX ``DataWorker`` feeds the port's
  ``ResilientDataIterator`` and ``DataServiceIterator``, and a port worker
  the JAX consumers, batch for batch bitwise; a consumer with the wrong
  key is refused by a worker of either package;
- the kill drill of ``tests/test_chaos_e2e.py`` (3 random-access workers,
  ``data_worker_kill`` on worker 1 after 2 requests) on both packages:
  equal trajectories, bitwise, and equal to the drill without the kill;
- ``train_loop`` fed by the service, through the registry with heartbeats
  (``HOROVOD_FAULT_HEARTBEAT_SECONDS`` and
  ``HOROVOD_FAULT_WORKER_DEADLINE`` set), against the same steps on
  in-memory batches, bitwise.

The module runs under a time limit of its own (``LIMIT_S``).
"""

import json
import signal
import socket
import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu import metrics as JM
from horovod_tpu.data import compute_service as jcs
from horovod_tpu.elastic.sampler import ElasticSampler as JSampler
from horovod_tpu.resilience import chaos as jchaos
import horovod_tpu_torch as htt
from horovod_tpu_torch import metrics as M
from horovod_tpu_torch.data import compute_service as cs
from horovod_tpu_torch.data.compute_service import (
    ComputeConfig, ComputeService, DataServiceIterator, DataWorker,
    ResilientDataIterator, compute_worker_fn, distribute)
from horovod_tpu_torch.elastic.sampler import ElasticSampler
from horovod_tpu_torch.resilience import chaos
from horovod_tpu_torch.resilience import faults

LIMIT_S = 240
KEY = b"\x01" * 32


@pytest.fixture(scope="module", autouse=True)
def _module_time_limit():
    def expired(signum, frame):
        raise TimeoutError(f"{__name__} ran past its {LIMIT_S} s limit")

    prev = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


@pytest.fixture(autouse=True)
def _no_chaos():
    yield
    for mod in (chaos, jchaos):
        mod.install(None)


def make_config(address, dispatchers=1, workers_per_dispatcher=2,
                dispatcher_side="compute", timeout=10.0):
    return ComputeConfig(dispatchers=dispatchers,
                         workers_per_dispatcher=workers_per_dispatcher,
                         dispatcher_side=dispatcher_side,
                         address=address, key=KEY, timeout=timeout)


def range_dataset(worker_index, num_workers, n=20):
    """Source-sharded dataset: worker i serves elements i, i+W, i+2W, ..."""
    for i in range(worker_index, n, num_workers):
        yield np.full((2,), i, dtype=np.int32)


@pytest.fixture
def service():
    svc = ComputeService(dispatchers=1, workers_per_dispatcher=2, key=KEY)
    addr = svc.start()
    yield svc, addr
    svc.stop()


# -- the cases of tests/test_compute_service.py -----------------------------

def test_config_roundtrip_and_atomic_write(tmp_path):
    cfg = make_config(("127.0.0.1", 1234))
    path = str(tmp_path / "svc.json")
    cfg.write(path)
    assert ComputeConfig.read(path) == cfg
    # the file is the JAX package's: each package reads the other's
    assert jcs.ComputeConfig.read(path).to_dict() == cfg.to_dict()


def test_config_read_wait_times_out(tmp_path):
    with pytest.raises(TimeoutError):
        ComputeConfig.read(str(tmp_path / "never.json"),
                           wait_for_file_creation=True, timeout=0.3)


def test_registry_dispatcher_and_worker_registration(service):
    svc, addr = service
    client = make_config(addr).compute_client()
    client.register_dispatcher(0, "10.0.0.1", 5000)
    assert client.wait_for_dispatcher_registration(0) == ("10.0.0.1", 5000)
    client.register_worker_for_dispatcher(0, "10.0.0.2", 6000)
    client.register_worker_for_dispatcher(0, "10.0.0.3", 6001)
    workers = client.wait_for_dispatcher_worker_registration(0)
    assert ("10.0.0.2", 6000) in workers and ("10.0.0.3", 6001) in workers


def test_registry_rejects_bad_key(service):
    svc, addr = service
    client = make_config(addr).compute_client()
    client._key = b"wrong" * 6 + b"xy"
    with pytest.raises(Exception):
        client.register_dispatcher(0, "h", 1)


def test_registry_rejects_out_of_range_dispatcher(service):
    svc, addr = service
    client = make_config(addr).compute_client()
    with pytest.raises(RuntimeError, match="out of range"):
        client.register_dispatcher(7, "h", 1)


def test_worker_streams_shard_exactly_once():
    worker = DataWorker(range_dataset, worker_index=0, num_workers=1)
    addr = worker.start()
    try:
        it = DataServiceIterator([addr], job="e0")
        assert sorted(int(b[0]) for b in it) == list(range(20))
    finally:
        worker.stop()


def test_two_workers_two_consumers_distributed_epoch(service):
    svc, addr = service
    cfg = make_config(addr)
    worker_threads = [
        threading.Thread(target=compute_worker_fn,
                         args=(cfg, range_dataset),
                         kwargs={"index": i, "size": 2}, daemon=True)
        for i in range(2)]
    for t in worker_threads:
        t.start()
    results = {}

    def consume(rank, job):
        it = distribute(cfg, rank=rank, job=job)
        results[(rank, job)] = [int(b[0]) for b in it]

    consumers = [threading.Thread(target=consume, args=(r, "epoch0"))
                 for r in range(2)]
    for t in consumers:
        t.start()
    for t in consumers:
        t.join(timeout=30)
        assert not t.is_alive(), "consumer hung"
    assert sorted(results[(0, "epoch0")] + results[(1, "epoch0")]) == \
        list(range(20))
    consume(0, "epoch1")
    assert sorted(results[(0, "epoch1")]) == list(range(20))
    cfg.compute_client().shutdown()
    for t in worker_threads:
        t.join(timeout=10)
        assert not t.is_alive(), "compute worker did not shut down"


def test_training_side_dispatcher_registration(service):
    svc, addr = service
    cfg = make_config(addr, dispatcher_side="training")
    worker = DataWorker(range_dataset, worker_index=0, num_workers=1,
                        key=KEY)
    waddr = worker.start()
    client = cfg.compute_client()

    def register_workers():
        client.register_worker_for_dispatcher(0, *waddr)
        client.register_worker_for_dispatcher(0, *waddr)

    timer = threading.Timer(0.2, register_workers)
    timer.start()
    try:
        it = distribute(cfg, rank=0, job="j")
        assert sorted({int(b[0]) for b in it}) == list(range(20))
    finally:
        timer.join(timeout=5)
        worker.stop()


def test_compute_worker_main_resolves_dataset_fn():
    from horovod_tpu_torch.data.compute_worker import resolve_dataset_fn
    fn = resolve_dataset_fn("test_torch_compute_service:range_dataset")
    assert list(fn(0, 1))[0][0] == 0
    with pytest.raises(SystemExit):
        resolve_dataset_fn("no_colon_here")


def test_iterator_close_unblocks_pullers():
    worker = DataWorker(lambda i, n: range_dataset(i, n, n=200),
                        worker_index=0, num_workers=1, key=KEY)
    addr = worker.start()
    try:
        it = DataServiceIterator([addr], job="early", prefetch=1, key=KEY)
        assert len([next(it) for _ in range(3)]) == 3
        it.close()
        for t in it._threads:
            assert not t.is_alive(), "puller thread leaked after close()"
    finally:
        worker.stop()


def test_slow_consumer_still_sees_end_of_stream():
    worker = DataWorker(lambda i, n: range_dataset(i, n, n=6),
                        worker_index=0, num_workers=1, key=KEY)
    addr = worker.start()
    try:
        it = DataServiceIterator([addr], job="slow", prefetch=1, key=KEY)
        got = []

        def consume():
            for b in it:
                got.append(int(b[0]))
                time.sleep(0.05)

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive(), "consumer hung waiting for end-of-stream"
        assert sorted(got) == list(range(6))
    finally:
        worker.stop()


@pytest.mark.parametrize("worker_mod", [cs, jcs], ids=["port", "jax"])
def test_worker_drops_unauthenticated_data_requests(worker_mod):
    worker = worker_mod.DataWorker(range_dataset, worker_index=0,
                                   num_workers=1, key=KEY)
    addr = worker.start()
    try:
        with socket.create_connection(addr, timeout=5) as s:
            cs._send_raw(s, json.dumps(
                {"payload": {"op": "get", "job": "x"},
                 "sig": "not-a-real-signature"}).encode())
            s.settimeout(1.0)
            with pytest.raises((ConnectionError, TimeoutError, OSError)):
                cs._recv_raw(s)
    finally:
        worker.stop()


def test_config_validates_topology():
    with pytest.raises(ValueError, match="dispatchers"):
        make_config(("h", 1), dispatchers=0)
    with pytest.raises(ValueError, match="dispatcher_side"):
        make_config(("h", 1), dispatcher_side="sideways")


def test_worker_fn_rejects_out_of_range_index(service):
    svc, addr = service
    cfg = make_config(addr, dispatchers=1, workers_per_dispatcher=2)
    with pytest.raises(ValueError, match="out of range"):
        compute_worker_fn(cfg, range_dataset, index=5, size=6)


# -- the wire across packages ------------------------------------------------

def _samples(i, n, count=48):
    rng = np.random.RandomState(99)
    return [rng.randn(3, 2).astype(np.float32) for _ in range(count)]


def _resilient(workers, sampler, key=KEY, batch=8):
    with ResilientDataIterator(workers, sampler, batch_size=batch,
                               key=key) as it:
        return [np.stack(b) for b in it]


@pytest.mark.parametrize("worker_mod", [cs, jcs], ids=["port", "jax"])
def test_either_packages_worker_feeds_the_port_consumers(worker_mod):
    """The port's ResilientDataIterator gets from a worker of either
    package the batches the JAX iterator gets, bitwise: the sampler's
    samples of the dataset."""
    workers = [worker_mod.DataWorker(_samples, i, 2, key=KEY,
                                     random_access=True) for i in range(2)]
    addrs = [w.start() for w in workers]
    try:
        got = _resilient(addrs, ElasticSampler(48, seed=5, rank=0,
                                               num_replicas=1))
        with jcs.ResilientDataIterator(
                addrs, JSampler(48, seed=5, rank=0, num_replicas=1),
                batch_size=8, key=KEY) as jit:
            want = [np.stack(b) for b in jit]
    finally:
        for w in workers:
            w.stop()
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the reference batches: the sampler's indices into the dataset
    data = _samples(0, 1)
    sampler = ElasticSampler(48, seed=5, rank=0, num_replicas=1)
    for k, batch in enumerate(got):
        idx = sampler.indices[k * 8:(k + 1) * 8]
        np.testing.assert_array_equal(batch, np.stack([data[i]
                                                       for i in idx]))


@pytest.mark.parametrize("worker_mod,consumer_mod", [(jcs, cs), (cs, jcs)],
                         ids=["jax-to-port", "port-to-jax"])
def test_streamed_pass_crosses_packages(worker_mod, consumer_mod):
    worker = worker_mod.DataWorker(range_dataset, 0, 1, key=KEY)
    addr = worker.start()
    try:
        it = consumer_mod.DataServiceIterator([addr], job="x", key=KEY)
        got = [b for b in it]
    finally:
        worker.stop()
    assert sorted(int(b[0]) for b in got) == list(range(20))
    assert all(b.dtype == np.int32 and b.shape == (2,) for b in got)


@pytest.mark.parametrize("worker_mod", [cs, jcs], ids=["port", "jax"])
def test_a_consumer_with_the_wrong_key_is_refused(worker_mod):
    worker = worker_mod.DataWorker(_samples, 0, 1, key=KEY,
                                   random_access=True)
    addr = worker.start()
    try:
        with pytest.raises(RuntimeError, match="data workers are dead"):
            _resilient([addr], ElasticSampler(48, seed=5, rank=0,
                                              num_replicas=1),
                       key=b"\x02" * 32)
    finally:
        worker.stop()


# -- the kill drill ----------------------------------------------------------

def _drill(mod, sampler_cls, chaos_mod, kill):
    """tests/test_chaos_e2e.py's ``_train_over_data_service`` over one
    package: 3 random-access workers, sampler-defined batches, an SGD-like
    update from each batch; returns (params, processed indices, batches,
    per-batch params)."""
    def dataset_fn(i, n):
        rng = np.random.RandomState(99)
        return [rng.randn(4).astype(np.float64) for _ in range(64)]

    chaos_mod.install(kill)
    workers = [mod.DataWorker(dataset_fn, i, 3, random_access=True)
               for i in range(3)]
    addrs = [w.start() for w in workers]
    sampler = sampler_cls(64, shuffle=True, seed=13, rank=0,
                          num_replicas=1)
    params = np.zeros(4, np.float64)
    trajectory = []
    try:
        with mod.ResilientDataIterator(addrs, sampler, batch_size=8) as it:
            for batch in it:
                params = params - 0.1 * np.mean(np.stack(batch), axis=0)
                trajectory.append(params.copy())
    finally:
        for w in workers:
            w.stop()
        chaos_mod.install(None)
    return params, sampler.processed_indices, trajectory


def _counter(snap, name):
    return sum(s["value"] for s in snap[name]["series"]) \
        if name in snap else 0.0


def test_kill_drill_trajectories_bitwise_on_both_packages():
    kill = {"data_worker_kill": {"worker": 1, "after_batches": 2}}
    deaths = _counter(M.metrics_snapshot(), "hvd_data_worker_deaths_total")
    reshards = _counter(M.metrics_snapshot(), "hvd_data_reshards_total")
    clean = _drill(cs, ElasticSampler, chaos, None)
    port = _drill(cs, ElasticSampler, chaos, kill)
    ref = _drill(jcs, JSampler, jchaos, kill)
    assert len(port[2]) == len(ref[2]) == len(clean[2]) == 8
    for a, b, c in zip(port[2], ref[2], clean[2]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert sorted(set(port[1])) == list(range(64))
    assert port[1] == ref[1]
    snap = M.metrics_snapshot()
    assert _counter(snap, "hvd_data_worker_deaths_total") >= deaths + 1
    assert _counter(snap, "hvd_data_reshards_total") >= reshards + 1
    kills = [s["value"] for s in snap["hvd_chaos_injections_total"]["series"]
             if s["labels"]["action"] == "data_worker_kill"]
    assert kills and kills[0] >= 1
    jsnap = JM.metrics_snapshot()
    for name in ("hvd_data_worker_deaths_total", "hvd_data_reshards_total"):
        assert (snap[name]["kind"], snap[name]["help"]) == \
            (jsnap[name]["kind"], jsnap[name]["help"])


# -- train_loop fed by the service -------------------------------------------

def _tokens(i, n):
    rng = np.random.RandomState(7)
    return [rng.randn(6).astype(np.float32) for _ in range(40)]


def _linear_state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    w = torch.nn.Parameter(torch.randn(6, generator=gen))
    return {"w": w, "opt": torch.optim.SGD([w], lr=0.05, momentum=0.9)}


def _linear_step(state, batch):
    state["opt"].zero_grad()
    loss = ((batch @ state["w"]) ** 2).mean()
    loss.backward()
    state["opt"].step()
    return state, loss.detach()


def test_train_loop_fed_by_the_service_with_the_knobs_set(monkeypatch):
    """Workers register and heartbeat (0.2 s) through the registry, the
    consumer folds in its deadline (2 s); worker 2 is killed after 3
    requests. The loop runs all 5 steps and ends where the same steps on
    in-memory batches end, bitwise."""
    monkeypatch.setenv("HOROVOD_FAULT_HEARTBEAT_SECONDS", "0.2")
    monkeypatch.setenv("HOROVOD_FAULT_WORKER_DEADLINE", "2")
    assert faults.heartbeat_interval_s() == 0.2
    assert faults.worker_deadline_s() == 2.0
    svc = ComputeService(dispatchers=1, workers_per_dispatcher=3, key=KEY)
    cfg = make_config(svc.start(), workers_per_dispatcher=3)
    chaos.install({"data_worker_kill": {"worker": 2, "after_batches": 3}})
    threads = [threading.Thread(target=compute_worker_fn,
                                args=(cfg, _tokens),
                                kwargs={"index": i, "size": 3,
                                        "random_access": True}, daemon=True)
               for i in range(3)]
    for t in threads:
        t.start()
    sampler = ElasticSampler(40, seed=3, rank=0, num_replicas=1)
    try:
        from horovod_tpu_torch.data.compute_service import data_service
        with data_service(cfg, rank=0) as workers:
            it = ResilientDataIterator(workers, sampler, batch_size=8,
                                       key=KEY, client=cfg.compute_client())
            state, info = htt.train_loop(
                _linear_step, _linear_state(),
                (torch.from_numpy(np.stack(b)) for b in it))
            it.close()
    finally:
        cfg.compute_client().shutdown()
        for t in threads:
            t.join(timeout=10)
        svc.stop()
    assert info["final_step"] == 5 and info["status"] == "completed"
    assert all(not t.is_alive() for t in threads)
    data = _tokens(0, 1)
    ref = _linear_state()
    order = ElasticSampler(40, seed=3, rank=0, num_replicas=1).indices
    for k in range(5):
        _linear_step(ref, torch.from_numpy(np.stack(
            [data[i] for i in order[k * 8:(k + 1) * 8]])))
    assert torch.equal(state["w"].detach(), ref["w"].detach())
