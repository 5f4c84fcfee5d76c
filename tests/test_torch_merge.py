"""The port's cross-rank trace merge (``horovod_tpu_torch/tracing/merge.py``)
against the JAX package's ``horovod_tpu/tracing/merge.py``: clock offsets
and merged payloads on the same summaries, the publish/collect protocol
over a real c10d ``TCPStore`` pair, the shed site, ``shutdown`` writing
the merged file, and a two-rank gloo world with a chaos ``clock_skew``
drill.

The module runs under a time limit of its own (``LIMIT_S``)."""

import json
import os
import signal
import socket
import threading
import time

import numpy as np
import pytest
import torch.distributed as dist

from horovod_tpu.tracing import merge as jmerge
import horovod_tpu_torch as htt
from horovod_tpu_torch.resilience import faults
from horovod_tpu_torch.tracing import merge
from horovod_tpu_torch.tracing import spans
from horovod_tpu_torch.utils.kvstore import DistributedKV
import test_torch_workers as workers

LIMIT_S = 120


@pytest.fixture(scope="module", autouse=True)
def _limit():
    def on_alarm(signum, frame):
        raise TimeoutError(f"{__name__} ran past its {LIMIT_S} s limit")
    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def _clean():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()
    faults.reset_for_tests()


def _summary(pidx, epoch_unix, names):
    return {
        "process_index": pidx, "hostname": f"host{pidx}",
        "pid": 1000 + pidx, "trace_id": "t0",
        "epoch_unix": epoch_unix, "dropped": 0,
        "spans": [{"name": n, "cat": "t", "ts_us": 10.0 * i,
                   "dur_us": 5.0, "tid": 1, "span_id": i + 1,
                   "parent_id": 0, "attrs": {"i": i}}
                  for i, n in enumerate(names)],
    }


def test_clock_offset_and_merged_payload_equal_jax():
    leader = _summary(0, 1000.0, ["a", "b"])
    f1 = _summary(1, 1000.25, ["c"])               # 250 ms ahead
    f2 = _summary(2, 999.5, ["d", "e", "f"])       # 500 ms behind
    for f in (f1, f2):
        assert merge.clock_offset_us(leader, f) == \
            jmerge.clock_offset_us(leader, f)
    assert merge.clock_offset_us(leader, f1) == pytest.approx(250_000.0)
    # given out of order: the lowest index anchors in both packages
    got = merge.merge_summaries([f2, leader, f1])
    want = jmerge.merge_summaries([f2, leader, f1])
    assert got == want
    assert merge.merge_summaries([]) == jmerge.merge_summaries([])
    b = [e for e in got["traceEvents"] if e.get("ph") == "X"
         and e["pid"] == 1][0]
    assert b["ts"] == pytest.approx(250_000.0)


@pytest.fixture()
def store_pair():
    """Two ranks' clients of one TCPStore (a real c10d transport)."""
    master = dist.TCPStore("127.0.0.1", 0, 2, is_master=True,
                           wait_for_workers=False)
    client = dist.TCPStore("127.0.0.1", master.port, 2, is_master=False)
    return DistributedKV(master), DistributedKV(client)


def test_two_ranks_through_a_real_store(tmp_path, store_pair):
    leader_kv, follower_kv = store_pair
    spans.enable(trace_id="shared")
    with spans.span("leader_op", cat="t"):
        pass
    follower = _summary(1, spans.epoch_unix() + 0.5, ["follower_op"])
    follower_kv.set("hvd/trace/p1", json.dumps(follower), overwrite=True)
    path = str(tmp_path / "merged.trace.json")
    out = merge.merged_chrome_trace(path, kv=leader_kv, process_index=0,
                                    process_count=2)
    assert out == path
    data = json.loads(open(path).read())
    names = {(e["pid"], e["args"]["name"]) for e in data["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "process_name"}
    assert {n for _, n in names} == {f"host0 ({socket.gethostname()})",
                                     "host1 (host1)"}
    xs = {e["name"] for e in data["traceEvents"] if e.get("ph") == "X"}
    assert {"leader_op", "follower_op"} <= xs
    assert data["metadata"]["merged_hosts"] == 2
    assert data["metadata"]["clock_offsets_us"]["1"] == \
        pytest.approx(500_000.0, rel=1e-6)
    # the leader's own summary was published for its peers too
    assert follower_kv.try_get("hvd/trace/p0") is not None


def test_follower_writes_nothing(tmp_path, store_pair):
    leader_kv, follower_kv = store_pair
    spans.enable()
    with spans.span("x"):
        pass
    path = str(tmp_path / "f.trace.json")
    out = merge.merged_chrome_trace(path, kv=follower_kv, process_index=1,
                                    process_count=2)
    assert out == "" and not os.path.exists(path)
    assert leader_kv.try_get("hvd/trace/p1") is not None


def test_leader_waits_for_a_late_follower(tmp_path, store_pair):
    leader_kv, follower_kv = store_pair
    spans.enable(trace_id="shared")
    with spans.span("leader_op", cat="t"):
        pass
    follower = _summary(1, spans.epoch_unix(), ["late_op"])

    def publish_late():
        time.sleep(0.2)
        follower_kv.set("hvd/trace/p1", json.dumps(follower),
                        overwrite=True)

    t = threading.Thread(target=publish_late)
    t.start()
    try:
        path = str(tmp_path / "late.trace.json")
        merge.merged_chrome_trace(path, kv=leader_kv, process_index=0,
                                  process_count=2, wait_s=5.0)
        data = json.loads(open(path).read())
        assert data["metadata"]["merged_hosts"] == 2
        assert "late_op" in {e["name"] for e in data["traceEvents"]
                             if e.get("ph") == "X"}
    finally:
        t.join()


def test_dead_peer_is_tolerated(tmp_path, store_pair):
    leader_kv, _ = store_pair
    spans.enable()
    with spans.span("only_leader"):
        pass
    path = str(tmp_path / "m.trace.json")
    merge.merged_chrome_trace(path, kv=leader_kv, process_index=0,
                              process_count=3, wait_s=0.2)
    data = json.loads(open(path).read())
    assert data["metadata"]["merged_hosts"] == 1


def test_shed_site_writes_a_local_only_trace(tmp_path, store_pair):
    leader_kv, follower_kv = store_pair
    spans.enable()
    with spans.span("leader_op"):
        pass
    follower_kv.set("hvd/trace/p1", json.dumps(_summary(1, 0.0, ["f"])),
                    overwrite=True)
    faults.fault_domain().record_exhausted("trace_merge", critical=False)
    assert faults.should_shed("trace_merge")
    path = str(tmp_path / "shed.trace.json")
    assert merge.merged_chrome_trace(path, kv=leader_kv, process_index=0,
                                     process_count=2) == path
    data = json.loads(open(path).read())
    assert data["metadata"]["merged_hosts"] == 1
    assert leader_kv.try_get("hvd/trace/p0") is None     # never touched


def test_shutdown_writes_the_merged_file(tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_TRACE", "1")
    monkeypatch.setenv("HOROVOD_TRACE_DIR", str(tmp_path))
    htt.init(device="cpu")
    try:
        assert spans.enabled()
        with spans.span("user.block", cat="t"):
            pass
    finally:
        htt.shutdown()
    assert not spans.enabled()
    path = tmp_path / f"merged-{socket.gethostname()}-p0.trace.json"
    data = json.loads(path.read_text())
    assert data["metadata"]["merged_hosts"] == 1
    assert "user.block" in {e["name"] for e in data["traceEvents"]
                            if e.get("ph") == "X"}


def test_export_on_shutdown_without_spans_writes_nothing(tmp_path):
    assert merge.export_on_shutdown(directory=str(tmp_path)) is None
    assert not os.listdir(tmp_path)


def test_two_rank_world_merges_with_a_clock_skew_drill(tmp_path):
    """Both ranks trace; rank 1's wall-clock anchor is skewed 2.5 s by
    chaos before shutdown; rank 0's merged file has both tracks and an
    offset that absorbs the skew: follower anchor + skew - leader
    anchor. The same world runs the numerics drill through the
    coordinator and writes a ledger record on each rank."""
    skew = 2.5
    rng = np.random.default_rng(1)
    batches = [(rng.standard_normal((8, 16)).astype(np.float32),
                rng.standard_normal((8, 4)).astype(np.float32))
               for _ in range(3)]
    trace_dir = tmp_path / "trace"
    ledgers = [str(tmp_path / f"ledger-{r}.jsonl") for r in range(2)]
    phases = [{"env": {"HOROVOD_TRACE": "1",
                       "HOROVOD_TRACE_DIR": str(trace_dir),
                       "HOROVOD_GOODPUT_LEDGER": ledgers},
               "knobs": {"HOROVOD_NUMERICS": True,
                         "HOROVOD_NUMERICS_CHECK_EVERY": 1000},
               "threads": 1,
               "scenarios": [{"kind": "observe", "name": "merge",
                              "batches": batches, "clock_skew": skew,
                              "nan": True}]}]
    load = workers.run_phases(2, phases, tmp_path)
    outs = [load("merge", r) for r in range(2)]
    epochs = [float(o["epoch_unix"]) for o in outs]
    # the numerics drill: the NaN rank 0 put into num_bad is in the sum on
    # both ranks, and each rank's shutdown record carries it
    for r, o in enumerate(outs):
        (a,) = json.loads(str(o["anomalies"]))
        assert a["buckets"] == [{"bucket": 0, "nonfinite": 1,
                                 "label": "num_bad"}], r
        (rec,) = [json.loads(line) for line in open(ledgers[r])]
        assert rec["world_size"] == 2 and rec["chip"] == "cpu"
        assert rec["numerics"]["by_kind"] == {"nonfinite": 1}
        assert rec["wire"]["n_buckets"] >= 1
    files = sorted(p for p in os.listdir(trace_dir)
                   if p.startswith("merged-"))
    assert files == [f"merged-{socket.gethostname()}-p0.trace.json"]
    data = json.loads((trace_dir / files[0]).read_text())
    meta = data["metadata"]
    assert meta["merged_hosts"] == 2 and meta["anchor_process"] == 0
    assert meta["clock_offsets_us"]["0"] == 0.0
    assert meta["clock_offsets_us"]["1"] == pytest.approx(
        (epochs[1] + skew - epochs[0]) * 1e6, abs=1.0)
    tracks = {e["pid"] for e in data["traceEvents"]
              if e.get("ph") == "M" and e["name"] == "process_name"}
    assert tracks == {0, 1}
    for pid in (0, 1):
        names = {e["name"] for e in data["traceEvents"]
                 if e.get("ph") == "X" and e["pid"] == pid}
        assert {"observe.train", "train.step"} <= names, pid
