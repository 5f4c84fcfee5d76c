"""The port's metrics exports against the JAX package's, on the CPU.

The cases of ``tests/test_metrics.py`` that export: the Prometheus
exposition golden, ``/metrics`` counters that advance between two scrapes
of a live coordinator, ``/healthz`` under a stall (and 503 once the
stall inspector aborts), the cross-rank aggregator over a ``TCPStore``
(two clients in process, and a two-rank gloo world where ``init`` starts
the publisher), the JSON dumper and the ``HOROVOD_METRICS_DUMP`` final
dump at ``shutdown``. ``/healthz`` carries the JAX package's blocks and
statuses for the same state, the serving and fleet blocks included.

The whole module runs under a time limit of its own (``LIMIT_S``); the
two-rank world has its own (``WORLD_LIMIT_S``).
"""

import itertools
import json
import re
import signal
import socket
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

import horovod_tpu_torch as htt
from horovod_tpu import metrics as JM
from horovod_tpu.config import knobs as jknobs
from horovod_tpu.serving import ServeEngine as JServeEngine
from horovod_tpu.serving import ServingFleet as JServingFleet
from horovod_tpu.serving import reset_for_tests as jreset_serving
from horovod_tpu.stall_inspector import get_stall_inspector as jinspector
from horovod_tpu_torch import metrics as M
from horovod_tpu_torch import params_from_numpy
from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.serving import Request, ServeEngine, ServingFleet
from horovod_tpu_torch.serving import reset_for_tests as reset_serving
from horovod_tpu_torch.stall_inspector import get_stall_inspector
from horovod_tpu_torch.utils.kvstore import DistributedKV
import test_torch_serving as ts
import test_torch_workers as tw

LIMIT_S = 150
WORLD_LIMIT_S = 60
_uniq = itertools.count()


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
def _clean():
    get_stall_inspector().reset()
    jinspector().reset()
    yield
    if htt.is_initialized():
        htt.shutdown()
    M.stop_exports()
    for name in ("HOROVOD_METRICS_PORT", "HOROVOD_METRICS_DUMP",
                 "HOROVOD_METRICS_DUMP_INTERVAL",
                 "HOROVOD_STALL_CHECK_TIME_SECONDS",
                 "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS"):
        knobs.clear_override(name)
        jknobs.clear_override(name)
    get_stall_inspector().reset()
    jinspector().reset()
    reset_serving()
    jreset_serving()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? (\+|-)?(Inf|[0-9.e+-]+)$")


def _parse_exposition(text: str):
    """{name: value} for label-free samples; also validates every line."""
    out = {}
    for line in text.strip().splitlines():
        if line.startswith("#"):
            assert re.match(r"^# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* ",
                            line), line
            continue
        assert _SAMPLE_RE.match(line), f"unparseable sample line: {line!r}"
        name, _, value = line.partition(" ")
        if "{" not in name:
            out[name] = float(value)
    return out


def _run_steps(n_steps: int, tensors_per_step: int = 3):
    """A few steps of async allreduces through the coordinator (the same
    fused signature every step, so its plan cache hits from step 2)."""
    for _ in range(n_steps):
        hs = [htt.allreduce_async(torch.ones(8, 16), op=htt.Sum,
                                  name=f"mstep.{next(_uniq)}")
              for _ in range(tensors_per_step)]
        for h in hs:
            h.wait()


# ---------------------------------------------------------------------------
# exposition format (golden)
# ---------------------------------------------------------------------------

def test_prometheus_exposition_golden():
    """The JAX test's golden text, from both registries."""
    expected = "\n".join([
        "# HELP t_requests_total Total requests",
        "# TYPE t_requests_total counter",
        't_requests_total{op="all\\"re\\\\duce\\n"} 2',
        "# HELP t_depth Queue depth",
        "# TYPE t_depth gauge",
        "t_depth 3.5",
        "# HELP t_lat_seconds Latency",
        "# TYPE t_lat_seconds histogram",
        't_lat_seconds_bucket{le="0.1"} 0',
        't_lat_seconds_bucket{le="1"} 2',
        't_lat_seconds_bucket{le="+Inf"} 3',
        "t_lat_seconds_sum 2.75",
        "t_lat_seconds_count 3",
    ]) + "\n"
    for mod in (M, JM):
        reg = mod.MetricsRegistry()
        reg.counter("t_requests_total", "Total requests",
                    labelnames=("op",)).labels(op='all"re\\duce\n').inc(2)
        reg.gauge("t_depth", "Queue depth").set(3.5)
        h = reg.histogram("t_lat_seconds", "Latency", buckets=(0.1, 1.0))
        for v in (0.25, 0.5, 2.0):
            h.observe(v)
        assert reg.render() == expected


# ---------------------------------------------------------------------------
# HTTP end to end
# ---------------------------------------------------------------------------

def test_metrics_http_endpoint_counters_increase():
    """With HOROVOD_METRICS_PORT set, ``init`` serves ``/metrics``; its
    cycle, bytes and cache-hit counters strictly increase between two
    scrapes of a live coordinator, and the histograms carry their
    bucket/sum/count triple."""
    port = _free_port()
    knobs.set_override("HOROVOD_METRICS_PORT", port)
    htt.init(device="cpu")
    assert M.get_metrics_server().port == port
    _run_steps(3)
    status_a, text_a = _get(port, "/metrics")
    assert status_a == 200
    a = _parse_exposition(text_a)
    _run_steps(3)
    status_b, text_b = _get(port, "/metrics")
    assert status_b == 200
    b = _parse_exposition(text_b)
    for name in ("hvd_cycles_total", "hvd_bytes_reduced_total",
                 "hvd_cache_hits_total"):
        assert name in a and name in b, name
        assert b[name] > a[name], f"{name}: {a[name]} -> {b[name]}"
    for suffix in ("_bucket", "_sum", "_count"):
        assert f"hvd_cycle_duration_seconds{suffix}" in text_b
    assert "hvd_handle_wait_seconds_count" in text_b
    assert b["hvd_world_size"] == 1 and b["hvd_process_count"] == 1
    assert _get(port, "/nope")[0] == 404
    htt.shutdown()
    assert M.get_metrics_server() is None


def test_healthz_reflects_stall_state_as_jax_does():
    """``/healthz`` goes ok -> degraded -> ok with a stalled operation, as
    the JAX package's ``health_snapshot`` does for the same state, and
    answers 503 once the inspector aborts."""
    port = _free_port()
    knobs.set_override("HOROVOD_METRICS_PORT", port)
    htt.init(device="cpu")
    insp, jinsp = get_stall_inspector(), jinspector()
    seen = []

    def both():
        code, body = _get(port, "/healthz")
        assert code == 200
        seen.append((json.loads(body)["status"],
                     JM.health_snapshot()["status"]))

    both()
    for k in (knobs, jknobs):
        k.set_override("HOROVOD_STALL_CHECK_TIME_SECONDS", 0)
    for i in (insp, jinsp):
        i.record_start("hz_stuck_op")
    time.sleep(0.01)
    for i in (insp, jinsp):
        i.check_for_stalls()
    both()
    for i in (insp, jinsp):
        i.record_done("hz_stuck_op")
    both()
    assert seen == [("ok", "ok"), ("degraded", "degraded"), ("ok", "ok")]
    knobs.set_override("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", 1e-9)
    insp.record_start("hz_dead_op")
    time.sleep(0.01)
    insp.check_for_stalls()
    code, body = _get(port, "/healthz")
    assert code == 503 and json.loads(body)["status"] == "unhealthy"


def _fleets():
    """A fleet of two on each package, served the same four requests."""
    jp = ts.jtfm.init_params(ts._jcfg(), jax.random.PRNGKey(0))
    pp = params_from_numpy(ts._np_tree(jp), "cpu")
    kw = dict(replicas=2, min_replicas=1, max_replicas=4,
              scale_down_idle=10 ** 9, cooldown=0, queue_deadline=0.0)
    jfleet = JServingFleet(lambda rid: ts._synchronous(JServeEngine(
        ts._jcfg(), jp, mesh=None, **ts.ENGINE_KW)), **kw)
    fleet = ServingFleet(lambda rid: ServeEngine(
        ts._cfg(), pp, device="cpu", **ts.ENGINE_KW), **kw)
    for f, cls in ((jfleet, ts.JRequest), (fleet, Request)):
        rng = np.random.default_rng(8)
        f.run([cls(rid=i, prompt=rng.integers(1, 255, 12).astype(np.int32),
                   max_new_tokens=3, arrival=0.0) for i in range(4)])
    return jfleet, fleet


def _blocks(h):
    """The parts of a /healthz payload both packages must agree on: the
    status, every block's keys, and the values of the stall, fleet and
    serving blocks (builds and the store's outcomes left out: a JAX
    replica without its artifact store compiles)."""
    def strip(d):
        if isinstance(d, dict):
            return {k: strip(v) for k, v in d.items()
                    if k not in ("builds", "store_outcomes")}
        return d
    return {"status": h["status"],
            "keys": {k: sorted(v) for k, v in h.items()
                     if isinstance(v, dict)},
            "stall": h["stall"], "preemption": h["preemption"],
            "fleet": strip(h["fleet"]), "serving": strip(h["serving"])}


def test_healthz_blocks_match_jax_with_serving_and_fleet():
    """For the same state (a fleet of two that served four requests, no
    stall) both packages' ``/healthz`` have the same status, the same
    blocks with the same keys, and the same serving and fleet blocks; the
    port's is served over HTTP."""
    jfleet, fleet = _fleets()
    srv = M.start_metrics_server(0, host="127.0.0.1")
    code, body = _get(srv.port, "/healthz")
    assert code == 200
    got, want = json.loads(body), JM.health_snapshot()
    for h in (got, want):
        for absent_here in ("straggler", "goodput", "world",
                            "artifact_store"):
            h.pop(absent_here, None)
    assert {"serving", "fleet"} <= set(got)
    assert _blocks(got) == _blocks(want)
    assert got["fleet"]["members"]["replica-0"]["builds"] == 0
    assert set(got["fleet"]["members"]) == {"replica-0", "replica-1"}
    _, text = _get(srv.port, "/metrics")
    for name in ("hvd_serve_requests_total", "hvd_serve_ttft_seconds_count",
                 "hvd_fleet_replicas"):
        assert name in text, name


# ---------------------------------------------------------------------------
# cross-rank aggregation
# ---------------------------------------------------------------------------

def test_cluster_aggregator_over_tcp_store():
    """Two ranks' clients of one TCPStore: the follower publishes (twice:
    a republication must pass the store's write-once set), the leader
    merges its own snapshot and the follower's, as the JAX test's."""
    import torch.distributed as dist
    master = dist.TCPStore("127.0.0.1", 0, 2, is_master=True,
                           wait_for_workers=False)
    client = dist.TCPStore("127.0.0.1", master.port, 2, is_master=False)
    marker = M.counter(f"t_agg_{next(_uniq)}_total", "agg marker")
    marker.inc(3)
    follower = M.ClusterAggregator(DistributedKV(client), process_index=1,
                                   process_count=2)
    follower.publish()
    follower.publish()
    leader = M.ClusterAggregator(DistributedKV(master), process_index=0,
                                 process_count=2)
    merged = leader.merged_snapshot()
    assert merged[marker.name]["series"][0]["value"] == 6
    assert f"{marker.name} 6" in M.render_snapshot(merged)
    # a missing peer contributes nothing; the scrape does not block
    lonely = M.ClusterAggregator(DistributedKV(master), process_index=0,
                                 process_count=3)
    assert lonely.merged_snapshot()[marker.name]["series"][0]["value"] == 6


def test_metrics_aggregate_across_a_two_rank_world(tmp_path):
    """In a gloo world of two, ``init`` starts rank 1's publisher; rank 0's
    ``metrics_snapshot(aggregate=True)`` and its ``/metrics`` show the sum
    of both ranks' counters."""
    def expired(signum, frame):
        raise TimeoutError(f"two-rank world ran past {WORLD_LIMIT_S} s")

    marker = f"t_world_agg_{next(_uniq)}_total"
    phases = [{"knobs": {"HOROVOD_METRICS_AGG_INTERVAL": 0.05},
               "scenarios": [{"name": "agg", "kind": "metrics_agg",
                              "marker": marker, "timeout_s": 20.0}]}]
    prev = signal.signal(signal.SIGALRM, expired)
    left = signal.alarm(WORLD_LIMIT_S)
    t0 = time.monotonic()
    try:
        load = tw.run_phases(2, phases, tmp_path)
        out = load("agg", 0)
    finally:
        signal.signal(signal.SIGALRM, prev)     # the module's limit again
        spent = int(time.monotonic() - t0) + 1
        signal.alarm(max(left - spent, 1) if left else 0)
    assert float(out["merged"]) == float(out["want"]) == 3.0
    assert bool(out["scraped"])


# ---------------------------------------------------------------------------
# JSON snapshot dump
# ---------------------------------------------------------------------------

def test_snapshot_dumper_writes_valid_json(tmp_path):
    htt.init(device="cpu")
    _run_steps(1)
    path = str(tmp_path / "metrics.json")
    dumper = M.SnapshotDumper(path, interval=0.05)
    deadline = time.time() + 5
    while not (tmp_path / "metrics.json").exists() and time.time() < deadline:
        time.sleep(0.02)
    dumper.stop()                       # the final dump always lands
    payload = json.load(open(path))
    assert payload["health"]["status"] in ("ok", "degraded")
    assert "hvd_cycles_total" in payload["metrics"]
    assert set(payload) == {"time", "pid", "health", "metrics"}


def test_metrics_dump_knob_final_dump(tmp_path):
    path = str(tmp_path / "dump.json")
    knobs.set_override("HOROVOD_METRICS_DUMP", path)
    knobs.set_override("HOROVOD_METRICS_DUMP_INTERVAL", 3600.0)
    htt.init(device="cpu")
    _run_steps(1)
    htt.shutdown()                      # stop_exports -> the final dump
    payload = json.load(open(path))
    assert "hvd_bytes_reduced_total" in payload["metrics"]
    assert payload["health"]["world"]["size"] == 1


def test_busy_metrics_port_falls_back_to_an_ephemeral_one():
    """A second process on the launcher's port binds another, as the JAX
    ``init_from_env`` does, instead of failing ``init``."""
    taken = socket.socket()
    taken.bind(("0.0.0.0", 0))
    taken.listen(1)
    try:
        knobs.set_override("HOROVOD_METRICS_PORT", taken.getsockname()[1])
        htt.init(device="cpu")
        srv = M.get_metrics_server()
        assert srv is not None and srv.port != taken.getsockname()[1]
        assert _get(srv.port, "/healthz")[0] == 200
    finally:
        taken.close()
