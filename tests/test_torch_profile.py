"""The port's profile capture window and its attribution
(``horovod_tpu_torch/tracing/profile.py``) against the JAX package's
``horovod_tpu/tracing/profile.py``: the spec grammar, the interval
algebra, and ``attribute`` on the same synthetic intervals written in
each package's trace format (XLA op events with ``hlo_op`` for JAX;
torch.profiler kernel, runtime and annotation events for the port), then
a real ``HOROVOD_TRACE_PROFILE=steps:2@2`` window through ``train_loop``
in a two-rank gloo world whose attribution names the gradient buckets.

The world runs under a time limit of its own (``LIMIT_S``)."""

import json
import os
import signal

import pytest
import torch

from horovod_tpu.tracing import profile as jprofile
import horovod_tpu_torch as htt
from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.tracing import profile
import test_torch_workers as workers

LIMIT_S = 120

SPECS = ["", "0", "steps:3", "steps:5@7", "steps:0", "steps:1@1", "every:3",
         "steps:", "steps:2@", " steps:4@9 "]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_profile_spec_matches_jax(spec):
    try:
        want = jprofile.parse_profile_spec(spec)
    except ValueError:
        with pytest.raises(ValueError, match="steps:N"):
            profile.parse_profile_spec(spec)
        return
    assert profile.parse_profile_spec(spec) == want


def test_launcher_checks_the_spec_with_the_same_parser():
    from horovod_tpu_torch.runner import launch
    args = launch.build_parser().parse_args(
        ["-np", "1", "--trace-profile", "every:3", "python", "x.py"])
    with pytest.raises(ValueError, match="steps:N"):
        launch.env_from_args(args)
    args = launch.build_parser().parse_args(
        ["-np", "1", "--trace-profile", "steps:2@3", "python", "x.py"])
    assert launch.env_from_args(args)["HOROVOD_TRACE_PROFILE"] == "steps:2@3"


INTERVALS = [
    ([(0, 10), (5, 15), (20, 30)], [(8, 22)]),
    ([(0, 1)], [(2, 3)]),
    ([(0, 4), (4, 6), (10, 12)], [(1, 2), (3, 11)]),
    ([], [(0, 5)]),
]


@pytest.mark.parametrize("a,b", INTERVALS)
def test_interval_algebra_matches_jax(a, b):
    ua, ub = profile._union(a), profile._union(b)
    assert ua == jprofile._union(a) and ub == jprofile._union(b)
    assert profile._total(ua) == jprofile._total(ua)
    assert profile._intersection(ua, ub) == jprofile._intersection(ua, ub)
    evs = [{"ts": lo, "dur": hi - lo} for lo, hi in a]
    assert profile._spans_of(evs) == jprofile._spans_of(evs)


# ---------------------------------------------------------------------------
# attribute: the same intervals in each package's format
# ---------------------------------------------------------------------------

def _jax_ev(name, ts, dur, hlo_op=None):
    e = {"ph": "X", "name": name, "pid": 7, "tid": 1, "ts": float(ts),
         "dur": float(dur)}
    if hlo_op:
        e["args"] = {"hlo_op": hlo_op}
    return e


class _TorchTrace:
    """torch.profiler's Chrome-trace events for kernels launched from
    host threads: a ``cudaLaunchKernel`` runtime event at the launch
    and a ``kernel`` event on the stream, linked by correlation id, and
    ``user_annotation`` ranges (record_function) around launches."""

    def __init__(self):
        self.events, self._corr, self._t = [], 0, 0.0

    def annotate(self, name, thread=1, dur=1000.0):
        self.events.append({"ph": "X", "cat": "user_annotation",
                            "name": name, "pid": 1, "tid": thread,
                            "ts": self._t, "dur": dur})

    def kernel(self, name, ts, dur, thread=1, stream=7, at=None):
        self._corr += 1
        launch = self._t + 1.0 if at is None else at
        self.events.append({"ph": "X", "cat": "cuda_runtime",
                            "name": "cudaLaunchKernel", "pid": 1,
                            "tid": thread, "ts": launch, "dur": 0.5,
                            "args": {"correlation": self._corr}})
        self.events.append({"ph": "X", "cat": "kernel", "name": name,
                            "pid": 0, "tid": stream, "ts": float(ts),
                            "dur": float(dur),
                            "args": {"correlation": self._corr,
                                     "External id": 1000 + self._corr}})


def _close(a, b):
    for k in ("observed_overlap_ratio", "exposed_collective_seconds",
              "exposed_collective_seconds_per_step", "collective_seconds",
              "collective_events"):
        assert a[k] == pytest.approx(b[k]), k


def test_attribute_overlap_and_exposed_matches_jax():
    # collective 0..10, compute 5..15: 5 of 10 collective us hidden
    j = jprofile.attribute([_jax_ev("all-reduce.1", 0, 10, "all-reduce.1"),
                            _jax_ev("fusion.1", 5, 10, "fusion.1")],
                           steps=2)
    t = _TorchTrace()
    t.kernel("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 0, 10, stream=9)
    t.kernel("ampere_sgemm_128x64_nn", 5, 10)
    p = profile.attribute(t.events, steps=2)
    _close(p, j)
    assert p["observed_overlap_ratio"] == pytest.approx(0.5)
    assert p["exposed_collective_seconds_per_step"] == pytest.approx(2.5e-6)


def test_attribute_no_collectives_matches_jax():
    j = jprofile.attribute([_jax_ev("dot.1", 0, 10, "dot.1")])
    t = _TorchTrace()
    t.kernel("ampere_sgemm_128x64_nn", 0, 10)
    p = profile.attribute(t.events)
    _close(p, j)
    assert p["observed_overlap_ratio"] is None


def test_memcpy_and_memset_are_device_ops_but_neither_kind():
    t = _TorchTrace()
    t.kernel("ncclDevKernel_AllReduce", 0, 10, stream=9)
    t.events.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD",
                     "pid": 0, "tid": 7, "ts": 0.0, "dur": 10.0})
    p = profile.attribute(t.events)
    assert p["device_op_events"] == 1 and p["compute_seconds"] == 0
    assert p["observed_overlap_ratio"] == 0.0


def test_per_bucket_attribution_matches_jax():
    """JAX maps instructions to buckets through the HLO op_name metadata;
    torch's kernels take the innermost annotation around their launch on
    the launching thread, whatever stream and time they run at (a hook's
    NCCL kernel runs on its own stream, after the host left the range)."""
    bucket_map = {"all-reduce.2": "hvd_bucket0", "fusion.3": "hvd_bucket1"}
    j = jprofile.attribute([_jax_ev("all-reduce.2", 0, 10, "all-reduce.2"),
                            _jax_ev("fusion.3", 0, 4, "fusion.3"),
                            _jax_ev("dot.9", 0, 4, "dot.9")],
                           bucket_map=bucket_map)
    t = _TorchTrace()
    t.annotate("hvd_bucket0", thread=3, dur=5.0)
    t.kernel("ncclDevKernel_AllReduce", 0, 10, thread=3, stream=9)
    t._t = 100.0
    t.annotate("hvd_bucket1", thread=3, dur=5.0)
    t.kernel("elementwise_kernel", 0, 4, thread=3)
    t._t = 200.0
    t.kernel("ampere_sgemm", 0, 4, thread=3)        # unlabelled: skipped
    p = profile.attribute(t.events)
    assert p["per_bucket"] == j["per_bucket"]
    assert [(b["bucket"], b["events"]) for b in p["per_bucket"]] == [
        ("hvd_bucket0", 1), ("hvd_bucket1", 1)]


def test_tier_stage_labels_split_a_bucket_like_jax():
    j = jprofile.attribute([
        _jax_ev("jit(step)/hvd_bucket2_rs/reduce-scatter", 0, 3, "rs.1"),
        _jax_ev("jit(step)/hvd_bucket2_xdcn/all-reduce", 3, 5, "ar.1"),
        _jax_ev("jit(step)/hvd_bucket2_ag/all-gather", 8, 2, "ag.1")])
    t = _TorchTrace()
    t.annotate("hvd_bucket2", dur=100.0)
    for stage, ts, dur in (("rs", 0, 3), ("xdcn", 3, 5), ("ag", 8, 2)):
        t.annotate(f"hvd_bucket2_{stage}", dur=2.0)
        t.kernel(f"ncclDevKernel_{stage}", ts, dur, stream=9)
        t._t += 10.0
    p = profile.attribute(t.events)
    assert p["per_bucket"] == j["per_bucket"]
    _close(p, j)


def test_kernel_without_a_host_range_falls_back_to_gpu_annotations():
    """Only a kernel whose launch is not in the trace takes the
    ``gpu_user_annotation`` ranges of its stream (and is counted); one
    launched outside every bucket range stays unlabelled, however a
    bucket's device range covers it on the same stream."""
    t = _TorchTrace()
    t.kernel("ncclDevKernel_AllReduce", 10, 5, stream=9, thread=4)
    t.events = [e for e in t.events if e["cat"] != "cuda_runtime"]
    t.events.append({"ph": "X", "cat": "gpu_user_annotation",
                     "name": "hvd_bucket3", "pid": 0, "tid": 9,
                     "ts": 9.0, "dur": 8.0})
    p = profile.attribute(t.events)
    assert [b["bucket"] for b in p["per_bucket"]] == ["hvd_bucket3"]
    assert p["unlaunched_device_events"] == 1
    t = _TorchTrace()
    t.kernel("ampere_sgemm", 10, 5, stream=9, thread=4)
    t.events.append({"ph": "X", "cat": "gpu_user_annotation",
                     "name": "hvd_bucket3", "pid": 0, "tid": 9,
                     "ts": 9.0, "dur": 8.0})
    p = profile.attribute(t.events)
    assert p["per_bucket"] == [] and p["unlaunched_device_events"] == 0


def test_a_device_reading_never_takes_the_host_ops():
    """Asked for the device reading, a trace without kernel events gives
    no device ops and no overlap or exposed numbers (and no gauges),
    where the CPU reading of the same trace counts the aten and c10d
    ops; the result says which reading it took."""
    from horovod_tpu_torch import metrics as M
    host = [{"ph": "X", "cat": "cpu_op", "name": n, "pid": 1, "tid": 1,
             "ts": ts, "dur": 10.0}
            for n, ts in (("aten::mm", 0.0), ("c10d::allreduce_", 5.0))]
    cpu = profile.attribute(host)
    assert cpu["device"] is False and cpu["collective_events"] == 1
    assert cpu["observed_overlap_ratio"] == pytest.approx(0.5)
    card = profile.attribute(host, device=True)
    assert card["device"] is True and card["device_op_events"] == 0
    assert card["observed_overlap_ratio"] is None
    assert card["exposed_collective_seconds"] is None
    assert card["exposed_collective_seconds_per_step"] is None
    gauge = M.gauge("hvd_step_exposed_collective_seconds", "",
                    aggregation="leader")
    gauge.set(-1.0)
    profile.publish_gauges(card)
    assert gauge.value == -1.0
    profile.publish_gauges(cpu)
    assert gauge.value == pytest.approx(cpu[
        "exposed_collective_seconds_per_step"])
    t = _TorchTrace()
    t.kernel("ampere_sgemm", 0, 10)
    assert profile.attribute(t.events)["device"] is True


def test_cpu_trace_counts_aten_ops_and_gloo_work():
    """Without kernel events the aten ops are the device ops and c10d's
    ops and gloo's work the collectives (the JAX reader counts XLA:CPU
    thunks the same way on the CPU)."""
    evs = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1,
         "tid": 1, "ts": 0.0, "dur": 10.0},
        {"ph": "X", "cat": "cpu_op", "name": "MmBackward0", "pid": 1,
         "tid": 1, "ts": 0.0, "dur": 50.0},
        {"ph": "X", "cat": "user_annotation", "name": "hvd_bucket0",
         "pid": 1, "tid": 1, "ts": 20.0, "dur": 5.0},
        {"ph": "X", "cat": "cpu_op", "name": "c10d::allreduce_", "pid": 1,
         "tid": 1, "ts": 21.0, "dur": 1.0},
        {"ph": "X", "cat": "user_annotation", "name": "gloo:all_reduce",
         "pid": 1, "tid": 2, "ts": 22.0, "dur": 8.0},
    ]
    j = jprofile.attribute([
        _jax_ev("dot.1", 0, 10, "dot.1"),
        _jax_ev("jit(f)/hvd_bucket0/all-reduce-start", 21, 1, "ar.1"),
        _jax_ev("all-reduce.2", 22, 8, "all-reduce.2")])
    p = profile.attribute(evs)
    _close(p, j)
    assert p["device_op_events"] == 3
    assert p["per_bucket"] == j["per_bucket"]


def test_device_seconds_by_label():
    t = _TorchTrace()
    t.annotate("blockwise_ce.backward", dur=10.0)
    t.kernel("sgemm", 0, 30)
    t.kernel("sgemm", 30, 20)
    t._t = 50.0
    t.kernel("other", 60, 5)
    assert profile.device_seconds_by_label(
        t.events, r"blockwise_ce\.backward") == {
            "blockwise_ce.backward": pytest.approx(50e-6)}


def test_capture_window_covers_documented_steps(tmp_path):
    """'steps:N@S' profiles steps S..S+N-1: the window opens at the END
    of step S-1 and writes the attribution when it closes."""
    prof = profile.StepProfiler(2, 3, log_dir=str(tmp_path))
    x = torch.randn(32, 32)
    prof.on_step_end(1)
    assert prof._prof is None              # not open before S-1
    prof.on_step_end(2)
    assert prof._active and prof._first_profiled == 3
    x @ x
    prof.on_step_end(3)
    assert prof._active
    x @ x
    prof.on_step_end(4)                    # steps 3 and 4: closes
    assert not prof._active and prof._prof is None
    a = json.loads((tmp_path / "profile_attribution.json").read_text())
    assert a["profiled_steps"] == 2 and len(a["window_step_seconds"]) == 2
    assert a["device_op_events"] > 0 and a["collective_events"] == 0
    assert a["observed_overlap_ratio"] is None
    prof.stop()                            # idempotent
    prof.on_step_end(9)
    assert profile.find_trace_files(str(tmp_path))


def test_stop_mid_window_closes_the_profiler(tmp_path):
    prof = profile.StepProfiler(5, 2, log_dir=str(tmp_path))
    prof.on_step_end(1)
    assert prof._active
    prof.stop()
    assert not prof._active
    assert (tmp_path / "profile_attribution.json").exists()
    with torch.profiler.profile():         # no profiler left running
        pass


def test_train_loop_opens_the_window_from_the_knob(tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_TRACE_DIR", str(tmp_path))
    knobs.set_override("HOROVOD_TRACE_PROFILE", "steps:2@2")
    try:
        x = torch.randn(16, 16)
        seen = []

        def step(state, b):
            seen.append(b)
            return state + 1, (x @ x).sum()

        state, info = htt.train_loop(step, 0, [1, 2, 3, 4, 5])
    finally:
        knobs.clear_override("HOROVOD_TRACE_PROFILE")
    assert info["final_step"] == 5 and seen == [1, 2, 3, 4, 5]
    a = json.loads((tmp_path / "profile" /
                    "profile_attribution.json").read_text())
    assert a["profiled_steps"] == 2 and a["device_op_events"] > 0


# ---------------------------------------------------------------------------
# a real window in a two-rank gloo world
# ---------------------------------------------------------------------------

def _on_alarm(signum, frame):
    raise TimeoutError(f"{__name__} ran past its {LIMIT_S} s limit")


def test_two_rank_window_attributes_every_bucket(tmp_path):
    import numpy as np
    rng = np.random.default_rng(0)
    batches = [(rng.standard_normal((8, 16)).astype(np.float32),
                rng.standard_normal((8, 4)).astype(np.float32))
               for _ in range(5)]
    phases = [{"env": {"HOROVOD_TRACE_DIR": str(tmp_path / "trace")},
               "knobs": {"HOROVOD_TRACE_PROFILE": "steps:2@2",
                         "HOROVOD_GRADIENT_BUCKET_BYTES": 2048},
               "threads": 1,
               "scenarios": [{"kind": "observe", "name": "window",
                              "batches": batches}]}]
    old = signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(LIMIT_S)
    try:
        load = workers.run_phases(2, phases, tmp_path)
        outs = [load("window", r) for r in range(2)]
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    for r, out in enumerate(outs):
        assert int(out["final_step"]) == 5
        n_buckets = int(out["n_buckets"])
        assert n_buckets >= 3
        a = json.loads(str(out["attribution"]))
        assert a["profiled_steps"] == 2
        assert a["collective_events"] > 0
        assert a["observed_overlap_ratio"] is not None
        labels = [b["bucket"] for b in a["per_bucket"]]
        assert labels == [f"hvd_bucket{k}" for k in range(n_buckets)], r
        assert all(b["device_seconds"] > 0 for b in a["per_bucket"])
        assert os.path.exists(tmp_path / "trace" / "profile" / f"rank{r}" /
                              "profile_attribution.json")
