"""The port's native core (``horovod_tpu_torch/native``, built from
``horovod_tpu_torch/csrc/core.cc``) and its timeline, on the CPU.

``tests/test_native.py`` replayed against the port: the native and the
Python bin planners equal the JAX package's ``plan_fusion_bins`` over
hypothesis-drawn sizes and thresholds; ``pack_arrays`` equals ``np.stack``
(so its flat buffer is ``np.concatenate`` of the raveled arrays) on the
inline and the threaded copy paths and refuses what it cannot copy; the
native writer's file is a valid Chrome trace; both timeline writers (the
native one, and the Python one under ``HOROVOD_TPU_NATIVE=0``) give a
file ``json.load`` reads, with each tensor's QUEUE and DISPATCH events and
the cycle marks of a coordinator cycle. The library is built under
``build/horovod_tpu_torch/``, never in the source tree, and a build that
fails raises with the compiler's message instead of falling back.
"""

import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from horovod_tpu.ops.fusion import plan_fusion_bins as jax_plan
from horovod_tpu_torch import native
from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.ops.fusion import _plan_fusion_bins_py, plan_fusion_bins


def test_native_core_builds_under_build_and_loads():
    st_ = native.status()
    assert st_["available"], f"native build failed: {st_['build_error']}"
    path = native.library_path()
    assert st_["path"] == str(path)
    assert path.parent.parts[-2:] == ("build", "horovod_tpu_torch")
    assert path.name.startswith("libhvdcore-") and path.exists()
    # nothing is written into the source tree
    assert not list(native.CSRC.glob("*.so"))


@settings(max_examples=60, deadline=None)
@given(sizes=st.lists(st.integers(1, 1 << 22), max_size=40),
       threshold=st.sampled_from([0, 1, 1024, 1 << 16, 1 << 22, 1 << 27]))
def test_planners_equal_the_jax_planner(sizes, threshold):
    want = jax_plan(sizes, threshold)
    assert native.plan_fusion_bins(sizes, threshold) == want
    assert _plan_fusion_bins_py(sizes, threshold) == want
    assert plan_fusion_bins(sizes, threshold) == want


def test_plan_fusion_bins_lookahead_and_oversize():
    assert plan_fusion_bins([10, 999999, 10], threshold=100) == [[0, 2], [1]]
    assert plan_fusion_bins([999999, 10], threshold=100) == [[0], [1]]


def test_python_planner_under_the_knob(monkeypatch):
    monkeypatch.setenv("HOROVOD_TPU_NATIVE", "0")
    assert knobs.get("HOROVOD_TPU_NATIVE") is False
    assert not native.available()
    assert native.plan_fusion_bins([1, 2], 2) is None
    assert native.pack_arrays([np.zeros(2)]) is None
    assert plan_fusion_bins([1, 2, 3], 3) == [[0, 1], [2]]


@pytest.mark.parametrize("shape", [(3,), (16, 16), (2, 5, 7)])
def test_pack_arrays_equals_np_stack(shape):
    rng = np.random.RandomState(1)
    arrs = [rng.rand(*shape).astype(np.float32) for _ in range(5)]
    out = native.pack_arrays(arrs)
    np.testing.assert_array_equal(out, np.stack(arrs))
    np.testing.assert_array_equal(
        out.reshape(-1), np.concatenate([a.reshape(-1) for a in arrs]))


def test_pack_arrays_large_parallel_path():
    """> 4 MiB in all takes the multi-threaded copy."""
    arrs = [np.full((1 << 20,), i, np.float32) for i in range(4)]
    np.testing.assert_array_equal(native.pack_arrays(arrs), np.stack(arrs))


def test_pack_arrays_refuses_mixed_shapes_and_objects():
    assert native.pack_arrays([np.zeros((2,)), np.zeros((3,))]) is None
    assert native.pack_arrays([np.array([{"x": 1}], dtype=object),
                               np.array([{"y": 2}], dtype=object)]) is None


def test_native_timeline_writer_valid_chrome_trace(tmp_path):
    path = str(tmp_path / "tl.json")
    w = native.NativeTimelineWriter(path, pid=42)
    w.event("tensor/grad:0", "QUEUE", "B", 1.0, tid=7)
    w.event("tensor/grad:0", "QUEUE", "E", 2.5, tid=7,
            args_json='{"bytes": 128}')
    w.event('weird "name"\n', "", "i", 3.0)
    assert w.dropped == 0
    w.close(9.0)
    events = json.load(open(path))
    assert events[0] == {"name": "tensor/grad:0", "cat": "QUEUE", "ph": "B",
                         "ts": 1.0, "pid": 42, "tid": 7}
    assert events[1]["args"] == {"bytes": 128}
    assert events[2]["name"] == 'weird "name"\n'
    assert events[-1]["name"] == "timeline_end"


def test_failed_build_raises_with_the_compilers_message(tmp_path,
                                                         monkeypatch):
    bad = tmp_path / "core.cc"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    with pytest.raises(RuntimeError, match="native core build failed"):
        native.available()
    with pytest.raises(RuntimeError, match="error"):      # cached, again
        native.plan_fusion_bins([1], 1)
    assert native.status()["available"] is False
    assert "error" in native.status()["build_error"]
    monkeypatch.setenv("HOROVOD_TPU_NATIVE", "0")         # the Python way
    assert plan_fusion_bins([1, 1], 1) == [[0], [1]]


@pytest.mark.parametrize("native_on", [True, False])
def test_timeline_of_a_cycle_loads(tmp_path, monkeypatch, native_on):
    """Both writers: the file of a coordinator cycle loads with json.load
    and holds each tensor's QUEUE pair and DISPATCH span and the cycle
    mark (the native writer B/E pairs, the Python one complete events)."""
    import horovod_tpu_torch as htt
    from horovod_tpu_torch import timeline
    from horovod_tpu_torch.ops.coordinator import Coordinator
    monkeypatch.setenv("HOROVOD_TPU_NATIVE", "1" if native_on else "0")
    monkeypatch.setenv("HOROVOD_TIMELINE_MARK_CYCLES", "1")
    path = str(tmp_path / "tl.json")
    ctx = htt.init(device="cpu")
    try:
        coord = Coordinator(ctx, start_thread=False)
        ctx.coordinator = coord
        htt.start_timeline(path)
        assert (timeline.get_timeline()._native is not None) == native_on
        hs = [htt.allreduce_async(torch.full((3,), float(i)), op=htt.Sum,
                                  name=f"t{i}") for i in range(3)]
        hs.append(htt.alltoall_async(torch.arange(4.0), name="solo"))
        coord.run_cycle()
        for h in hs:
            h.wait()
    finally:
        htt.stop_timeline()
        htt.shutdown()
    events = json.load(open(path))
    names = [e["name"] for e in events]
    assert names[0] == "timeline_start" and names[-1] == "timeline_end"
    for n in ("t0", "t1", "t2", "solo"):
        queue = [e["ph"] for e in events
                 if e["name"] == n and e.get("cat") == "QUEUE"]
        assert queue == ["B", "E"], (n, queue)
    dispatch = {e["name"]: e["ph"] for e in events
                if e.get("cat") == "DISPATCH"}
    want = ("E" if native_on else "X")
    assert dispatch.get("fused[3]") == want and dispatch.get("solo") == want
    assert "CYCLE" in names and any(
        e.get("cat") == "MEMCPY_IN_FUSION_BUFFER" for e in events)


def test_timeline_from_env_starts_at_init_and_ends_at_shutdown(tmp_path,
                                                                monkeypatch):
    import horovod_tpu_torch as htt
    from horovod_tpu_torch import timeline
    path = str(tmp_path / "env.json")
    monkeypatch.setenv("HOROVOD_TIMELINE", path)
    htt.init(device="cpu")
    try:
        assert timeline.get_timeline().active
        htt.synchronize(htt.allreduce_async(torch.ones(2), name="envt"))
    finally:
        htt.shutdown()
    assert not timeline.get_timeline().active
    assert "envt" in {e["name"] for e in json.load(open(path))}
    monkeypatch.setenv("HOROVOD_TIMELINE", "DYNAMIC")
    htt.init(device="cpu")
    try:
        assert not timeline.get_timeline().active
    finally:
        htt.shutdown()
