"""The port's numerics monitor (``horovod_tpu_torch/goodput/numerics.py``)
against the JAX package's ``horovod_tpu/goodput/numerics.py`` on the same
seeded inputs: the detectors' golden streams, the per-tensor aggregates
on buffers with injected NaN and inf, localization to parameter names,
the monitor's cadence and actions, the eager coordinator's bins (a fixed
number of launches per bin, whatever its tensor count) and the loss feed
of ``train_loop``, where ``abort`` raises."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import horovod_tpu as hvd
from horovod_tpu.config import knobs as jknobs
from horovod_tpu.goodput import numerics as jnum
from horovod_tpu.models import transformer as jtfm
from horovod_tpu.parallel import trainer as jtrainer
from horovod_tpu.resilience import faults as jfaults
import horovod_tpu_torch as htt
from horovod_tpu_torch import metrics as M
from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.goodput import numerics
from horovod_tpu_torch.ops import coordinator as coord_mod
from horovod_tpu_torch.resilience import faults
from horovod_tpu_torch.tracing import spans

NUMERICS_KNOBS = ("HOROVOD_NUMERICS", "HOROVOD_NUMERICS_CHECK_EVERY",
                  "HOROVOD_NUMERICS_ACTION")


@pytest.fixture(autouse=True)
def _clean():
    yield
    for k in NUMERICS_KNOBS + ("HOROVOD_TRACE_DIR",):
        knobs.clear_override(k)
        jknobs.clear_override(k)
    numerics.reset_for_tests()
    jnum.reset_for_tests()
    faults.reset_for_tests()
    jfaults.reset_for_tests()
    spans.reset()


def _both(name, *args, **kw):
    return getattr(numerics, name)(*args, **kw), getattr(jnum, name)(
        *args, **kw)


def _fired(det, values):
    out = []
    for i, v in enumerate(values):
        a = det.observe(v)
        if a:
            out.append((i, json.dumps(a, sort_keys=True)))
    return out


# ---------------------------------------------------------------------------
# the detectors' golden streams (tests/test_goodput.py)
# ---------------------------------------------------------------------------

def test_loss_spike_golden_stream_matches_jax():
    rng = np.random.RandomState(0)
    stream = list(2.0 + 0.01 * rng.randn(30)) + [8.0, 2.0]
    port, jax_ = _both("LossSpikeDetector", sigma=6.0, warmup=10,
                       alpha=0.1)
    got, want = _fired(port, stream), _fired(jax_, stream)
    assert got == want
    assert [i for i, _ in got] == [30]           # the spike, once
    assert json.loads(got[0][1])["kind"] == "loss_spike"


def test_loss_nonfinite_fires_immediately_like_jax():
    for v in (float("nan"), float("inf")):
        port, jax_ = _both("LossSpikeDetector")
        assert _fired(port, [v]) == _fired(jax_, [v])
        assert json.loads(_fired(numerics.LossSpikeDetector(), [v])[0][1])[
            "signal"] == "loss"


def test_grad_norm_explosion_golden_stream_matches_jax():
    stream = [1.0] * 10 + [50.0, 1.0, float("nan")]
    port, jax_ = _both("GradNormDetector", factor=10.0, warmup=5, alpha=0.2)
    got = _fired(port, stream)
    assert got == _fired(jax_, stream)
    assert [(i, json.loads(a)["kind"]) for i, a in got] == [
        (10, "grad_norm_explosion"), (12, "nonfinite")]


def test_descending_loss_never_fires():
    stream = [float(v) for v in np.linspace(5.0, 0.5, 50)]
    port, jax_ = _both("LossSpikeDetector", sigma=6.0, warmup=5)
    assert _fired(port, stream) == _fired(jax_, stream) == []


def test_nonfinite_detector_matches_jax():
    layout = {0: ["a"], 1: ["b", "c"]}
    for counts, labels in (([0, 0], None), ([0, 3], None),
                           ([2, 1, 0], ["x", "y", "z"])):
        port, jax_ = _both("NonfiniteDetector", layout)
        assert port.observe(counts, labels) == jax_.observe(counts, labels)


# ---------------------------------------------------------------------------
# the aggregates
# ---------------------------------------------------------------------------

def _poisoned(seed):
    rng = np.random.default_rng(seed)
    vals = [rng.standard_normal(s).astype(np.float32)
            for s in ((7,), (3, 5), (1,), (64, 9), (2, 2, 2))]
    vals[1][0, 2] = np.nan
    vals[1][2, 4] = np.inf
    vals[3][5, 1] = -np.inf
    vals[3][:2, :] = np.nan
    return vals


@pytest.mark.parametrize("seed", [0, 1])
def test_bin_aggregates_match_jax(seed):
    vals = _poisoned(seed)
    jnf, jsq = jnum.bin_aggregates([jnp.asarray(v) for v in vals])
    flat = torch.cat([torch.from_numpy(v).reshape(-1) for v in vals])
    nf, sq = numerics.bin_aggregates(flat, [v.size for v in vals])
    assert nf.dtype == torch.int32 and sq.dtype == torch.float32
    np.testing.assert_array_equal(nf.numpy(), np.asarray(jnf))
    np.testing.assert_allclose(sq.numpy(), np.asarray(jsq), rtol=1e-6,
                               equal_nan=True)
    # bf16 buffers widen to f32 first, as JAX's astype does
    flat16 = flat.to(torch.bfloat16)
    nf16, sq16 = numerics.bin_aggregates(flat16, [v.size for v in vals])
    jnf16, jsq16 = jnum.bin_aggregates(
        [jnp.asarray(v).astype(jnp.bfloat16) for v in vals])
    np.testing.assert_array_equal(nf16.numpy(), np.asarray(jnf16))
    np.testing.assert_allclose(sq16.numpy(), np.asarray(jsq16), rtol=1e-6,
                               equal_nan=True)


def test_update_ratio_matches_jax():
    ws = {"w": np.ones(4, np.float32), "b": np.full(3, 2.0, np.float32)}
    us = {"w": np.full(4, 0.01, np.float32), "b": np.full(3, 0.5, np.float32)}
    want = float(jax.jit(jnum.update_ratio)(ws, us))
    got = float(numerics.update_ratio(
        [torch.from_numpy(ws[k]) for k in sorted(ws)],
        [torch.from_numpy(us[k]) for k in sorted(us)]))
    assert got == pytest.approx(want, rel=1e-6)


def _op_count(fn):
    """The aten ops ``fn`` runs (each a kernel launch on the card)."""
    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


@pytest.mark.parametrize("block", [0, 1, 5, 4096])
def test_bin_aggregates_are_the_same_at_every_block(block):
    vals = _poisoned(3)
    flat = torch.cat([torch.from_numpy(v).reshape(-1) for v in vals])
    numels = [v.size for v in vals]
    nf, sq = numerics.bin_aggregates(flat, numels, block=block)
    ref_nf, ref_sq = numerics.bin_aggregates(flat, numels, block=0)
    assert torch.equal(nf, ref_nf)
    np.testing.assert_allclose(sq.numpy(), ref_sq.numpy(), rtol=1e-6,
                               equal_nan=True)
    ids, top, slots = numerics.segment_layout(numels, "cpu", block)
    assert ids.shape == (flat.numel(),) and ids.dtype == torch.int32
    if block:
        # blocks never straddle two tensors
        assert slots == sum(-(-m // block) for m in numels)
        assert torch.equal(top[ids.long()], numerics.segment_layout(
            numels, "cpu", 0)[0])


@pytest.mark.parametrize("block", [0, 4096])
def test_bin_aggregates_launch_count_does_not_grow_with_tensors(block):
    counts = []
    for n in (1, 4, 64):
        numels = [3 + 1000 * i for i in range(n)]
        flat = torch.randn(sum(numels))
        numerics.segment_layout(numels, "cpu", block)   # the layout's build
        counts.append(_op_count(lambda: numerics.bin_aggregates(
            flat, numels, block=block)))
    assert counts[0] == counts[1] == counts[2], counts
    bf = torch.randn(40).to(torch.bfloat16)
    numerics.segment_layout([10, 30], "cpu", block)
    assert _op_count(lambda: numerics.bin_aggregates(
        bf, [10, 30], block=block)) == counts[0] + 1     # the widening


# ---------------------------------------------------------------------------
# localization
# ---------------------------------------------------------------------------

def _grads():
    # three 1 KiB f32 leaves + one 2 KiB: bucket_bytes=2048 in REVERSE
    # order plans [d], [c, b], [a] -> buckets 0..2
    return {"a": np.zeros((256,), np.float32),
            "b": np.zeros((256,), np.float32),
            "c": np.zeros((256,), np.float32),
            "d": np.zeros((512,), np.float32)}


def test_bucket_param_map_matches_jax():
    for bb in (2048, 4096, 0, 1 << 30):
        got, want = _both("bucket_param_map", _grads(), bucket_bytes=bb)
        assert got == want, bb
    assert numerics.bucket_param_map(_grads(), bucket_bytes=2048) == {
        0: ["['d']"], 1: ["['c']", "['b']"], 2: ["['a']"]}


def test_localize_nonfinite_matches_jax_on_numpy_and_torch_trees():
    g = _grads()
    g["b"][7] = np.nan
    g["d"][:3] = np.inf
    want = jnum.localize_nonfinite(g, bucket_bytes=2048)
    assert numerics.localize_nonfinite(g, bucket_bytes=2048) == want
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    assert numerics.localize_nonfinite(tg, bucket_bytes=2048) == want
    assert [(b["bucket"], b["nonfinite"]) for b in want] == [(0, 3), (1, 1)]
    assert numerics.localize_nonfinite(_grads(), bucket_bytes=2048) == []


def test_localization_names_the_flagship_leaves_like_jax():
    """The flagship's parameter tree as params_from_numpy carries it: the
    same keys, so the same names, buckets and counts."""
    cfg = jtfm.TransformerConfig(vocab_size=64, d_model=16, n_heads=2,
                                 head_dim=8, n_layers=2, d_ff=32,
                                 max_seq=32, dtype=jnp.float32,
                                 dp_axis=None)
    np_params = jax.tree.map(np.array, jtfm.init_params(
        cfg, jax.random.PRNGKey(0)))
    np_params["layers"]["w_in"][1, 3, 5] = np.nan
    np_params["embed"][2, :4] = np.inf
    params = htt.params_from_numpy(np_params, device="cpu")
    for bb in (4096, 1 << 25):
        want = jnum.localize_nonfinite(np_params, bucket_bytes=bb)
        assert numerics.localize_nonfinite(params, bucket_bytes=bb) == want
        assert numerics.bucket_param_map(params, bucket_bytes=bb) == \
            jnum.bucket_param_map(np_params, bucket_bytes=bb)
    assert {p for b in want for p in b["params"]} == {
        "['embed']", "['layers']['w_in']"}


def test_localization_names_resnet_parameters_under_the_name_map():
    """A module's parameters go by their ``named_parameters`` names in
    ``parameters()`` order (the DistributedOptimizer's plan order); under
    the weight converter's name map (``a.b`` is the flax path ('a', 'b'))
    the offending parameters are JAX's."""
    from horovod_tpu.models import resnet as jresnet
    from horovod_tpu_torch.models import resnet
    kw = dict(stage_sizes=[1, 1], num_classes=10, num_filters=8)
    jm = jresnet.ResNet(block_cls=jresnet.BottleneckBlock,
                        dtype=jnp.float32, **kw)
    v = jax.tree.map(np.array, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=True))
    v = {k: dict(vv) for k, vv in v.items()}
    flat = jax.tree_util.tree_flatten_with_path(v["params"])[0]
    bad = [flat[1][1], flat[-2][1]]
    bad[0].reshape(-1)[0] = np.nan
    bad[1].reshape(-1)[-1] = -np.inf
    model = resnet.variables_from_numpy(
        htt.ResNet(block_cls=resnet.BottleneckBlock, dtype=torch.float32,
                   device="cpu", **kw), v)

    def as_keystr(name):
        return "".join(f"[{k!r}]" for k in name.split("."))

    for bb in (1 << 25, 4096):
        want = {p for b in jnum.localize_nonfinite(v["params"],
                                                   bucket_bytes=bb)
                for p in b["params"]}
        got = numerics.localize_nonfinite(model, bucket_bytes=bb)
        assert {as_keystr(p) for b in got for p in b["params"]} == want
        assert sum(b["nonfinite"] for b in got) == 2
    one = numerics.localize_nonfinite(model, bucket_bytes=1 << 25)
    assert [b["bucket"] for b in one] == [0]
    # one bucket, in the sync's reverse (backward) order
    names = [n for n, _ in model.named_parameters()]
    assert numerics.bucket_param_map(model, bucket_bytes=1 << 25) == {
        0: names[::-1]}


# ---------------------------------------------------------------------------
# the monitor
# ---------------------------------------------------------------------------

def _tracing(tmp_path):
    knobs.set_override("HOROVOD_TRACE_DIR", str(tmp_path))
    spans.enable(buffer_spans=256)


def test_anomaly_fires_flight_recording(tmp_path):
    _tracing(tmp_path)
    before = M.get_registry().snapshot().get(
        "hvd_numerics_anomalies_total", {}).get("series", [])
    mon = numerics.NumericsMonitor(check_every=1, action="warn")
    mon.observe_step(3, loss=torch.tensor(float("nan")))
    assert mon.summary()["anomalies"] == 1
    assert mon.summary()["by_kind"] == {"nonfinite": 1}
    flights = list(tmp_path.glob("flight-numerics-nonfinite-*.json"))
    assert flights, list(tmp_path.iterdir())
    payload = json.loads(flights[0].read_text())
    assert payload["metadata"]["reason"].startswith("numerics-")
    assert "numerics.anomaly" in [e.get("name")
                                  for e in payload["traceEvents"]]
    after = M.get_registry().snapshot()["hvd_numerics_anomalies_total"]
    assert sum(s["value"] for s in after["series"]) == \
        sum(s["value"] for s in before) + 1


def test_nonfinite_localized_via_bucket_layout_like_jax():
    layout = numerics.bucket_param_map(
        {"a": np.zeros((256,), np.float32),
         "b": np.zeros((256,), np.float32)}, bucket_bytes=1024)
    got = []
    for mod, counts in ((numerics, torch.tensor([0, 3])),
                        (jnum, np.array([0, 3]))):
        mon = mod.NumericsMonitor(bucket_params=layout, check_every=1,
                                  action="warn")
        mon.observe_step(5, nonfinite_counts=counts)
        got.append(mon.summary())
    assert got[0] == got[1]
    assert got[0]["last"]["buckets"][0]["params"] == ["['a']"]


def test_degrade_action_flips_healthz_and_heals():
    mon = numerics.NumericsMonitor(check_every=1, action="degrade")
    mon.observe_step(1, loss=torch.tensor(float("inf")))
    h = M.health_snapshot()
    assert h["status"] == "degraded"
    assert "numerics" in h["fault_domain"]["shed"]
    mon.observe_step(2, loss=1.0)          # a clean drain heals the site
    assert M.health_snapshot()["fault_domain"]["shed"] == []


def test_abort_action_raises():
    mon = numerics.NumericsMonitor(check_every=1, action="abort")
    with pytest.raises(numerics.NumericsAnomalyError) as e:
        mon.observe_step(1, loss=float("nan"))
    assert e.value.anomaly["kind"] == "nonfinite"


def test_cadence_buffers_device_tensors_until_due():
    mon = numerics.NumericsMonitor(check_every=3, action="warn")
    mon.observe_step(1, loss=torch.tensor(float("nan")))
    mon.observe_step(2, loss=torch.tensor(1.0))
    assert mon.summary()["anomalies"] == 0 and mon.drains == 0
    mon.observe_step(3, loss=torch.tensor(1.0))        # due: drains
    assert mon.drains == 1 and mon.summary()["anomalies"] == 1
    mon.observe_step(4, loss=torch.tensor(float("inf")))
    assert [a["kind"] for a in mon.drain()] == ["nonfinite"]


class _Copy:
    """A row's CUDA event stand-in: landed or not, and waited on."""

    def __init__(self, landed):
        self.landed, self.waited = landed, 0

    def query(self):
        return self.landed

    def synchronize(self):
        self.waited += 1
        self.landed = True


def test_the_cadence_drain_never_waits_on_a_copy_in_flight():
    """The drain that falls due on the observing thread reads the leading
    rows whose host copies have landed and leaves the rest, in order, for
    the next drain; only an explicit drain waits."""
    mon = numerics.NumericsMonitor(check_every=2, action="warn")
    first, second = _Copy(True), _Copy(False)
    mon._pending = [(1, {"loss": torch.tensor(float("nan"))}, first),
                    (2, {"loss": torch.tensor(float("inf"))}, second)]
    mon._observed = 2
    mon.observe_step(3, loss=torch.tensor(float("nan")))
    mon.observe_step(4, loss=torch.tensor(1.0))          # due
    assert [a["step"] for a in mon.anomalies] == [1]
    assert second.waited == 0 and len(mon._pending) == 3
    second.landed = True
    mon.observe_step(5, loss=torch.tensor(1.0))
    mon.observe_step(6, loss=torch.tensor(1.0))          # due again
    assert [a["step"] for a in mon.anomalies] == [1, 2, 3]
    assert mon._pending == []
    late = _Copy(False)
    mon._pending = [(7, {"loss": torch.tensor(float("nan"))}, late)]
    assert [a["step"] for a in mon.drain()] == [7] and late.waited == 1


def test_step_rows_drive_the_grad_norm_detector_and_bins_do_not():
    mon = numerics.NumericsMonitor(check_every=1, action="warn")
    for _ in range(12):
        mon.observe_step(0, grad_sq_norms=torch.tensor([1.0, 0.0]))
    mon.observe_bin(["x"], torch.tensor([0]), torch.tensor([1e6]))
    assert mon.summary()["anomalies"] == 0
    mon.observe_step(13, grad_sq_norms=torch.tensor([1e6]))
    assert mon.summary()["by_kind"] == {"grad_norm_explosion": 1}


def test_get_monitor_follows_the_knob():
    assert numerics.get_monitor() is None
    knobs.set_override("HOROVOD_NUMERICS", True)
    mon = numerics.get_monitor()
    assert mon is not None and numerics.get_monitor() is mon
    assert numerics.monitor_summary() == {"anomalies": 0, "by_kind": {},
                                          "last": None}


# ---------------------------------------------------------------------------
# the eager coordinator's bins
# ---------------------------------------------------------------------------

@pytest.fixture()
def port_ctx():
    ctx = htt.init(device="cpu")
    yield ctx
    htt.shutdown()


def _manual(ctx):
    coord = coord_mod.Coordinator(ctx, start_thread=False)
    ctx.coordinator = coord
    return coord


def test_coordinator_bins_feed_the_monitor_like_jax(port_ctx):
    """JAX's eager test (tests/test_goodput.py): one poisoned bin gives
    exactly one anomaly, a nonfinite one naming the tensor; the port's
    world of one gives the same anomaly as JAX's eight-device mesh for the
    same reduced values."""
    for kn in (knobs, jknobs):
        kn.set_override("HOROVOD_NUMERICS", True)
        kn.set_override("HOROVOD_NUMERICS_CHECK_EVERY", 1)
    x = np.ones((16,), np.float32)
    x[5] = np.nan
    h1 = htt.allreduce_async(torch.from_numpy(x), name="num_bad",
                             op=htt.Sum)
    h2 = htt.allreduce_async(torch.ones(4), name="num_good", op=htt.Sum)
    htt.synchronize(h1)
    htt.synchronize(h2)
    mon = numerics.get_monitor()
    mon.drain()
    hvd.init()
    try:
        stacked = np.ones((hvd.size(), 16), np.float32)
        stacked[2, 5] = np.nan
        j1 = hvd.allreduce_async(stacked, name="num_bad", op=hvd.Sum)
        j2 = hvd.allreduce_async(np.ones((hvd.size(), 4), np.float32),
                                 name="num_good", op=hvd.Sum)
        hvd.synchronize(j1)
        hvd.synchronize(j2)
        jmon = jnum.get_monitor()
        jmon.drain()
    finally:
        hvd.shutdown()
    assert [a["kind"] for a in mon.anomalies] == ["nonfinite"]
    assert mon.anomalies == jmon.anomalies
    assert mon.anomalies[0]["buckets"] == [
        {"bucket": 0, "nonfinite": 1, "label": "num_bad"}]


def _bin_rows(coord, tensors, monkeypatch):
    """Run one bin of ``tensors`` through the thread-less coordinator;
    returns the monitor's buffered row and the aten ops the numerics
    aggregation ran for the bin."""
    ops = []
    real = coord_mod._observe_numerics

    def counted(names, outs, flats):
        ops.append(_op_count(lambda: real(names, outs, flats)))

    monkeypatch.setattr(coord_mod, "_observe_numerics", counted)
    mon = numerics.get_monitor()
    handles = [htt.allreduce_async(t, name=f"t{i}", op=htt.Sum)
               for i, t in enumerate(tensors)]
    coord.run_cycle()
    outs = [htt.synchronize(h) for h in handles]
    monkeypatch.setattr(coord_mod, "_observe_numerics", real)
    coord.run_cycle() if coord.queue else None
    with mon._lock:
        rows = list(mon._pending)
    mon._pending.clear()
    return rows, ops, outs


def test_coordinator_bins_take_a_fixed_number_of_launches(port_ctx,
                                                          monkeypatch):
    knobs.set_override("HOROVOD_NUMERICS", True)
    knobs.set_override("HOROVOD_NUMERICS_CHECK_EVERY", 1000)
    coord = _manual(port_ctx)
    rng = np.random.default_rng(4)
    seen = {}
    for n in (2, 7, 24):
        vals = [rng.standard_normal(3 + 5 * i).astype(np.float32)
                for i in range(n)]
        vals[n // 2][1] = np.nan
        vals[-1][0] = np.inf
        tensors = [torch.from_numpy(v) for v in vals]
        # a first bin of this layout builds its plan and segment ids
        _bin_rows(coord, [t.clone() for t in tensors], monkeypatch)
        rows, ops, outs = _bin_rows(coord, tensors, monkeypatch)
        assert len(rows) == 1 and len(ops) == 1
        step, row, event = rows[0]
        assert event is None                # host tensors: nothing to wait
        assert step == -1 and row["labels"] == [f"t{i}" for i in range(n)]
        assert isinstance(row["nonfinite"], torch.Tensor)
        np.testing.assert_array_equal(
            row["nonfinite"].numpy(),
            [int((~np.isfinite(v)).sum()) for v in vals])
        np.testing.assert_allclose(
            row["sq_norms"].numpy(),
            [float(np.sum(o.numpy().astype(np.float64) ** 2))
             for o in outs], rtol=1e-6)
        seen[n] = ops[0]
    assert len(set(seen.values())) == 1, seen
    coord.shutdown()


def test_subgroup_and_gather_bins_carry_no_aggregates(port_ctx):
    knobs.set_override("HOROVOD_NUMERICS", True)
    knobs.set_override("HOROVOD_NUMERICS_CHECK_EVERY", 1000)
    coord = _manual(port_ctx)
    h = htt.allgather_async(torch.ones(2, 3), name="g")
    coord.run_cycle()
    htt.synchronize(h)
    assert numerics.get_monitor()._pending == []
    coord.shutdown()


def test_knob_off_makes_no_monitor_and_no_rows(port_ctx):
    coord = _manual(port_ctx)
    h = htt.allreduce_async(torch.ones(3), name="off", op=htt.Sum)
    coord.run_cycle()
    htt.synchronize(h)
    assert numerics.get_monitor() is None
    coord.shutdown()


# ---------------------------------------------------------------------------
# train_loop's loss feed
# ---------------------------------------------------------------------------

def _loss_step(losses):
    it = iter(losses)

    def step(state, batch):
        return {"w": state["w"] + batch, "step": state["step"] + 1}, \
            next(it)
    return step


def _jax_loop(losses, action):
    jknobs.set_override("HOROVOD_NUMERICS", True)
    jknobs.set_override("HOROVOD_NUMERICS_CHECK_EVERY", 1)
    jknobs.set_override("HOROVOD_NUMERICS_ACTION", action)
    try:
        jtrainer.train_loop(_loss_step(losses), {"w": 0.0, "step": 0},
                            [1.0] * len(losses))
        return None, jnum.get_monitor().summary()
    except jnum.NumericsAnomalyError as e:
        return json.dumps(e.anomaly), jnum.get_monitor().summary()


def test_train_loop_observes_the_loss_like_jax():
    losses = [2.0, 2.1, float("nan"), 2.0]
    knobs.set_override("HOROVOD_NUMERICS", True)
    knobs.set_override("HOROVOD_NUMERICS_CHECK_EVERY", 1)
    state, info = htt.train_loop(
        _loss_step([torch.tensor(v) for v in losses]),
        {"w": 0.0, "step": 0}, [1.0] * 4)
    assert info["final_step"] == 4
    got = numerics.get_monitor().summary()
    _, want = _jax_loop(losses, "warn")
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert got["by_kind"] == {"nonfinite": 1}
    assert got["last"]["step"] == 3


def test_train_loop_drains_the_tail_at_its_end():
    knobs.set_override("HOROVOD_NUMERICS", True)
    knobs.set_override("HOROVOD_NUMERICS_CHECK_EVERY", 100)
    htt.train_loop(_loss_step([1.0, float("inf")]), {"w": 0.0, "step": 0},
                   [1.0, 1.0])
    assert numerics.get_monitor().summary()["anomalies"] == 1


def test_abort_raises_into_train_loop_like_jax():
    losses = [2.0, float("nan"), 2.0, 2.0]
    knobs.set_override("HOROVOD_NUMERICS", True)
    knobs.set_override("HOROVOD_NUMERICS_CHECK_EVERY", 1)
    knobs.set_override("HOROVOD_NUMERICS_ACTION", "abort")
    seen = []
    with pytest.raises(numerics.NumericsAnomalyError) as e:
        htt.train_loop(_loss_step(losses), {"w": 0.0, "step": 0},
                       [1.0] * 4, on_step=lambda i, s, l: seen.append(i))
    assert seen == [1]                     # the step after the NaN never ran
    want, _ = _jax_loop(losses, "abort")
    assert json.dumps(e.value.anomaly) == want
