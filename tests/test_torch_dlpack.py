"""The port's DLPack frontend bridge (``horovod_tpu_torch.eager.
_frontend_bridge``) against the JAX package's results, on the CPU.

``tests/test_dlpack.py`` replayed with the port's foreign inputs: numpy
arrays and jax arrays (anything not a ``torch.Tensor`` that is a numpy
array or has ``__dlpack__``). In ONE two-rank gloo world
(``test_torch_workers.run_phases``, scenario kind ``dlpack``) every rank
passes its row of numpy inputs: the dtype sweep (f32, bf16, f16, int32,
int64, uint8), the async handle, grouped ops (the grouped async form
keeping each input's dtype), allgather, broadcast, alltoall, reducescatter
and alltoallv's ``(rows, splits)`` all come back as numpy arrays of the
input's dtype (within its family: the received splits stay integers), with
the values the JAX package gives for the rank-stacked arrays (bitwise but
for the f16 and bf16 sums, held within 1e-2 as the JAX test does). In a
world of one, jax arrays come back as jax arrays (bf16 and int32
included, through the async handle, ``poll``/``result`` and a
keyword-first call); a refused zero-copy import falls back to a host copy,
bf16 by its bits; a device array with no host conversion raises a
``TypeError`` naming its device. The JAX test's list of per-rank rows has
no counterpart (each rank passes its own tensor), and its TensorFlow
cases need a frontend this image lacks.
"""

import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

import horovod_tpu as hvd
import horovod_tpu_torch as htt
import test_torch_workers as workers

LIMIT_S = 120
W = 2
BF16 = np.dtype(ml_dtypes.bfloat16)


@pytest.fixture(scope="module", autouse=True)
def _module_time_limit():
    def expired(signum, frame):
        raise TimeoutError(f"{__name__} ran past its {LIMIT_S} s limit")

    prev = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


def _stacked(dtype, shape=(4,), seed=0):
    rng = np.random.RandomState(seed)
    if np.issubdtype(np.dtype(dtype), np.integer):
        return rng.randint(0, 7, (W,) + shape).astype(dtype)
    return rng.rand(*((W,) + shape)).astype(dtype)


SWEEP = {"f32": np.float32, "bf16": BF16, "f16": np.float16,
         "i32": np.int32, "i64": np.int64, "u8": np.uint8}
SPLITS = np.asarray([[1, 2], [2, 1]])


def _calls():
    calls = [{"name": f"sweep_{k}", "fn": "allreduce", "arg": _stacked(d),
              "kw": {"op": "SUM"}} for k, d in SWEEP.items()]
    x = _stacked(np.float32)
    calls += [
        {"name": "async", "fn": "allreduce_async", "arg": x,
         "kw": {"op": "SUM"}, "wait": True},
        {"name": "grouped", "fn": "grouped_allreduce", "args": [x, x * 2],
         "kw": {"op": "SUM"}},
        {"name": "grouped_async", "fn": "grouped_allreduce_async",
         "args": [x, _stacked(np.int64, seed=1)], "kw": {"op": "SUM"},
         "wait": True},
        {"name": "allgather", "fn": "allgather", "arg": x},
        {"name": "broadcast", "fn": "broadcast", "arg": x,
         "kw": {"root_rank": 1}},
        {"name": "alltoall", "fn": "alltoall",
         "arg": _stacked(np.float32, (W,))},
        {"name": "reducescatter", "fn": "reducescatter",
         "arg": np.ones((W, W, 3), np.float32), "kw": {"op": "SUM"}},
        {"name": "alltoallv", "fn": "alltoall",
         "arg": np.ones((W, 3, 2), np.float32),
         "rank_kw": {"splits": SPLITS}}]
    return calls


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("dlpack")
    phases = [{"threads": 1, "scenarios": [
        {"kind": "dlpack", "name": "calls", "calls": _calls()}]}]
    load = workers.run_phases(W, phases, out)
    return [dict(load("calls", r)) for r in range(W)]


def _jax(call):
    """The JAX package's result of the call on the rank-stacked arrays."""
    hvd.init(devices=jax.devices()[:W])
    try:
        kw = dict(call.get("kw", {}))
        if "op" in kw:
            kw["op"] = hvd.ReduceOp[kw["op"]]
        if "rank_kw" in call:
            kw.update(call["rank_kw"])
        x = ([jnp.asarray(a) for a in call["args"]] if "args" in call
             else jnp.asarray(call["arg"]))
        res = getattr(hvd, call["fn"])(x, **kw)
        if call.get("wait"):
            res = hvd.synchronize(res)
        return jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64)
            if a.dtype.name in ("bfloat16", "float16", "float32")
            else np.asarray(a), res)
    finally:
        hvd.shutdown()


def _leaf(port, name, r, want_dtype):
    p = port[r]
    assert str(p[f"{name}|type"]) == "numpy", name
    assert str(p[f"{name}|dtype"]) == np.dtype(want_dtype).name, name
    return p[name]


@pytest.mark.parametrize("key", sorted(SWEEP))
def test_allreduce_dtype_sweep_returns_numpy(world, key):
    call = next(c for c in _calls() if c["name"] == f"sweep_{key}")
    want = _jax(call)
    tol = 1e-2 if key in ("bf16", "f16") else 0.0
    for r in range(W):
        got = _leaf(world, f"sweep_{key}", r, SWEEP[key])
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        if not tol:
            np.testing.assert_array_equal(got, want)


def test_async_handle_and_grouped_forms_return_numpy(world):
    calls = {c["name"]: c for c in _calls()}
    want = _jax(calls["async"])
    for r in range(W):
        np.testing.assert_allclose(_leaf(world, "async", r, np.float32),
                                   want, rtol=1e-6)
    g = _jax(calls["grouped"])
    ga = _jax(calls["grouped_async"])
    for r in range(W):
        np.testing.assert_allclose(_leaf(world, "grouped|1", r, np.float32),
                                   g[1], rtol=1e-6)
        np.testing.assert_allclose(world[r]["grouped|1"],
                                   2 * world[r]["grouped|0"], rtol=1e-6)
        np.testing.assert_allclose(
            _leaf(world, "grouped_async|0", r, np.float32), ga[0], rtol=1e-6)
        # the int64 input comes back int64 (the JAX side reduces in x32)
        np.testing.assert_array_equal(
            _leaf(world, "grouped_async|1", r, np.int64), ga[1])


def test_shape_changing_ops_return_numpy(world):
    calls = {c["name"]: c for c in _calls()}
    for name, cmp in (("allgather", "same"), ("broadcast", "same"),
                      ("alltoall", "rank"), ("reducescatter", "rank")):
        want = _jax(calls[name])
        for r in range(W):
            got = _leaf(world, name, r, np.float32)
            np.testing.assert_array_equal(
                got, want[r] if cmp == "rank" else want)


def test_alltoallv_tuple_converts_rows_and_keeps_int_splits(world):
    rows, recv = _jax(_calls()[-1])
    for r in range(W):
        np.testing.assert_array_equal(
            _leaf(world, "alltoallv|0", r, np.float32), np.asarray(rows[r]))
        assert str(world[r]["alltoallv|1|type"]) == "numpy"
        assert not np.issubdtype(world[r]["alltoallv|1"].dtype, np.floating)
        np.testing.assert_array_equal(world[r]["alltoallv|1"],
                                      np.asarray(recv)[r])


# ---------------------------------------------------------------------------
# a world of one: jax arrays, numpy edge cases, the import fallbacks
# ---------------------------------------------------------------------------

@pytest.fixture()
def port_world():
    htt.init(device="cpu")
    yield
    htt.shutdown()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.int32])
def test_jax_inputs_return_jax_arrays(port_world, dtype):
    x = jnp.arange(6).astype(dtype).reshape(2, 3)
    out = htt.allreduce(x, op=htt.Sum)
    assert isinstance(out, jax.Array) and out.dtype == dtype
    np.testing.assert_array_equal(np.asarray(out, np.float64),
                                  np.asarray(x, np.float64))
    h = htt.allreduce_async(x, op=htt.Sum)
    assert isinstance(htt.synchronize(h), jax.Array)


def test_poll_result_matches_synchronize_type(port_world):
    x = jnp.ones((3,), jnp.float32)
    h = htt.allreduce_async(x, op=htt.Sum)
    while not htt.poll(h):
        pass
    assert isinstance(h.result(), jax.Array)
    assert isinstance(htt.synchronize(h), jax.Array)


def test_keyword_first_argument_and_torch_passthrough(port_world):
    xs = [np.ones(2, np.float32), np.full(3, 2.0, np.float32)]
    outs = htt.grouped_allreduce(tensors=xs, op=htt.Sum)
    assert all(isinstance(o, np.ndarray) for o in outs)
    out = htt.allreduce(tensor=jnp.ones(2), op=htt.Sum)
    assert isinstance(out, jax.Array)
    t = htt.allreduce(torch.ones(2), op=htt.Sum)
    assert isinstance(t, torch.Tensor)


def test_result_is_writable_and_bf16_numpy_roundtrips(port_world):
    out = htt.allreduce(np.ones((2, 2), np.float32), op=htt.Sum)
    out += 1
    b = htt.allreduce(np.ones(3, BF16), op=htt.Sum)
    assert b.dtype == BF16 and np.array_equal(b.astype(np.float32),
                                              np.ones(3, np.float32))


def test_unconvertible_foreign_tensor_raises_clear_error():
    from horovod_tpu_torch.eager import _dlpack_import

    class DeviceTensor:
        """Quacks like a device-resident foreign-framework tensor."""
        device = "cuda:0"
        dtype = np.float32

        def __dlpack__(self, *a, **k):
            raise RuntimeError("cross-device dlpack unsupported")

        def __dlpack_device__(self):
            return (2, 0)

        def __array__(self, *a, **k):
            raise TypeError("can't convert cuda:0 device type tensor")

    with pytest.raises(TypeError) as ei:
        _dlpack_import(DeviceTensor())
    msg = str(ei.value)
    assert "cuda:0" in msg and "CPU" in msg


def test_refused_zero_copy_import_takes_a_host_copy(monkeypatch):
    from horovod_tpu_torch import eager

    def refuse(*a, **k):
        raise RuntimeError("forced dlpack failure")

    monkeypatch.setattr(torch, "from_dlpack", refuse)
    x = jnp.arange(6, dtype=jnp.float32).reshape(2, 3)
    out = eager._dlpack_import(x)
    assert isinstance(out, torch.Tensor)
    np.testing.assert_array_equal(out.numpy(), np.asarray(x))
    outb = eager._dlpack_import(jnp.ones(4, jnp.bfloat16))
    assert outb.dtype == torch.bfloat16 and torch.equal(
        outb.float(), torch.ones(4))
