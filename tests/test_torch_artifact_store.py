"""The port's compiled-artifact store (``horovod_tpu_torch.store``) against
the JAX package's, on the CPU.

The two packages meet where no XLA executable is involved: the key
digest, the program-keying knob fingerprint, the entry format (a JSON
entry either package publishes, the other reads), the LRU's eviction
order and the keys of ``stats()``, the ``/healthz`` block and the ledger
block. Then the cases of ``tests/test_artifact_store.py`` that have a
counterpart here, on JSON entries: round trip, disabled store, the
per-component misses, version skew, corrupt and truncated entries, chaos
``store_corrupt`` and ``fs_transient`` with its own budget, the shed
site, concurrent readers and the atomic publish under the ``schedhooks``
seam.

The kernel tier (``ops/_build.py``) runs with a stand-in ``nvcc`` (a
shell script that copies the source to the library path and logs each
run), as ``tests/test_torch_paged_decode.py`` does: a cold resolve
publishes, a warm one into an empty build directory runs no ``nvcc`` and
writes the same bytes, a corrupt entry rebuilds and republishes, and an
edited header misses. The consumers: the eager coordinator in a two-rank
gloo world (a warm coordinator builds no plan; results against the JAX
eager results of ``tests/test_torch_coordinator.py``), ``train_loop``
(the step manifest misses then hits, losses bitwise equal and against
the JAX trainer without its store), and the serving fleet (a replica
grown on a host of its own resolves paged decode from the store with
``builds == 0``; tokens against the JAX fleet of
``tests/test_torch_fleet.py``).
"""

import hashlib
import json
import os
import shutil
import signal
import struct
import threading
import time

import numpy as np
import pytest
import torch

import jax

from horovod_tpu import autotune as jautotune
from horovod_tpu.config import knobs as jknobs
from horovod_tpu.store import artifact_store as jst
import horovod_tpu_torch as htt
from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.resilience import chaos, faults
from horovod_tpu_torch.store import artifact_store as st
from horovod_tpu_torch.utils import schedhooks
import test_torch_workers as workers

LIMIT_S = 240

# An env fingerprint given explicitly, so both packages key alike.
ENV = {"format": 1, "horovod_tpu_torch": "0.3.0", "torch": "2.11.0",
       "cuda": "12.8", "platform": "gpu",
       "device_kind": "NVIDIA H100 80GB HBM3", "capability": "9.0",
       "n_devices": 4, "process_count": 4}


@pytest.fixture(scope="module", autouse=True)
def _module_time_limit():
    def expired(signum, frame):
        raise TimeoutError(f"{__name__} ran past its {LIMIT_S} s limit")

    prev = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


@pytest.fixture()
def store(tmp_path):
    knobs.set_override("HOROVOD_ARTIFACT_STORE", str(tmp_path / "store"))
    st.reset_for_tests()
    yield st.from_env()
    knobs.clear_override("HOROVOD_ARTIFACT_STORE")
    st.reset_for_tests()
    chaos.install(None)


def _rewrite_header(path, edit):
    raw = open(path, "rb").read()
    (hlen,) = struct.unpack(">I", raw[len(st.MAGIC):len(st.MAGIC) + 4])
    body = raw[len(st.MAGIC) + 4:]
    header = edit(json.loads(body[:hlen]))
    hdr = json.dumps(header, sort_keys=True).encode()
    open(path, "wb").write(
        st.MAGIC + struct.pack(">I", len(hdr)) + hdr + body[hlen:])


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,components", [
    ("kernel", {"kernel": "paged_decode", "source": "0123456789abcdef"}),
    ("step", {"step": "mod.train_step@abc", "mesh": {"world_size": 4},
              "knobs": {"HOROVOD_FUSION_THRESHOLD": "134217728"},
              "grad_signature": [[[[4, 8], "torch.float32"]], 4]}),
    ("eager_fused", {"sig": "('allreduce', 1.5, None, True)",
                     "mesh": {"world_size": 2, "n_devices": 2}}),
])
def test_store_key_digest_equals_jax(kind, components):
    port = st.StoreKey(kind, components, env=ENV)
    jax_key = jst.StoreKey(kind, components, env=ENV)
    assert port.canonical == jax_key.canonical
    assert port.digest == jax_key.digest and len(port.digest) == 32


@pytest.mark.parametrize("env", [{}, {
    "HOROVOD_GRADIENT_COMPRESSION": "bf16",
    "HOROVOD_FUSION_THRESHOLD": "8MB", "HOROVOD_NUMERICS": "1",
    "HOROVOD_TPU_MATMUL_PRECISION": "float32",
    "HOROVOD_GRADIENT_BUCKET_BYTES": "0"}])
def test_program_knob_fingerprint_equals_jax(monkeypatch, env):
    # the same environment for both: no override an earlier test left
    # in either registry (the JAX autotune tests leave some)
    monkeypatch.setattr(jknobs, "_overrides", {})
    monkeypatch.setattr(knobs, "_overrides", {})
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port, want = st.program_knob_fingerprint(), jst.program_knob_fingerprint()
    assert st.PROGRAM_KNOBS == jst.PROGRAM_KNOBS
    common = set(port) & set(want)
    assert set(env) <= common and len(common) >= 10
    assert {k: port[k] for k in common} == {k: want[k] for k in common}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_blob_crosses_between_packages(tmp_path, writer):
    """A JSON entry published by one package is read by the other's
    ``read_entry_headers`` and ``load_blob`` under the same key."""
    comps = {"sig": "s", "knobs": {"A": "1"}}
    obj = {"kernels": {"flash_fwd": "d" * 32}, "n": [1, 2.5]}
    pstore, jstore = (st.ArtifactStore(str(tmp_path)),
                      jst.ArtifactStore(str(tmp_path)))
    pkey, jkey = (st.StoreKey("step", comps, env=ENV),
                  jst.StoreKey("step", comps, env=ENV))
    if writer == "port":
        assert pstore.publish_blob(pkey, obj, extra_meta={"label": "x"})
        reader, rkey, headers = jstore, jkey, jst.read_entry_headers
    else:
        assert jstore.publish_blob(jkey, obj, extra_meta={"label": "x"})
        reader, rkey, headers = pstore, pkey, st.read_entry_headers
    (h,) = headers(str(tmp_path))
    assert h["payload_ok"] and h["kind"] == "step" and h["label"] == "x"
    assert h["file"] == pkey.digest + ".hvdx" and h["env"] == ENV
    assert reader.load_blob(rkey) == obj
    assert reader.stats()["hits"] == 1


def test_eviction_order_equals_jax(tmp_path):
    """The same entries with the same mtimes leave the same survivors
    under the same budget in both packages."""
    src = st.ArtifactStore(str(tmp_path / "src"))
    names, now = [], time.time()
    for i in range(5):
        key = st.StoreKey("blob", {"i": i}, env=ENV)
        src.publish_blob(key, {"x": "y" * (100 * (i + 1))})
        names.append(key.digest + ".hvdx")
    mtimes = [now - 500, now - 100, now - 900, now - 50, now - 300]
    sizes = [os.path.getsize(os.path.join(src.root, n)) for n in names]
    survivors = {}
    for pkg, cls in (("port", st.ArtifactStore), ("jax", jst.ArtifactStore)):
        d = tmp_path / pkg
        d.mkdir()
        for n, t in zip(names, mtimes):
            shutil.copy(os.path.join(src.root, n), d / n)
            os.utime(d / n, (t, t))
        s = cls(str(d), max_bytes=sum(sizes) - sizes[2] - sizes[0] + 1)
        s._evict_to_budget()
        survivors[pkg] = (sorted(os.listdir(d)), s.stats()["evictions"])
    assert survivors["port"] == survivors["jax"]
    # the two oldest mtimes went
    assert survivors["port"] == (sorted(names[i] for i in (1, 3, 4)), 2)


def test_stats_healthz_and_ledger_blocks_have_the_jax_keys(store, tmp_path):
    from horovod_tpu import metrics as JM
    from horovod_tpu.goodput import ledger as jledger
    from horovod_tpu_torch import metrics as M
    from horovod_tpu_torch.goodput import ledger
    key = store.key("blob", sig="keys")
    store.publish_blob(key, {"a": 1})
    store.load_blob(key)
    jknobs.set_override("HOROVOD_ARTIFACT_STORE", str(tmp_path / "jstore"))
    jst.reset_for_tests()
    try:
        jstore = jst.from_env()
        jkey = jstore.key("blob", sig="keys")
        jstore.publish_blob(jkey, {"a": 1})
        jstore.load_blob(jkey)
        want = (jstore.stats(), JM.health_snapshot()["artifact_store"],
                jledger.build_record()["artifact_store"])
    finally:
        jknobs.clear_override("HOROVOD_ARTIFACT_STORE")
        jst.reset_for_tests()
    got = (store.stats(), M.health_snapshot()["artifact_store"],
           ledger.build_record()["artifact_store"])
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
    for g, w in zip(got[1:], want[1:]):
        assert {k: v for k, v in g.items() if k != "size_bytes"} == \
            {k: v for k, v in w.items() if k != "size_bytes"}


# ---------------------------------------------------------------------------
# the JAX package's cases, on JSON entries
# ---------------------------------------------------------------------------

def test_blob_round_trip(store):
    key = store.key("bucket_auto_sweep", grad_signature="g", workload="w")
    obj = {"winner_bucket_bytes": 123, "candidates": {"1": {"s": 0.5}}}
    assert store.publish_blob(key, obj)
    assert store.load_blob(key) == obj
    s = store.stats()
    assert s["hits"] == 1 and s["publishes"] == 1 and s["entries"] == 1
    assert s["size_bytes"] == s["bytes_written"] > 0


def test_disabled_store_is_none():
    st.reset_for_tests()
    knobs.set_override("HOROVOD_ARTIFACT_STORE", "")
    try:
        assert st.from_env() is None and not st.enabled()
        assert st.store_stats() is None

        def f(x):
            return x
        fn, outcome = st.adopt_step(f, (torch.ones(4),))
        assert outcome == "disabled" and fn is f
    finally:
        knobs.clear_override("HOROVOD_ARTIFACT_STORE")
        st.reset_for_tests()


def test_flipped_knob_misses(store):
    key = store.key("step", knobs=st.program_knob_fingerprint())
    store.publish_blob(key, {"k": 1})
    knobs.set_override("HOROVOD_GRADIENT_COMPRESSION", "fp8_e4m3")
    try:
        flipped = store.key("step", knobs=st.program_knob_fingerprint())
        assert flipped.digest != key.digest
        assert store.load_blob(flipped) is None
    finally:
        knobs.clear_override("HOROVOD_GRADIENT_COMPRESSION")
    assert store.load_blob(key) == {"k": 1}


def test_changed_mesh_misses(store):
    mesh_a = {"world_size": 4, "n_devices": 4, "mesh_shape": [4]}
    mesh_b = {"world_size": 4, "n_devices": 4, "mesh_shape": [2, 2]}
    key = store.key("step", mesh=mesh_a)
    store.publish_blob(key, {"k": 1})
    changed = store.key("step", mesh=mesh_b)
    assert changed.digest != key.digest
    assert store.load_blob(changed) is None


def test_changed_grad_signature_misses(store):
    from horovod_tpu_torch.autotune import grad_signature
    sig_a = grad_signature([((16, 4), torch.float32)], 8)
    sig_b = grad_signature([((16, 8), torch.float32)], 8)
    key = store.key("step", grad_signature=sig_a)
    store.publish_blob(key, {"k": 1})
    assert store.load_blob(store.key("step", grad_signature=sig_b)) is None
    assert store.load_blob(key) == {"k": 1}


def test_version_skew_misses_and_logs(store):
    import logging
    lines = []
    handler = logging.Handler()
    handler.emit = lambda rec: lines.append(rec.getMessage())
    st.logger.addHandler(handler)
    try:
        _version_skew_misses(store)
    finally:
        st.logger.removeHandler(handler)
    assert any("version-skewed entry ignored" in m for m in lines)


def _version_skew_misses(store):
    key = store.key("step", sig="skew")
    store.publish_blob(key, {"k": 1})
    path = store._path(key)
    _rewrite_header(path, lambda h: dict(
        h, env=dict(h["env"], torch="0.0.1-foreign")))
    misses = store.stats()["misses"]
    assert store.load_blob(key) is None
    assert store.stats()["misses"] == misses + 1
    assert store.miss_reasons == {"version-skewed": 1}
    assert os.path.exists(path)     # kept: the LRU evicts it later


def test_corrupt_and_truncated_fall_back(store):
    key = store.key("step", sig="corrupt")
    store.publish_blob(key, {"k": "v" * 64})
    path = store._path(key)
    raw = open(path, "rb").read()
    for mutation in (raw[: len(raw) // 2],              # truncated payload
                     raw[: len(st.MAGIC) + 2],          # truncated header
                     b"GARBAGE" + raw[7:],              # bad magic
                     raw[: -8] + b"\x00" * 8,           # flipped payload
                     b""):                              # empty file
        open(path, "wb").write(mutation)
        assert store.load_blob(key) is None             # never raises
    open(path, "wb").write(raw)
    assert store.load_blob(key) == {"k": "v" * 64}
    assert store.stats()["misses"] == 5
    assert store.miss_reasons == {"corrupt": 5}


def test_chaos_store_corrupt_falls_back(store):
    key = store.key("step", sig="chaos")
    store.publish_blob(key, {"k": 1})
    chaos.install({"store_corrupt": {"fail_first": 1}})
    try:
        assert store.load_blob(key) is None             # injected bit rot
        assert store.load_blob(key) == {"k": 1}         # budget spent
    finally:
        chaos.install(None)
    assert store.miss_reasons == {"corrupt": 1}


def test_fs_transient_store_scope_and_separate_budget(store):
    """fs_transient with scope store fails the store's I/O (retry_fs takes
    the EIO) on a budget of its own; the default checkpoint scope never
    touches the store."""
    key = store.key("step", sig="fs-scope")
    store.publish_blob(key, {"k": 1})
    faults.reset_for_tests()
    chaos.install({"fs_transient": {"fail_first": 1, "scope": "store"}})
    try:
        spec = chaos.active()
        assert store.load_blob(key) == {"k": 1}         # EIO retried
        assert spec._store_fs_failed == 1 and spec._fs_failed == 0
        assert store.publish_blob(store.key("step", sig="w"), {"k": 2})
        assert spec._store_fs_failed == 1               # budget spent
    finally:
        chaos.install(None)
    chaos.install({"fs_transient": {"fail_first": 1}})  # default scope
    try:
        spec = chaos.active()
        assert store.load_blob(key) == {"k": 1}
        assert spec._store_fs_ops == 0 and spec._fs_failed == 0
    finally:
        chaos.install(None)
        faults.reset_for_tests()
    assert store.stats()["errors"] == 0


def test_shed_site_builds_as_usual(store):
    """artifact_store is an optional fault-domain site: while it is shed
    the store answers None/False without touching the disk, and /healthz
    turns degraded; never a crash."""
    from horovod_tpu_torch import metrics as M
    key = store.key("step", sig="shed")
    assert "artifact_store" in faults.SHEDDABLE_SITES
    faults.reset_for_tests()
    knobs.set_override("HOROVOD_FAULT_PROBE_SECONDS", 9999)
    try:
        faults.fault_domain().record_exhausted("artifact_store",
                                               critical=False)
        assert faults.fault_domain().state() == faults.DEGRADED
        assert M.health_snapshot()["status"] == "degraded"
        assert not store.publish_blob(key, {"k": 1})
        assert store.load_blob(key) is None
        assert store.stats()["shed"] == 2 and not store.contains(key)
        faults.fault_domain().record_success("artifact_store")
        assert store.publish_blob(key, {"k": 1})
        assert store.load_blob(key) == {"k": 1}
    finally:
        knobs.clear_override("HOROVOD_FAULT_PROBE_SECONDS")
        faults.reset_for_tests()


def test_lru_eviction_by_mtime(store):
    keys = [store.key("blob", i=i) for i in range(3)]
    payload = {"x": "y" * 512}
    store.publish_blob(keys[0], payload)
    store.publish_blob(keys[1], payload)
    now = time.time()
    os.utime(store._path(keys[0]), (now - 1000, now - 1000))
    os.utime(store._path(keys[1]), (now - 500, now - 500))
    assert store.load_blob(keys[0]) == payload      # a hit touches mtime
    size = os.path.getsize(store._path(keys[0]))
    store.max_bytes = size * 2 + 10                 # room for two
    store.publish_blob(keys[2], payload)
    assert not store.contains(keys[1])              # the oldest went
    assert store.contains(keys[0]) and store.contains(keys[2])
    assert store.stats()["evictions"] == 1


def test_concurrent_readers(store):
    key = store.key("step", sig="conc")
    obj = {"kernels": {"paged_decode": "a" * 32}}
    store.publish_blob(key, obj)
    errs = []

    def reader():
        try:
            for _ in range(20):
                assert store.load_blob(key) == obj
        except Exception as e:                      # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs and store.stats()["hits"] == 80


def test_atomic_publish_under_schedhooks_seam(store):
    """A kill at the publish point leaves only a ``.tmp-`` file, which
    readers do not see, the eviction scan skips and reaps once stale, and
    a later publish replaces: no partial entry is ever served."""
    key = store.key("step", sig="atomic")
    renames = []

    class CrashAtPublish(schedhooks.SchedulerHooks):
        def rename(self, src, dst):
            renames.append((src, dst))
            raise KeyboardInterrupt("simulated kill at the publish point")

    prev = schedhooks.install(CrashAtPublish())
    try:
        with pytest.raises(KeyboardInterrupt):
            store.publish_blob(key, {"k": 1})
    finally:
        schedhooks.install(prev)
    (src, dst) = renames[0]
    assert os.path.basename(src).startswith(".tmp-")
    assert dst == store._path(key) and os.path.exists(src)
    assert not store.contains(key) and store.load_blob(key) is None
    assert store.stats()["entries"] == 0
    os.utime(src, (time.time() - 7200, time.time() - 7200))
    store._entries()
    assert not os.path.exists(src)
    assert store.publish_blob(key, {"k": 1})
    assert store.load_blob(key) == {"k": 1}


def test_healthz_and_ledger_carry_store_block(store):
    from horovod_tpu_torch import metrics as M
    from horovod_tpu_torch.goodput import ledger
    key = store.key("step", sig="obs")
    store.publish_bytes(key, b"library", compile_seconds=1.25)
    assert store.load_bytes(key)[1] == b"library"
    block = M.health_snapshot()["artifact_store"]
    assert block["hits"] == 1 and block["publishes"] == 1
    assert block["compile_seconds_saved"] == 1.25 and block["entries"] == 1
    assert ledger.build_record()["artifact_store"]["hits"] == 1
    text = M.get_registry().render()
    for name in ("hvd_artifact_store_hits_total",
                 "hvd_artifact_store_bytes_total",
                 "hvd_compile_seconds_saved_total",
                 "hvd_artifact_store_size_bytes"):
        assert name in text
    knobs.set_override("HOROVOD_ARTIFACT_STORE", "")
    try:
        assert "artifact_store" not in M.health_snapshot()
        assert ledger.build_record()["artifact_store"] is None
    finally:
        knobs.clear_override("HOROVOD_ARTIFACT_STORE")


# ---------------------------------------------------------------------------
# the kernel tier, with a stand-in nvcc
# ---------------------------------------------------------------------------

@pytest.fixture()
def kernels(tmp_path, monkeypatch, store):
    """A stand-in nvcc (copies the source to the library, logs each run),
    an empty build directory and fresh resolution state; yields a helper
    with ``runs()`` (nvcc runs so far) and ``host(i)`` (point the build
    directory at an empty one, as on another host)."""
    log = tmp_path / "nvcc.log"
    exe = tmp_path / "nvcc"
    exe.write_text(
        "#!/bin/sh\n"
        'if [ "$1" = "--version" ]; then\n'
        '  echo "Cuda compilation tools, release 12.9, V12.9.86"; exit 0\n'
        "fi\n"
        f'echo run >> "{log}"\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'cp "$3" "$2"; echo ptxas ok\n')
    exe.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc", lambda: str(exe))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "resolved", {})
    monkeypatch.setattr(_build, "resolve_seconds", {})

    class K:
        store_ = store

        @staticmethod
        def runs():
            return len(log.read_text().split()) if log.exists() else 0

        @staticmethod
        def host(i):
            monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / f"host{i}")
            _build._libs.clear()
            _build.resolved.clear()
            return _build.BUILD_DIR

    K.host(0)
    yield K


def _digests():
    return {n: hashlib.sha256(_build.library_path(n).read_bytes()).hexdigest()
            for n in _build.SOURCES}


def test_kernel_cold_resolve_publishes(kernels):
    before = _build.builds_run
    seconds = _build.build_all()
    assert kernels.runs() == 6 and _build.builds_run == before + 6
    assert set(_build.resolved.values()) == {"built"}
    s = kernels.store_.stats()
    assert s["publishes"] == 6 and s["entries"] == 6 and s["misses"] == 6
    headers = {h["kernel"]: h for h in st.read_entry_headers(s["root"])}
    assert set(headers) == set(_build.SOURCES)
    for name, h in headers.items():
        assert h["kind"] == "kernel" and h["payload_ok"]
        assert h["nvcc_release"] == "12.9" and h["order_fingerprint"] is None
        assert h["compile_seconds"] == round(seconds[name], 6) > 0
        assert h["components"] == {"kernel": name,
                                   "source": _build.source_digest(name)}
        assert h["file"] == _build.kernel_key(name).digest + ".hvdx"


def test_kernel_warm_resolve_runs_no_nvcc_and_writes_the_same_bytes(kernels):
    _build.build_all()
    cold = _digests()
    saved = sum(h["compile_seconds"] for h in
                st.read_entry_headers(kernels.store_.root))
    kernels.host(1)
    runs, builds = kernels.runs(), _build.builds_run
    assert _build.build_all() == {n: 0.0 for n in _build.SOURCES}
    assert kernels.runs() == runs and _build.builds_run == builds
    assert set(_build.resolved.values()) == {"store"}
    assert _digests() == cold
    assert all(_build.library_path(n).parent == kernels.host(1)
               for n in _build.SOURCES)
    s = kernels.store_.stats()
    assert s["hits"] == 6 and s["publishes"] == 6
    assert s["compile_seconds_saved"] == pytest.approx(saved, abs=1e-5)
    assert not [p for p in os.listdir(_build.BUILD_DIR) if "tmp" in p]


def test_kernel_corrupt_entry_rebuilds_and_republishes(kernels):
    _build.build_all()
    cold = _digests()
    path = kernels.store_._path(_build.kernel_key("flash_fwd"))
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[:-4] + b"\x00\x00\x00\x00")
    kernels.host(1)
    runs = kernels.runs()
    _build.build_all()
    assert kernels.runs() == runs + 1
    assert _build.resolved["flash_fwd"] == "built"
    assert {_build.resolved[n] for n in _build.SOURCES
            if n != "flash_fwd"} == {"store"}
    assert _digests() == cold
    s = kernels.store_.stats()
    assert s["publishes"] == 7 and kernels.store_.miss_reasons["corrupt"] == 1
    assert all(h["payload_ok"]
               for h in st.read_entry_headers(kernels.store_.root))


def test_kernel_chaos_store_corrupt_rebuilds(kernels):
    _build.build_all()
    kernels.host(1)
    chaos.install({"store_corrupt": {"fail_first": 1}})
    try:
        runs = kernels.runs()
        _build.build_all()
    finally:
        chaos.install(None)
    assert kernels.runs() == runs + 1
    assert sorted(_build.resolved.values()).count("store") == 5


def test_kernel_edited_header_misses(kernels, tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    _build.build_all()
    keys = {n: _build.kernel_key(n).digest for n in _build.SOURCES}
    with open(csrc / "sm90_common.cuh", "a") as f:
        f.write("\n// edited\n")
    assert all(_build.kernel_key(n).digest != keys[n]
               for n in _build.SOURCES)
    kernels.host(1)
    runs = kernels.runs()
    _build.build_all()
    assert kernels.runs() == runs + 6
    assert kernels.store_.stats()["entries"] == 12


def test_kernel_key_leaves_out_the_world(kernels):
    """A library does not depend on the world: a rank of four keys its
    kernels as one card does, while the other kinds key on the world."""
    one = (_build.kernel_key("paged_decode").digest, st.env_fingerprint())

    class Four(schedhooks.SchedulerHooks):
        def world(self):
            return (2, 4)

    prev = schedhooks.install(Four())
    try:
        four = (_build.kernel_key("paged_decode").digest,
                st.env_fingerprint())
    finally:
        schedhooks.install(prev)
    assert one[0] == four[0]
    assert one[1]["process_count"] == 1 and four[1]["process_count"] == 4
    assert "process_count" not in _build.kernel_key("paged_decode").env


def test_kernel_warm_build_dir_fills_a_cold_store(kernels):
    knobs.set_override("HOROVOD_ARTIFACT_STORE", "")
    try:
        _build.build_all()
    finally:
        knobs.set_override("HOROVOD_ARTIFACT_STORE", kernels.store_.root)
    assert kernels.store_.stats()["entries"] == 0
    runs = kernels.runs()
    _build.resolved.clear()             # a later process on this checkout
    _build.build_all()
    assert kernels.runs() == runs
    assert set(_build.resolved.values()) == {"local"}
    headers = st.read_entry_headers(kernels.store_.root)
    assert len(headers) == 6
    assert all(h["nvcc_release"] is None and h["compile_seconds"] == 0
               for h in headers)
    kernels.host(1)
    _build.build_all()
    assert set(_build.resolved.values()) == {"store"}


def test_load_resolves_then_opens_and_records(kernels, monkeypatch):
    opened = []
    monkeypatch.setattr(_build, "_open_library",
                        lambda path, name: opened.append((path, name))
                        or name)
    with _build.recording() as names:
        assert _build.load("stream_copy") == "stream_copy"
        t = threading.Thread(target=_build.load, args=("flash_bwd",))
        t.start()
        t.join()
    assert names == {"stream_copy", "flash_bwd"}
    assert opened[0] == (_build.library_path("stream_copy"), "stream_copy")
    assert _build.load("stream_copy") == "stream_copy"
    assert len(opened) == 2 and kernels.runs() == 2


# ---------------------------------------------------------------------------
# the step tier
# ---------------------------------------------------------------------------

def _kernel_step(state, x):
    """A train step that loads two kernels, as the flagship's first step
    loads the flash forward and backward."""
    _build.load("flash_fwd")
    _build.load("flash_bwd")
    return state, float(x)


@pytest.fixture()
def fake_open(monkeypatch):
    monkeypatch.setattr(_build, "_open_library", lambda path, name: name)


def test_step_manifest_miss_then_hit_resolves_before_step_one(kernels,
                                                             fake_open):
    state = {"w": torch.zeros(3)}
    _, info = htt.train_loop(_kernel_step, state, [1.0, 2.0])
    assert info["store_step"] == "miss" and kernels.runs() == 2
    (h,) = [h for h in st.read_entry_headers(kernels.store_.root)
            if h["kind"] == "step"]
    assert h["label"] == "train_step"
    manifest = kernels.store_.load_blob(st.StoreKey(
        "step", h["components"], env=st.env_fingerprint()))
    assert manifest == {"kernels": {
        n: _build.kernel_key(n).digest for n in ("flash_bwd", "flash_fwd")}}
    kernels.host(1)
    seen = []

    def first_step(state, x):
        # both libraries are in the build directory before step 1
        seen.append({n: _build.library_path(n).exists()
                     for n in ("flash_fwd", "flash_bwd")})
        return _kernel_step(state, x)
    first_step.__qualname__ = _kernel_step.__qualname__
    runs, builds = kernels.runs(), _build.builds_run
    _, info = htt.train_loop(first_step, state, [1.0, 2.0])
    assert info["store_step"] == "hit"
    assert seen[0] == {"flash_fwd": True, "flash_bwd": True}
    assert kernels.runs() == runs and _build.builds_run == builds
    assert _build.resolved == {"flash_fwd": "store", "flash_bwd": "store"}


def test_step_manifest_of_an_edited_kernel_is_stale(kernels, fake_open,
                                                    tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    state = {"w": torch.zeros(3)}
    assert htt.train_loop(_kernel_step, state, [1.0])[1]["store_step"] == \
        "miss"
    with open(csrc / "flash_fwd.cu", "a") as f:
        f.write("\n// edited\n")
    kernels.host(1)
    assert htt.train_loop(_kernel_step, state, [1.0])[1]["store_step"] == \
        "miss"
    assert kernels.store_.miss_reasons.get("stale") == 1
    assert htt.train_loop(_kernel_step, state, [1.0])[1]["store_step"] == \
        "hit"


def test_step_key_moves_with_shapes_knobs_and_world(store, monkeypatch,
                                                     tmp_path):
    from horovod_tpu_torch.parallel.trainer import TrainState
    monkeypatch.setenv("HOROVOD_BUCKET_AUTO_CACHE",
                       str(tmp_path / "bucket_auto.json"))
    state = TrainState(0, {"a": torch.zeros(4, 8)}, None)
    base = st.step_key_components(_kernel_step, (state, torch.zeros(2, 3)))
    assert base["grad_signature"] == jautotune.grad_signature(
        [((4, 8), np.dtype(np.float32))], 1)
    other = st.step_key_components(_kernel_step, (state, torch.zeros(2, 4)))
    assert other["step"] != base["step"]
    state2 = TrainState(5, {"a": torch.ones(4, 8)}, None)
    assert st.step_key_components(
        _kernel_step, (state2, torch.ones(2, 3))) == base   # values: no
    knobs.set_override("HOROVOD_GRADIENT_BUCKET_BYTES", "auto")
    try:
        auto = st.step_key_components(_kernel_step,
                                      (state, torch.zeros(2, 3)))
    finally:
        knobs.clear_override("HOROVOD_GRADIENT_BUCKET_BYTES")
    assert auto["resolved_bucket_bytes"] == 25 * 1024 * 1024
    assert auto["knobs"] != base["knobs"]


@pytest.fixture(scope="module")
def np_params():
    import test_torch_training as tt
    from horovod_tpu.models import transformer as jtfm
    return jax.tree.map(np.asarray,
                        jtfm.init_params(tt._jcfg(), jax.random.PRNGKey(0)))


def test_train_loop_store_step_is_bitwise_and_matches_jax(store, np_params):
    """The flagship's steps through ``train_loop`` on a store, cold then
    warm: ``store_step`` miss then hit, the losses and parameters bitwise
    equal between the two, and against the JAX trainer (without its
    store) at the training tolerance."""
    import test_torch_training as tt
    batches = tt._batches(3)
    j_losses, j_params = tt._jax_trajectory(np_params, batches, 1)
    runs = []
    for _ in range(2):
        htt.init(device="cpu")
        try:
            init_fn, step = htt.make_transformer_train_step(
                tt._cfg(dp_axis="dp", mlp_recompute=True), tt._sgd,
                device="cpu")
            state = init_fn(htt.params_from_numpy(np_params, device="cpu"))
            losses = []
            state, info = htt.train_loop(
                step, state, batches,
                on_step=lambda i, s, loss: losses.append(loss.clone()))
        finally:
            htt.shutdown()
        runs.append((info, losses, state.params))
    assert [r[0]["store_step"] for r in runs] == ["miss", "hit"]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    from horovod_tpu_torch.utils import tree as tree_util
    assert all(torch.equal(a, b) for a, b in zip(
        tree_util.tree_leaves(runs[0][2]), tree_util.tree_leaves(runs[1][2])))
    np.testing.assert_allclose([float(x) for x in runs[1][1]], j_losses,
                               **tt.TOL)
    tt._assert_tree_close(runs[1][2], j_params, what="params after 3 steps")


# ---------------------------------------------------------------------------
# the eager coordinator in a two-rank gloo world
# ---------------------------------------------------------------------------

def test_warm_coordinator_builds_no_plan_and_matches_jax(tmp_path):
    """Two phases of one two-rank world on one store: the cold
    coordinators build the plans and publish them, the warm ones (fresh
    coordinators, empty plan caches) build none and read every plan from
    the store; the results equal the JAX eager results."""
    import test_torch_coordinator as tc
    w = 2
    scripts = {name: tc._script(name, w, str(tmp_path))
               for name in ("cache_hit_on_steady_state",
                            "mixed_dtypes_share_one_program",
                            "mixed_ops_split_programs")}
    env = {"HOROVOD_ARTIFACT_STORE": str(tmp_path / "store")}
    phases = [{"threads": 1, "env": env, "scenarios": [
        dict(sc, kind="coord", name=f"{tag}-{name}")
        for name, sc in scripts.items()]} for tag in ("cold", "warm")]
    load = workers.run_phases(w, phases, tmp_path)
    for name, sc in scripts.items():
        jres = tc.run_jax(sc, w)
        for tag in ("cold", "warm"):
            port = [dict(load(f"{tag}-{name}", r)) for r in range(w)]
            counts = [port[r]["store_counts"].tolist() for r in range(w)]
            for r in range(w):
                rec = json.loads(str(port[r]["record"]))
                assert rec["bins"] == jres["bins"], (tag, name, r)
            if tag == "cold":
                # a rank may read a plan its peer published a moment ago
                assert sum(b for b, _ in counts) >= 1, (name, counts)
            else:
                assert all(b == 0 and h >= 1 for b, h in counts), \
                    (name, counts)
            tc._check_values(sc, port, jres, w)
    entries = st.read_entry_headers(env["HOROVOD_ARTIFACT_STORE"])
    assert entries and all(h["kind"] == "eager_fused" and h["payload_ok"]
                           for h in entries)


def test_fused_plan_round_trips_through_json():
    from horovod_tpu_torch.ops.coordinator import FusedPlan
    plan = FusedPlan("allreduce", "codec:bf16", True,
                     [(torch.float32, [0, 2], [12, 4]),
                      (torch.bfloat16, [1], [8])], stats=True)
    back = FusedPlan.from_json(json.loads(json.dumps(plan.to_json())))
    assert (back.op_type, back.path, back.batch, back.stats) == \
        ("allreduce", "codec:bf16", True, True)
    assert back.groups == plan.groups
    with pytest.raises(ValueError):
        FusedPlan.from_json(dict(plan.to_json(),
                                 groups=[["Tensor", [0], [1]]]))


def test_store_sig_is_the_same_in_every_world_of_the_shape():
    """The store's form of a bin signature names a process set by its
    ranks, not by the id its registration order gave it."""
    from horovod_tpu_torch.ops import coordinator as C
    from horovod_tpu_torch.parallel.process_sets import ProcessSet

    class E:
        def __init__(self, ps):
            self.process_set = ps

    sig = ("allreduce", 1, 7, 0.5, None, 0, ((4,),), (torch.float32,),
           True)
    a, b = ProcessSet([2, 0]), ProcessSet([0, 2])
    a.process_set_id, b.process_set_id = 3, 9
    assert C._store_sig(sig, E(a)) == C._store_sig(sig, E(b))
    assert C._store_sig(sig, E(a))[2] == ("ranks", (0, 2))
    assert C._store_sig(sig, E(a))[7] == ("float32",)
    assert C._store_sig(sig, E(None))[2] == ("ranks", None)


# ---------------------------------------------------------------------------
# the serving fleet
# ---------------------------------------------------------------------------

@pytest.fixture()
def fleet_params():
    import test_torch_serving as ts
    from horovod_tpu.serving import reset_for_tests as jreset
    from horovod_tpu_torch import params_from_numpy
    from horovod_tpu_torch.serving import reset_for_tests
    jp = ts.jtfm.init_params(ts._jcfg(), jax.random.PRNGKey(0))
    yield jp, params_from_numpy(ts._np_tree(jp), "cpu")
    reset_for_tests()
    jreset()


@pytest.fixture()
def hosts(kernels, monkeypatch):
    """Each port replica on a host of its own: an empty build directory
    made as its engine is built, and the engine resolving its kernels as
    on the card (the CPU engine runs their plain versions)."""
    from horovod_tpu_torch.serving import engine as engine_mod
    monkeypatch.setattr(engine_mod, "_launches_kernels", lambda dev: True)

    def port_pkg(params, **kw):
        import test_torch_fleet as tf
        jax_pkg, port = tf.both(params, **kw)
        make = port.make_engine

        def make_engine(rid):
            kernels.host(100 + len(port.built))
            port.built.append(rid)
            return make(rid)
        port.built = []
        port.make_engine = make_engine
        return jax_pkg, port
    return port_pkg


def test_fleet_warm_replica_builds_zero_through_router_path(fleet_params,
                                                            hosts, kernels):
    import test_torch_fleet as tf
    got = {}
    for pkg in hosts(fleet_params):
        fleet = pkg.fleet(replicas=1)
        fleet.run(pkg.reqs(2, seed=3))
        rep = fleet.grow(reason="test")
        fleet.drain(0, reason="test")
        fleet.run([])
        req = pkg.Request(rid=50, prompt=np.arange(1, 13, dtype=np.int32),
                          max_new_tokens=4)
        assert fleet.dispatch(req) == rep.rid
        fleet.run([])
        assert req.done and not req.error and len(req.tokens) == 4
        if not pkg.jax:
            first = fleet.replicas[0].engine
            assert first.builds == 1
            assert first.store_outcomes == {"serve_decode": "miss"}
            assert rep.engine.builds == 0
            assert rep.engine.store_outcomes == {"serve_decode": "hit"}
            assert fleet.stats()["members"]["replica-1"]["builds"] == 0
            assert kernels.runs() == 1
        got[pkg.name] = tf.summary(fleet)
        pkg.reset()
    assert got["port"] == got["jax"]


def test_fleet_autoscaler_grows_warm_off_the_store(fleet_params, hosts,
                                                   kernels):
    import test_torch_fleet as tf
    got = {}
    for pkg in hosts(fleet_params):
        fleet = pkg.fleet(replicas=1, max_replicas=2, scale_up_depth=2,
                          scale_down_idle=3, cooldown=0)
        for r in pkg.reqs(10, seed=5, n_new=4):
            r.arrival = None
            fleet.dispatch(r)
        fleet.cycle()
        grow = [e for e in fleet.scale_events
                if e["event"] == "grow" and "queue_depth" in str(e["reason"])]
        assert grow and grow[0]["cycle"] == 0
        if not pkg.jax:
            assert grow[0]["builds"] == 0
            assert fleet.replicas[grow[0]["replica"]].engine.store_outcomes \
                == {"serve_decode": "hit"}
        fleet.run([])
        assert len(fleet.completed) == 10
        for _ in range(12):
            fleet.cycle()
        fleet.run([])
        assert len(fleet.admitting()) == fleet.min_replicas
        got[pkg.name] = tf.summary(fleet)
        pkg.reset()
    assert got["port"] == got["jax"]


def test_fleet_of_one_on_the_store_is_the_bare_engine(fleet_params, hosts,
                                                      kernels):
    import test_torch_fleet as tf
    from horovod_tpu.serving import ServeScheduler as JServeScheduler
    from horovod_tpu_torch.serving import ServeScheduler
    got = {}
    for pkg in hosts(fleet_params):
        fleet = pkg.fleet(replicas=1, max_replicas=1)
        done = fleet.run(pkg.reqs(6))
        got[pkg.name] = tf.summary(fleet, done)
        pkg.reset()
        eng = pkg.make_engine(99)
        sched = (JServeScheduler(eng, queue_deadline=0.0) if pkg.jax else
                 ServeScheduler(eng, queue_deadline=0.0, device="cpu"))
        bare = sched.run(pkg.reqs(6))
        assert got[pkg.name]["tokens"] == {r.rid: r.tokens for r in bare}
        if not pkg.jax:
            assert eng.builds == 0
            assert eng.store_outcomes == {"serve_decode": "hit"}
    assert got["port"] == got["jax"]


def test_engine_store_outcomes_name_the_kernel_steps(fleet_params, hosts,
                                                     kernels):
    """The labels of the JAX engine whose port launches a kernel: decode,
    and with speculative decoding the verify step and the truncated
    draft, all paged decode; none on the CPU path or without the store."""
    import test_torch_serving as ts
    from horovod_tpu_torch.serving import ServeEngine
    from horovod_tpu_torch.serving import engine as engine_mod
    _, pp = fleet_params
    kw = dict(ts.ENGINE_KW, draft="truncate:1", spec_k=2)
    eng = ServeEngine(ts._cfg(), pp, device="cpu", **kw)
    assert eng.store_outcomes == {"serve_decode": "miss",
                                  "serve_verify_k2": "miss",
                                  "serve_draft_l1": "miss"}
    assert eng.builds == 1
    eng = ServeEngine(ts._cfg(), pp, device="cpu", **kw)
    assert set(eng.store_outcomes.values()) == {"local"} and eng.builds == 0
    kernels.host(1)
    eng = ServeEngine(ts._cfg(), pp, device="cpu", **kw)
    assert set(eng.store_outcomes.values()) == {"hit"} and eng.builds == 0
    assert eng.stats()["store_outcomes"] == eng.store_outcomes
    engine_mod._launches_kernels = lambda dev: dev.type == "cuda"
    assert ServeEngine(ts._cfg(), pp, device="cpu").store_outcomes == {}
