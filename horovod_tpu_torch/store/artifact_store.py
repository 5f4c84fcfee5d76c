"""Disk-backed store of the port's compiled artifacts.

The counterpart of ``horovod_tpu/store/artifact_store.py``: what one
process paid to compile, a later process loads instead of compiling
again: a preemption auto-resume, an elastic respawn, a serving replica
joining a fleet, the next run on a fresh checkout.

The port has no XLA executables. Its steps run eagerly, and what it
compiles are the kernel libraries ``nvcc`` builds at first use
(``ops/_build.py``): those are what the store holds here, one entry per
library (kind ``kernel``). Three consumers keep small JSON entries
beside them: the eager coordinator's fused plans (``eager_fused``), the
train step's manifest of the kernels its first step loaded (``step``)
and a serving engine's kernels (``serve``, read through the kernel
tier). So the JAX module's ``serialize_executable`` payload,
``aot_compile``, ``program_text_hash``, ``donation_guard`` and the XLA
half of ``wrap_compiled`` have no counterpart here, and the HVD503
collective-order fingerprint of the header is ``null`` until the port
has the IR verifier (ROADMAP A.15).

Key = sha256 over the canonical JSON of::

    {kind,                    # kernel | step | serve | eager_fused | blob
     env fingerprint,         # torch + CUDA versions, platform, device
                              # name and compute capability, world size
                              # (kernel keys leave the world out: a
                              # library does not depend on it)
     components}              # per consumer: kernel source digest, step
                              # signature, mesh, program-keying knobs,
                              # gradient signature

A flipped knob, a changed mesh, another gradient payload or an edited
kernel source each make another digest, so a stale artifact never loads.

Publishing writes the whole entry to a ``.tmp-`` sibling and publishes it
with one ``schedhooks.rename``; a reader checks the magic, the format
version, the env fingerprint and the payload's sha256 before it uses an
entry, so a partial, corrupt, truncated or version-skewed entry logs a
line, counts a miss and falls back to a build, never a crash. Store I/O
runs under ``retry_fs`` at the optional fault-domain site
``artifact_store``: while the site is shed, the process builds as usual.

Entry format (the JAX package's, so each package reads the other's
JSON entries): ``MAGIC`` + u32 header length (big-endian) + JSON header
+ payload, one file ``<digest>.hvdx``.
"""

from __future__ import annotations

import functools
import hashlib
import inspect
import json
import os
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.utils import schedhooks
from horovod_tpu_torch.utils.logging import get_logger

logger = get_logger("horovod_tpu_torch.store")

MAGIC = b"HVDSTORE\x01"
FORMAT_VERSION = 1
_SUFFIX = ".hvdx"
_TMP_PREFIX = ".tmp-"
SITE = "artifact_store"

# Knobs that key a stored artifact (their resolved values): the JAX
# package's tuple. A name the port does not register is skipped, as the
# JAX package skips one on KeyError.
PROGRAM_KNOBS = (
    "HOROVOD_GRADIENT_COMPRESSION",
    "HOROVOD_GRADIENT_ERROR_FEEDBACK",
    "HOROVOD_GRADIENT_BUCKET_BYTES",
    "HOROVOD_DCN_SCHEDULE",
    "HOROVOD_DCN_MESH",
    "HOROVOD_DCN_VIRTUAL_SLICES",
    "HOROVOD_FUSION_THRESHOLD",
    "HOROVOD_BATCH_D2D_MEMCOPIES",
    "HOROVOD_HIERARCHICAL_ALLREDUCE",
    "HOROVOD_HIERARCHICAL_ALLGATHER",
    "HOROVOD_TORUS_ALLREDUCE",
    "HOROVOD_TPU_DONATE_BUFFERS",
    "HOROVOD_TPU_MATMUL_PRECISION",
    "HOROVOD_CE_BLOCK_VOCAB",
    "HOROVOD_NUMERICS",
)


def env_fingerprint(world: bool = True) -> Dict[str, Any]:
    """The toolchain and device an artifact is valid under: the port's
    version, torch's and its CUDA's (for the JAX package's jax and
    jaxlib), the platform (``gpu``/``cpu``), the device's name and
    compute capability, and with ``world`` the number of devices and of
    processes (both the world size: one card per rank). Any difference
    is a miss. Kernel keys pass ``world=False``: a library built for one
    card loads in a world of four."""
    from horovod_tpu_torch.version import __version__
    fp: Dict[str, Any] = {"format": FORMAT_VERSION,
                          "horovod_tpu_torch": __version__,
                          "torch": torch.__version__,
                          "cuda": torch.version.cuda or ""}
    if torch.cuda.is_available():
        dev = torch.cuda.current_device()
        major, minor = torch.cuda.get_device_capability(dev)
        fp.update(platform="gpu",
                  device_kind=torch.cuda.get_device_name(dev),
                  capability=f"{major}.{minor}")
    else:
        fp.update(platform="cpu", device_kind="cpu", capability="")
    if world:
        n = schedhooks.process_world()[1]
        fp.update(n_devices=n, process_count=n)
    return fp


def mesh_fingerprint() -> Dict[str, Any]:
    """The checkpoint manifest's topology identity
    (``resilience/async_checkpoint.mesh_fingerprint``): the fields that
    gate a snapshot's restore gate a stored artifact's load."""
    from horovod_tpu_torch.resilience.async_checkpoint import (
        mesh_fingerprint as _mfp)
    return _mfp()


def program_knob_fingerprint() -> Dict[str, str]:
    """Resolved values of the program-keying knobs, as strings."""
    out = {}
    for name in PROGRAM_KNOBS:
        try:
            out[name] = str(knobs.get(name))
        except KeyError:
            continue
    return out


class StoreKey:
    """One composite fingerprint: ``kind`` + env fingerprint + the
    consumer's components, in canonical JSON; ``digest`` names the
    entry's file."""

    def __init__(self, kind: str, components: Dict[str, Any],
                 env: Optional[Dict[str, Any]] = None):
        self.kind = str(kind)
        self.env = env if env is not None else env_fingerprint()
        self.components = components
        self.canonical = json.dumps(
            {"kind": self.kind, "env": self.env,
             "components": components},
            sort_keys=True, default=str)
        self.digest = hashlib.sha256(
            self.canonical.encode()).hexdigest()[:32]

    def __repr__(self) -> str:
        return f"StoreKey({self.kind}, {self.digest})"


# -- metrics (imported lazily: the store is imported before the plane) ------

def _count(name: str, help_: str, n: float = 1.0) -> None:
    try:
        from horovod_tpu_torch import metrics as M
        M.counter(name, help_).inc(n)
    except Exception:
        pass


def _set_size_gauge(nbytes: int) -> None:
    try:
        from horovod_tpu_torch import metrics as M
        M.gauge("hvd_artifact_store_size_bytes",
                "Bytes currently held by the persistent compiled-"
                "artifact store (post-eviction)",
                aggregation="leader").set(float(nbytes))
    except Exception:
        pass


def _canonical(components: Dict[str, Any]) -> Any:
    return json.loads(json.dumps(components, sort_keys=True, default=str))


class ArtifactStore:
    """One store root directory of entries ``<digest>.hvdx``: ``MAGIC`` +
    u32 header length + JSON header + payload. The header alone decides
    whether an entry loads (env fingerprint, components, payload
    sha256); the payload is a kernel library's bytes or a JSON blob."""

    def __init__(self, root: str, max_bytes: int = 0):
        self.root = os.path.abspath(os.path.expanduser(root))
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        # this instance's tallies (stats(), /healthz and the ledger read
        # them; the module's counters add over instances)
        self._stats = {"hits": 0, "misses": 0, "evictions": 0,
                       "publishes": 0, "bytes_written": 0,
                       "compile_seconds_saved": 0.0, "errors": 0,
                       "shed": 0}
        # misses by reason (absent, corrupt, version-skewed, ...)
        self.miss_reasons: Dict[str, int] = {}

    def _path(self, key: StoreKey) -> str:
        return os.path.join(self.root, key.digest + _SUFFIX)

    def _tally(self, field: str, n: float = 1) -> None:
        with self._lock:
            self._stats[field] += n

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = dict(self._stats)
        out["compile_seconds_saved"] = round(out["compile_seconds_saved"], 6)
        out["root"] = self.root
        out["max_bytes"] = self.max_bytes
        entries = self._entries()
        out["size_bytes"] = sum(nb for _, nb, _ in entries)
        out["entries"] = len(entries)
        return out

    def _miss(self, reason: str, path: str, detail: str = "") -> None:
        self._tally("misses")
        with self._lock:
            self.miss_reasons[reason] = self.miss_reasons.get(reason, 0) + 1
        _count("hvd_artifact_store_misses_total",
               "Artifact-store lookups that fell back to a compile")
        if reason != "absent":
            logger.warning("artifact store: %s entry ignored (%s)%s — "
                           "falling back to a build", reason, path,
                           f": {detail}" if detail else "")

    # -- read -----------------------------------------------------------------
    def _read_entry(self, key: StoreKey) -> Optional[Tuple[dict, bytes]]:
        """(header, payload) of a valid entry, or None (counted and, but
        for an absent one, logged as a miss). Never raises."""
        from horovod_tpu_torch.resilience import chaos, faults
        path = self._path(key)
        if faults.should_shed(SITE):
            self._tally("shed")
            self._miss("absent", path)
            return None

        def _read() -> Optional[bytes]:
            chaos.on_fs("store_read", path)
            if not os.path.exists(path):
                return None
            with open(path, "rb") as f:
                return f.read()
        try:
            raw = faults.retry_fs(SITE, _read)
        except (faults.RetryBudgetExhausted, OSError) as e:
            self._tally("errors")
            self._miss("unreadable", path, str(e))
            return None
        if raw is None:
            self._miss("absent", path)
            return None
        if chaos.on_store_load(path):
            self._miss("corrupt", path, "chaos store_corrupt")
            return None
        parsed = _parse(raw)
        if parsed is None:
            self._miss("corrupt", path, "bad magic, truncated or "
                       "unparseable header")
            return None
        header, payload = parsed
        if header.get("env") != key.env:
            self._miss("version-skewed", path,
                       f"stored under {header.get('env')}, current "
                       f"{key.env}")
            return None
        if header.get("components") != _canonical(key.components):
            self._miss("mismatched", path, "component collision")
            return None
        if hashlib.sha256(payload).hexdigest() != \
                header.get("payload_sha256"):
            self._miss("corrupt", path, "payload digest mismatch")
            return None
        return header, payload

    def _hit(self, key: StoreKey, header: dict) -> None:
        self._tally("hits")
        saved = float(header.get("compile_seconds") or 0.0)
        self._tally("compile_seconds_saved", saved)
        _count("hvd_artifact_store_hits_total",
               "Artifact-store lookups served from disk (compile skipped)")
        if saved > 0:
            _count("hvd_compile_seconds_saved_total",
                   "Compile seconds skipped by artifact-store hits (the "
                   "publish-time measured cost of each entry)", saved)
        try:
            os.utime(self._path(key))       # the LRU's order is mtime
        except OSError:
            pass

    def load_bytes(self, key: StoreKey) -> Optional[Tuple[dict, bytes]]:
        """(header, payload) of the entry for ``key`` (a kernel library's
        bytes, checked against the header's sha256), or None: a miss,
        whether absent, corrupt, truncated, version-skewed or shed."""
        entry = self._read_entry(key)
        if entry is not None:
            self._hit(key, entry[0])
        return entry

    def load_blob(self, key: StoreKey,
                  accept: Optional[Callable[[Any], Optional[str]]] = None
                  ) -> Optional[Any]:
        """The JSON entry for ``key``, or None. ``accept(obj)`` may name a
        reason to refuse a valid entry (a step manifest whose kernels
        moved on); a refused entry is a miss."""
        entry = self._read_entry(key)
        if entry is None:
            return None
        header, payload = entry
        try:
            obj = json.loads(payload.decode("utf-8"))
        except (UnicodeDecodeError, ValueError) as e:
            self._miss("corrupt", self._path(key), str(e))
            return None
        reason = accept(obj) if accept is not None else None
        if reason:
            self._miss("stale", self._path(key), reason)
            return None
        self._hit(key, header)
        return obj

    def contains(self, key: StoreKey) -> bool:
        return os.path.exists(self._path(key))

    # -- write ----------------------------------------------------------------
    def _publish(self, key: StoreKey, payload: bytes,
                 meta: Dict[str, Any]) -> bool:
        from horovod_tpu_torch.resilience import chaos, faults
        if faults.should_shed(SITE):
            self._tally("shed")
            return False
        header = dict(meta)
        header.setdefault("order_fingerprint", None)
        header["env"] = key.env
        header["kind"] = key.kind
        header["components"] = _canonical(key.components)
        header["payload_sha256"] = hashlib.sha256(payload).hexdigest()
        header["payload_bytes"] = len(payload)
        header["created_unix"] = time.time()
        hdr = json.dumps(header, sort_keys=True).encode("utf-8")
        blob = MAGIC + struct.pack(">I", len(hdr)) + hdr + payload
        final = self._path(key)
        tmp = os.path.join(self.root, f"{_TMP_PREFIX}{key.digest}-"
                           f"{os.getpid()}-{os.urandom(4).hex()}")

        def _write() -> None:
            os.makedirs(self.root, exist_ok=True)
            chaos.on_fs("store_write", tmp)
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            chaos.on_fs("store_rename", final)
            # ONE rename publishes: no reader sees a partial entry. Through
            # the schedhooks seam, so a kill at this point can be drilled.
            schedhooks.rename(tmp, final)
        try:
            faults.retry_fs(SITE, _write)
        except (faults.RetryBudgetExhausted, OSError,
                chaos.ChaosDenied) as e:
            self._tally("errors")
            logger.warning("artifact store: publish of %s failed (%s) — "
                           "entry skipped, the run goes on", key, e)
            try:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            except OSError:
                pass
            return False
        self._tally("publishes")
        self._tally("bytes_written", len(blob))
        _count("hvd_artifact_store_bytes_total",
               "Bytes written to the persistent compiled-artifact store",
               len(blob))
        self._evict_to_budget()
        return True

    def publish_bytes(self, key: StoreKey, payload: bytes, *,
                      compile_seconds: float = 0.0,
                      extra_meta: Optional[Dict[str, Any]] = None) -> bool:
        """Publish raw bytes (a kernel library) with the seconds they took
        to build; False (logged) when the site is shed or I/O fails."""
        meta: Dict[str, Any] = {"compile_seconds":
                                round(float(compile_seconds), 6)}
        meta.update(extra_meta or {})
        return self._publish(key, bytes(payload), meta)

    def publish_blob(self, key: StoreKey, obj: Any, *,
                     extra_meta: Optional[Dict[str, Any]] = None) -> bool:
        payload = json.dumps(obj, sort_keys=True, default=str).encode()
        return self._publish(key, payload, dict(extra_meta or {}))

    # -- eviction -------------------------------------------------------------
    def _entries(self) -> List[Tuple[str, int, float]]:
        """[(path, nbytes, mtime)] of committed entries. ``.tmp-``
        leftovers of a killed publish are invisible to readers and reaped
        here once an hour old."""
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        now = time.time()
        for name in sorted(names):
            path = os.path.join(self.root, name)
            if name.startswith(_TMP_PREFIX):
                try:
                    if now - os.path.getmtime(path) > 3600:
                        os.unlink(path)
                except OSError:
                    pass
                continue
            if not name.endswith(_SUFFIX):
                continue
            try:
                st = os.stat(path)
            except OSError:
                continue
            out.append((path, int(st.st_size), st.st_mtime))
        return out

    def total_bytes(self) -> int:
        return sum(nb for _, nb, _ in self._entries())

    def _evict_to_budget(self) -> None:
        """Size-budgeted LRU: the oldest mtimes go first until the store
        fits HOROVOD_ARTIFACT_STORE_MAX_BYTES (0 = no limit). Hits touch
        the mtime again, so entries in use stay."""
        if self.max_bytes <= 0:
            _set_size_gauge(self.total_bytes())
            return
        entries = sorted(self._entries(), key=lambda e: e[2])
        total = sum(nb for _, nb, _ in entries)
        for path, nb, _ in entries:
            if total <= self.max_bytes:
                break
            try:
                os.unlink(path)
            except OSError:
                continue
            total -= nb
            self._tally("evictions")
            _count("hvd_artifact_store_evictions_total",
                   "Artifact-store entries evicted by the size-budgeted "
                   "LRU (HOROVOD_ARTIFACT_STORE_MAX_BYTES)")
            logger.info("artifact store: evicted %s (%d bytes) to fit the "
                        "%d-byte budget", os.path.basename(path), nb,
                        self.max_bytes)
        _set_size_gauge(total)

    def key(self, kind: str, **components: Any) -> StoreKey:
        return StoreKey(kind, components)


def _parse(raw: bytes) -> Optional[Tuple[dict, bytes]]:
    """(header, payload) of an entry's bytes, or None when the magic is
    wrong or the header truncated or unparseable."""
    if len(raw) < len(MAGIC) + 4 or not raw.startswith(MAGIC):
        return None
    (hlen,) = struct.unpack(">I", raw[len(MAGIC):len(MAGIC) + 4])
    body = raw[len(MAGIC) + 4:]
    if len(body) < hlen:
        return None
    try:
        header = json.loads(body[:hlen].decode("utf-8"))
    except (UnicodeDecodeError, ValueError):
        return None
    return header, body[hlen:]


def read_entry_headers(root: str) -> List[Dict[str, Any]]:
    """Parsed headers of every ``.hvdx`` entry under ``root``, each with
    ``file`` (its name) and ``payload_ok`` (the payload hashes to
    ``payload_sha256``). An entry whose header does not parse is
    skipped; an unreadable root raises OSError."""
    out: List[Dict[str, Any]] = []
    root = os.path.abspath(os.path.expanduser(root))
    for name in sorted(os.listdir(root)):
        if not name.endswith(_SUFFIX) or name.startswith(_TMP_PREFIX):
            continue
        try:
            with open(os.path.join(root, name), "rb") as f:
                raw = f.read()
        except OSError:
            continue
        parsed = _parse(raw)
        if parsed is None:
            continue
        header, payload = parsed
        header["file"] = name
        header["payload_ok"] = (hashlib.sha256(payload).hexdigest()
                                == header.get("payload_sha256"))
        out.append(header)
    return out


# ---------------------------------------------------------------------------
# the process's store (HOROVOD_ARTIFACT_STORE)
# ---------------------------------------------------------------------------

_store: Optional[ArtifactStore] = None
_store_cfg: Optional[Tuple[str, int]] = None
_store_lock = threading.Lock()


def enabled() -> bool:
    return bool(str(knobs.get("HOROVOD_ARTIFACT_STORE") or "").strip())


def from_env() -> Optional[ArtifactStore]:
    """The configured store, or None when HOROVOD_ARTIFACT_STORE is
    empty: one instance per (root, budget), so the tallies of every
    consumer add up in what /healthz reports."""
    global _store, _store_cfg
    root = str(knobs.get("HOROVOD_ARTIFACT_STORE") or "").strip()
    if not root:
        return None
    cfg = (root, int(knobs.get("HOROVOD_ARTIFACT_STORE_MAX_BYTES")))
    with _store_lock:
        if _store is None or _store_cfg != cfg:
            _store = ArtifactStore(root, max_bytes=cfg[1])
            _store_cfg = cfg
        return _store


def store_stats() -> Optional[Dict[str, Any]]:
    """The configured store's tallies (None when it is off): the
    /healthz ``artifact_store`` block and the ledger's read them."""
    store = from_env()
    return store.stats() if store is not None else None


def reset_for_tests() -> None:
    global _store, _store_cfg
    with _store_lock:
        _store = None
        _store_cfg = None


# ---------------------------------------------------------------------------
# the step tier: a manifest of the kernels the first step loaded
# ---------------------------------------------------------------------------

def _arg_sig(x: Any) -> Any:
    """Shapes and dtypes of an argument, never its values."""
    if isinstance(x, torch.Tensor):
        return ["tensor", list(x.shape), str(x.dtype)]
    if isinstance(x, np.ndarray):
        return ["array", list(x.shape), str(x.dtype)]
    if isinstance(x, torch.nn.Module):
        return [type(x).__name__,
                [[n, list(p.shape), str(p.dtype)]
                 for n, p in x.named_parameters()]]
    if isinstance(x, dict):
        return {str(k): _arg_sig(v) for k, v in sorted(x.items())}
    if isinstance(x, (list, tuple)):
        return [_arg_sig(v) for v in x]
    return type(x).__name__


def _param_leaves(state: Any) -> List[Tuple[tuple, str]]:
    params = getattr(state, "params", None)
    if params is None:
        return []
    from horovod_tpu_torch.utils import tree as tree_util
    tensors = (list(params.parameters())
               if isinstance(params, torch.nn.Module)
               else tree_util.tree_leaves(params))
    return [(tuple(t.shape), str(t.dtype)) for t in tensors
            if isinstance(t, torch.Tensor)]


def step_key_components(step_fn: Callable, args: Tuple[Any, ...]
                        ) -> Dict[str, Any]:
    """Key of a train step's manifest: the step's symbol and the shapes
    and dtypes of its arguments (the state's leaves and the first batch),
    the mesh, the program-keying knobs and, when the state has
    parameters, the gradient signature with the bucket size ``auto``
    resolves to.

    The JAX key also hashes the lowered program's text, so that an edit
    of the step's code misses. An eager step has no lowered text, and no
    stored artifact depends on its Python code: what the manifest names
    are kernel entries, and each is named by the digest of its kernel
    key, which hashes the kernel's source, headers and flags. A manifest
    whose digests no longer match the kernels' current keys is refused
    as stale (:func:`adopt_step`)."""
    fn = inspect.unwrap(step_fn)
    symbol = (f"{getattr(fn, '__module__', '?')}."
              f"{getattr(fn, '__qualname__', type(fn).__name__)}")
    argsig = hashlib.sha256(json.dumps(
        _arg_sig(list(args)), sort_keys=True).encode()).hexdigest()[:16]
    comps: Dict[str, Any] = {"step": f"{symbol}@{argsig}",
                             "mesh": mesh_fingerprint(),
                             "knobs": program_knob_fingerprint()}
    leaves = _param_leaves(args[0]) if args else []
    if leaves:
        from horovod_tpu_torch import autotune
        world = schedhooks.process_world()[1]
        gsig = autotune.grad_signature(leaves, world)
        comps["grad_signature"] = gsig
        if knobs.get("HOROVOD_GRADIENT_BUCKET_BYTES") == "auto":
            # the cache alone: a key neither warns nor talks to the ranks
            cached = autotune.bucket_cache_load().get(gsig)
            comps["resolved_bucket_bytes"] = int(
                cached if cached is not None
                else autotune.DEFAULT_BUCKET_BYTES)
    return comps


def _stale_kernels(manifest: Any) -> Optional[str]:
    """Why a step manifest no longer holds (None when it does)."""
    from horovod_tpu_torch.ops import _build
    kernels = manifest.get("kernels") if isinstance(manifest, dict) else None
    if not isinstance(kernels, dict):
        return "no kernel table"
    for name, digest in sorted(kernels.items()):
        if name not in _build.SOURCES:
            return f"unknown kernel {name!r}"
        if _build.kernel_key(name).digest != digest:
            return f"kernel {name} changed since the manifest"
    return None


def adopt_step(step_fn: Callable, args: Tuple[Any, ...], *,
               label: str = "train_step", kind: str = "step",
               extra_components: Optional[Dict[str, Any]] = None
               ) -> Tuple[Callable, str]:
    """Serve a step's kernels from the store before its first call.

    Hit: every kernel of the stored manifest is resolved (from the store,
    or the build directory) now, and ``step_fn`` comes back unchanged.
    Miss: the returned step runs its first call with a recorder on
    ``_build.load`` and publishes the manifest of the kernels it loaded.
    Outcomes: ``hit | miss | disabled | error``; never raises."""
    store = from_env()
    if store is None:
        return step_fn, "disabled"
    try:
        comps = step_key_components(step_fn, args)
        if extra_components:
            comps.update(extra_components)
        key = store.key(kind, **comps)
        manifest = store.load_blob(key, accept=_stale_kernels)
        if manifest is not None:
            from horovod_tpu_torch.ops import _build
            _build.build_all(sorted(manifest["kernels"]))
            logger.info("artifact store: %s's kernels served from %s "
                        "(key %s)", label, store.root, key.digest)
            return step_fn, "hit"
    except Exception as e:
        logger.warning("artifact store: %s not adopted (%s: %s); the step "
                       "runs as built", label, type(e).__name__, e)
        return step_fn, "error"
    return _recording_step(step_fn, store, key, label), "miss"


def _recording_step(step_fn: Callable, store: ArtifactStore, key: StoreKey,
                    label: str) -> Callable:
    """``step_fn`` whose first call records the kernels it loads and
    then publishes them as the manifest under ``key``."""
    from horovod_tpu_torch.ops import _build
    first = [True]

    @functools.wraps(step_fn)
    def step(*a, **kw):
        if not first:
            return step_fn(*a, **kw)
        first.clear()
        with _build.recording() as names:
            out = step_fn(*a, **kw)
        try:
            store.publish_blob(
                key, {"kernels": {n: _build.kernel_key(n).digest
                                  for n in sorted(names)}},
                extra_meta={"label": label})
        except Exception as e:
            logger.warning("artifact store: %s manifest not published "
                           "(%s: %s)", label, type(e).__name__, e)
        return out

    return step
