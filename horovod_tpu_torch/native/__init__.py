"""ctypes bindings of the port's native runtime core (``csrc/core.cc``).

The counterpart of ``horovod_tpu/native/__init__.py``: one shared library
of host C++, built at first use with ``g++`` from the port's own copy of
``core.cc`` and loaded with ``ctypes``. It lands in
``build/horovod_tpu_torch/`` at the root of the checkout, named by a hash
of its source and flags (as ``ops/_build.py`` names the CUDA kernels), so
an edited source rebuilds and an unchanged one is built once. Several
processes starting together on a fresh checkout build it once: the build
runs under an inter-process lock and ends with an atomic rename, so no
process loads a half-written library.

Components (consumers in parentheses):

- the fusion bin planner (``ops.fusion.plan_fusion_bins``, every cycle of
  ``ops/coordinator.py``);
- the chrome-trace writer (``timeline.Timeline``'s writer);
- the segment pack (:func:`pack_arrays`, ``np.stack`` of equal arrays
  with a parallel ``memcpy``; the port has no per-rank lists to stage,
  since each rank passes its own tensor).

``HOROVOD_TPU_NATIVE=0`` selects the Python planner and writer: every
binding then returns None (or ``available()`` False) and the caller takes
its Python version. With the knob on (the default) a build or load that
fails raises with the compiler's message; the port never falls back to
the Python versions in silence (the JAX package does, ROADMAP C).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = CSRC / "core.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "horovod_tpu_torch"
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-pthread", "-Wall", "-Wextra",
            "-shared"]
_ABI_VERSION = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def _enabled() -> bool:
    from horovod_tpu_torch.config import knobs
    return bool(knobs.get("HOROVOD_TPU_NATIVE"))


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    return BUILD_DIR / f"libhvdcore-{h.hexdigest()[:16]}.so"


def _compiler() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"the native core is built with {cxx!r}, which "
                           f"is not on PATH")
    return found


def build() -> Path:
    """Build the library unless it is built; returns its path. Raises
    with the compiler's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libhvdcore.lock", "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        if out.exists():                # another process built it meanwhile
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_compiler(), *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"native core build failed (g++ exit {proc.returncode}):\n"
                + (proc.stderr or proc.stdout).strip()[-4000:])
        os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> None:
    lib.hvd_native_abi_version.restype = ctypes.c_int32
    if lib.hvd_native_abi_version() != _ABI_VERSION:
        raise RuntimeError("native core ABI version mismatch")
    lib.hvd_plan_fusion_bins.restype = ctypes.c_int32
    lib.hvd_plan_fusion_bins.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int32, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32)]
    lib.hvd_timeline_open.restype = ctypes.c_void_p
    lib.hvd_timeline_open.argtypes = [ctypes.c_char_p, ctypes.c_int32,
                                      ctypes.c_int64]
    lib.hvd_timeline_event.restype = None
    lib.hvd_timeline_event.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char,
        ctypes.c_double, ctypes.c_int32, ctypes.c_char_p]
    lib.hvd_timeline_dropped.restype = ctypes.c_int64
    lib.hvd_timeline_dropped.argtypes = [ctypes.c_void_p]
    lib.hvd_timeline_close.restype = None
    lib.hvd_timeline_close.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.hvd_pack_segments.restype = None
    lib.hvd_pack_segments.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32]


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library; None under HOROVOD_TPU_NATIVE=0. A failed build
    or load raises, now and at every later call."""
    global _lib, _error
    if not _enabled():
        return None
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        try:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
        except (OSError, AttributeError, RuntimeError,
                subprocess.TimeoutExpired) as exc:
            _error = str(exc)
            raise RuntimeError(_error) from exc
        _lib = lib
        return _lib


def available() -> bool:
    """True when the library is in use; False under HOROVOD_TPU_NATIVE=0.
    Raises when it is on and the library fails to build or load."""
    return _load() is not None


def status() -> dict:
    """What the native core is doing, for logs: never raises (a build
    error is reported under ``build_error``)."""
    try:
        lib = _load()
    except RuntimeError:
        lib = None
    return {"available": lib is not None,
            "path": str(library_path()) if lib is not None else None,
            "enabled": _enabled(), "build_error": _error}


# ---------------------------------------------------------------------------
# fusion planner
# ---------------------------------------------------------------------------

def plan_fusion_bins(sizes_bytes: Sequence[int],
                     threshold: int) -> Optional[List[List[int]]]:
    """The native greedy bin planner (the bins of
    ``ops.fusion._plan_fusion_bins_py``); None under
    HOROVOD_TPU_NATIVE=0."""
    lib = _load()
    if lib is None:
        return None
    n = len(sizes_bytes)
    if n == 0:
        return []
    sizes = (ctypes.c_int64 * n)(*[int(s) for s in sizes_bytes])
    out = (ctypes.c_int32 * n)()
    n_bins = lib.hvd_plan_fusion_bins(sizes, n, int(threshold), out)
    bins: List[List[int]] = [[] for _ in range(n_bins)]
    for i in range(n):
        bins[out[i]].append(i)
    return bins


# ---------------------------------------------------------------------------
# timeline writer
# ---------------------------------------------------------------------------

class NativeTimelineWriter:
    """Chrome-trace writer whose serialization and file IO run on a C++
    thread (ref TimelineWriter timeline.cc:150): B/E/i events, one per
    line, the array closed by :meth:`close`."""

    def __init__(self, path: str, pid: int, capacity: int = 1 << 16):
        lib = _load()
        if lib is None:
            raise RuntimeError("the native core is off (HOROVOD_TPU_NATIVE=0)")
        self._lib = lib
        self._handle = lib.hvd_timeline_open(path.encode(), int(pid),
                                             int(capacity))
        if not self._handle:
            raise OSError(f"cannot open timeline file {path!r}")

    def event(self, name: str, cat: str, ph: str, ts_us: float,
              tid: int = 0, args_json: Optional[str] = None) -> None:
        self._lib.hvd_timeline_event(
            self._handle, name.encode(), cat.encode() if cat else None,
            ph.encode()[:1], float(ts_us), int(tid),
            args_json.encode() if args_json else None)

    @property
    def dropped(self) -> int:
        return int(self._lib.hvd_timeline_dropped(self._handle))

    def close(self, end_ts_us: float) -> None:
        if self._handle:
            self._lib.hvd_timeline_close(self._handle, float(end_ts_us))
            self._handle = None


# ---------------------------------------------------------------------------
# segment pack
# ---------------------------------------------------------------------------

def pack_arrays(arrays: Sequence[np.ndarray],
                num_threads: int = 0) -> Optional[np.ndarray]:
    """``np.stack`` of equal-shape, equal-dtype C-contiguous arrays by a
    parallel ``memcpy``; None when the core is off or the arrays do not
    qualify (the caller then stacks them itself)."""
    lib = _load()
    if lib is None or not arrays:
        return None
    first = arrays[0]
    if not all(isinstance(a, np.ndarray) and a.shape == first.shape
               and a.dtype == first.dtype and a.flags.c_contiguous
               and not a.dtype.hasobject      # raw memcpy of PyObject*
               for a in arrays):              # would corrupt refcounts
        return None
    n = len(arrays)
    out = np.empty((n,) + first.shape, dtype=first.dtype)
    srcs = (ctypes.c_void_p * n)(
        *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrays])
    sizes = (ctypes.c_int64 * n)(*([first.nbytes] * n))
    lib.hvd_pack_segments(srcs, sizes, n,
                          out.ctypes.data_as(ctypes.c_void_p),
                          int(num_threads))
    return out
