"""Builds the port's CUDA kernels from the sources in ``csrc/`` and
binds them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``build/horovod_tpu_torch/`` at the root of the
checkout, named by a hash of its source and flags, so an edited source
rebuilds and an unchanged one is built once. Nothing is built at import
time: the first launch builds, or :func:`build_all` builds every kernel
at once, one ``nvcc`` process per source, all started together.
:func:`launch` calls a kernel's C entry point on the current stream and
raises when the launch fails.

With ``HOROVOD_ARTIFACT_STORE`` set, these libraries are what the
compiled-artifact store holds (``store/artifact_store.py``, kind
``kernel``). :func:`build_all` resolves each library in turn:

1. one already in the build directory is used as it is, and published
   when the store lacks it, so a warm checkout fills a cold store;
2. else the store's entry is written into the build directory (a
   temporary sibling, then ``os.replace``), its sha256 checked first, and
   no ``nvcc`` runs;
3. else ``nvcc`` builds it, the seconds go to goodput's ``compile``
   phase, and the library is published with the build's seconds and the
   ``nvcc`` release in its header.

The kernel key (:func:`kernel_key`) is computed without ``nvcc``: the
source digest of :func:`library_path`, the kernel's name, torch's and its
CUDA's versions and the device's name and compute capability, but not
the world, so a world of four loads what one card published. Resolving
(the file exists) is apart from loading (``ctypes.CDLL``,
:func:`_open_library`). Ranks that miss together each build and publish
the same bytes; the store's rename makes the last one win.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "horovod_tpu_torch"
SOURCES = {"paged_decode": "paged_decode.cu", "flash_fwd": "flash_fwd.cu",
           "flash_bwd": "flash_bwd.cu", "conv_bn_fwd": "conv_bn_fwd.cu",
           "conv_bn_bwd": "conv_bn_bwd.cu", "stream_copy": "stream_copy.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# The kernels' dtype argument.
DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

_P, _I, _F, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
# C signatures per library, the stream last.
SIGNATURES = {
    "paged_decode": {"hvd_paged_decode": [_P] * 7 + [_I] * 7 + [_F, _I, _P]},
    "flash_fwd": {"hvd_flash_fwd": [_P] * 6 + [_I] * 7 + [_F, _I, _I, _P]},
    "flash_bwd": {
        "hvd_flash_bwd_dq": [_P] * 7 + [_I] * 7 + [_F, _I, _I, _P],
        "hvd_flash_bwd_dkv": [_P] * 8 + [_I] * 7 + [_F, _I, _I, _P]},
    "conv_bn_fwd": {"hvd_conv_bn_fwd": [_P] * 8 + [_I] * 7 + [_P]},
    "conv_bn_bwd": {"hvd_conv_bn_bwd": [_P] * 14 + [_I] * 10 + [_P]},
    "stream_copy": {"hvd_stream_copy": [_P, _P, _LL, _LL, _I, _P]},
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_logs: Dict[str, str] = {}
# nvcc builds this process has run (a serving engine counts the ones that
# ran while it was constructed and served its first decode step)
builds_run = 0
_count_lock = threading.Lock()
# how each library was last resolved in this process ("local": found in
# the build directory, "store": written from the artifact store,
# "built": nvcc) and the seconds that took (an nvcc build's, or reading
# and writing a store entry)
resolved: Dict[str, str] = {}
resolve_seconds: Dict[str, float] = {}
# the recorders of :func:`recording` (a step's first call)
_recorders: List[Set[str]] = []


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin/nvcc`` as PyTorch resolves
    ``CUDA_HOME``, else the one on ``PATH``. Raises when there is none."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (no $CUDA_HOME/bin/nvcc, none on PATH): the "
        "port's CUDA kernels are built from source at first use")


def source_digest(name: str) -> str:
    """Hash of a kernel's source, every header and the flags."""
    src = CSRC / SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{source_digest(name)}.so"


def kernel_key(name: str):
    """The artifact-store key of kernel ``name``'s library."""
    from horovod_tpu_torch.store import artifact_store as _store
    return _store.StoreKey(
        "kernel", {"kernel": name, "source": source_digest(name)},
        env=_store.env_fingerprint(world=False))


def nvcc_release(compiler: str) -> Optional[str]:
    """The ``release X.Y`` of ``nvcc --version``, or None."""
    try:
        out = subprocess.run([compiler, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    words = out.replace(",", " ").split()
    i = words.index("release") + 1 if "release" in words else len(words)
    return words[i] if i < len(words) else None


def _fetch(name: str, store, out: Path) -> bool:
    """Write the store's entry of ``name`` into the build directory (a
    temporary sibling, then one ``os.replace``); False on a miss. The
    payload's sha256 was checked against its header by the read."""
    t0 = time.perf_counter()
    entry = store.load_bytes(kernel_key(name))
    if entry is None:
        return False
    tmp = out.with_suffix(f".{os.getpid()}.store.tmp")
    tmp.write_bytes(entry[1])
    os.replace(tmp, out)
    resolved[name] = "store"
    resolve_seconds[name] = time.perf_counter() - t0
    return True


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Resolve every kernel in ``names`` (all by default): through the
    artifact store when it is on (module docstring), then build the rest,
    one ``nvcc`` per source, all started together. Returns the seconds
    each build took (0.0 for one not built here); raises with the
    compiler's output when any build fails."""
    global builds_run
    from horovod_tpu_torch.store import artifact_store as _store
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    store = _store.from_env()
    procs = {}
    seconds = {n: 0.0 for n in names}
    todo = []
    for n in names:
        out = library_path(n)
        if out.exists():
            resolved.setdefault(n, "local")
            if store is not None and not store.contains(kernel_key(n)):
                store.publish_bytes(kernel_key(n), out.read_bytes(),
                                    extra_meta={"kernel": n,
                                                "nvcc_release": None})
        elif store is None or not _fetch(n, store, out):
            todo.append(n)
    compiler = nvcc() if todo else None
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out, time.perf_counter())
    t_all = time.perf_counter()
    failed = []
    for n, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        build_logs[n] = log
        if proc.returncode != 0:
            failed.append(f"{n} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        resolved[n] = "built"
        resolve_seconds[n] = seconds[n]
        with _count_lock:
            builds_run += 1
    if procs:
        from horovod_tpu_torch.goodput import accountant as _goodput
        _goodput.carve(_goodput.COMPILE, time.perf_counter() - t_all)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    if store is not None and procs:
        release = nvcc_release(compiler)
        for n in procs:
            store.publish_bytes(kernel_key(n), library_path(n).read_bytes(),
                                compile_seconds=seconds[n],
                                extra_meta={"kernel": n,
                                            "nvcc_release": release})
    return seconds


def resolve(name: str) -> str:
    """Make kernel ``name``'s library exist in the build directory,
    without loading it; returns how: ``local`` (it was there), ``store``
    (the artifact store's entry was written) or ``built`` (nvcc)."""
    was_there = library_path(name).exists()
    build_all([name])
    return "local" if was_there else resolved[name]


@contextlib.contextmanager
def recording():
    """Collect the names of the kernels :func:`load` is asked for, from
    every thread (autograd's backward launches from its own), while the
    ``with`` body runs."""
    names: Set[str] = set()
    with _lock:
        _recorders.append(names)
    try:
        yield names
    finally:
        with _lock:
            _recorders.remove(names)


def _open_library(path: Path, name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.hvd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hvd_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed, with
    its C signatures set."""
    with _lock:
        for names in _recorders:
            names.add(name)
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = _libs[name] = _open_library(library_path(name), name)
        return lib


def launch(name: str, fn: str, device: torch.device, *args) -> None:
    """Call ``fn`` of library ``name`` on the device's current stream;
    raises when the launch fails."""
    lib = load(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err:
        msg = lib.hvd_cuda_error_string(err).decode()
        raise RuntimeError(f"{fn} kernel launch failed: {msg} "
                           f"(cudaError {err})")


def check_cuda(fn: str, tensors: Sequence[torch.Tensor], plain: str) -> None:
    """Raise unless every tensor is a 16-byte aligned CUDA tensor on one
    device; ``plain`` names the plain version for CPU tensors."""
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{fn} takes CUDA tensors only; the plain version "
                         f"for CPU tensors is {plain}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{fn}: tensors on different devices")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{fn}: tensors must be 16-byte aligned")
