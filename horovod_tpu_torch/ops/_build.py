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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

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


def library_path(name: str) -> Path:
    src = CSRC / SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build every kernel in ``names`` (all by default) that is not built
    yet, one ``nvcc`` per source, all started together. Returns the
    seconds each build took (0.0 for one already built); raises with the
    compiler's output when any build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {n: 0.0 for n in names}
    todo = [n for n in names if not library_path(n).exists()]
    compiler = nvcc() if todo else None
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out, time.perf_counter())
    failed = []
    for n, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        build_logs[n] = log
        if proc.returncode != 0:
            failed.append(f"{n} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed, with
    its C signatures set."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.hvd_cuda_error_string.argtypes = [ctypes.c_int]
            lib.hvd_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
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
