"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``*.cu`` under ``vistaocr_tpu_torch/csrc/`` is compiled into one
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes), at first use, into
``vistaocr_tpu_torch/_build/`` under a name keyed by a hash of the
sources and flags. A failed build raises with nvcc's stderr; there is no
soft path that carries on without the kernels.

Pointers and the stream cross the C boundary as ``ctypes.c_void_p``
(``tensor.data_ptr()``, ``torch.cuda.current_stream().cuda_stream``);
each C entry point returns ``cudaGetLastError()`` after its launches,
and ``check`` raises on a non-zero value.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"  # the toolkit's standard location
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels cannot be built"
    )


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libvo_kernels_{h.hexdigest()[:16]}.so")


def _compile(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stderr}"
        )
    os.replace(tmp, out)


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vo_lstm_fwd.restype = i
    lib.vo_lstm_fwd.argtypes = [
        i, i, i, i, i,  # type_code, T, B, H, ndir
        p,  # mask
        p, p, p, p, i,  # direction 0: xw, wh, ys, scratch, reverse
        p, p, p, p, i,  # direction 1
        p,  # stream
    ]


def load():
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _compile(path)
            lib = ctypes.CDLL(path)
            _bind(lib)
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
