"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``*.cu`` under ``vistaocr_tpu_torch/csrc/`` is compiled to an
object file, all of them by parallel nvcc processes, and the objects are
linked into one shared library with a plain C interface (no PyTorch
headers, so a build takes seconds, not minutes), at first use, into
``vistaocr_tpu_torch/_build/`` under a name keyed by a hash of the
sources, the headers (``*.cuh``) and the flags. A failed build raises
with nvcc's stderr; there is no soft path that carries on without the
kernels.

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
    "-Xcompiler", "-fPIC",
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
    for src in sorted(sources() + glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libvo_kernels_{h.hexdigest()[:16]}.so")


def _run_all(cmds) -> None:
    """Run the commands in parallel; raise with the first failure's
    stderr after all of them have ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    errors = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{err}")
    if errors:
        raise RuntimeError("\n".join(errors))


def _compile(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = f"{out}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [f"{stem}.{os.path.basename(src)}.o" for src in sources()]
    _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
              for src, obj in zip(sources(), objs)])
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", f"{stem}.tmp", *objs]])
    for obj in objs:
        os.remove(obj)
    os.replace(f"{stem}.tmp", out)


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vo_lstm_fwd.restype = i
    lib.vo_lstm_fwd.argtypes = [
        i, i, i, i, i,  # type_code, T, B, H, ndir
        p,  # mask
        p, p, p, p, p, i,  # direction 0: xw, wh, ys, cs, scratch, reverse
        p, p, p, p, p, i,  # direction 1
        p,  # stream
    ]
    lib.vo_lstm_fwd_named.restype = i
    lib.vo_lstm_fwd_named.argtypes = [i] + lib.vo_lstm_fwd.argtypes  # design
    lib.vo_lstm_fwd_design.restype = i
    lib.vo_lstm_fwd_design.argtypes = [i, i, i, i]  # type_code, B, H, ndir
    lib.vo_lstm_fwd_scratch.restype = ctypes.c_longlong
    lib.vo_lstm_fwd_scratch.argtypes = [i, i]  # B, H
    lib.vo_lstm_bwd_named.restype = i
    lib.vo_lstm_bwd_named.argtypes = [
        i, i,  # gemm, loop
        i, i, i, i, i,  # type_code, T, B, H, ndir
        p,  # mask
        # direction 0: xw, wh, wh in f32, ys, cs, dys, dxw, scratch, reverse
        p, p, p, p, p, p, p, p, i,
        p, p, p, p, p, p, p, p, i,  # direction 1
        p,  # stream
    ]
    lib.vo_lstm_bwd_loop_design.restype = i
    lib.vo_lstm_bwd_loop_design.argtypes = [i, i, i, i]  # type_code, B, H, ndir
    lib.vo_lstm_bwd_persistent_plan.restype = i
    lib.vo_lstm_bwd_persistent_plan.argtypes = [i, i, i, i, p]  # type_code, B, H, ndir, out[3]
    lib.vo_lstm_bwd_scratch.restype = ctypes.c_longlong
    lib.vo_lstm_bwd_scratch.argtypes = [i, i, i, i]  # loop, T, B, H
    lib.vo_lstm_bwd_gates_design.restype = i
    lib.vo_lstm_bwd_gates_design.argtypes = [i, i]  # type_code, H
    lib.vo_lstm_dwh.restype = i
    lib.vo_lstm_dwh.argtypes = [
        i, i, i, i, i, i,  # design, type_code, T, B, H, ndir
        p, p, p, i,  # direction 0: ys, dxw, dwh, reverse
        p, p, p, i,  # direction 1
        p,  # workspace
        p,  # stream
    ]
    lib.vo_lstm_dwh_workspace.restype = ctypes.c_longlong
    lib.vo_lstm_dwh_workspace.argtypes = [i, i, i, i, i, i]  # design, type_code, T, B, H, ndir
    lib.vo_lstm_dwh_design.restype = i
    lib.vo_lstm_dwh_design.argtypes = [i, i]  # type_code, H
    lib.vo_ctc_alpha.restype = i
    lib.vo_ctc_alpha.argtypes = [
        i, i, i,  # T, B, S
        p, p, p, p, p,  # lp, active, skip, svalid, alphas
        p,  # stream
    ]
    lib.vo_ctc_beta.restype = i
    lib.vo_ctc_beta.argtypes = [
        i, i, i,  # T, B, S
        # lp, active, islast, skip2, svalid, terminal, alphas, logp, dlp
        p, p, p, p, p, p, p, p, p,
        p,  # stream
    ]
    lib.vo_bi_lstm_fwd.restype = i
    lib.vo_bi_lstm_fwd.argtypes = [
        i, i, i, i,  # w_type, T, B, H
        p, p, p, p, p,  # xw, mask, wh, ys, cs
        p,  # stream
    ]
    lib.vo_bi_lstm_bwd.restype = i
    lib.vo_bi_lstm_bwd.argtypes = [
        i, i, i, i,  # w_type, T, B, H
        p, p, p, p, p, p,  # xw, mask, wh, ys, cs, dys
        p, p, p,  # dxw, dwh, scratch
        p,  # stream
    ]
    f = ctypes.c_float
    lib.vo_int8_quantize.restype = i
    lib.vo_int8_quantize.argtypes = [
        i, ctypes.c_longlong,  # type_code, n
        p, f, p,  # x, inv_s, y
        p,  # stream
    ]
    lib.vo_int8_conv_design.restype = i
    lib.vo_int8_conv_design.argtypes = [i, i, i, i, i]  # CI, CO, out_code, ph, pw
    lib.vo_int8_conv_fused.restype = i
    lib.vo_int8_conv_fused.argtypes = [
        i, i, i, i,  # design, in_code, round_bf, out_code
        i, i, i, i, i, i,  # B, H, W, CI, CO, KP
        i, i, i,  # ph, pw, pool_stride
        p, p, p, p,  # x, wq, scale, bias
        f, f,  # inv_s, inv_next
        p,  # y
        p,  # stream
    ]
    lib.vo_stem_partials.restype = ctypes.c_longlong
    lib.vo_stem_partials.argtypes = [i, i, i]  # B, H, W
    lib.vo_stem_fwd.restype = i
    lib.vo_stem_fwd.argtypes = [
        i, i, i, i, i,  # type_code, B, H, W, CO
        i, i,  # standardize, vec
        p, p, p, p, p, p,  # images, widths, kernel, stats, out, xn
        p,  # stream
    ]
    lib.vo_stem_dk.restype = i
    lib.vo_stem_dk.argtypes = [
        i, i, i, i, i, i,  # type_code, B, H, W, CO, vec
        p, p, p, p,  # xn, dout, partial, dk
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
