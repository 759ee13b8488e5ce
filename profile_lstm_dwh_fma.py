#!/usr/bin/env python3
"""What bounds the f32 dwh kernel (``lstm_dwh_fma``,
``vistaocr_tpu_torch/csrc/lstm_bwd.cu``) on one NVIDIA GPU, by taking
work out of its inner loop.

    python3 profile_lstm_dwh_fma.py

Builds copies of ``csrc/lstm_bwd.cu`` into
``vistaocr_tpu_torch/_build/profile/`` (one nvcc each, all started
together), each with a part of the inner loop's work removed, and times
each beside the kernel as it stands and one f32 ``torch.mm`` a direction
(TF32 off), in turns, at B=32, T=512, H=512, both directions (CUDA
events after a warm-up):

- ``full``: the kernel as it stands (16 fragment values read from
  shared memory and 64 FMAs a thread a row);
- ``lds_once``: the fragments read once a 32-row stage and reused for
  its 32 rows (1/32 of the shared-memory reads, every FMA);
- ``fma_eighth``: 8 FMAs a thread a row, which still use all 16
  fragment values (every shared-memory read, 1/8 of the FMAs);
- ``neither``: both cuts (the copies, barriers, fold and stores left).

The copies compute wrong sums: they are timed only. Each cut is placed
by a text anchor in the source; an anchor that is missing (the kernel
changed) stops the script, as does an unchanged copy whose sums differ
from the library's. Prints a line a variant and a JSON line.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

B, T, H = 32, 512, 512
REPS = 20
TURNS = 2

# the fragment loads of a row k of the stage, and the row's FMAs
LOADS = """      const float4 a0 = *reinterpret_cast<const float4*>(a + k * 128);
      const float4 a1 = *reinterpret_cast<const float4*>(a + k * 128 + 64);
      const float4 c0 = *reinterpret_cast<const float4*>(c + k * 128);
      const float4 c1 = *reinterpret_cast<const float4*>(c + k * 128 + 64);
"""
FMAS = """#pragma unroll
      for (int ii = 0; ii < 8; ++ii)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[ii][j] = fmaf(av[ii], cv[j], acc[ii][j]);
"""
CUTS = {
    "lds_once": ((LOADS, LOADS.replace("k * 128", "0")),),
    "fma_eighth": ((FMAS, """#pragma unroll
      for (int ii = 0; ii < 8; ++ii)
        acc[ii][ii] = fmaf(av[ii], cv[ii], acc[ii][ii]);
"""),),
}
CUTS["neither"] = CUTS["lds_once"] + CUTS["fma_eighth"]
VARIANTS = ("full",) + tuple(CUTS)


def variant_source(src: str, name: str) -> str:
    for anchor, text in CUTS.get(name, ()):
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in lstm_bwd.cu: "
                               f"{anchor[:70]!r}")
        src = src.replace(anchor, text)
    return src


def build() -> dict:
    """One shared library a variant, built by parallel nvcc processes."""
    from vistaocr_tpu_torch.ops import _build

    out = os.path.join(_build.BUILD_DIR, "profile")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(_build.CSRC, "lstm_bwd.cu")) as f:
        src = f.read()
    libs, cmds = {}, []
    for name in VARIANTS:
        cu = os.path.join(out, f"lstm_bwd_{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(src, name))
        libs[name] = os.path.join(out, f"liblstm_bwd_{name}.so")
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                     _build.CSRC, "-o", libs[name], cu])
    _build._run_all(cmds)
    loaded = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        lib.vo_lstm_dwh.restype = i
        lib.vo_lstm_dwh.argtypes = [i] * 6 + [p, p, p, i] * 2 + [p, p]
        lib.vo_lstm_dwh_workspace.restype = ctypes.c_longlong
        lib.vo_lstm_dwh_workspace.argtypes = [i] * 6
        loaded[name] = lib
    return loaded


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_lstm_dwh_fma: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from vistaocr_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    libs = build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(H)
    ys = [torch.randn((T, B, H), generator=g, device=dev) * 0.5
          for _ in range(2)]
    dxw = [torch.randn((T, B, 4 * H), generator=g, device=dev) * 0.1
           for _ in range(2)]
    dwh = [torch.empty((H, 4 * H), device=dev) for _ in range(2)]
    R = (T - 1) * B

    def dwh_call(lib):
        nbytes = lib.vo_lstm_dwh_workspace(-1, 0, T, B, H, 2)
        work = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=dev)

        def call():  # the launcher zeroes the tickets
            args = [a for k in range(2) for a in (
                ys[k].data_ptr(), dxw[k].data_ptr(), dwh[k].data_ptr(), 0)]
            _build.check(lib.vo_lstm_dwh(
                -1, 0, T, B, H, 2, *args, work.data_ptr() if nbytes else None,
                torch.cuda.current_stream().cuda_stream), "vo_lstm_dwh")
        return call

    def mm():
        for k in range(2):
            torch.mm(ys[k][:-1].reshape(R, H).t(),
                     dxw[k][1:].reshape(R, 4 * H))

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(REPS):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / REPS

    from vistaocr_tpu_torch.ops import lstm_cuda

    calls = {n: dwh_call(lib) for n, lib in libs.items()}
    calls["full"]()  # the copy as it stands gives the library's bits
    same = all(torch.equal(a, b) for a, b in zip(dwh, lstm_cuda.lstm_dwh(
        [(ys[k], dxw[k], False) for k in range(2)], torch.float32)))
    if not same:
        raise RuntimeError("the unchanged copy disagrees with lstm_dwh")
    calls["torch_mm"] = mm
    times = {n: [] for n in calls}
    for turn in range(TURNS):
        order = list(calls) if turn % 2 == 0 else list(reversed(calls))
        for n in order:
            times[n].append(ms(calls[n]))
    bound = 2 * 2 * R * H * 4 * H / 67e12 * 1e3  # f32 FMAs at 67 TFLOP/s
    for n, v in times.items():
        print(f"lstm_dwh_fma {n} B={B} T={T} H={H}, both directions: "
              + " / ".join(f"{x:.4f}" for x in v)
              + f" ms (FMA bound {bound:.4f}) ({smi})", flush=True)
    print(json.dumps({"B": B, "T": T, "H": H, "bound_ms": bound,
                      "ms": times, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
