#!/usr/bin/env python3
"""Where a frame of the f32-weight LSTM forward (``lstm_fwd_grid``,
``vistaocr_tpu_torch/csrc/lstm_fwd.cu``) goes, on one NVIDIA GPU.

    python3 profile_lstm_fwd.py

Builds a copy of ``csrc/lstm_fwd.cu`` with ``clock64`` stamps around
each phase of the kernel's frame loop (in CTA (0, 0), thread 0) into
``vistaocr_tpu_torch/_build/profile/``, runs the ``save_cell`` form of
both directions at H=512 and the train buckets' (B, T), and prints the
microseconds a frame spent in each phase:

- spin: waiting for every CTA of the direction to release h(t-1)
  (the frame counter's acquire and the CTA barrier after it);
- wait: waiting for a ring stage's bulk copy of h(t-1) to land;
- issue: issuing the bulk copies (the first ring stages included);
- product: the f32 FMA product of the stages;
- epilogue: the split partial sums, the barrier, the cell update and
  the stores of a tile;
- prefetch: loading a tile's xw, mask, c and h(t-1) of the thread's cells;
- release: releasing the frame counter;
- frame: the whole frame (the phases, the loop and the stamps).

The stamps cost a little time themselves; the call's CUDA-event time is
printed beside the uninstrumented kernel's. Each stamp is placed by a
text anchor in the source; an anchor that is missing (the kernel
changed) stops the script.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

PHASES = ("spin", "wait", "issue", "product", "epilogue", "release",
          "frame", "prefetch")
SHAPES = ((32, 512), (64, 256), (128, 128), (512, 32))  # (B, T), H=512

# (anchor, text put in its place): the stamps, P[i] += cycles of PHASES[i]
STAMPS = (
    ("constexpr int GTHREADS = 256;",
     "__device__ unsigned long long vo_prof[16];\n"
     "constexpr int GTHREADS = 256;"),
    ("  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;\n"
     "  const int Hp",
     "  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;\n"
     "  long long P[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  unsigned long long g0;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g0));\n"
     "  const int Hp"),
    ("    const int t = d.reverse ? T - 1 - step : step;\n"
     "    const float* cur",
     "    const long long c0 = clock64();\n"
     "    const int t = d.reverse ? T - 1 - step : step;\n"
     "    const float* cur"),
    ("      __syncthreads();\n    }\n    // the warp's stage q",
     "      __syncthreads();\n    }\n    P[0] += clock64() - c0;\n"
     "    // the warp's stage q"),
    ("      if (lane == 0) fence_proxy_async_global();\n"
     "      for (int q = 0; q < GSTAGES - 1; ++q) issue(q);",
     "      const long long i0 = clock64();\n"
     "      if (lane == 0) fence_proxy_async_global();\n"
     "      for (int q = 0; q < GSTAGES - 1; ++q) issue(q);\n"
     "      P[2] += clock64() - i0;"),
    ("      if (sc == 0) {\n#pragma unroll\n        for (int r = 0; r < 8; ++r)",
     "      const long long z0 = clock64();\n"
     "      if (sc == 0) {\n#pragma unroll\n        for (int r = 0; r < 8; ++r)"),
    ("      if (active) {\n        const int slot = (done + q) % GSTAGES;\n",
     "      P[7] += clock64() - z0;\n      long long a2 = 0;\n"
     "      if (active) {\n        const long long a0 = clock64();\n"
     "        const int slot = (done + q) % GSTAGES;\n"),
    ("        __syncwarp();  // the whole warp is past stage q - 1: reuse its "
     "slot\n        issue(q + GSTAGES - 1);",
     "        __syncwarp();\n        const long long a1 = clock64();\n"
     "        P[1] += a1 - a0;\n        issue(q + GSTAGES - 1);\n"
     "        a2 = clock64();\n        P[2] += a2 - a1;"),
    ("      if (sc != nsc - 1) continue;",
     "      if (active) P[3] += clock64() - a2;\n"
     "      if (sc != nsc - 1) continue;\n"
     "      const long long e0 = clock64();"),
    ("      // and stored its h (the frame's release follows the last tile)\n"
     "      __syncthreads();\n    }",
     "      // and stored its h (the frame's release follows the last tile)\n"
     "      __syncthreads();\n      P[4] += clock64() - e0;\n    }"),
    ("    if (tid == 0 && step + 1 < T) {\n"
     "      asm volatile(\"red.release.gpu.global.add.u32 [%0], 1;\\n\"\n"
     "                   :: \"l\"(d.count) : \"memory\");\n    }\n  }\n}",
     "    const long long r0 = clock64();\n"
     "    if (tid == 0 && step + 1 < T) {\n"
     "      asm volatile(\"red.release.gpu.global.add.u32 [%0], 1;\\n\"\n"
     "                   :: \"l\"(d.count) : \"memory\");\n    }\n"
     "    P[5] += clock64() - r0;\n    P[6] += clock64() - c0;\n  }\n"
     "  unsigned long long g1;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g1));\n"
     "  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) {\n"
     "    for (int i = 0; i < 8; ++i) vo_prof[i] = P[i];\n"
     "    vo_prof[8] = g1 - g0;\n  }\n}"),
)

READER = """
extern "C" int vo_prof_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, vo_prof, sizeof(unsigned long long) * 16));
}
"""


def instrumented_source(src: str) -> str:
    for anchor, text in STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in lstm_fwd.cu: "
                               f"{anchor[:70]!r}")
        src = src.replace(anchor, text)
    return src + READER


def build() -> ctypes.CDLL:
    from vistaocr_tpu_torch.ops import _build

    out = os.path.join(_build.BUILD_DIR, "profile")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(_build.CSRC, "lstm_fwd.cu")) as f:
        src = instrumented_source(f.read())
    cu = os.path.join(out, "lstm_fwd_profile.cu")
    with open(cu, "w") as f:
        f.write(src)
    lib = os.path.join(out, "liblstm_fwd_profile.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                    "-I", _build.CSRC, "-o", lib, cu], check=True)
    return ctypes.CDLL(lib)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_lstm_fwd: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from vistaocr_tpu_torch.ops import _build, lstm_cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    lib = build()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vo_lstm_fwd_named.restype = i
    lib.vo_lstm_fwd_named.argtypes = ([i] * 6 + [p] + [p, p, p, p, p, i] * 2
                                      + [p])
    lib.vo_lstm_fwd_scratch.restype = ctypes.c_longlong
    lib.vo_lstm_fwd_scratch.argtypes = [i, i]
    lib.vo_prof_read.argtypes = [p]
    dev, H = torch.device("cuda"), 512
    for B, T in SHAPES:
        g = torch.Generator(device=dev).manual_seed(B)
        mask = torch.ones((T, 1, B), device=dev)
        xw = [torch.randn((T, B, 4 * H), generator=g, device=dev)
              for _ in range(2)]
        wh = [torch.randn((H, 4 * H), generator=g, device=dev) / H ** 0.5
              for _ in range(2)]

        def call():
            ys = [torch.empty((T, B, H), device=dev) for _ in range(2)]
            cs = [torch.empty((T, B, H), device=dev) for _ in range(2)]
            sc = [torch.zeros(lib.vo_lstm_fwd_scratch(B, H), device=dev)
                  for _ in range(2)]
            args = [a for k in range(2) for a in (
                xw[k].data_ptr(), wh[k].data_ptr(), ys[k].data_ptr(),
                cs[k].data_ptr(), sc[k].data_ptr(), k)]
            _build.check(lib.vo_lstm_fwd_named(  # 1: lstm_fwd_grid
                1, 0, T, B, H, 2, mask.data_ptr(), *args,
                torch.cuda.current_stream().cuda_stream), "instrumented")

        def ms(fn, reps=5):
            fn()
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            torch.cuda.synchronize()
            return a.elapsed_time(b) / reps

        plain = ms(lambda: lstm_cuda.lstm_fwd(
            [(xw[0], wh[0], False), (xw[1], wh[1], True)], mask,
            torch.float32, save_cell=True, design="grid"))
        stamped = ms(call)
        out = (ctypes.c_ulonglong * 16)()
        _build.check(lib.vo_prof_read(ctypes.addressof(out)), "read")
        ghz = out[6] / out[8]  # frame cycles over the kernel's nanoseconds
        us = {n: out[k] / T / ghz / 1e3 for k, n in enumerate(PHASES)}
        print(f"lstm_fwd_grid B={B} T={T} H={H} save_cell, both directions: "
              f"{stamped:.3f} ms a call stamped ({plain:.3f} unstamped), "
              f"SM clock {ghz:.3f} GHz; us a frame: " + ", ".join(
                  f"{n} {v:.3f}" for n, v in us.items()) + f" ({smi})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
