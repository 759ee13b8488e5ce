#!/usr/bin/env python3
"""Where the time of F2's frame loop (``lstm_bwd_tc``,
``vistaocr_tpu_torch/csrc/lstm_bwd.cu``) goes on one NVIDIA GPU, by
taking work out of copies of the kernel and by clock64 stamps.

    python3 profile_lstm_bwd_tc.py [--batches 32,64,128,512]

Builds copies of ``csrc/lstm_bwd.cu`` into
``vistaocr_tpu_torch/_build/profile/`` (one nvcc each, all started
together) and times each copy's ``lstm_bwd_tc`` (device time a launch,
``torch.profiler``) in turns with the kernel as it stands, at H=1000,
both directions, bf16 streams and weights, every row valid, B = 32, 64,
128 and 512 with T = 16384 / B, behind the wide gate GEMM:

- ``full``: the kernel as it stands (clusters of two CTAs, each dg chunk
  brought once a pair by a multicast bulk copy);
- ``no_multicast``: clusters of one, each CTA bringing every chunk
  itself;
- ``release_cluster``: a CTA frees a stage with ``mbarrier.arrive`` at
  cluster scope with release semantics (the instruction waits for the
  thread's earlier global loads) instead of the default;
- ``tiny_dg_copies``: each chunk's copy cut to its first 16 bytes (the
  ring's protocol stays whole; the product reads stale shared memory);
- ``half_dg_copies``: each chunk's first half of the rows copied;
- ``clusters_of_four``: each chunk brought once for four CTAs (the
  library's launcher refuses it where the card cannot hold every cluster
  at once; the refusal is printed);
- ``stamps``: the kernel with clock64 stamps, cycles a frame by phase
  (the frame counter's wait, the product with its waits for chunks, the
  partial sums, the cell backward, the release), the most over the
  warps of CTAs 0 and N-1 of direction 0.

The cut copies compute wrong dxw: they are timed only. Each edit is
placed by a text anchor in the source; an anchor that is missing (the
kernel changed) stops the script, as does a ``full`` or ``stamps`` copy
whose dxw differs from the library's. Prints a line a variant and
shape, and a JSON line.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

H = 1000
ROWS = 16384  # B * T
BATCHES = (32, 64, 128, 512)
TURNS = 2
REPS = 3

POST_COPY = ("      bulk_load_multicast(ring + (sl * XSTAGES + st) * XCHUNK,\n"
             "                          cur + ((long long)q * XSL + sl) * "
             "sbytes +\n"
             "                              (long long)c * XROWS * XPITCH,\n"
             "                          bytes, bar, (1u << XCL) - 1);\n")
ROWS_COPIED = ("          min(XROWS, B - q * XROWS) * (c == nch - 1 ? plast "
               ": XPITCH);\n")
ARRIVE = "              mbar_arrive_cluster(empty0 + 8 * st);\n"
CUTS = {
    "no_multicast": (
        ("constexpr int XCL = 2;", "constexpr int XCL = 1;"),
        (POST_COPY, POST_COPY.replace("bulk_load_multicast", "bulk_load")
         .replace(", (1u << XCL) - 1);", ");"))),
    "release_cluster": ((ARRIVE, ARRIVE.replace(
        "mbar_arrive_cluster(empty0 + 8 * st);",
        'asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64'
        ' _, [%0];" :: "r"(empty0 + 8 * st) : "memory");')),),
    "tiny_dg_copies": ((ROWS_COPIED, "          16u;\n"),),
    "half_dg_copies": ((ROWS_COPIED, ROWS_COPIED.replace(
        "min(XROWS, B - q * XROWS)", "(min(XROWS, B - q * XROWS) + 1) / 2")),),
    "clusters_of_four": (("constexpr int XCL = 2;", "constexpr int XCL = 4;"),),
}

# the stamps: P[i] += cycles of STAMP_PHASES[i] in every warp; lane 0 of
# each warp of CTAs 0 and N-1 of direction 0 keeps the most over warps
STAMP_PHASES = ("counter_wait", "product", "chunk_waits", "partials",
                "cell_backward_and_release", "frame")
STAMPS = (
    ("template <typename S>\nstruct TcBwdDir {",
     "__device__ unsigned long long vo_prof[16];\n"
     "template <typename S>\nstruct TcBwdDir {"),
    ("  int used = 0;  // chunks this warp took before this frame (ring "
     "phases)\n",
     "  int used = 0;  // chunks this warp took before this frame (ring "
     "phases)\n  long long P[6] = {0, 0, 0, 0, 0, 0};\n"),
    ("    const int t = d.reverse ? step : T - 1 - step;\n",
     "    const long long c0 = clock64();\n"
     "    const int t = d.reverse ? step : T - 1 - step;\n"),
    ("    for (int q = 0; q < nq; ++q) {\n      const int b0 = q * XROWS;\n",
     "    P[0] += clock64() - c0;\n"
     "    for (int q = 0; q < nq; ++q) {\n      const long long q0 = clock64();\n"
     "      long long w0 = 0;\n      const int b0 = q * XROWS;\n"),
    ("            grid_wait(&full[sl * XSTAGES + st], (seq / XSTAGES) & 1);\n",
     "            const long long wa = clock64();\n"
     "            grid_wait(&full[sl * XSTAGES + st], (seq / XSTAGES) & 1);\n"
     "            w0 += clock64() - wa;\n"),
    ("        // the slice's partial sums: c0,c1 at",
     "        P[1] += clock64() - q0;\n        P[2] += w0;\n"
     "        const long long r0 = clock64();\n"
     "        // the slice's partial sums: c0,c1 at"),
    ("          dhp[e] = sum;\n        }\n      }\n",
     "          dhp[e] = sum;\n        }\n        P[3] += clock64() - r0;\n"
     "      }\n      const long long e0 = clock64();\n"),
    ("      if (last) store();\n    }\n",
     "      if (last) store();\n      P[4] += clock64() - e0;\n    }\n"
     "    P[5] += clock64() - c0;\n"),
    ("  // no CTA leaves while its peer may still arrive on its barriers\n",
     "  if (lane == 0 && blockIdx.y == 0 && (blockIdx.x == 0 ||\n"
     "                                      blockIdx.x == gridDim.x - 1)) {\n"
     "    for (int i = 0; i < 6; ++i) {\n"
     "      atomicMax(&vo_prof[(blockIdx.x == 0 ? 0 : 8) + i],\n"
     "                static_cast<unsigned long long>(P[i]));\n    }\n  }\n"
     "  // no CTA leaves while its peer may still arrive on its barriers\n"),
    ('extern "C" int vo_lstm_bwd_loop_design(',
     'extern "C" int vo_prof_swap(unsigned long long* out) {\n'
     '  static const unsigned long long zero[16] = {};\n'
     '  const cudaError_t err = cudaMemcpyFromSymbol(out, vo_prof,\n'
     '                                               sizeof(zero));\n'
     '  return static_cast<int>(err != cudaSuccess ? err\n'
     '      : cudaMemcpyToSymbol(vo_prof, zero, sizeof(zero)));\n}\n\n'
     'extern "C" int vo_lstm_bwd_loop_design('),
)
VARIANTS = ("full",) + tuple(CUTS) + ("stamps",)


def variant_source(src: str, name: str) -> str:
    edits = STAMPS if name == "stamps" else CUTS.get(name, ())
    for anchor, text in edits:
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
        cu = os.path.join(out, f"lstm_bwd_tc_{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(src, name))
        libs[name] = os.path.join(out, f"liblstm_bwd_tc_{name}.so")
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                     _build.CSRC, "-o", libs[name], cu])
    _build._run_all(cmds)
    loaded = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        lib.vo_lstm_bwd_named.restype = i
        lib.vo_lstm_bwd_named.argtypes = [i] * 7 + [p] + (
            [p] * 8 + [i]) * 2 + [p]
        lib.vo_lstm_bwd_scratch.restype = ctypes.c_longlong
        lib.vo_lstm_bwd_scratch.argtypes = [i] * 4
        loaded[name] = lib
    return loaded


def main(argv) -> int:
    import argparse

    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default=",".join(map(str, BATCHES)))
    batches = [int(b) for b in ap.parse_args(argv).batches.split(",")]
    if not torch.cuda.is_available():
        print("profile_lstm_bwd_tc: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from vistaocr_tpu_torch.ops import _build, lstm_cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    libs = build()
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    prof = (ctypes.c_ulonglong * 16)()
    results = {}
    for B in batches:
        T = ROWS // B
        g = torch.Generator(device=dev).manual_seed(B)

        def rnd(*shape, scale=1.0):
            return (torch.randn(shape, generator=g, device=dev) * scale).to(
                bf16)

        dirs = [(rnd(T, B, 4 * H), rnd(H, 4 * H, scale=H ** -0.5),
                 rnd(T, B, H, scale=0.5), rnd(T, B, H), rnd(T, B, H), r)
                for r in (False, True)]
        mask = torch.ones(T, 1, B, device=dev)
        loop = lstm_cuda.LOOP_DESIGNS.index("tc")
        nbytes = libs["full"].vo_lstm_bwd_scratch(loop, T, B, H)
        scratch = [torch.empty(nbytes // 4, device=dev) for _ in dirs]
        dxw = [torch.empty_like(d[0]) for d in dirs]
        args = [a for k, (xw, wh, ys, cs, dys, rev) in enumerate(dirs)
                for a in (xw.data_ptr(), wh.data_ptr(), wh.data_ptr(),
                          ys.data_ptr(), cs.data_ptr(), dys.data_ptr(),
                          dxw[k].data_ptr(), scratch[k].data_ptr(), int(rev))]

        def call(lib):
            _build.check(lib.vo_lstm_bwd_named(
                1, loop, 1, T, B, H, 2, mask.data_ptr(), *args,
                torch.cuda.current_stream().cuda_stream), "vo_lstm_bwd_named")

        with torch.no_grad():
            ref = lstm_cuda.lstm_bptt_frames(dirs, mask, bf16)
        for name in ("full", "stamps"):
            call(libs[name])
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(dxw, ref)):
                raise RuntimeError(f"{name}: dxw differs from the library's")
        libs["stamps"].vo_prof_swap(prof)
        call(libs["stamps"])
        torch.cuda.synchronize()
        libs["stamps"].vo_prof_swap(prof)
        stamps = {who: {p: prof[o + i] / T for i, p in enumerate(
            STAMP_PHASES)} for who, o in (("cta0", 0), ("last_cta", 8))}
        times = {name: [] for name in VARIANTS if name != "stamps"}
        order = list(times)
        for turn in range(TURNS):
            for name in (order[:] if turn % 2 == 0 else order[::-1]):
                lib = libs[name]
                print(f"timing {name} at B={B}", file=sys.stderr, flush=True)
                try:
                    call(lib)
                except RuntimeError as err:  # a launch the card refuses
                    times[name] = str(err)
                    order.remove(name)
                    continue
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as p:
                    for _ in range(REPS):
                        call(lib)
                    torch.cuda.synchronize()
                ka = [e for e in p.key_averages() if "lstm_bwd_tc" in e.key]
                times[name].append(ka[0].device_time_total / ka[0].count
                                   / 1e3)
        results[f"B{B}_T{T}"] = {"ms_a_launch": times,
                                 "cycles_a_frame": stamps}
        for name, t in times.items():
            print(f"lstm_bwd_tc {name} B={B} T={T} H={H}: " + (
                t if isinstance(t, str) else " / ".join(
                    f"{v:.3f}" for v in t) + " ms a launch") + f" ({smi})",
                flush=True)
        for who, st in stamps.items():
            print(f"lstm_bwd_tc stamps {who} B={B} T={T}: " + "; ".join(
                f"{p} {v:.0f}" for p, v in st.items()) + " cycles a frame",
                flush=True)
    print(json.dumps({"lstm_bwd_tc_profile": results, "H": H,
                      "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
