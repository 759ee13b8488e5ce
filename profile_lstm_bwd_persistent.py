#!/usr/bin/env python3
"""Where the time of the flagship's bf16 BPTT frame loop
(``lstm_bwd_persistent``, ``vistaocr_tpu_torch/csrc/lstm_bwd.cu``) goes on
one NVIDIA GPU, by taking work out of copies of the kernel and by clock64
stamps.

    python3 profile_lstm_bwd_persistent.py [--shapes 32x512,128x128]
        [--variants full,no_sum] [--root DIR [--root-variants full]]

Builds copies of ``csrc/lstm_bwd.cu`` into
``vistaocr_tpu_torch/_build/profile/`` (one nvcc each, all started
together) and times each copy's ``lstm_bwd_persistent`` (device time a
launch, ``torch.profiler``) in turns with the kernel as it stands, at
H=512, both directions, bf16 streams and weights, every row valid, B/T =
32/512, 64/256, 128/128 and 512/32 (the 2**21-pixel ladder's buckets),
behind the wide gate GEMM:

- ``full``: the kernel as it stands;
- ``no_exchange``: the partials sent to the peers cut to 16 bytes a peer
  and frame (the mbarrier's byte count matches what is sent, so the
  protocol stays whole; the sum reads stale shared memory);
- ``no_sum``: the 16-way sum of the received partials cut to one block;
- ``no_product``: the wgmma cut (the partials are stale);
- ``no_epilogue``: the cell backward cut to ``dh + dys`` into dxw (no
  gate reads, transcendentals, dgates or dg tile);
- ``stamps``: the kernel with clock64 stamps, cycles a frame by phase
  (the wait for the frame's inputs, the cell backward with the next
  frame's input copies issued, each m64 tile's product with its wait,
  the partials out, the wait for the peers' partials, the sum), the most
  over the warps of CTAs 0 and C-1 of the first cluster of direction 0;
- ``rows_32``, ``rows_16``, ``rows_8``: the kernel with its batch rows a
  cluster fixed (the library chooses them by B), the table its rule
  reads.

Beside them: ``lstm_bwd_tc`` (the F2 frame loop, one cooperative launch,
which takes H=512 too) through its named design as a yardstick, and, for
each copy and shape, its rows a cluster, the clusters it launches, how
many the card holds at once (``cudaOccupancyMaxActiveClusters``) and the
waves that makes.

``--root DIR`` also builds the ``--root-variants`` (default ``full``) of
another checkout's ``csrc/lstm_bwd.cu`` (a parent unpacked with ``git
archive``) and times them in the same turns (and reads its ``stamps``
copy, if named), so that two kernels are compared on one card. Each edit is placed by a text anchor; a variant
has a recipe for each kernel design it applies to (the partials sent as
16-byte ``st.async`` stores by 32-row clusters, and as one bulk copy a
peer by clusters of 32, 16 or 8 rows), and the first whose anchors are
each found once is taken; none found stops the script. The cut copies
compute wrong dxw and are timed only; a ``full`` or ``stamps`` copy of
this tree whose dxw differs from the library's stops the script (the
other copies are reported as bit-equal or not). Prints a line a variant
and shape and a JSON line; ``--out`` also writes the JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

H = 512
SHAPES = ((32, 512), (64, 256), (128, 128), (512, 32))  # (B, T)
TURNS = 2
REPS = 3
KERNEL = "lstm_bwd_persistent"

# --- the parent design: 16-byte st.async stores of the partials ----------
_V1_STORE = ("        if (p < nrank) {\n"
             "          st_async_v4(")
_V1_SUM = ("    for (int q = 0; q < nrank; ++q) {\n"
           "      const float4 v = *reinterpret_cast<const float4*>"
           "(rx + q * BSLOT);\n")
_V1_PRODUCT = ("      for (int kk = 0; kk < 8; ++kk) {\n"
               "        wgmma_m64n32_rs<0>(acc, af[mt][kk],\n")
_V1_CELL = (
    "      const float gi = sigmoid_fast(p[0]);\n"
    "      const float gf = sigmoid_fast(p[BN * BU]);\n"
    "      const float gg = tanh_fast(p[2 * BN * BU]);\n"
    "      const float go = sigmoid_fast(p[3 * BN * BU]);\n"
    "      const float tc = tanh_fast(to_f32(cs_s[b * BU + u]));\n"
    "      const float c_prev = to_f32(cs_s[(BN + b) * BU + u]);\n"
    "      const float dh_t = dh[i] + to_f32(dy_s[b * BU + u]);\n")
_V1_CELL_END = (
    "      if (u_ok && b0 + b < B) {  // a warp stores 32 consecutive units\n"
    "        S* dx = d.dxw + ((long long)t * B + b0 + b) * G + j0 + u;\n"
    "#pragma unroll\n"
    "        for (int g = 0; g < 4; ++g) dx[(long long)g * H] = v[g];\n"
    "      }\n"
    "#pragma unroll\n"
    "      for (int g = 0; g < 4; ++g) {  // round_W(dgates): the product's B\n"
    "        const int kc = 32 * g + u;\n"
    "        *reinterpret_cast<bf16*>(dg_s + (kc / 64) * BN * 128 +\n"
    "                                 swz128(b, (kc % 64) / 8) + (kc % 8) * 2) "
    "=\n"
    "            __float2bfloat16(to_f32(v[g]));\n"
    "      }\n")
_V1_CELL_CUT = (
    "      (void)p;\n"
    "      const float dh_t = dh[i] + to_f32(dy_s[b * BU + u]);\n"
    "      dc[i] = 0.0f;\n"
    "      keep[i] = (1.0f - m) * dh_t;\n"
    "      if (u_ok && b0 + b < B) {\n"
    "        d.dxw[((long long)t * B + b0 + b) * G + j0 + u] = "
    "from_f32<S>(dh_t);\n"
    "      }\n")
_V1_PLAN = (
    'extern "C" int vo_prof_plan(int B, int H, int ndir, int* out) {\n'
    "  // the parent launch's plan (32 rows a cluster) and co-resident\n"
    "  // clusters, as launch_bwd_persistent configures it (bf16 streams)\n"
    "  const int csize = (H + BU - 1) / BU;\n"
    "  auto kernel = csize <= 4 ? lstm_bwd_persistent<bf16, 1>\n"
    "                : csize <= 8 ? lstm_bwd_persistent<bf16, 2>\n"
    "                             : lstm_bwd_persistent<bf16, 4>;\n"
    "  constexpr int smem = bwd_persistent_smem<bf16>();\n"
    "  cudaFuncSetAttribute(kernel,\n"
    "      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);\n"
    "  cudaFuncSetAttribute(kernel,\n"
    "      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
    "  cudaLaunchConfig_t cfg = {};\n"
    "  cfg.gridDim = dim3(csize, (B + BN - 1) / BN, ndir);\n"
    "  cfg.blockDim = dim3(BTHREADS);\n"
    "  cfg.dynamicSmemBytes = smem;\n"
    "  cudaLaunchAttribute attr[1];\n"
    "  attr[0].id = cudaLaunchAttributeClusterDimension;\n"
    "  attr[0].val.clusterDim.x = csize;\n"
    "  attr[0].val.clusterDim.y = 1;\n"
    "  attr[0].val.clusterDim.z = 1;\n"
    "  cfg.attrs = attr;\n"
    "  cfg.numAttrs = 1;\n"
    "  out[0] = BN;\n"
    "  out[1] = ndir * ((B + BN - 1) / BN);\n"
    "  return static_cast<int>(\n"
    "      cudaOccupancyMaxActiveClusters(&out[2], kernel, &cfg));\n"
    "}\n\n")
_V2_PLAN = (
    'extern "C" int vo_lstm_bwd_persistent_plan(int, int, int, int, int*);\n'
    'extern "C" int vo_prof_plan(int B, int H, int ndir, int* out) {\n'
    "  return vo_lstm_bwd_persistent_plan(1, B, H, ndir, out);\n"
    "}\n\n")
_LOOP_DESIGN = 'extern "C" int vo_lstm_bwd_loop_design('
_PROF_SWAP = (
    'extern "C" int vo_prof_swap(unsigned long long* out) {\n'
    "  static const unsigned long long zero[32] = {};\n"
    "  const cudaError_t err = cudaMemcpyFromSymbol(out, vo_prof,\n"
    "                                               sizeof(zero));\n"
    "  return static_cast<int>(err != cudaSuccess ? err\n"
    "      : cudaMemcpyToSymbol(vo_prof, zero, sizeof(zero)));\n}\n\n")

# stamps: P[i] += cycles of STAMP_PHASES[i] in every warp; lane 0 of each
# warp of CTAs 0 and C-1 keeps the most over warps (vo_prof[0..15] and
# [16..31])
STAMP_PHASES = ("input_wait", "cell_backward", "product_tile0",
                "product_tile1", "product_tile2", "product_tile3",
                "partials_out", "peer_wait", "sum", "frame")
_STAMP_DUMP = (
    "  if (lane == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&\n"
    "      (rank == 0 || rank == nrank - 1)) {\n"
    "    for (int i = 0; i < 10; ++i) {\n"
    "      atomicMax(&vo_prof[(rank == 0 ? 0 : 16) + i],\n"
    "                static_cast<unsigned long long>(P[i]));\n"
    "    }\n  }\n")
_V1_STAMPS = (
    ("template <typename S>\nstruct BwdSeqDir {",
     "__device__ unsigned long long vo_prof[32];\n"
     "template <typename S>\nstruct BwdSeqDir {"),
    ("  float dh[4], dc[4], keep[4];\n",
     "  float dh[4], dc[4], keep[4];\n"
     "  long long P[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  long long c1 = 0;\n"),
    ("    cp_async_wait_all();\n"
     "    __syncthreads();  // the inputs arrived; the last product read dg_s\n",
     "    const long long c0 = clock64();\n"
     "    cp_async_wait_all();\n"
     "    __syncthreads();  // the inputs arrived; the last product read dg_s\n"
     "    c1 = clock64();\n    P[0] += c1 - c0;\n"),
    ("      load_inputs(tn, tpn);  // lands during the product and the "
     "exchange\n    }\n",
     "      load_inputs(tn, tpn);  // lands during the product and the "
     "exchange\n    }\n"
     "    { const long long c2 = clock64(); P[1] += c2 - c1; c1 = c2; }\n"),
    ("      wgmma_commit();\n      wgmma_wait<0>();\n",
     "      wgmma_commit();\n      wgmma_wait<0>();\n"
     "      { const long long c2 = clock64(); P[2 + mt] += c2 - c1; "
     "c1 = c2; }\n"),
    ("                      odd ? a[3] : y1, cluster_addr(bar, p));\n"
     "        }\n      }\n    }\n"
     "    mbar_wait(&full[buf], (step >> 1) & 1);\n",
     "                      odd ? a[3] : y1, cluster_addr(bar, p));\n"
     "        }\n      }\n"
     "      { const long long c2 = clock64(); P[6] += c2 - c1; c1 = c2; }\n"
     "    }\n"
     "    mbar_wait(&full[buf], (step >> 1) & 1);\n"
     "    { const long long c2 = clock64(); P[7] += c2 - c1; c1 = c2; }\n"),
    ("    for (int i = 0; i < 4; ++i) dh[i] = sum[i] + keep[i];\n  }\n",
     "    for (int i = 0; i < 4; ++i) dh[i] = sum[i] + keep[i];\n"
     "    { const long long c2 = clock64(); P[8] += c2 - c1; "
     "P[9] += c2 - c0; }\n  }\n" + _STAMP_DUMP),
    (_LOOP_DESIGN, _PROF_SWAP + _LOOP_DESIGN),
)

# --- this design: a bulk copy a peer, BN rows a cluster -----------------
_V2_COPY = ("        bulk_copy_to_peer(cluster_addr(dst, p), out + p * SLOT, "
            "SLOT,\n")
_V2_SUM = ("      for (int q = 0; q < nrank; ++q) {\n"
           "        const float* v = rx + q * (SLOT / 4);\n")
_V2_PRODUCT = ("        for (int kk = 0; kk < 8; ++kk) {\n"
               "          wgmma_rs<BN>(")
_V2_CELL = (
    "      const float gi = sigmoid_fast(p[0]);\n"
    "      const float gf = sigmoid_fast(p[BN * BU]);\n"
    "      const float gg = tanh_fast(p[2 * BN * BU]);\n"
    "      const float go = sigmoid_fast(p[3 * BN * BU]);\n"
    "      const float tc = tanh_fast(to_f32(io_s[b * BU + u]));\n"
    "      const float c_prev = to_f32(io_s[(BN + b) * BU + u]);\n"
    "      const float dh_t = dh[i] + to_f32(io_s[(2 * BN + b) * BU + u]);\n")
_V2_CELL_END = ("            __float2bfloat16(to_f32(v[g]));\n"
                "      }\n")
_V2_COST = ("    const long long cost = (clusters + res - 1) / res * "
            "BWD_ROWS[k].frame_ns;\n")
_V2_STAMPS = (
    ("template <typename S>\nstruct BwdSeqDir {",
     "__device__ unsigned long long vo_prof[32];\n"
     "template <typename S>\nstruct BwdSeqDir {"),
    ("  float dh[RPT], dc[RPT], keep[RPT];\n",
     "  float dh[RPT], dc[RPT], keep[RPT];\n"
     "  long long P[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};\n"),
    ("    frame(step, t, tp);\n    const int buf = step & 1;\n",
     "    frame(step, t, tp);\n    const int buf = step & 1;\n"
     "    const long long c0 = clock64();\n    long long c1 = c0;\n"),
    ("      mbar_wait(&full[buf ^ 1], ((step - 1) >> 1) & 1);\n",
     "      mbar_wait(&full[buf ^ 1], ((step - 1) >> 1) & 1);\n"
     "      { const long long c2 = clock64(); P[7] += c2 - c1; c1 = c2; }\n"),
    ("      for (int i = 0; i < RPT; ++i) dh[i] = sum[i] + keep[i];\n    }\n",
     "      for (int i = 0; i < RPT; ++i) dh[i] = sum[i] + keep[i];\n"
     "      { const long long c2 = clock64(); P[8] += c2 - c1; c1 = c2; }\n"
     "    }\n"),
    ("    cp_async_wait_all();\n"
     "    // the inputs arrived; the last product read dg_s, and the buffer "
     "the\n"
     "    // partials are staged in below was summed\n"
     "    __syncthreads();\n",
     "    c1 = clock64();\n"
     "    cp_async_wait_all();\n"
     "    // the inputs arrived; the last product read dg_s, and the buffer "
     "the\n"
     "    // partials are staged in below was summed\n"
     "    __syncthreads();\n"
     "    { const long long c2 = clock64(); P[0] += c2 - c1; c1 = c2; }\n"),
    ("      load_inputs(tn, tpn);  // lands during the product and the "
     "exchange\n    }\n",
     "      load_inputs(tn, tpn);  // lands during the product and the "
     "exchange\n    }\n"
     "    { const long long c2 = clock64(); P[1] += c2 - c1; c1 = c2; }\n"),
    ("      if (mt < MT) {\n        wgmma_wait<NACC - 1>();\n"
     "      } else {\n        wgmma_wait<0>();\n      }\n",
     "      if (mt < MT) {\n        wgmma_wait<NACC - 1>();\n"
     "      } else {\n        wgmma_wait<0>();\n      }\n"
     "      { const long long c2 = clock64(); P[2 + done] += c2 - c1; "
     "c1 = c2; }\n"),
    ("        bulk_commit();\n      }\n    }\n  }\n"
     "  // no CTA leaves while a copy from or to its shared memory is in "
     "flight\n",
     "        bulk_commit();\n      }\n"
     "      { const long long c2 = clock64(); P[6] += c2 - c1; c1 = c2; }\n"
     "    }\n    P[9] += clock64() - c0;\n  }\n" + _STAMP_DUMP +
     "  // no CTA leaves while a copy from or to its shared memory is in "
     "flight\n"),
    (_LOOP_DESIGN, _PROF_SWAP + _LOOP_DESIGN),
)

RECIPES = {  # variant -> one tuple of (anchor, text) edits a design
    "full": ((),),
    "no_exchange": (
        (("mbar_arrive_expect_tx(&full[buf], nrank * SLOT);",
          "mbar_arrive_expect_tx(&full[buf], nrank * 16);"),
         (_V2_COPY, _V2_COPY.replace("SLOT,\n", "16,\n"))),
        (("if (tid == 0) mbar_arrive_expect_tx(&full[buf], nrank * BSLOT);",
          "if (tid == 0) mbar_arrive_expect_tx(&full[buf], nrank * 16);"),
         (_V1_STORE, "        if (p < nrank && uu == 0 && c == 0) {\n"
                     "          st_async_v4(")),),
    "no_sum": (
        ((_V2_SUM, _V2_SUM.replace("q < nrank", "q < 1")),),
        ((_V1_SUM, _V1_SUM.replace("q < nrank", "q < 1")),),),
    "no_product": (
        ((_V2_PRODUCT, _V2_PRODUCT.replace("kk < 8", "kk < 0")),),
        ((_V1_PRODUCT, _V1_PRODUCT.replace("kk < 8", "kk < 0")),),),
    "no_epilogue": (
        ((_V2_CELL,
          "      (void)p;\n"
          "      const float dh_t = dh[i] + to_f32(io_s[(2 * BN + b) * BU + "
          "u]);\n"
          "      dc[i] = 0.0f;\n"
          "      keep[i] = (1.0f - m) * dh_t;\n"
          "      io_s[(3 * BN + b) * BU + u] = from_f32<S>(dh_t);\n"
          "#if 0\n"),
         (_V2_CELL_END, _V2_CELL_END + "#endif\n")),
        ((_V1_CELL, _V1_CELL_CUT),
         ("      const float dc_t = dc[i] + dh_t * go * (1.0f - tc * tc);\n",
          ""),
         ("      const S v[4] = {from_f32<S>((dc_t * gg) * gi * (1.0f - gi) * "
          "m),\n"
          "                      from_f32<S>((dc_t * c_prev) * gf * (1.0f - "
          "gf) * m),\n"
          "                      from_f32<S>((dc_t * gi) * (1.0f - gg * gg) "
          "* m),\n"
          "                      from_f32<S>((dh_t * tc) * go * (1.0f - go) "
          "* m)};\n"
          "      dc[i] = m * (dc_t * gf) + (1.0f - m) * dc[i];\n"
          "      keep[i] = (1.0f - m) * dh_t;\n", ""),
         (_V1_CELL_END, "")),),
    "stamps": (_V2_STAMPS, _V1_STAMPS),
}
# copies of this design with the library's rows a cluster fixed (the
# rule's table)
ROW_VARIANTS = ("rows_32", "rows_16", "rows_8")  # in BWD_ROWS' order
for _k, _name in enumerate(ROW_VARIANTS):
    RECIPES[_name] = (
        ((_V2_COST, f"    const long long cost = k == {_k} ? 0 : 1;\n"),),)
VARIANTS = tuple(RECIPES)
# every copy reports its plan: rows a cluster, clusters, and the clusters
# the card holds at once
PLAN_QUERY = ((_V2_COST, _LOOP_DESIGN, _V2_PLAN),
              ("  auto kernel = lstm_bwd_persistent<S, MT>;\n", _LOOP_DESIGN,
               _V1_PLAN))


def _apply(src: str, edits) -> str:
    for anchor, text in edits:
        src = src.replace(anchor, text)
    return src


def _matches(src: str, edits) -> bool:
    return all(src.count(anchor) == 1 for anchor, _ in edits)


def variant_source(src: str, name: str) -> str:
    """The source of variant ``name`` of the kernel in ``src``, with the
    plan query of its design: the first of the variant's recipes whose
    anchors are each found once."""
    for marker, anchor, text in PLAN_QUERY:
        if src.count(marker) == 1:
            src = _apply(src, ((anchor, text + anchor),))
            break
    else:
        raise RuntimeError("no plan query's marker found once in lstm_bwd.cu")
    for edits in RECIPES[name]:
        if _matches(src, edits):
            return _apply(src, edits)
    raise RuntimeError(f"{name}: no recipe's anchors found once in "
                       f"lstm_bwd.cu")


def build(trees) -> dict:
    """One shared library a (tree, variant), built by parallel nvcc
    processes; ``trees``: (label, csrc directory, variants)."""
    from vistaocr_tpu_torch.ops import _build

    out = os.path.join(_build.BUILD_DIR, "profile")
    os.makedirs(out, exist_ok=True)
    libs, cmds = {}, []
    for label, csrc, variants in trees:
        with open(os.path.join(csrc, "lstm_bwd.cu")) as f:
            src = f.read()
        for name in variants:
            key = f"{label}{name}"
            stem = key.replace(":", "_")
            cu = os.path.join(out, f"lstm_bwd_persistent_{stem}.cu")
            with open(cu, "w") as f:
                f.write(variant_source(src, name))
            libs[key] = os.path.join(out, f"liblstm_bwd_persistent_{stem}.so")
            cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                         csrc, "-o", libs[key], cu])
    _build._run_all(cmds)
    loaded = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for key, path in libs.items():
        lib = ctypes.CDLL(path)
        lib.vo_lstm_bwd_named.restype = i
        lib.vo_lstm_bwd_named.argtypes = [i] * 7 + [p] + (
            [p] * 8 + [i]) * 2 + [p]
        lib.vo_lstm_bwd_scratch.restype = ctypes.c_longlong
        lib.vo_lstm_bwd_scratch.argtypes = [i] * 4
        lib.vo_prof_plan.restype = i
        lib.vo_prof_plan.argtypes = [i, i, i, p]
        loaded[key] = lib
    return loaded


def _device_ms(fn, name: str) -> float:
    """Device ms a launch of the kernel whose name holds ``name`` over
    REPS calls of ``fn`` in a torch.profiler window; the window opens with
    small launches, a synchronise and a pause (the profiler drops device
    events near its edges), and is taken again if it saw no launch."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    pad = torch.zeros(1, device="cuda")
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(64):
                pad.add_(1.0)
            torch.cuda.synchronize()
            time.sleep(0.02)
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
        ka = [e for e in prof.key_averages() if name in e.key]
        if ka and ka[0].count:
            return ka[0].device_time_total / ka[0].count / 1e3
    raise RuntimeError(f"the profiler saw no {name} launch")


def main(argv) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=",".join(f"{b}x{t}"
                                                 for b, t in SHAPES),
                    help="comma-separated BxT")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--root", default=None,
                    help="also time this checkout's kernel")
    ap.add_argument("--root-variants", default="full")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    shapes = [tuple(int(v) for v in s.split("x"))
              for s in args.shapes.split(",")]
    variants = args.variants.split(",")
    if "full" not in variants:
        variants.insert(0, "full")
    if not torch.cuda.is_available():
        print("profile_lstm_bwd_persistent: torch.cuda.is_available() is "
              "False", file=sys.stderr)
        return 1
    from vistaocr_tpu_torch.ops import _build, lstm_cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    trees = [("", _build.CSRC, variants)]
    if args.root:
        trees.append(("root:", os.path.join(args.root, "vistaocr_tpu_torch",
                                            "csrc"),
                      args.root_variants.split(",")))
    libs = build(trees)
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    prof = (ctypes.c_ulonglong * 32)()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    persistent = lstm_cuda.LOOP_DESIGNS.index("persistent")
    tc = lstm_cuda.LOOP_DESIGNS.index("tc")
    results = {}
    for B, T in shapes:
        g = torch.Generator(device=dev).manual_seed(B)

        def rnd(*shape, scale=1.0):
            return (torch.randn(shape, generator=g, device=dev) * scale).to(
                bf16)

        dirs = [(rnd(T, B, 4 * H), rnd(H, 4 * H, scale=H ** -0.5),
                 rnd(T, B, H, scale=0.5), rnd(T, B, H), rnd(T, B, H), r)
                for r in (False, True)]
        mask = torch.ones(T, 1, B, device=dev)
        nbytes = max(libs["full"].vo_lstm_bwd_scratch(lp, T, B, H)
                     for lp in (persistent, tc))
        scratch = [torch.empty(nbytes // 4, device=dev) for _ in dirs]
        dxw = [torch.empty_like(d[0]) for d in dirs]
        ptrs = [a for k, (xw, wh, ys, cs, dys, rev) in enumerate(dirs)
                for a in (xw.data_ptr(), wh.data_ptr(), wh.data_ptr(),
                          ys.data_ptr(), cs.data_ptr(), dys.data_ptr(),
                          dxw[k].data_ptr(), scratch[k].data_ptr(), int(rev))]

        def call(lib, loop=persistent):
            _build.check(lib.vo_lstm_bwd_named(
                1, loop, 1, T, B, H, 2, mask.data_ptr(), *ptrs,
                torch.cuda.current_stream().cuda_stream), "vo_lstm_bwd_named")

        with torch.no_grad():
            ref = lstm_cuda.lstm_bptt_frames(dirs, mask, bf16,
                                             loop="persistent")
        bit_equal = {}
        for key in libs:
            if key.split(":")[-1] not in ("full", "stamps", *ROW_VARIANTS):
                continue
            call(libs[key])
            torch.cuda.synchronize()
            bit_equal[key] = all(torch.equal(a, b) for a, b in zip(dxw, ref))
            if key in ("full", "stamps") and not bit_equal[key]:
                raise RuntimeError(f"{key}: dxw differs from the library's")
        stamps = {}  # a stamps copy's cycles a frame, by tree
        for key in libs:
            if key.split(":")[-1] != "stamps":
                continue
            libs[key].vo_prof_swap(prof)
            call(libs[key])
            torch.cuda.synchronize()
            libs[key].vo_prof_swap(prof)
            for who, o in (("cta0", 0), ("last_cta", 16)):
                stamps[f"{key} {who}"] = {p: prof[o + i] / T for i, p in
                                          enumerate(STAMP_PHASES)}
        plans = {}
        out = (ctypes.c_int * 4)()
        for key in libs:
            if key.split(":")[-1] in ("full", *ROW_VARIANTS):
                _build.check(libs[key].vo_prof_plan(B, H, 2, out),
                             "vo_prof_plan")
                bn, n, res = out[:3]
                plans[key] = {"rows": bn, "clusters": n, "co_resident": res,
                              "waves": -(-n // res), "sms": sms}
        timed = [k for k in libs if k.split(":")[-1] != "stamps"] + ["tc"]
        times = {k: [] for k in timed}
        for turn in range(TURNS):
            for key in (timed if turn % 2 == 0 else timed[::-1]):
                lib, loop, name = ((libs["full"], tc, "lstm_bwd_tc")
                                   if key == "tc" else
                                   (libs[key], persistent, KERNEL))
                print(f"timing {key} at B={B}", file=sys.stderr, flush=True)
                times[key].append(_device_ms(lambda: call(lib, loop), name))
        results[f"B{B}_T{T}"] = {"ms_a_launch": times,
                                 "us_a_frame": {k: min(v) * 1e3 / T
                                                for k, v in times.items()},
                                 "plans": plans, "bit_equal": bit_equal,
                                 "cycles_a_frame": stamps}
        for key, t in times.items():
            print(f"{KERNEL if key != 'tc' else 'lstm_bwd_tc'} {key} B={B} "
                  f"T={T} H={H}: " + " / ".join(f"{v:.4f}" for v in t)
                  + f" ms a launch, {min(t) * 1e3 / T:.3f} us a frame "
                  f"({smi})", flush=True)
        for key, pl in plans.items():
            print(f"{KERNEL} {key} B={B}: {pl}; dxw bit-equal to the "
                  f"library's: {bit_equal.get(key)}", flush=True)
        for who, st in stamps.items():
            print(f"{KERNEL} {who} B={B} T={T}: " + "; ".join(
                f"{p} {v:.0f}" for p, v in st.items()) + " cycles a frame",
                flush=True)
    line = json.dumps({"lstm_bwd_persistent_profile": results, "H": H,
                       "card": smi})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
