#!/usr/bin/env python3
"""Times of the fused stem's kernel pair (K7a ``vo_stem_fwd``, K7b
``vo_stem_dk``, ``vistaocr_tpu_torch/csrc/stem.cu``) on one NVIDIA GPU,
kernel by kernel, for this checkout and another one (``--root``, a parent
unpacked with ``git archive``) in turns: the other tree, this one, this
one, the other tree, ``--turns`` times.

    python3 profile_stem.py [--root DIR] [--turns 2]
        [--parts kernels,cuts,path,step] [--out FILE]

Each tree runs in a process of its own (this script with ``--child``,
its working directory and first path entry the tree's root, so that it
imports that tree's ``vistaocr_tpu_torch``). Parts:

- ``kernels``: ``stem_fwd_cuda`` and ``stem_dk_cuda`` at H=32, CO=64, B/W
  32/2048 and 128/512 (the flagship's 2**21-pixel train buckets), out and
  xn in bf16 and in f32: ms a call by CUDA events (the median of 3 runs of
  10 calls after a warm-up), the device time of each kernel of the call
  (``torch.profiler``), the design the tree names (``stem_design``, where
  it has one), whether reruns are bit-equal, and the largest difference
  to the plain versions. Only ``stem.cu`` is built for this part (its own
  library in ``vistaocr_tpu_torch/_build/profile/``, bound by the tree's
  ``_build._bind``), so it takes seconds, not the whole library's build;
- ``cuts``: copies of the tree's ``stem.cu`` with work taken out, each
  found by text anchors (a copy whose anchors a tree lacks is skipped),
  timed by device time a launch at the same shapes (bf16 and f32): the
  forward with its 9-tap sums cut to one product (the store stream
  stays) or with its stores behind a test that never holds (the sums
  stay); the first design's dK with its 9 FMAs an element cut to one
  add (the load stream stays) or with its per-channel warp and block
  reductions cut; the persistent dK with its ring of chunks and no
  product. Beside them, copies that change a choice: the persistent
  dK's ring at 4 stages and one CTA an SM, or 2 stages and three, and
  the conv's stores as streaming stores. The cut copies compute wrong
  values and are timed only;
- ``path``: phase 9's bf16 side-by-side, the flagship's train-mode
  forward+backward at B=32, W=2048 with the experiments in place
  (``forward_with_experiments``) and with ``model.forward``;
- ``step``: the flagship's bf16 train step at B=32, W=2048
  (``chip_smoke.f32_step``).

``path`` and ``step`` build the tree's whole library. Prints a line a
tree and turn, the card's name and power limit, and a JSON line of every
reading; ``--out`` also writes the JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
H, CO = 32, 64
SHAPES = ((32, 2048), (128, 512))  # (B, W)
PARTS = ("kernels", "cuts", "path", "step")
PATH_BATCH = (32, 2048)  # (B, W)

# --- cut copies of stem.cu: (name, kernel timed, edits), each edit an
# anchor found once and its replacement; the _V1_ anchors are the first
# design's (one block a 8 x 512 tile, a reduction a channel) ------------
_V1_FWD_SUM = (
    "        float s = 0.0f;\n"
    "#pragma unroll\n"
    "        for (int dh = 0; dh < 3; ++dh)\n"
    "#pragma unroll\n"
    "          for (int dw = 0; dw < 3; ++dw)\n"
    "            s = fmaf(k[dh * 3 + dw], win[r + dh][c + dw], s);\n"
    "        v[c] = s;\n")
_V1_FWD_STORE = "      store_row(o + (long long)r * W, v, valid, vec);\n"
_V1_DK_FMA = (
    "#pragma unroll\n"
    "        for (int c = 0; c < VEC; ++c)\n"
    "#pragma unroll\n"
    "          for (int dh = 0; dh < 3; ++dh)\n"
    "#pragma unroll\n"
    "            for (int dw = 0; dw < 3; ++dw)\n"
    "              acc[dh * 3 + dw] = fmaf(dv[c], win[r + dh][c + dw], "
    "acc[dh * 3 + dw]);\n")
_V1_DK_SHFL = (
    "#pragma unroll\n"
    "    for (int i = 0; i < 9; ++i) {\n"
    "#pragma unroll\n"
    "      for (int o = 16; o > 0; o >>= 1)\n"
    "        acc[i] += __shfl_down_sync(0xffffffffu, acc[i], o);\n"
    "    }\n")
_V1_DK_SYNC1 = ("      for (int i = 0; i < 9; ++i) red[warp][i] = acc[i];\n"
                 "    }\n    __syncthreads();\n")
_V1_DK_SYNC2 = ("      partial[blk * CO * 9 + co * 9 + threadIdx.x] = s;\n"
                 "    }\n    __syncthreads();\n")
CUTS = (
    ("fwd_one_product", "stem_conv",
     ((_V1_FWD_SUM, "        v[c] = win[r + 1][c + 1] * k[4];\n"),)),
    ("fwd_no_stores", "stem_conv",
     ((_V1_FWD_STORE,
       "      float z = 0.0f;\n      for (float e : v) z += e;\n"
       "      if (z == 1.2345e30f)\n  " + _V1_FWD_STORE),)),
    ("dk_one_add", "stem_dk_partial",
     ((_V1_DK_FMA, "        for (int c = 0; c < VEC; ++c) acc[c] += dv[c];\n"),)),
    ("dk_no_reductions", "stem_dk_partial",
     ((_V1_DK_SHFL, ""),
      (_V1_DK_SYNC1, _V1_DK_SYNC1.replace("    __syncthreads();\n", "")),
      (_V1_DK_SYNC2, _V1_DK_SYNC2.replace("    __syncthreads();\n", "")))),
    # the persistent dK: its ring of chunks alone, no product
    ("dk_ring_only", "stem_dk_partial",
     (("      dk_compute(dk_smem + (k % DK_STAGES) * STAGE_BYTES, acc);\n",
       ""),)),
    # not cuts: dK's ring deeper with one CTA an SM, or shallower with three
    ("dk_4_stages_1_cta", "stem_dk_partial",
     (("constexpr int DK_STAGES = 3;", "constexpr int DK_STAGES = 4;"),
      ("constexpr int DK_CTAS_PER_SM = 2;", "constexpr int DK_CTAS_PER_SM = 1;"))),
    ("dk_2_stages_3_ctas", "stem_dk_partial",
     (("constexpr int DK_STAGES = 3;", "constexpr int DK_STAGES = 2;"),
      ("constexpr int DK_CTAS_PER_SM = 2;", "constexpr int DK_CTAS_PER_SM = 3;"))),
    # not a cut: the conv's 16-byte stores as streaming stores (st.global.cs)
    ("fwd_streaming_stores", "stem_conv",
     (("    *reinterpret_cast<uint4*>(p) = u;\n",
       "    __stcs(reinterpret_cast<uint4*>(p), u);\n"),
      ("    *reinterpret_cast<float4*>(p) = u;\n",
       "    __stcs(reinterpret_cast<float4*>(p), u);\n"))),
)


def _smoke():
    """This checkout's chip_smoke.py, whatever tree is imported."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ms(fn) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / 10)
    return float(np.median(runs))


def _device_us(fn, reps: int = 5) -> dict:
    """Device time (us) a call of ``fn`` by kernel (the name up to its
    template arguments), over ``reps`` calls in a ``torch.profiler``
    window after a warm-up; the window opens with 64 small launches and
    closes after a synchronise and a pause, so that no launch of the calls
    falls outside it."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    pad = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            pad.add_(1.0)
        torch.cuda.synchronize()
        time.sleep(0.02)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
    out: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "elementwise" in e.name:  # the pad
            continue
        name = (e.name.replace("(anonymous namespace)::", "")
                .replace("void ", "").split("<")[0].split("(")[0])
        out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / reps
    return out


def _nvcc_lib(src_text: str, csrc: str, name: str) -> str:
    """Compile one stem.cu text into its own shared library under the
    tree's ``_build/profile/``; returns the path."""
    from vistaocr_tpu_torch.ops import _build

    out = os.path.join(_build.BUILD_DIR, "profile")
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(src_text)
    lib = os.path.join(out, f"lib{name}.so")
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                      csrc, "-o", lib, cu]])
    return lib


class _Tolerant:
    """A ctypes library for ``_build._bind``: the names it lacks absorb
    their bindings (a library of stem.cu alone)."""

    def __init__(self, lib):
        self._lib = lib
        self._absent = {}

    def __getattr__(self, name):
        try:
            return getattr(self._lib, name)
        except AttributeError:
            return self._absent.setdefault(name, types.SimpleNamespace())


def _stem_only_library() -> None:
    """Build the tree's stem.cu alone and make it the library its
    wrappers load."""
    from vistaocr_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC, "stem.cu")) as f:
        src = f.read()
    lib = ctypes.CDLL(_nvcc_lib(src, _build.CSRC, "stem_only"))
    _build._bind(_Tolerant(lib))
    _build._lib = lib


def _operands(dev, B, W, seed):
    import torch

    rng = np.random.default_rng(seed)
    widths = rng.integers(W // 3, W + 1, B).astype(np.int32)
    widths[0], widths[-1] = W, W - 7
    images = torch.from_numpy(rng.integers(0, 256, (B, H, W), np.uint8)).to(dev)
    kernel = torch.from_numpy(rng.normal(0, 0.1, (CO, 1, 3, 3)).astype(
        np.float32)).to(dev)
    dout = torch.from_numpy(rng.normal(0, 1, (B, CO, H, W)).astype(
        np.float32)).to(dev)
    return images, torch.from_numpy(widths).to(dev), kernel, dout


def _kernels(c, dev) -> dict:
    import torch
    from vistaocr_tpu_torch.experiments import stem_cuda as S

    _stem_only_library()
    out = {}
    for B, W in SHAPES:
        images, widths, kernel, dout32 = _operands(dev, B, W, B + W)
        for dtype in (torch.bfloat16, torch.float32):
            dout = dout32.to(dtype)

            def fwd():
                return S.stem_fwd_cuda(images, widths, kernel, True, dtype)

            o1, x1 = fwd()
            o2, x2 = fwd()
            ro, rx = S.fused_stem_ref(images, widths, kernel, True, dtype)
            d1 = S.stem_dk_cuda(x1, dout)
            d2 = S.stem_dk_cuda(x1, dout)
            rd = S.stem_dk_ref(x1, dout)
            torch.cuda.synchronize()
            row = {
                "fwd_ms": _ms(fwd),
                "dk_ms": _ms(lambda: S.stem_dk_cuda(x1, dout)),
                "fwd_kernels_us": _device_us(fwd),
                "dk_kernels_us": _device_us(lambda: S.stem_dk_cuda(x1, dout)),
                "fwd_rerun_bit_equal": bool(torch.equal(o1, o2)
                                            and torch.equal(x1, x2)),
                "dk_rerun_bit_equal": bool(torch.equal(d1, d2)),
                "fwd_max_abs_err": max(c._abs(o1, ro), c._abs(x1, rx)),
                "dk_rel_err": c._rel(d1, rd),
            }
            if hasattr(S, "stem_design"):
                row["design"] = S.stem_design(dtype)
            out[f"B{B}_W{W}_{str(dtype)[6:]}"] = row
    return out


def _cut_sources():
    from vistaocr_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC, "stem.cu")) as f:
        src = f.read()
    found = {}
    for name, kernel, edits in CUTS:
        if all(src.count(a) == 1 for a, _ in edits):
            text = src
            for a, b in edits:
                text = text.replace(a, b)
            found[name] = (kernel, text)
    return found


def _cuts(c, dev) -> dict:
    """Each cut copy through its tree's C entry points: the first design's
    ABI (``vo_stem_fwd`` with a ``vec`` flag and [B, 2] float32
    statistics, ``vo_stem_dk`` with ``vec``) or the later one (no ``vec``,
    moment pairs [B, ``vo_stem_moment_chunks(H, W)``, 2] float64)."""
    import torch
    from vistaocr_tpu_torch.ops import _build

    found = _cut_sources()
    if not found:
        return {"note": "no cut's anchors found in this tree's stem.cu"}
    p, i = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for name, (_, text) in found.items():
        lib = ctypes.CDLL(_nvcc_lib(text, _build.CSRC, f"stem_cut_{name}"))
        first = not hasattr(lib, "vo_stem_moment_chunks")
        lib.vo_stem_partials.restype = ctypes.c_longlong
        lib.vo_stem_partials.argtypes = [i, i, i]
        lib.vo_stem_fwd.restype = i
        lib.vo_stem_fwd.argtypes = [i] * (7 if first else 6) + [p] * 7
        lib.vo_stem_dk.restype = i
        lib.vo_stem_dk.argtypes = [i] * (6 if first else 5) + [p] * 5
        if not first:
            lib.vo_stem_moment_chunks.restype = i
            lib.vo_stem_moment_chunks.argtypes = [i, i]
        libs[name] = (lib, first)
    out = {}
    for B, W in SHAPES:
        images, widths, kernel, dout32 = _operands(dev, B, W, B + W)
        for dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)):
            dout = dout32.to(dtype)
            o = torch.empty((B, CO, H, W), dtype=dtype, device=dev)
            xn = torch.randn((B, H, W), device=dev).to(dtype)
            dk = torch.empty((CO, 1, 3, 3), device=dev)
            s = torch.cuda.current_stream().cuda_stream
            row = {}
            for name, (lib, first) in libs.items():
                part = torch.empty((lib.vo_stem_partials(B, H, W), CO * 9),
                                   device=dev)
                stats = (torch.empty((B, 2), device=dev) if first else
                         torch.empty((B, lib.vo_stem_moment_chunks(H, W), 2),
                                     dtype=torch.float64, device=dev))
                vec = (1,) if first else ()
                fwd = found[name][0] == "stem_conv"

                def call(lib=lib, part=part, stats=stats, vec=vec, fwd=fwd):
                    err = (lib.vo_stem_fwd(
                        code, B, H, W, CO, 1, *vec, images.data_ptr(),
                        widths.data_ptr(), kernel.data_ptr(), stats.data_ptr(),
                        o.data_ptr(), xn.data_ptr(), s)
                        if fwd else lib.vo_stem_dk(
                            code, B, H, W, CO, *vec, xn.data_ptr(),
                            dout.data_ptr(), part.data_ptr(), dk.data_ptr(), s))
                    if err:
                        raise RuntimeError(f"cut {name}: error {err}")

                row[name] = _device_us(call).get(found[name][0])
            out[f"B{B}_W{W}_{str(dtype)[6:]}"] = row
    return out


def _path(c, dev) -> dict:
    """Phase 9's bf16 side-by-side: forward+backward of the flagship with
    the experiments and with ``model.forward``, ms (median of 3 after a
    warm-up)."""
    import time

    import torch
    from vistaocr_tpu_torch.checkpoint import load_model
    from vistaocr_tpu_torch.experiments.flagship import forward_with_experiments
    from vistaocr_tpu_torch.ops.ctc import mean_ctc_loss
    from vistaocr_tpu_torch.text import utf8_to_uxxxx

    with tempfile.TemporaryDirectory() as tmp:
        c.flagship_snapshot(tmp)
        model, alphabet, _ = load_model(tmp, dev, compute_dtype="bfloat16",
                                        dropout=0.0, augment=0.0)
    B, W = PATH_BATCH
    lines = c.glyph_lines(c.glyph_font(17), np.random.default_rng(23), B, 200,
                          W)
    images = np.full((B, 32, W), 255, np.uint8)
    ids = [alphabet.encode(utf8_to_uxxxx(text)) for _, text in lines]
    labels = np.zeros((B, max(len(i) for i in ids)), np.int32)
    widths, lls = np.zeros(B, np.int32), np.zeros(B, np.int32)
    for k, ((img, _), lab) in enumerate(zip(lines, ids)):
        images[k, :, :img.shape[1]] = img
        widths[k] = img.shape[1]
        labels[k, :len(lab)] = lab
        lls[k] = len(lab)
    images_t, widths_t, labels_t, lls_t = (
        torch.from_numpy(a).to(dev) for a in (images, widths, labels, lls))
    weights = torch.ones(B, device=dev)

    def run(forward):
        lp, fm = forward()
        loss = mean_ctc_loss(lp, fm.sum(dim=1).to(torch.int32), labels_t,
                             lls_t, sample_weights=weights)
        torch.autograd.grad(loss, list(model.parameters()))

    def timed(forward):
        times = []
        for _ in range(4):  # the first is a warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(forward)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times[1:]))

    return {
        "experiments_ms": timed(lambda: forward_with_experiments(
            model, images_t, widths_t, train=True)),
        "production_ms": timed(lambda: model(images_t, widths_t, train=True)),
    }


def _step(c, dev) -> dict:
    step = c.f32_step(dev, c.glyph_font(17), *PATH_BATCH, "bfloat16")
    return {"ms": [c._cuda_ms(step, 10) for _ in range(3)]}


def child(parts) -> dict:
    # the tree's package first (the script's own directory, which Python
    # put first, is this checkout)
    sys.path.insert(0, os.getcwd())
    import torch
    from vistaocr_tpu_torch.runtime import disable_tf32

    disable_tf32()
    c = _smoke()
    dev = torch.device("cuda", 0)
    fns = {"kernels": _kernels, "cuts": _cuts, "path": _path, "step": _step}
    if any(p in ("path", "step") for p in parts):  # the whole library
        parts = [p for p in parts if p in ("path", "step")] + [
            p for p in parts if p not in ("path", "step")]
    return {p: fns[p](c, dev) for p in parts}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="another checkout, timed in turns with this one")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--parts", default="kernels,cuts")
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    parts = [p for p in args.parts.split(",") if p]
    if any(p not in PARTS for p in parts):
        ap.error(f"parts are {PARTS}")
    if args.child:
        print("CHILD " + json.dumps(child(parts)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("profile_stem: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    trees = {"this": HERE}
    # a child imports its tree's package: not this one's, which a parent
    # process may have imported already
    assert "vistaocr_tpu_torch" not in sys.modules
    if args.root:
        trees["root"] = os.path.abspath(args.root)
    order = (["root", "this", "this", "root"] if args.root
             else ["this", "this"]) * args.turns
    readings: dict = {name: [] for name in trees}
    for name in order:
        root = trees[name]
        env = {**os.environ, "PYTHONPATH": root}
        proc = subprocess.run(
            [sys.executable, os.path.join(HERE, "profile_stem.py"),
             "--child", "--parts", ",".join(parts)],
            cwd=root, env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("CHILD ")][-1]
        got = json.loads(line[len("CHILD "):])
        readings[name].append(got)
        print(f"{name} ({root}): {json.dumps(got)}", flush=True)
    print(smi)
    result = {"card": smi, "trees": trees, "order": order,
              "readings": readings}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
