#!/usr/bin/env python3
"""Where the time of the int8 conv stack (``csrc/int8_conv.cu``,
``models/quant.quantized_conv_features``) goes on one NVIDIA GPU, beside
another checkout's stack and the float path's cuDNN convs.

    python3 profile_int8_conv.py [--root DIR] [--shapes 128x512,32x2048]
        [--variants full,no_mma,no_loads,no_epilogue,no_store] [--out FILE]

At the flagship's conv widths (stages 64/128/256 x 2, pools (2, 2), (2, 2),
(2, 1)) in bf16, on seeded noise lines of B x 32 x W pixels, the qstack
folded from seeded kernels and calibrated on the batch:

- each tree (this one, and ``--root DIR``, a parent unpacked with ``git
  archive``) in a process of its own, in turns (root, this, this, root):
  the whole stack (``quantized_conv_features``: quantizes, convs and
  pools), each conv as the tree's stack calls it (its public entry point
  on the input the stack gives it) and, in a tree without the fused
  entry points, each pool pass; beside them the float path's folded
  cuDNN bf16 stack (``folded_conv_features``) and each cuDNN conv. ms a
  call by CUDA events over 10 calls, inputs warm in L2 where they fit;
- this tree's ``int8_conv_tc`` convs from copies of ``int8_conv.cu``
  with work cut out (one nvcc each, all started together, into
  ``vistaocr_tpu_torch/_build/profile/``), timed in turns with the
  kernel as it stands: ``no_mma`` (the wgmma cut: the loads, the ring
  and the epilogue), ``no_loads`` (the producer arrives on each stage
  without copying: the products on stale operands and the epilogue),
  ``no_epilogue`` (the dequantize, pool and quantize into the staging
  buffer cut), ``no_store`` (the tile's TMA store cut); ``full`` must be
  bit-equal to the library's output. Each edit is placed by a text
  anchor found once (``tests/test_torch_port_int8_fused.py -k anchors``
  checks them).

Bounds: bytes (each input, weight and output read or written once) at
3.35 TB/s against int8 operations at 1,979 TOP/s, the larger. Prints a
line a measurement and a JSON line; ``--out`` also writes the JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

SHAPES = ((128, 512), (32, 2048))  # (B, W): the smoke's INT8_TIMED
TURNS = ("root", "this", "this", "root")
REPS = 10
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

# --- the cut copies of int8_conv.cu ---------------------------------------
# each edit is made in both consumer schedules of int8_conv_tc: ping-pong
# (CO = 64, whole tiles a warpgroup) and cooperative (CO = 128 and 256)
_MMA_PP = ("            wgmma_s8<N>(acc[sl],\n"
           "                        wgmma_desc(pa + sl * (A_BYTES / 2) + 32 * j, 16, SBO,\n"
           "                                   LAYOUT),\n"
           "                        wgmma_desc(pb + 32 * j, 16, SBO, LAYOUT),\n"
           "                        kt > 0 || j > 0);\n")
_MMA_CO = ("          wgmma_s8<N>(acc, wgmma_desc(pa + 32 * j, 16, SBO, LAYOUT),\n"
           "                      wgmma_desc(pb + 32 * j, 16, SBO, LAYOUT),\n"
           "                      kt > 0 || j > 0);  // a tile starts at zero\n")
_ACC_PP = "    int acc[2][N / 2];\n"
_ACC_CO = "    int acc[N / 2];\n"
_LOADS = (
    "            mbar_arrive_expect_tx(&full[slot], stage);\n"
    "            tma_load_4d(st, &xmap, &full[slot], c0, w0 + kw - 1, h0 + kh - 1,\n"
    "                        b);\n"
    "            tma_load_4d(st + A_BYTES / 2, &xmap, &full[slot], c0,\n"
    "                        w0 + 7 + kw, h0 + kh - 1, b);\n"
    "            if (!a.resident) {\n"
    "              tma_load_2d(st + A_BYTES, &wmap, &full[slot], kt * KC, 0);\n"
    "            }\n")
_EPI_PP = ("          epi_quad(e, sg, q, sbt[n / 2], n * es, acc[sl][4 * j],\n"
           "                   acc[sl][4 * j + 1], acc[sl][4 * j + 2],\n"
           "                   acc[sl][4 * j + 3]);\n")
_EPI_CO = ("        epi_quad(e, sg, q, sbt[n / 2], n * es, acc[4 * j], acc[4 * j + 1],\n"
           "                 acc[4 * j + 2], acc[4 * j + 3]);\n")
_STORE_PP = ("          tma_store_4d(&ymap, mine + ((r * sg.P) << a.rbs), r * per,\n"
             "                       w0 / e.pw, h0 / e.ph, b);\n")
_STORE_CO = ("          tma_store_4d(&ymap, stg + ((r * sg.P) << a.rbs), r * per,\n"
             "                       w0 / e.pw, h0 / e.ph, b);\n")
RECIPES = {
    "full": (),
    "no_mma": ((_MMA_PP, ""), (_MMA_CO, ""),
               (_ACC_PP, "    int acc[2][N / 2] = {};\n"),
               (_ACC_CO, "    int acc[N / 2] = {};\n")),
    "no_loads": ((_LOADS, "            (void)st;\n"
                          "            mbar_arrive(&full[slot]);\n"),),
    # the staging writes (dequantize, pool, quantize) cut; one value a
    # thread still reaches shared memory, so the products stay
    "no_epilogue": (
        (_EPI_PP, "          if (j == 0) mine[tid] = static_cast<uint8_t>("
                  "acc[sl][0] + acc[sl][N / 2 - 1]);\n"),
        (_EPI_CO, "        if (j == 0) stg[threadIdx.x] = static_cast<uint8_t>("
                  "acc[0] + acc[N / 2 - 1]);\n")),
    "no_store": ((_STORE_PP, ""), (_STORE_CO, "")),  # the TMA stores cut
}
VARIANTS = tuple(RECIPES)


def variant_source(src: str, name: str) -> str:
    """``int8_conv.cu`` with variant ``name``'s edits; each anchor must be
    found once."""
    for anchor, text in RECIPES[name]:
        if src.count(anchor) != 1:
            raise RuntimeError(f"{name}: anchor found {src.count(anchor)} "
                               f"times in int8_conv.cu:\n{anchor}")
        src = src.replace(anchor, text)
    return src


def build(variants) -> dict:
    """One shared library a variant of this tree's int8_conv.cu, built by
    parallel nvcc processes."""
    from vistaocr_tpu_torch.ops import _build

    out = os.path.join(_build.BUILD_DIR, "profile")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(_build.CSRC, "int8_conv.cu")) as f:
        src = f.read()
    libs, cmds = {}, []
    for name in variants:
        cu = os.path.join(out, f"int8_conv_{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(src, name))
        libs[name] = os.path.join(out, f"libint8_conv_{name}.so")
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                     _build.CSRC, "-o", libs[name], cu])
    _build._run_all(cmds)
    loaded = {}
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        lib.vo_int8_conv_fused.restype = i
        lib.vo_int8_conv_fused.argtypes = [i] * 13 + [p] * 4 + [f, f, p, p]
        loaded[name] = lib
    return loaded


def cuda_ms(fn, reps: int = REPS) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def flagship_case(B: int, W: int, dev):
    """(config, QuantizedStack, images, widths): the flagship's conv widths
    in bf16, kernels from a seed, scales calibrated on the batch."""
    import numpy as np
    import torch
    from vistaocr_tpu_torch.models import ModelConfig, quant

    cfg = ModelConfig(num_classes=97, compute_dtype="bfloat16")
    rng = np.random.default_rng(B + W)
    chans = [1] + [st.channels for st in cfg.stages
                   for _ in range(st.num_convs)]
    ks = [rng.normal(0, np.sqrt(2 / (9 * chans[i])),
                     (chans[i + 1], chans[i], 3, 3)).astype(np.float32)
          for i in range(len(chans) - 1)]
    bs = [rng.normal(0, 0.1, c).astype(np.float32) for c in chans[1:]]
    images = torch.from_numpy(rng.integers(0, 256, (B, 32, W), np.uint8)).to(
        dev)
    widths = torch.full((B,), W, dtype=torch.int32, device=dev)
    scales = quant.calibrate_in_scales(ks, bs, cfg, [(images, widths)],
                                       device=dev)
    qs = quant.QuantizedStack(quant.quantize_conv_stack(ks, bs, scales), dev,
                              cfg.dtype)
    return cfg, qs, images, widths


def stack_steps(cfg, qs, images, widths):
    """The tree's stack step by step: [(name, fn, output)], each fn
    recomputing its output from the step before's."""
    from vistaocr_tpu_torch.models import quant
    from vistaocr_tpu_torch.ops import int8_conv as ic
    from vistaocr_tpu_torch.ops.preprocess import preprocess_images

    x = preprocess_images(images, widths, standardize=cfg.standardize_input,
                          dtype=cfg.dtype)
    steps = []
    if hasattr(quant, "conv_plan"):  # the fused stack
        for step in quant.conv_plan(cfg):
            if step[0] == "pool":
                fn = (lambda x=x, w=step[1]:
                      quant._nhwc_pool(x, w, cfg.conv_pool))
                name = "pool"
            else:
                c = qs.convs[step[1]]
                nxt = qs.convs[step[1] + 1].inv_s if step[3] else None
                fn = (lambda x=x, c=c, w=step[2], nxt=nxt:
                      ic.int8_conv_fused(x, c.weight, c.scale, c.bias,
                                         inv_s=c.inv_s, dtype=cfg.dtype,
                                         window=w, pool_impl=cfg.conv_pool,
                                         inv_s_next=nxt))
                name = f"conv{step[1]}"
            x = fn()
            steps.append((name, fn, x))
        return steps
    i = 0
    for st in cfg.stages:  # the parent: a conv a call, a pool pass a stage
        for _ in range(st.num_convs):
            c = qs.convs[i]
            fn = (lambda x=x, c=c:
                  ic.int8_conv(x, c.weight, c.scale, c.bias, c.inv_s))
            x = fn()
            steps.append((f"conv{i}", fn, x))
            i += 1
        fn = lambda x=x, w=st.pool: quant._nhwc_pool(x, w, cfg.conv_pool)
        x = fn()
        steps.append(("pool", fn, x))
    return steps


def child(B: int, W: int) -> dict:
    """This process's tree (the first on sys.path): the stack, each step,
    and the float path's cuDNN stack and convs, ms a call."""
    import torch
    import torch.nn.functional as F
    import vistaocr_tpu_torch
    from vistaocr_tpu_torch.models import quant
    from vistaocr_tpu_torch.ops.preprocess import preprocess_images
    from vistaocr_tpu_torch.runtime import disable_tf32

    disable_tf32()
    dev = torch.device("cuda")
    cfg, qs, images, widths = flagship_case(B, W, dev)
    out = {"package": os.path.dirname(vistaocr_tpu_torch.__file__)}
    with torch.inference_mode():
        out["stack_ms"] = cuda_ms(lambda: quant.quantized_conv_features(
            qs, images, widths, cfg))
        steps = stack_steps(cfg, qs, images, widths)
        out["steps"] = [[name, cuda_ms(fn)] for name, fn, _ in steps]
        out["convs_ms"] = sum(t for n, t in out["steps"] if n != "pool")
        out["pools_ms"] = sum(t for n, t in out["steps"] if n == "pool")
        out["float_stack_ms"] = cuda_ms(lambda: quant.folded_conv_features(
            qs.fkernels, [c.bias for c in qs.convs], images, widths, cfg))
        x = preprocess_images(images, widths,
                              standardize=cfg.standardize_input,
                              dtype=cfg.dtype)
        cudnn = []
        i = 0
        for st in cfg.stages:
            for _ in range(st.num_convs):
                xn = x.permute(0, 3, 1, 2).contiguous()
                cudnn.append(cuda_ms(lambda: F.conv2d(xn, qs.fkernels[i],
                                                      padding=1)))
                x = quant._float_conv(x, qs.fkernels[i], qs.convs[i].bias,
                                      cfg.dtype)
                i += 1
            x = quant._nhwc_pool(x, st.pool, cfg.conv_pool)
        out["cudnn_ms"] = cudnn
    return out


def bounds(qs, x0, steps) -> dict:
    """Each fused conv's bound and the stack's: bytes (the conv's input,
    packed weights, scale and bias, and output; for the stack the sum
    over its convs, so each int8 intermediate is written once and read
    once) at 3.35 TB/s against 2 * M * CO * 9 * CI int8 operations at
    1,979 TOP/s."""
    rows, total_ops, total_bytes = {}, 0.0, 0.0
    prev = x0
    for name, _, y in steps:
        x, prev = prev, y
        if name == "pool":
            continue
        c = qs.convs[int(name[4:])]
        ci, co = x.shape[-1], c.weight.shape[0]
        ops = 2.0 * x.shape[0] * x.shape[1] * x.shape[2] * co * 9 * ci
        nbytes = (x.numel() * x.element_size() + c.weight.numel() + 8 * co
                  + y.numel() * y.element_size())
        t_ops, t_bytes = ops / INT8_OPS_PER_S * 1e3, (
            nbytes / HBM_BYTES_PER_S * 1e3)
        rows[name] = {"ops": ops, "bytes": nbytes,
                      "bound_ms": max(t_ops, t_bytes),
                      "bound_by": "bytes" if t_bytes >= t_ops
                      else "operations"}
        total_ops += ops
        total_bytes += nbytes
    t_ops = total_ops / INT8_OPS_PER_S * 1e3
    t_bytes = total_bytes / HBM_BYTES_PER_S * 1e3
    return {"convs": rows, "stack": {
        "ops": total_ops, "bytes": total_bytes, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations"}}


def cuts(libs, B: int, W: int) -> dict:
    """This tree's tc convs through each cut copy, in turns, and full's
    output against the library's."""
    import torch
    from vistaocr_tpu_torch.models import quant
    from vistaocr_tpu_torch.ops import _build, int8_conv as ic
    from vistaocr_tpu_torch.ops.preprocess import preprocess_images

    dev = torch.device("cuda")
    cfg, qs, images, widths = flagship_case(B, W, dev)
    out = {}
    with torch.inference_mode():
        steps = stack_steps(cfg, qs, images, widths)
        prev = preprocess_images(images, widths,
                                 standardize=cfg.standardize_input,
                                 dtype=cfg.dtype)
        b = bounds(qs, prev, steps)
        plan = {f"conv{s[1]}": s for s in quant.conv_plan(cfg)
                if s[0] != "pool"}
        for name, _, y in steps:
            x, prev = prev, y
            if name == "pool" or x.dtype != torch.int8:
                continue
            s = plan[name]
            c = qs.convs[s[1]]
            if ic.conv_design(x.shape[-1], c.weight.shape[0], y.dtype,
                              s[2]) != "tc":
                continue
            Bx, H, Wx, ci = x.shape
            outs = {k: torch.empty_like(y) for k in libs}

            def call(k):
                _build.check(libs[k].vo_int8_conv_fused(
                    1, 2, 1, ic._TYPE_CODES[y.dtype], Bx, H, Wx, ci,
                    c.weight.shape[0], c.weight.shape[1], s[2][0], s[2][1],
                    int(cfg.conv_pool == "stride"), x.data_ptr(),
                    c.weight.data_ptr(), c.scale.data_ptr(),
                    c.bias.data_ptr(), ctypes.c_float(0.0),
                    ctypes.c_float(qs.convs[s[1] + 1].inv_s if s[3] else 0.0),
                    outs[k].data_ptr(),
                    torch.cuda.current_stream().cuda_stream), k)

            call("full")
            torch.cuda.synchronize()
            if not torch.equal(outs["full"], y):
                raise RuntimeError(f"{name}: the full copy differs from the "
                                   "library's output")
            times = {k: [] for k in libs}
            for turn in range(2):
                for k in (list(libs) if turn == 0 else list(libs)[::-1]):
                    times[k].append(cuda_ms(lambda: call(k)))
            out[name] = {"shape": [Bx, H, Wx, ci, c.weight.shape[0]],
                         "window": list(s[2]), "ms": times, **b["convs"][name]}
    return {"convs": out, "bounds": b}


def run_child(root: str, B: int, W: int) -> dict:
    res = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", f"{B}x{W}",
         "--root", os.path.abspath(root)],
        cwd=root, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"child in {root} failed:\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=",".join(f"{b}x{w}"
                                                 for b, w in SHAPES))
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--root", default=None,
                    help="also time this checkout's stack, in turns")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_int8_conv: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    if args.child:  # the tree at --root, ahead of this script's own
        sys.path.insert(0, args.root)
        B, W = (int(v) for v in args.child.split("x"))
        print(json.dumps(child(B, W)))
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    here = os.path.dirname(os.path.abspath(__file__))
    variants = args.variants.split(",")
    if "full" not in variants:
        variants.insert(0, "full")
    libs = build(variants)
    results = {}
    for shape in args.shapes.split(","):
        B, W = (int(v) for v in shape.split("x"))
        trees = {}
        for turn in TURNS:
            if turn == "root" and not args.root:
                continue
            r = run_child(args.root if turn == "root" else here, B, W)
            trees.setdefault(turn, []).append(r)
            print(f"{turn} B={B} W={W}: stack {r['stack_ms']:.4f} ms, convs "
                  f"{r['convs_ms']:.4f}, pools {r['pools_ms']:.4f}; steps "
                  + ", ".join(f"{n} {t:.4f}" for n, t in r["steps"])
                  + f"; cuDNN bf16 stack {r['float_stack_ms']:.4f}, convs "
                  + ", ".join(f"{t:.4f}" for t in r["cudnn_ms"])
                  + f" ({smi})", flush=True)
        c = cuts(libs, B, W)
        for name, row in c["convs"].items():
            print(f"cuts {name} {row['shape']} B={B} W={W} (bound "
                  f"{row['bound_ms']:.4f} ms, {row['bound_by']}): "
                  + "; ".join(f"{k} " + " / ".join(f"{v:.4f}" for v in t)
                              for k, t in row["ms"].items())
                  + f" ({smi})", flush=True)
        print(f"bounds B={B} W={W}: {json.dumps(c['bounds'])}", flush=True)
        results[f"B{B}_W{W}"] = {"trees": trees, "cuts": c}
    line = json.dumps({"int8_conv_profile": results, "card": smi})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
