#!/usr/bin/env python3
"""Where the f32-weight LSTM's large-batch frames go, and the cooperative
designs against a parent checkout's, on one NVIDIA GPU.

    python3 profile_lstm_f32_wide.py [--parts breakdown,turns,edges,steps]
        [--root DIR] [--out FILE]

f32 weights and streams, both directions, H=512 unless said, every row
valid. Builds copies of ``csrc/lstm_fwd.cu`` and ``csrc/lstm_bwd.cu``
(each file alone, one library a copy; one nvcc each, all started
together) into ``vistaocr_tpu_torch/_build/profile/`` and drives them
through ``ops/lstm_cuda.py``'s entry points. Parts:

- ``breakdown``: the per-frame designs cut apart. ``lstm_step`` at B=512,
  T=32 (``save_cell``): the kernel, a copy without its product (what is
  left is the loads, the cell update, the stores and the launch) and a
  copy that returns at once (the launch alone), each as CUDA-event ms a
  call and device us a launch (``torch.profiler``); the split frame loop
  (``bptt_cell`` + ``bptt_dh`` a frame) at B=128, T=128: each kernel's
  device us a launch, ``bptt_dh`` without its product loop, and the
  loop's wall time a frame (the call's event time less its gate GEMM's
  device time), whose excess over the two kernels is the launches' gaps.
  The new cooperative designs, ``lstm_fwd_rows`` (B=512, T=32) and
  ``lstm_bwd_rows`` (B=64/128/512), beside copies without their FMAs
  (what is left is the exchange, the waits and the cell work).
  (``lstm_fwd_grid``'s frame by clock64 stamps: ``profile_lstm_fwd.py``.)
- ``turns``: with ``--root`` (a parent unpacked with ``git archive``),
  the parent's kernels and this tree's, each by its own library's rule,
  in turns (parent, this, this, parent): the ``save_cell`` forward at
  (B, H) = (384, 512), (448, 512), (512, 512), (128, 1000), (256, 256)
  with T = 16384 / B, and the BPTT frames (gate GEMM + frame loop) at B/T
  = 64/256, 128/128, 512/32 and H=1000 at 128/128; beside them each of
  this tree's f32 designs named (forward: grid, rows, step; loop: split,
  rows, and fold and rows at B=32/512), the table the library's rules
  are set from.
- ``edges``: this tree's f32 designs named, and the one its rules pick,
  at the hidden sizes around the turns' H=512 (``FWD_EDGE_SHAPES``,
  ``LOOP_EDGE_SHAPES``): where the rules stop taking the cooperative
  designs.
- ``steps``: with ``--root``, one f32 train step of the flagship
  (``chip_smoke.f32_step``: forward and backward through the entry
  points) at (B, W) = (128, 512) and (512, 128), run from each tree's
  root in its own process (this tree's ``chip_smoke.py`` copied into the
  parent's), in turns, ms a step (CUDA events).

Every number is printed with the card's name and power limit; ``--out``
writes them as JSON. Each edit is placed by a text anchor; an anchor that
is not found exactly once stops the script.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

H = 512
FWD_TURN_SHAPES = ((384, 512), (448, 512), (512, 512), (128, 1000),
                   (256, 256))
LOOP_TURN_SHAPES = ((64, 256, 512), (128, 128, 512), (512, 32, 512),
                    (128, 128, 1000))
STEP_SHAPES = ((128, 512), (512, 128))
# (B, H) and (B, T, H) off the turns' H=512, T = 16384 / B: the forward's
# large B (lstm_fwd_rows takes two row groups up to H=528, one above), the
# frame loop's train buckets (lstm_bwd_rows fits up to H=688)
FWD_EDGE_SHAPES = tuple((B, h) for h in (256, 384, 528, 576, 640)
                        for B in (448, 512))
LOOP_EDGE_SHAPES = tuple((B, 16384 // B, h)
                         for h in (64, 128, 256, 384, 576, 640, 688)
                         for B in (64, 128, 512))

# (file, variant): the edits (anchor, replacement) of a copy
VARIANTS = {
    ("lstm_fwd.cu", "step_no_product"): (
        ("  gate_product<float, W, R>(acc, d.h_in, d.wh, B, H, b0, j0, sm);",
         "  // product cut"),),
    ("lstm_fwd.cu", "step_empty"): (
        ("  const Dir<S, W> d = blockIdx.z == 0 ? d0 : d1;\n"
         "  __shared__ __align__(16) Tiles sm;",
         "  if (H > 0) return;\n"
         "  const Dir<S, W> d = blockIdx.z == 0 ? d0 : d1;\n"
         "  __shared__ __align__(16) Tiles sm;"),),
    ("lstm_fwd.cu", "rows_no_fma"): (
        ("              for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(hk, "
         "w8[c], acc[i][c]);",
         "              acc[i][kk] += hk * (w8[kk] + w8[kk + 4]);"),),
    ("lstm_bwd.cu", "dh_no_product"): (
        ("  for (int g0 = k_lo; g0 < k_hi; g0 += SIMT_K) {\n"
         "    // converted at the store",
         "  for (int g0 = k_lo; g0 < k_lo; g0 += SIMT_K) {\n"
         "    // converted at the store"),),
    ("lstm_bwd.cu", "rows_no_fma"): (
        ("                for (int v = 0; v < 4; ++v) {\n"
         "                  acc[r4][v] = fmaf(x, wv[v], acc[r4][v]);\n"
         "                }",
         "                acc[r4][kk] += x * wv[kk];"),),
}


def variant_source(src: str, edits) -> str:
    for anchor, text in edits:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor[:70]!r}")
        src = src.replace(anchor, text)
    return src


def _bind(lib, kind: str):
    """The entry points ``ops/lstm_cuda.py`` calls, on a library built
    from lstm_fwd.cu (kind "fwd") or lstm_bwd.cu ("bwd") alone."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if kind == "fwd":
        lib.vo_lstm_fwd.restype = i
        lib.vo_lstm_fwd.argtypes = [i] * 5 + [p] + ([p] * 5 + [i]) * 2 + [p]
        lib.vo_lstm_fwd_named.restype = i
        lib.vo_lstm_fwd_named.argtypes = [i] + lib.vo_lstm_fwd.argtypes
        lib.vo_lstm_fwd_design.restype = i
        lib.vo_lstm_fwd_design.argtypes = [i] * 4
        lib.vo_lstm_fwd_scratch.restype = ll
        lib.vo_lstm_fwd_scratch.argtypes = [i, i]
    else:
        lib.vo_lstm_bwd_named.restype = i
        lib.vo_lstm_bwd_named.argtypes = [i] * 7 + [p] + ([p] * 8 + [i]) * 2 + [p]
        lib.vo_lstm_bwd_loop_design.restype = i
        lib.vo_lstm_bwd_loop_design.argtypes = [i] * 4
        lib.vo_lstm_bwd_scratch.restype = ll
        lib.vo_lstm_bwd_scratch.argtypes = [i] * 4
        lib.vo_lstm_bwd_gates_design.restype = i
        lib.vo_lstm_bwd_gates_design.argtypes = [i, i]
    return lib


def build(specs) -> dict:
    """One library a spec (key, csrc directory, file, edits), built by
    parallel nvcc processes, loaded and bound."""
    from vistaocr_tpu_torch.ops import _build

    out = os.path.join(_build.BUILD_DIR, "profile")
    os.makedirs(out, exist_ok=True)
    paths, cmds = {}, []
    for key, csrc, name, edits in specs:
        with open(os.path.join(csrc, name)) as f:
            src = variant_source(f.read(), edits)
        stem = key.replace(":", "_").replace("/", "_")
        cu = os.path.join(out, f"f32_wide_{stem}.cu")
        with open(cu, "w") as f:
            f.write(src)
        paths[key] = (os.path.join(out, f"libf32_wide_{stem}.so"), name)
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                     csrc, "-o", paths[key][0], cu])
    _build._run_all(cmds)
    return {k: _bind(ctypes.CDLL(p), "fwd" if n == "lstm_fwd.cu" else "bwd")
            for k, (p, n) in paths.items()}


class using:
    """Route ``ops/lstm_cuda.py``'s calls to the library ``lib``."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        from vistaocr_tpu_torch.ops import _build

        self.saved, _build._lib = _build._lib, self.lib

    def __exit__(self, *exc):
        from vistaocr_tpu_torch.ops import _build

        _build._lib = self.saved


def _event_ms(fn, reps: int = 5) -> float:
    import torch

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


def _device_us(fn, names) -> dict:
    """{name: (device us a launch, launches a call)} over one call of
    ``fn`` in a torch.profiler window (opened with small launches, a
    synchronise and a pause: the profiler drops device events near its
    edges)."""
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
        fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
    out = {}
    for n in names:
        v = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and n in e.name]
        out[n] = (sum(v) / len(v) if v else 0.0, len(v))
    return out


def _fwd_case(B, T, Hx, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    mask = torch.ones((T, 1, B), device="cuda")
    dirs = [(torch.randn((T, B, 4 * Hx), generator=g, device="cuda"),
             torch.randn((Hx, 4 * Hx), generator=g, device="cuda") / Hx ** 0.5,
             r) for r in (False, True)]
    return dirs, mask


def _loop_case(B, T, Hx, seed):
    import torch
    from vistaocr_tpu_torch.ops import lstm_cuda as L

    dirs, mask = _fwd_case(B, T, Hx, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    out = []
    with torch.no_grad():
        for (xw, wh, r), (ys, cs) in zip(dirs, L.lstm_forward_cells(
                dirs, mask, torch.float32, plain=True)):
            out.append((xw, wh, ys, cs,
                        torch.randn((T, B, Hx), generator=g, device="cuda"),
                        r))
    return out, mask


def breakdown(libs, smi) -> dict:
    import torch
    from vistaocr_tpu_torch.ops import lstm_cuda as L

    res = {}
    f32 = torch.float32
    with torch.no_grad():
        B, T = 512, 32
        dirs, mask = _fwd_case(B, T, H, 1)
        row = {}
        for v in ("full", "step_no_product", "step_empty"):
            with using(libs[f"this:fwd:{v}"]):
                def call():
                    return L.lstm_fwd(dirs, mask, f32, save_cell=True,
                                      design="step")
                ms = _event_ms(call)
                us, n = _device_us(call, ("lstm_step<",))["lstm_step<"]
            row[v] = {"ms": ms, "per_frame_us": ms / T * 1e3,
                      "device_us_a_launch": us, "launches": n}
        for v in ("full", "rows_no_fma"):
            with using(libs[f"this:fwd:{v}"]):
                def call():
                    return L.lstm_fwd(dirs, mask, f32, save_cell=True,
                                      design="rows")
                ms = _event_ms(call)
            row[f"lstm_fwd_rows_{v}"] = {"ms": ms,
                                         "per_frame_us": ms / T * 1e3}
        res["forward_B512_T32"] = row
        print(f"forward B={B} T={T} H={H} save_cell, both directions, us a "
              f"frame (event) / device us a launch: " + "; ".join(
                  f"{k} {r['per_frame_us']:.3f}" + (
                      f" / {r['device_us_a_launch']:.3f} x {r['launches']}"
                      if "launches" in r else "")
                  for k, r in row.items()) + f" ({smi})", flush=True)

        for B, T, Hx in ((128, 128, 512), (64, 256, 512), (512, 32, 512)):
            kdirs, mask = _loop_case(B, T, Hx, 2)
            row = {}
            loops = (("split", "full"), ("split", "dh_no_product"),
                     ("rows", "full"), ("rows", "rows_no_fma"))
            if B != 128:
                loops = loops[2:]
            for loop, v in loops:
                with using(libs[f"this:bwd:{v}"]):
                    def call():
                        return L.lstm_bptt_frames(kdirs, mask, f32, loop=loop)
                    ms = _event_ms(call, 3)
                    names = ("bptt_gates_gemm<", "bptt_cell<", "bptt_dh<",
                             "lstm_bwd_rows<")
                    dev = _device_us(call, names)
                loop_ms = ms - dev["bptt_gates_gemm<"][0] / 1e3
                r = {"call_ms": ms, "loop_per_frame_us": loop_ms / T * 1e3,
                     **{n[:-1] + "_us": dev[n][0] for n in names[1:]
                        if dev[n][1]},
                     **{n[:-1] + "_launches": dev[n][1] for n in names}}
                if loop == "split":
                    r["gaps_per_frame_us"] = r["loop_per_frame_us"] - (
                        r["bptt_cell_us"] + r["bptt_dh_us"])
                row[f"{loop}_{v}"] = r
            res[f"loop_B{B}_T{T}_H{Hx}"] = row
            print(f"frame loop B={B} T={T} H={Hx}, both directions: " +
                  "; ".join(f"{k}: " + ", ".join(
                      f"{n} {x:.3f}" for n, x in r.items()
                      if not n.endswith("launches")) for k, r in row.items())
                  + f" ({smi})", flush=True)
    return res


def _forward_designs(row: dict, dirs, mask) -> None:
    """Into ``row``: the design the loaded library's rule picks for
    ``dirs`` (f32, both directions), and each f32 design named, its ms a
    ``save_cell`` call and its largest difference from ``lstm_step``'s
    outputs; a design the library refuses (it does not fit) is recorded
    so."""
    import torch
    from vistaocr_tpu_torch.ops import _build
    from vistaocr_tpu_torch.ops import lstm_cuda as L

    f32 = torch.float32
    B, Hx = dirs[0][0].shape[1], dirs[0][1].shape[0]
    row["this_design"] = L.FWD_DESIGNS[
        _build.load().vo_lstm_fwd_design(0, B, Hx, 2)]
    ref = L.lstm_fwd(dirs, mask, f32, save_cell=True, design="step")
    for design in ("grid", "rows", "step"):
        try:
            got = L.lstm_fwd(dirs, mask, f32, save_cell=True, design=design)
        except RuntimeError as e:  # the design does not fit
            row[f"{design}_ms"] = f"refused: {e}"
            continue
        torch.cuda.synchronize()
        row[f"{design}_max_abs_diff_from_step"] = max(
            (a - b).abs().max().item() for a, b in zip(
                got[0] + got[1], ref[0] + ref[1]))
        row[f"{design}_ms"] = _event_ms(
            lambda d=design: L.lstm_fwd(dirs, mask, f32, save_cell=True,
                                        design=d))


def _loop_designs(row: dict, kdirs, mask, loops) -> None:
    """Into ``row``: the frame loop the loaded library's rule picks for
    ``kdirs`` (f32, both directions), and each of ``loops`` named, its ms
    a call (gate GEMM included) and its largest relative difference from
    the split's dxw; a loop the library refuses is recorded so; and the
    gate GEMM's device ms."""
    import torch
    from vistaocr_tpu_torch.ops import _build
    from vistaocr_tpu_torch.ops import lstm_cuda as L

    f32 = torch.float32
    B, Hx = kdirs[0][0].shape[1], kdirs[0][1].shape[0]
    row["this_design"] = L.LOOP_DESIGNS[
        _build.load().vo_lstm_bwd_loop_design(0, B, Hx, 2)]
    ref = L.lstm_bptt_frames(kdirs, mask, f32, loop="split")
    for loop in loops:
        try:
            got = L.lstm_bptt_frames(kdirs, mask, f32, loop=loop)
        except RuntimeError as e:  # the design does not fit
            row[f"{loop}_ms"] = f"refused: {e}"
            continue
        torch.cuda.synchronize()
        row[f"{loop}_max_rel_diff_from_split"] = max(
            ((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(got, ref))
        row[f"{loop}_ms"] = _event_ms(
            lambda lp=loop: L.lstm_bptt_frames(kdirs, mask, f32, loop=lp), 3)
    gemm = _device_us(lambda: L.lstm_bptt_frames(
        kdirs, mask, f32, loop="split"), ("bptt_gates_gemm<",))
    row["gates_gemm_ms"] = gemm["bptt_gates_gemm<"][0] / 1e3


def turns(libs, smi) -> dict:
    import torch
    from vistaocr_tpu_torch.ops import lstm_cuda as L

    f32 = torch.float32
    res = {"forward": [], "loop": []}
    order = ("parent", "this", "this", "parent")
    with torch.no_grad():
        for B, Hx in FWD_TURN_SHAPES:
            T = 16384 // B
            dirs, mask = _fwd_case(B, T, Hx, B + Hx)
            row = {"B": B, "T": T, "H": Hx}
            for who in order:
                with using(libs[f"{who}:fwd:full"]):
                    row.setdefault(f"{who}_ms", []).append(_event_ms(
                        lambda: L.lstm_fwd(dirs, mask, f32, save_cell=True)))
            with using(libs["this:fwd:full"]):
                _forward_designs(row, dirs, mask)
            res["forward"].append(row)
            print(f"forward turns B={B} T={T} H={Hx} save_cell, both "
                  f"directions, ms a call: " + ", ".join(
                      f"{k} {v}" for k, v in row.items()
                      if k not in ("B", "T", "H")) + f" ({smi})", flush=True)
        for B, T, Hx in (*LOOP_TURN_SHAPES, (32, 512, 512)):
            kdirs, mask = _loop_case(B, T, Hx, B + T)
            row = {"B": B, "T": T, "H": Hx}
            if B != 32:
                for who in order:
                    with using(libs[f"{who}:bwd:full"]):
                        row.setdefault(f"{who}_ms", []).append(_event_ms(
                            lambda: L.lstm_bptt_frames(kdirs, mask, f32), 3))
            with using(libs["this:bwd:full"]):
                _loop_designs(row, kdirs, mask,
                              ("split", "fold", "rows") if B in (32, 512)
                              else ("split", "rows"))
            res["loop"].append(row)
            print(f"frame loop turns B={B} T={T} H={Hx}, both directions, ms "
                  f"a call (gate GEMM + loop): " + ", ".join(
                      f"{k} {v}" for k, v in row.items()
                      if k not in ("B", "T", "H")) + f" ({smi})", flush=True)
    return res


def edges(libs, smi) -> dict:
    """This tree's f32 designs named, beside its rules' picks, at
    ``FWD_EDGE_SHAPES`` and ``LOOP_EDGE_SHAPES``."""
    import torch

    res = {"forward": [], "loop": []}
    with torch.no_grad():
        for B, Hx in FWD_EDGE_SHAPES:
            T = 16384 // B
            dirs, mask = _fwd_case(B, T, Hx, B + Hx)
            row = {"B": B, "T": T, "H": Hx}
            with using(libs["this:fwd:full"]):
                _forward_designs(row, dirs, mask)
            res["forward"].append(row)
            print(f"forward edge B={B} T={T} H={Hx} save_cell, both "
                  f"directions, ms a call: " + ", ".join(
                      f"{k} {v}" for k, v in row.items()
                      if k not in ("B", "T", "H")) + f" ({smi})", flush=True)
        for B, T, Hx in LOOP_EDGE_SHAPES:
            kdirs, mask = _loop_case(B, T, Hx, B + T)
            row = {"B": B, "T": T, "H": Hx}
            with using(libs["this:bwd:full"]):
                _loop_designs(row, kdirs, mask, ("split", "rows"))
            res["loop"].append(row)
            print(f"frame loop edge B={B} T={T} H={Hx}, both directions, ms "
                  f"a call (gate GEMM + loop): " + ", ".join(
                      f"{k} {v}" for k, v in row.items()
                      if k not in ("B", "T", "H")) + f" ({smi})", flush=True)
    return res


STEP_CODE = """
import json, torch, chip_smoke as c
from vistaocr_tpu_torch.runtime import disable_tf32
disable_tf32()
out = {}
for B, W in %r:
    s = c.f32_step(torch.device("cuda"), c.glyph_font(17), B, W)
    out[f"{B}x{W}"] = [c._cuda_ms(s, 3) for _ in range(2)]
print("STEP " + json.dumps(out))
"""


def steps(root: str, smi) -> dict:
    """ms of one f32 train step at STEP_SHAPES from each tree's root, in
    its own process, in turns (parent, this, this, parent)."""
    here = os.path.dirname(os.path.abspath(__file__))
    shutil.copy(os.path.join(here, "chip_smoke.py"),
                os.path.join(root, "chip_smoke.py"))
    res = {}
    for who in ("parent", "this", "this", "parent"):
        proc = subprocess.run(
            [sys.executable, "-c", STEP_CODE % (STEP_SHAPES,)],
            cwd=root if who == "parent" else here, capture_output=True,
            text=True, timeout=900)
        line = [x for x in proc.stdout.splitlines() if x.startswith("STEP ")]
        if proc.returncode or not line:
            raise RuntimeError(f"{who} step failed: {proc.stderr[-2000:]}")
        for k, v in json.loads(line[0][5:]).items():
            res.setdefault(k, {}).setdefault(who, []).extend(v)
    for k, v in res.items():
        print(f"f32 train step {k} (B x W), ms a step in turns: parent "
              f"{v['parent']}, this {v['this']} ({smi})", flush=True)
    return res


def main(argv) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default="breakdown,turns,edges,steps")
    ap.add_argument("--root", default=None,
                    help="a parent checkout for the turns and steps")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    parts = args.parts.split(",")
    if not torch.cuda.is_available():
        print("profile_lstm_f32_wide: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    if ("turns" in parts or "steps" in parts) and not args.root:
        ap.error("--root is needed for the turns and steps")
    from vistaocr_tpu_torch.ops import _build
    from vistaocr_tpu_torch.runtime import disable_tf32

    disable_tf32()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    specs = [("this:fwd:full", _build.CSRC, "lstm_fwd.cu", ()),
             ("this:bwd:full", _build.CSRC, "lstm_bwd.cu", ())]
    if "breakdown" in parts:
        specs += [(f"this:{'fwd' if f == 'lstm_fwd.cu' else 'bwd'}:{v}",
                   _build.CSRC, f, edits)
                  for (f, v), edits in VARIANTS.items()]
    if "turns" in parts:
        parent = os.path.join(args.root, "vistaocr_tpu_torch", "csrc")
        specs += [("parent:fwd:full", parent, "lstm_fwd.cu", ()),
                  ("parent:bwd:full", parent, "lstm_bwd.cu", ())]
    t0 = time.time()
    libs = build(specs)
    print(f"built {len(specs)} libraries in {time.time() - t0:.1f} s",
          flush=True)
    out = {"card": smi}
    if "breakdown" in parts:
        out["breakdown"] = breakdown(libs, smi)
    if "turns" in parts:
        out["turns"] = turns(libs, smi)
    if "edges" in parts:
        out["edges"] = edges(libs, smi)
    if "steps" in parts:
        out["steps"] = steps(args.root, smi)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
