#!/usr/bin/env python3
"""Times of the direction-stacked BLSTM entries (K6a ``vo_bi_lstm_fwd``,
K6b ``vo_bi_lstm_bwd``, ``vistaocr_tpu_torch/csrc/lstm_bi_stacked.cu``)
and of what they stand beside, on one NVIDIA GPU, for this checkout and
another one (``--root``, a parent unpacked with ``git archive``) in
turns: the other tree, this one, this one, the other tree, ``--turns``
times.

    python3 profile_bi_stacked.py [--root DIR] [--turns 2]
        [--parts stacked,layer,path,step]

Each tree runs in a process of its own (this script with ``--child``,
its working directory and first path entry the tree's root, so that it
imports that tree's ``vistaocr_tpu_torch``; the glyph data and snapshot
helpers are this checkout's ``chip_smoke.py``). A process times, by CUDA
events after a warm-up (ms a call, the median of 3 runs of 5 calls):

- ``stacked``: ``bi_lstm_fwd_cuda`` and ``bi_lstm_bwd_cuda`` (the BPTT on
  the stacked forward's ys and cs) at H=512, B/T 32/512 and 128/128,
  weights in bf16 and in f32, the designs a tree names (``bi_design``,
  where it has one); and, where the tree's ``lstm_cuda`` takes a mask a
  direction, the layer route on dense copies of the same planes (a mask
  each, ``reverse=False``, the same type code: ``chip_smoke``'s
  ``bi_layer_route``), with the stacked outputs' bit-equality to it and
  the device time of each BPTT kernel in both (``torch.profiler``, a
  window padded as ``chip_smoke._kernel_us`` pads it);
- ``layer``: the production layer route itself at the same shapes, bf16
  streams and weights (the flagship's type code) and f32: ``lstm_fwd``
  (``save_cell``), ``lstm_bptt_frames`` and ``lstm_dwh`` of two
  directions with one mask, each call's device time by kernel, and a
  SHA-256 of their outputs, so that the trees' kernels are held to each
  other bit for bit;
- ``path``: phase 9's bf16 side-by-side, the flagship's train-mode
  forward+backward at B=32, W=2048 with the experiments in place
  (``forward_with_experiments``) and with ``model.forward``;
- ``step``: the flagship's bf16 train step at B=32, W=2048
  (``chip_smoke.f32_step``).

Prints a line a part and tree, the card's name and power limit, and a
JSON line of every reading; ``--out`` also writes the JSON.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
H = 512
SHAPES = ((32, 512), (128, 128))  # (B, T)
PARTS = ("stacked", "layer", "path", "step")
PATH_BATCH = (32, 2048)  # (B, W)


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
        for _ in range(5):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / 5)
    return float(np.median(runs))


def _device_us(fn) -> dict:
    """Device time (us) of one call of ``fn`` by kernel (the name up to
    its template arguments), summed over its launches, from a
    ``torch.profiler`` window after a warm-up; the window opens with 64
    small launches and closes after a synchronise and a pause, so that no
    launch of the call falls outside it."""
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
        fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
    out: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "elementwise" in e.name and "Add" in e.name:  # the pad
            continue
        name = (e.name.replace("(anonymous namespace)::", "")
                .replace("void ", "").split("<")[0].split("(")[0])
        out[name] = out.get(name, 0.0) + e.time_range.elapsed_us()
    return out


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _stacked(c, dev) -> dict:
    import torch
    from vistaocr_tpu_torch.experiments import lstm_bi_stacked as S
    from vistaocr_tpu_torch.ops import lstm_cuda as L

    out = {}
    for B, T in SHAPES:
        rng = np.random.default_rng(B * T + H)
        lengths = rng.integers(1, T + 1, B)
        lengths[0] = T
        m = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
        mask = torch.from_numpy(np.ascontiguousarray(
            np.stack([m, m[::-1]], axis=1))).to(dev)
        xw = torch.from_numpy(rng.normal(0, 1, (T, 2, B, 4 * H)).astype(
            np.float32)).to(dev)
        wh = torch.from_numpy(rng.normal(0, 1 / np.sqrt(H), (2, H, 4 * H))
                              .astype(np.float32)).to(dev)
        dys = torch.from_numpy(rng.normal(0, 1, (T, 2, B, H)).astype(
            np.float32)).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            whq = wh.to(dtype).contiguous()
            with torch.no_grad():
                ys, cs = S.bi_lstm_fwd_cuda(xw, mask, whq, dtype)
                dxw, dwh = S.bi_lstm_bwd_cuda(xw, mask, whq, ys, cs, dys,
                                              dtype)
                row = {
                    "fwd_ms": _ms(lambda: S.bi_lstm_fwd_cuda(xw, mask, whq,
                                                             dtype)),
                    "bwd_ms": _ms(lambda: S.bi_lstm_bwd_cuda(
                        xw, mask, whq, ys, cs, dys, dtype)),
                }
                if hasattr(S, "bi_design"):
                    row["design"] = S.bi_design(dtype, B, H)
                if hasattr(L, "_mask_ptrs"):  # a mask a direction
                    fwd, bwd = c.bi_layer_route(xw, mask, whq, dtype, ys, cs,
                                                dys)
                    lys, lcs = fwd()
                    ldxw, ldwh = bwd()
                    row["route_fwd_ms"] = _ms(fwd)
                    row["route_bwd_ms"] = _ms(bwd)
                    row["bwd_kernels_us"] = {
                        "stacked": _device_us(lambda: S.bi_lstm_bwd_cuda(
                            xw, mask, whq, ys, cs, dys, dtype)),
                        "route": _device_us(bwd)}
                    row["bit_equal"] = all(
                        torch.equal(a[:, k], b[k])
                        for a, b in ((ys, lys), (cs, lcs), (dxw, ldxw))
                        for k in range(2)) and all(
                        torch.equal(dwh[k], ldwh[k]) for k in range(2))
            out[f"B{B}_T{T}_{str(dtype)[6:]}"] = row
    return out


def _layer(c, dev) -> dict:
    import torch
    from vistaocr_tpu_torch.ops import lstm_cuda as L

    out = {}
    for B, T in SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            (xw_wh, mask) = c._recurrence_case(B, T, H, dtype, dev,
                                               seed=B + T)
            xw = [x for x, _ in xw_wh]
            whq = [w.contiguous() for _, w in xw_wh]
            rng = np.random.default_rng(T)
            dys = [torch.from_numpy(rng.normal(0, 1, (T, B, H)).astype(
                np.float32)).to(dev, dtype) for _ in range(2)]
            dirs = [(xw[0], whq[0], False), (xw[1], whq[1], True)]
            with torch.no_grad():
                ys, cs = L.lstm_fwd(dirs, mask, dtype, save_cell=True)
                bdirs = [(xw[k], whq[k], ys[k], cs[k], dys[k], bool(k))
                         for k in range(2)]
                dxw = L.lstm_bptt_frames(bdirs, mask, dtype)
                ddirs = [(ys[k], dxw[k], bool(k)) for k in range(2)]
                dwh = L.lstm_dwh(ddirs, dtype)
                out[f"B{B}_T{T}_{str(dtype)[6:]}"] = {
                    "fwd_ms": _ms(lambda: L.lstm_fwd(dirs, mask, dtype,
                                                     save_cell=True)),
                    "frames_ms": _ms(lambda: L.lstm_bptt_frames(bdirs, mask,
                                                                dtype)),
                    "dwh_ms": _ms(lambda: L.lstm_dwh(ddirs, dtype)),
                    "sha256": _digest([*ys, *cs, *dxw, *dwh]),
                    "device_us": {
                        **_device_us(lambda: L.lstm_fwd(dirs, mask, dtype,
                                                        save_cell=True)),
                        **_device_us(lambda: L.lstm_bptt_frames(bdirs, mask,
                                                                dtype)),
                        **_device_us(lambda: L.lstm_dwh(ddirs, dtype))},
                }
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
    fns = {"stacked": _stacked, "layer": _layer, "path": _path,
           "step": _step}
    return {p: fns[p](c, dev) for p in parts}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="another checkout, timed in turns with this one")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--parts", default=",".join(PARTS))
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
        print("profile_bi_stacked: torch.cuda.is_available() is False",
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
            [sys.executable, os.path.join(HERE, "profile_bi_stacked.py"),
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
