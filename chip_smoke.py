#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line before it starts; any failure raises, so
the exit code is non-zero and no ``ok`` line is printed):

1. device  - require CUDA; print the card's name and power limit.
2. build   - build the kernels from ``vistaocr_tpu_torch/csrc`` (nvcc).
3. kernel  - the LSTM recurrence kernel against its plain PyTorch version
             on the card: the flagship shape (B=128, T=512, H=512, both
             directions, ragged mask) and an odd shape (B=5, T=7, H=40),
             f32 streams (TF32 off) within 1e-4, bf16 streams within
             3e-2; both timed with CUDA events after warm-up.
4. service - the flagship model (bf16, seeded random weights) behind
             ``OcrService`` (max_batch=128, max_wait_ms=2.0): ~256 lines
             at height 32, 8 at heights 48/64 (device resize) through
             ``ocr_lines``, 16 through ``submit``; the kernel's launch
             counter must grow.
5. parity  - the same snapshot in f32: ``lstm_impl="scan"`` (plain)
             against ``"auto"`` (kernel), log-probs within 1e-3 on valid
             frames, greedy ids equal where the plain run's top-2 margin
             exceeds 1e-2.

The last three lines are a JSON object with one row per kernel, the
``nvidia-smi`` name/power-limit line, and the ``ok`` JSON object.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import numpy as np


def _phase(name: str) -> None:
    print(f"== phase: {name}", flush=True)


def _require(ok, what) -> None:
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _cuda_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _recurrence_case(B, T, H, dtype, dev, seed):
    """Seeded xw [T,B,4H] (both directions), ragged mask [T,1,B] (random
    lengths >= 1, row 0 full) and wh [H,4H] on the card."""
    import torch

    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, T + 1, B)
    lengths[0] = T
    mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    out = []
    for _ in range(2):
        xw = rng.normal(0.0, 1.0, (T, B, 4 * H)).astype(np.float32)
        wh = rng.normal(0.0, 1.0 / np.sqrt(H), (H, 4 * H)).astype(np.float32)
        out.append((torch.from_numpy(xw).to(dev, dtype),
                    torch.from_numpy(wh).to(dev, dtype)))
    m = torch.from_numpy(mask[:, None, :]).to(dev)
    return out, m


FLAGSHIP_SHAPE = (128, 512, 512)  # (B, T, H): max_batch, 2048 px / 4, hidden
ODD_SHAPE = (5, 7, 40)


def kernel_phase(dev, card: str, shapes=(ODD_SHAPE, FLAGSHIP_SHAPE)) -> dict:
    """Kernel vs plain on every shape; times at the last (flagship) one."""
    import torch
    from vistaocr_tpu_torch.ops import lstm_cuda

    tol = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
    row = {}
    for (B, T, H) in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            (fwd, bwd), mask = _recurrence_case(B, T, H, dtype, dev, seed=B + T)
            with torch.inference_mode():
                ys_f, ys_b = lstm_cuda.blstm_recurrence(
                    fwd[0], bwd[0], mask, fwd[1], bwd[1], dtype=dtype)
                one = lstm_cuda.lstm_recurrence(
                    bwd[0], mask, bwd[1], reverse=True, dtype=dtype)
                ref_f = lstm_cuda.lstm_recurrence_ref(
                    fwd[0], mask, fwd[1], reverse=False, dtype=dtype)
                ref_b = lstm_cuda.lstm_recurrence_ref(
                    bwd[0], mask, bwd[1], reverse=True, dtype=dtype)
                torch.cuda.synchronize()
                err = max(
                    (ys_f.float() - ref_f.float()).abs().max().item(),
                    (ys_b.float() - ref_b.float()).abs().max().item(),
                    (one.float() - ref_b.float()).abs().max().item(),
                )
            ok = np.isfinite(err) and err <= tol[dtype]
            tag = f"B={B} T={T} H={H} {str(dtype).replace('torch.', '')}"
            print(f"kernel vs plain {tag}: max|d|={err:.3e} "
                  f"(tol {tol[dtype]:g}) {'ok' if ok else 'FAIL'}", flush=True)
            _require(ok, f"LSTM kernel agrees with plain: {tag}")
            if (B, T, H) != shapes[-1]:
                continue

            def kern():
                lstm_cuda.blstm_recurrence(fwd[0], bwd[0], mask, fwd[1],
                                           bwd[1], dtype=dtype)

            def plain():
                lstm_cuda.lstm_recurrence_ref(fwd[0], mask, fwd[1],
                                              reverse=False, dtype=dtype)
                lstm_cuda.lstm_recurrence_ref(bwd[0], mask, bwd[1],
                                              reverse=True, dtype=dtype)

            with torch.inference_mode():
                ms = _cuda_ms(kern, 10)
                plain_ms = _cuda_ms(plain, 3)
            print(f"time {tag}, both directions: kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms ({card})", flush=True)
            row[dtype] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return row


def _lines(rng, n, height, wmin, wmax):
    """Seeded text-like line images: paper with dark strokes."""
    out = []
    for _ in range(n):
        w = int(rng.integers(wmin, wmax + 1))
        img = np.full((height, w), 255, np.uint8)
        for _ in range(max(3, w // 10)):
            y = int(rng.integers(2, height - 2))
            x = int(rng.integers(0, w))
            lw = int(rng.integers(1, 12))
            img[y - 2 : y + 2, x : x + lw] = int(rng.integers(0, 90))
        out.append(img)
    return out


def flagship_snapshot(path: str) -> None:
    """The flagship ModelConfig in bf16, seeded random initialisation."""
    import torch
    from vistaocr_tpu_torch.checkpoint import save_snapshot
    from vistaocr_tpu_torch.data import ShapeContract
    from vistaocr_tpu_torch.models import CnnLstmOcr, ModelConfig, init_parameters
    from vistaocr_tpu_torch.text import Alphabet

    alphabet = Alphabet.from_charset(
        "".join(chr(c) for c in range(0x20, 0x7F)))
    cfg = ModelConfig(num_classes=alphabet.num_classes,
                      compute_dtype="bfloat16")
    model = CnnLstmOcr(cfg)
    init_parameters(model, torch.Generator().manual_seed(1234))
    save_snapshot(path, state_dict=model.state_dict(), model_config=cfg,
                  alphabet=alphabet, contract=ShapeContract())


def service_phase(snap: str, card: str, smi: str) -> int:
    from vistaocr_tpu_torch.ops import lstm_cuda
    from vistaocr_tpu_torch.serve import OcrService, ServiceConfig

    rng = np.random.default_rng(7)
    bulk = _lines(rng, 256, 32, 40, 2048)
    bulk += _lines(rng, 4, 48, 40, 3000) + _lines(rng, 4, 64, 40, 4000)
    online = _lines(rng, 16, 32, 40, 1024)
    t0 = time.time()
    svc = OcrService(snap, ServiceConfig(max_batch=128, max_wait_ms=2.0),
                     device="cuda")
    try:
        print(f"service init {time.time() - t0:.2f} s {svc.init_timings}",
              flush=True)
        lstm_cuda.LAUNCHES = 0
        t0 = time.time()
        results = svc.ocr_lines(bulk)
        dt = time.time() - t0
        futures = [svc.submit(img) for img in online]
        results += [f.result(timeout=300) for f in futures]
        launches = lstm_cuda.LAUNCHES
        n = len(bulk) + len(online)
        _require(len(results) == n, f"{len(results)} results for {n} lines")
        for r in results:
            _require(isinstance(r.text, str), f"str text: {r}")
            _require(r.latency_ms > 0, f"latency_ms > 0: {r}")
            _require(r.confidence is not None and 0 < r.confidence <= 1,
                     f"0 < confidence <= 1: {r}")
        _require(svc.stats["lines"] == n, f"stats[lines] == {n}: {svc.stats}")
        _require(launches > 0, "the LSTM kernel was not launched")
        print(f"ocr_lines: {len(bulk)} lines in {dt:.3f} s = "
              f"{len(bulk) / dt:.1f} lines/s ({smi}); stats {svc.stats}; "
              f"kernel launches {launches}", flush=True)
        print(f"sample: {results[0].text!r} conf={results[0].confidence:.4f}"
              f" bucket={results[0].bucket_width}", flush=True)
    finally:
        svc.close()
    return launches


def parity_phase(snap: str, dev) -> None:
    import torch
    from vistaocr_tpu_torch.checkpoint import load_model

    rng = np.random.default_rng(11)
    B, W = 32, 1024
    images = rng.integers(0, 256, (B, 32, W), np.uint8)
    widths = rng.integers(40, W + 1, B).astype(np.int32)
    widths[0] = W
    out = {}
    for impl in ("scan", "auto"):
        model, _, _ = load_model(snap, dev, compute_dtype="float32",
                                 lstm_impl=impl)
        with torch.inference_mode():
            lp, fm = model(torch.from_numpy(images).to(dev),
                           torch.from_numpy(widths).to(dev))
        out[impl] = (lp.float().cpu().numpy(), fm.cpu().numpy())
    (lp_p, fm_p), (lp_k, fm_k) = out["scan"], out["auto"]
    _require(lp_k.shape == (B, W // 4, lp_p.shape[2]),
             f"log-prob shape {lp_k.shape}")
    _require((fm_p == fm_k).all(), "frame masks equal")
    _require(np.isfinite(lp_k[fm_k]).all(), "finite log-probs")
    err = float(np.abs(lp_p - lp_k)[fm_p].max())
    top2 = np.sort(lp_p, axis=-1)[..., -2:]
    confident = fm_p & ((top2[..., 1] - top2[..., 0]) > 1e-2)
    ids_p, ids_k = lp_p.argmax(-1), lp_k.argmax(-1)
    mismatched = int((ids_p != ids_k)[confident].sum())
    print(f"f32 parity scan vs kernel: max|d log p|={err:.3e} (tol 1e-3) "
          f"on {int(fm_p.sum())} valid frames; greedy ids compared on "
          f"{int(confident.sum())}, excluded {int(fm_p.sum() - confident.sum())}"
          f" (top-2 margin <= 1e-2), mismatched {mismatched}", flush=True)
    _require(err <= 1e-3, f"log-prob parity {err:.3e} <= 1e-3")
    _require(mismatched == 0, f"{mismatched} greedy ids differ")


def main() -> int:
    _phase("device")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    dev = torch.device("cuda", 0)
    print(f"card: {card}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    from vistaocr_tpu_torch.ops import _build
    from vistaocr_tpu_torch.runtime import disable_tf32

    disable_tf32()
    _phase("build")
    t0 = time.time()
    _build.load()
    print(f"kernels built/loaded in {time.time() - t0:.2f} s "
          f"({_build.library_path()})", flush=True)

    _phase("kernel")
    rows = kernel_phase(dev, f"{card}, {smi}")

    with tempfile.TemporaryDirectory() as tmp:
        flagship_snapshot(tmp)
        _phase("service")
        launches = service_phase(tmp, card, smi)
        _phase("parity")
        parity_phase(tmp, dev)

    bf16, f32 = rows[torch.bfloat16], rows[torch.float32]
    print(json.dumps({"kernels": [{
        "name": "lstm_fwd",
        "route": "cuda",
        "source": "vistaocr_tpu_torch/csrc/lstm_fwd.cu",
        "replaces": "vistaocr_tpu/ops/lstm_pallas.py:51",
        "launches": launches,
        "max_abs_err": bf16["max_abs_err"],
        "ms": bf16["ms"],
        "plain_ms": bf16["plain_ms"],
        "f32_max_abs_err": f32["max_abs_err"],
        "f32_ms": f32["ms"],
        "f32_plain_ms": f32["plain_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
