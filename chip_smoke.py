#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths once on one
NVIDIA GPU.

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
6. train-kernels - each training kernel against its plain version, TF32
             off, f32 and bf16: the ``save_cell`` forward and the BPTT
             (frames + dwh) of both directions at an odd shape (B=5, T=7,
             H=40) and the flagship training shapes (B=32, T=512 and
             B=128, T=128, H=512); the CTC alpha/beta recursions at an odd
             shape (empty label, infeasible sample) and B=32, T=512,
             L=255, K=96. Times from CUDA events after warm-up.
7. train   - ``train.fit`` with the flagship ``TrainConfig`` (bf16,
             dropout 0.1, Adam 1e-3, clip 5, ``--preset full``: auto
             ladder over a 2**21-pixel budget) on a seeded glyph data set
             (a random bitmap per character, lines 40-2048 px, 3000 train
             and 128 val lines, written with the port's ``ShardWriter``):
             40 steps and one validation; the loss must be finite and its
             last-10 mean below its first-10 mean, and every training
             kernel's launch counter must grow.
8. train-parity - one f32 train-mode forward/backward of the flagship
             model from the same parameters with ``lstm_impl``/``ctc_impl``
             ``"auto"`` (kernels) against ``"scan"`` (plain): the loss within
             1e-5 relative and every gradient within 2e-3 of its tensor's
             largest magnitude (f32 sums in another order: tiled products in
             the recurrence and one dwh sum over (T-1)*B rows instead of one
             per frame, compounded over 256 frames; the class fold's
             ``scatter_add`` uses atomics).
9. experiments - the experiments' kernels (``vistaocr_tpu_torch/
             experiments``) against their plain versions, TF32 off, f32
             within 1e-4 (dK, dxw and dwh relative to their tensor's
             largest magnitude: sums of up to 2**21 products); bf16 stem
             out/xn at most one bf16 ulp (plus 2e-6) apart in at most
             2e-3 of the elements, dK within 1e-4 relative, ys/cs within
             2**-8, dxw and dwh within 5e-3 relative: the fused stem
             K7a/K7b at B=3, W=45 (one width < W) and the flagship train
             shapes B=32, W=2048 and B=128, W=512 (H=32, CO=64); the
             direction-stacked BLSTM K6a/K6b at B=5, T=7, H=40 (ragged
             mask) and B=32, T=512 / B=128, T=128 (H=512). At the
             flagship shapes each is timed beside its plain version and
             the production path it would replace
             (``preprocess_images`` + cuDNN conv and its weight gradient;
             the K1 ``save_cell`` forward and K2/K3 BPTT of one
             ``BLSTMStack`` layer), and compared with it in f32. Then the
             flagship path with both experiments in place
             (``forward_with_experiments``: fused stem -> ConvStack ->
             bridge -> ``bilstm_layer_stacked`` per layer -> head) on the
             flagship snapshot's weights in f32 (dropout and augment off),
             one glyph batch at B=32, W=2048, against ``model.forward(
             train=True)``: log-probs within 1e-3 on valid frames, every
             gradient of the same CTC loss within 2e-3 of its tensor's
             largest magnitude; each of the four kernels' launch counters
             must grow in that run. The same two paths in bf16 are timed
             side by side: finite log-probs, each loss within 1e-3 of
             the f32 production loss.

The last three lines are a JSON object with one row per kernel, the
``nvidia-smi`` name/power-limit line, and the ``ok`` JSON object.
"""

from __future__ import annotations

import dataclasses
import json
import os
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


# --- training path -----------------------------------------------------------
LSTM_TRAIN_SHAPES = ((5, 7, 40), (128, 128, 512), (32, 512, 512))  # (B, T, H)
CTC_SHAPES = ((5, 20, 9, 6), (32, 512, 96, 255))  # (B, T, K, L)


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-12)).item()


def _abs(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def lstm_train_kernels(dev, card: str) -> dict:
    """save_cell forward, BPTT frames + dwh (both directions) against the
    plain versions; times at each flagship shape, rows at the last."""
    import torch
    from vistaocr_tpu_torch.ops import lstm_cuda as L

    rows = {}
    for (B, T, H) in LSTM_TRAIN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            (fwd, bwd), mask = _recurrence_case(B, T, H, dtype, dev,
                                                seed=B + T + 1)
            dirs = [(fwd[0], fwd[1], False), (bwd[0], bwd[1], True)]
            rng = np.random.default_rng(B * T)
            dys = [torch.from_numpy(rng.normal(0, 1, (T, B, H)).astype(
                np.float32)).to(dev, dtype) for _ in range(2)]
            with torch.no_grad():
                got = L.lstm_forward_cells(dirs, mask, dtype)
                ref = L.lstm_forward_cells(dirs, mask, dtype, plain=True)
                bdirs = [(x, w, ys, cs, dy, r) for (x, w, r), (ys, cs), dy
                         in zip(dirs, ref, dys)]
                whq = [w.to(dtype).contiguous() for _, w, _ in dirs]
                kdirs = [(x, w, ys, cs, dy, r) for (x, _, ys, cs, dy, r), w
                         in zip(bdirs, whq)]
                dxw_k = L.lstm_bptt_frames(kdirs, mask, dtype)
                ref_b = L.lstm_bptt(bdirs, mask, dtype, plain=True)
                # dwh from the plain dxw, so its check sees the reduction only
                dwh_k = L.lstm_dwh([(d[2], g, d[5]) for d, (g, _)
                                    in zip(bdirs, ref_b)], dtype)
                torch.cuda.synchronize()
            f32 = dtype == torch.float32
            e_fwd = max(max(_abs(y, ry), _abs(c, rc))
                        for (y, c), (ry, rc) in zip(got, ref))
            e_dxw = max(_abs(g, r) for g, (r, _) in zip(dxw_k, ref_b))
            r_dxw = max(_rel(g, r) for g, (r, _) in zip(dxw_k, ref_b))
            r_dwh = max(_rel(g, r) for g, (_, r) in zip(dwh_k, ref_b))
            e_dwh = max(_abs(g, r) for g, (_, r) in zip(dwh_k, ref_b))
            tag = f"B={B} T={T} H={H} {str(dtype).replace('torch.', '')}"
            ok = (e_fwd <= (1e-4 if f32 else 3e-2)
                  and r_dxw <= (1e-4 if f32 else 2e-2)
                  and r_dwh <= (1e-4 if f32 else 2e-2))
            print(f"train kernels vs plain {tag}: save_cell max|d|={e_fwd:.3e}"
                  f"; dxw max|d|={e_dxw:.3e} (rel {r_dxw:.2e}); dwh "
                  f"max|d|={e_dwh:.3e} (rel {r_dwh:.2e}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            _require(ok, f"LSTM training kernels agree with plain: {tag}")
            if (B, T, H) == LSTM_TRAIN_SHAPES[0]:
                continue
            with torch.no_grad():
                t = {
                    "fwd": _cuda_ms(lambda: L.lstm_forward_cells(
                        dirs, mask, dtype), 5),
                    "fwd_plain": _cuda_ms(lambda: L.lstm_forward_cells(
                        dirs, mask, dtype, plain=True), 1),
                    "bwd": _cuda_ms(lambda: L.lstm_bptt(bdirs, mask, dtype), 5),
                    "bwd_plain": _cuda_ms(lambda: L.lstm_bptt(
                        bdirs, mask, dtype, plain=True), 1),
                    "dwh": _cuda_ms(lambda: L.lstm_dwh(
                        [(d[2], g, d[5]) for d, (g, _) in zip(bdirs, ref_b)],
                        dtype), 5),
                    "dwh_plain": _cuda_ms(lambda: [L.lstm_dwh_ref(
                        d[2], g, reverse=d[5], dtype=dtype)
                        for d, (g, _) in zip(bdirs, ref_b)], 1),
                }
            print(f"time {tag}, both directions: save_cell fwd {t['fwd']:.3f}"
                  f" ms (plain {t['fwd_plain']:.3f}); BPTT frames+dwh "
                  f"{t['bwd']:.3f} ms (plain {t['bwd_plain']:.3f}); dwh "
                  f"{t['dwh']:.3f} ms (plain {t['dwh_plain']:.3f}) ({card})",
                  flush=True)
            rows[(B, T, dtype)] = {
                "lstm_fwd_save_cell": (e_fwd, t["fwd"], t["fwd_plain"]),
                "lstm_bwd": (e_dxw, t["bwd"], t["bwd_plain"]),
                "lstm_dwh": (e_dwh, t["dwh"], t["dwh_plain"]),
            }
    return rows


def ctc_train_kernels(dev, card: str) -> dict:
    """CTC alpha/beta kernels against the plain versions (f32)."""
    import torch
    from vistaocr_tpu_torch.ops import ctc_cuda as C

    rows = {}
    for (B, T, K, L) in CTC_SHAPES:
        rng = np.random.default_rng(T + L)
        lp = torch.log_softmax(torch.from_numpy(
            rng.normal(0, 2, (B, T, K)).astype(np.float32)), -1).to(dev)
        labels = rng.integers(1, K, (B, L)).astype(np.int32)
        labels[0, 1] = labels[0, 0]
        ll = rng.integers(L // 2, L + 1, B).astype(np.int32)
        ll[0] = L
        il = np.array([int(rng.integers(min(2 * n + 1, T), T + 1))
                       for n in ll], np.int32)
        il[0] = T
        if B > 2:
            ll[1] = 0  # an empty label
            ll[2], il[2] = L, max(1, L // 2)  # an infeasible sample
        il_t, ll_t = torch.from_numpy(il).to(dev), torch.from_numpy(ll).to(dev)
        lp_ext, skip, active, islast = C._prepare(
            lp, il_t, torch.from_numpy(labels).to(dev), 0)
        svalid, terminal = C._state_masks(ll_t, lp_ext.shape[2])
        skip2 = torch.cat([skip[:, 2:], torch.zeros_like(skip[:, :2])],
                          1).contiguous()
        alphas = C.ctc_alpha(lp_ext, active, skip, svalid)
        ref_a = C.ctc_alpha_ref(lp_ext, active, skip, svalid)
        logp = C._loss_from_alphas(ref_a, il_t, ll_t).contiguous()
        dlp = C.ctc_beta(lp_ext, active, islast, skip2, svalid, terminal,
                         ref_a, logp)
        ref_d = C.ctc_beta_ref(lp_ext, active, islast, skip2, svalid,
                               terminal, ref_a, logp)
        torch.cuda.synchronize()
        reach = (ref_a > -1e29) & (svalid[None] > 0)
        same_reach = bool(torch.equal(alphas > -1e29, ref_a > -1e29))
        e_a = _abs(alphas[reach], ref_a[reach])
        e_b = _abs(dlp, ref_d)
        tag = f"B={B} T={T} K={K} L={L}"
        ok = same_reach and e_a <= 2e-4 and e_b <= 2e-5
        print(f"CTC kernels vs plain {tag}: alpha max|d|={e_a:.3e} on "
              f"{int(reach.sum())} reachable states, beta d lp_ext "
              f"max|d|={e_b:.3e} {'ok' if ok else 'FAIL'}", flush=True)
        _require(ok, f"CTC kernels agree with plain: {tag}")
        if (B, T, K, L) != CTC_SHAPES[-1]:
            continue
        t = {
            "a": _cuda_ms(lambda: C.ctc_alpha(lp_ext, active, skip, svalid),
                          10),
            "a_plain": _cuda_ms(lambda: C.ctc_alpha_ref(lp_ext, active, skip,
                                                        svalid), 2),
            "b": _cuda_ms(lambda: C.ctc_beta(lp_ext, active, islast, skip2,
                                             svalid, terminal, ref_a, logp),
                          10),
            "b_plain": _cuda_ms(lambda: C.ctc_beta_ref(
                lp_ext, active, islast, skip2, svalid, terminal, ref_a,
                logp), 2),
        }
        print(f"time {tag}: alpha {t['a']:.3f} ms (plain {t['a_plain']:.3f}),"
              f" beta {t['b']:.3f} ms (plain {t['b_plain']:.3f}) ({card})",
              flush=True)
        rows["ctc_alpha"] = (e_a, t["a"], t["a_plain"])
        rows["ctc_beta"] = (e_b, t["b"], t["b_plain"])
    return rows


GLYPH_CHARSET = ("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                 "0123456789 .,")


def glyph_font(seed: int, height: int = 32) -> dict:
    """A fixed random ink bitmap, 8-16 px wide, per character."""
    rng = np.random.default_rng(seed)
    font = {}
    for ch in GLYPH_CHARSET:
        w = int(rng.integers(8, 17))
        g = np.full((height, w), 255, np.uint8)
        if ch != " ":
            ink = rng.random((height - 12, w - 2)) < 0.4
            g[6:height - 6, 1:w - 1][ink] = int(rng.integers(0, 80))
        font[ch] = g
    return font


def glyph_lines(font: dict, rng, n: int, wmin: int, wmax: int):
    """n (image, text) lines: characters drawn at random until the next
    one would pass a target width drawn from [wmin, wmax]."""
    chars = list(font)
    out = []
    for _ in range(n):
        target = int(rng.integers(wmin, wmax + 1))
        text, width = [], 0
        while True:
            ch = chars[int(rng.integers(len(chars)))]
            if text and width + font[ch].shape[1] > target:
                break
            text.append(ch)
            width += font[ch].shape[1]
        out.append((np.concatenate([font[c] for c in text], axis=1),
                    "".join(text)))
    return out


def write_glyph_dataset(path: str, font: dict, seed: int, n_train: int,
                        n_val: int) -> None:
    from vistaocr_tpu_torch.data import ShardWriter, write_manifest
    from vistaocr_tpu_torch.text import utf8_to_uxxxx

    rng = np.random.default_rng(seed)
    splits = {}
    for split, n in (("train", n_train), ("val", n_val)):
        w = ShardWriter(path, split, 32)
        for i, (img, text) in enumerate(glyph_lines(font, rng, n, 40, 2048)):
            w.add(f"{split}-{i:06d}", img, utf8_to_uxxxx(text))
        splits[split] = w.close()
    write_manifest(path, 32, splits)


TRAIN_COUNTERS = (("lstm_cuda", "SAVE_CELL_LAUNCHES"),
                  ("lstm_cuda", "BWD_LAUNCHES"),
                  ("lstm_cuda", "DWH_LAUNCHES"),
                  ("ctc_cuda", "ALPHA_LAUNCHES"),
                  ("ctc_cuda", "BETA_LAUNCHES"))


def train_phase(tmp: str, font: dict, smi: str) -> dict:
    from vistaocr_tpu_torch import train as T
    from vistaocr_tpu_torch.ops import ctc_cuda, lstm_cuda

    mods = {"lstm_cuda": lstm_cuda, "ctc_cuda": ctc_cuda}
    data, run = os.path.join(tmp, "glyphs"), os.path.join(tmp, "run")
    t0 = time.time()
    write_glyph_dataset(data, font, seed=21, n_train=3000, n_val=128)
    print(f"glyph data set written in {time.time() - t0:.2f} s", flush=True)
    cfg = T.TrainConfig(**{**T.PRESETS["full"], "data_dir": data,
                           "snapshot_dir": run, "max_steps": 40,
                           "val_interval_steps": 40, "log_interval": 1,
                           "seed": 0})
    for mod, name in TRAIN_COUNTERS:
        setattr(mods[mod], name, 0)
    t0 = time.time()
    summary = T.fit(cfg, device="cuda", log=lambda m: None if m.startswith(
        "step ") else print(m, flush=True))
    wall = time.time() - t0
    counts = {name: getattr(mods[mod], name) for mod, name in TRAIN_COUNTERS}
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    steps = [r for r in recs if "loss" in r]
    losses = [r["loss"] for r in steps]
    _require(len(losses) == 40, f"40 logged steps, got {len(losses)}")
    _require(all(np.isfinite(losses)) and max(losses) < 1e20,
             f"finite losses: {losses}")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    steady = steps[10:]
    lps = sum(r["lines"] for r in steady) / sum(r["seconds"] for r in steady)
    print(f"train: 40 steps in {wall:.1f} s (setup and validation included);"
          f" loss first-10 mean {first:.2f}, last-10 mean {last:.2f}; curve "
          f"{[round(x, 1) for x in losses]}; steps 11-40: "
          f"{sum(r['lines'] for r in steady)} lines at {lps:.1f} train "
          f"lines/s ({smi}); val CER {summary['last_val_cer']:.4f}; "
          f"launches {counts}", flush=True)
    _require(last < first, f"loss falls: last-10 {last} < first-10 {first}")
    _require(all(v > 0 for v in counts.values()),
             f"every training kernel launched: {counts}")
    _require(os.path.exists(os.path.join(run, "last", "meta.json")),
             "snapshot written")
    return counts


def train_parity_phase(dev, font: dict) -> None:
    import torch
    from vistaocr_tpu_torch import train as T
    from vistaocr_tpu_torch.models import CnnLstmOcr, ModelConfig, init_parameters
    from vistaocr_tpu_torch.text import Alphabet, utf8_to_uxxxx

    alphabet = Alphabet.from_charset(GLYPH_CHARSET)
    cfg = ModelConfig(num_classes=alphabet.num_classes,
                      compute_dtype="float32", dropout=0.0)
    lines = glyph_lines(font, np.random.default_rng(9), 16, 200, 1024)
    B, W = len(lines), 1024
    images = np.full((B, 32, W), 255, np.uint8)
    labels = np.zeros((B, 127), np.int32)
    widths, lls = np.zeros(B, np.int32), np.zeros(B, np.int32)
    for i, (img, text) in enumerate(lines):
        images[i, :, :img.shape[1]] = img
        widths[i] = img.shape[1]
        ids = alphabet.encode(utf8_to_uxxxx(text))
        labels[i, :len(ids)] = ids
        lls[i] = len(ids)
    batch = [torch.from_numpy(a).to(dev) for a in (images, widths, labels, lls)]
    weights = torch.ones(B, device=dev)
    base = CnnLstmOcr(cfg)
    init_parameters(base, torch.Generator().manual_seed(5))
    out = {}
    for impl in ("scan", "auto"):
        model = CnnLstmOcr(dataclasses.replace(cfg, lstm_impl=impl))
        model.load_state_dict(base.state_dict())
        model.to(dev)
        loss, grads = T.loss_and_grads(model, *batch, weights, ctc_impl=impl)
        torch.cuda.synchronize()
        out[impl] = (loss.item(), grads)
    (l_p, g_p), (l_k, g_k) = out["scan"], out["auto"]
    worst = max(((_rel(g_k[n], g_p[n]), n) for n in g_p))
    rel_loss = abs(l_k - l_p) / abs(l_p)
    print(f"f32 train-step parity scan vs kernels: loss {l_p:.6f} vs "
          f"{l_k:.6f} (rel {rel_loss:.2e}, tol 1e-5); gradients: worst "
          f"max|d|/max|g| {worst[0]:.2e} at {worst[1]} (tol 2e-3) over "
          f"{len(g_p)} tensors", flush=True)
    _require(np.isfinite(l_k) and rel_loss <= 1e-5, "loss parity")
    _require(worst[0] <= 2e-3, f"gradient parity {worst}")


# --- experiments: fused stem (K7a/K7b), direction-stacked BLSTM (K6a/K6b) ----
STEM_SHAPES = ((3, 32, 45, 64), (128, 32, 512, 64), (32, 32, 2048, 64))
BI_SHAPES = ((5, 7, 40), (128, 128, 512), (32, 512, 512))  # (B, T, H)
# bf16 bounds of kernel against plain (f32: 1e-4). Both sides read the same
# bf16 operands, so the bounds sit close to the card's readings (PERF.md):
# a stored bf16 value may flip by one ulp in rare elements (share 2e-4);
# dK sums
# identical products (reading 3.4e-7 relative); dxw and dwh follow rare
# flips of the rounded h and dgates (5e-4); ys/cs stay f32 (8.7e-4).
BF16_FLIP_SHARE = 2e-3
BF16_F32_SLACK = 2e-6  # f32 out/xn of kernel and plain differ by <= 6.0e-7
BF16_DK_REL = 1e-4
BF16_BPTT_REL = 5e-3
BF16_YS_ABS = 2.0 ** -8  # one bf16 ulp of a value in [0.5, 1)


def _dtname(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _bf16_flips(a, b, slack: float = BF16_F32_SLACK) -> tuple:
    """(largest (|a - b| - slack) in bf16 ulps of the larger magnitude,
    share of the elements that differ at all). Roundings to bf16 of two
    f32 values at most ``slack`` apart differ by at most ``slack`` plus
    one ulp (near a cancelling sum's zero that is many ulps), and rarely."""
    import torch

    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    d = (a - b).abs()
    return (((d - slack).clamp(min=0) / ulp).max().item(),
            (d > 0).float().mean().item())


def stem_experiment_kernels(dev, card: str) -> dict:
    """K7a/K7b against their plain versions; at the flagship shapes also
    timed and compared with the production stem."""
    import torch
    import torch.nn.functional as F
    from vistaocr_tpu_torch.experiments import stem_cuda as S
    from vistaocr_tpu_torch.ops.preprocess import preprocess_images

    rows = {}
    for (B, H, W, CO) in STEM_SHAPES:
        rng = np.random.default_rng(B + W)
        widths = rng.integers(W // 3, W + 1, B).astype(np.int32)
        widths[0], widths[-1] = W, W - 7
        images = torch.from_numpy(rng.integers(0, 256, (B, H, W), np.uint8)
                                  ).to(dev)
        widths = torch.from_numpy(widths).to(dev)
        kernel = torch.from_numpy(rng.normal(0, 0.1, (CO, 1, 3, 3)).astype(
            np.float32)).to(dev)
        dout32 = torch.from_numpy(rng.normal(0, 1, (B, CO, H, W)).astype(
            np.float32)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            dout = dout32.to(dtype)
            out, xn = S.stem_fwd_cuda(images, widths, kernel, True, dtype)
            ref_out, ref_xn = S.fused_stem_ref(images, widths, kernel, True,
                                               dtype)
            dk = S.stem_dk_cuda(xn, dout)
            ref_dk = S.stem_dk_ref(xn, dout)
            x = preprocess_images(images, widths, dtype=dtype).permute(
                0, 3, 1, 2).contiguous()
            prod = F.conv2d(x, kernel.to(dtype), padding=1)
            prod_dk = torch.nn.grad.conv2d_weight(x, kernel.shape, dout,
                                                  padding=1)
            torch.cuda.synchronize()
            e_fwd = max(_abs(out, ref_out), _abs(xn, ref_xn))
            e_dk, r_dk = _abs(dk, ref_dk), _rel(dk, ref_dk)
            e_prod, r_prod_dk = _abs(out, prod), _rel(dk, prod_dk)
            flips = [_bf16_flips(out, ref_out), _bf16_flips(xn, ref_xn)]
            ulps = max(f[0] for f in flips)
            share = max(f[1] for f in flips)
            if dtype == torch.float32:  # also the same function as production
                ok = (e_fwd <= 1e-4 and r_dk <= 1e-4 and e_prod <= 1e-4
                      and r_prod_dk <= 1e-4)
            else:
                ok = (ulps <= 1 and share <= BF16_FLIP_SHARE
                      and r_dk <= BF16_DK_REL)
            tag = f"B={B} H={H} W={W} CO={CO} {_dtname(dtype)}"
            print(f"stem kernels vs plain {tag}: out/xn max|d|={e_fwd:.3e} "
                  f"({ulps:.2f} bf16 ulp, {share:.2e} of elements differ); "
                  f"dK max|d|={e_dk:.3e} (rel {r_dk:.2e}); vs production "
                  f"out max|d|={e_prod:.3e}, dK rel {r_prod_dk:.2e} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            _require(ok, f"stem kernels agree with plain: {tag}")
            if (B, H, W, CO) == STEM_SHAPES[0]:
                continue

            def production():
                xp = preprocess_images(images, widths, dtype=dtype)
                return F.conv2d(xp.permute(0, 3, 1, 2), kernel.to(dtype),
                                padding=1)

            t = {
                "fwd": _cuda_ms(lambda: S.stem_fwd_cuda(
                    images, widths, kernel, True, dtype), 20),
                "fwd_plain": _cuda_ms(lambda: S.fused_stem_ref(
                    images, widths, kernel, True, dtype), 5),
                "fwd_prod": _cuda_ms(production, 20),
                "dk": _cuda_ms(lambda: S.stem_dk_cuda(xn, dout), 20),
                "dk_plain": _cuda_ms(lambda: S.stem_dk_ref(xn, dout), 5),
                "dk_prod": _cuda_ms(lambda: torch.nn.grad.conv2d_weight(
                    x, kernel.shape, dout, padding=1), 20),
            }
            print(f"time {tag}: stem fwd {t['fwd']:.4f} ms (plain "
                  f"{t['fwd_plain']:.4f}, production {t['fwd_prod']:.4f}); "
                  f"dK {t['dk']:.4f} ms (plain {t['dk_plain']:.4f}, "
                  f"production {t['dk_prod']:.4f}) ({card})", flush=True)
            rows[(B, W, _dtname(dtype))] = {
                "stem_fwd": (e_fwd, t["fwd"], t["fwd_plain"], t["fwd_prod"]),
                "stem_dk": (e_dk, t["dk"], t["dk_plain"], t["dk_prod"]),
            }
    return rows


def bi_experiment_kernels(dev, card: str) -> dict:
    """K6a/K6b against their plain versions; at the flagship shapes also
    timed and compared with the production K1 save_cell + K2/K3 BPTT of
    one layer on the same inputs."""
    import torch
    from vistaocr_tpu_torch.experiments import lstm_bi_stacked as S
    from vistaocr_tpu_torch.ops import lstm_cuda as L

    rows = {}
    for (B, T, H) in BI_SHAPES:
        rng = np.random.default_rng(B * T + H)
        lengths = rng.integers(1, T + 1, B)
        lengths[0] = T
        m = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
        mask = torch.from_numpy(np.ascontiguousarray(
            np.stack([m, m[::-1]], axis=1))).to(dev)  # [T, 2, B]
        xw = torch.from_numpy(rng.normal(0, 1, (T, 2, B, 4 * H)).astype(
            np.float32)).to(dev)
        wh = torch.from_numpy(rng.normal(0, 1 / np.sqrt(H), (2, H, 4 * H))
                              .astype(np.float32)).to(dev)
        dys = torch.from_numpy(rng.normal(0, 1, (T, 2, B, H)).astype(
            np.float32)).to(dev)
        # the production layer's operands: natural time order per direction
        pmask = torch.from_numpy(m[:, None, :].copy()).to(dev)  # [T, 1, B]
        for dtype in (torch.float32, torch.bfloat16):
            whq = wh.to(dtype).contiguous()
            with torch.no_grad():
                ys, cs = S.bi_lstm_fwd_cuda(xw, mask, whq, dtype)
                rys, rcs = S.bi_recurrence_ref(xw, mask, wh, dtype,
                                               save_cell=True)
                dxw, dwh = S.bi_lstm_bwd_cuda(xw, mask, whq, rys, rcs, dys,
                                              dtype)
                rdxw, rdwh = S.bi_bptt_ref(xw, mask, wh, rys, rcs, dys, dtype)
                dirs = [(xw[:, 0].to(dtype).contiguous(), wh[0], False),
                        (torch.flip(xw[:, 1], [0]).to(dtype).contiguous(),
                         wh[1], True)]
                (pys_f, pcs_f), (pys_b, pcs_b) = L.lstm_forward_cells(
                    dirs, pmask, dtype)
                pdys = [dys[:, 0].to(dtype).contiguous(),
                        torch.flip(dys[:, 1], [0]).to(dtype).contiguous()]
                bdirs = [(dirs[0][0], wh[0], pys_f, pcs_f, pdys[0], False),
                         (dirs[1][0], wh[1], pys_b, pcs_b, pdys[1], True)]
                (pdxw_f, pdwh_f), (pdxw_b, pdwh_b) = L.lstm_bptt(bdirs, pmask,
                                                                 dtype)
                torch.cuda.synchronize()
            e_fwd = max(_abs(ys, rys), _abs(cs, rcs))
            e_dxw, r_dxw = _abs(dxw, rdxw), _rel(dxw, rdxw)
            r_dwh = _rel(dwh, rdwh)
            e_prod = max(_abs(pys_f, ys[:, 0]),
                         _abs(torch.flip(pys_b, [0]), ys[:, 1]))
            r_prod = max(_rel(pdxw_f, dxw[:, 0]),
                         _rel(torch.flip(pdxw_b, [0]), dxw[:, 1]),
                         _rel(torch.stack([pdwh_f, pdwh_b]), dwh))
            if dtype == torch.float32:  # also the same function as production
                ok = (e_fwd <= 1e-4 and r_dxw <= 1e-4 and r_dwh <= 1e-4
                      and e_prod <= 1e-4 and r_prod <= 1e-3)
            else:
                ok = (e_fwd <= BF16_YS_ABS and r_dxw <= BF16_BPTT_REL
                      and r_dwh <= BF16_BPTT_REL)
            tag = f"B={B} T={T} H={H} {_dtname(dtype)}"
            print(f"stacked BLSTM kernels vs plain {tag}: ys/cs max|d|="
                  f"{e_fwd:.3e}; dxw max|d|={e_dxw:.3e} (rel {r_dxw:.2e}); "
                  f"dwh rel {r_dwh:.2e}; vs production ys max|d|="
                  f"{e_prod:.3e}, dxw/dwh rel {r_prod:.2e} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            _require(ok, f"stacked BLSTM kernels agree with plain: {tag}")
            if (B, T, H) == BI_SHAPES[0]:
                continue
            with torch.no_grad():
                t = {
                    "fwd": _cuda_ms(lambda: S.bi_lstm_fwd_cuda(
                        xw, mask, whq, dtype), 5),
                    "fwd_plain": _cuda_ms(lambda: S.bi_recurrence_ref(
                        xw, mask, wh, dtype, save_cell=True), 1),
                    "fwd_prod": _cuda_ms(lambda: L.lstm_forward_cells(
                        dirs, pmask, dtype), 5),
                    "bwd": _cuda_ms(lambda: S.bi_lstm_bwd_cuda(
                        xw, mask, whq, rys, rcs, dys, dtype), 5),
                    "bwd_plain": _cuda_ms(lambda: S.bi_bptt_ref(
                        xw, mask, wh, rys, rcs, dys, dtype), 1),
                    "bwd_prod": _cuda_ms(lambda: L.lstm_bptt(
                        bdirs, pmask, dtype), 5),
                }
            print(f"time {tag}, both directions: stacked fwd {t['fwd']:.3f}"
                  f" ms (plain {t['fwd_plain']:.3f}, production K1 "
                  f"{t['fwd_prod']:.3f}); stacked BPTT frames+dwh "
                  f"{t['bwd']:.3f} ms (plain {t['bwd_plain']:.3f}, "
                  f"production K2/K3 {t['bwd_prod']:.3f}) ({card})",
                  flush=True)
            rows[(B, T, _dtname(dtype))] = {
                "bi_lstm_fwd": (e_fwd, t["fwd"], t["fwd_plain"],
                                t["fwd_prod"]),
                "bi_lstm_bwd": (e_dxw, t["bwd"], t["bwd_plain"],
                                t["bwd_prod"]),
            }
    return rows


EXPERIMENT_COUNTERS = (("stem_cuda", "STEM_LAUNCHES"),
                       ("stem_cuda", "STEM_DK_LAUNCHES"),
                       ("lstm_bi_stacked", "BI_FWD_LAUNCHES"),
                       ("lstm_bi_stacked", "BI_BWD_LAUNCHES"))


EXPERIMENT_BATCH = (32, 2048)  # (B, W): one 2**21-pixel train batch


def experiments_path_phase(dev, font: dict, smi: str) -> dict:
    """The flagship train-mode forward/backward with both experiments in
    place against ``model.forward`` on one glyph batch; returns the four
    launch counts of that run."""
    import torch
    from vistaocr_tpu_torch.checkpoint import load_model
    from vistaocr_tpu_torch.experiments import lstm_bi_stacked, stem_cuda
    from vistaocr_tpu_torch.experiments.flagship import forward_with_experiments
    from vistaocr_tpu_torch.ops.ctc import mean_ctc_loss
    from vistaocr_tpu_torch.text import utf8_to_uxxxx

    with tempfile.TemporaryDirectory() as tmp:
        flagship_snapshot(tmp)
        model, alphabet, _ = load_model(tmp, dev, compute_dtype="float32",
                                        dropout=0.0, augment=0.0)
        model16, _, _ = load_model(tmp, dev, compute_dtype="bfloat16",
                                   dropout=0.0, augment=0.0)
    B, W = EXPERIMENT_BATCH
    lines = glyph_lines(font, np.random.default_rng(23), B, 200, W)
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

    def run(forward, net=model):
        lp, fm = forward(net)
        loss = mean_ctc_loss(lp, fm.sum(dim=1).to(torch.int32), labels_t,
                             lls_t, sample_weights=weights)
        named = dict(net.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()))
        return lp.detach(), fm, loss.detach(), dict(zip(named, grads))

    def production(net):
        return net(images_t, widths_t, train=True)

    def experiments(net):
        return forward_with_experiments(net, images_t, widths_t, train=True)

    lp_p, fm_p, loss_p, g_p = run(production)
    mods = {"stem_cuda": stem_cuda, "lstm_bi_stacked": lstm_bi_stacked}
    for mod, name in EXPERIMENT_COUNTERS:
        setattr(mods[mod], name, 0)
    lp_e, fm_e, loss_e, g_e = run(experiments)
    torch.cuda.synchronize()
    counts = {name: getattr(mods[mod], name)
              for mod, name in EXPERIMENT_COUNTERS}

    _require(lp_e.shape == (B, W // 4, alphabet.num_classes),
             f"log-prob shape {tuple(lp_e.shape)}")
    _require(torch.equal(fm_e, fm_p), "frame masks equal")
    _require(bool(torch.isfinite(lp_e[fm_e]).all()), "finite log-probs")
    err = _abs(lp_e[fm_e], lp_p[fm_p])
    # the 2e-3 bound holds for the tensors the experiments compute the
    # gradients of: the stem kernel (K7b) and the LSTM weights (K6b). The
    # ConvStack's own gradients pass the max-pools, where a 1e-7 change
    # of the stem's output can move a near-tie's gradient to its
    # neighbour; they are printed, not held to it.
    checked = [n for n in g_p if n == "stem_kernel" or n.startswith("blstm.")]
    worst = max((_rel(g_e[n], g_p[n]), n) for n in checked)
    worst_all = max((_rel(g_e[n], g_p[n]), n) for n in g_p)
    rel_loss = abs(loss_e.item() - loss_p.item()) / abs(loss_p.item())

    def path_ms(forward, net=model):
        times = []
        for _ in range(4):  # the first is a warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(forward, net)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times[1:]))

    t_prod, t_exp = path_ms(production), path_ms(experiments)
    print(f"f32 flagship train-mode path, experiments vs model.forward "
          f"(B={B}, W={W}, {int(fm_p.sum())} valid frames): max|d log p|="
          f"{err:.3e} (tol 1e-3); loss {loss_p.item():.6f} vs "
          f"{loss_e.item():.6f} (rel {rel_loss:.2e}); gradients: worst "
          f"max|d|/max|g| {worst[0]:.2e} at {worst[1]} (tol 2e-3) over "
          f"the stem kernel and {len(checked) - 1} LSTM tensors; over all "
          f"{len(g_p)} tensors {worst_all[0]:.2e} at {worst_all[1]}; "
          f"forward+backward {t_exp:.1f} ms vs "
          f"production {t_prod:.1f} ms ({smi}); launches {counts}",
          flush=True)
    _require(err <= 1e-3, f"log-prob parity {err:.3e} <= 1e-3")
    _require(worst[0] <= 2e-3, f"gradient parity {worst}")
    _require(all(v > 0 for v in counts.values()),
             f"every experiment kernel launched: {counts}")

    # bf16, the dtype training runs in: the fused stem's contract differs
    # from production's there (its conv reads the unrounded image and the
    # f32 kernel), so each path's loss is held to the f32 production loss
    # (readings 5.2e-5 and 7.3e-5 relative) and the two paths are timed.
    lp16_p, _, loss16_p, _ = run(production, model16)
    lp16_e, _, loss16_e, _ = run(experiments, model16)
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(t).all()) for t in (
        lp16_p[fm_p], lp16_e[fm_p], loss16_p, loss16_e))
    rel16 = [abs(v.item() - loss_p.item()) / abs(loss_p.item())
             for v in (loss16_p, loss16_e)]
    t16_prod = path_ms(production, model16)
    t16_exp = path_ms(experiments, model16)
    print(f"bf16 flagship train-mode path, experiments vs model.forward: "
          f"max|d log p|={_abs(lp16_e[fm_p], lp16_p[fm_p]):.3e}; loss "
          f"{loss16_p.item():.6f} vs {loss16_e.item():.6f} (against the f32 "
          f"loss: rel {rel16[0]:.2e} / {rel16[1]:.2e}, tol 1e-3); "
          f"forward+backward "
          f"{t16_exp:.1f} ms vs production {t16_prod:.1f} ms ({smi})",
          flush=True)
    _require(finite, "finite bf16 log-probs and losses")
    _require(max(rel16) <= 1e-3, f"bf16 losses near the f32 loss: {rel16}")
    return counts


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

    _phase("train-kernels")
    lstm_rows = lstm_train_kernels(dev, f"{card}, {smi}")
    ctc_rows = ctc_train_kernels(dev, f"{card}, {smi}")
    font = glyph_font(17)
    with tempfile.TemporaryDirectory() as tmp:
        _phase("train")
        counts = train_phase(tmp, font, smi)
    _phase("train-parity")
    train_parity_phase(dev, font)
    _phase("experiments")
    stem_rows = stem_experiment_kernels(dev, f"{card}, {smi}")
    bi_rows = bi_experiment_kernels(dev, f"{card}, {smi}")
    exp_counts = experiments_path_phase(dev, font, smi)

    bf16, f32 = rows[torch.bfloat16], rows[torch.float32]
    kernels = [{
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
    }]
    main_shape = LSTM_TRAIN_SHAPES[-1][:2]  # B=32, T=512: the W=2048 bucket
    lstm_meta = {
        "lstm_fwd_save_cell": ("lstm_fwd.cu", "lstm_pallas.py:51",
                               "SAVE_CELL_LAUNCHES"),
        "lstm_bwd": ("lstm_bwd.cu", "lstm_pallas.py:281", "BWD_LAUNCHES"),
        "lstm_dwh": ("lstm_bwd.cu", "lstm_pallas.py:264", "DWH_LAUNCHES"),
    }
    for name, (src, rep, counter) in lstm_meta.items():
        e, ms, plain = lstm_rows[(*main_shape, torch.bfloat16)][name]
        e32, ms32, plain32 = lstm_rows[(*main_shape, torch.float32)][name]
        row = {"name": name, "route": "cuda",
               "source": f"vistaocr_tpu_torch/csrc/{src}",
               "replaces": f"vistaocr_tpu/ops/{rep}",
               "launches": counts[counter], "max_abs_err": e, "ms": ms,
               "plain_ms": plain, "f32_max_abs_err": e32, "f32_ms": ms32,
               "f32_plain_ms": plain32}
        if name == "lstm_bwd":
            row["also_replaces"] = "vistaocr_tpu/ops/lstm_pallas.py:334"
        kernels.append(row)
    for name, rep, counter in (("ctc_alpha", "ctc_pallas.py:74",
                                "ALPHA_LAUNCHES"),
                               ("ctc_beta", "ctc_pallas.py:157",
                                "BETA_LAUNCHES")):
        e, ms, plain = ctc_rows[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": "vistaocr_tpu_torch/csrc/ctc.cu",
                        "replaces": f"vistaocr_tpu/ops/{rep}",
                        "launches": counts[counter], "max_abs_err": e,
                        "ms": ms, "plain_ms": plain})
    # the experiments: rows at the W=2048 bucket's shapes, bf16 (f32 beside)
    exp_meta = {
        "bi_lstm_fwd": ("lstm_bi_stacked.cu", "lstm_bi_stacked.py:31",
                        "BI_FWD_LAUNCHES", bi_rows, (32, 512)),
        "bi_lstm_bwd": ("lstm_bi_stacked.cu", "lstm_bi_stacked.py:104",
                        "BI_BWD_LAUNCHES", bi_rows, (32, 512)),
        "stem_fwd": ("stem.cu", "stem_pallas.py:46", "STEM_LAUNCHES",
                     stem_rows, (32, 2048)),
        "stem_dk": ("stem.cu", "stem_pallas.py:108", "STEM_DK_LAUNCHES",
                    stem_rows, (32, 2048)),
    }
    for name, (src, rep, counter, table, shape) in exp_meta.items():
        e, ms, plain, prod = table[(*shape, "bfloat16")][name]
        e32, ms32, plain32, prod32 = table[(*shape, "float32")][name]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"vistaocr_tpu_torch/csrc/{src}",
                        "replaces": f"experiments/{rep}",
                        "launches": exp_counts[counter], "max_abs_err": e,
                        "ms": ms, "plain_ms": plain, "production_ms": prod,
                        "f32_max_abs_err": e32, "f32_ms": ms32,
                        "f32_plain_ms": plain32, "f32_production_ms": prod32})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
