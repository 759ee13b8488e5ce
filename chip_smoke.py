#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths once on one
NVIDIA GPU.

    python3 chip_smoke.py         # every phase, as below
    python3 chip_smoke.py --ctc   # phases 1, 2 and the CTC part of 6
    python3 chip_smoke.py --int8  # phases 1, 2, 7 (its snapshot) and int8
    python3 chip_smoke.py --http  # phases 1, 2 and 4b (the HTTP server)
    python3 chip_smoke.py --dp    # phases 1, 2 and dp (data and tensor
                                  # parallelism)
    python3 chip_smoke.py --fused # phases 1, 2 and fused (the device
                                  # cache and the epoch-fused trainer),
                                  # with dp's NCCL CLI run fused

Phases (each prints one line before it starts; any failure raises, so
the exit code is non-zero and no ``ok`` line is printed):

1. device  - require CUDA; print the card's name and power limit.
2. build   - build the kernels from ``vistaocr_tpu_torch/csrc`` (nvcc).
3. kernel  - the LSTM recurrence kernel against its plain PyTorch version
             on the card: the flagship shape (B=128, T=512, H=512, both
             directions, ragged mask), the W=128 train bucket's (B=512,
             T=32) and an odd shape (B=5, T=7, H=40), f32 streams (TF32
             off) within 1e-4, bf16 streams within 3e-2; the first two
             timed with CUDA events after warm-up, with the time per
             frame, the forward kernel's launches in one call
             (``torch.profiler``: one persistent launch with bf16 weights;
             with f32 one ``lstm_fwd_grid`` launch, or T of ``lstm_step``
             where the library's shape rule runs it) and two runs
             bit-equal. With f32 weights both designs are also named,
             each held to the plain version within 1e-4, run twice
             (bit-equal) and, at the timed shapes, timed side by side.
4. service - the flagship model (bf16, seeded random weights) behind
             ``OcrService`` (max_batch=128, max_wait_ms=2.0): ~256 lines
             at height 32, 8 at heights 48/64 (device resize) through
             ``ocr_lines``, 16 through ``submit``; the kernel's launch
             counter must grow. Then the same lines through a service
             with ``device_deskew=True`` (deskew on the card in front of
             the forward, at the contract height and after the device
             resize), every line scored.
4b. http   - the port's HTTP server (``serve/http_server.py``) over the
             flagship of phase 4 (``http_phase``): the PNG/JPEG decoder
             without PIL on every file of ``tests/torch_port_images``
             (each array's sha256 against the manifest written from
             Pillow) and its ms an image; 271 lines (PNG at heights
             32/48/64, widths 40-2048, and the corpus's JPEG lines) from
             eight client threads mixing raw and JSON ``/ocr`` and
             ``/ocr_batch`` of 16: every answer 200, every text equal to
             ``ocr_lines`` on the same arrays, ``/stats`` grown by the
             count, bad body / TIFF / empty batch 400, K1 two launches a
             batch and no f32-weight forward; HTTP and ``ocr_lines``
             lines/s and the request p50/p99; a second server on the
             device beam under the same load, its texts equal to a serial
             ``ocr_lines``; ``serve.soak`` 20 s with 8 clients, no error.
5. parity  - the same snapshot in f32: ``lstm_impl="scan"`` (plain)
             against ``"auto"`` (kernel), log-probs within 1e-3 on valid
             frames, greedy ids equal where the plain run's top-2 margin
             exceeds 1e-2.
6. train-kernels - each training kernel against its plain version, TF32
             off, f32 and bf16: the ``save_cell`` forward and the BPTT
             (frames + dwh) of both directions at an odd shape (B=5, T=7,
             H=40) and the training shapes (B=32, T=512, B=128, T=128,
             B=512, T=32 and B=64, T=256, H=512), the BPTT frames and dwh
             run twice on
             the same inputs (bit-equal), the save_cell forward's time per
             frame, launches per call and two runs bit-equal as in phase
             3, with f32 weights both forward designs checked and timed
             side by side as there, and at the edges of the library's
             rule between them (B=256-448 at H=512, B=128/256 at H=256,
             B=32/128 at H=1000, T = 16384 / B); the CTC alpha/beta recursions at an odd shape (empty
             label, infeasible sample) and the three train buckets at
             K=96 (B=32, T=512, L=256; B=128, T=128, L=128; B=512, T=32,
             L=32): alpha within 2e-4 on reachable states, d lp_ext
             within 2e-5, and at the buckets two runs bit-equal, one
             launch of each kernel a call, each timed, and the whole
             ``ctc_loss_kernel`` forward+backward (with its torch
             assembly) timed beside ``F.ctc_loss``. The f32 dwh
             (``lstm_dwh_fma``) at the four train buckets' rows (H=512)
             and at B=32, T=512, H=1000: within ``lstm_dwh_ref``'s bounds,
             no farther from the exact f64 sum than one f32 ``torch.mm``
             of the same operands, two runs bit-equal, one launch a call,
             timed in turns with that ``torch.mm`` beside its bound and
             plain version, the earlier design's time (PERF.md) on the
             printed line only. F2's
             shapes: bf16 weights above H=512 (B=32, T=512, H=520 and
             1000; type codes 1 and 2), whose forward runs on
             ``lstm_fwd_tc`` (the tensor cores, wh in bf16), whose frame
             loop runs on the f32-weight kernels with wh widened and the
             products' operands rounded to bf16, and whose gate GEMM and
             dwh run on the wide wgmma kernels: each kernel held to its
             plain version (forwards 3e-2, gate GEMM 1e-5 relative, also
             of the parent FMA design, frame loop, BPTT and dwh 2e-2
             relative, dwh also to the exact f64 sum as closely as one
             ``torch.mm``), run twice bit-equal, its launches counted,
             and at H=1000 (bf16 streams) each timed beside its bound,
             plain version, library call, the f32 route and, in turns,
             the earlier design (the forward's ``lstm_fwd_grid``, the FMA
             gate GEMM, dwh's 128 x 128 tiles), with ``lstm_fwd_tc`` and
             ``lstm_step`` timed in turns at B = 32, 128, 256 and 512 (T
             = 16384 / B); at the flagship's H=512 both gate GEMM and dwh
             designs checked and timed in turns. The BPTT frames
             are the gate GEMM (every frame's gate recompute as one
             GEMM: bf16 weights ``bptt_gates_gemm_wide`` on the tensor
             cores, f32 ``bptt_gates_gemm`` on the FMA units), then the
             frame loop: ``lstm_bwd_persistent`` (bf16
             weights, one launch) or, with f32 weights, three designs
             side by side: folded, ``bptt_frame`` (one launch a frame: the
             cell backward and the dh product), ``lstm_bwd_rows`` (one
             cooperative launch a call) and split, ``bptt_cell`` and
             ``bptt_dh`` a frame (the library runs the first up to B=32,
             the second beyond where it fits, else the third), each also
             held to its own plain version (``bptt_gates_ref`` within
             1e-5 relative, ``bptt_frames_ref`` on the kernel's gates
             within 2e-2 with bf16 weights, 1e-4 with f32), with one GEMM
             and one or T (each per-frame kernel) frame-loop launches a
             call. The f32 forward's three designs (``lstm_fwd_grid``,
             ``lstm_fwd_rows``, ``lstm_step``) likewise, and timed at the
             library rule's edge shapes (``F32_RULE_SHAPES``). Times from CUDA events after warm-up, the BPTT
             kernels per launch (and launches per call) from
             ``torch.profiler`` over one ``lstm_bptt_frames`` call, beside
             each kernel's bound and the library call that computes the
             same function where there is one (``torch.mm`` for dwh, for
             the gate recompute (+ xw) and, the product alone, for one
             f32 frame's dh; ``F.ctc_loss`` forward+backward for
             alpha+beta).
7. train   - ``train.fit`` with the flagship ``TrainConfig`` (bf16,
             dropout 0.1, Adam 1e-3, clip 5, ``--preset full``: auto
             ladder over a 2**21-pixel budget) on a seeded glyph data set
             (a random bitmap per character, lines 40-2048 px, 3000 train
             and 128 val lines, written with the port's ``ShardWriter``):
             40 steps and one validation; the loss must be finite and its
             last-10 mean below its first-10 mean, and every training
             kernel's launch counter must grow.
   fused   - the device-resident dataset cache and the epoch-fused
             trainer (``fused_phase``): (a) ``train.fit`` on phase 7's
             glyph data and ``TrainConfig`` with ``device_cache="on"``,
             ``fused_epochs="on"``, 40 steps, validation at 40: exactly
             40 steps, every segment loss finite and below 1e20, a
             capture per batch shape the steps reached (from the
             segments' ``batch_shape``), 40 replays and no eager step, the
             validation's snapshot holding ``stack_rows_done`` /
             ``stack_epochs``, every training kernel's wrapper called in
             the warm-ups and captures; train lines/s after the captures
             beside phase 7's per-step figure, capture seconds and peak
             memory. (b) One bucket of the same data (the stacked plan's
             with the most rows: B=32, W=1760), the flagship from one
             seeded init with dropout 0.1: 8 bf16 graph replays against 8
             eager ``train_step`` calls on the same rows (each loss within
             2**-8 relative), then 4 in f32 (losses within 1e-5,
             parameters within atol 3e-3 / rtol 2e-2), every replay's
             dropout masks equal to the eager step's; each path timed
             (CUDA events) and profiled over 4 steps (the device-busy
             share; K1, K2/K3 and K4/K5 on the device during replays, no
             capture in the window). The JSON line ``{"fused": ...}``
             holds the readings.
   infer   - on phase 7's snapshot and glyph validation split (128
             lines): ``run_inference`` greedy with a posterior dump that
             ``decode.offline`` decodes to the same strings (a line may
             differ only where the f16 dump ties its top two classes at
             a frame); host beam (``--decoder beam --beam-impl host``)
             with a char LM and a lexicon built from the split's
             transcripts on the C++ engine, which must have built; then
             ``OcrService(decoder="beam", beam_impl="host",
             device_resize=False)`` on colour (RGB/RGBA) lines at and off
             the contract height; greedy and host-beam lines/s. Then the
             device beam (the default ``beam_impl``): plain, with the char
             LM and lexicon fused (lexicon words, confidences, the report's
             ``lm_fusion``) and with ``--nbest 4`` (lists of 1-4 whose
             first is the fused 1-best), each run twice (the first
             captures its graphs); its graph replay counter must
             grow; lines/s of each.
   service-beam - the device beam behind ``OcrService(max_batch=128)``
             on phase 7's snapshot and 128 new glyph lines: plain (its
             warm-up captures every graph of the ladder), with the char LM
             and lexicon of the ``infer`` phase fused, and with a word LM
             too: counters set to 0 before ``ocr_lines`` and read after
             (graph replays and K1 launches must grow), then the same
             posteriors (the model's on those lines, and 64 seeded lines
             of 256 frames) through the service's device tail and the
             host C++ engine: equal strings, or a difference printed with
             its reason where no beam ends at a word boundary (the
             documented fallback); two replays bit-equal, graph and eager
             equal. Lines/s of a warm call beside the host beam and greedy
             on the same lines, the device-busy share of a warm call, and
             the search alone at B=128, T=512 (W=16, k=8): ms a batch as
             a graph and eagerly, device launches a frame, its bound. One
             JSON line holds these readings.
   int8    - on phase 7's snapshot (``int8_phase``): (a) the port's
             writer calibrates 4 glyph train batches and writes
             ``qstack.msgpack``, read back; (b) each of the six fused
             convs on ``csrc/int8_conv.cu`` (each with its pool and the
             next conv's quantize) bit-equal to its plain version (and
             two runs bit-equal) at B=128, W=512, at B=32, W=2048 and at
             B=3, W=37, ``int8_conv`` at an odd shape (CI=5), each conv
             timed at the first two beside its bound (int8 operations
             at 1,979 TOP/s or bytes at 3.35 TB/s), its plain version,
             the same function from ``F.unfold`` + ``torch._int_mm``
             (checked equal) and the float path's cuDNN bf16 conv, and
             the whole stack beside the float path's cuDNN stack; (c)
             ``OcrService(max_batch=128, quantize="int8")`` on 128 glyph
             lines, float prefix 0 and 2, greedy and the device beam,
             beside the bf16 service, each on phase 7's snapshot and on
             the seeded random-init flagship (phase 4's, calibrated on
             the glyph train split): int8 launches (six a batch, fewer
             under a prefix), quantize passes (one a batch under a
             prefix) and K1 launches (``lstm_fwd_persistent``,
             one a BLSTM layer and batch) counted in the timed call, warm
             lines/s, each batch's posteriors from the service bit-equal
             to ``quantized_forward`` on the same batch and held to the
             margin gate of ``tests/test_quant.py`` against the float
             model's (no flip where the float top-2 margin exceeds 0.15,
             flips on at most 5% of valid frames), greedy strings
             against bf16's (the share equal; edits at most 10% of the
             frames, two a flipped frame); (d) ``run_inference`` int8
             and bf16: lines/s, CER, int8 and K1 launches; (e)
             ``normalize_line(do_deskew=True)`` on glyph lines rotated
             by known angles (the estimate within 0.5 degrees): host
             deskew without PIL. The phase prints its seconds.
8. train-parity - one f32 train-mode forward/backward of the flagship
             model from the same parameters with ``lstm_impl``/``ctc_impl``
             ``"auto"`` (kernels) against ``"scan"`` (plain): the loss within
             1e-5 relative and every gradient within 2e-3 of its tensor's
             largest magnitude (f32 sums in another order: tiled products in
             the recurrence and one dwh sum over (T-1)*B rows instead of one
             per frame, compounded over 256 frames; the class fold's
             ``scatter_add`` uses atomics). Then the f32 path: one f32
             forward/backward on the kernels at B=32, W=2048, one at
             B=128, W=512 and one at B=512, W=128 (seeded glyph lines of
             W/2..W px), the LSTM launch counters set to 0 just before the
             first and read after the last (a forward call is one
             ``lstm_fwd_grid`` launch at B=32 and 128, one
             ``lstm_fwd_rows`` at B=512; a BPTT call one f32 gate GEMM,
             then T ``bptt_frame`` launches at B=32, one
             ``lstm_bwd_rows`` beyond), then each timed: CUDA-event ms a step
             and its device time from ``torch.profiler``. Then F2's path:
             a bf16 flagship at ``lstm_hidden`` 520 and 1000, one train
             step and one inference forward each at B=32, W=2048 and
             B=128, W=512, the LSTM counters set to 0 before and read
             after: ``lstm_fwd_tc`` a forward call, the f32-weight frame
             loop as its shape rule says, the wide gate GEMM and dwh, no
             persistent kernel and no f32-weight forward; and one train
             step at H=1000, B=32, W=2048 timed with the library's
             designs and with the forward's earlier ``lstm_fwd_grid``, in
             turns.
9. experiments - the experiments' kernels (``vistaocr_tpu_torch/
             experiments``) against their plain versions, TF32 off, f32
             within 1e-4 (dK, dxw and dwh relative to their tensor's
             largest magnitude: sums of up to 2**21 products); bf16 stem
             out/xn at most one bf16 ulp (plus 2e-6) apart in at most
             2e-3 of the elements, dK within 1e-4 relative, ys/cs within
             2**-8, dxw and dwh within 5e-3 relative: the fused stem
             K7a/K7b at B=3, W=45 (one width < W) and the flagship train
             shapes B=32, W=2048 and B=128, W=512 (H=32, CO=64), each
             type's design (``stem_design``: dK on mma.sync in bf16, on
             FMAs in f32) printed, and reruns of out, xn and dK held
             bit-equal; the
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
dp         - data parallelism on the one card (``dp_phase``; correctness,
             not scaling): two ranks on ``cuda:0`` over gloo
             (``tests/torch_port_dp_child.py``, ``maybe_init_distributed(
             ..., backend="gloo")``: NCCL refuses two ranks on one device)
             train the flagship at full width (bf16, H=512, 2 layers,
             dropout 0, seeded weights) on seeded glyph batches of 32 lines
             in the W=512 bucket, 16 rows a rank, for 4 Adam steps, held
             against one process on the same batches (each step's loss
             within 2**-8 relative), and one f32 step held to JAX's DP
             tolerances (loss 1e-5 relative, parameters atol 3e-3 / rtol
             2e-2); the two ranks' losses, state dicts and launch counts
             bit-equal, and each rank's K1, K2/K3 and K4/K5 launched. Then
             one rank over NCCL through the trainer's CLI
             (``--num-processes 1``), 4 steps and a validation on a small
             glyph set, then the same with ``--device-cache on
             --fused-epochs on`` (the log must show the cache and the
             graphs). Then the service: ``mesh_data=-1`` (a shard a
             card) equal to ``mesh_data=0``, and two shards on ``cuda:0``
             (the device list patched) giving, line for line, the texts
             and confidences of one shard, greedy and the device beam.
             Its ``tp`` check (``tp_train_check``) runs the same job with
             the model axis: 4 gloo ranks on ``cuda:0`` at data=2,
             model=2, then 2 at data=1, model=2, each holding its column
             shard of the bridge and the BLSTM gates, held to the same
             one process within the same bounds; every rank's gathered
             state dicts, losses and launch counts bit-equal, its shards
             gathered back to the initial weights exactly, and each
             rank's K1, K2/K3 and K4/K5 launched.
10. profiles - cuDNN's ``nn.LSTM(H, H, bidirectional=True)`` at each
             shape and dtype where phases 3 and 6 timed K1 (with autograd
             recording where K1 ran its save_cell form): a scale reference
             that is NOT the same function (it fuses the input projection
             and has no mask freeze); then the service of phase 4 anew,
             one warm ``ocr_lines`` call over the same lines under
             ``torch.profiler``: device-busy share and the largest
             kernels.

The last three lines are a JSON object with one row per kernel (its
launches on the main path, error against its plain version, time, plain
time, library time or null, and bound: the bytes moved at 3.35 TB/s or
the operations at the operand type's peak, whichever is larger), the
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
SMALL_BUCKET_SHAPE = (512, 32, 512)  # the W=128 train bucket: 2**21 / (32 W)
# the f32-weight forward's designs by name (FWD_DESIGNS) and kernel; the
# library chooses by shape: lstm_fwd_grid, one launch, up to B=320 at
# H=512; lstm_fwd_rows, one launch, beyond it where it fits; lstm_step, a
# launch a frame, elsewhere
F32_FWD_KERNELS = {"grid": "lstm_fwd_grid", "rows": "lstm_fwd_rows",
                   "step": "lstm_step"}


def fwd_kernel_name(B: int, H: int, dtype) -> str:
    """The forward kernel the library runs at B, H (both directions)."""
    import torch
    from vistaocr_tpu_torch.ops import lstm_cuda

    if _dtname(dtype) == "bfloat16":
        return "lstm_fwd_persistent"
    return F32_FWD_KERNELS[lstm_cuda.forward_design(torch.float32, B, H)]


def f32_fwd_designs(dirs, mask, refs, save_cell: bool, T: int,
                    bound_ms=None) -> dict:
    """The f32-weight forward designs named (``lstm_fwd_grid`` and
    ``lstm_fwd_rows``, one launch; ``lstm_step``, one a frame) over
    ``dirs`` = (xw, wh f32, reverse) per direction: each held to the plain
    outputs ``refs`` (ys per
    direction, then cs with ``save_cell``) within 1e-4 and run twice
    (bit-equal); with ``bound_ms`` also timed (CUDA events) and its
    launches a call counted (torch.profiler)."""
    import torch
    from vistaocr_tpu_torch.ops import lstm_cuda

    out = {}
    for design, name in F32_FWD_KERNELS.items():
        one = design != "step"  # one launch a call, else one a frame

        def call(design=design):
            ys, cs = lstm_cuda.lstm_fwd(
                dirs, mask, torch.float32, save_cell=save_cell,
                design=design)
            return ys + (cs or [])

        a, b = call(), call()
        torch.cuda.synchronize()
        err = max(_abs(x, r) for x, r in zip(a, refs))
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        _require(np.isfinite(err) and err <= 1e-4 and same,
                 f"{name} agrees with plain (max|d| {err:.3e} <= 1e-4) and "
                 f"is bit-equal twice ({same})")
        row = {"kernel_name": name, "max_abs_err": err,
               "bit_equal_twice": same}
        if bound_ms is not None:
            ms = _cuda_ms(call, 5)
            us, n = _kernel_us(call, (name + "<",),
                               {name + "<": 1 if one else T})[name + "<"]
            _require(n == (1 if one else T),
                     f"{name}: {1 if one else T} launch(es) a call, got {n}")
            row.update({"ms": ms, "per_frame_us": ms / T * 1e3,
                        "launches_per_call": n, "kernel_us": us,
                        "bound_ms": bound_ms})
        out[name] = row
    return out


def cudnn_lstm_ms(B, T, H, dtype, dev, train: bool) -> float:
    """The scale reference for K1, NOT the same function: one
    ``torch.nn.LSTM(H, H, bidirectional=True)`` call (cuDNN) at the same B,
    T, H and dtype. cuDNN fuses the input projection, which the kernel
    leaves to cuBLAS, and has no per-frame mask freeze. ``train``: with
    autograd recording (cuDNN keeps its reserve space), as the save_cell
    form runs."""
    import torch

    lstm = torch.nn.LSTM(H, H, bidirectional=True).to(dev, dtype)
    x = torch.randn((T, B, H), device=dev, dtype=dtype, requires_grad=train)
    with torch.set_grad_enabled(train):
        return _cuda_ms(lambda: lstm(x), 10)


def fwd_kernel_extras(call, B, T, dtype, ms: float, bound_ms: float) -> dict:
    """Beside a timed K1 call (both directions): the forward kernel's
    launches in one call (torch.profiler: one, or T where the library runs
    lstm_step), the time per frame, and whether two runs give the same
    bits."""
    import torch

    dt = _dtname(dtype)
    name = fwd_kernel_name(B, 512, dtype)
    want = T if name == "lstm_step" else 1
    launches = _kernel_us(call, (name + "<",), {name + "<": want})[
        name + "<"][1]
    _require(launches == want,
             f"{name}: launches a call at B={B} T={T}: {launches}")
    a, b = call(), call()
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    _require(same, f"K1 deterministic at B={B} T={T} {dt}")
    return {"launches_per_call": launches, "kernel_name": name,
            "per_frame_us": ms / T * 1e3, "bound_per_frame_us":
            bound_ms / T * 1e3, "bit_equal_twice": same}


def cudnn_phase(dev, card: str, rows: dict, lstm_rows: dict) -> None:
    """cuDNN's nn.LSTM at each shape where K1 was timed, added to its rows
    as ``cudnn_lstm_ms`` (the scale reference, not the same function)."""
    import torch

    note = ("torch.nn.LSTM(H, H, bidirectional=True), not the same "
            "function: fuses the input projection, no mask freeze")
    targets = [((B, T), dt, False, rows[(B, T)][dt])
               for (B, T) in rows for dt in rows[(B, T)]]
    targets += [((B, T), dt, True, r["lstm_fwd_save_cell"])
                for (B, T, dt), r in lstm_rows.items()]
    for (B, T), dtype, train, row in targets:
        row["cudnn_lstm_ms"] = cudnn_lstm_ms(B, T, 512, dtype, dev, train)
        row["cudnn_lstm_is"] = note
        print(f"cuDNN nn.LSTM B={B} T={T} H=512 {_dtname(dtype)}"
              f"{' with autograd' if train else ''}: "
              f"{row['cudnn_lstm_ms']:.3f} ms (kernel {row['ms']:.3f} ms; "
              f"not the same function) ({card})", flush=True)


def kernel_phase(dev, card: str,
                 shapes=(ODD_SHAPE, FLAGSHIP_SHAPE, SMALL_BUCKET_SHAPE)
                 ) -> dict:
    """Kernel vs plain on every shape; times at the others than the first
    (the flagship and the W=128 bucket's shape), keyed (B, T)."""
    import torch
    from vistaocr_tpu_torch.ops import lstm_cuda

    tol = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
    rows = {}
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
            f32 = dtype == torch.float32
            fdirs = [(fwd[0], fwd[1], False), (bwd[0], bwd[1], True)]
            if (B, T, H) == shapes[0]:
                if f32:  # both f32 designs named, checked only
                    with torch.inference_mode():
                        f32_fwd_designs(fdirs, mask, [ref_f, ref_b], False, T)
                continue

            def kern():
                return lstm_cuda.blstm_recurrence(fwd[0], bwd[0], mask, fwd[1],
                                                  bwd[1], dtype=dtype)

            def plain():
                lstm_cuda.lstm_recurrence_ref(fwd[0], mask, fwd[1],
                                              reverse=False, dtype=dtype)
                lstm_cuda.lstm_recurrence_ref(bwd[0], mask, bwd[1],
                                              reverse=True, dtype=dtype)

            with torch.inference_mode():
                ms = _cuda_ms(kern, 10)
                plain_ms = _cuda_ms(plain, 3)
                # xw, wh and the mask read once, ys written once
                nbytes = _nbytes(mask, fwd[0], bwd[0], fwd[1], bwd[1], ys_f,
                                 ys_b)
                row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": None,
                       **_bound(nbytes, 2 * T * 2 * B * H * 4 * H, dtype)}
                row.update(fwd_kernel_extras(kern, B, T, dtype, ms,
                                             row["bound_ms"]))
                if f32:
                    row["designs"] = f32_fwd_designs(
                        fdirs, mask, [ref_f, ref_b], False, T,
                        row["bound_ms"])
            print(f"time {tag}, both directions: kernel {ms:.3f} ms = "
                  f"{row['per_frame_us']:.2f} us a frame (bound "
                  f"{row['bound_per_frame_us']:.3f}; {row['launches_per_call']}"
                  f" launch(es) of {row['kernel_name']} a call; two runs "
                  f"bit-equal), plain {plain_ms:.3f} ms ({card})", flush=True)
            if f32:
                print(f"f32 designs {tag}, inference, both directions: " +
                      "; ".join(f"{n} {d['ms']:.3f} ms = {d['per_frame_us']:.2f}"
                                f" us a frame, {d['launches_per_call']} "
                                f"launch(es), max|d|={d['max_abs_err']:.3e}"
                                for n, d in row["designs"].items()) +
                      f" (the library runs {row['kernel_name']}) ({card})",
                      flush=True)
            rows.setdefault((B, T), {})[dtype] = row
    return rows


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
    # deskew on the device in front of the forward, both dispatches (the
    # contract height and the device resize)
    svc = OcrService(snap, ServiceConfig(max_batch=128, max_wait_ms=2.0,
                                         device_deskew=True), device="cuda")
    try:
        lstm_cuda.LAUNCHES = 0
        svc.ocr_lines(bulk)
        t0 = time.time()
        skewed = svc.ocr_lines(bulk)
        dt = time.time() - t0
        _require(len(skewed) == len(bulk) and lstm_cuda.LAUNCHES > 0
                 and all(0 < r.confidence <= 1 for r in skewed),
                 "device_deskew service: every line answered and scored")
        print(f"ocr_lines with device_deskew: {len(bulk)} lines in {dt:.3f} "
              f"s = {len(bulk) / dt:.1f} lines/s ({smi}); "
              f"{sum(a.text == b.text for a, b in zip(skewed, results))} "
              "texts as without it", flush=True)
    finally:
        svc.close()
    return launches


def service_profile(snap: str, smi: str, top: int = 12) -> None:
    """Device time of one warm ``ocr_lines`` call over phase 4's 264 lines
    under ``torch.profiler``: the window, the device-busy share and the
    largest kernels by name (``train.device_time_summary``)."""
    from torch.profiler import ProfilerActivity, profile
    from vistaocr_tpu_torch.serve import OcrService, ServiceConfig
    from vistaocr_tpu_torch.train import device_time_summary

    rng = np.random.default_rng(7)
    bulk = _lines(rng, 256, 32, 40, 2048)
    bulk += _lines(rng, 4, 48, 40, 3000) + _lines(rng, 4, 64, 40, 4000)
    svc = OcrService(snap, ServiceConfig(max_batch=128, max_wait_ms=2.0),
                     device="cuda")
    try:
        svc.ocr_lines(bulk)  # warm
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            svc.ocr_lines(bulk)
    finally:
        svc.close()
    print(f"service profile, one warm ocr_lines call over {len(bulk)} lines "
          f"({smi}):\n" + "".join(device_time_summary(
              prof.events()).splitlines(True)[:top]), flush=True)



# --- phase 4b: the HTTP server ----------------------------------------------
CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "torch_port_images")
DECODE_TIMED = ("grey_64x2048.png", "grey_64x2048_q90.jpg",
                "rgb420_32x2048_q90.jpg")
HTTP_CLIENTS = 8
HTTP_BATCH = 16  # images a /ocr_batch call


def png_bytes(img) -> bytes:
    """A minimal grey 8-bit PNG writer: zlib over rows whose filter type
    cycles through all five (None, Sub, Up, Average, Paeth)."""
    import struct
    import zlib

    def chunk(cid, data):
        return (struct.pack(">I", len(data)) + cid + data
                + struct.pack(">I", zlib.crc32(data, zlib.crc32(cid))))

    H, W = img.shape
    rows = bytearray()
    prev = np.zeros(W, np.int64)
    for y in range(H):
        row = img[y].astype(np.int64)
        a = np.concatenate([[0], row[:-1]])
        c = np.concatenate([[0], prev[:-1]])
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, prev, c))
        ft = y % 5
        pred = (0, a, prev, (a + prev) // 2, paeth)[ft]
        rows.append(ft)
        rows += ((row - pred) % 256).astype(np.uint8).tobytes()
        prev = row
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(rows), 6))
            + chunk(b"IEND", b""))


def decoder_check(smi: str) -> dict:
    """Every corpus file decoded without PIL, its array's sha256, dtype and
    shape held to the manifest (written from Pillow); the median ms an
    image of the timed trio."""
    import hashlib
    from vistaocr_tpu_torch.serve import imagecodec

    with open(os.path.join(CORPUS, "manifest.json")) as f:
        manifest = json.load(f)
    for name, want in manifest.items():
        with open(os.path.join(CORPUS, name), "rb") as f:
            arr = imagecodec.decode_image(f.read())
        got = {"sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
               "dtype": str(arr.dtype), "shape": list(arr.shape)}
        _require(got == want, f"{name}: decoded {got} == manifest {want}")
    ms = {}
    for name in DECODE_TIMED:
        with open(os.path.join(CORPUS, name), "rb") as f:
            raw = f.read()
        times = []
        for _ in range(60):
            t0 = time.perf_counter()
            imagecodec.decode_image(raw)
            times.append((time.perf_counter() - t0) * 1e3)
        ms[name] = float(np.median(times[10:]))
    print(f"decoder: {len(manifest)} corpus files equal to the manifest; "
          f"median ms an image {json.dumps(ms)} (host CPU of the card "
          f"machine; {smi})", flush=True)
    return {"files": len(manifest), "ms": ms}


def http_requests(rng):
    """(bodies, decoded arrays): 256 text-like lines at heights 32, 48 and
    64, widths 40-2048, as PNG, then the corpus's JPEG lines."""
    from vistaocr_tpu_torch.serve import imagecodec

    lines = []
    for k, h in enumerate((32, 48, 64)):
        lines += _lines(rng, 86 - (k == 2) * 2, h, 40, 2048)
    bodies = [png_bytes(img) for img in lines]
    for name in sorted(os.listdir(CORPUS)):
        if name.endswith(".jpg"):
            with open(os.path.join(CORPUS, name), "rb") as f:
                bodies.append(f.read())
    return bodies, [imagecodec.decode_image(b) for b in bodies]


def http_load(url: str, bodies) -> tuple:
    """Eight client threads at once, each request raw ``/ocr``, JSON
    ``/ocr`` or ``/ocr_batch`` of 16 in turn: (texts by body, request
    latencies ms, the service's own ``latency_ms`` of each ``/ocr``, wall
    s, statuses)."""
    import base64
    import threading
    import urllib.request

    units, i, k = [], 0, 0
    while i < len(bodies):
        kind = ("raw", "json", "batch")[k % 3]
        n = HTTP_BATCH if kind == "batch" else 1
        units.append((kind, list(range(i, min(i + n, len(bodies))))))
        i += n
        k += 1
    texts = [None] * len(bodies)
    lat, svc_lat, statuses, lock = [], [], [], threading.Lock()

    def post(path, data, ctype):
        req = urllib.request.Request(url + path, data=data, method="POST",
                                     headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())

    def client(c):
        for kind, idx in units[c::HTTP_CLIENTS]:
            t0 = time.perf_counter()
            if kind == "raw":
                status, body = post("/ocr", bodies[idx[0]], "image/png")
                got = [body]
            elif kind == "json":
                status, body = post("/ocr", json.dumps({"image_b64": (
                    base64.b64encode(bodies[idx[0]]).decode())}).encode(),
                    "application/json")
                got = [body]
            else:
                status, body = post("/ocr_batch", json.dumps({
                    "images_b64": [base64.b64encode(bodies[j]).decode()
                                   for j in idx]}).encode(),
                    "application/json")
                got = body["results"]
            dt = (time.perf_counter() - t0) * 1e3
            with lock:
                lat.append(dt)
                statuses.append(status)
                if kind != "batch":
                    svc_lat.append(got[0]["latency_ms"])
                for j, r in zip(idx, got):
                    texts[j] = r["text"]

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(HTTP_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return texts, lat, svc_lat, time.perf_counter() - t0, statuses


def _http_server(svc):
    import threading
    from http.server import ThreadingHTTPServer
    from vistaocr_tpu_torch.serve.http_server import make_handler

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_port}"


def _bad_requests(url: str) -> list:
    import urllib.error
    import urllib.request

    out = []
    for path, data, ctype in (
            ("/ocr", b"not an image", "image/png"),
            ("/ocr", b"II*\x00" + bytes(60), "image/tiff"),
            ("/ocr_batch", json.dumps({"images_b64": []}).encode(),
             "application/json")):
        req = urllib.request.Request(url + path, data=data, method="POST",
                                     headers={"Content-Type": ctype})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                out.append(r.status)
        except urllib.error.HTTPError as e:
            out.append(e.code)
    return out


def _text_gate(name, svc, http_texts, ref_texts, arrays) -> dict:
    """HTTP texts against direct ``ocr_lines`` on the same arrays. The
    service pads a batch to its ladder size (8, 32 or 128), and in bf16
    the forward's rounding follows that size, so a line that rode in a
    batch of another size than in the bulk call is held to ``ocr_lines``
    of itself at each ladder size (1, 9 and 33 copies): its HTTP text must
    equal one of them. Counts: equal to the bulk call, equal at another
    ladder size, equal to none (the gate)."""
    out = {"equal": 0, "other_batch_size": 0, "none": 0}
    for i, (a, b) in enumerate(zip(http_texts, ref_texts)):
        if a == b:
            out["equal"] += 1
            continue
        at = [svc.ocr_lines([arrays[i]] * k)[0].text for k in (1, 9, 33)]
        out["other_batch_size" if a in at else "none"] += 1
        print(f"  {name}: line {i} {arrays[i].shape}: http {a!r}, bulk "
              f"ocr_lines {b!r}, alone at B=8/32/128 {at!r}", flush=True)
    return out


def http_phase(snap: str, card: str, smi: str) -> dict:
    """The port's HTTP server over the bf16 flagship on 127.0.0.1:0 (a
    thread): the decoder against the committed corpus; 271 lines (256 PNG
    at heights 32/48/64, widths 40-2048, plus the corpus's 15 JPEG lines)
    from eight clients at once, mixing raw and JSON ``/ocr`` and
    ``/ocr_batch`` of 16, twice (the second timed): every answer 200 and
    its text equal to ``ocr_lines`` on the same decoded arrays (at the
    batch size it rode in, ``_text_gate``); ``/stats`` lines grow by the
    count sent; a bad body, a TIFF header and an empty batch answer
    400; K1's launches (``lstm_cuda.LAUNCHES``, set to 0 before the load
    and read after) two a batch, no f32-weight forward. Then a second
    server with the device beam (plain) under the same mixed load of 101
    lines, its texts equal to a serial ``ocr_lines``; then ``serve.soak``
    20 s with 8 clients and no error."""
    from vistaocr_tpu_torch.ops import lstm_cuda
    from vistaocr_tpu_torch.serve import OcrService, ServiceConfig, soak

    t_phase = time.time()
    out = {"decode": decoder_check(smi)}
    bodies, arrays = http_requests(np.random.default_rng(11))
    n = len(bodies)
    svc = OcrService(snap, ServiceConfig(max_batch=128, max_wait_ms=2.0),
                     device="cuda")
    httpd, url = _http_server(svc)
    try:
        ref = [r.text for r in svc.ocr_lines(arrays)]  # also warms shapes
        t0 = time.perf_counter()
        svc.ocr_lines(arrays)
        direct_s = time.perf_counter() - t0
        http_load(url, bodies)  # the first load, untimed
        lines0 = svc.stats["lines"]
        batches0 = svc.stats["batches"]
        lstm_cuda.LAUNCHES = 0
        lstm_cuda.FWD_GRID_LAUNCHES = 0
        lstm_cuda.STEP_LAUNCHES = 0
        texts, lat, svc_lat, wall, statuses = http_load(url, bodies)
        launches = lstm_cuda.LAUNCHES
        grid, step = lstm_cuda.FWD_GRID_LAUNCHES, lstm_cuda.STEP_LAUNCHES
        batches = svc.stats["batches"] - batches0
        grown = svc.stats["lines"] - lines0
        bad = _bad_requests(url)
        gate = _text_gate("greedy", svc, texts, ref, arrays)
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.close()
    lat = np.sort(np.asarray(lat))
    svc_lat = np.sort(np.asarray(svc_lat))
    out.update({
        "lines": n, "requests": len(lat),
        "http_lines_per_s": n / wall, "ocr_lines_lines_per_s": n / direct_s,
        "p50_ms": float(lat[len(lat) // 2]),
        "p99_ms": float(lat[min(len(lat) - 1, int(len(lat) * 0.99))]),
        "service_latency_p50_ms": float(svc_lat[len(svc_lat) // 2]),
        "launches_http": launches, "batches_http": batches, "texts": gate})
    print(f"http greedy (warm): {n} lines in {len(lat)} requests from "
          f"{HTTP_CLIENTS} clients, {n / wall:.1f} lines/s, request p50 "
          f"{out['p50_ms']:.2f} ms p99 {out['p99_ms']:.2f} ms (the "
          f"service's own latency_ms p50 {out['service_latency_p50_ms']:.2f}"
          f"); ocr_lines on the same arrays {n / direct_s:.1f} lines/s; K1 "
          f"launches {launches} over {batches} batches; texts {gate} "
          f"({card}, {smi})", flush=True)
    _require(all(s == 200 for s in statuses), f"every answer 200: {statuses}")
    _require(None not in texts, "every line answered")
    _require(grown == n, f"/stats lines grew by {grown}, sent {n}")
    _require(bad == [400, 400, 400], f"bad requests answer 400: {bad}")
    _require(launches == 2 * batches and batches > 0,
             f"K1 two launches a batch: {launches} over {batches} batches")
    _require(grid == 0 and step == 0,
             f"no f32-weight forward: grid {grid}, step {step}")
    _require(gate["none"] == 0, f"HTTP texts equal to ocr_lines: {gate}")

    # the device beam behind a second server: /ocr_batch runs ocr_lines in
    # a handler thread while the bucket workers dispatch and replay
    beam_cfg = ServiceConfig(max_batch=128, max_wait_ms=2.0, decoder="beam",
                             warmup=False)
    svc = OcrService(snap, beam_cfg, device="cuda")
    httpd, url = _http_server(svc)
    sub = list(range(0, 256, 3))[:86] + list(range(256, n))
    try:
        texts, _, _, wall_b, statuses = http_load(
            url, [bodies[i] for i in sub])
        ref = [r.text for r in svc.ocr_lines([arrays[i] for i in sub])]
        gate_b = _text_gate("beam", svc, texts, ref,
                            [arrays[i] for i in sub])
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.close()
    out["beam"] = {"lines": len(sub), "http_lines_per_s": len(sub) / wall_b,
                   "texts": gate_b}
    print(f"http device beam: {len(sub)} lines, {len(sub) / wall_b:.1f} "
          f"lines/s (graph captures included); texts against a serial "
          f"ocr_lines {gate_b} ({smi})", flush=True)
    _require(all(s == 200 for s in statuses), "beam: every answer 200")
    _require(gate_b["none"] == 0, f"beam: texts equal to ocr_lines: {gate_b}")

    report = soak.main(["--snapshot", snap, "--seconds", "20", "--clients",
                        "8", "--device", "cuda"])
    out["soak"] = report
    print(f"serve.soak 20 s, 8 clients ({smi})", flush=True)
    _require(report["errors"] == 0, f"soak errors: {report['first_errors']}")
    out["seconds"] = time.time() - t_phase
    print(f"http phase {out['seconds']:.1f} s", flush=True)
    return out


def _colour(img, i: int):
    """A grayscale line as an RGB (or, every third, RGBA) array."""
    rgb = np.stack([img, np.roll(img, i, axis=1), 255 - img // 3], axis=-1)
    if i % 3 == 1:
        alpha = np.full(img.shape + (1,), 255 - i % 7, np.uint8)
        rgb = np.concatenate([rgb, alpha], axis=-1)
    return rgb.astype(np.uint8)


def _from_lexicon(text: str, lexicon: set) -> bool:
    """Lexicon words, the last of which may be a word's prefix (the beam
    keeps a mid-word final where no whole-word final survives)."""
    *head, last = text.split() or [""]
    return set(head) <= lexicon and (
        last in lexicon or any(w.startswith(last) for w in lexicon))


def infer_phase(dev, snap: str, data: str, font: dict, smi: str) -> dict:
    """``run_inference`` of the flagship snapshot ``snap`` (phase 7's, 40
    bf16 steps) on the glyph validation split of ``data``: greedy with a
    posterior dump that the port's ``decode.offline`` decodes to the same
    strings (a line may differ only where the dump's f16 log-probs tie
    its top two classes at some frame: f16 keeps 11 bits); host beam with
    a char LM and a lexicon built from the split's transcripts, on the C++
    engine (required: a broken build fails here); then ``OcrService`` with
    ``beam_impl="host"`` and ``device_resize=False`` on colour lines at
    and off the contract height. The K1 forward's launches are counted
    over the phase; greedy and host-beam lines/s printed with the card."""
    from vistaocr_tpu_torch import infer
    from vistaocr_tpu_torch.data import open_dataset
    from vistaocr_tpu_torch.decode import device_beam as db
    from vistaocr_tpu_torch.decode import native_binding, offline
    from vistaocr_tpu_torch.decode.lm import train_char_lm
    from vistaocr_tpu_torch.ops import lstm_cuda
    from vistaocr_tpu_torch.serve import OcrService, ServiceConfig
    from vistaocr_tpu_torch.text import uxxxx_to_utf8

    _require(native_binding.available(),
             f"the C++ beam engine builds: {native_binding.build_error()}")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        texts = list(open_dataset(data, "val").transcripts())
        lm_path, lex_path = os.path.join(tmp, "char.arpa"), os.path.join(
            tmp, "words.txt")
        train_char_lm(texts, order=3).write_arpa(lm_path)
        words = sorted({w for t in texts for w in uxxxx_to_utf8(t).split()})
        with open(lex_path, "w") as f:
            f.write("\n".join(words) + "\n")

        def run(tag, **kw):
            path = os.path.join(tmp, f"{tag}.jsonl")
            report = infer.run_inference(snap, data, "val", out_path=path,
                                         device=dev, log=lambda m: None, **kw)
            with open(path) as f:
                recs = [json.loads(line) for line in f]
            _require(report["lines"] == len(recs) == len(texts),
                     f"{tag}: {len(texts)} lines, got {report['lines']}")
            return report, recs

        lstm_cuda.LAUNCHES = 0
        run("warm")  # cuDNN's first calls at each shape
        greedy, recs = run("greedy")
        dump = os.path.join(tmp, "dump")
        dumped, recs = run("dump", dump_posteriors=dump)
        off = os.path.join(tmp, "offline.jsonl")
        offline.decode_posteriors(dump, decoder="greedy", out_path=off,
                                  log=lambda m: None)
        with open(off) as f:
            off_hyps = {r["id"]: r["hyp_uxxxx"] for r in map(json.loads, f)}
        hyps = {r["id"]: r["hyp_uxxxx"] for r in recs}
        differ = {i for i in hyps if off_hyps.get(i) != hyps[i]}
        tied = set()
        for lid, lp in infer.iter_posteriors(dump):
            top = np.sort(lp, axis=1)[:, -2:]
            ulp = np.exp2(np.floor(np.log2(np.abs(top[:, 1]) + 1e-30)) - 10)
            if (top[:, 1] - top[:, 0] <= ulp).any():
                tied.add(lid)
        same = len(hyps) - len(differ)
        _require(set(off_hyps) == set(hyps) and differ <= tied,
                 f"the offline decode of the dump gives run_inference's "
                 f"greedy hypotheses: {len(differ)} lines differ, of them "
                 f"{len(differ - tied)} with no f16 tie")
        _require(all(r["conf"] is not None and 0 < r["conf"] <= 1
                     for r in recs), "greedy confidences in (0, 1]")
        beam, brecs = run("beam", decoder="beam", beam_impl="host",
                          lm_path=lm_path, lexicon_path=lex_path)
        lexicon = set(words)
        _require(all(_from_lexicon(r["hyp_text"], lexicon) for r in brecs),
                 "host-beam hypotheses are lexicon words")
        # the device beam (the default beam_impl): plain, with the char LM
        # and lexicon fused, and their n-best lists; each run twice, the
        # first capturing a graph per batch shape, the second replaying
        db.GRAPH_REPLAYS = 0
        captures = db.GRAPH_CAPTURES
        cold = {}
        for tag, kw in (("plain", {}),
                        ("fused", dict(lm_path=lm_path,
                                       lexicon_path=lex_path)),
                        ("nbest", dict(lm_path=lm_path,
                                       lexicon_path=lex_path, nbest=4))):
            cold[tag] = run(f"beam_device_{tag}_cold", decoder="beam",
                            **kw)[0]["lines_per_sec"]
            if tag == "plain":
                dplain, _ = run("beam_device_plain", decoder="beam")
            elif tag == "fused":
                dbeam, drecs = run("beam_device", decoder="beam", **kw)
            else:
                dnbest, nrecs = run("beam_device_nbest", decoder="beam",
                                    **kw)
        replays, captures = db.GRAPH_REPLAYS, db.GRAPH_CAPTURES - captures
        _require(replays > 0, "run_inference replayed the device beam graph")
        _require(dbeam["decoder"] == "beam:device"
                 and dbeam["lm_fusion"] == "device-interleaved",
                 f"device beam report {dbeam}")
        _require(all(_from_lexicon(r["hyp_text"], lexicon) for r in drecs)
                 and all(0 < r["conf"] <= 1 for r in drecs),
                 "device-beam hypotheses are lexicon words, scored")
        _require(all(1 <= len(r["nbest"]) <= 4
                     and r["nbest"][0]["hyp_uxxxx"] == r["hyp_uxxxx"]
                     for r in nrecs), "n-best lists of 1-4, best first")
        _require([r["hyp_uxxxx"] for r in nrecs]
                 == [r["hyp_uxxxx"] for r in drecs],
                 "the fused n-best's first is the fused 1-best")
        dev_host_same = sum(a["hyp_uxxxx"] == b["hyp_uxxxx"]
                            for a, b in zip(drecs, brecs))
        rng = np.random.default_rng(41)
        lines = [img for img, _ in glyph_lines(font, rng, 24, 40, 1500)]
        lines = [_colour(img, i) for i, img in enumerate(lines)]
        lines += [np.repeat(img, 2, axis=0) for img in lines[:4]]  # H=64
        lines += [img[::2] for img in lines[4:8]]  # H=16
        svc = OcrService(snap, ServiceConfig(
            decoder="beam", beam_impl="host", lm_path=lm_path,
            lexicon_path=lex_path, device_resize=False, max_batch=32,
            warmup=False), device=dev)
        try:
            t0 = time.time()
            results = svc.ocr_lines(lines)
            svc_dt = time.time() - t0
            results.append(svc.submit(lines[0]).result(timeout=300))
        finally:
            svc.close()
        _require(len(results) == len(lines) + 1 and all(
            _from_lexicon(r.text, lexicon) and r.confidence is None
            for r in results),
            "service host beam on colour lines: lexicon words, no score")
        launches = lstm_cuda.LAUNCHES
        _require(launches > 0, "the LSTM forward kernel ran in the phase")
        out = {"greedy_lines_per_sec": greedy["lines_per_sec"],
               "greedy_with_dump_lines_per_sec": dumped["lines_per_sec"],
               "greedy_cer": greedy["cer"],
               "beam_lines_per_sec": beam["lines_per_sec"],
               "beam_cer": beam["cer"], "lines": len(texts),
               "device_beam_plain_lines_per_sec": dplain["lines_per_sec"],
               "device_beam_lines_per_sec": dbeam["lines_per_sec"],
               "device_beam_nbest_lines_per_sec": dnbest["lines_per_sec"],
               "device_beam_cer": dbeam["cer"],
               "device_beam_equals_host_beam": dev_host_same,
               "device_beam_graph_replays": replays,
               "device_beam_graph_captures": captures,
               "device_beam_cold_lines_per_sec": cold,
               "offline_same": same, "offline_f16_tied": len(tied),
               "service_lines": len(lines),
               "service_lines_per_sec": len(lines) / svc_dt,
               "lstm_fwd_launches": launches}
    print(f"infer: run_inference greedy {out['greedy_lines_per_sec']} "
          f"lines/s ({out['greedy_with_dump_lines_per_sec']} with the "
          f"posterior dump), host beam (C++ engine, char LM + lexicon) "
          f"{out['beam_lines_per_sec']} lines/s over {len(texts)} glyph "
          f"lines (CER {out['greedy_cer']} / {out['beam_cer']}); device "
          f"beam plain {out['device_beam_plain_lines_per_sec']}, char LM + "
          f"lexicon fused {out['device_beam_lines_per_sec']} (CER "
          f"{out['device_beam_cer']}; equal to the host beam on "
          f"{dev_host_same} lines), --nbest 4 "
          f"{out['device_beam_nbest_lines_per_sec']} lines/s (warm; the "
          f"runs that captured the graphs {cold}), {captures} graphs "
          f"captured, {replays} replays; offline "
          f"decode of the dump equal on {same} lines ({len(tied)} with an "
          f"f16 tie at some frame); "
          f"service host beam, host resize: {out['service_lines']} colour "
          f"lines at {out['service_lines_per_sec']:.1f} lines/s; "
          f"lstm_fwd launches {launches} ({smi})", flush=True)
    return out


def _hyp_uxxxx(alphabet, hyp) -> str:
    """A service finalize's hypothesis as uxxxx: an id row or a uxxxx
    string, with or without its score."""
    if isinstance(hyp, tuple):
        hyp = hyp[0]
    return hyp if isinstance(hyp, str) else alphabet.decode(hyp.tolist())


def _ends_mid_word(uxxxx: str, lexicon: set) -> bool:
    """The hypothesis's last word is no lexicon word: the search fell back
    to every beam because none ended at a word boundary."""
    from vistaocr_tpu_torch.text import uxxxx_to_utf8

    text = uxxxx_to_utf8(uxxxx).split()
    return bool(text) and text[-1] not in lexicon


# A line where the device beam and the host engine return different
# strings on the same posteriors, with no LM or lexicon in play, is held
# to the host's n-best (its Python expansion, float64): the device's
# string must be one of the host's BEAM_NBEST best, within
# beam_tie_margin of the host's best score.
BEAM_NBEST = 4


def beam_tie_margin(frames: int, score: float) -> float:
    """The widest gap that f32 rounding can open between two computations
    of one prefix's CTC score over ``frames`` frames, ``score`` its
    magnitude. A frame updates a prefix's log-domain mass by two f32
    additions of values at most |score| + |lp| (each within u = 2**-24 of
    its result) and one log-add-exp term in [0, log 2] (within 3u of it,
    about 2.1u); along the winning prefix the partial scores lie between
    the final score and 0, and each frame's lp is within it, so a frame
    adds at most u * (2 |score| + 3) and a line T times that. Both sides
    may round (the device's search in f32; the host engine in f32 or
    float64), so the margin is twice the one-sided bound:
    2 * 2**-24 * T * (2 |score| + 3)."""
    return 2.0 * 2.0 ** -24 * frames * (2.0 * abs(score) + 3.0)


def beam_tie(lp, frames: int, alphabet, config, dev_hyp: str,
             dev_score: float) -> dict:
    """The host's ``BEAM_NBEST`` best hypotheses with their scores on one
    line's posteriors (``lp`` [>= frames, K], no LM or lexicon: the Python
    expansion, float64), and whether ``dev_hyp`` is among them within
    ``beam_tie_margin`` of the best: ``tie``, ``margin``, ``gap`` (the
    host's best score less its score for ``dev_hyp``, or None when it is
    not in the n-best), ``host`` [(uxxxx, score)] and ``device``
    (``dev_hyp``, ``dev_score``, the device's own f32 score)."""
    from vistaocr_tpu_torch.decode import beam_decode

    lp = np.asarray(lp, np.float32)[None, :frames]
    host = beam_decode(lp, np.ones((1, frames), bool), alphabet, config,
                       nbest=BEAM_NBEST)[0]
    best = host[0][1]
    found = [sc for h, sc in host if h == dev_hyp]
    gap = best - found[0] if found else None
    margin = beam_tie_margin(frames, max(abs(best), abs(dev_score)))
    return {"tie": gap is not None and gap <= margin, "margin": margin,
            "gap": gap, "host": host, "device": (dev_hyp, dev_score)}


def beam_same_posteriors(svc, lines, words, seed: int = 5) -> dict:
    """The device beam's tail (``_decode_tail`` + ``_finalize``, the
    service's own) and the host engine (``beam_decode``: the C++ engine
    with the service's char LM, lexicon and word LM) on the same
    posteriors: the model's, batch by batch as ``ocr_lines`` assembles
    ``lines``, then 64 seeded CTC-shaped lines of 256 frames
    (``beam_posteriors``), whose hypotheses are long whatever the
    snapshot learned. On the first batch also the graph twice (bit-equal)
    and eagerly (the same rows). Lines that differ only where no beam
    ends at a word boundary (``decode/device_beam.py``: the documented
    fallback, where the host oracle still word-scores the partial
    trailing word) are printed with that reason; with no LM or lexicon,
    lines whose device string is a near tie of the host's (``beam_tie``:
    in the host's n-best within ``beam_tie_margin`` of its best) are
    counted as ``tie_within_rounding`` and printed with both strings and
    scores; any other difference fails. ``seed``: the seeded lines'."""
    import torch
    from vistaocr_tpu_torch.decode import beam_decode

    groups: dict = {}
    for img in lines:
        p = svc._prep(img)
        groups.setdefault(svc.contract.bucket_for_width(p.width), []).append(p)
    batches = []
    with torch.inference_mode():
        for b, plist in sorted(groups.items()):
            for i in range(0, len(plist), svc.config.max_batch):
                chunk = plist[i:i + svc.config.max_batch]
                images, widths, _ = svc._assemble(b, chunk)
                batches.append((*svc.model(svc._to_device(images),
                                           svc._to_device(widths)),
                                len(chunk)))
    batches.append((*beam_posteriors(64, 256, svc.alphabet.num_classes,
                                     svc.device, seed=seed), 64))
    tally = {"same": 0, "no_boundary_fallback": 0, "tie_within_rounding": 0,
             "nonempty": 0}
    plain = svc._lm is None and svc._lexicon is None and svc._word_lm is None
    for n, (lp, fm, count) in enumerate(batches):
        with torch.inference_mode():
            dev_hyps = svc._finalize(svc._decode_tail(lp, fm), count)
            if n == 0:
                one = svc._beam_prog(lp, fm, **svc._beam_kw)
                two = svc._beam_prog(lp, fm, **svc._beam_kw)
                eager = svc._beam_prog(lp, fm, graph=False, **svc._beam_kw)
                _require(all(torch.equal(a, c) for a, c in zip(one, two)),
                         "two graph replays bit-equal")
                _require(all(torch.equal(a, c) for a, c in zip(one, eager)),
                         "graph and eager give the same rows")
        host = beam_decode(lp, fm, svc.alphabet, svc.config.beam,
                           lm=svc._lm, valid=np.arange(lp.shape[0]) < count,
                           lexicon=svc._lexicon, word_lm=svc._word_lm)
        for i, (dh, h) in enumerate(zip(dev_hyps, host)):
            d = _hyp_uxxxx(svc.alphabet, dh)
            tally["nonempty"] += bool(d)
            if d == h:
                tally["same"] += 1
                continue
            tie = None
            if plain:
                tie = beam_tie(lp[i].float().cpu().numpy(),
                               int(fm[i].sum()), svc.alphabet,
                               svc.config.beam, d, float(dh[1]))
                print(f"  device {d!r} (device score {dh[1]:.7f}) != host "
                      f"{h!r}: host {BEAM_NBEST}-best "
                      f"{[(x, round(v, 7)) for x, v in tie['host']]}; gap "
                      f"{tie['gap']}, margin {tie['margin']:.3e} "
                      f"({int(fm[i].sum())} frames): "
                      f"{'tie within rounding' if tie['tie'] else 'GAP'}",
                      flush=True)
            if tie is not None and tie["tie"]:
                tally["tie_within_rounding"] += 1
            elif words and (_ends_mid_word(d, words)
                            or _ends_mid_word(h, words)):
                tally["no_boundary_fallback"] += 1
                print(f"  differs only by the no-boundary fallback (no beam "
                      f"ends at a word boundary; the host oracle word-scores "
                      f"the partial trailing word, the device search does "
                      f"not): device {d!r}, host {h!r}", flush=True)
            else:
                _require(False, f"device beam {d!r} == host beam {h!r} on "
                                "the same posteriors")
    return tally


def service_beam_phase(dev, snap: str, data: str, font: dict, card: str,
                       smi: str) -> dict:
    """The device beam (``decoder="beam"``, ``beam_impl="device"``, the
    default) behind ``OcrService(max_batch=128)`` on phase 7's snapshot
    and 128 new glyph lines of 40-2048 px: plain (its warm-up captures
    every (bucket, batch size) graph), then with the char LM (order 3)
    and lexicon built from the glyph validation transcripts as the
    ``infer`` phase builds them, then with a word-bigram LM over the same
    transcripts as well. Each through ``ocr_lines`` with the graph replay
    and K1 launch counters set to 0 before and read after (both must
    grow), confidences in (0, 1]; then the same posteriors through the
    device tail and the host engine (``beam_same_posteriors``); then a warm
    ``ocr_lines`` call timed. Beside them, on the same lines: the greedy
    service and the host beam with the char LM and lexicon (lines/s);
    the device-busy share of a warm ``ocr_lines`` call of the word-LM
    service (``torch.profiler``); and ``device_beam_timing`` of the plain
    and word-LM services' programs."""
    from torch.profiler import ProfilerActivity, profile
    from vistaocr_tpu_torch.data import open_dataset
    from vistaocr_tpu_torch.decode import BeamConfig
    from vistaocr_tpu_torch.decode import device_beam as db
    from vistaocr_tpu_torch.decode.lm import train_char_lm
    from vistaocr_tpu_torch.ops import lstm_cuda
    from vistaocr_tpu_torch.serve import OcrService, ServiceConfig
    from vistaocr_tpu_torch.text import uxxxx_to_utf8
    from vistaocr_tpu_torch.train import device_time_summary

    out: dict = {}
    beam = BeamConfig(lm_alpha=0.5, word_lm_alpha=0.5)
    lines = [img for img, _ in glyph_lines(font, np.random.default_rng(43),
                                           128, 40, 2048)]
    with tempfile.TemporaryDirectory() as tmp:
        texts = list(open_dataset(data, "val").transcripts())
        lm_path = os.path.join(tmp, "char.arpa")
        lex_path = os.path.join(tmp, "words.txt")
        wlm_path = os.path.join(tmp, "words.arpa")
        train_char_lm(texts, order=3).write_arpa(lm_path)
        utf8 = [uxxxx_to_utf8(t) for t in texts]
        words = sorted({w for t in utf8 for w in t.split()})
        with open(lex_path, "w") as f:
            f.write("\n".join(words) + "\n")
        train_char_lm(utf8, order=2).write_arpa(wlm_path)
        base = dict(max_batch=128, max_wait_ms=2.0, beam=beam)
        routes = {
            "plain": dict(decoder="beam"),
            "char_lm_lexicon": dict(decoder="beam", lm_path=lm_path,
                                    lexicon_path=lex_path),
            "char_lm_lexicon_word_lm": dict(
                decoder="beam", lm_path=lm_path, lexicon_path=lex_path,
                word_lm_path=wlm_path),
            "host_beam_char_lm_lexicon": dict(
                decoder="beam", beam_impl="host", lm_path=lm_path,
                lexicon_path=lex_path),
            "greedy": dict(),
        }
        programs = {}
        for name, opts in routes.items():
            t0 = time.time()
            svc = OcrService(snap, ServiceConfig(
                warmup=name == "plain", **base, **opts), device=dev)
            try:
                init_s = time.time() - t0
                db.GRAPH_REPLAYS = 0
                lstm_cuda.LAUNCHES = 0
                results = svc.ocr_lines(lines)
                replays, launches = db.GRAPH_REPLAYS, lstm_cuda.LAUNCHES
                device_beam = svc._beam_prog is not None
                _require(len(results) == len(lines) and launches > 0,
                         f"{name}: every line answered, K1 launched")
                _require(all(isinstance(r.text, str) for r in results),
                         f"{name}: texts")
                if name.startswith("host"):
                    _require(all(r.confidence is None for r in results),
                             f"{name}: no score")
                else:
                    _require(all(0 < r.confidence <= 1 for r in results),
                             f"{name}: confidences in (0, 1]")
                row = {"init_s": init_s, "replays": replays,
                       "k1_launches": launches}
                if device_beam:
                    _require(replays > 0, f"{name}: the graph replayed")
                    row.update(beam_same_posteriors(
                        svc, lines, set(words) if svc._lexicon else None))
                    programs[name] = (svc._beam_prog, svc._beam_kw,
                                      svc.alphabet.num_classes)
                t0 = time.time()
                warm = svc.ocr_lines(lines)
                row["lines_per_sec"] = len(lines) / (time.time() - t0)
                row["same_as_first_call"] = sum(
                    a.uxxxx == b.uxxxx for a, b in zip(results, warm))
                if name == "char_lm_lexicon_word_lm":
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        svc.ocr_lines(lines)
                    summary = device_time_summary(prof.events())
                    row["profile"] = summary.splitlines()[0]
                    print(f"service device beam ({name}) profile, one warm "
                          f"ocr_lines call over {len(lines)} lines ({smi}):"
                          "\n" + "".join(summary.splitlines(True)[:12]),
                          flush=True)
            finally:
                svc.close()
            out[name] = row
            print(f"service {name}: {len(lines)} glyph lines, warm "
                  f"{row['lines_per_sec']:.1f} lines/s ({smi}); {row}",
                  flush=True)
    return out, programs


BEAM_RERUNS = 20


def beam_reruns(dev, snap: str, font: dict, smi: str,
                runs: int = BEAM_RERUNS) -> dict:
    """The service-beam phase's plain route (``OcrService`` with
    ``decoder="beam"``, the device beam) on one snapshot, ``runs`` times:
    each run ``beam_same_posteriors`` on 128 new glyph lines (seeded 43 +
    run; run 0 is the phase's own) and 64 seeded lines (seed 5 + run).
    Returns the tallies summed over the runs and the runs with a line
    that was not the same string."""
    from vistaocr_tpu_torch.decode import BeamConfig
    from vistaocr_tpu_torch.serve import OcrService, ServiceConfig

    beam = BeamConfig(lm_alpha=0.5, word_lm_alpha=0.5)
    svc = OcrService(snap, ServiceConfig(
        warmup=True, max_batch=128, max_wait_ms=2.0, beam=beam,
        decoder="beam"), device=dev)
    total: dict = {}
    differed = []
    try:
        for k in range(runs):
            lines = [img for img, _ in glyph_lines(
                font, np.random.default_rng(43 + k), 128, 40, 2048)]
            tally = beam_same_posteriors(svc, lines, None, seed=5 + k)
            print(f"plain device beam rerun {k}: {tally}", flush=True)
            for key, v in tally.items():
                total[key] = total.get(key, 0) + v
            if tally["same"] != 128 + 64:
                differed.append(k)
    finally:
        svc.close()
    print(f"plain device beam, {runs} reruns on one snapshot ({smi}): "
          f"{total}; runs with a line that differed: {differed}", flush=True)
    return {"runs": runs, "tally": total, "differed": differed}


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
# (B, T, H): odd, the W=512 and W=2048 buckets, the W=128 one, and the
# W=1024 one (next to where the f32 frame loop's designs cross)
LSTM_TRAIN_SHAPES = ((5, 7, 40), (128, 128, 512), (32, 512, 512),
                     (512, 32, 512), (64, 256, 512))
# the BPTT's frame loop after the gate GEMM: with bf16 weights one
# persistent launch (None); with f32 weights three designs (LOOP_DESIGNS),
# timed and checked side by side: "fold", one launch a frame; "split", a
# cell launch and a dh launch a frame; "rows" (lstm_bwd_rows), one launch
# a call; the library chooses by B (fold up to B=32)
F32_DESIGNS = ("fold", "split", "rows")
# the f32-weight loops a frame, which F2's route ran before lstm_bwd_tc
F32_PER_FRAME = ("fold", "split")
# the gate GEMM the library runs, by weight type (f32: its FMA form; bf16:
# the wide wgmma design), as torch.profiler names it
GATES_KERNEL = {True: "bptt_gates_gemm<", False: "bptt_gates_gemm_wide<"}
LOOP_KERNELS = {None: ("lstm_bwd_persistent",), "fold": ("bptt_frame",),
                "split": ("bptt_cell", "bptt_dh"),
                "rows": ("lstm_bwd_rows",)}
# the frame-loop kernels launched once a frame (T a call); the others once
# a call
FRAME_KERNELS = ("bptt_frame", "bptt_cell", "bptt_dh")


def _per_call(kernel: str, T: int) -> int:
    """Launches of a frame-loop kernel in one call over T frames."""
    return T if kernel in FRAME_KERNELS else 1


def _loop_key(fd) -> str:
    """A frame loop's name: the f32-weight design's, or bf16's one."""
    return fd or "persistent"
# (B, T, K, L): an odd shape (empty label, infeasible sample), then the
# three train buckets at K=96 with the ladder's label cap min(256, T):
# W=2048 (S=513), W=512 and W=128; the first bucket is the kernels' row
CTC_SHAPES = ((5, 20, 9, 6), (32, 512, 96, 256), (128, 128, 96, 128),
              (512, 32, 96, 32))
CTC_MAIN = (32, 512)


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-12)).item()


def _abs(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


# H100 SXM peaks (NVIDIA's data sheet, dense): HBM bytes/s, and FLOP/s of
# the bf16 tensor cores and of the f32 units outside them
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes: float, flops: float, dtype) -> dict:
    """The least time the card could take: the bytes moved (each input
    read once, each output written once) over the memory rate, or the
    operations over the peak rate of the operand type, the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[_dtname(dtype)] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# the device beam where the service's batches are largest: max_batch 128,
# T = 2048 px / 4 frames, the BeamConfig defaults (W=16, k=8)
BEAM_TIMED = (128, 512)
# the search state one pool candidate carries a frame: two 32-bit hashes,
# the last token, the blank / non-blank masses, the score, parent and token
BEAM_CANDIDATE_BYTES = 32


def beam_posteriors(B: int, T: int, K: int, dev, seed: int):
    """Seeded CTC-shaped log-probs [B, T, K] (blank-heavy, a few symbols
    peaked a line) and a ragged frame mask (row 0 full) on ``dev``."""
    import torch

    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, 2.0, (B, T, K)).astype(np.float32)
    logits[..., 0] += 3.0
    for b in range(B):
        logits[b, :, rng.integers(1, K, 4)] += 2.0
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    frames = rng.integers(T // 4, T + 1, B)
    frames[0] = T
    mask = np.arange(T)[None, :] < frames[:, None]
    return (torch.from_numpy(lp.astype(np.float32)).to(dev),
            torch.from_numpy(mask).to(dev))


def device_beam_timing(dev, card: str, variants: dict, K: int) -> dict:
    """The device beam search at ``BEAM_TIMED`` on seeded posteriors over
    ``K`` classes, per variant (name: (a service's ``BeamProgram``, its
    tables on the card)): the
    CUDA graph twice (bit-equal) and eagerly (the same rows), then ms a
    batch of each (CUDA events), device launches a frame (the slope of
    ``torch.profiler``'s device events between an eager 16- and 48-frame
    search), the bound (log-probs and mask read once, the outputs written
    once, at 3.35 TB/s) and the pool's bytes a frame (``BEAM_CANDIDATE_BYTES``
    a candidate, W * (k+1) candidates a line)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from vistaocr_tpu_torch.decode import BeamConfig

    B, T = BEAM_TIMED
    cfg = BeamConfig()
    W, k = cfg.beam_width, min(cfg.topk, K - 1)
    lp, mask = beam_posteriors(B, T, K, dev, seed=3)
    rows = {}
    for name, (prog, kw) in variants.items():
        first, second = prog(lp, mask, **kw), prog(lp, mask, **kw)
        eager = prog(lp, mask, graph=False, **kw)
        _require(all(torch.equal(a, b) for a, b in zip(first, second)),
                 f"device beam {name}: two graph replays bit-equal")
        _require(all(torch.equal(a, b) for a, b in zip(first, eager)),
                 f"device beam {name}: graph and eager give the same rows")
        graph_ms = _cuda_ms(lambda: prog(lp, mask, **kw), 10)
        eager_ms = _cuda_ms(lambda: prog(lp, mask, graph=False, **kw), 2)
        events = {}
        for frames in (16, 48):
            prog(lp[:, :frames], mask[:, :frames], graph=False, **kw)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                prog(lp[:, :frames], mask[:, :frames], graph=False, **kw)
                torch.cuda.synchronize()
            events[frames] = sum(
                e.device_type == torch.autograd.DeviceType.CUDA
                for e in prof.events())
        per_frame = (events[48] - events[16]) / 32
        io = _nbytes(lp, mask, *first)
        pool = B * W * (k + 1) * BEAM_CANDIDATE_BYTES
        rows[name] = {
            "ms": graph_ms, "eager_ms": eager_ms,
            "launches_per_frame": per_frame,
            "device_events_16_48": [events[16], events[48]],
            "bound_ms": io / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "pool_bytes_per_frame": pool,
            "pool_ms": T * pool / HBM_BYTES_PER_S * 1e3,
            "at": f"B{B}_T{T}_K{K}_W{W}_k{k}"}
        print(f"device beam {name} at B={B}, T={T}, K={K}, W={W}, k={k}: "
              f"graph {graph_ms:.3f} ms a batch, eager {eager_ms:.3f}; "
              f"{per_frame:.1f} device launches a frame; bound "
              f"{rows[name]['bound_ms']:.4f} ms (I/O bytes), pool "
              f"{pool} B a frame = {rows[name]['pool_ms']:.4f} ms over T "
              f"({card})", flush=True)
    return rows


def _kernel_us(fn, names, expect=None) -> dict:
    """{name: (device time per launch in us, launches)} of the kernels
    whose names contain each of ``names``, from the device events of
    ``torch.profiler`` over one call of ``fn`` after a warm-up call. The
    profiler keeps only device events that lie inside its window on the
    host's clock, and the device's timestamps, converted to that clock,
    can fall outside it: it has dropped the first per-frame launches (448
    of 512 counted, 31 of 32), and a lone persistent launch at the end of
    the call, which ends just before the synchronise returns. So each
    window starts with 64 small launches, a synchronise and a 20 ms
    pause, and ends with a synchronise and another 20 ms pause before it
    closes. A window that holds none of a kernel, or fewer
    events of a name than ``expect`` (name: the launches ``fn`` makes)
    says, is taken again, up to three times; the caller checks the
    counts it gets."""
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
            fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        times = {n: [e.time_range.elapsed_us() for e in dev if n in e.name]
                 for n in names}
        got = {n: (sum(v) / len(v), len(v)) for n, v in times.items() if v}
        if len(got) == len(names) and all(
                got[n][1] >= k for n, k in (expect or {}).items()):
            return got
    if len(got) == len(names):
        return got
    _require(False, f"the profiler timed {names}: device events "
                    f"{sorted({e.name[:60] for e in dev})[:20]}")


def dwh_one_product(ys, dxw, reverse: bool, dtype):
    """The library yardstick of the ``lstm_dwh`` kernel: the same function
    as one ``torch.mm`` over the (T-1)*B rows at a one-frame offset
    (forward: ys[0..T-2] with dxw[1..T-1]; reverse: ys[1..T-1] with
    dxw[0..T-2]), operands rounded to ``dtype``, f32 accumulation. On the
    card a bf16 product is one cuBLAS bf16 GEMM with f32 output; otherwise
    the rounded operands are multiplied in f32 (TF32 off)."""
    import torch

    H = ys.shape[2]
    a = (ys[1:] if reverse else ys[:-1]).reshape(-1, H).to(dtype)
    c = (dxw[:-1] if reverse else dxw[1:]).reshape(-1, 4 * H).to(dtype)
    if a.is_cuda and dtype == torch.bfloat16:
        return torch.mm(a.T, c, out_dtype=torch.float32)
    return torch.mm(a.float().T, c.float())


def gates_one_product(xw, ys, wh, reverse: bool, dtype):
    """The library yardstick of the ``bptt_gates_gemm`` kernel: the same
    function, f32 pre [T, B, 4H] = f32(xw) + round(ys[tp]) @ round(wh),
    as one ``torch.mm`` over the (T-1)*B rows that have a predecessor
    (forward: ys[0..T-2] for frames 1..T-1; reverse: ys[1..T-1] for frames
    0..T-2) added to f32(xw); the edge frame keeps f32(xw). On the card a
    bf16 product is one cuBLAS bf16 GEMM with f32 output; otherwise the
    rounded operands are multiplied in f32 (TF32 off)."""
    import torch

    T, B, H = ys.shape
    a = (ys[1:] if reverse else ys[:-1]).reshape(-1, H).to(dtype)
    w = wh.to(dtype)
    if a.is_cuda and dtype == torch.bfloat16:
        prod = torch.mm(a, w, out_dtype=torch.float32)
    else:
        prod = torch.mm(a.float(), w.float())
    pre = xw.to(torch.float32, copy=True)
    (pre[:-1] if reverse else pre[1:]).add_(prod.view(T - 1, B, 4 * H))
    return pre


def lstm_train_kernels(dev, card: str) -> dict:
    """save_cell forward, BPTT frames + dwh (both directions) against the
    plain versions, the BPTT kernels twice on the same inputs (bit-equal);
    times at each flagship shape beside the bounds and library calls. With
    bf16 weights each of the two BPTT kernels is also held to its own plain
    version: ``bptt_gates_gemm``'s gates against ``bptt_gates_ref`` within
    1e-5 of their largest magnitude (the same bf16 products, f32 sums in
    another order), ``lstm_bwd_persistent``'s dxw, from the kernel's own
    gates, against ``bptt_frames_ref`` within 2e-2."""
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
            f32 = dtype == torch.float32
            with torch.no_grad():
                got = L.lstm_forward_cells(dirs, mask, dtype)
                ref = L.lstm_forward_cells(dirs, mask, dtype, plain=True)
                bdirs = [(x, w, ys, cs, dy, r) for (x, w, r), (ys, cs), dy
                         in zip(dirs, ref, dys)]
                whq = [w.to(dtype).contiguous() for _, w, _ in dirs]
                kdirs = [(x, w, ys, cs, dy, r) for (x, _, ys, cs, dy, r), w
                         in zip(bdirs, whq)]
                # f32 weights: every frame-loop design, each held to its
                # plain version; lstm_bptt runs the library's choice by B
                runs = {fd: L.lstm_bptt_frames(kdirs, mask, dtype,
                                               return_gates=True, loop=fd)
                        for fd in (F32_DESIGNS if f32 else (None,))}
                chosen = L.loop_design(dtype, B, H) if f32 else None
                dxw_k, pre_k = runs[chosen]
                pre_r = [L.bptt_gates_ref(x, ys, w, reverse=r, dtype=dtype)
                         for x, w, ys, _, _, r in bdirs]
                loop_r = [L.bptt_frames_ref(p, mask, w, cs, dy, reverse=r,
                                            dtype=dtype)
                          for p, (_, w, _, cs, dy, r) in zip(pre_k, bdirs)]
                ref_b = L.lstm_bptt(bdirs, mask, dtype, plain=True)
                # dwh from the plain dxw, so its check sees the reduction only
                dwh_k = L.lstm_dwh([(d[2], g, d[5]) for d, (g, _)
                                    in zip(bdirs, ref_b)], dtype)
                torch.cuda.synchronize()
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
            e_pre = max(_abs(a, b) for a, b in zip(pre_k, pre_r))
            r_pre = max(_rel(a, b) for a, b in zip(pre_k, pre_r))
            same_pre = all(torch.equal(a, b) for _, pre in runs.values()
                           for a, b in zip(pre, pre_k))
            loop_err = {fd: (max(_abs(a, b) for a, b in zip(g, loop_r)),
                             max(_rel(a, b) for a, b in zip(g, loop_r)))
                        for fd, (g, _) in runs.items()}
            loop_tol = 1e-4 if f32 else 2e-2
            ok = (ok and r_pre <= 1e-5 and same_pre
                  and all(r <= loop_tol for _, r in loop_err.values()))
            parts = f"; bptt_gates_gemm max|d|={e_pre:.3e} (rel {r_pre:.2e}"
            parts += ", tol 1e-5)" + "".join(
                f", {' + '.join(LOOP_KERNELS[fd])} on its gates max|d|="
                f"{e:.3e} (rel {r:.2e}, tol {loop_tol:.0e})"
                for fd, (e, r) in loop_err.items())
            print(f"train kernels vs plain {tag}: save_cell max|d|={e_fwd:.3e}"
                  f"; dxw max|d|={e_dxw:.3e} (rel {r_dxw:.2e}); dwh "
                  f"max|d|={e_dwh:.3e} (rel {r_dwh:.2e}){parts} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            _require(ok, f"LSTM training kernels agree with plain: {tag}")
            ddirs = [(d[2], g, d[5]) for d, (g, _) in zip(bdirs, ref_b)]
            with torch.no_grad():  # the BPTT kernels, run twice
                same = all(torch.equal(a, b) for fd, (g, _) in runs.items()
                           for a, b in zip(g, L.lstm_bptt_frames(
                               kdirs, mask, dtype, loop=fd))) and all(
                    torch.equal(a, b) for a, b in zip(
                        dwh_k, L.lstm_dwh(ddirs, dtype)))
            print(f"BPTT frames and dwh twice on the same inputs {tag}: "
                  f"bit-equal {same}", flush=True)
            _require(same, f"BPTT kernels deterministic: {tag}")
            # ys of both directions, then cs: what the forward designs give
            fwd_refs = [yc[0] for yc in ref] + [yc[1] for yc in ref]
            if (B, T, H) == LSTM_TRAIN_SHAPES[0]:
                if f32:  # both f32 forward designs named, checked only
                    with torch.no_grad():
                        f32_fwd_designs(dirs, mask, fwd_refs, True, T)
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
                    "frames": _cuda_ms(lambda: L.lstm_bptt_frames(
                        kdirs, mask, dtype), 5),
                    **{f"frames_{fd}": _cuda_ms(
                        lambda fd=fd: L.lstm_bptt_frames(
                            kdirs, mask, dtype, loop=fd), 5)
                       for fd in runs if fd is not None},
                    "dwh": _cuda_ms(lambda: L.lstm_dwh(ddirs, dtype), 20),
                    "dwh_plain": _cuda_ms(lambda: [L.lstm_dwh_ref(
                        y, g, reverse=r, dtype=dtype) for y, g, r in ddirs], 1),
                    "dwh_lib": _cuda_ms(lambda: [dwh_one_product(
                        y, g, r, dtype) for y, g, r in ddirs], 20),
                }
                t["gates_plain"] = _cuda_ms(lambda: [L.bptt_gates_ref(
                    x, ys, w, reverse=r, dtype=dtype)
                    for x, w, ys, _, _, r in bdirs], 2)
                t["gates_lib"] = _cuda_ms(lambda: [gates_one_product(
                    x, ys, w, r, dtype) for x, w, ys, _, _, r in kdirs], 20)
                t["loop_plain"] = _cuda_ms(lambda: [L.bptt_frames_ref(
                    p, mask, w, cs, dy, reverse=r, dtype=dtype)
                    for p, (_, w, _, cs, dy, r) in zip(pre_r, bdirs)], 1)
                if f32:
                    # the per-frame dh product alone, both directions
                    dg = [g[T // 2] for g, _ in ref_b]  # one frame's dgates
                    t["dh_lib"] = _cuda_ms(lambda: [torch.mm(x, w.T) for x, w
                                                    in zip(dg, whq)], 50)
                gk = GATES_KERNEL[f32]
                per = {fd: _kernel_us(
                    lambda fd=fd: L.lstm_bptt_frames(kdirs, mask, dtype,
                                                     loop=fd),
                    (gk, *(k + "<" for k in LOOP_KERNELS[fd])),
                    {gk: 1, **{k + "<": _per_call(k, T)
                               for k in LOOP_KERNELS[fd]}})
                    for fd in runs}
            # bounds: each input read once, each output written once; the
            # products this run needs (no h_prev at the edge frame, no dh
            # after the last one): (T-1)*B rows each
            R = (T - 1) * B
            prod = 2 * B * H * 4 * H  # one frame's product, one direction
            fwd_bytes = _nbytes(mask, *(x for x, _, _ in dirs), *whq,
                                *(a for yc in ref for a in yc))
            frame_in = _nbytes(mask, *(x for x, *_ in kdirs), *whq,
                               *(a for d in kdirs for a in d[2:5]))
            dxw_bytes = _nbytes(*(g for g, _ in ref_b))
            dwh_bytes = _nbytes(*(w for _, w in ref_b))
            dwh_in = _nbytes(*(a for y, g, _ in ddirs for a in (y, g)))
            gemm_flops = 2 * 2 * R * H * 4 * H  # both directions
            bwd = {"max_abs_err": e_dxw, "ms": t["bwd"],
                   "plain_ms": t["bwd_plain"], "library_ms": None,
                   **_bound(frame_in + dxw_bytes + dwh_bytes, 3 * gemm_flops,
                            dtype),
                   "frames_ms": t["frames"]}
            rows[(B, T, dtype)] = {"lstm_bwd": bwd}
            pre_bytes = _nbytes(*pre_k)
            gemm_in = _nbytes(*(x for x, *_ in kdirs), *(d[2] for d in kdirs),
                              *whq)
            loop_in = _nbytes(mask, *whq, *(a for d in kdirs for a in d[3:5]))
            cell_in = _nbytes(mask, *(a for d in kdirs for a in d[3:5]))
            dh_in = _nbytes(mask, *whq, *(d[4] for d in kdirs))
            gp = per[chosen][gk]
            gemm = {"max_abs_err": e_pre, "ms": gp[0] / 1e3,
                    "plain_ms": t["gates_plain"],
                    "library_ms": t["gates_lib"],
                    **_bound(gemm_in + pre_bytes, gemm_flops, dtype),
                    "launches_per_call": gp[1]}
            rows[(B, T, dtype)]["bptt_gates_gemm"] = gemm
            # each frame-loop kernel: its device time a call (per launch
            # times launches), bound, launches; the split design's cell
            # backward is elementwise (about 40 operations a unit and row)
            bounds = {
                "lstm_bwd_persistent": (pre_bytes + loop_in + dxw_bytes,
                                        gemm_flops),
                "bptt_frame": (pre_bytes + loop_in + dxw_bytes, gemm_flops),
                "lstm_bwd_rows": (pre_bytes + loop_in + dxw_bytes,
                                  gemm_flops),
                "bptt_cell": (pre_bytes + cell_in + dxw_bytes,
                              2 * 40 * T * B * H),
                "bptt_dh": (dxw_bytes + dh_in, gemm_flops)}
            designs = {}
            for fd in runs:
                e_loop = loop_err[fd][0]
                dsg = {"frames_ms": t.get(f"frames_{fd}", t["frames"]),
                       "chosen": fd == chosen, "per_frame_us": 0.0}
                for k in LOOP_KERNELS[fd]:
                    us, n = per[fd][k + "<"]
                    n_want = _per_call(k, T)
                    _require(per[fd][gk][1] == 1
                             and n == n_want,
                             f"one gate GEMM and {n_want} {k} launch(es) a "
                             f"call: {tag}, {per[fd]}")
                    row = {"max_abs_err": e_loop, "ms": us * n / 1e3,
                           "plain_ms": t["loop_plain"], "library_ms": None,
                           **_bound(*bounds[k], dtype),
                           "launches_per_call": n}
                    row["per_frame_us"] = row["ms"] / T * 1e3
                    row["bound_per_frame_us"] = row["bound_ms"] / T * 1e3
                    if k == "bptt_dh":  # the product alone, one frame
                        row["library_ms"] = t["dh_lib"] * T
                    if k == "lstm_bwd_persistent":  # its rows a cluster
                        plan = L.persistent_plan(B, H, stream=dtype)
                        row.update(rows_a_cluster=plan["rows"],
                                   clusters=plan["clusters"],
                                   co_resident_clusters=plan["resident"],
                                   waves=plan["waves"])
                    rows[(B, T, dtype)][k] = row
                    dsg["per_frame_us"] += row["per_frame_us"]
                designs[_loop_key(fd)] = dsg
            loop_names = LOOP_KERNELS[chosen]
            bwd.update({
                "launches_per_call": {"bptt_gates_gemm": 1,
                                      **{k: _per_call(k, T)
                                         for k in loop_names}},
                "per_frame_us": designs[_loop_key(chosen)]["per_frame_us"],
                "per_frame_bound_us": _bound(*bounds["bptt_frame"], dtype)[
                    "bound_ms"] / T * 1e3,
                "bptt_gates_gemm_us": gemm["ms"] * 1e3,
                "bptt_gates_gemm_bound_us": gemm["bound_ms"] * 1e3,
                "bptt_gates_gemm_library_us": t["gates_lib"] * 1e3})
            if f32:
                bwd["frame_loop_designs"] = designs
                bwd["dh_product_library_us"] = t["dh_lib"] * 1e3
            detail = (
                f"per launch (torch.profiler): {gk[:-1]} "
                f"{gemm['ms'] * 1e3:.2f} us (bound "
                f"{gemm['bound_ms'] * 1e3:.2f}; plain "
                f"{t['gates_plain']:.3f} ms; torch.mm + xw "
                f"{t['gates_lib'] * 1e3:.2f} us)")
            for fd in runs:
                ks = LOOP_KERNELS[fd]
                dsg = designs[_loop_key(fd)]
                detail += (
                    f"; {_loop_key(fd)}{' (chosen)' if dsg['chosen'] else ''}"
                    f" {dsg['per_frame_us']:.3f} us a frame = " + " + ".join(
                        f"{k} {per[fd][k + '<'][0]:.2f} us x "
                        f"{per[fd][k + '<'][1]} (bound "
                        f"{rows[(B, T, dtype)][k]['bound_per_frame_us']:.3f})"
                        for k in ks) + f", frames {dsg['frames_ms']:.3f} ms")
            if not f32:
                pr = rows[(B, T, dtype)]["lstm_bwd_persistent"]
                detail += (f"; lstm_bwd_persistent at {pr['rows_a_cluster']}"
                           f" rows a cluster: {pr['clusters']} clusters, "
                           f"{pr['co_resident_clusters']} co-resident, "
                           f"{pr['waves']} wave(s)")
            detail += f"; plain frame loop {t['loop_plain']:.3f} ms"
            if f32:
                detail += (f"; torch.mm per frame, the dh product alone, "
                           f"{t['dh_lib'] * 1e3:.2f} us")
            print(f"time {tag}, both directions: save_cell fwd {t['fwd']:.3f}"
                  f" ms (plain {t['fwd_plain']:.3f}); BPTT frames+dwh "
                  f"{t['bwd']:.3f} ms (plain {t['bwd_plain']:.3f}; frames "
                  f"alone {t['frames']:.3f}); {detail}; dwh "
                  f"{t['dwh']:.4f} ms (plain {t['dwh_plain']:.3f}, torch.mm "
                  f"{t['dwh_lib']:.4f}) ({card})", flush=True)
            fwd_row = {"max_abs_err": e_fwd, "ms": t["fwd"],
                       "plain_ms": t["fwd_plain"], "library_ms": None,
                       **_bound(fwd_bytes, 2 * T * prod, dtype)}
            with torch.no_grad():
                fwd_row.update(fwd_kernel_extras(
                    lambda: [a for yc in L.lstm_forward_cells(dirs, mask, dtype)
                             for a in yc], B, T, dtype, t["fwd"],
                    fwd_row["bound_ms"]))
                if f32:
                    fwd_row["designs"] = f32_fwd_designs(
                        dirs, mask, fwd_refs, True, T, fwd_row["bound_ms"])
            print(f"save_cell {tag}: {fwd_row['per_frame_us']:.2f} us a frame "
                  f"(bound {fwd_row['bound_per_frame_us']:.3f}; "
                  f"{fwd_row['launches_per_call']} launch(es) of "
                  f"{fwd_row['kernel_name']} a call; two runs bit-equal) "
                  f"({card})", flush=True)
            if f32:
                print(f"f32 designs {tag}, save_cell, both directions: " +
                      "; ".join(f"{n} {d['ms']:.3f} ms = {d['per_frame_us']:.2f}"
                                f" us a frame, {d['launches_per_call']} "
                                f"launch(es), max|d|={d['max_abs_err']:.3e}"
                                for n, d in fwd_row["designs"].items()) +
                      f" (the library runs {fwd_row['kernel_name']}; bound "
                      f"{fwd_row['bound_ms']:.3f} ms) ({card})", flush=True)
            rows[(B, T, dtype)].update({
                "lstm_fwd_save_cell": fwd_row,
                "lstm_dwh": {
                    "max_abs_err": e_dwh, "ms": t["dwh"],
                    "plain_ms": t["dwh_plain"], "library_ms": t["dwh_lib"],
                    **_bound(dwh_in + dwh_bytes, 2 * 2 * R * H * 4 * H,
                             dtype)},
            })
    return rows


# where the library's f32 forward rule (vo_lstm_fwd_design) changes
# design, (B, H), with T = 16384 / B (a 2**21-pixel train batch): H=512
# with wh resident (the grid up to B=320, lstm_step at 384, lstm_fwd_rows
# from 448 to the W=128 bucket's 512), H=576 (one row group: lstm_step),
# H=256 (4 units a CTA: the grid up to B=128) and H=1000 (wh streamed from
# L2: the grid at B=32; lstm_fwd_rows does not fit there)
F32_RULE_SHAPES = ((256, 512), (320, 512), (384, 512), (448, 512),
                   (512, 512), (512, 576), (128, 256), (256, 256),
                   (32, 1000), (128, 1000))
# lstm_fwd_rows' largest H for two directions (a CTA's f32 slice of wh in
# shared memory); above it the library refuses the design
F32_ROWS_MAX_H = 640


def f32_forward_rule_times(dev, card: str) -> list:
    """The f32 forward designs (save_cell form, both directions) timed
    side by side at the rule's edge shapes, each held to lstm_step's
    outputs (1e-4), with the design the library runs there and the
    fastest; lstm_fwd_rows is refused by the library above
    F32_ROWS_MAX_H (H=1000), recorded so; any other refusal, or one of
    the design the library runs, fails."""
    import torch
    from vistaocr_tpu_torch.ops import lstm_cuda as L

    out = []
    for B, H in F32_RULE_SHAPES:
        T = 16384 // B
        (fwd, bwd), mask = _recurrence_case(B, T, H, torch.float32, dev,
                                            seed=B + H)
        dirs = [(fwd[0], fwd[1], False), (bwd[0], bwd[1], True)]
        outs, ms, refused = {}, {}, []
        with torch.no_grad():
            for d, name in F32_FWD_KERNELS.items():
                try:
                    ys, cs = L.lstm_fwd(dirs, mask, torch.float32,
                                        save_cell=True, design=d)
                except RuntimeError as e:
                    _require(d == "rows" and H > F32_ROWS_MAX_H,
                             f"{name} refused at B={B} H={H}: {e}")
                    refused.append(name)
                    continue
                outs[name] = ys + cs
            err = max(_abs(a, b) for n, o in outs.items()
                      for a, b in zip(o, outs["lstm_step"]))
            for d, name in F32_FWD_KERNELS.items():
                if name in outs:
                    ms[name] = _cuda_ms(lambda d=d: L.lstm_fwd(
                        dirs, mask, torch.float32, save_cell=True,
                        design=d), 5)
        _require(err <= 1e-4, f"f32 designs agree at B={B} H={H}: {err}")
        row = {"B": B, "T": T, "H": H, "max_abs_diff": err, **{
            f"{n}_ms": v for n, v in ms.items()},
            "refused": refused, "fastest": min(ms, key=ms.get),
            "library_runs": fwd_kernel_name(B, H, torch.float32)}
        _require(row["library_runs"] not in refused,
                 f"the library runs {row['library_runs']}, refused at "
                 f"B={B} H={H}")
        print(f"f32 forward rule B={B} T={T} H={H}, save_cell, both "
              f"directions: " + ", ".join(f"{n} {v:.3f} ms"
                                          for n, v in ms.items()) +
              (f" ({', '.join(refused)} does not fit)" if refused else "") +
              f"; the library runs {row['library_runs']} ({card})",
              flush=True)
        out.append(row)
    return out


# bf16 weights above H=512 (type codes 1 and 2): the forward on
# lstm_fwd_tc and the frame loop on lstm_bwd_tc (the tensor cores, wh in
# bf16), the gate GEMM and dwh on the wide wgmma kernels; (B, T, H)
# checked in both codes, the last one also timed (code 1, the model's)
# beside the earlier designs (the forward's lstm_fwd_grid, the FMA gate
# GEMM, the f32-weight frame loop, dwh's 128 x 128 tiles) and the f32
# route (code 0) at the same shape
F2_SHAPES = ((32, 512, 520), (32, 512, 1000))
F2_TIMED = F2_SHAPES[-1]
F2_COUNTERS = ("FWD_TC_LAUNCHES", "FWD_GRID_LAUNCHES", "STEP_LAUNCHES",
               "GATES_GEMM_LAUNCHES",
               "GATES_WIDE_LAUNCHES", "FRAME_LAUNCHES", "CELL_LAUNCHES",
               "DH_LAUNCHES", "DWH_LAUNCHES", "BWD_PERSISTENT_LAUNCHES",
               "BWD_TC_LAUNCHES")
# the designs F2's route ran before, timed beside the library's: the
# forward's lstm_fwd_grid (wh widened to f32), the FMA gate GEMM, the
# frame loop on the f32-weight kernels ("f32": bptt_frame a frame up to
# B=32, bptt_cell and bptt_dh beyond, wh widened; f2_parent_loop), and
# dwh's 128 x 128 tiles (with the L2 promotion that the maps now take by H)
F2_PARENT = {"fwd": "grid", "gemm": "fma", "loop": "f32", "dwh": "tiles"}
# where lstm_fwd_tc and lstm_step, and lstm_bwd_tc and the parent's frame
# loop, are timed side by side at H=1000 (both directions, T = 16384 / B),
# for the library's rules between them
F2_FWD_RULE_B = (32, 128, 256, 512)
F2_RULE_ROWS = 16384
# the flagship's bf16 gate GEMM (the 128 x 128 wgmma tiles that
# bptt_gates_gemm_wide replaced) and dwh at B=32, T=512, H=512 as an H100
# (700 W) ran them before (ms; PERF.md's kernel table): printed beside
# this run's times there, and nowhere else
FLAGSHIP_EARLIER_MS = {"bptt_gates_gemm": 0.399, "lstm_dwh": 0.1093}


# dwh and one torch.mm of the same bf16 operands sum the same products
# over (T-1)*B = 16352 rows in f32 in two orders, and at F2_SHAPES those
# part by more than the 1e-5 that holds at the card tests' small shapes
# (this phase prints each one's distance to the exact sum: cuBLAS's is
# itself 1e-5 to 3e-5 of the largest magnitude on an NVIDIA H100 80GB
# HBM3 at 700 W). So each dwh design is held to the exact sum (f64
# products of the bf16 values): within 1e-5 of it, or no further from it
# than DWH_LIBRARY_FACTOR times the library call; the designs' gap to each
# other and to torch.mm is reported.
DWH_LIBRARY_FACTOR = 1.0


def _dwh_accurate(err: float, library_err: float) -> bool:
    return err <= max(1e-5, DWH_LIBRARY_FACTOR * library_err)


def dwh_exact(ys, dxw, reverse: bool, dtype):
    """dwh's function in float64: the products of the operands rounded to
    ``dtype`` are exact there, and the sum's error is negligible."""
    H = ys.shape[2]
    a = (ys[1:] if reverse else ys[:-1]).reshape(-1, H).to(dtype).double()
    c = (dxw[:-1] if reverse else dxw[1:]).reshape(-1, 4 * H).to(
        dtype).double()
    return a.T @ c


# lstm_dwh_fma (f32 streams and weights: the parity route's dwh) at the
# train buckets' row counts (H=512; R = (T-1)*B within 3% of 16352) and in
# f32 at H=1000, both directions, seeded normal operands; the first is the
# kernels line's shape
F32_DWH_SHAPES = ((32, 512, 512), (128, 128, 512), (512, 32, 512),
                  (64, 256, 512), (32, 512, 1000))
# the parent's f32 dwh (lstm_dwh_f32: one CTA a 128 x 128 tile over all
# rows) as an NVIDIA H100 80GB HBM3 at 700 W ran it at B=32, T=512 (ms,
# by H; PERF.md's kernel table): printed on the human line beside this
# run's times, never in the kernels line; profile_lstm_bwd_gemms.py
# --root times it in turns
F32_DWH_EARLIER_MS = {512: 1.692, 1000: 6.3377}


def f32_dwh_kernel(dev, card: str) -> dict:
    """``lstm_dwh_fma`` at ``F32_DWH_SHAPES``: against ``lstm_dwh_ref``
    (atol 2e-4, rtol 1e-3) and the exact f64 sum, no farther from it than
    one ``torch.mm`` of the same operands; two runs bit-equal; one launch
    a call (its counter); timed in turns with that ``torch.mm`` (CUDA
    events), beside its bound (f32 FMAs at 67 TFLOP/s) and plain
    version. Returns a row a shape."""
    import torch
    from vistaocr_tpu_torch.ops import lstm_cuda as L

    f32 = torch.float32
    rows = {}
    for B, T, H in F32_DWH_SHAPES:
        rng = np.random.default_rng(B + T + H)
        ddirs = [(_normal(rng, (T, B, H), 0.5, dev, f32),
                  _normal(rng, (T, B, 4 * H), 0.1, dev, f32), r)
                 for r in (False, True)]
        before = L.DWH_LAUNCHES
        with torch.no_grad():
            runs = [L.lstm_dwh(ddirs, f32) for _ in range(2)]
            torch.cuda.synchronize()
            launches = L.DWH_LAUNCHES - before
            ref = [L.lstm_dwh_ref(y, g, reverse=r) for y, g, r in ddirs]
            mm = [dwh_one_product(y, g, r, f32) for y, g, r in ddirs]
            exact = [dwh_exact(y, g, r, f32) for y, g, r in ddirs]
            t = _turns_ms({
                "mm": lambda: [dwh_one_product(y, g, r, f32)
                               for y, g, r in ddirs],
                "dwh": lambda: L.lstm_dwh(ddirs, f32)}, 10)
            plain_ms = _cuda_ms(lambda: [L.lstm_dwh_ref(y, g, reverse=r)
                                         for y, g, r in ddirs], 1)
        err = {"max_abs_err": max(_abs(a, b) for a, b in zip(runs[0], ref)),
               "exact_rel": max(_rel(a, b) for a, b in zip(runs[0], exact)),
               "mm_exact_rel": max(_rel(a, b) for a, b in zip(mm, exact)),
               "mm_rel": max(_rel(a, b) for a, b in zip(runs[0], mm))}
        close = all(torch.allclose(a, b, atol=2e-4, rtol=1e-3)
                    for a, b in zip(runs[0], ref))
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        R = (T - 1) * B
        row = {**err, "ms": t["dwh"], "plain_ms": plain_ms,
               "library_ms": t["mm"],
               **_bound(_nbytes(*(a for y, g, _ in ddirs for a in (y, g)))
                        + 2 * H * 4 * H * 4, 2 * 2 * R * H * 4 * H, f32),
               "launches_per_call": launches // 2, "bit_equal_twice": same,
               "ms_source": "CUDA events, in turns with torch.mm"}
        earlier = F32_DWH_EARLIER_MS.get(H) if B == 32 else None
        ok = (close and same and launches == 2
              and err["exact_rel"] <= err["mm_exact_rel"])
        print(f"f32 dwh lstm_dwh_fma B={B} T={T} H={H}, both directions: "
              f"{t['dwh']:.4f} ms, torch.mm {t['mm']:.4f} ms (in turns), "
              f"bound {row['bound_ms']:.4f}, plain {plain_ms:.3f}"
              + (f", earlier design {earlier} (PERF.md)" if earlier
                 else "")
              + "; " + "; ".join(f"{k} {v:.3e}" for k, v in err.items())
              + f"; within lstm_dwh_ref's bounds {close}; bit-equal twice "
              f"{same}; launches {launches} in 2 calls "
              f"{'ok' if ok else 'FAIL'} ({card})", flush=True)
        _require(ok, f"lstm_dwh_fma at B={B} T={T} H={H}: {row}, "
                     f"ref bounds {close}")
        rows[(B, T, H)] = row
    return rows


def _normal(rng, shape, scale, dev, dtype):
    import torch

    return torch.from_numpy(rng.normal(0, scale, shape).astype(
        np.float32)).to(dev, dtype)


def _counter_deltas(mod, names, before) -> dict:
    return {n: getattr(mod, n) - b for n, b in zip(names, before)}


def f2_parent_loop(B: int) -> str:
    """The frame loop F2's route ran at batch size B before lstm_bwd_tc
    (``F2_PARENT["loop"]``): the f32-weight loop a frame that the library
    then picked by B (``LOOP_DESIGNS`` "fold" up to B=32, "split"
    beyond; lstm_bwd_rows does not fit at H=1000)."""
    return "fold" if B <= 32 else "split"


def f2_train_kernels(dev, card: str) -> dict:
    """bf16 weights at ``F2_SHAPES``, type codes 1 and 2, both directions,
    ragged mask: the save_cell and inference forwards on ``lstm_fwd_tc``
    (3e-2 of the plain version), the wide gate GEMM (1e-5 relative of
    ``bptt_gates_ref`` and of the parent FMA design), the frame loop
    (``lstm_bwd_tc``) on the kernel's gates and the whole BPTT (2e-2
    relative; the parent's f32-weight loop held to the same bound on the
    same gates), the wide dwh from the plain dxw (2e-2
    relative of the plain version; as ``_dwh_accurate`` says against the
    exact sum, on the BPTT's operands and normal ones, its gaps to one
    ``torch.mm`` of the same bf16 operands and to the parent 128 x 128
    design shown), each run twice
    (bit-equal), with the launches of each call counted (the library's
    route: lstm_fwd_tc for the forward, lstm_bwd_tc for the frame loop,
    one launch a call each, the wide kernels for the gate GEMM and dwh).
    At ``F2_TIMED`` with bf16
    streams each kernel is timed beside its bound (operations at the bf16
    peak: the products are of bf16 values), its plain version, the library
    call where there is one, the parent design and the f32 route (f32
    weights and streams) at the same shape. Returns kernel rows."""
    import torch
    from vistaocr_tpu_torch.ops import _build, lstm_cuda as L

    lib = _build.load()
    bf16, f32 = torch.bfloat16, torch.float32
    checked, rows = [], {}
    for (B, T, H) in F2_SHAPES:
        _require(L.forward_design(bf16, B, H) == "tc"
                 and L.loop_design(bf16, B, H) == "tc",
                 f"F2's forward and frame loop at B={B} H={H} are "
                 f"lstm_fwd_tc and lstm_bwd_tc")
        for stream in (bf16, f32):
            tag = (f"B={B} T={T} H={H}, bf16 weights, {_dtname(stream)} "
                   f"streams")
            (fwd, bwd), mask = _recurrence_case(B, T, H, stream, dev,
                                                seed=B + T + H)
            dirs = [(fwd[0], fwd[1].to(bf16), False),
                    (bwd[0], bwd[1].to(bf16), True)]
            rng = np.random.default_rng(H)
            dys = [torch.from_numpy(rng.normal(0, 1, (T, B, H)).astype(
                np.float32)).to(dev, stream) for _ in range(2)]
            before = [getattr(L, n) for n in F2_COUNTERS]
            with torch.no_grad():
                cells = [L.lstm_forward_cells(dirs, mask, bf16)
                         for _ in range(2)]
                inf = [L.blstm_recurrence(dirs[0][0], dirs[1][0], mask,
                                          dirs[0][1], dirs[1][1])
                       for _ in range(2)]
                ref = L.lstm_forward_cells(dirs, mask, bf16, plain=True)
                bdirs = [(x, w, ys, cs, dy, r) for (x, w, r), (ys, cs), dy
                         in zip(dirs, ref, dys)]
                runs = [L.lstm_bptt_frames(bdirs, mask, bf16,
                                           return_gates=True)
                        for _ in range(2)]
                ref_b = L.lstm_bptt(bdirs, mask, bf16, plain=True)
                ddirs = [(d[2], g, d[5]) for d, (g, _) in zip(bdirs, ref_b)]
                dwhs = [L.lstm_dwh(ddirs, bf16) for _ in range(2)]
                torch.cuda.synchronize()
                got = _counter_deltas(L, F2_COUNTERS, before)
                (dxw_k, pre_k), (dxw_2, pre_2) = runs
                pre_r = [L.bptt_gates_ref(x, ys, w, reverse=r, dtype=bf16)
                         for x, w, ys, _, _, r in bdirs]
                loop_r = [L.bptt_frames_ref(p, mask, w, cs, dy, reverse=r,
                                            dtype=bf16)
                          for p, (_, w, _, cs, dy, r) in zip(pre_k, bdirs)]
                dxw_p = L.lstm_bptt_frames(bdirs, mask, bf16,
                                           loop=f2_parent_loop(B))
                # the parent designs on the same inputs, and dwh's library
                # call (one cuBLAS bf16 GEMM, f32 out) on the same operands:
                # the BPTT's, and seeded normal ones of the same shapes
                pre_p = L.lstm_bptt_frames(bdirs, mask, bf16,
                                           return_gates=True,
                                           gemm=F2_PARENT["gemm"])[1]
                dwh_p = L.lstm_dwh(ddirs, bf16, design=F2_PARENT["dwh"])
                dwh_mm = [dwh_one_product(y, g, r, bf16)
                          for y, g, r in ddirs]
                ndirs = [(_normal(rng, (T, B, H), 0.5, dev, stream),
                          _normal(rng, (T, B, 4 * H), 0.1, dev, stream), r)
                         for r in (False, True)]
                dwh_n = L.lstm_dwh(ndirs, bf16)
                dwh_n_mm = [dwh_one_product(y, g, r, bf16)
                            for y, g, r in ndirs]
                exact = [dwh_exact(y, g, r, bf16) for y, g, r in ddirs]
                exact_n = [dwh_exact(y, g, r, bf16) for y, g, r in ndirs]
            want = {"FWD_TC_LAUNCHES": 4, "FWD_GRID_LAUNCHES": 0,
                    "STEP_LAUNCHES": 0, "GATES_GEMM_LAUNCHES": 2,
                    "GATES_WIDE_LAUNCHES": 2, "FRAME_LAUNCHES": 0,
                    "CELL_LAUNCHES": 0, "DH_LAUNCHES": 0, "DWH_LAUNCHES": 2,
                    "BWD_PERSISTENT_LAUNCHES": 0, "BWD_TC_LAUNCHES": 2}
            wide_dwh = L.DWH_DESIGNS[lib.vo_lstm_dwh_design(1, H)] == "wide"
            err = {
                "save_cell": max(max(_abs(y, ry), _abs(c, rc)) for (y, c), (
                    ry, rc) in zip(cells[0], ref)),
                "inference": max(_abs(y, ry) for y, (ry, _) in zip(
                    inf[0], ref)),
                "gates_rel": max(_rel(a, b) for a, b in zip(pre_k, pre_r)),
                "gates_parent_rel": max(_rel(a, b) for a, b in zip(pre_k,
                                                                   pre_p)),
                "dwh_mm_rel": max(_rel(a, b) for a, b in zip(dwh_n,
                                                             dwh_n_mm)),
                "dwh_mm_rel_bptt": max(_rel(a, b) for a, b in zip(dwhs[0],
                                                                  dwh_mm)),
                "dwh_exact_rel": max(_rel(a, b) for a, b in zip(dwh_n,
                                                                exact_n)),
                "dwh_mm_exact_rel": max(_rel(a, b) for a, b in zip(
                    dwh_n_mm, exact_n)),
                "dwh_exact_rel_bptt": max(_rel(a, b) for a, b in zip(
                    dwhs[0], exact)),
                "dwh_mm_exact_rel_bptt": max(_rel(a, b) for a, b in zip(
                    dwh_mm, exact)),
                "dwh_parent_rel": max(_rel(a, b) for a, b in zip(dwhs[0],
                                                                 dwh_p)),
                "loop_rel": max(_rel(a, b) for a, b in zip(dxw_k, loop_r)),
                "parent_loop_rel": max(_rel(a, b) for a, b in zip(dxw_p,
                                                                  loop_r)),
                "dxw_rel": max(_rel(a, b) for a, (b, _) in zip(dxw_k, ref_b)),
                "dxw_abs": max(_abs(a, b) for a, (b, _) in zip(dxw_k, ref_b)),
                "dwh_rel": max(_rel(a, b) for a, (_, b) in zip(dwhs[0],
                                                               ref_b)),
                "dwh_abs": max(_abs(a, b) for a, (_, b) in zip(dwhs[0],
                                                               ref_b)),
                "gates_abs": max(_abs(a, b) for a, b in zip(pre_k, pre_r)),
                "loop_abs": max(_abs(a, b) for a, b in zip(dxw_k, loop_r))}
            same = (all(torch.equal(a, b) for (ya, ca), (yb, cb) in zip(
                        *cells) for a, b in ((ya, yb), (ca, cb)))
                    and all(torch.equal(a, b) for a, b in zip(*inf))
                    and all(torch.equal(a, b) for a, b in zip(
                        dxw_k + pre_k, dxw_2 + pre_2))
                    and all(torch.equal(a, b) for a, b in zip(*dwhs)))
            ok = (err["save_cell"] <= 3e-2 and err["inference"] <= 3e-2
                  and err["gates_rel"] <= 1e-5 and err["loop_rel"] <= 2e-2
                  and err["parent_loop_rel"] <= 2e-2
                  and err["gates_parent_rel"] <= 1e-5
                  and all(_dwh_accurate(err[f"dwh_exact_rel{o}"],
                                        err[f"dwh_mm_exact_rel{o}"])
                          for o in ("", "_bptt"))
                  and err["dxw_rel"] <= 2e-2 and err["dwh_rel"] <= 2e-2
                  and same and got == want and wide_dwh)
            print(f"F2 kernels vs plain {tag}: " + "; ".join(
                f"{k} {v:.3e}" for k, v in err.items()) + f"; bit-equal "
                f"twice {same}; launches {got} (lstm_fwd_tc, "
                f"bptt_gates_gemm_wide, lstm_bwd_tc, "
                f"lstm_dwh_tc {'128 x 256' if wide_dwh else '128 x 128'}) "
                f"{'ok' if ok else 'FAIL'}", flush=True)
            _require(ok, f"F2 kernels agree with plain, bit-equal, launches "
                         f"{got} == {want}, dwh's wide tiles {wide_dwh}: "
                         f"{tag}")
            checked.append({"B": B, "T": T, "H": H,
                            "streams": _dtname(stream), **err,
                            "bit_equal_twice": same, "launches": got})
            if (B, T, H) != F2_TIMED or stream != bf16:
                continue
            rows = f2_timings(dev, card, dirs, bdirs, ddirs, mask, pre_r,
                              err, ref)
    for row in rows.values():
        row["checked"] = checked
    return rows


def _turns_ms(fns: dict, reps: int) -> dict:
    """Two calls timed in turns, a b b a (CUDA events over ``reps`` calls
    each time), so that a drift of the card between them falls on both;
    returns each one's mean time a call (ms)."""
    (a, fa), (b, fb) = fns.items()
    t = [_cuda_ms(f, reps) for f in (fa, fb, fb, fa)]
    return {a: (t[0] + t[3]) / 2, b: (t[1] + t[2]) / 2}


def dwh_rates(H: int, R: int, ms: dict) -> dict:
    """dwh's achieved rate for each design (ms: design -> time of a
    two-direction call): TFLOP/s in all and an SM that the grid keeps
    busy, the grid's CTAs and its waves on the card (one CTA an SM)."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flops = 2 * 2 * R * H * 4 * H
    out = {}
    for design, t in ms.items():
        tn = 256 if design == "wide" else 128
        ctas = 2 * -(-4 * H // tn) * -(-H // 128)
        tflops = flops / (t * 1e-3) / 1e12
        out[design] = {"ms": t, "tflops": tflops, "ctas": ctas,
                       "waves": ctas / sms,
                       "tflops_per_busy_sm": tflops / min(ctas, sms)}
    return out


GATES_WIDE = GATES_KERNEL[False]


def f2_timings(dev, card, dirs, bdirs, ddirs, mask, pre_r, err,
               ref) -> dict:
    """Each F2 kernel timed at F2_TIMED (bf16 streams and weights) beside
    its bound, plain version, library call and the f32 route; the forward
    (lstm_fwd_tc, CUDA events and the profiler's device time a launch),
    the wide gate GEMM and lstm_bwd_tc (the profiler's device time a
    launch inside ``lstm_bptt_frames``), dwh and the BPTT frames (the gate
    GEMM and the frame loop; CUDA events) in turns with the earlier
    designs (``F2_PARENT``), the parent's frame-loop kernels (bptt_frame,
    bptt_cell and bptt_dh) a frame; dwh's achieved rate an SM in both
    designs; lstm_fwd_tc beside lstm_step and lstm_bwd_tc beside the
    parent's frame loop at ``F2_FWD_RULE_B`` (``f2_forward_rule``,
    ``f2_loop_rule``)."""
    import torch
    from vistaocr_tpu_torch.ops import lstm_cuda as L

    bf16, f32 = torch.bfloat16, torch.float32
    T, B, G = dirs[0][0].shape
    H = G // 4
    d32 = [(x.float(), w.float(), r) for x, w, r in dirs]
    b32 = [(x.float(), w.float(), ys.float(), cs.float(), dy.float(), r)
           for x, w, ys, cs, dy, r in bdirs]
    dd32 = [(y.float(), g.float(), r) for y, g, r in ddirs]
    with torch.no_grad():
        # the forward in turns with its earlier design (lstm_fwd_grid)
        t = _turns_ms({
            "fwd_grid": lambda: L.lstm_fwd(dirs, mask, bf16, save_cell=True,
                                           design=F2_PARENT["fwd"]),
            "fwd": lambda: L.lstm_forward_cells(dirs, mask, bf16)}, 5)
        t.update({
            "fwd_step": _cuda_ms(lambda: L.lstm_fwd(
                dirs, mask, bf16, save_cell=True, design="step"), 5),
            "fwd_f32": _cuda_ms(lambda: L.lstm_forward_cells(d32, mask, f32),
                                5),
            "fwd_plain": _cuda_ms(lambda: L.lstm_forward_cells(
                dirs, mask, bf16, plain=True), 1),
            "frames_f32": _cuda_ms(lambda: L.lstm_bptt_frames(b32, mask, f32),
                                   5),
            "dwh_f32": _cuda_ms(lambda: L.lstm_dwh(dd32, f32), 5),
            "dwh_plain": _cuda_ms(lambda: [L.lstm_dwh_ref(
                y, g, reverse=r, dtype=bf16) for y, g, r in ddirs], 1),
            "dwh_lib": _cuda_ms(lambda: [dwh_one_product(
                y, g, r, bf16) for y, g, r in ddirs], 20),
            "gates_plain": _cuda_ms(lambda: [L.bptt_gates_ref(
                x, ys, w, reverse=r, dtype=bf16)
                for x, w, ys, _, _, r in bdirs], 2),
            "gates_lib": _cuda_ms(lambda: [gates_one_product(
                x, ys, w, r, bf16) for x, w, ys, _, _, r in bdirs], 20),
            "loop_plain": _cuda_ms(lambda: [L.bptt_frames_ref(
                p, mask, w, cs, dy, reverse=r, dtype=bf16)
                for p, (_, w, _, cs, dy, r) in zip(pre_r, bdirs)], 1),
        })
        # the gate GEMM's device time a launch, parent design and the
        # library's in turns (parent, library, library, parent)
        g_us = {"gates_parent": [], "gates": []}
        for key in ("gates_parent", "gates", "gates", "gates_parent"):
            gemm = F2_PARENT["gemm"] if key == "gates_parent" else None
            kname = GATES_KERNEL[gemm == "fma"]
            g_us[key].append(_kernel_us(
                lambda gemm=gemm: L.lstm_bptt_frames(bdirs, mask, bf16,
                                                     gemm=gemm),
                (kname,), {kname: 1})[kname][0])
        t.update({k: sum(v) / len(v) / 1e3 for k, v in g_us.items()})
        t.update(_turns_ms({
            "dwh_parent": lambda: L.lstm_dwh(ddirs, bf16,
                                             design=F2_PARENT["dwh"]),
            "dwh": lambda: L.lstm_dwh(ddirs, bf16)}, 20))
        # the frames (gate GEMM and frame loop) in turns with the parent's
        # frame loop
        t.update(_turns_ms({
            "frames_parent": lambda: L.lstm_bptt_frames(
                bdirs, mask, bf16, loop=f2_parent_loop(B)),
            "frames": lambda: L.lstm_bptt_frames(bdirs, mask, bf16)}, 3))
        dg = [g[T // 2].to(bf16).float() for _, g, _ in ddirs]
        wq = [w.float() for _, w, _ in dirs]
        t["dh_lib"] = _cuda_ms(lambda: [torch.mm(x, w.T) for x, w in
                                        zip(dg, wq)], 50)
        per = {fd: _kernel_us(
            lambda fd=fd: L.lstm_bptt_frames(bdirs, mask, bf16, loop=fd),
            (GATES_WIDE, *(k + "<" for k in LOOP_KERNELS[fd])),
            {GATES_WIDE: 1, **{k + "<": T for k in LOOP_KERNELS[fd]}})
            for fd in F32_PER_FRAME}
        tc_us = _kernel_us(lambda: L.lstm_bptt_frames(bdirs, mask, bf16),
                           ("lstm_bwd_tc<",), {"lstm_bwd_tc<": 1})[
                               "lstm_bwd_tc<"]
        fwd_us = _kernel_us(lambda: L.lstm_fwd(
            dirs, mask, bf16, save_cell=True, design="tc"),
            ("lstm_fwd_tc<",), {"lstm_fwd_tc<": 1})["lstm_fwd_tc<"]
    rule = f2_forward_rule(dev, card, H)
    loop_rule = f2_loop_rule(dev, card, H)
    R = (T - 1) * B
    flops = 2 * 2 * R * H * 4 * H  # one product over every frame, 2 dirs
    whq = [w for _, w, _ in dirs]
    fwd_bytes = _nbytes(mask, *(x for x, _, _ in dirs), *whq,
                        *(a for yc in ref for a in yc))
    pre_bytes = 2 * T * B * G * 4
    dxw_bytes = _nbytes(*(g for _, g, _ in ddirs))
    gemm_in = _nbytes(*(x for x, *_ in bdirs), *(d[2] for d in bdirs), *whq)
    loop_in = _nbytes(mask, *whq, *(a for d in bdirs for a in d[3:5]))
    cell_in = _nbytes(mask, *(a for d in bdirs for a in d[3:5]))
    dh_in = _nbytes(mask, *whq, *(d[4] for d in bdirs))
    dwh_in = _nbytes(*(a for y, g, _ in ddirs for a in (y, g)))
    dwh_out = 2 * H * G * 4
    fwd_bound = _bound(fwd_bytes, 2 * 2 * T * B * H * G, bf16)
    _require(fwd_us[1] == 1 and tc_us[1] == 1,
             f"lstm_fwd_tc and lstm_bwd_tc: one launch a call, {fwd_us}, "
             f"{tc_us}")
    rows = {"lstm_fwd_tc": {
        "max_abs_err": err["save_cell"], "ms": t["fwd"],
        "plain_ms": t["fwd_plain"], "library_ms": None, **fwd_bound,
        "launches_per_call": fwd_us[1], "kernel_us_per_launch": fwd_us[0],
        "per_frame_us": t["fwd"] / T * 1e3,
        "inference_max_abs_err": err["inference"],
        "parent_ms": t["fwd_grid"],
        "parent": "lstm_fwd_grid, wh widened to f32 (in turns)",
        "lstm_step_ms": t["fwd_step"], "f32_route_ms": t["fwd_f32"],
        "rule_times": rule}}
    rows["bptt_gates_gemm_wide"] = {
        "max_abs_err": err["gates_abs"], "ms": t["gates"],
        "plain_ms": t["gates_plain"], "library_ms": t["gates_lib"],
        **_bound(gemm_in + pre_bytes, flops, bf16), "launches_per_call": 1,
        "ms_source": "profiler, device time a launch in lstm_bptt_frames",
        "parent_ms": t["gates_parent"],
        "parent": "bptt_gates_gemm, f32 FMA form (wh widened)"}
    bounds = {"bptt_frame": (pre_bytes + loop_in + dxw_bytes, flops),
              "bptt_cell": (pre_bytes + cell_in + dxw_bytes,
                            2 * 40 * T * B * H),
              "bptt_dh": (dxw_bytes + dh_in, flops)}
    # the parent's frame-loop kernels (the f32-weight designs), a frame
    parent_kernels = {}
    for fd in F32_PER_FRAME:
        for k in LOOP_KERNELS[fd]:
            us, n = per[fd][k + "<"]
            parent_kernels[k] = {
                "ms": us * n / 1e3, "library_ms": t["dh_lib"] * T
                if k == "bptt_dh" else None, **_bound(*bounds[k], bf16),
                "launches_per_call": n, "per_frame_us": us}
    rows["lstm_bwd_tc"] = {
        "max_abs_err": err["loop_abs"], "ms": tc_us[0] / 1e3,
        "plain_ms": t["loop_plain"], "library_ms": t["dh_lib"] * T,
        "library_call": "the dh product alone, torch.mm a frame, x T",
        **_bound(*bounds["bptt_frame"], bf16), "launches_per_call": tc_us[1],
        "ms_source": "profiler, device time a launch in lstm_bptt_frames",
        "per_frame_us": tc_us[0] / T, "parent_loop_rel": err[
            "parent_loop_rel"], "parent_kernels": parent_kernels,
        "parent": f"{f2_parent_loop(B)} (the {F2_PARENT['loop']}-weight "
                  f"frame loop, wh widened)", "rule_times": loop_rule}
    rates = dwh_rates(H, R, {"tiles": t["dwh_parent"], "wide": t["dwh"]})
    rows["lstm_dwh"] = {
        "max_abs_err": err["dwh_abs"], "ms": t["dwh"],
        "plain_ms": t["dwh_plain"], "library_ms": t["dwh_lib"],
        **_bound(dwh_in + dwh_out, flops, bf16),
        "ms_source": "CUDA events, one lstm_dwh call",
        "f32_route_ms": t["dwh_f32"], "parent_ms": t["dwh_parent"],
        "parent": "lstm_dwh_tc in 128 x 128 tiles", "rates": rates}
    for k in ("bptt_gates_gemm_wide", "lstm_bwd_tc"):
        rows[k]["frames_ms"] = t["frames"]
        rows[k]["parent_frames_ms"] = t["frames_parent"]
        rows[k]["f32_route_frames_ms"] = t["frames_f32"]
    print(f"F2 times B={B} T={T} H={H}, bf16 weights and streams, both "
          f"directions: save_cell lstm_fwd_tc {t['fwd']:.3f} ms "
          f"({t['fwd'] / T * 1e3:.2f} us a frame; profiler "
          f"{fwd_us[0] / 1e3:.3f} ms a launch), in turns with lstm_fwd_grid "
          f"{t['fwd_grid']:.3f} ms, lstm_step {t['fwd_step']:.3f} ms, f32 "
          f"route {t['fwd_f32']:.3f} ms, bound {fwd_bound['bound_ms']:.3f} "
          f"ms, plain {t['fwd_plain']:.3f} ms; BPTT frames "
          f"{t['frames']:.3f} ms (in turns with the parent's frame loop "
          f"{t['frames_parent']:.3f}; f32 route {t['frames_f32']:.3f}); "
          f"lstm_bwd_tc {tc_us[0] / 1e3:.3f} ms a launch, "
          f"{tc_us[0] / T:.2f} us a frame (profiler; bound "
          f"{rows['lstm_bwd_tc']['bound_ms']:.3f} ms; parent bptt_frame "
          f"{per['fold']['bptt_frame<'][0]:.2f} us x T, bptt_cell "
          f"{per['split']['bptt_cell<'][0]:.2f} + bptt_dh "
          f"{per['split']['bptt_dh<'][0]:.2f} us x T; dh alone torch.mm x T "
          f"{t['dh_lib'] * T:.3f} ms; plain loop "
          f"{t['loop_plain']:.3f} ms); gate GEMM bptt_gates_gemm_wide "
          f"{t['gates']:.4f} ms a launch (profiler; parent FMA form "
          f"{t['gates_parent']:.4f}; events: torch.mm + xw "
          f"{t['gates_lib']:.4f}, plain {t['gates_plain']:.3f}; bound "
          f"{rows['bptt_gates_gemm_wide']['bound_ms']:.4f}); dwh lstm_dwh_tc "
          f"128 x 256 {t['dwh']:.4f} ms (events; 128 x 128 tiles "
          f"{t['dwh_parent']:.4f}, torch.mm {t['dwh_lib']:.4f}, bound "
          f"{rows['lstm_dwh']['bound_ms']:.4f}, f32 route "
          f"{t['dwh_f32']:.4f}); dwh an SM: " + "; ".join(
              f"{d} {r['tflops_per_busy_sm']:.2f} TFLOP/s over "
              f"{r['ctas']} CTAs ({r['waves']:.2f} waves)"
              for d, r in rates.items()) + f" ({card})", flush=True)
    return rows


def f2_forward_rule(dev, card: str, H: int) -> list:
    """lstm_fwd_tc and lstm_step (save_cell, bf16 streams and weights, both
    directions, every row valid) timed in turns at H and each B of
    ``F2_FWD_RULE_B`` with T = 16384 / B, each held to the other (3e-2),
    beside the design the library runs there."""
    import torch
    from vistaocr_tpu_torch.ops import lstm_cuda as L

    bf16 = torch.bfloat16
    out = []
    for B in F2_FWD_RULE_B:
        T = F2_RULE_ROWS // B
        rng = np.random.default_rng(B + H)
        dirs = [(_normal(rng, (T, B, 4 * H), 1.0, dev, bf16),
                 _normal(rng, (H, 4 * H), H ** -0.5, dev, bf16), r)
                for r in (False, True)]
        mask = torch.ones(T, 1, B, device=dev)
        with torch.no_grad():
            (ya, ca), (yb, cb) = (L.lstm_fwd(dirs, mask, bf16,
                                             save_cell=True, design=d)
                                  for d in ("tc", "step"))
            err = max(_abs(a, b) for a, b in zip(ya + ca, yb + cb))
            ms = _turns_ms({d: lambda d=d: L.lstm_fwd(
                dirs, mask, bf16, save_cell=True, design=d)
                for d in ("step", "tc")}, 3)
        _require(err <= 3e-2, f"lstm_fwd_tc and lstm_step agree at B={B} "
                              f"H={H}: {err}")
        row = {"B": B, "T": T, "H": H, "max_abs_diff": err,
               "lstm_fwd_tc_ms": ms["tc"], "lstm_step_ms": ms["step"],
               "library_runs": L.forward_design(bf16, B, H)}
        print(f"F2 forward rule B={B} T={T} H={H}, save_cell, both "
              f"directions: lstm_fwd_tc {ms['tc']:.3f} ms, lstm_step "
              f"{ms['step']:.3f} ms (in turns), max|d| {err:.2e}; the "
              f"library runs {row['library_runs']} ({card})", flush=True)
        out.append(row)
    return out


def f2_loop_rule(dev, card: str, H: int) -> list:
    """The BPTT frames (the wide gate GEMM and the frame loop; bf16 streams
    and weights, both directions, every row valid) with lstm_bwd_tc and
    with the parent's frame loop (``f2_parent_loop``) timed in turns at H
    and each B of ``F2_FWD_RULE_B`` with T = 16384 / B, each held to the
    other (2e-2 relative), beside the design the library runs there,
    which must be the one that won."""
    import torch
    from vistaocr_tpu_torch.ops import lstm_cuda as L

    bf16 = torch.bfloat16
    out = []
    for B in F2_FWD_RULE_B:
        T = F2_RULE_ROWS // B
        rng = np.random.default_rng(B + H + 1)
        bdirs = [(_normal(rng, (T, B, 4 * H), 1.0, dev, bf16),
                  _normal(rng, (H, 4 * H), H ** -0.5, dev, bf16),
                  _normal(rng, (T, B, H), 0.5, dev, bf16),
                  _normal(rng, (T, B, H), 1.0, dev, bf16),
                  _normal(rng, (T, B, H), 1.0, dev, bf16), r)
                 for r in (False, True)]
        mask = torch.ones(T, 1, B, device=dev)
        parent = f2_parent_loop(B)
        with torch.no_grad():
            got = {d: L.lstm_bptt_frames(bdirs, mask, bf16, loop=d)
                   for d in ("tc", parent)}
            err = max(_rel(a, b) for a, b in zip(got["tc"], got[parent]))
            ms = _turns_ms({d: lambda d=d: L.lstm_bptt_frames(
                bdirs, mask, bf16, loop=d) for d in (parent, "tc")}, 3)
        runs = L.loop_design(bf16, B, H)
        won = "tc" if ms["tc"] <= ms[parent] else parent
        _require(err <= 2e-2 and runs == won,
                 f"lstm_bwd_tc and {parent} agree at B={B} H={H} ({err}) "
                 f"and the library runs the faster one ({runs}, {ms})")
        row = {"B": B, "T": T, "H": H, "max_rel_diff": err,
               "frames_tc_ms": ms["tc"], "parent": parent,
               "frames_parent_ms": ms[parent], "library_runs": runs}
        print(f"F2 frame loop rule B={B} T={T} H={H}, both directions, "
              f"gate GEMM + loop: lstm_bwd_tc {ms['tc']:.3f} ms, {parent} "
              f"{ms[parent]:.3f} ms (in turns), rel diff {err:.2e}; the "
              f"library runs {runs} ({card})", flush=True)
        out.append(row)
    return out


# the flagship's bf16 BPTT shape (the W=2048 bucket, H=512), where the
# library keeps dwh's 128 x 128 tiles; the gate GEMM and both dwh designs
# checked and timed there
F2_FLAGSHIP = (32, 512, 512)


def flagship_designs(dev, card: str) -> dict:
    """At ``F2_FLAGSHIP``, bf16, both directions: the gate GEMM
    (``bptt_gates_gemm_wide``, through ``lstm_bptt_frames``) against
    ``bptt_gates_ref`` (1e-5 relative) and its device time a launch (the
    profiler); dwh's two designs against the exact sum as
    ``_dwh_accurate`` says (their gaps to each other and to one
    ``torch.mm`` shown), timed in turns (tiles, wide, wide, tiles), with
    dwh's rate an SM; every call's two runs bit-equal. The human-readable
    line prints each time beside the earlier one there
    (``FLAGSHIP_EARLIER_MS``)."""
    import torch
    from vistaocr_tpu_torch.ops import lstm_cuda as L

    bf16 = torch.bfloat16
    B, T, H = F2_FLAGSHIP
    rng = np.random.default_rng(T + H)
    bdirs = [(_normal(rng, (T, B, 4 * H), 1.0, dev, bf16),
              _normal(rng, (H, 4 * H), H ** -0.5, dev, bf16),
              _normal(rng, (T, B, H), 0.5, dev, bf16),
              _normal(rng, (T, B, H), 1.0, dev, bf16),
              _normal(rng, (T, B, H), 1.0, dev, bf16), r)
             for r in (False, True)]
    mask = torch.ones(T, 1, B, device=dev)
    ddirs = [(ys, _normal(rng, (T, B, 4 * H), 0.1, dev, bf16), r)
             for _, _, ys, _, _, r in bdirs]
    with torch.no_grad():
        pre = [L.lstm_bptt_frames(bdirs, mask, bf16, return_gates=True)[1]
               for _ in range(2)]
        dwh = {d: [L.lstm_dwh(ddirs, bf16, design=d) for _ in range(2)]
               for d in L.DWH_DESIGNS}
        pre_r = [L.bptt_gates_ref(x, ys, w, reverse=r, dtype=bf16)
                 for x, w, ys, *_, r in bdirs]
        dwh_mm = [dwh_one_product(y, g, r, bf16) for y, g, r in ddirs]
        exact = [dwh_exact(y, g, r, bf16) for y, g, r in ddirs]
        # the events first: timed after a profiler window, this 0.1 ms
        # kernel's back-to-back calls read slower
        t = _turns_ms({
            "dwh_tiles": lambda: L.lstm_dwh(ddirs, bf16, design="tiles"),
            "dwh_wide": lambda: L.lstm_dwh(ddirs, bf16, design="wide")}, 20)
        t["gates"] = _kernel_us(
            lambda: L.lstm_bptt_frames(bdirs, mask, bf16), (GATES_WIDE,),
            {GATES_WIDE: 1})[GATES_WIDE][0] / 1e3
    err = {"gates_rel": max(_rel(a, b) for a, b in zip(pre[0], pre_r))}
    err.update({f"dwh_{d}_exact_rel": max(_rel(a, b) for a, b in zip(
        v[0], exact)) for d, v in dwh.items()})
    err["dwh_mm_exact_rel"] = max(_rel(a, b) for a, b in zip(dwh_mm, exact))
    shown = {f"dwh_{d}_mm_rel": max(_rel(a, b) for a, b in zip(v[0], dwh_mm))
             for d, v in dwh.items()}
    shown["dwh_designs_rel"] = max(_rel(a, b) for a, b in zip(
        dwh["wide"][0], dwh["tiles"][0]))
    same = all(torch.equal(a, b) for runs in (pre, *dwh.values())
               for a, b in zip(*runs))
    ok = same and err["gates_rel"] <= 1e-5 and all(
        _dwh_accurate(err[f"dwh_{d}_exact_rel"], err["dwh_mm_exact_rel"])
        for d in dwh)
    err.update(shown)
    rates = dwh_rates(H, (T - 1) * B, {"tiles": t["dwh_tiles"],
                                       "wide": t["dwh_wide"]})
    print(f"flagship B={B} T={T} H={H} bf16, both directions: gate GEMM "
          f"bptt_gates_gemm_wide {t['gates']:.4f} ms a launch (profiler; "
          f"earlier 128 x 128 tiles "
          f"{FLAGSHIP_EARLIER_MS['bptt_gates_gemm']}, PERF.md); dwh 128 x "
          f"128 tiles {t['dwh_tiles']:.4f} ms (events; earlier "
          f"{FLAGSHIP_EARLIER_MS['lstm_dwh']}, PERF.md), 128 x 256 "
          f"{t['dwh_wide']:.4f} ms; dwh an SM: " + "; ".join(
              f"{d} {r['tflops_per_busy_sm']:.2f} TFLOP/s over {r['ctas']} "
              f"CTAs" for d, r in rates.items()) + "; " + "; ".join(
              f"{k} {v:.2e}" for k, v in err.items()) + f"; bit-equal twice "
          f"{same} {'ok' if ok else 'FAIL'} ({card})", flush=True)
    _require(ok, f"flagship gate GEMM and dwh designs agree: {err}, {same}")
    return {**t, **err, "bit_equal_twice": same, "dwh_rates": rates}


# F2's main path: a bf16 flagship at lstm_hidden 520 and 1000, one train
# step (forward + backward through entry points) and one inference forward
# at the W=2048 (B=32) and W=512 (B=128) buckets
F2_PATH = tuple((H, B, W) for H in (520, 1000)
                for B, W in ((32, 2048), (128, 512)))


def f2_path_phase(dev, font: dict, card: str) -> dict:
    """F2's main path with the LSTM counters set to 0 before the first step
    and read after the last: what each call's route launches (lstm_fwd_tc;
    the wide gate GEMM, the frame loop the library's rule picks by B
    (lstm_bwd_tc where it won, else the f32-weight loop) and dwh), and
    never a persistent kernel nor an f32-weight forward; lstm_bwd_tc
    launched at least once."""
    import torch
    from vistaocr_tpu_torch import train as TR
    from vistaocr_tpu_torch.models import CnnLstmOcr, ModelConfig, init_parameters
    from vistaocr_tpu_torch.ops import _build, lstm_cuda

    lib = _build.load()
    cases = []
    for H, B, W in F2_PATH:
        alphabet, batch = _glyph_batch(font, H + B, B, W, W // 2,
                                       min(256, W // 4), dev)
        model = CnnLstmOcr(ModelConfig(num_classes=alphabet.num_classes,
                                       compute_dtype="bfloat16",
                                       lstm_hidden=H, dropout=0.0))
        init_parameters(model, torch.Generator().manual_seed(H))
        cases.append((H, B, W, model.to(dev), batch))
    names = F2_COUNTERS + ("LAUNCHES", "BWD_LAUNCHES")
    for name in names:
        setattr(lstm_cuda, name, 0)
    want = dict.fromkeys(names, 0)
    t0 = time.time()
    for H, B, W, model, batch in cases:
        before = (lstm_cuda.LAUNCHES, lstm_cuda.BWD_LAUNCHES)
        loss, grads = TR.loss_and_grads(model, *batch,
                                        torch.ones(B, device=dev))
        with torch.inference_mode():
            lp, fm = model(batch[0], batch[1])
        torch.cuda.synchronize()
        _require(np.isfinite(loss.item()) and all(
            torch.isfinite(g).all().item() for g in grads.values())
            and torch.isfinite(lp[fm]).all().item(),
            f"F2 path H={H} B={B}: finite loss, gradients and log-probs")
        fwd = lstm_cuda.LAUNCHES - before[0]
        bwd = lstm_cuda.BWD_LAUNCHES - before[1]
        T = W // 4
        want["LAUNCHES"] += fwd
        want["BWD_LAUNCHES"] += bwd
        design = lstm_cuda.forward_design(torch.bfloat16, B, H)
        if design == "tc":
            want["FWD_TC_LAUNCHES"] += fwd
        elif design == "grid":
            want["FWD_GRID_LAUNCHES"] += fwd
        else:
            want["STEP_LAUNCHES"] += fwd * T
        for name in ("GATES_GEMM_LAUNCHES", "GATES_WIDE_LAUNCHES",
                     "DWH_LAUNCHES"):
            want[name] += bwd
        loop = lstm_cuda.loop_design(torch.bfloat16, B, H)
        if loop == "tc":
            want["BWD_TC_LAUNCHES"] += bwd
        elif loop == "fold":
            want["FRAME_LAUNCHES"] += bwd * T
        else:
            want["CELL_LAUNCHES"] += bwd * T
            want["DH_LAUNCHES"] += bwd * T
    counts = {name: getattr(lstm_cuda, name) for name in names}
    print(f"F2 path (bf16 flagship at H=520 and 1000, a train step and an "
          f"inference forward at B=32 W=2048 and B=128 W=512) in "
          f"{time.time() - t0:.2f} s: launches {counts} ({card})", flush=True)
    wide = all(lstm_cuda.DWH_DESIGNS[lib.vo_lstm_dwh_design(1, H)] == "wide"
               for H, _, _ in F2_PATH)
    idle = ("BWD_PERSISTENT_LAUNCHES", "FWD_GRID_LAUNCHES", "STEP_LAUNCHES")
    _require(counts == want and all(counts[k] == 0 for k in idle)
             and all(counts[k] > 0 for k in (
                 "FWD_TC_LAUNCHES", "GATES_WIDE_LAUNCHES", "BWD_TC_LAUNCHES",
                 "DWH_LAUNCHES")) and wide,
             f"F2 path launches {counts}, want {want}; dwh's wide tiles "
             f"{wide}")
    return counts


# one F2 train step timed with the library's route and with the frame
# loop's earlier design (the f32-weight loop, F2_PARENT["loop"]):
# lstm_hidden 1000 at the W=2048 bucket
F2_STEP = (1000, 32, 2048)  # (H, B, W)


def f2_step_timing(dev, font: dict, card: str) -> dict:
    """One bf16 train step (``loss_and_grads``) at ``F2_STEP`` on the
    library's route, and on the same route with the frame loop's earlier
    design (``F2_PARENT["loop"]``, the f32-weight loop) named in the BPTT
    wrapper (only here, to time it), in turns (parent, library, library,
    parent), 3 steps each time; both losses and gradients finite, the
    losses within 1e-6 relative (both routes run the same forward) and the
    gradients within 2e-2 relative (the two frame loops sum the dh
    products in other orders, which moves dxw by bf16 roundings)."""
    import functools

    import torch
    from vistaocr_tpu_torch import train as TR
    from vistaocr_tpu_torch.models import CnnLstmOcr, ModelConfig, init_parameters
    from vistaocr_tpu_torch.ops import lstm_cuda as L

    H, B, W = F2_STEP
    alphabet, batch = _glyph_batch(font, H + B + 1, B, W, W // 2,
                                   min(256, W // 4), dev)
    model = CnnLstmOcr(ModelConfig(num_classes=alphabet.num_classes,
                                   compute_dtype="bfloat16", lstm_hidden=H,
                                   dropout=0.0))
    init_parameters(model, torch.Generator().manual_seed(H))
    model.to(dev)
    weights = torch.ones(B, device=dev)
    frames = L.lstm_bptt_frames

    def step():
        return TR.loss_and_grads(model, *batch, weights)

    def parent():
        L.lstm_bptt_frames = functools.partial(frames,
                                               loop=f2_parent_loop(B))
        try:
            return step()
        finally:
            L.lstm_bptt_frames = frames

    (loss_a, g_a), (loss_b, g_b) = step(), parent()
    torch.cuda.synchronize()
    gap = max(_rel(g_a[k], g_b[k]) for k in g_a)
    loss_gap = abs(loss_a.item() - loss_b.item()) / abs(loss_a.item())
    ok = (np.isfinite(loss_a.item()) and np.isfinite(loss_b.item())
          and all(torch.isfinite(g).all().item() for g in g_a.values())
          and loss_gap <= 1e-6 and gap <= 2e-2)
    t = _turns_ms({"parent": parent, "library": step}, 3)
    print(f"F2 train step H={H} B={B} W={W} bf16: library route "
          f"{t['library']:.3f} ms, parent frame loop ({f2_parent_loop(B)}) "
          f"{t['parent']:.3f} ms (saved {t['parent'] - t['library']:.3f}); "
          f"losses {loss_a.item():.6f} / {loss_b.item():.6f} (relative "
          f"gap {loss_gap:.2e}), gradients within {gap:.2e} relative "
          f"{'ok' if ok else 'FAIL'} ({card})",
          flush=True)
    _require(ok, f"F2 step on both routes: losses {loss_a.item()}, "
                 f"{loss_b.item()}, gradient gap {gap}")
    return {"H": H, "B": B, "W": W, "library_ms": t["library"],
            "parent_ms": t["parent"], "parent": f"frame loop "
            f"{f2_parent_loop(B)} (the f32-weight kernels)",
            "loss_rel_gap": loss_gap, "gradient_rel_gap": gap}


def _ctc_inputs(B, T, K, L, dev):
    """Seeded log-probs [B, T, K] with lengths (a repeat; where B > 2 an
    empty label and an infeasible sample), and the kernels' inputs."""
    import torch
    from vistaocr_tpu_torch.ops import ctc_cuda as C

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
    labels_t = torch.from_numpy(labels).to(dev)
    lp_ext, skip, active, islast = C._prepare(lp, il_t, labels_t, 0)
    svalid, terminal = C._state_masks(ll_t, lp_ext.shape[2])
    skip2 = torch.cat([skip[:, 2:], torch.zeros_like(skip[:, :2])],
                      1).contiguous()
    return (lp, il_t, labels_t, ll_t), (lp_ext, skip, active, islast, svalid,
                                        terminal, skip2)


def ctc_train_kernels(dev, card: str) -> dict:
    """CTC alpha/beta kernels against the plain versions (f32) at every
    shape of ``CTC_SHAPES``: alpha within 2e-4 on reachable states with
    the same reachable set, d lp_ext within 2e-5. At the three train
    buckets: both kernels run twice (bit-equal), one launch of each a call
    (``torch.profiler``), each timed beside its plain version, and the
    whole ``ctc_loss_kernel`` forward and backward (the assembly: gather,
    transposes, terminal reduction, class fold) beside ``F.ctc_loss``
    forward+backward. {(B, T): {"ctc_alpha": row, "ctc_beta": row,
    "ctc_loss": row}}."""
    import torch
    import torch.nn.functional as F
    from vistaocr_tpu_torch.ops import ctc_cuda as C

    rows = {}
    for (B, T, K, L) in CTC_SHAPES:
        (lp, il_t, labels_t, ll_t), (lp_ext, skip, active, islast, svalid,
                                     terminal, skip2) = _ctc_inputs(
            B, T, K, L, dev)
        alphas = C.ctc_alpha(lp_ext, active, skip, svalid)
        ref_a = C.ctc_alpha_ref(lp_ext, active, skip, svalid)
        logp = C._loss_from_alphas(ref_a, il_t, ll_t).contiguous()
        beta_in = (lp_ext, active, islast, skip2, svalid, terminal, ref_a,
                   logp)
        dlp = C.ctc_beta(*beta_in)
        ref_d = C.ctc_beta_ref(*beta_in)
        torch.cuda.synchronize()
        reach = (ref_a > -1e29) & (svalid[None] > 0)
        same_reach = bool(torch.equal(alphas > -1e29, ref_a > -1e29))
        e_a = _abs(alphas[reach], ref_a[reach])
        e_b = _abs(dlp, ref_d)
        S = lp_ext.shape[2]
        tag = f"B={B} T={T} K={K} L={L} S={S}"
        ok = same_reach and e_a <= 2e-4 and e_b <= 2e-5
        print(f"CTC kernels vs plain {tag}: alpha max|d|={e_a:.3e} on "
              f"{int(reach.sum())} reachable states, beta d lp_ext "
              f"max|d|={e_b:.3e} {'ok' if ok else 'FAIL'}", flush=True)
        _require(ok, f"CTC kernels agree with plain: {tag}")
        if (B, T, K, L) == CTC_SHAPES[0]:
            continue
        same = (torch.equal(C.ctc_alpha(lp_ext, active, skip, svalid),
                            alphas)
                and torch.equal(C.ctc_beta(*beta_in), dlp))
        _require(same, f"CTC kernels bit-equal across reruns: {tag}")
        prof = _kernel_us(lambda: (C.ctc_alpha(lp_ext, active, skip, svalid),
                                   C.ctc_beta(*beta_in)),
                          ("ctc_alpha_kernel", "ctc_beta_kernel"))
        launches = {n: c for n, (_, c) in prof.items()}
        _require(launches == {"ctc_alpha_kernel": 1, "ctc_beta_kernel": 1},
                 f"one launch of each CTC kernel a call: {launches}")
        t = {
            "a": _cuda_ms(lambda: C.ctc_alpha(lp_ext, active, skip, svalid),
                          20),
            "a_plain": _cuda_ms(lambda: C.ctc_alpha_ref(lp_ext, active, skip,
                                                        svalid), 2),
            "b": _cuda_ms(lambda: C.ctc_beta(*beta_in), 20),
            "b_plain": _cuda_ms(lambda: C.ctc_beta_ref(*beta_in), 2),
        }
        # the whole loss with its assembly, and the library call computing
        # the same function: the CTC loss and its gradient (infeasible
        # samples zeroed), on the same log-probs
        lp_tbk = lp.transpose(0, 1).detach().contiguous()

        def ours():
            x = lp.clone().requires_grad_(True)
            C.ctc_loss_kernel(x, il_t, labels_t, ll_t).sum().backward()

        def library():
            x = lp_tbk.clone().requires_grad_(True)
            F.ctc_loss(x, labels_t.long(), il_t.long(), ll_t.long(), blank=0,
                       reduction="sum", zero_infinity=True).backward()

        t["loss"] = _cuda_ms(ours, 10)
        t["lib"] = _cuda_ms(library, 10)
        ops = 10 * T * B * S  # per state and frame: 3 exp, 1 log, 6 add/max
        row_a = {"max_abs_err": e_a, "ms": t["a"], "plain_ms": t["a_plain"],
                 "library_ms": t["lib"],
                 "us_a_frame": t["a"] * 1e3 / T,
                 "profiler_us": prof["ctc_alpha_kernel"][0],
                 **_bound(_nbytes(lp_ext, active, skip, svalid, alphas), ops,
                          torch.float32)}
        row_b = {"max_abs_err": e_b, "ms": t["b"], "plain_ms": t["b_plain"],
                 "library_ms": t["lib"],
                 "us_a_frame": t["b"] * 1e3 / T,
                 "profiler_us": prof["ctc_beta_kernel"][0],
                 **_bound(_nbytes(*beta_in, dlp), ops, torch.float32)}
        rows[(B, T)] = {"ctc_alpha": row_a, "ctc_beta": row_b, "ctc_loss": {
            "ms": t["loss"], "library_ms": t["lib"],
            "assembly_ms": t["loss"] - t["a"] - t["b"]}}
        print(f"time {tag}: alpha {t['a']:.4f} ms = "
              f"{row_a['us_a_frame']:.3f} us a frame (plain "
              f"{t['a_plain']:.3f}, bound {row_a['bound_ms']:.4f}), beta "
              f"{t['b']:.4f} ms = {row_b['us_a_frame']:.3f} us a frame "
              f"(plain {t['b_plain']:.3f}, bound {row_b['bound_ms']:.4f}); "
              f"ctc_loss_kernel forward+backward {t['loss']:.4f} ms "
              f"(assembly {t['loss'] - t['a'] - t['b']:.4f}), F.ctc_loss "
              f"forward+backward {t['lib']:.4f} ms; bit-equal reruns, one "
              f"launch each ({card})", flush=True)
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
                        n_val: int, widths=(40, 2048)) -> None:
    from vistaocr_tpu_torch.data import ShardWriter, write_manifest
    from vistaocr_tpu_torch.text import utf8_to_uxxxx

    rng = np.random.default_rng(seed)
    splits = {}
    for split, n in (("train", n_train), ("val", n_val)):
        w = ShardWriter(path, split, 32)
        for i, (img, text) in enumerate(glyph_lines(font, rng, n, *widths)):
            w.add(f"{split}-{i:06d}", img, utf8_to_uxxxx(text))
        splits[split] = w.close()
    write_manifest(path, 32, splits)


TRAIN_COUNTERS = (("lstm_cuda", "SAVE_CELL_LAUNCHES"),
                  ("lstm_cuda", "BWD_LAUNCHES"),
                  ("lstm_cuda", "GATES_GEMM_LAUNCHES"),
                  ("lstm_cuda", "GATES_WIDE_LAUNCHES"),
                  ("lstm_cuda", "BWD_PERSISTENT_LAUNCHES"),
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
    return counts, lps


def _glyph_batch(font: dict, seed: int, B: int, W: int, wmin: int,
                 L: int, dev):
    """B seeded glyph lines of wmin..W px in one [B, 32, W] batch: the
    alphabet and (images, widths, labels [B, L], label lengths) on ``dev``."""
    import torch
    from vistaocr_tpu_torch.text import Alphabet, utf8_to_uxxxx

    alphabet = Alphabet.from_charset(GLYPH_CHARSET)
    lines = glyph_lines(font, np.random.default_rng(seed), B, wmin, W)
    images = np.full((B, 32, W), 255, np.uint8)
    labels = np.zeros((B, L), np.int32)
    widths, lls = np.zeros(B, np.int32), np.zeros(B, np.int32)
    for i, (img, text) in enumerate(lines):
        images[i, :, :img.shape[1]] = img
        widths[i] = img.shape[1]
        ids = alphabet.encode(utf8_to_uxxxx(text))
        labels[i, :len(ids)] = ids
        lls[i] = len(ids)
    return alphabet, [torch.from_numpy(a).to(dev)
                      for a in (images, widths, labels, lls)]


# the dp phase: two ranks on one card over gloo (NCCL refuses two ranks on
# one device), held against one process on the same global batches
DP_BATCH, DP_WIDTH, DP_STEPS = 32, 512, 4  # 16 rows a rank
DP_TIMEOUT_S = 240  # each spawned run; every rank is killed after
# tests/test_torch_port_train.py: a bf16 step's loss against another
# framework's within 2**-8 relative (twice JAX's own bf16-vs-f32 gap)
BF16_STEP_LOSS_REL = 2.0 ** -8
DP_K = {"K1": ("SAVE_CELL_LAUNCHES",),
        "K2/K3": ("GATES_GEMM_LAUNCHES", "BWD_PERSISTENT_LAUNCHES",
                  "DWH_LAUNCHES"),
        "K4/K5": ("ALPHA_LAUNCHES", "BETA_LAUNCHES")}


def _dp_child():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_port_dp_child.py")
    spec = importlib.util.spec_from_file_location("torch_port_dp_child", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dp_train_job(job: str, font: dict) -> None:
    """The flagship at full width (bf16 and f32, dropout 0, seeded
    weights) and DP_STEPS seeded glyph batches of DP_BATCH lines in the
    W=DP_WIDTH bucket (the first with its last row padding)."""
    import torch
    from vistaocr_tpu_torch.models import CnnLstmOcr, ModelConfig, init_parameters

    batches = {}
    for k in range(DP_STEPS):
        alphabet, batch = _glyph_batch(font, 40 + k, DP_BATCH, DP_WIDTH,
                                       DP_WIDTH // 2, DP_WIDTH // 4, "cpu")
        for f, t in zip(("images", "widths", "labels", "label_lengths"),
                        batch):
            batches[f"{f}_{k}"] = t.numpy()
        batches[f"valid_{k}"] = np.arange(DP_BATCH) < DP_BATCH - (k == 0)
    cfgs = {dt: ModelConfig(num_classes=alphabet.num_classes,
                            compute_dtype=dt, dropout=0.0)
            for dt in ("bfloat16", "float32")}
    model = CnnLstmOcr(cfgs["float32"])
    init_parameters(model, torch.Generator().manual_seed(5))
    np.savez(os.path.join(job, "weights.npz"), **{
        f"sd/{k}": v.numpy() for k, v in model.state_dict().items()})
    np.savez(os.path.join(job, "batches.npz"), **batches)
    with open(os.path.join(job, "job.json"), "w") as f:
        json.dump({"runs": [
            {"config": cfgs["bfloat16"].to_json(), "optimizer": "adam",
             "lr": 1e-3, "steps": DP_STEPS},
            {"config": cfgs["float32"].to_json(), "optimizer": "adam",
             "lr": 1e-3, "steps": 1}]}, f)


def _hold_ranks(ranks, one, equal_keys) -> dict:
    """Spawned ranks against one process on the same job: every rank's
    ``equal_keys`` bit-equal to rank 0's, each bf16 step's loss within
    BF16_STEP_LOSS_REL, the f32 step within JAX's parallel tolerances
    (loss 1e-5 relative, parameters atol 3e-3 / rtol 2e-2), and each
    rank's K1, K2/K3 and K4/K5 launched in its bf16 steps."""
    r0 = ranks[0]
    for r, res in enumerate(ranks[1:], 1):
        differ = [k for k in r0 if equal_keys(k)
                  and not np.array_equal(r0[k], res[k])]
        _require(sorted(res) == sorted(r0) and not differ,
                  f"rank {r}'s losses, state dicts and launch counts "
                  f"bit-equal to rank 0's: {differ[:5]}")
    rel = np.abs(r0["0/loss"] - one["0/loss"]) / np.abs(one["0/loss"])
    _require(np.isfinite(r0["0/loss"]).all()
             and (rel <= BF16_STEP_LOSS_REL).all(),
             f"bf16 loss of each step within 2**-8: ranks {r0['0/loss']}, "
             f"one process {one['0/loss']}")
    f32_rel = float(abs(r0["1/loss"][0] - one["1/loss"][0])
                    / abs(one["1/loss"][0]))
    _require(f32_rel <= 1e-5, f"f32 loss within 1e-5: {f32_rel}")
    worst = 0.0
    for k in one:
        if k.startswith("1/sd/") and not k.endswith("num_batches_tracked"):
            _require(r0[k].shape == one[k].shape, f"{k[5:]} whole")
            diff = np.abs(r0[k] - one[k])
            worst = max(worst, float(diff.max()))
            _require((diff <= 3e-3 + 2e-2 * np.abs(one[k])).all(),
                     f"f32 {k[5:]} after one Adam step within atol 3e-3 / "
                     "rtol 2e-2")
    counts = []
    for r, res in enumerate(ranks):
        c = {group: sum(int(res[f"0/count/{n}"]) for n in names)
             for group, names in DP_K.items()}
        _require(all(v > 0 for v in c.values()),
                 f"rank {r} launched K1, K2/K3 and K4/K5: {c}")
        counts.append(c)
    return {"steps": DP_STEPS, "bf16_loss_ranks": r0["0/loss"].tolist(),
            "bf16_loss_one": one["0/loss"].tolist(),
            "bf16_loss_rel_max": float(rel.max()),
            "f32_loss_rel": f32_rel, "f32_param_max_abs_diff": worst,
            "launches_a_rank": counts,
            "launches_a_rank_by_counter": {
                n: int(r0[f"0/count/{n}"]) for names in DP_K.values()
                for n in names}}


def dp_train_check(dev, job: str, one: dict, one_s: float,
                   smi: str) -> dict:
    """Two gloo ranks on ``dev`` against one process (``one``, the job of
    ``dp_train_job`` run whole): ``_hold_ranks``, with every output of the
    two ranks bit-equal."""
    child = _dp_child()
    t0 = time.time()
    ranks, outs = child.spawn_ranks(job, 2, str(dev), "gloo", DP_TIMEOUT_S)
    ranks_s = time.time() - t0
    for out in outs:
        print(out.strip(), flush=True)
    out = {"ranks": 2, "backend": "gloo", "device": str(dev),
           "rows_a_rank": DP_BATCH // 2, "width": DP_WIDTH,
           **_hold_ranks(ranks, one, lambda k: True),
           "ranks_s": ranks_s, "one_process_s": one_s}
    print(f"dp train: 2 gloo ranks x {DP_BATCH // 2} rows on {dev}, "
          f"{DP_STEPS} bf16 steps: loss {out['bf16_loss_ranks']} against one "
          f"process {out['bf16_loss_one']} (worst "
          f"{out['bf16_loss_rel_max']:.2e}); f32 loss rel "
          f"{out['f32_loss_rel']:.2e}, parameters max |diff| "
          f"{out['f32_param_max_abs_diff']:.2e}; launches a rank "
          f"{out['launches_a_rank']}; ranks {ranks_s:.1f} s, one process "
          f"{one_s:.1f} s ({smi})", flush=True)
    return out


# the tp check: the mesh's model axis (tensor parallelism) on the one card,
# gloo ranks on cuda:0 laid out data x model, on the dp job
TP_MESHES = ((2, 2), (1, 2))  # (data, model)


def tp_train_check(dev, job: str, one: dict, smi: str) -> dict:
    """For each (data, model) of TP_MESHES, data x model gloo ranks on
    ``dev`` train the dp job with the bridge and BLSTM gates sharded on
    the model axis, against one process (``_hold_ranks``): every rank's
    gathered state dicts, losses, norms and launch counts bit-equal, and
    each rank's shard-and-gather of the initial weights exact."""
    child = _dp_child()
    with open(os.path.join(job, "job.json")) as f:
        spec = json.load(f)
    with np.load(os.path.join(job, "weights.npz")) as z:
        weights = {k[3:]: z[k] for k in z.files}
    out = {}
    for data, model in TP_MESHES:
        world = data * model
        with open(os.path.join(job, "job.json"), "w") as f:
            json.dump({**spec, "mesh": {"data": data, "model": model}}, f)
        t0 = time.time()
        ranks, outs = child.spawn_ranks(job, world, str(dev), "gloo",
                                        DP_TIMEOUT_S)
        ranks_s = time.time() - t0
        for o in outs:
            print(o.strip(), flush=True)
        for r, res in enumerate(ranks):
            _require(res["mesh/index"].tolist() == list(divmod(r, model))
                     and all(np.array_equal(res[f"roundtrip/{k}"], v)
                             for k, v in weights.items()),
                     f"rank {r} at {divmod(r, model)} of {data}x{model}; "
                     "its shards gather to the initial weights")
        held = _hold_ranks(ranks, one, lambda k: "/local/" not in k
                           and k != "mesh/index")
        sharded = sorted(k[len("0/local/"):] for k in ranks[0]
                         if k.startswith("0/local/")
                         and ranks[0][k].shape != one[
                             k.replace("/local/", "/sd/")].shape)
        tag = f"data{data}_model{model}"
        out[tag] = {"ranks": world, "data": data, "model": model,
                    "backend": "gloo", "device": str(dev),
                    "rows_a_rank": DP_BATCH // data, "width": DP_WIDTH,
                    "sharded": sharded, **held, "ranks_s": ranks_s}
        print(f"tp train: {world} gloo ranks ({data} x {model}) x "
              f"{DP_BATCH // data} rows on {dev}, {len(sharded)} tensors "
              f"sharded, {DP_STEPS} bf16 steps: loss "
              f"{held['bf16_loss_ranks']} against one process "
              f"{held['bf16_loss_one']} (worst "
              f"{held['bf16_loss_rel_max']:.2e}); f32 loss rel "
              f"{held['f32_loss_rel']:.2e}, parameters max |diff| "
              f"{held['f32_param_max_abs_diff']:.2e}; launches a rank "
              f"{held['launches_a_rank'][0]}; ranks {ranks_s:.1f} s "
              f"({smi})", flush=True)
    return out


def dp_nccl_cli(tmp: str, font: dict, smi: str, fused: bool = False) -> dict:
    """One rank over NCCL through the trainer's CLI: a few steps and a
    validation on a small glyph data set; with ``fused`` the same with
    ``--device-cache on --fused-epochs on``, every step a graph replay."""
    child = _dp_child()
    tag = "dp_fused" if fused else "dp"
    data, run = os.path.join(tmp, "dp_glyphs"), os.path.join(tmp, f"{tag}_run")
    if not os.path.exists(data):
        write_glyph_dataset(data, font, seed=23, n_train=256, n_val=32,
                            widths=(200, 512))
    env = dict(os.environ)
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "vistaocr_tpu_torch.train",
           "--data-dir", data, "--snapshot-dir", run,
           "--bucket-widths", "256,512", "--batch-pixels", str(2**19),
           "--max-steps", "4", "--val-interval-steps", "4",
           "--log-interval", "1", "--coordinator-address",
           f"127.0.0.1:{child.free_port()}", "--num-processes", "1",
           "--process-id", "0"]
    if fused:
        cmd += ["--device-cache", "on", "--fused-epochs", "on"]
    t0 = time.time()
    proc = subprocess.run(cmd, env=env, cwd=root, capture_output=True,
                          text=True, timeout=DP_TIMEOUT_S)
    wall = time.time() - t0
    _require(proc.returncode == 0,
             f"NCCL CLI run exited {proc.returncode}: {proc.stderr[-3000:]}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [r for r in map(json.loads, f) if "loss" in r]
    losses = [r["loss"] for r in recs]  # a step's, or a fused segment's
    logged = sum(r.get("steps", 1) for r in recs)
    _require(summary["steps"] == 4 and logged == 4
             and all(np.isfinite(losses)),
             f"4 NCCL CLI steps with finite losses: {summary} {recs}")
    _require("mesh=data:1xmodel:1 (rank 0)" in proc.stdout,
             "the CLI run joined its one-rank group")
    _require(not fused or (
        "device cache: dataset resident on device" in proc.stdout
        and "each step one CUDA graph replay" in proc.stdout),
        f"the fused CLI run took the cache and the graphs: {proc.stdout}")
    print(f"{tag} nccl: one rank (cpu:gloo,cuda:nccl) through the CLI, 4 "
          f"steps in {wall:.1f} s of command time: losses {losses}, val CER "
          f"{summary['last_val_cer']} ({smi})", flush=True)
    return {"backend": "cpu:gloo,cuda:nccl", "ranks": 1, "steps": 4,
            "fused": fused, "losses": losses,
            "val_cer": summary["last_val_cer"], "wall_s": wall}


def dp_service_check(dev, font: dict, snap: str, smi: str) -> dict:
    """The service with mesh_data=-1 against mesh_data=0, and two shards
    on ``dev`` (the device list patched to it twice) against one, greedy
    and the device beam. Every line falls in the W=512 bucket and the
    two-shard service takes full batches of 32, so each shard runs the
    16-row batches that the one-shard service at max_batch=16 runs: the
    texts and confidences must be equal, not near."""
    import torch
    from vistaocr_tpu_torch.ops import lstm_cuda
    from vistaocr_tpu_torch.parallel import mesh as pmesh
    from vistaocr_tpu_torch.serve import OcrService, ServiceConfig

    lines = [img for img, _ in glyph_lines(font, np.random.default_rng(9),
                                            64, 420, 512)]
    _require(all(385 <= img.shape[1] <= 512 for img in lines),
             "every dp service line in the W=512 bucket")

    def serve(**kw):
        svc = OcrService(snap, ServiceConfig(warmup=False, **kw),
                         device=str(dev))
        try:
            svc.ocr_lines(lines)  # the first call builds and captures
            lstm_cuda.LAUNCHES = 0
            t0 = time.time()
            got = svc.ocr_lines(lines)
            dt = time.time() - t0
            return got, len(svc._shards), lstm_cuda.LAUNCHES, dt
        finally:
            svc.close()

    out = {}
    real = pmesh.local_devices
    for decoder in ("greedy", "beam"):
        one, n1, _, _ = serve(max_batch=32, decoder=decoder)
        every, n_all, _, _ = serve(max_batch=32, decoder=decoder,
                                   mesh_data=-1)
        _require(n1 == 1 and n_all == torch.cuda.device_count(),
                 f"mesh_data=-1 holds a shard a card: {n_all}")
        if n_all == 1:
            _require([(r.text, r.confidence) for r in every]
                     == [(r.text, r.confidence) for r in one],
                     f"{decoder}: mesh_data=-1 equals mesh_data=0")
        half, _, _, _ = serve(max_batch=16, decoder=decoder)
        pmesh.local_devices = lambda device_type="cuda": [dev, dev]
        try:
            two, n2, launches, dt = serve(max_batch=32, decoder=decoder,
                                          mesh_data=2)
        finally:
            pmesh.local_devices = real
        same = sum((a.text, a.confidence) == (b.text, b.confidence)
                   for a, b in zip(two, half))
        _require(n2 == 2 and same == len(lines) and launches > 0
                 and any(r.text for r in two),
                 f"{decoder}: two shards on {dev} give the texts and "
                 f"confidences of one ({same}/{len(lines)}), K1 launched "
                 f"({launches})")
        out[decoder] = {"lines": len(lines), "equal": same,
                        "k1_launches_two_shards": launches,
                        "two_shards_lines_per_s": len(lines) / dt}
        print(f"dp service {decoder}: mesh_data=-1 = {n_all} shard(s), equal"
              f" to mesh_data=0; two shards on {dev}: {same}/{len(lines)} "
              f"texts and confidences equal to one shard, K1 launches "
              f"{launches}, {len(lines) / dt:.1f} lines/s warm ({smi})",
              flush=True)
    return out


def dp_phase(dev, font: dict, smi: str) -> dict:
    t0 = time.time()
    out = {}
    with tempfile.TemporaryDirectory() as job:
        dp_train_job(job, font)
        t1 = time.time()
        one = _dp_child().run_job(job, device=str(dev))
        one_s = time.time() - t1
        out["train"] = dp_train_check(dev, job, one, one_s, smi)
        t1 = time.time()
        out["tp"] = tp_train_check(dev, job, one, smi)
        out["tp_seconds"] = time.time() - t1
        print(f"tp check: {out['tp_seconds']:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        out["nccl_cli"] = dp_nccl_cli(tmp, font, smi)
        out["nccl_cli_fused"] = dp_nccl_cli(tmp, font, smi, fused=True)
        snap = os.path.join(tmp, "snap")
        flagship_snapshot(snap)
        out["service"] = dp_service_check(dev, font, snap, smi)
    out["seconds"] = time.time() - t0
    out["note"] = ("correctness on one shared card, not scaling: every "
                   "rank and both shards time-slice one GPU")
    print(f"dp phase: {out['seconds']:.1f} s", flush=True)
    return out


# --- the fused phase: the device cache and the epoch-fused trainer -----------
FUSED_STEPS = 40  # fit's steps, each one CUDA graph replay
FUSED_PARITY_STEPS = 8  # bf16 replays against as many eager steps
FUSED_F32_STEPS = 4
FUSED_WINDOW = 4  # steps in each profiler window
# the kernels each step must run on the device (name fragments): every one
# with bf16 weights; with f32 weights one of each group
FUSED_KERNELS = {
    "bfloat16": {"K1": ("lstm_fwd_persistent",),
                 "K2/K3": ("bptt_gates_gemm",), "K2/K3 frames": (
                     "lstm_bwd_persistent",), "K2/K3 dwh": ("lstm_dwh",),
                 "K4": ("ctc_alpha_kernel",), "K5": ("ctc_beta_kernel",)},
    "float32": {"K1": ("lstm_fwd_grid", "lstm_fwd_rows", "lstm_step"),
                "K2/K3": ("bptt_gates_gemm",), "K2/K3 frames": (
                    "bptt_frame", "lstm_bwd_rows", "bptt_cell"),
                "K2/K3 dwh": ("lstm_dwh",),
                "K4": ("ctc_alpha_kernel",), "K5": ("ctc_beta_kernel",)},
}


class _MaskRecorder:
    """Within the block, every dropout mask the model draws
    (``models.blstm.dropout_mask``) is also kept in ``masks``."""

    def __enter__(self):
        from vistaocr_tpu_torch.models import blstm

        self.mod, self.real, self.masks = blstm, blstm.dropout_mask, []

        def record(x, rate, generator):
            mask = self.real(x, rate, generator)
            self.masks.append(mask)
            return mask

        blstm.dropout_mask = record
        return self

    def __exit__(self, *exc):
        self.mod.dropout_mask = self.real


def _busy_share(summary: str) -> float:
    """The device-busy percentage of a ``device_time_summary``."""
    import re

    return float(re.search(r"device busy [\d.]+ ms \(([\d.]+)%\)",
                           summary).group(1))


def _window(fn):
    """``torch.profiler``'s device events over one call of ``fn`` (CUDA
    activity only): (every event, {kernel name: launches})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    names = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            names[e.name] = names.get(e.name, 0) + 1
    return events, names


def _seen(names: dict, groups: dict) -> dict:
    """Launches of each group's kernels in a window's ``names``."""
    return {g: sum(n for name, n in names.items()
                   if any(f in name for f in frags))
            for g, frags in groups.items()}


def fused_fit(data: str, run: str, smi: str, per_step_lps) -> dict:
    """Part (a): ``fit`` on the glyph data with the flagship
    ``TrainConfig``, ``device_cache="on"``, ``fused_epochs="on"``,
    FUSED_STEPS steps and one validation."""
    import torch
    from vistaocr_tpu_torch import train as T
    from vistaocr_tpu_torch.ops import ctc_cuda, lstm_cuda

    mods = {"lstm_cuda": lstm_cuda, "ctc_cuda": ctc_cuda}
    cfg = T.TrainConfig(**{**T.PRESETS["full"], "data_dir": data,
                           "snapshot_dir": run, "max_steps": FUSED_STEPS,
                           "val_interval_steps": FUSED_STEPS, "seed": 0,
                           "device_cache": "on", "fused_epochs": "on"})
    T.GRAPH_CAPTURES = T.GRAPH_REPLAYS = T.FUSED_EAGER_STEPS = 0
    T.CAPTURE_SECONDS = 0.0
    for mod, name in TRAIN_COUNTERS:
        setattr(mods[mod], name, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logs = []

    def log(m):
        logs.append(m)
        if not m.startswith("step "):
            print(m, flush=True)

    t0 = time.time()
    summary = T.fit(cfg, device="cuda", log=log)
    wall = time.time() - t0
    counts = {name: getattr(mods[mod], name) for mod, name in TRAIN_COUNTERS}
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    segs = [r for r in recs if "loss" in r]
    shapes = sorted({tuple(r["batch_shape"]) for r in segs})
    losses = [r["loss"] for r in segs]
    _require(summary["steps"] == FUSED_STEPS
             and sum(r["steps"] for r in segs) == FUSED_STEPS,
             f"{FUSED_STEPS} fused steps: {summary} {segs}")
    _require(all(np.isfinite(losses)) and max(losses) < 1e20,
             f"finite segment losses: {losses}")
    _require(any("each step one CUDA graph replay" in m for m in logs)
             and "device cache: dataset resident on device" in logs,
             "fit ran the cache and the graphs")
    _require(T.GRAPH_CAPTURES == len(shapes)
             and T.GRAPH_REPLAYS == FUSED_STEPS
             and T.FUSED_EAGER_STEPS == 0,
             f"a capture a batch shape ({len(shapes)}: {shapes}), a replay "
             f"a step: captures {T.GRAPH_CAPTURES}, replays "
             f"{T.GRAPH_REPLAYS}, eager {T.FUSED_EAGER_STEPS}")
    vals = [r for r in recs if "val_cer" in r]
    with open(os.path.join(run, "best", "meta.json")) as f:
        extra = json.load(f)["extra"]  # validation's copy of last/
    _require(len(vals) == 1 and vals[0]["step"] == FUSED_STEPS
             and extra["stack_rows_done"] == FUSED_STEPS
             and extra["stack_epochs"] == T.TrainConfig().epoch_stack
             and os.path.exists(os.path.join(run, "last", "meta.json")),
             f"one validation at step {FUSED_STEPS} and its snapshot with "
             f"the stack position: {vals} {extra}")
    _require(all(v > 0 for v in counts.values()),
             f"every training kernel captured: {counts}")
    lines = sum(r["lines"] for r in segs)
    seconds = sum(r["seconds"] for r in segs)
    lps = lines / (seconds - T.CAPTURE_SECONDS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"fused fit: {FUSED_STEPS} steps as {T.GRAPH_REPLAYS} graph "
          f"replays over {len(segs)} segments, {T.GRAPH_CAPTURES} captures "
          f"(shapes {shapes}) in {T.CAPTURE_SECONDS:.2f} s with their "
          f"warm-ups; {wall:.1f} s in all (setup and validation included); "
          f"segment losses {losses}; val CER {summary['last_val_cer']:.4f}; "
          f"wrapper calls (warm-ups and captures) {counts}; peak memory "
          f"{peak:.2f} GiB ({smi})", flush=True)
    print(f"fused fit: {lines} lines at {lps:.1f} train lines/s after the "
          f"captures (the per-step path, phase 7, steps 11-40: "
          f"{'not run' if per_step_lps is None else f'{per_step_lps:.1f}'}"
          f" lines/s) ({smi})", flush=True)
    return {"steps": FUSED_STEPS, "segments": len(segs),
            "captures": T.GRAPH_CAPTURES, "replays": T.GRAPH_REPLAYS,
            "batch_shapes": shapes, "capture_s": T.CAPTURE_SECONDS,
            "wall_s": wall, "losses": losses,
            "val_cer": summary["last_val_cer"], "lines": lines,
            "lines_per_s_after_captures": lps,
            "per_step_lines_per_s_phase7": per_step_lps,
            "peak_memory_gib": peak, "wrapper_calls": counts}


def _graph_against_eager(model, arrays, idx, w, steps: int) -> dict:
    """``steps`` graph replays of ``make_train_epoch`` (one a call, so
    each step's loss and dropout masks are read) and as many eager
    ``train_step`` calls over the same rows, each from its own copy of
    ``model``: {mode: (losses, masks a step, model, state, trainer)}."""
    import copy
    from vistaocr_tpu_torch import train as T

    out = {}
    for mode in ("graph", "eager"):
        m = copy.deepcopy(model)
        tx = T.Optimizer("adam")
        state = T.TrainState(model=m,
                             opt_state=tx.init(dict(m.named_parameters())))
        losses, masks = [], []
        with _MaskRecorder() as rec:
            if mode == "graph":
                fn = T.make_train_epoch(m, tx, False, "auto", grad_clip=5.0)
                _require(fn.graphs, "the fused steps run as graphs")
                for k in range(steps):
                    n0 = len(rec.masks)
                    losses.append(float(fn(state, arrays, idx[k:k + 1],
                                           w[k:k + 1], 1e-3)["loss"]))
                    if k == 0:  # the warm-up's masks, then the graph's
                        live = rec.masks[n0 + (len(rec.masks) - n0) // 2:]
                    masks.append([t.clone() for t in live])
            else:
                fn = T.make_train_step(m, tx, False, "auto", grad_clip=5.0)
                for k in range(steps):
                    n0 = len(rec.masks)
                    losses.append(float(fn(
                        state, *(a.index_select(0, idx[k]) for a in arrays),
                        w[k], 1e-3)["loss"]))
                    masks.append(rec.masks[n0:])
        out[mode] = (losses, masks, m, state, fn)
    return out


def fused_parity(dev, data: str, smi: str) -> dict:
    """Part (b): one bucket of the glyph data (the plan's with the most
    rows), the flagship from one seeded init: bf16 graph replays against
    eager steps (losses within 2**-8, masks equal), their times and
    profiler windows, then f32 (losses within 1e-5, parameters within
    atol 3e-3 / rtol 2e-2, masks equal)."""
    import torch
    from vistaocr_tpu_torch import train as T
    from vistaocr_tpu_torch.data import (BatchPipeline, make_ladder,
                                         open_dataset)
    from vistaocr_tpu_torch.data.device_cache import DeviceCache
    from vistaocr_tpu_torch.models import CnnLstmOcr, init_parameters
    from vistaocr_tpu_torch.text import Alphabet

    cfg = T.TrainConfig(**T.PRESETS["full"])
    ds = open_dataset(data, "train")
    contract = cfg.contract()
    contract = dataclasses.replace(contract, bucket_widths=make_ladder(
        ds.widths, stride=contract.width_stride, align=32, max_waste=0.03,
        max_width=max(cfg.bucket_widths)))
    alphabet = Alphabet.build(ds.transcripts())
    pipe = BatchPipeline(ds, alphabet, contract, batch_pixels=cfg.batch_pixels,
                         drop_remainder=True, shuffle=True, seed=0)
    b, arrays, idx, w = max(DeviceCache(pipe, device=dev).epoch_plan(
        0, stack=cfg.epoch_stack), key=lambda p: p[2].shape[0])
    rows = torch.arange(FUSED_PARITY_STEPS, device=dev) % idx.shape[0]
    idx, w = idx[rows], w[rows]
    B, W = idx.shape[1], pipe.spec_for(b).width
    out = {"B": B, "W": W, "T": W // 4}
    for dtype, steps, tol in (("bfloat16", FUSED_PARITY_STEPS,
                               BF16_STEP_LOSS_REL),
                              ("float32", FUSED_F32_STEPS, 1e-5)):
        model = CnnLstmOcr(dataclasses.replace(
            cfg.model_config(alphabet.num_classes), compute_dtype=dtype))
        init_parameters(model, torch.Generator().manual_seed(3))
        model.to(dev)
        captures = T.GRAPH_CAPTURES
        runs = _graph_against_eager(model, arrays, idx, w, steps)
        (g_loss, g_masks, g_model, g_state, epoch), \
            (e_loss, e_masks, e_model, e_state, step) = runs["graph"], \
            runs["eager"]
        rel = [abs(a - e) / abs(e) for a, e in zip(g_loss, e_loss)]
        _require(T.GRAPH_CAPTURES == captures + 1
                 and all(np.isfinite(g_loss)) and max(rel) <= tol,
                 f"{dtype}: one capture, each replay's loss within {tol} of "
                 f"the eager step's: {g_loss} {e_loss}")
        same = [len(a) == len(e) > 0 and all(torch.equal(x, y)
                                             for x, y in zip(a, e))
                for a, e in zip(g_masks, e_masks)]
        _require(all(same) and not torch.equal(g_masks[0][0],
                                               g_masks[1][0]),
                 f"{dtype}: every replay draws the eager step's dropout "
                 f"masks, and steps draw anew: {same}")
        worst = 0.0  # held to JAX's bound in f32, read in bf16
        for (k, a), e in zip(g_model.state_dict().items(),
                             e_model.state_dict().values()):
            if a.is_floating_point():
                diff = (a - e).abs()
                worst = max(worst, float(diff.max()))
                _require(dtype != "float32"
                         or bool((diff <= 3e-3 + 2e-2 * e.abs()).all()),
                         f"f32 {k} within atol 3e-3 / rtol 2e-2")
        row = {"steps": steps, "loss_graph": g_loss, "loss_eager": e_loss,
               "loss_rel_max": max(rel), "masks_equal": len(same),
               "masks_a_step": len(g_masks[0]), "param_max_abs_diff": worst}
        # the two paths' times and device windows at this bucket
        ms = {}
        for mode, fn in (("graph", lambda: epoch(g_state, arrays, idx, w,
                                                 1e-3)),
                         ("eager", lambda: [step(
                             e_state, *(a.index_select(0, idx[k])
                                        for a in arrays), w[k], 1e-3)
                             for k in range(FUSED_PARITY_STEPS)])):
            ms[mode] = _cuda_ms(fn, 1) / FUSED_PARITY_STEPS
        part = slice(0, FUSED_WINDOW)
        captures = T.GRAPH_CAPTURES
        windows = {
            "graph": _window(lambda: epoch(g_state, arrays, idx[part],
                                           w[part], 1e-3)),
            "eager": _window(lambda: [step(
                e_state, *(a.index_select(0, idx[k]) for a in arrays),
                w[k], 1e-3) for k in range(FUSED_WINDOW)])}
        _require(T.GRAPH_CAPTURES == captures, "the window only replays")
        for mode, (events, names) in windows.items():
            seen = _seen(names, FUSED_KERNELS[dtype])
            _require(all(v > 0 for v in seen.values()),
                     f"{dtype} {mode}: K1-K5 on the device in the window: "
                     f"{seen}; {sorted(names)[:30]}")
            summary = T.device_time_summary(events, top=8)
            row[f"{mode}_ms_a_step"] = ms[mode]
            row[f"{mode}_lines_per_s"] = 1e3 * B / ms[mode]
            row[f"{mode}_busy_pct"] = _busy_share(summary)
            row[f"{mode}_window_kernels"] = seen
            print(f"fused parity {dtype} {mode}, B={B} W={W}: "
                  f"{ms[mode]:.3f} ms a step, {1e3 * B / ms[mode]:.1f} "
                  f"train lines/s; window of {FUSED_WINDOW} steps: "
                  f"{summary.splitlines()[0]}; kernels {seen} ({smi})",
                  flush=True)
        print(f"fused parity {dtype}: {steps} graph replays against eager "
              f"steps, losses {g_loss} / {e_loss} (worst {max(rel):.2e}), "
              f"masks equal in {len(same)} steps ({len(g_masks[0])} a "
              f"step), parameters {worst:.2e} ({smi})", flush=True)
        out[dtype] = row
    return out


def fused_phase(dev, tmp: str, font: dict, smi: str,
                per_step_lps=None) -> dict:
    """The device cache and the epoch-fused trainer: ``fused_fit`` on
    phase 7's glyph data (written here when phase 7 did not run), then
    ``fused_parity``."""
    t0 = time.time()
    data = os.path.join(tmp, "glyphs")
    if not os.path.exists(data):
        write_glyph_dataset(data, font, seed=21, n_train=3000, n_val=128)
    out = {"fit": fused_fit(data, os.path.join(tmp, "fused_run"), smi,
                            per_step_lps),
           "parity": fused_parity(dev, data, smi)}
    out["seconds"] = time.time() - t0
    print(f"fused phase: {out['seconds']:.1f} s", flush=True)
    return out


# the f32 path of phase 8: one f32 forward+backward of the flagship at the
# W=2048 bucket (lstm_fwd_grid, the folded f32 frame loop), one at the
# W=512 bucket (lstm_fwd_grid, lstm_bwd_rows) and one at the W=128 bucket
# (lstm_fwd_rows, lstm_bwd_rows), on the kernels (the counts of its LSTM
# kernels)
F32_COUNTERS = ("SAVE_CELL_LAUNCHES", "FWD_GRID_LAUNCHES",
                "FWD_ROWS_LAUNCHES", "STEP_LAUNCHES", "BWD_LAUNCHES",
                "GATES_GEMM_LAUNCHES", "FRAME_LAUNCHES", "BWD_ROWS_LAUNCHES",
                "CELL_LAUNCHES", "DH_LAUNCHES", "DWH_LAUNCHES")
# the counter of each f32 forward design (T launches a call for "step")
# and of each f32 frame-loop design (T a call for "fold", T each for
# "split")
F32_FWD_COUNTER = {"grid": "FWD_GRID_LAUNCHES", "rows": "FWD_ROWS_LAUNCHES",
                   "step": "STEP_LAUNCHES"}
F32_LOOP_COUNTERS = {"fold": ("FRAME_LAUNCHES",),
                     "rows": ("BWD_ROWS_LAUNCHES",),
                     "split": ("CELL_LAUNCHES", "DH_LAUNCHES")}
# (B, W): 2**21-pixel train batches
F32_STEPS = ((32, 2048), (128, 512), (512, 128))


def f32_step(dev, font: dict, B: int, W: int,
             compute_dtype: str = "float32"):
    """One train-mode forward+backward (``loss_and_grads``, dropout off)
    of the flagship model on the kernels in ``compute_dtype`` (f32, or the
    flagship's "bfloat16"), from seeded parameters and B glyph lines of
    W/2..W px, as a function of no arguments. Entry points only, so it
    also runs in an earlier tree of the port."""
    import torch
    from vistaocr_tpu_torch import train as T
    from vistaocr_tpu_torch.models import CnnLstmOcr, ModelConfig, init_parameters

    alphabet, batch = _glyph_batch(font, 10, B, W, W // 2, min(256, W // 4),
                                   dev)
    model = CnnLstmOcr(ModelConfig(num_classes=alphabet.num_classes,
                                   compute_dtype=compute_dtype, dropout=0.0))
    init_parameters(model, torch.Generator().manual_seed(5))
    model.to(dev)
    weights = torch.ones(B, device=dev)
    return lambda: T.loss_and_grads(model, *batch, weights)


def f32_step_timing(step, card: str, B: int, W: int,
                    label: str = "f32") -> dict:
    """CUDA-event ms of ``step`` (an ``f32_step``) after a warm-up, and its
    device time: the sum of the device operations' durations in a
    ``torch.profiler`` window over one step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ms = _cuda_ms(step, 3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    device_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(f"{label} forward+backward of the flagship on the kernels, B={B} "
          f"W={W}: {ms:.3f} ms a step (CUDA events), device time "
          f"{device_ms:.3f} ms ({card})", flush=True)
    return {"B": B, "W": W, "ms": ms, "device_ms": device_ms}


def train_parity_phase(dev, font: dict, card: str) -> dict:
    """The f32 parity check (scan against the kernels), then the f32 path:
    one f32 step on the kernels at each of ``F32_STEPS`` with the BPTT
    counters set to 0 before the first and read after the last, and the
    timing of each."""
    import torch
    from vistaocr_tpu_torch import train as T
    from vistaocr_tpu_torch.models import CnnLstmOcr, ModelConfig, init_parameters

    alphabet, batch = _glyph_batch(font, 9, 16, 1024, 200, 127, dev)
    cfg = ModelConfig(num_classes=alphabet.num_classes,
                      compute_dtype="float32", dropout=0.0)
    B = batch[0].shape[0]
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

    from vistaocr_tpu_torch.ops import lstm_cuda

    steps = [f32_step(dev, font, B, W) for B, W in F32_STEPS]
    for name in F32_COUNTERS:
        setattr(lstm_cuda, name, 0)
    want = dict.fromkeys(F32_COUNTERS, 0)  # what each step's route launches
    for step, (B, W) in zip(steps, F32_STEPS):
        before = (lstm_cuda.LAUNCHES, lstm_cuda.BWD_LAUNCHES)
        loss, _ = step()
        torch.cuda.synchronize()
        _require(np.isfinite(loss.item()), "finite f32 loss")
        fwd, bwd, T = (lstm_cuda.LAUNCHES - before[0],
                       lstm_cuda.BWD_LAUNCHES - before[1], W // 4)
        _require(fwd > 0 and bwd > 0, f"B={B}: LSTM forward and BPTT calls")
        want["SAVE_CELL_LAUNCHES"] += fwd
        design = lstm_cuda.forward_design(torch.float32, B, 512)
        want[F32_FWD_COUNTER[design]] += fwd * (T if design == "step" else 1)
        for name in ("BWD_LAUNCHES", "GATES_GEMM_LAUNCHES", "DWH_LAUNCHES"):
            want[name] += bwd
        loop = lstm_cuda.loop_design(torch.float32, B, 512)
        for name in F32_LOOP_COUNTERS[loop]:
            want[name] += bwd * (1 if loop == "rows" else T)
    counts = {name: getattr(lstm_cuda, name) for name in F32_COUNTERS}
    print(f"f32 path: launches in its steps {counts}", flush=True)
    # the forward: lstm_fwd_grid once a layer call (B=32, 128),
    # lstm_fwd_rows once (B=512); the BPTT: one f32 gate GEMM a call, then
    # T bptt_frame launches (B=32) or one lstm_bwd_rows (B=128, 512); every
    # kernel the rules pick is launched, and no other
    _require(counts == want and all(counts[n] > 0 for n in (
        "FWD_ROWS_LAUNCHES", "BWD_ROWS_LAUNCHES"))
        and all(counts[n] > 0 for n, v in want.items() if v > 0),
        f"f32 path launches {counts}, want {want}")
    return {"counts": counts,
            "steps": [f32_step_timing(step, card, B, W)
                      for step, (B, W) in zip(steps, F32_STEPS)]}


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
            design = S.stem_design(dtype)
            out, xn = S.stem_fwd_cuda(images, widths, kernel, True, dtype)
            ref_out, ref_xn = S.fused_stem_ref(images, widths, kernel, True,
                                               dtype)
            dk = S.stem_dk_cuda(xn, dout)
            ref_dk = S.stem_dk_ref(xn, dout)
            out2, xn2 = S.stem_fwd_cuda(images, widths, kernel, True, dtype)
            reruns_equal = (torch.equal(out, out2) and torch.equal(xn, xn2)
                            and torch.equal(dk, S.stem_dk_cuda(xn, dout)))
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
            ok = ok and reruns_equal
            tag = f"B={B} H={H} W={W} CO={CO} {_dtname(dtype)}"
            print(f"stem kernels vs plain {tag} (design {design['fwd']}, "
                  f"{design['dk']}): out/xn max|d|={e_fwd:.3e} "
                  f"({ulps:.2f} bf16 ulp, {share:.2e} of elements differ); "
                  f"dK max|d|={e_dk:.3e} (rel {r_dk:.2e}); vs production "
                  f"out max|d|={e_prod:.3e}, dK rel {r_prod_dk:.2e}; reruns "
                  f"{'bit-equal' if reruns_equal else 'DIFFER'} "
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
            conv_ops = 2 * 9 * CO * B * H * W
            rows[(B, W, _dtname(dtype))] = {
                "stem_fwd": {
                    "design": design["fwd"],
                    "max_abs_err": e_fwd, "ms": t["fwd"],
                    "plain_ms": t["fwd_plain"], "library_ms": None,
                    **_bound(_nbytes(images, widths, kernel, out, xn),
                             conv_ops, dtype),
                    "production_ms": t["fwd_prod"]},
                # the production weight gradient is one library call
                "stem_dk": {
                    "design": design["dk"],
                    "max_abs_err": e_dk, "ms": t["dk"],
                    "plain_ms": t["dk_plain"], "library_ms": t["dk_prod"],
                    **_bound(_nbytes(xn, dout, dk), conv_ops, dtype),
                    "production_ms": t["dk_prod"]},
            }
    return rows


def bi_layer_route(xw, mask, whq, dtype, ys, cs, dys):
    """The layer route (``lstm_cuda``) on dense copies of the stacked
    planes as its two directions, each with its plane's mask,
    ``reverse=False`` and the stacked call's type code (f32 streams):
    returns (run the forward, run the BPTT frames + dwh), each giving its
    outputs per plane. The copies are made here, once, outside the
    calls."""
    from vistaocr_tpu_torch.experiments import lstm_bi_stacked as S
    from vistaocr_tpu_torch.ops import lstm_cuda as L

    planes = [{k: v.contiguous() if hasattr(v, "contiguous") else v
               for k, v in p.items()}
              for p in S.bi_planes(xw, mask, ys, cs, dys)]
    masks = [p["mask"] for p in planes]

    def fwd():
        return L.lstm_fwd([(p["xw"], whq[k], False)
                           for k, p in enumerate(planes)], masks, dtype,
                          save_cell=True)

    def bwd():
        dxw = L.lstm_bptt_frames(
            [(p["xw"], whq[k], p["ys"], p["cs"], p["dys"], False)
             for k, p in enumerate(planes)], masks, dtype)
        return dxw, L.lstm_dwh([(p["ys"], g, False)
                                for p, g in zip(planes, dxw)], dtype)

    return fwd, bwd


def bi_work(B: int, T: int, H: int) -> tuple:
    """The products K6a and K6b do, both planes (multiply-adds x 2): the
    forward's T frames of [B, H] x [H, 4H]; the BPTT's gate recompute and
    dh product of the T - 1 frames that have them (the edge frame's gates
    are xw alone, the last frame's dh is not read) and dwh over (T-1)*B
    rows."""
    frame = 2 * 2 * B * H * 4 * H
    return T * frame, 3 * (T - 1) * frame


def bi_experiment_kernels(dev, card: str) -> dict:
    """K6a/K6b against their plain versions, and bit-equal to the layer
    route on the same planes (``bi_layer_route``: the same device code and
    designs, in the same sum order); at the flagship shapes also timed
    beside that route and beside the production K1 save_cell + K2/K3 BPTT
    of one layer on the same inputs in natural time order."""
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
            design = S.bi_design(dtype, B, H)
            with torch.no_grad():
                ys, cs = S.bi_lstm_fwd_cuda(xw, mask, whq, dtype)
                rys, rcs = S.bi_recurrence_ref(xw, mask, wh, dtype,
                                               save_cell=True)
                dxw, dwh = S.bi_lstm_bwd_cuda(xw, mask, whq, rys, rcs, dys,
                                              dtype)
                rdxw, rdwh = S.bi_bptt_ref(xw, mask, wh, rys, rcs, dys, dtype)
                route_fwd, _ = bi_layer_route(xw, mask, whq, dtype, ys, cs,
                                              dys)
                _, route_bwd = bi_layer_route(xw, mask, whq, dtype, rys, rcs,
                                              dys)
                lys, lcs = route_fwd()
                ldxw, ldwh = route_bwd()
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
            # the same device code in the same order as the layer route:
            # bit-equal, plane by plane
            same = all(torch.equal(a[:, k], b[k])
                       for a, b in ((ys, lys), (cs, lcs), (dxw, ldxw))
                       for k in range(2)) and all(
                torch.equal(dwh[k], ldwh[k]) for k in range(2))
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
            print(f"stacked BLSTM {tag}, designs {design}: vs plain ys/cs "
                  f"max|d|={e_fwd:.3e}; dxw max|d|={e_dxw:.3e} (rel "
                  f"{r_dxw:.2e}); dwh rel {r_dwh:.2e}; ys, cs, dxw, dwh "
                  f"bit-equal to the layer route on the same planes: "
                  f"{same}; vs production ys max|d|={e_prod:.3e}, dxw/dwh "
                  f"rel {r_prod:.2e} {'ok' if ok and same else 'FAIL'}",
                  flush=True)
            _require(ok, f"stacked BLSTM kernels agree with plain: {tag}")
            _require(same, f"stacked BLSTM bit-equal to the layer route on "
                           f"the same planes: {tag}")
            if (B, T, H) == BI_SHAPES[0]:
                continue
            with torch.no_grad():
                t = {
                    "fwd": _cuda_ms(lambda: S.bi_lstm_fwd_cuda(
                        xw, mask, whq, dtype), 5),
                    "fwd_route": _cuda_ms(route_fwd, 5),
                    "fwd_plain": _cuda_ms(lambda: S.bi_recurrence_ref(
                        xw, mask, wh, dtype, save_cell=True), 1),
                    "fwd_prod": _cuda_ms(lambda: L.lstm_forward_cells(
                        dirs, pmask, dtype), 5),
                    "bwd": _cuda_ms(lambda: S.bi_lstm_bwd_cuda(
                        xw, mask, whq, rys, rcs, dys, dtype), 5),
                    "bwd_route": _cuda_ms(route_bwd, 5),
                    "bwd_plain": _cuda_ms(lambda: S.bi_bptt_ref(
                        xw, mask, wh, rys, rcs, dys, dtype), 1),
                    "bwd_prod": _cuda_ms(lambda: L.lstm_bptt(
                        bdirs, pmask, dtype), 5),
                }
            print(f"time {tag}, both planes: stacked fwd {t['fwd']:.3f} ms "
                  f"(layer route on the planes {t['fwd_route']:.3f}, ratio "
                  f"{t['fwd'] / t['fwd_route']:.3f}; plain "
                  f"{t['fwd_plain']:.3f}; production K1 in time order "
                  f"{t['fwd_prod']:.3f}); stacked BPTT frames+dwh "
                  f"{t['bwd']:.3f} ms (layer route {t['bwd_route']:.3f}, "
                  f"ratio {t['bwd'] / t['bwd_route']:.3f}; plain "
                  f"{t['bwd_plain']:.3f}; production K2/K3 "
                  f"{t['bwd_prod']:.3f}) ({card})", flush=True)
            fwd_ops, bwd_ops = bi_work(B, T, H)
            rows[(B, T, _dtname(dtype))] = {
                "bi_lstm_fwd": {
                    "max_abs_err": e_fwd, "ms": t["fwd"],
                    "plain_ms": t["fwd_plain"], "library_ms": None,
                    **_bound(_nbytes(xw, mask, whq, ys, cs), fwd_ops, dtype),
                    "design": design["forward"],
                    "layer_route_ms": t["fwd_route"],
                    "production_ms": t["fwd_prod"]},
                "bi_lstm_bwd": {
                    "max_abs_err": e_dxw, "ms": t["bwd"],
                    "plain_ms": t["bwd_plain"], "library_ms": None,
                    **_bound(_nbytes(xw, mask, whq, rys, rcs, dys, dxw, dwh),
                             bwd_ops, dtype),
                    "design": {k: design[k] for k in ("gemm", "loop", "dwh")},
                    "layer_route_ms": t["bwd_route"],
                    "production_ms": t["bwd_prod"]},
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


# --- int8 ------------------------------------------------------------------
# (B, W): a service batch at max_batch of the W=512 bucket, and the widest
# bucket at 2**21 pixels
INT8_TIMED = ((128, 512), (32, 2048))
INT8_ODD = (3, 32, 37, 5, 24)  # (B, H, W, CI, CO)
INT8_OPS_PER_S = 1979e12  # the int8 tensor cores, dense
MARGIN, MAX_FLIP_SHARE = 0.15, 0.05  # tests/test_quant.py's margin gate
DESKEW_ANGLES = (-3.0, -1.5, 2.0, 4.0)


def _padded_batch(lines, dev):
    """(images [B, 32, W], widths) of lines, W the longest rounded up to
    a multiple of 128."""
    import torch

    W = -(-max(x.shape[1] for x in lines) // 128) * 128
    images = np.full((len(lines), 32, W), 255, np.uint8)
    for i, x in enumerate(lines):
        images[i, :, :x.shape[1]] = x
    widths = np.array([x.shape[1] for x in lines], np.int32)
    return torch.from_numpy(images).to(dev), torch.from_numpy(widths).to(dev)


def int8_stack_steps(qs, images, widths, cfg, prefix: int = 0):
    """The int8 stack's convs as ``quantized_conv_features`` runs them
    (``quant.conv_plan`` with ``prefix`` float convs): [(name, x, ws,
    kwargs)], x each int8 conv's input (the preprocess output or the
    float prefix's activation, then the int8 activation the conv before
    wrote), ws its weights, scale and bias, and kwargs the rest of its
    ``int8_conv_fused`` call."""
    from vistaocr_tpu_torch.models import quant
    from vistaocr_tpu_torch.ops import int8_conv as ic
    from vistaocr_tpu_torch.ops.preprocess import preprocess_images

    x = preprocess_images(images, widths, standardize=cfg.standardize_input,
                          dtype=cfg.dtype)
    steps = []
    for step in quant.conv_plan(cfg, prefix):
        if step[0] == "pool":
            x = quant._nhwc_pool(x, step[1], cfg.conv_pool)
            continue
        c = qs.convs[step[1]]
        if step[0] == "float":
            x = quant._float_conv(x, qs.fkernels[step[1]], c.bias, cfg.dtype)
            continue
        kw = dict(inv_s=c.inv_s, dtype=cfg.dtype, window=step[2],
                  pool_impl=cfg.conv_pool,
                  inv_s_next=qs.convs[step[1] + 1].inv_s if step[3] else None)
        steps.append((f"conv{step[1]}", x, (c.weight, c.scale, c.bias), kw))
        x = ic.int8_conv_fused(x, c.weight, c.scale, c.bias, **kw)
    return steps


def float_conv_inputs(qs, images, widths, cfg) -> list:
    """Each conv's input on the float path (folded kernels, the stage's
    pool), NCHW: the real activations the cuDNN yardstick convolves."""
    from vistaocr_tpu_torch.models import quant
    from vistaocr_tpu_torch.ops.preprocess import preprocess_images

    x = preprocess_images(images, widths, standardize=cfg.standardize_input,
                          dtype=cfg.dtype)
    ins = []
    for step in quant.conv_plan(cfg, len(qs.convs)):
        if step[0] == "pool":
            x = quant._nhwc_pool(x, step[1], cfg.conv_pool)
            continue
        ins.append(x.permute(0, 3, 1, 2).contiguous())
        x = quant._float_conv(x, qs.fkernels[step[1]], qs.convs[step[1]].bias,
                              cfg.dtype)
    return ins


def int_mm_conv(x, wp, scale, bias, *, inv_s=None, dtype=None,
                window=(1, 1), pool_impl="max", inv_s_next=None):
    """A fused int8 conv from library calls: the quantize (a float x),
    ``F.unfold`` columns, ``torch._int_mm`` (exact int32 sums, K
    zero-padded to a multiple of 8), the epilogue, the pool and the next
    quantize. A yardstick; the port never calls it."""
    import torch
    import torch.nn.functional as F
    from vistaocr_tpu_torch.ops import int8_conv as ic

    B, H, W, ci = x.shape
    co = wp.shape[0]
    xq = x if x.dtype == torch.int8 else ic.quantize_ref(x, inv_s)
    cols = F.unfold(xq.permute(0, 3, 1, 2).to(torch.float32), 3,
                    padding=1)  # k = (c, kh, kw)
    k8 = -(-9 * ci // 8) * 8
    a = torch.zeros((B * H * W, k8), dtype=torch.int8, device=x.device)
    a[:, : 9 * ci] = cols.transpose(1, 2).reshape(B * H * W, 9 * ci)
    w = torch.zeros((k8, co), dtype=torch.int8, device=x.device)
    w[: 9 * ci] = ic._unpack(wp, ci).reshape(co, 9 * ci).t()
    acc = torch._int_mm(a, w).reshape(B, H, W, co)
    y = ic.pool_ref(ic.epilogue_ref(acc, scale, bias, dtype or x.dtype),
                    window, pool_impl)
    return y if inv_s_next is None else ic.quantize_ref(y, inv_s_next)


def _int8_bound(x, y, ws) -> dict:
    """A fused conv's least time: the bytes of its input, packed weights,
    scale, bias and output at 3.35 TB/s against its int8 operations at
    1,979 TOP/s, the larger."""
    ops = 2.0 * x.shape[0] * x.shape[1] * x.shape[2] * ws[0].shape[0] \
        * 9 * x.shape[3]
    t_ops = ops / INT8_OPS_PER_S * 1e3
    t_bytes = _nbytes(x, y, *ws) / HBM_BYTES_PER_S * 1e3
    return {"ops": ops, "bytes": _nbytes(x, y, *ws),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _check_int8_steps(steps, where: str) -> dict:
    """Each step of ``int8_stack_steps``: the kernel bit-equal to its
    plain version and across two runs. Returns {name: (y, max |err|)}."""
    import torch
    from vistaocr_tpu_torch.ops import int8_conv as ic

    out = {}
    for name, x, ws, kw in steps:
        y = ic.int8_conv_fused(x, *ws, **kw)
        ref = ic.int8_conv_fused_ref(x, *ws, **kw)
        err = (y.float() - ref.float()).abs().max().item()
        _require(torch.equal(y, ref) and torch.equal(
            y, ic.int8_conv_fused(x, *ws, **kw)),
            f"int8 conv {name} {where} ({x.dtype} in, {y.dtype} out): "
            f"bit-equal to its plain version and across runs (max |err| "
            f"{err})")
        out[name] = (y, err)
    return out


def _int8_conv_row(x, y, ws, kw, err, fk) -> dict:
    """A fused conv timed beside its bound, its plain version,
    ``int_mm_conv`` (checked equal) and cuDNN's bf16 conv with the folded
    float kernel ``fk`` on the float path's input to the same conv."""
    import torch
    import torch.nn.functional as F
    from vistaocr_tpu_torch.ops import int8_conv as ic

    _require(torch.equal(int_mm_conv(x[0], *ws, **kw), y),
             "_int_mm + unfold equal to the kernel")
    return {
        "shape": [*x[0].shape, ws[0].shape[0]], "in": str(x[0].dtype),
        "out": str(y.dtype), "window": list(kw["window"]),
        "design": ic.conv_design(x[0].shape[-1], ws[0].shape[0], y.dtype,
                                 kw["window"]),
        "max_abs_err": err,
        "ms": _cuda_ms(lambda: ic.int8_conv_fused(x[0], *ws, **kw), 10),
        "plain_ms": _cuda_ms(lambda: ic.int8_conv_fused_ref(x[0], *ws, **kw),
                             1),
        **_int8_bound(x[0], y, ws),
        "library_ms": _cuda_ms(lambda: int_mm_conv(x[0], *ws, **kw), 3),
        "library_call": "quantize + F.unfold + torch._int_mm + epilogue + "
                        "pool + quantize",
        "cudnn_bf16_ms": _cuda_ms(lambda: F.conv2d(x[1], fk, padding=1), 10)}


def _quantize_row(x, inv_s: float) -> dict:
    """The quantize pass (``ic.quantize``) on a float prefix's real
    activation: bit-equal to ``quantize_ref``, to one library expression
    and across runs, timed beside them and its bound (each input byte
    read once, each int8 written once, at 3.35 TB/s)."""
    import torch
    from vistaocr_tpu_torch.ops import int8_conv as ic

    q = ic.quantize(x, inv_s)
    ref = ic.quantize_ref(x, inv_s)

    def library():
        return torch.round(x.float() * inv_s).clamp(-127, 127).to(torch.int8)

    err = (q.float() - ref.float()).abs().max().item()
    _require(torch.equal(q, ref) and torch.equal(q, library())
             and torch.equal(q, ic.quantize(x, inv_s)),
             f"int8 quantize of {x.dtype} {tuple(x.shape)}: bit-equal to "
             f"quantize_ref, to the library expression and across runs "
             f"(max |err| {err})")
    nbytes = _nbytes(x, q)
    return {"shape": list(x.shape), "in": str(x.dtype), "max_abs_err": err,
            "ms": _cuda_ms(lambda: ic.quantize(x, inv_s), 20),
            "plain_ms": _cuda_ms(lambda: ic.quantize_ref(x, inv_s), 10),
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": _cuda_ms(library, 10),
            "library_call": "torch.round(x.float() * inv_s).clamp(-127, "
                            "127).to(torch.int8)"}


def int8_kernel_rows(dev, raw: dict, cfg, font, smi: str) -> dict:
    """The int8 stack's kernels on glyph lines, each kernel against its
    plain version (bit-equal, and two runs bit-equal, ``_check_int8_steps``):
    - ``int8_conv`` itself at the whole ``INT8_ODD`` shape (CI=5: the
      direct kernel), and each conv of the stack (``int8_stack_steps``)
      at B=3, W=37 (odd W past every tile edge);
    - at both ``INT8_TIMED`` shapes, each conv of the stack with no float
      prefix (``convs``: timed by ``_int8_conv_row``), and the whole stack
      (``quantized_conv_features``: preprocess and the six launches)
      beside the float path's folded cuDNN stack and the stack's bound
      (its convs' bytes, each int8 activation written once and read once,
      against its operations);
    - at both, each conv of the stack under ``float_prefix=2``
      (``prefix2``): the quantize pass on the prefix's real activation
      (``_quantize_row``) and the first int8 conv, fed that float
      activation (quantize pass + tc kernel), timed as above;
    - in float32 at the first timed shape, every conv at prefixes 0 and 2
      and the quantize pass (``f32``: max |err| a conv).
    Returns {"convs": {(B, W): {conv: row, "stack": row}}, "prefix2":
    {(B, W): {"quantize": row, conv: row}}, "f32": {name: err}}."""
    import dataclasses

    import torch
    from vistaocr_tpu_torch.models import quant
    from vistaocr_tpu_torch.ops import int8_conv as ic

    qs = quant.QuantizedStack(raw, dev, cfg.dtype)
    rng = np.random.default_rng(5)
    B, H, W, ci, co = INT8_ODD
    odd = (torch.from_numpy(rng.normal(0, 1, (B, H, W, ci)).astype(
        np.float32)).to(dev, cfg.dtype),
        ic.pack_weights(torch.from_numpy(rng.integers(
            -127, 128, (co, ci, 3, 3)).astype(np.int8))).to(dev),
        torch.from_numpy(rng.uniform(1e-4, 1e-3, co).astype(
            np.float32)).to(dev),
        torch.zeros(co, device=dev), 42.0)
    got = ic.int8_conv(*odd)
    _require(torch.equal(got, ic.int8_conv_ref(*odd))
             and torch.equal(got, ic.int8_conv(*odd)),
             f"int8 conv bit-equal at the odd shape {INT8_ODD}")
    rows: dict = {}
    pre2: dict = {}
    f32: dict = {}
    for B, W in ((INT8_ODD[0], INT8_ODD[2]),) + INT8_TIMED:
        timed = (B, W) in INT8_TIMED
        lines = [img for img, _ in glyph_lines(
            font, np.random.default_rng(B + W), B, W // 2, W)]
        images, widths = _padded_batch(lines, dev)
        if not timed:  # W exactly, not rounded up to the bucket
            images = images[:, :, :W].contiguous()
            widths = widths.clamp(max=W)
        where = f"at B={B} W={W}"
        steps = int8_stack_steps(qs, images, widths, cfg)
        checked = _check_int8_steps(steps, where)
        if not timed:
            rows[(B, W)] = {n: {"shape": list(steps[k][1].shape),
                                "max_abs_err": checked[n][1]}
                            for k, n in enumerate(checked)}
            continue
        fins = float_conv_inputs(qs, images, widths, cfg)
        rows[(B, W)] = {}
        for name, x, ws, kw in steps:
            k = int(name[4:])
            y, err = checked[name]
            rows[(B, W)][name] = _int8_conv_row((x, fins[k]), y, ws, kw, err,
                                                qs.fkernels[k])
        del steps, checked
        convs = list(rows[(B, W)].values())
        t_ops = sum(r["ops"] for r in convs) / INT8_OPS_PER_S * 1e3
        t_bytes = sum(r["bytes"] for r in convs) / HBM_BYTES_PER_S * 1e3
        rows[(B, W)]["stack"] = {
            "ms": _cuda_ms(lambda: quant.quantized_conv_features(
                qs, images, widths, cfg), 10),
            "float_stack_ms": _cuda_ms(lambda: quant.folded_conv_features(
                qs.fkernels, [c.bias for c in qs.convs], images, widths, cfg),
                10),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        # float_prefix=2: the quantize pass and the float-fed first int8 conv
        steps = int8_stack_steps(qs, images, widths, cfg, 2)
        checked = _check_int8_steps(steps, where + " under float_prefix=2")
        name, x, ws, kw = steps[0]
        k = int(name[4:])
        pre2[(B, W)] = {
            "quantize": _quantize_row(x, kw["inv_s"]),
            name: _int8_conv_row((x, fins[k]), checked[name][0], ws, kw,
                                 checked[name][1], qs.fkernels[k]),
            "checked": {n: e for n, (_, e) in checked.items()}}
        _require(pre2[(B, W)][name]["design"] == "tc",
                 f"the first int8 conv under float_prefix=2 ({name}) takes "
                 f"the tc kernel behind the quantize pass")
        del steps, checked, fins
        st, qr, c2 = (rows[(B, W)]["stack"], pre2[(B, W)]["quantize"],
                      pre2[(B, W)][name])
        print(f"int8 convs at B={B} W={W} ({smi}): " + "; ".join(
                f"{n} {r['ms']:.4f} ms ({r['design']}, bound "
                f"{r['bound_ms']:.4f}, _int_mm {r['library_ms']:.4f}, "
                f"cuDNN bf16 on the float path's input "
                f"{r['cudnn_bf16_ms']:.4f})"
                for n, r in rows[(B, W)].items() if n != "stack")
              + f"; the stack {st['ms']:.4f} ms (bound {st['bound_ms']:.4f},"
              f" the float path's cuDNN stack {st['float_stack_ms']:.4f}); "
              f"float_prefix=2: quantize pass {qr['ms']:.4f} ms (bound "
              f"{qr['bound_ms']:.4f}, plain {qr['plain_ms']:.4f}, library "
              f"{qr['library_ms']:.4f}), {name} fed the float activation "
              f"{c2['ms']:.4f} ms (bound {c2['bound_ms']:.4f}, cuDNN bf16 "
              f"{c2['cudnn_bf16_ms']:.4f})", flush=True)
        if (B, W) == INT8_TIMED[0]:  # float32, checked only
            cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
            qs32 = quant.QuantizedStack(raw, dev, torch.float32)
            for prefix in (0, 2):
                steps = int8_stack_steps(qs32, images, widths, cfg32, prefix)
                checked = _check_int8_steps(
                    steps, f"{where} in float32, float_prefix={prefix}")
                f32.update({f"{n}_prefix{prefix}": e
                            for n, (_, e) in checked.items()})
                if prefix:
                    f32["quantize"] = _quantize_row(
                        steps[0][1], steps[0][3]["inv_s"])["max_abs_err"]
                del steps, checked
            del qs32
            print(f"int8 float32 at B={B} W={W}: every conv at prefixes 0 "
                  f"and 2 and the quantize pass bit-equal ({f32})",
                  flush=True)
    return {"convs": rows, "prefix2": pre2, "f32": f32}


def _margin_gate(ref_lp, lp, fm) -> dict:
    """tests/test_quant.py:114-139 on the posteriors: no argmax flip on a
    frame whose float top-2 margin exceeds MARGIN, flips on at most
    MAX_FLIP_SHARE of the valid frames."""
    import torch

    top2 = torch.topk(ref_lp.float().exp(), 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    flip = fm & (lp.argmax(-1) != ref_lp.argmax(-1))
    return {"confident_flips": int((flip & (margin > MARGIN)).sum()),
            "flips": int(flip.sum()), "valid_frames": int(fm.sum()),
            "nonblank_frames": int((fm & (ref_lp.argmax(-1) != 0)).sum()),
            "max_prob_drift": float((lp.float().exp() - ref_lp.float().exp()
                                     ).abs()[fm].max())}


def _spy_forward(svc) -> list:
    """Record each batch that ``svc.ocr_lines`` dispatches: its count of
    real rows (the rest are pad slots), its model input and its
    posteriors, by wrapping ``_assemble_chunk``, ``_forward`` and
    ``_decode_tail`` on the instance (``ocr_lines`` assembles and
    dispatches each chunk in turn in the caller's thread, the tail inside
    the forward). Returns the list of [rows, images, widths, log_probs,
    frame_mask] it appends to; ``del svc._assemble_chunk, svc._forward,
    svc._decode_tail`` ends it."""
    seen: list = []
    rows: list = []
    assemble, forward, tail = (svc._assemble_chunk, svc._forward,
                               svc._decode_tail)

    def spy_assemble(bucket_idx, chunk, raw):
        rows.append(len(chunk))
        return assemble(bucket_idx, chunk, raw)

    def spy_forward(images, widths, *shard):
        seen.append([rows.pop(0), images.clone(), widths.clone()])
        return forward(images, widths, *shard)

    def spy_tail(lp, fm, *shard):
        seen[-1] += [lp.clone(), fm.clone()]
        return tail(lp, fm, *shard)

    svc._assemble_chunk, svc._forward, svc._decode_tail = (
        spy_assemble, spy_forward, spy_tail)
    return seen


def _service_gate(svc, seen: list, prefix: int) -> dict:
    """Each recorded batch of an int8 service: its posteriors bit-equal to
    ``quantized_forward`` on the same batch, its frame mask equal to the
    float model's, and ``_margin_gate`` of its real rows against the float
    model's posteriors, summed over the batches."""
    import torch
    from vistaocr_tpu_torch.models import quant

    parts = []
    with torch.inference_mode():
        for n, images, widths, lp, fm in seen:
            qlp, qfm = quant.quantized_forward(svc.model, svc._qstack, images,
                                               widths, float_prefix=prefix)
            ref_lp, ref_fm = svc.model(images, widths)
            _require(torch.equal(qlp, lp) and torch.equal(qfm, fm)
                     and torch.equal(ref_fm, fm) and torch.isfinite(lp).all(),
                     "int8 service posteriors finite and bit-equal to "
                     "quantized_forward on the same batch (max |diff| "
                     f"{(qlp - lp).abs().max().item()}), frame masks equal")
            parts.append(_margin_gate(ref_lp[:n], lp[:n], fm[:n]))
    g = {k: sum(p[k] for p in parts) for k in (
        "confident_flips", "flips", "valid_frames", "nonblank_frames")}
    g["max_prob_drift"] = max(p["max_prob_drift"] for p in parts)
    g["flip_share"] = g["flips"] / g["valid_frames"]
    g["batches_checked"] = len(parts)
    return g


def _edits(a: str, b: str) -> int:
    """Edit distance, the common prefix and suffix stripped first."""
    from vistaocr_tpu_torch.text import levenshtein

    i = 0
    while i < min(len(a), len(b)) and a[i] == b[i]:
        i += 1
    j = 0
    while j < min(len(a), len(b)) - i and a[-1 - j] == b[-1 - j]:
        j += 1
    return levenshtein(a[i:len(a) - j], b[i:len(b) - j])


def int8_service_run(snap: str, kw: dict, lines, dev, n_convs: int,
                     layers: int) -> tuple:
    """One ``OcrService(max_batch=128)`` over ``lines``: a warm call (for
    an int8 service recorded by ``_spy_forward``), then the counters of
    both kernels set to 0 around a timed call: the int8 conv ``n_convs -
    quantize_float_prefix`` launches a batch (none in float), K1
    (``lstm_fwd_persistent``) one a BLSTM layer and batch, and no other
    form of the forward recurrence. Returns (row, texts)."""
    import torch
    from vistaocr_tpu_torch.models import quant
    from vistaocr_tpu_torch.ops import int8_conv as ic, lstm_cuda
    from vistaocr_tpu_torch.serve import OcrService, ServiceConfig

    int8 = kw.get("quantize") == "int8"
    prefix = kw.get("quantize_float_prefix", 0)
    svc = OcrService(snap, ServiceConfig(max_batch=128, max_wait_ms=2.0,
                                         **kw), device=dev)
    try:
        seen = _spy_forward(svc) if int8 else None
        svc.ocr_lines(lines)  # warm (the beam: captures its graphs)
        if int8:
            del svc._assemble_chunk, svc._forward, svc._decode_tail
        ic.LAUNCHES = ic.QUANTIZE_LAUNCHES = 0
        for name in ("LAUNCHES", "FWD_GRID_LAUNCHES", "STEP_LAUNCHES"):
            setattr(lstm_cuda, name, 0)
        b0 = svc.stats["batches"]
        t0 = time.time()
        res = svc.ocr_lines(lines)
        dt = time.time() - t0
        launches, k1 = ic.LAUNCHES, lstm_cuda.LAUNCHES
        passes = ic.QUANTIZE_LAUNCHES
        other_forms = lstm_cuda.FWD_GRID_LAUNCHES + lstm_cuda.STEP_LAUNCHES
        batches = svc.stats["batches"] - b0
        gate = _service_gate(svc, seen, prefix) if int8 else None
        # one quantize pass a batch where the first int8 conv after a
        # float prefix takes the tc kernel (it quantizes no input itself)
        expect_q = 0
        if int8 and prefix:
            cfg = svc.model.config
            step = [t for t in quant.conv_plan(cfg, prefix)
                    if t[0] == "int8"][0]
            ci, co = svc._qstack.fkernels[step[1]].shape[:2][::-1]
            expect_q = batches * (ic.conv_design(
                ci, co, torch.int8 if step[3] else cfg.dtype,
                step[2]) == "tc")
    finally:
        svc.close()
    _require(len(res) == len(lines) and all(
        0 < r.confidence <= 1 for r in res), f"{kw}: every line scored")
    expect = (n_convs - prefix) * batches * int8
    _require(launches == expect and batches > 0 and passes == expect_q,
             f"{kw}: {launches} int8 conv launches, {expect} expected; "
             f"{passes} quantize passes, {expect_q} expected")
    _require(k1 == layers * batches and other_forms == 0,
             f"{kw}: {k1} K1 launches ({other_forms} not persistent), "
             f"{layers * batches} persistent expected")
    row = {"lines_per_s": len(lines) / dt, "seconds": dt, "batches": batches,
           "int8_launches": launches, "launches_per_batch": launches / batches,
           "quantize_passes": passes,
           "k1_launches": k1, "k1_launches_per_batch": k1 / batches}
    if gate is not None:
        _require(gate["confident_flips"] == 0
                 and gate["flips"] <= MAX_FLIP_SHARE * gate["valid_frames"],
                 f"int8 margin gate on the service's posteriors ({kw}): "
                 f"{gate}")
        row["margin_gate"] = gate
    return row, [r.text for r in res]


INT8_TURNS = 10  # timed calls of each service in int8_service_turns


def int8_service_turns(snap: str, lines, dev, reps: int = INT8_TURNS) -> dict:
    """Warm lines/s of the bf16 and the int8 greedy ``OcrService`` on the
    same lines, in turns: both open at once and warmed, then ``reps``
    calls of each, alternating, each call timed on the host clock from a
    synchronized card to its results. Returns each route's calls and
    their median, least and most lines/s, and the int8/bf16 ratio of
    each turn's pair."""
    import torch
    from vistaocr_tpu_torch.serve import OcrService, ServiceConfig

    svcs = {tag: OcrService(snap, ServiceConfig(max_batch=128,
                                                max_wait_ms=2.0, **kw),
                            device=dev)
            for tag, kw in (("bf16", {}), ("int8", dict(quantize="int8")))}
    rates: dict = {tag: [] for tag in svcs}
    try:
        for svc in svcs.values():
            svc.ocr_lines(lines)  # warm
        for _ in range(reps):
            for tag, svc in svcs.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                svc.ocr_lines(lines)
                rates[tag].append(len(lines) / (time.perf_counter() - t0))
    finally:
        for svc in svcs.values():
            svc.close()
    out = {tag: {"lines_per_s": r, "median": float(np.median(r)),
                 "min": min(r), "max": max(r)} for tag, r in rates.items()}
    ratio = [a / b for a, b in zip(rates["int8"], rates["bf16"])]
    out["int8_over_bf16"] = {"per_turn": ratio,
                             "median": float(np.median(ratio)),
                             "min": min(ratio), "max": max(ratio)}
    out["lines"], out["calls_each"] = len(lines), reps
    return out


def int8_phase(dev, snap: str, data: str, font: dict, smi: str) -> dict:
    """int8 on phase 7's flagship snapshot: (a) the port's writer
    calibrates on 4 glyph train batches and writes ``qstack.msgpack``,
    read back; (b) ``int8_kernel_rows``; (c) ``int8_service_run`` of the
    bf16 service and of ``OcrService(max_batch=128, quantize="int8")``
    with ``quantize_float_prefix`` 0 and 2, greedy, and the device beam,
    on 128 glyph lines, for phase 7's snapshot and for the seeded
    random-init flagship: both kernels' launches counted, warm lines/s,
    the service's own posteriors held to ``quantized_forward`` and to the
    margin gate, and the greedy strings' edits from bf16's bounded, then
    the bf16 and int8 greedy services in turns on the random-init
    flagship (``int8_service_turns``: lines/s and its spread); (d)
    ``run_inference`` greedy, int8 and bf16: lines/s, CER and both
    kernels' launches; (e) ``normalize_line(do_deskew=True)`` on
    glyph lines rotated by known angles (host deskew without PIL)."""
    from vistaocr_tpu_torch import infer
    from vistaocr_tpu_torch.checkpoint import load_model
    from vistaocr_tpu_torch.data import transforms
    from vistaocr_tpu_torch.models import quant
    from vistaocr_tpu_torch.ops import int8_conv as ic, lstm_cuda

    t_phase = time.time()
    out: dict = {}
    # (a) the writer
    t0 = time.time()
    path = quant.quantize_snapshot(snap, data, calib_batches=4, device=dev)
    raw = quant.load_qstack(snap)
    model, _, _ = load_model(snap, dev)
    cfg = model.config
    n = sum(st.num_convs for st in cfg.stages)
    _require(set(raw) == {"kernels", "fkernels", "wscales", "biases",
                          "in_scales"} and all(len(v) == n
                                               for v in raw.values()),
             f"qstack read back: {n} convs of each field")
    for wq, fk, s in zip(raw["kernels"], raw["fkernels"], raw["in_scales"]):
        _require(wq.dtype == np.int8 and wq.shape == fk.shape
                 and np.abs(wq).max() == 127 and np.isfinite(s) and s > 0,
                 f"qstack conv: int8 {wq.shape}, scale {s}")
    out["qstack"] = {"seconds": round(time.time() - t0, 3),
                     "bytes": os.path.getsize(path),
                     "in_scales": [float(s) for s in raw["in_scales"]]}
    print(f"int8 (a): qstack written and read back {out['qstack']}",
          flush=True)
    # (b) each kernel against its plain version, timed
    out.update(int8_kernel_rows(dev, raw, cfg, font, smi))
    # (c) the service, on phase 7's snapshot (40 steps: its frames may be
    # all blank) and on the seeded random-init flagship (phase 4's
    # snapshot: no frame is blank-bound), its qstack calibrated here
    lines = [img for img, _ in glyph_lines(font, np.random.default_rng(47),
                                           128, 40, 2048)]
    routes = (("bf16", {}), ("int8", dict(quantize="int8")),
              ("int8_prefix2", dict(quantize="int8",
                                    quantize_float_prefix=2)),
              ("int8_device_beam", dict(quantize="int8", decoder="beam",
                                        warmup=False)))
    svc_out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        flagship_snapshot(tmp)
        rmodel, _, _ = load_model(tmp, dev)
        quant.save_qstack(tmp, quant.quantize_model(
            rmodel, quant.calibration_batches(data, tmp)))
        del rmodel
        for snap_tag, path in (("", snap), ("_random_init", tmp)):
            greedy: dict = {}
            for tag, kw in routes:
                row, texts = int8_service_run(path, kw, lines, dev, n,
                                              cfg.lstm_layers)
                if tag != "int8_device_beam":
                    greedy[tag] = texts
                    row["nonempty_strings"] = sum(bool(t) for t in texts)
                svc_out[tag + snap_tag] = row
            # greedy strings against bf16's: each flipped frame moves a
            # greedy string by at most 2 edits, so the margin gate's flip
            # share bounds the edits by 2 * MAX_FLIP_SHARE of the frames
            for tag in ("int8", "int8_prefix2"):
                row = svc_out[tag + snap_tag]
                edits = sum(_edits(a, b) for a, b in zip(greedy[tag],
                                                         greedy["bf16"]))
                frames = row["margin_gate"]["valid_frames"]
                row["greedy_equal_to_bf16"] = float(np.mean(
                    [a == b for a, b in zip(greedy[tag], greedy["bf16"])]))
                row["greedy_edits_to_bf16"] = edits
                row["greedy_edits_per_frame"] = edits / frames
                _require(edits <= 2 * MAX_FLIP_SHARE * frames,
                         f"{tag}{snap_tag}: {edits} edits from bf16's greedy "
                         f"strings over {frames} frames")
        turns = int8_service_turns(tmp, lines, dev)
    out["launches"] = svc_out["int8"]["int8_launches"]
    out["quantize_launches"] = svc_out["int8_prefix2_random_init"][
        "quantize_passes"]
    out["service"] = svc_out
    out["service_turns"] = turns
    print(f"int8 (c) service, 128 glyph lines ({smi}): "
          + json.dumps(svc_out), flush=True)
    print(f"int8 (c) greedy service in turns on the random-init flagship "
          f"({smi}): " + json.dumps(turns), flush=True)
    # (d) offline inference on the glyph validation split, both kernels'
    # counters set to 0 around the timed run
    inf: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, kw in (("bf16", {}), ("int8", dict(quantize="int8"))):
            msgs = []
            infer.run_inference(snap, data, "val", device=dev,
                                log=msgs.append, **kw)  # warm
            ic.LAUNCHES = 0
            for name in ("LAUNCHES", "FWD_GRID_LAUNCHES", "STEP_LAUNCHES"):
                setattr(lstm_cuda, name, 0)
            rep = infer.run_inference(
                snap, data, "val", device=dev, log=msgs.append,
                out_path=os.path.join(tmp, f"{tag}.jsonl"), **kw)
            launches, k1 = ic.LAUNCHES, lstm_cuda.LAUNCHES
            other_forms = (lstm_cuda.FWD_GRID_LAUNCHES
                           + lstm_cuda.STEP_LAUNCHES)
            _require(rep.get("quantize") == kw.get("quantize") and (
                tag == "bf16" or "int8 PTQ: loaded stored qstack from "
                "snapshot" in msgs), f"infer {tag}: {rep}")
            # a batch: n int8 launches (none in bf16), one K1 a layer
            _require(k1 > 0 and k1 % cfg.lstm_layers == 0
                     and other_forms == 0 and launches == (
                         n * k1 // cfg.lstm_layers if tag == "int8" else 0),
                     f"infer {tag}: {launches} int8 and {k1} K1 launches "
                     f"({other_forms} not persistent)")
            inf[tag] = {"lines_per_s": rep["lines_per_sec"],
                        "cer": rep["cer"], "wer": rep["wer"],
                        "lines": rep["lines"], "int8_launches": launches,
                        "k1_launches": k1}
    out["infer"] = inf
    print(f"int8 (d) run_inference ({smi}): {json.dumps(inf)}", flush=True)
    # (e) host deskew with PIL made unimportable for the duration
    saved = {k: sys.modules.pop(k) for k in list(sys.modules)
             if k == "PIL" or k.startswith("PIL.")}
    sys.modules["PIL"] = None  # `import PIL` raises ImportError
    skew = []
    try:
        for (img, _), angle in zip(
                glyph_lines(font, np.random.default_rng(53),
                            len(DESKEW_ANGLES), 300, 900), DESKEW_ANGLES):
            rot = transforms._rotate(img, angle, expand=True, fillcolor=255)
            est = transforms.estimate_skew(rot)
            norm = transforms.normalize_line(rot, 32, do_deskew=True)
            _require(norm.shape[0] == 32 and norm.dtype == np.uint8
                     and abs(est + angle) <= 0.5,
                     f"deskew of a line rotated by {angle}: estimate {est}")
            skew.append({"angle": angle, "estimate": est,
                         "out_shape": list(norm.shape)})
    finally:
        del sys.modules["PIL"]
        sys.modules.update(saved)
    out["deskew"] = {"pil_blocked": True, "lines": skew}
    out["seconds"] = time.time() - t_phase
    print(f"int8 (e) host deskew: {json.dumps(out['deskew'])}; int8 phase "
          f"{out['seconds']:.1f} s", flush=True)
    return out


def int8_row(int8_out: dict) -> dict:
    """The kernels line's row: one service batch's six launches at
    B=128, W=512 summed (each conv and the whole stack at both timed
    shapes beside it)."""
    per = {n: r for n, r in int8_out["convs"][INT8_TIMED[0]].items()
           if n != "stack"}
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "cudnn_bf16_ms")
    total = {k: sum(r[k] for r in per.values()) for k in keys}
    return {
        "name": "int8_conv", "route": "cuda",
        "source": "vistaocr_tpu_torch/csrc/int8_conv.cu",
        "replaces": "vistaocr_tpu/models/quant.py:214 (XLA int8 conv in "
                    "JAX; not a TPU kernel)",
        "launches": int8_out["launches"],
        "max_abs_err": max(
            [r["max_abs_err"] for rows in int8_out["convs"].values()
             for n, r in rows.items() if n != "stack"]
            + [e for rows in int8_out["prefix2"].values()
               for e in rows["checked"].values()]
            + list(int8_out["f32"].values())),
        **total,
        "bound_by": ("bytes" if sum(r["bound_by"] == "bytes"
                                    for r in per.values()) * 2 >= len(per)
                     else "operations"),
        "library_call": "quantize + F.unfold + torch._int_mm + epilogue + "
                        "pool + quantize",
        "form": "the six fused convs of one batch at B=128, W=512, summed",
        "stack": {f"B{B}_W{W}": rows["stack"]
                  for (B, W), rows in int8_out["convs"].items()
                  if "stack" in rows},
        "convs": {f"B{B}_W{W}": rows
                  for (B, W), rows in int8_out["convs"].items()},
        "prefix2": {f"B{B}_W{W}": rows
                    for (B, W), rows in int8_out["prefix2"].items()},
        "f32_max_abs_err": int8_out["f32"],
        "service": int8_out["service"],
        "service_turns": int8_out["service_turns"],
        "infer": int8_out["infer"],
        "qstack": int8_out["qstack"], "deskew": int8_out["deskew"],
        "phase_seconds": int8_out["seconds"]}


def int8_quantize_row(int8_out: dict) -> dict:
    """The kernels line's row of the quantize pass: its launches in the
    ``float_prefix=2`` service run (one a batch, in front of the first
    int8 conv), timed at B=128, W=512 (the other timed shape beside
    it)."""
    row = int8_out["prefix2"][INT8_TIMED[0]]["quantize"]
    _require(int8_out["quantize_launches"] > 0,
             "the float_prefix=2 service launched the quantize pass")
    return {
        "name": "int8_quantize", "route": "cuda",
        "source": "vistaocr_tpu_torch/csrc/int8_conv.cu",
        "replaces": "vistaocr_tpu/models/quant.py:210 (the activation "
                    "quantize, XLA in JAX; not a TPU kernel)",
        "launches": int8_out["quantize_launches"],
        **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms", "library_call")},
        "form": "the first int8 conv's input under float_prefix=2, B=128, "
                "W=512",
        "shapes": {f"B{B}_W{W}": rows["quantize"]
                   for (B, W), rows in int8_out["prefix2"].items()}}


def main(argv) -> int:
    ctc_only = argv == ["--ctc"]
    int8_only = argv == ["--int8"]
    http_only = argv == ["--http"]
    dp_only = argv == ["--dp"]
    fused_only = argv == ["--fused"]
    beam_only = argv == ["--beam"]
    experiments_only = argv == ["--experiments"]
    if argv and not (ctc_only or int8_only or http_only or dp_only
                     or fused_only or beam_only or experiments_only):
        print("usage: chip_smoke.py [--ctc | --int8 | --http | --dp | "
              "--fused | --beam | --experiments]", file=sys.stderr)
        return 2
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
    if ctc_only:
        _phase("train-kernels (CTC only)")
        ctc_rows = ctc_train_kernels(dev, f"{card}, {smi}")
        print(json.dumps({f"B{B}_T{T}": r for (B, T), r in ctc_rows.items()}))
        print(smi)
        return 0
    if http_only:
        with tempfile.TemporaryDirectory() as tmp:
            flagship_snapshot(tmp)
            _phase("http")
            http_out = http_phase(tmp, card, smi)
        print(json.dumps({"http": http_out}))
        print(smi)
        return 0
    if dp_only:
        _phase("dp")
        dp_out = dp_phase(dev, glyph_font(17), smi)
        print(json.dumps({"dp": dp_out}))
        print(smi)
        return 0
    if fused_only:
        font = glyph_font(17)
        with tempfile.TemporaryDirectory() as tmp:
            _phase("fused")
            fused_out = fused_phase(dev, tmp, font, smi)
            fused_out["nccl_cli"] = dp_nccl_cli(tmp, font, smi, fused=True)
        print(json.dumps({"fused": fused_out}))
        print(smi)
        return 0
    if beam_only:
        font = glyph_font(17)
        with tempfile.TemporaryDirectory() as tmp:
            _phase("train")
            train_phase(tmp, font, smi)
            _phase("beam reruns")
            beam_out = beam_reruns(dev, os.path.join(tmp, "run", "last"),
                                   font, smi)
        print(json.dumps({"beam_reruns": beam_out}))
        print(smi)
        return 0
    if experiments_only:
        _phase("experiments")
        stem_rows = stem_experiment_kernels(dev, f"{card}, {smi}")
        bi_rows = bi_experiment_kernels(dev, f"{card}, {smi}")
        exp_counts = experiments_path_phase(dev, glyph_font(17), smi)
        print(json.dumps({"stem": {"_".join(map(str, k)): v
                                   for k, v in stem_rows.items()},
                          "bi": {"_".join(map(str, k)): v
                                 for k, v in bi_rows.items()},
                          "launches": exp_counts}))
        print(smi)
        return 0
    if int8_only:
        font = glyph_font(17)
        with tempfile.TemporaryDirectory() as tmp:
            _phase("train")
            train_phase(tmp, font, smi)
            _phase("int8")
            int8_out = int8_phase(dev, os.path.join(tmp, "run", "last"),
                                  os.path.join(tmp, "glyphs"), font, smi)
        print(json.dumps({"kernels": [int8_row(int8_out),
                                      int8_quantize_row(int8_out)]}))
        print(smi)
        return 0

    _phase("kernel")
    rows = kernel_phase(dev, f"{card}, {smi}")

    with tempfile.TemporaryDirectory() as tmp:
        flagship_snapshot(tmp)
        _phase("service")
        launches = service_phase(tmp, card, smi)
        _phase("http")
        http_out = http_phase(tmp, card, smi)
        _phase("parity")
        parity_phase(tmp, dev)

    _phase("train-kernels")
    lstm_rows = lstm_train_kernels(dev, f"{card}, {smi}")
    dwh_f32_rows = f32_dwh_kernel(dev, f"{card}, {smi}")
    rule_rows = f32_forward_rule_times(dev, f"{card}, {smi}")
    f2_rows = f2_train_kernels(dev, f"{card}, {smi}")
    flagship_f2 = flagship_designs(dev, f"{card}, {smi}")
    ctc_rows = ctc_train_kernels(dev, f"{card}, {smi}")
    font = glyph_font(17)
    with tempfile.TemporaryDirectory() as tmp:
        _phase("train")
        counts, per_step_lps = train_phase(tmp, font, smi)
        # the flagship's bf16 step at the W=2048 bucket (B=32), whose BPTT
        # runs lstm_bwd_persistent twice
        bf16_step = f32_step_timing(f32_step(dev, font, 32, 2048,
                                             "bfloat16"),
                                    f"{card}, {smi}", 32, 2048, "bf16")
        _phase("fused")
        fused_out = fused_phase(dev, tmp, font, smi, per_step_lps)
        print(json.dumps({"fused": fused_out}), flush=True)
        _phase("infer")
        infer_out = infer_phase(dev, os.path.join(tmp, "run", "last"),
                                os.path.join(tmp, "glyphs"), font, smi)
        _phase("service-beam")
        beam_svc, programs = service_beam_phase(
            dev, os.path.join(tmp, "run", "last"),
            os.path.join(tmp, "glyphs"), font, card, smi)
        beam_rows = device_beam_timing(
            dev, f"{card}, {smi}",
            {n: programs[n][:2] for n in ("plain", "char_lm_lexicon_word_lm")},
            programs["plain"][2])
        print(json.dumps({"device_beam": {
            "note": "no TPU kernel: the search is XLA in JAX, plain torch "
                    "in one CUDA graph per shape here",
            "replaces": "vistaocr_tpu/decode/device_beam.py:160",
            "timing": beam_rows, "service": beam_svc,
            "infer": {k: v for k, v in infer_out.items()
                      if "beam" in k}}}), flush=True)
        _phase("int8")
        int8_out = int8_phase(dev, os.path.join(tmp, "run", "last"),
                              os.path.join(tmp, "glyphs"), font, smi)
    _phase("train-parity")
    f32_path = train_parity_phase(dev, font, f"{card}, {smi}")
    f2_counts = f2_path_phase(dev, font, f"{card}, {smi}")
    f2_step = f2_step_timing(dev, font, f"{card}, {smi}")
    _phase("experiments")
    stem_rows = stem_experiment_kernels(dev, f"{card}, {smi}")
    bi_rows = bi_experiment_kernels(dev, f"{card}, {smi}")
    exp_counts = experiments_path_phase(dev, font, smi)
    _phase("dp")
    dp_out = dp_phase(dev, font, smi)
    print(json.dumps({"dp": dp_out}), flush=True)
    _phase("profiles")
    cudnn_phase(dev, f"{card}, {smi}", rows, lstm_rows)
    with tempfile.TemporaryDirectory() as tmp:
        flagship_snapshot(tmp)
        service_profile(tmp, smi)

    def with_f32(row: dict, f32_row: dict) -> dict:
        """A kernel's bf16 numbers, and its f32 ones under f32_ names."""
        return {**row, **{f"f32_{k}": v for k, v in f32_row.items()
                          if k != "bound_by"}}

    kernels = [{
        "name": "lstm_fwd",
        "route": "cuda",
        "source": "vistaocr_tpu_torch/csrc/lstm_fwd.cu",
        "replaces": "vistaocr_tpu/ops/lstm_pallas.py:51",
        "launches": launches,
        "launches_http": http_out["launches_http"],
        **with_f32(rows[FLAGSHIP_SHAPE[:2]][torch.bfloat16],
                   rows[FLAGSHIP_SHAPE[:2]][torch.float32]),
        "at_B512_T32": with_f32(rows[SMALL_BUCKET_SHAPE[:2]][torch.bfloat16],
                                rows[SMALL_BUCKET_SHAPE[:2]][torch.float32]),
        "infer": infer_out,
    }]
    main_shape = (32, 512)  # the W=2048 bucket
    lstm_meta = {
        "lstm_fwd_save_cell": ("lstm_fwd.cu", "lstm_pallas.py:51",
                               "SAVE_CELL_LAUNCHES"),
        "lstm_bwd": ("lstm_bwd.cu", "lstm_pallas.py:281", "BWD_LAUNCHES"),
        "lstm_dwh": ("lstm_bwd.cu", "lstm_pallas.py:264", "DWH_LAUNCHES"),
    }
    for name, (src, rep, counter) in lstm_meta.items():
        row = {"name": name, "route": "cuda",
               "source": f"vistaocr_tpu_torch/csrc/{src}",
               "replaces": f"vistaocr_tpu/ops/{rep}",
               "launches": counts[counter],
               **with_f32(lstm_rows[(*main_shape, torch.bfloat16)][name],
                          lstm_rows[(*main_shape, torch.float32)][name])}
        if name == "lstm_fwd_save_cell":
            row["at_B512_T32"] = with_f32(
                lstm_rows[(*SMALL_BUCKET_SHAPE[:2], torch.bfloat16)][name],
                lstm_rows[(*SMALL_BUCKET_SHAPE[:2], torch.float32)][name])
        if name == "lstm_bwd":
            row["also_replaces"] = "vistaocr_tpu/ops/lstm_pallas.py:334"
            for B, T, _ in LSTM_TRAIN_SHAPES[1:]:
                if (B, T) != main_shape:
                    row[f"at_B{B}_T{T}"] = with_f32(
                        lstm_rows[(B, T, torch.bfloat16)][name],
                        lstm_rows[(B, T, torch.float32)][name])
        kernels.append(row)
    # the f32-weight forward's three designs: launches counted on the f32
    # path (phase 8), numbers from phase 6's save_cell form where the
    # library runs each (lstm_fwd_grid at the W=2048 bucket, lstm_fwd_rows
    # at W=128; lstm_step, off the path since lstm_fwd_rows, at W=128 too),
    # every other bucket and phase 3's inference form beside
    for name, counter, shape in (
            ("lstm_fwd_grid", "FWD_GRID_LAUNCHES", main_shape),
            ("lstm_fwd_rows", "FWD_ROWS_LAUNCHES", SMALL_BUCKET_SHAPE[:2]),
            ("lstm_step", "STEP_LAUNCHES", SMALL_BUCKET_SHAPE[:2])):
        fwd_row = lstm_rows[(*shape, torch.float32)]["lstm_fwd_save_cell"]
        dsg = fwd_row["designs"][name]
        row = {"name": name, "route": "cuda",
               "source": "vistaocr_tpu_torch/csrc/lstm_fwd.cu",
               "replaces": "vistaocr_tpu/ops/lstm_pallas.py:51",
               "launches": f32_path["counts"][counter],
               "max_abs_err": dsg["max_abs_err"], "ms": dsg["ms"],
               "plain_ms": fwd_row["plain_ms"], "bound_ms": dsg["bound_ms"],
               "bound_by": fwd_row["bound_by"], "library_ms": None,
               "form": "save_cell, f32 weights and streams",
               "at": f"B{shape[0]}_T{shape[1]}",
               "per_frame_us": dsg["per_frame_us"],
               "launches_per_call": dsg["launches_per_call"]}
        for B, T, _ in LSTM_TRAIN_SHAPES[1:]:
            if (B, T) != shape:
                row[f"at_B{B}_T{T}"] = lstm_rows[(B, T, torch.float32)][
                    "lstm_fwd_save_cell"]["designs"][name]
        for (B, T), by_dtype in rows.items():
            row[f"inference_at_B{B}_T{T}"] = by_dtype[torch.float32][
                "designs"][name]
        if name != "lstm_step":
            row["rule_times"] = rule_rows
        kernels.append(row)
    # each weight type's two BPTT kernels: bf16 launches counted on the
    # train path (phase 7), f32 on the f32 path (phase 8)
    for name, key, dtype, launches in (
            ("bptt_gates_gemm_wide", "bptt_gates_gemm", torch.bfloat16,
             counts["GATES_WIDE_LAUNCHES"]),
            ("lstm_bwd_persistent", "lstm_bwd_persistent", torch.bfloat16,
             counts["BWD_PERSISTENT_LAUNCHES"]),
            ("bptt_gates_gemm_f32", "bptt_gates_gemm", torch.float32,
             f32_path["counts"]["GATES_GEMM_LAUNCHES"]),
            ("bptt_frame", "bptt_frame", torch.float32,
             f32_path["counts"]["FRAME_LAUNCHES"]),
            ("lstm_bwd_rows", "lstm_bwd_rows", torch.float32,
             f32_path["counts"]["BWD_ROWS_LAUNCHES"]),
            ("bptt_cell", "bptt_cell", torch.float32,
             f32_path["counts"]["CELL_LAUNCHES"]),
            ("bptt_dh", "bptt_dh", torch.float32,
             f32_path["counts"]["DH_LAUNCHES"])):
        # lstm_bwd_rows' own numbers at the W=512 bucket, where it runs
        at = (128, 128) if name == "lstm_bwd_rows" else main_shape
        row = {"name": name, "route": "cuda",
               "source": "vistaocr_tpu_torch/csrc/lstm_bwd.cu",
               "replaces": "vistaocr_tpu/ops/lstm_pallas.py:281",
               "also_replaces": "vistaocr_tpu/ops/lstm_pallas.py:334",
               "launches": launches, "at": "B{}_T{}".format(*at),
               **lstm_rows[(*at, dtype)][key]}
        for B, T, _ in LSTM_TRAIN_SHAPES[1:]:
            if (B, T) != at:
                row[f"at_B{B}_T{T}"] = lstm_rows[(B, T, dtype)][key]
        if dtype == torch.float32:
            row["f32_steps"] = f32_path["steps"]
        if name == "lstm_bwd_persistent":
            row["bf16_step"] = bf16_step
        kernels.append(row)
    # F2's route: bf16 weights above H=512, the forward on lstm_fwd_tc and
    # the frame loop on lstm_bwd_tc, the gate GEMM and dwh on the wide
    # wgmma kernels, with launches counted on F2's main path (phase 8) and
    # times at F2_TIMED (the parent's frame-loop kernels, the f32-weight
    # ones, in lstm_bwd_tc's row)
    for name, src, rep, counter, form in (
            ("lstm_fwd_tc", "lstm_fwd.cu", "lstm_pallas.py:51",
             "FWD_TC_LAUNCHES", "tc"),
            ("bptt_gates_gemm_wide", "lstm_bwd.cu", "lstm_pallas.py:281",
             "GATES_WIDE_LAUNCHES", "wide"),
            ("lstm_bwd_tc", "lstm_bwd.cu", "lstm_pallas.py:281",
             "BWD_TC_LAUNCHES", "tc"),
            ("lstm_dwh", "lstm_bwd.cu", "lstm_pallas.py:264",
             "DWH_LAUNCHES", "wide")):
        kernels.append({
            "name": f"{name}_bf16w_f2", "route": "cuda",
            "source": f"vistaocr_tpu_torch/csrc/{src}",
            "replaces": f"vistaocr_tpu/ops/{rep}",
            "launches": f2_counts[counter],
            "form": {"wide": "bf16 weights above H=512, wgmma in 128 x 256 "
                             "tiles",
                     "tc": "bf16 weights above H=512, mma.sync with wh in "
                           "registers"}[form],
            "at": "B{}_T{}_H{}".format(*F2_TIMED), **f2_rows[name]})
        if name == "lstm_bwd_tc":
            kernels[-1]["also_replaces"] = (
                "vistaocr_tpu/ops/lstm_pallas.py:334")
        if name in ("lstm_fwd_tc", "lstm_bwd_tc"):
            kernels[-1]["f2_train_step"] = f2_step
    # the f32 dwh: launches on the f32 path (phase 8), numbers at each of
    # F32_DWH_SHAPES
    kernels.append({
        "name": "lstm_dwh_fma", "route": "cuda",
        "source": "vistaocr_tpu_torch/csrc/lstm_bwd.cu",
        "replaces": "vistaocr_tpu/ops/lstm_pallas.py:264",
        "launches": f32_path["counts"]["DWH_LAUNCHES"],
        "form": "f32 streams and weights", "at": "B{}_T{}_H{}".format(
            *F32_DWH_SHAPES[0]),
        **dwh_f32_rows[F32_DWH_SHAPES[0]],
        **{"at_B{}_T{}_H{}".format(*k): v for k, v in dwh_f32_rows.items()
           if k != F32_DWH_SHAPES[0]}})
    for row in kernels:  # the flagship's two designs, H=512
        if row["name"] in ("bptt_gates_gemm_wide", "lstm_dwh"):
            row["designs_at_B32_T512_H512"] = flagship_f2
    for name, rep, counter in (("ctc_alpha", "ctc_pallas.py:74",
                                "ALPHA_LAUNCHES"),
                               ("ctc_beta", "ctc_pallas.py:157",
                                "BETA_LAUNCHES")):
        row = {"name": name, "route": "cuda",
               "source": "vistaocr_tpu_torch/csrc/ctc.cu",
               "replaces": f"vistaocr_tpu/ops/{rep}",
               "launches": counts[counter], **ctc_rows[CTC_MAIN][name],
               "library_call": "F.ctc_loss forward+backward "
                               "(ctc_alpha and ctc_beta together)",
               "ctc_loss_kernel": ctc_rows[CTC_MAIN]["ctc_loss"]}
        for B, T, _, _ in CTC_SHAPES[1:]:
            if (B, T) != CTC_MAIN:
                row[f"at_B{B}_T{T}"] = ctc_rows[(B, T)][name]
        kernels.append(row)
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
        kernels.append({"name": name, "route": "cuda",
                        "source": f"vistaocr_tpu_torch/csrc/{src}",
                        "replaces": f"experiments/{rep}",
                        "launches": exp_counts[counter],
                        **with_f32(table[(*shape, "bfloat16")][name],
                                   table[(*shape, "float32")][name])})
    kernels += [int8_row(int8_out), int8_quantize_row(int8_out)]
    # the fused path (phase fused): each kernel's wrapper calls in fit's
    # warm-ups and captures, and its device launches in a profiler window
    # over FUSED_WINDOW replays at B=32, W=1760 (bf16; f32 for the f32
    # forms)
    fused_calls = fused_out["fit"]["wrapper_calls"]
    for name, counter, group, dtype in (
            ("lstm_fwd_save_cell", "SAVE_CELL_LAUNCHES", "K1", "bfloat16"),
            ("bptt_gates_gemm_wide", "GATES_WIDE_LAUNCHES", "K2/K3",
             "bfloat16"),
            ("lstm_bwd_persistent", "BWD_PERSISTENT_LAUNCHES",
             "K2/K3 frames", "bfloat16"),
            ("lstm_dwh", "DWH_LAUNCHES", "K2/K3 dwh", "bfloat16"),
            ("ctc_alpha", "ALPHA_LAUNCHES", "K4", "bfloat16"),
            ("ctc_beta", "BETA_LAUNCHES", "K5", "bfloat16"),
            ("lstm_fwd_grid", None, "K1", "float32"),
            ("bptt_frame", None, "K2/K3 frames", "float32")):
        row = next(r for r in kernels if r["name"] == name)
        if counter:
            row["launches_fused_captured"] = fused_calls[counter]
        row["launches_fused_replay_window"] = fused_out["parity"][dtype][
            "graph_window_kernels"][group]
    # the dp phase's launches on each of its two ranks, and on each rank of
    # the tp check's 2 x 2 mesh (bf16 steps, whose every gate GEMM is the
    # wide one)
    dp_counts = dp_out["train"]["launches_a_rank_by_counter"]
    tp_counts = dp_out["tp"]["data2_model2"]["launches_a_rank_by_counter"]
    for row in kernels:
        counter = {"lstm_fwd_save_cell": "SAVE_CELL_LAUNCHES",
                   "lstm_dwh": "DWH_LAUNCHES",
                   "bptt_gates_gemm_wide": "GATES_GEMM_LAUNCHES",
                   "lstm_bwd_persistent": "BWD_PERSISTENT_LAUNCHES",
                   "ctc_alpha": "ALPHA_LAUNCHES",
                   "ctc_beta": "BETA_LAUNCHES"}.get(row["name"])
        if counter:
            row["launches_dp_a_rank"] = dp_counts[counter]
            row["launches_tp_a_rank"] = tp_counts[counter]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
