"""Batched inference service on one CUDA device.

Counterpart of ``vistaocr_tpu/serve/service.py:50-916``, greedy path:

    submit(image) -> Future
        | grayscale + polarity (host, numpy)     [data/transforms]
        | route to bucket by width               [ShapeContract]
        | enqueue; flush on max_batch or deadline
        v
    per-bucket batch on the device: (resize) + preprocess + CNN +
    BLSTM (CUDA kernel) + head + greedy collapse and packed score
        v
    future.set_result(LineResult)

PyTorch runs eagerly, so nothing is compiled per bucket; the bucket
ladder and the 8/32/128 batch-size ladder still bound the shapes the
device sees (and the padding each batch carries). Options whose modules
are not ported yet raise ``NotImplementedError`` naming their ROADMAP
item; none is ignored.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ..checkpoint import load_model
from ..data.buckets import BucketSpec
from ..data.transforms import maybe_invert, to_grayscale
from ..decode.greedy import SCORE_SCALE, greedy_frames_packed
from ..ops.resize import MAX_SCALE, host_pool, resize_lines, resized_to_uint8
from ..runtime import resolve_device, disable_tf32
from ..text import uxxxx_to_utf8


@dataclasses.dataclass
class ServiceConfig:
    """The JAX ``ServiceConfig`` fields and defaults (see the JAX module
    for each knob's rationale). Options of unported modules raise when
    set; the tuning knobs that only those modules read (``beam``,
    ``beam_impl``, ``device_lm``, ``quantize_float_prefix``) come with
    them."""

    max_batch: int = 32
    max_wait_ms: float = 5.0
    decoder: str = "greedy"  # greedy (beam: not ported yet)
    # Batches a bucket worker keeps in flight before it blocks on the
    # oldest one's readback.
    pipeline_depth: int = 2
    # Batch sizes per bucket; () derives the x4 ladder 8, 32, 128, ...
    # capped at max_batch.
    batch_sizes: Sequence[int] = ()
    mesh_data: int = 0
    lm_path: Optional[str] = None
    lexicon_path: Optional[str] = None
    word_lm_path: Optional[str] = None
    device_deskew: bool = False
    # Requests at non-contract heights are resized on the device.
    device_resize: bool = True
    quantize: str = "none"
    warmup: bool = True
    # Serving re-buckets the snapshot's ladder onto serve_align multiples
    # (0 keeps the snapshot's ladder).
    serve_align: int = 128


def _check_supported(config: ServiceConfig) -> None:
    """Raise on every option whose module is not ported yet."""
    todo = []
    if config.decoder != "greedy":
        if config.decoder != "beam":
            raise ValueError(f"unknown decoder {config.decoder!r}")
        todo.append("decoder='beam' (ROADMAP Queue 1: device beam/LM/lexicon)")
    if config.lm_path:
        todo.append("lm_path (ROADMAP Queue 1: device beam/LM/lexicon)")
    if config.lexicon_path:
        todo.append("lexicon_path (ROADMAP Queue 1: device beam/LM/lexicon)")
    if config.word_lm_path:
        todo.append("word_lm_path (ROADMAP Queue 1: device beam/LM/lexicon)")
    if config.device_deskew:
        todo.append("device_deskew=True (ROADMAP Queue 1: deskew)")
    if not config.device_resize:
        todo.append("device_resize=False, the PIL host resize "
                    "(ROADMAP Queue 1: host prep)")
    if config.quantize == "int8":
        todo.append("quantize='int8' (ROADMAP Queue 1: int8)")
    elif config.quantize != "none":
        raise ValueError(f"unknown quantize mode {config.quantize!r}")
    if config.mesh_data not in (0, 1):
        todo.append(f"mesh_data={config.mesh_data} (ROADMAP Queue 1: "
                    "multi-GPU)")
    if todo:
        raise NotImplementedError(
            "not ported to vistaocr_tpu_torch yet: " + "; ".join(todo))


@dataclasses.dataclass
class LineResult:
    text: str
    uxxxx: str
    latency_ms: float
    bucket_width: int
    # Per-frame geometric-mean probability of the greedy best path, in
    # (0, 1]: exp(best-path log-prob / valid frames).
    confidence: Optional[float] = None

    @property
    def logical_text(self) -> str:
        """Reading-order text (RTL models emit display order)."""
        from ..text.bidi import display_order

        return display_order(self.text)


@dataclasses.dataclass
class _Pending:
    image: np.ndarray  # [H, W] uint8: contract height, or a raw crop
    width: int  # normalised width (the routing key)
    future: Future
    t_submit: float
    raw: bool = False


# Raw-buffer slack columns beyond bucket_width * MAX_SCALE: width rounding
# can leave the raw width up to MAX_SCALE/2 px past the nominal bound.
_RAW_SLACK = 8


@dataclasses.dataclass
class _Handle:
    """One dispatched batch: the packed [B, T+1] int32 result on the
    device and, once prefetched, its pinned host copy and a CUDA event."""

    packed: torch.Tensor
    host: Optional[torch.Tensor] = None
    event: Any = None


class OcrService:
    """In-process batched OCR service over a self-describing snapshot.

    ``device`` is explicit: ``"cuda"`` raises if no card is visible, and
    the CPU runs only when asked for (tests)."""

    def __init__(self, snapshot: str, config: ServiceConfig = ServiceConfig(),
                 device="cuda"):
        _check_supported(config)
        _t_init = time.time()
        self.config = config
        self.device = resolve_device(device)
        disable_tf32()
        self.model, self.alphabet, self.contract = load_model(
            snapshot, self.device)
        if config.serve_align:
            a = config.serve_align
            coarse = tuple(sorted({
                -(-w // a) * a for w in self.contract.bucket_widths
            }))
            self.contract = dataclasses.replace(
                self.contract, bucket_widths=coarse)
        _t_tables = time.time()
        self._char_of = {t: uxxxx_to_utf8(t) for t in self.alphabet.tokens}
        # id-indexed tables (0 = blank = empty) for the greedy finalize
        self._tok_list = [""] + self.alphabet.tokens
        self._chr_list = [""] + [self._char_of[t] for t in self.alphabet.tokens]
        if config.batch_sizes:
            sizes = sorted({min(int(s), config.max_batch)
                            for s in config.batch_sizes})
        else:
            sizes, s = [], 8
            while s < config.max_batch:
                sizes.append(s)
                s *= 4
            sizes.append(config.max_batch)
        self._batch_sizes = tuple(sorted(set(sizes)))
        _tables_s = time.time() - _t_tables
        self._queues: List[queue.Queue] = [
            queue.Queue() for _ in self.contract.bucket_widths
        ]
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._bucket_loop, args=(i,), daemon=True)
            for i in range(len(self.contract.bucket_widths))
        ]
        self._lock = threading.Lock()  # one device dispatch at a time
        self._stats_lock = threading.Lock()
        self.stats = {"lines": 0, "batches": 0, "pad_waste": 0}
        for t in self._threads:
            t.start()
        _t_warm = time.time()
        if config.warmup:
            self._warmup()
        self.init_timings = {
            "load_s": round(_t_tables - _t_init, 3),
            "tables_s": round(_tables_s, 3),
            "warmup_s": round(time.time() - _t_warm, 3),
            "warmup_graphs": (len(self.contract.bucket_widths)
                              * len(self._batch_sizes)),
        }

    # ---- client API ---------------------------------------------------------
    def _prep(self, image) -> _Pending:
        """Host-side request prep: grayscale + polarity (+ rare integer
        pre-pooling); the geometric resize runs on the device."""
        H = self.contract.height
        max_w = self.contract.bucket_widths[-1]
        arr = maybe_invert(to_grayscale(image))
        h, w = arr.shape
        cap = MAX_SCALE * H
        if h > cap:
            arr = host_pool(arr, cap)
            h, w = arr.shape
        if h == H and w <= max_w:
            return _Pending(arr, w, Future(), time.time())
        # normalised width: the parity-pinned host formula (round half to
        # even, as the JAX package's data/transforms.height_normalize)
        new_w = min(max(1, round(w * H / h)), max_w)
        return _Pending(arr, new_w, Future(), time.time(), raw=True)

    def submit(self, image) -> Future:
        """image: [H, W] uint8 array, any height. Returns a
        Future[LineResult]."""
        p = self._prep(image)
        b = self.contract.bucket_for_width(p.width)
        self._queues[b].put(p)
        return p.future

    def ocr_lines(self, images: Sequence) -> List[LineResult]:
        """Bulk OCR: route everything up front, dispatch every batch
        back-to-back, start every batch's device->host copy, then finalize
        on the host. Bypasses the online queues on purpose."""
        pendings = []
        buckets: dict = {}  # (bucket_idx, raw) -> [pendings]
        for img in images:
            p = self._prep(img)
            pendings.append(p)
            b = self.contract.bucket_for_width(p.width)
            buckets.setdefault((b, p.raw), []).append(p)

        inflight = []
        for (b, raw), plist in buckets.items():
            for k in range(0, len(plist), self.config.max_batch):
                chunk = plist[k : k + self.config.max_batch]
                assembled = self._assemble_chunk(b, chunk, raw)
                with self._lock:
                    handle = self._dispatch_assembled(assembled, raw)
                inflight.append((b, chunk, handle, assembled[0].shape[0]))

        for _, _, handle, _ in inflight:
            self._prefetch_handle(handle)
        for b, chunk, handle, B in inflight:
            n = len(chunk)
            hyps = self._finalize(handle, n)
            self._resolve(b, chunk, hyps)
            with self._stats_lock:
                self.stats["lines"] += n
                self.stats["batches"] += 1
                self.stats["pad_waste"] += B - n
        return [p.future.result() for p in pendings]

    def close(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)

    # ---- internals ----------------------------------------------------------
    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device, non_blocking=True)

    def _dispatch(self, images_np, widths_np) -> _Handle:
        """Device work for one assembled contract-height batch (call under
        the dispatch lock)."""
        with torch.inference_mode():
            lp, fm = self.model(self._to_device(images_np),
                                self._to_device(widths_np))
            return _Handle(greedy_frames_packed(lp, fm))

    def _dispatch_raw(self, raw, heights, widths, new_widths) -> _Handle:
        """Device work for a raw batch: on-device resize in front of the
        model (call under the dispatch lock)."""
        H = self.contract.height
        with torch.inference_mode():
            raw_d = self._to_device(raw)
            new_w = self._to_device(new_widths)
            out_w = (raw.shape[2] - _RAW_SLACK) // MAX_SCALE
            img = resized_to_uint8(resize_lines(
                raw_d, self._to_device(heights), self._to_device(widths),
                new_w, out_h=H, out_w=out_w,
            ))
            lp, fm = self.model(img, new_w)
            return _Handle(greedy_frames_packed(lp, fm))

    def _assemble_chunk(self, bucket_idx: int, chunk: List[_Pending],
                        raw: bool):
        if raw:
            return self._assemble_raw(bucket_idx, chunk)
        images, widths, _ = self._assemble(bucket_idx, chunk)
        return images, widths

    def _dispatch_assembled(self, assembled, raw: bool) -> _Handle:
        return (self._dispatch_raw(*assembled) if raw
                else self._dispatch(*assembled))

    def _prefetch_handle(self, handle: _Handle) -> None:
        """Start the batch's device->host copy into pinned memory."""
        if self.device.type != "cuda" or handle.host is not None:
            return
        host = torch.empty(handle.packed.shape, dtype=handle.packed.dtype,
                           pin_memory=True)
        host.copy_(handle.packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        handle.host, handle.event = host, event

    def _finalize(self, handle: _Handle, n: int):
        """Host side of a dispatched batch -> n (id row, log-prob) pairs."""
        if handle.host is not None:
            handle.event.synchronize()
            packed = handle.host.numpy()
        else:
            packed = handle.packed.cpu().numpy()
        return [
            (row[:-1][row[:-1] != 0], row[-1] / SCORE_SCALE)
            for row in packed[:n]
        ]

    def _warmup(self):
        """Run every (bucket, batch size) shape once, so the first real
        requests do not pay the kernel build or cuDNN's first-call
        set-up."""
        for i in range(len(self.contract.bucket_widths)):
            spec = BucketSpec.of(self.contract, i)
            for B in self._batch_sizes:
                images = np.zeros((B, spec.height, spec.width), np.uint8)
                widths = np.full((B,), spec.width, np.int32)
                with self._lock:
                    handle = self._dispatch(images, widths)
                self._finalize(handle, 1)

    def _bucket_loop(self, bucket_idx: int):
        """Online worker: assemble -> dispatch up to ``pipeline_depth``
        batches before blocking on the oldest readback."""
        q = self._queues[bucket_idx]
        cfg = self.config
        depth = max(1, cfg.pipeline_depth)
        inflight: deque = deque()
        while not self._stop.is_set():
            try:
                first = q.get(timeout=0.001 if inflight else 0.05)
            except queue.Empty:
                while inflight:
                    self._complete_batch(inflight.popleft())
                continue
            batch = [first]
            deadline = time.time() + cfg.max_wait_ms / 1000.0
            while len(batch) < cfg.max_batch:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                try:
                    batch.append(q.get(timeout=remaining))
                except queue.Empty:
                    break
            norm = [p for p in batch if not p.raw]
            rawl = [p for p in batch if p.raw]
            for plist, is_raw in ((norm, False), (rawl, True)):
                if plist:
                    ctx = self._start_batch(bucket_idx, plist, raw=is_raw)
                    if ctx is not None:
                        inflight.append(ctx)
            while len(inflight) > depth:
                self._complete_batch(inflight.popleft())
        while inflight:
            self._complete_batch(inflight.popleft())

    def _bsize_for(self, n: int) -> int:
        """Smallest batch size of the ladder that fits n lines."""
        for s in self._batch_sizes:
            if s >= n:
                return s
        return self._batch_sizes[-1]

    def _assemble(self, bucket_idx: int, pendings: List[_Pending]):
        """Pad a pending list into the smallest ladder batch shape; pad
        slots are full-width paper."""
        spec = BucketSpec.of(self.contract, bucket_idx)
        n = len(pendings)
        B = self._bsize_for(n)
        images = np.full((B, spec.height, spec.width), 255, np.uint8)
        widths = np.zeros((B,), np.int32)
        for i, p in enumerate(pendings):
            images[i, :, : p.width] = p.image
            widths[i] = p.width
        widths[n:] = spec.width
        valid = np.arange(B) < n
        return images, widths, valid

    def _assemble_raw(self, bucket_idx: int, pendings: List[_Pending]):
        """Pad raw crops into [B, MAX_SCALE*H, MAX_SCALE*bucket_w +
        _RAW_SLACK] + per-sample (height, raw width, normalised width)."""
        spec = BucketSpec.of(self.contract, bucket_idx)
        B = self._bsize_for(len(pendings))
        cap = MAX_SCALE * spec.height
        wraw = MAX_SCALE * spec.width + _RAW_SLACK
        raw = np.full((B, cap, wraw), 255, np.uint8)
        heights = np.full((B,), spec.height, np.int32)
        widths = np.full((B,), spec.width, np.int32)
        new_widths = np.full((B,), spec.width, np.int32)
        for i, p in enumerate(pendings):
            h, w = p.image.shape
            w = min(w, wraw)
            raw[i, :h, :w] = p.image[:, :w]
            heights[i] = h
            widths[i] = w
            new_widths[i] = p.width
        return raw, heights, widths, new_widths

    def _resolve(self, bucket_idx: int, pendings: List[_Pending], hyps):
        spec = BucketSpec.of(self.contract, bucket_idx)
        now = time.time()
        for p, (ids_row, logp) in zip(pendings, hyps):
            # normalise by the line's frame count, known from its width
            frames = self.contract.frames_for_width(p.width)
            conf = float(np.exp(min(logp / max(frames, 1), 0.0)))
            ids = ids_row.tolist()
            p.future.set_result(
                LineResult(
                    text="".join([self._chr_list[j] for j in ids]),
                    uxxxx=" ".join([self._tok_list[j] for j in ids]),
                    latency_ms=(now - p.t_submit) * 1000.0,
                    bucket_width=spec.width,
                    confidence=conf,
                )
            )

    def _start_batch(self, bucket_idx: int, pendings: List[_Pending],
                     raw: bool = False):
        """Assemble + dispatch one batch and start its device->host copy.
        Returns a context for ``_complete_batch``, or None if dispatch
        failed (the futures then carry the error)."""
        n = len(pendings)
        try:
            assembled = self._assemble_chunk(bucket_idx, pendings, raw)
            B = assembled[0].shape[0]
            with self._lock:
                handle = self._dispatch_assembled(assembled, raw)
            self._prefetch_handle(handle)
        except Exception as e:  # resolve futures with the error, don't hang
            for p in pendings:
                p.future.set_exception(e)
            return None
        return (bucket_idx, pendings, handle, B, n)

    def _complete_batch(self, ctx) -> None:
        """Finalize a dispatched batch (blocks on its readback) and
        resolve its futures."""
        bucket_idx, pendings, handle, B, n = ctx
        try:
            hyps = self._finalize(handle, n)
        except Exception as e:
            for p in pendings:
                p.future.set_exception(e)
            return
        self._resolve(bucket_idx, pendings, hyps)
        with self._stats_lock:
            self.stats["lines"] += n
            self.stats["batches"] += 1
            self.stats["pad_waste"] += B - n
