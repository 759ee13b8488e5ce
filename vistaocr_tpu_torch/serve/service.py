"""Batched inference service on one CUDA device, or a data mesh of them.

Counterpart of ``vistaocr_tpu/serve/service.py:50-916``:

    submit(image) -> Future
        | grayscale + polarity (host, numpy)     [data/transforms]
        | (device_resize=False: the host resize, PIL's BILINEAR in numpy)
        | route to bucket by width               [ShapeContract]
        | enqueue; flush on max_batch or deadline
        v
    per-bucket batch on the device: (resize) + (deskew) + preprocess +
    CNN + BLSTM (CUDA kernel) + head, then the decode tail: the greedy
    collapse and packed score; or (decoder="beam", beam_impl="device",
    the default) the beam search with the char LM, lexicon and word LM
    fused in it [decode/device_beam], one CUDA graph per batch shape on
    the card; or (beam_impl="host") the per-frame top-k
        v
    host: the id rows to text; (device beam without a fused LM: the
    best final, or two-pass LM rescoring of the W finals; host beam: the
    prefix beam search on the C++ engine or the Python expansion)
        v
    future.set_result(LineResult)

The model runs eagerly; the bucket ladder and the 8/32/128 batch-size
ladder bound the shapes the device sees (and the padding each batch
carries), and ``warmup`` captures the device beam's graph of each. With
``quantize="int8"`` the conv stack of every route is the snapshot's
stored int8 stack (``models/quant.py``: the int8 conv kernel on the card),
and the bridge, BLSTM and head stay in the model's type.

``mesh_data`` (JAX ``service.py:78-85``) serves data-parallel: 0 or 1 is
one device, -1 every local device of the service's type, n the first n
(more than there are raises ``ValueError``). Each device holds its own
shard: the model, the int8 stack, the decode tables and the device
beam's program with its graphs. The batch ladder is rounded up to
multiples of n; each batch is split into n contiguous shards, each
launched on its own device (its current stream), and the outputs are
joined in order on the host. No option is ignored.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..checkpoint import load_model
from ..data.buckets import BucketSpec
from ..data.transforms import maybe_invert, normalize_line, to_grayscale
from ..decode import BeamConfig, beam_decode, beam_topk, load_lm
from ..decode.device_beam import (
    BeamProgram,
    beam_scan_collapsed,
    device_beam_decode,
    device_tables,
)
from ..decode.greedy import SCORE_SCALE, greedy_frames_packed
from ..ops.deskew import device_deskew
from ..ops.resize import MAX_SCALE, host_pool, resize_lines, resized_to_uint8
from ..parallel import mesh as pmesh
from ..runtime import HostCopy, disable_tf32, resolve_device
from ..text import uxxxx_to_utf8


@dataclasses.dataclass
class ServiceConfig:
    """The JAX ``ServiceConfig`` fields and defaults (see the JAX module
    for each knob's rationale)."""

    max_batch: int = 32
    max_wait_ms: float = 5.0
    decoder: str = "greedy"  # greedy | beam
    beam: BeamConfig = dataclasses.field(default_factory=BeamConfig)
    # device (the search on the device, decode/device_beam.py) | host
    # (the C++ engine or the Python expansion over the device's
    # per-frame top-k)
    beam_impl: str = "device"
    # Batches a bucket worker keeps in flight before it blocks on the
    # oldest one's readback.
    pipeline_depth: int = 2
    # Batch sizes per bucket; () derives the x4 ladder 8, 32, 128, ...
    # capped at max_batch.
    batch_sizes: Sequence[int] = ()
    # Data-parallel serving: 0/1 one device, -1 every local device, n the
    # first n; each batch splits into n contiguous shards.
    mesh_data: int = 0
    lm_path: Optional[str] = None
    # The char LM fused inside the device beam (order 2-3 dense, 4
    # hashed); False, or a higher order: two-pass rescoring of the W
    # finals on the host.
    device_lm: bool = True
    lexicon_path: Optional[str] = None
    word_lm_path: Optional[str] = None
    # Deskew on the device in front of the forward (ops/deskew.py).
    device_deskew: bool = False
    # Requests at non-contract heights are resized on the device; False:
    # on the host at request prep (normalize_line).
    device_resize: bool = True
    # int8 serving (models/quant.py): the snapshot's qstack.msgpack (write
    # it once with `python -m vistaocr_tpu_torch.models.quant`) in place of
    # the conv stack in every route. "none" | "int8".
    quantize: str = "none"
    # With int8: the first N convs run with the folded float kernels.
    quantize_float_prefix: int = 0
    warmup: bool = True
    # Serving re-buckets the snapshot's ladder onto serve_align multiples
    # (0 keeps the snapshot's ladder).
    serve_align: int = 128


def _check_supported(config: ServiceConfig) -> None:
    """Raise on every option the service does not take."""
    if config.decoder not in ("greedy", "beam"):
        raise ValueError(f"unknown decoder {config.decoder!r}")
    if config.beam_impl not in ("device", "host"):
        raise ValueError(f"unknown beam_impl {config.beam_impl!r}")
    if config.lexicon_path and config.decoder != "beam":
        raise ValueError("lexicon_path needs decoder='beam' (the constraint "
                         "lives in the beam search)")
    if config.word_lm_path and config.decoder != "beam":
        raise ValueError("word_lm_path needs decoder='beam' (word-LM fusion "
                         "lives in the beam search)")
    if config.quantize not in ("none", "int8"):
        raise ValueError(f"unknown quantize mode {config.quantize!r}")


@dataclasses.dataclass
class LineResult:
    text: str
    uxxxx: str
    latency_ms: float
    bucket_width: int
    # Per-frame geometric-mean probability of the decode, in (0, 1]:
    # exp(greedy best-path or device-beam winner's CTC log-prob / valid
    # frames). None on the host beam path (its engines return no score).
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
    """One dispatched batch: its kind and results on the device, one tuple
    a shard in row order (greedy, and the device beam with a fused LM or
    lexicon: the packed [B, T+1] int32 rows; the device beam otherwise:
    totals and the best [B, T] or every beam's [B, W, T] rows; host beam:
    log-probs, frame mask and the per-frame top-k values and ids) and,
    once prefetched, their host copies."""

    kind: str  # greedy | beam_fused | beam_dev | beam_host
    parts: list
    copies: Optional[List[HostCopy]] = None


@dataclasses.dataclass
class _Shard:
    """What one data shard's forward and decode tail read, on its
    device."""

    device: torch.device
    model: torch.nn.Module
    qstack: Optional[object]  # models.quant.QuantizedStack
    beam_kw: dict
    beam_prog: Optional[BeamProgram]


def _on(device: torch.device):
    """Make ``device`` current for launches (CUDA), or nothing."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


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
        devices = self._mesh_devices(config.mesh_data)
        self.device = devices[0]
        self.model, self.alphabet, self.contract = load_model(
            snapshot, self.device)
        qstack = self._load_qstack(snapshot, config)
        self._lm = (load_lm(config.lm_path, self.alphabet)
                    if config.lm_path else None)
        _t_tables = time.time()
        tables, beam_fn = self._build_decode_tables(config)
        self._shards = [self._make_shard(i, d, qstack, tables, beam_fn)
                        for i, d in enumerate(devices)]
        # the first shard's, for callers that drive one shard's pieces
        self._qstack = self._shards[0].qstack
        self._beam_kw = self._shards[0].beam_kw
        self._beam_prog = self._shards[0].beam_prog
        _tables_s = time.time() - _t_tables
        if config.serve_align:
            a = config.serve_align
            coarse = tuple(sorted({
                -(-w // a) * a for w in self.contract.bucket_widths
            }))
            self.contract = dataclasses.replace(
                self.contract, bucket_widths=coarse)
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
        # every batch size must divide over the shards
        ns = len(self._shards)
        self._batch_sizes = tuple(sorted({-(-s // ns) * ns for s in sizes}))
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

    def _mesh_devices(self, mesh_data: int) -> List[torch.device]:
        """The service's devices: its own for 0 or 1, else a data mesh
        over the local devices of its type (``ValueError`` when there are
        fewer than ``mesh_data``)."""
        if mesh_data in (0, 1):
            return [self.device]
        local = pmesh.local_devices(self.device.type)
        mesh = pmesh.make_mesh(pmesh.MeshConfig(data=mesh_data, model=1),
                               devices=local if mesh_data < 0
                               else local[:mesh_data])
        return list(mesh.devices)

    def _make_shard(self, index: int, device: torch.device, qstack,
                    tables: dict, beam_fn) -> _Shard:
        """A shard's copies of the model, the int8 stack, the decode
        tables and the device beam's program on ``device``."""
        model = (self.model if index == 0
                 else copy.deepcopy(self.model).to(device))
        qs = None
        if qstack is not None:
            from ..models.quant import QuantizedStack

            qs = QuantizedStack(qstack, device, self.model.config.dtype)
            qs.check_float_prefix(self.config.quantize_float_prefix,
                                  "quantize_float_prefix")
        return _Shard(device, model, qs, device_tables(tables, device),
                      BeamProgram(beam_fn) if beam_fn is not None else None)

    def _load_qstack(self, snapshot: str, config: ServiceConfig):
        """int8 serving: the snapshot's stored qstack (serving never
        calibrates), or None."""
        if config.quantize != "int8":
            return None
        from ..models.quant import load_qstack

        qs = load_qstack(snapshot)
        if qs is None:
            raise ValueError(
                "quantize='int8' needs qstack.msgpack in the snapshot "
                "dir; create it once with `python -m "
                "vistaocr_tpu_torch.models.quant --snapshot ... --data ...`"
            )
        return qs

    def _build_decode_tables(self, config: ServiceConfig):
        """The beam's lexicon and word LM (both engines), and for the
        device beam its tables on the device, as the JAX service builds
        them: the trie (``Lexicon.dense_tables``, with the unk row under
        ``lex_unk_logp``), the word LM (``device_word_tables``: dense or
        hashed bigram, hashed trigram), and under ``device_lm`` the char
        LM (dense order 2-3, hashed order 4); then the search function
        (``_beam_all``: every beam's finals leave the device for two-pass
        LM rescoring). Returns the host tables and the search function
        (None without the device beam); each shard moves them to its
        device."""
        bc = config.beam
        device_beam = config.decoder == "beam" and config.beam_impl == "device"
        want_lm = bool(config.lm_path) and bc.lm_alpha != 0.0
        use_unk = (config.lexicon_path is not None
                   and bc.lex_unk_logp != 0.0)
        tables: dict = {}
        self._lexicon = self._word_lm = None
        if config.lexicon_path and config.decoder == "beam":
            from ..decode.lexicon import Lexicon

            self._lexicon = Lexicon.read_words(self.alphabet,
                                               config.lexicon_path)
            if device_beam:
                next_tbl, boundary = self._lexicon.dense_tables(unk=use_unk)
                tables.update(lex_next=next_tbl, lex_boundary=boundary)
                if use_unk:
                    tables.update(lex_unk_logp=float(bc.lex_unk_logp),
                                  space_id=self._lexicon.space_id)
        if config.word_lm_path and config.decoder == "beam":
            from ..decode.lm import ArpaLM, device_word_tables, word_unk_logp

            self._word_lm = ArpaLM.read_arpa(config.word_lm_path)
            if device_beam:
                if self._lexicon is None or self._word_lm.order > 3:
                    raise ValueError(
                        "device word fusion needs lexicon_path and a word LM "
                        "of order <= 3; use beam_impl='host' otherwise")
                tables.update(
                    device_word_tables(self._word_lm, self._lexicon.words),
                    word_ids=self._lexicon.word_id_table(unk=use_unk),
                    space_id=self._lexicon.space_id,
                    word_alpha=float(bc.word_lm_alpha),
                    word_beta=float(bc.word_lm_beta))
                if use_unk:
                    tables["word_unk_logp"] = float(
                        word_unk_logp(self._word_lm))
        lm_fused = False
        if want_lm and config.device_lm and device_beam:
            from ..decode.lm import ArpaLM, dense_logp_table, hashed_logp_table

            py_lm = ArpaLM.read_arpa(config.lm_path)
            if 2 <= py_lm.order <= 3:
                tables["lm_table"] = dense_logp_table(py_lm, self.alphabet)
                lm_fused = True
            elif py_lm.order == 4:
                t = hashed_logp_table(py_lm, self.alphabet)
                tables.update(lm_table=t["t3"], lm_hash_keys=t["keys"],
                              lm_hash_vals=t["vals"], lm_rows=t["rows"],
                              lm_probes=int(t["probes"]))
                lm_fused = True
        self._beam_fused = bool(tables)
        self._beam_all = want_lm and not lm_fused
        if self._beam_fused and self._beam_all:
            raise ValueError(
                "device lexicon serving with an LM needs order <= 4 "
                "(fused); use beam_impl='host' for higher orders")
        fuse = (dict(lm_alpha=float(bc.lm_alpha), lm_beta=float(bc.lm_beta))
                if lm_fused else {})
        beam_fn = functools.partial(
            beam_scan_collapsed, beam_width=bc.beam_width, topk=bc.topk,
            prune_logp=float(bc.prune_logp), all_beams=self._beam_all,
            **fuse) if device_beam else None
        return tables, beam_fn

    # ---- client API ---------------------------------------------------------
    def _prep(self, image) -> _Pending:
        """Host-side request prep. With device_resize, only grayscale +
        polarity (+ rare integer pre-pooling) happen here and the
        geometric resize runs on the device; without it the whole chain
        (normalize_line) runs here."""
        H = self.contract.height
        max_w = self.contract.bucket_widths[-1]
        if not self.config.device_resize:
            norm = normalize_line(image, H, max_width=max_w)
            return _Pending(norm, norm.shape[1], Future(), time.time())
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
        """image: [H, W]/[H, W, C] uint8 array or PIL image, any height.
        Returns a Future[LineResult]."""
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
    def _to_device(self, arr: np.ndarray,
                   shard: Optional[_Shard] = None) -> torch.Tensor:
        dev = self.device if shard is None else shard.device
        return torch.from_numpy(arr).to(dev, non_blocking=True)

    def _decode_tail(self, lp, fm, shard: Optional[_Shard] = None) -> _Handle:
        """The device work after the forward: the greedy collapse and
        packed score; the device beam (with a fused LM or lexicon only
        the packed winner rows leave the device, as in JAX); or the host
        beam's per-frame top-k."""
        shard = shard or self._shards[0]
        if self.config.decoder == "beam":
            if self.config.beam_impl == "host":
                k = min(self.config.beam.topk, lp.shape[-1])
                return _Handle("beam_host", [(lp, fm, *beam_topk(lp, k))])
            out = shard.beam_prog(lp, fm, **shard.beam_kw)
            if self._beam_fused:
                return _Handle("beam_fused", [(out[1],)])
            return _Handle("beam_dev", [out])
        return _Handle("greedy", [(greedy_frames_packed(lp, fm),)])

    def _forward(self, images, widths,
                 shard: Optional[_Shard] = None) -> _Handle:
        """(Deskew +) the model (its conv stack int8 under quantize) + the
        decode tail on one shard's device tensors."""
        shard = shard or self._shards[0]
        if self.config.device_deskew:
            images = device_deskew(images, widths)[0]
        if shard.qstack is None:
            lp, fm = shard.model(images, widths)
        else:
            from ..models.quant import quantized_forward

            lp, fm = quantized_forward(
                shard.model, shard.qstack, images, widths,
                float_prefix=self.config.quantize_float_prefix)
        return self._decode_tail(lp, fm, shard)

    def _sharded(self, batch: int, fn) -> _Handle:
        """``fn(shard, rows)`` on each shard's contiguous rows of a batch
        of ``batch``, launched in turn with the shard's device current;
        one handle with the shards' outputs in row order."""
        n = len(self._shards)
        handles = []
        for i, shard in enumerate(self._shards):
            with _on(shard.device):
                handles.append(fn(shard, pmesh.shard_rows(batch, i, n)))
        return _Handle(handles[0].kind, [p for h in handles for p in h.parts])

    def _dispatch(self, images_np, widths_np) -> _Handle:
        """Device work for one assembled contract-height batch (call under
        the dispatch lock)."""
        def run(shard, rows):
            return self._forward(self._to_device(images_np[rows], shard),
                                 self._to_device(widths_np[rows], shard),
                                 shard)

        with torch.inference_mode():
            return self._sharded(images_np.shape[0], run)

    def _dispatch_raw(self, raw, heights, widths, new_widths) -> _Handle:
        """Device work for a raw batch: on-device resize in front of the
        model (call under the dispatch lock)."""
        H = self.contract.height
        out_w = (raw.shape[2] - _RAW_SLACK) // MAX_SCALE

        def run(shard, rows):
            def put(a):
                return self._to_device(a[rows], shard)

            new_w = put(new_widths)
            img = resized_to_uint8(resize_lines(
                put(raw), put(heights), put(widths), new_w, out_h=H,
                out_w=out_w,
            ))
            return self._forward(img, new_w, shard)

        with torch.inference_mode():
            return self._sharded(raw.shape[0], run)

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
        """Start the batch's device->host copies into pinned memory, each
        shard's with its device current."""
        if handle.copies is None:
            copies = []
            for part in handle.parts:
                with _on(part[0].device):
                    copies.append(HostCopy(part))
            handle.copies = copies

    def _finalize(self, handle: _Handle, n: int):
        """Host side of a dispatched batch -> n (id row, log-prob) pairs
        (greedy, fused device beam), n (uxxxx, CTC log-prob) pairs
        (device beam), or n uxxxx hypotheses (host beam)."""
        self._prefetch_handle(handle)
        parts = [c.get() for c in handle.copies]
        arrays = (parts[0] if len(parts) == 1
                  else [np.concatenate(a) for a in zip(*parts)])
        valid = np.arange(arrays[0].shape[0]) < n
        if handle.kind == "beam_host":
            lp, fm, vals, ids = arrays
            return beam_decode(
                lp, fm, self.alphabet, self.config.beam, lm=self._lm,
                valid=valid, precomputed_topk=(vals, ids),
                lexicon=self._lexicon, word_lm=self._word_lm)
        if handle.kind == "beam_dev":
            return device_beam_decode(
                None, None, self.alphabet, self.config.beam, lm=self._lm,
                valid=valid, precomputed=arrays, return_scores=True)
        (packed,) = arrays
        return [
            (row[:-1][row[:-1] != 0], row[-1] / SCORE_SCALE)
            for row in packed[:n]
        ]

    def _warmup(self):
        """Run every (bucket, batch size) shape once, so the first real
        requests do not pay the kernel build, cuDNN's first-call set-up or
        the capture of the device beam's graph for the shape."""
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
        for p, hyp in zip(pendings, hyps):
            conf = None
            if isinstance(hyp, tuple):  # (id row or uxxxx, log-prob)
                hyp, logp = hyp
                # normalise by the line's frame count, known from its width
                frames = self.contract.frames_for_width(p.width)
                conf = float(np.exp(min(logp / max(frames, 1), 0.0)))
            if isinstance(hyp, str):  # beam: uxxxx
                text = "".join(self._char_of.get(t) or uxxxx_to_utf8(t)
                               for t in hyp.split())
                uxxxx = hyp
            else:  # greedy, fused device beam: id row
                ids = hyp.tolist()
                text = "".join([self._chr_list[j] for j in ids])
                uxxxx = " ".join([self._tok_list[j] for j in ids])
            p.future.set_result(
                LineResult(
                    text=text,
                    uxxxx=uxxxx,
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
