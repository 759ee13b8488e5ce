"""Bucketed host pipeline: sampling, batch assembly, device prefetch.

Counterpart of ``vistaocr_tpu/data/pipeline.py:38-336``: every batch has
one of a fixed set of shapes (the bucket ladder of ``ShapeContract``);
per-bucket batch sizes follow a pixel budget; a sample goes to the
narrowest bucket that fits both its width and its label (CTC needs
label_len <= frames), and samples that fit none are counted in
``dropped``. ``plan(epoch)`` is bit-identical to the JAX one (same
``np.random.default_rng((seed, epoch))`` draws), so both packages feed
the same batches in the same order.

Batches are assembled with numpy (``dataset.read_into``); the JAX
package's C++ assembler is not ported. ``device_epoch(epoch, device)``
runs a producer thread that assembles batches ahead and copies them to
the device from pinned host memory with ``non_blocking`` copies; images
travel as uint8 and are normalised on the device.

Data parallelism: every rank derives the same global plan and batch sizes
(``batch_multiple`` = the rank count), and ``device_epoch(...,
shard=(index, count))`` assembles and copies only rank ``index``'s
contiguous rows of each global batch, with ``valid`` and ``indices``
kept global so that evaluation can put the batch back together in order.
``plan_fingerprint`` is the JAX one, CRC32 for CRC32, which the trainer
compares across ranks. The prefetch thread only copies to the local
device; it issues no collective.
"""

from __future__ import annotations

import math
import queue
import zlib
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.mesh import shard_rows
from ..text import Alphabet
from .buckets import BucketSpec, ShapeContract


@dataclass
class Batch:
    """One static-shape batch. ``images`` is [B, H, W] uint8; ``widths``
    are true pixel widths (<= W); ``valid`` marks real samples (False =
    padding duplicate, eval only). Array fields are numpy arrays from
    ``epoch`` and tensors on the device from ``device_epoch``; ``valid``
    and ``indices`` stay numpy."""

    images: "np.ndarray"
    widths: "np.ndarray"  # [B] int32
    labels: "np.ndarray"  # [B, L] int32, 0-padded
    label_lengths: "np.ndarray"  # [B] int32
    valid: "np.ndarray"  # [B] bool
    bucket: BucketSpec
    indices: "np.ndarray"  # [B] int64 dataset indices

    @property
    def size(self) -> int:
        return int(self.images.shape[0])


class BatchPipeline:
    """Iterable over bucketed batches for one split (parameters as the JAX
    ``BatchPipeline``: ``batch_pixels`` budget, ``batch_multiple``,
    ``min_batch``, ``drop_remainder``, ``shuffle``, ``seed``)."""

    def __init__(
        self,
        dataset,
        alphabet: Alphabet,
        contract: ShapeContract,
        *,
        batch_pixels: int = 2**21,
        batch_multiple: int = 1,
        min_batch: int = 1,
        drop_remainder: bool = True,
        shuffle: bool = True,
        seed: int = 0,
    ):
        if dataset.height != contract.height:
            raise ValueError(
                f"dataset height {dataset.height} != contract height {contract.height}"
            )
        self.dataset = dataset
        self.alphabet = alphabet
        self.contract = contract
        self.drop_remainder = drop_remainder
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

        # static per-bucket batch sizes, multiples of lcm(8, batch_multiple)
        align = 8 * batch_multiple // math.gcd(8, batch_multiple)
        self.batch_sizes: List[int] = []
        for bw in contract.bucket_widths:
            b = max(min_batch, batch_pixels // (contract.height * bw))
            b = max(align, (b // align) * align)
            self.batch_sizes.append(b)

        # bucket assignment (width AND label length)
        self.bucket_members: List[List[int]] = [[] for _ in contract.bucket_widths]
        self.encoded: List[np.ndarray] = []
        self.dropped = 0
        widths = dataset.widths
        max_label = [0] * len(contract.bucket_widths)
        for i in range(len(dataset)):
            ids = np.asarray(alphabet.encode(dataset.transcript(i)), dtype=np.int32)
            self.encoded.append(ids)
            placed = False
            for b, bw in enumerate(contract.bucket_widths):
                if widths[i] <= bw and len(ids) <= contract.label_cap(bw):
                    self.bucket_members[b].append(i)
                    max_label[b] = max(max_label[b], len(ids))
                    placed = True
                    break
            if not placed:
                self.dropped += 1

        # data-driven per-bucket label caps on the (64k - 1) ladder
        self.label_caps: List[int] = []
        for b, bw in enumerate(contract.bucket_widths):
            hard = contract.label_cap(bw)
            need = max(max_label[b], 1)
            cap = next(
                (c for c in (15, 31, 63, 127, 191, 255, 383, 511) if c >= need),
                need,
            )
            self.label_caps.append(min(cap, hard))

    def spec_for(self, bucket_idx: int) -> BucketSpec:
        """BucketSpec with the data-driven label cap."""
        spec = BucketSpec.of(self.contract, bucket_idx)
        return BucketSpec(width=spec.width, height=spec.height,
                          frames=spec.frames,
                          label_len=self.label_caps[bucket_idx])

    def __len__(self) -> int:
        total = 0
        for members, bsz in zip(self.bucket_members, self.batch_sizes):
            if self.drop_remainder:
                total += len(members) // bsz
            else:
                total += -(-len(members) // bsz) if members else 0
        return total

    def batch_shapes(self) -> List[tuple]:
        """Every (B, H, W, L) this pipeline can emit: the trainer's capture
        set (``pipeline.py:168-178``). With ``drop_remainder`` a bucket
        with fewer members than its batch size emits nothing."""
        shapes = []
        for b, (members, bsz) in enumerate(zip(self.bucket_members,
                                               self.batch_sizes)):
            n = len(members)
            if n and (not self.drop_remainder or n >= bsz):
                spec = self.spec_for(b)
                shapes.append((bsz, spec.height, spec.width, spec.label_len))
        return shapes

    def _assemble(self, bucket_idx: int, idxs: Sequence[int], bsz: int,
                  rows: slice = slice(None)) -> Batch:
        """The batch's ``rows`` (all by default); ``valid`` and ``indices``
        cover the whole batch."""
        spec = self.spec_for(bucket_idx)
        n = len(idxs)
        slots = range(bsz)[rows]
        m = len(slots)
        images = np.full((m, spec.height, spec.width), 255, dtype=np.uint8)
        widths = np.zeros((m,), dtype=np.int32)
        labels = np.zeros((m, spec.label_len), dtype=np.int32)
        label_lengths = np.zeros((m,), dtype=np.int32)
        valid = np.arange(bsz) < n
        # pad the tail by repeating samples
        out_indices = np.asarray([idxs[s % n] for s in range(bsz)], np.int64)
        for r, slot in enumerate(slots):
            i = out_indices[slot]
            widths[r] = self.dataset.read_into(i, images[r])
            ids = self.encoded[i]
            labels[r, : len(ids)] = ids
            label_lengths[r] = len(ids)
        return Batch(images=images, widths=widths, labels=labels,
                     label_lengths=label_lengths, valid=valid, bucket=spec,
                     indices=out_indices)

    def plan(self, epoch: int) -> List[tuple]:
        """The exact (bucket_idx, [dataset indices]) batch plan for one
        epoch, deterministic in (seed, epoch, dataset order)."""
        rng = np.random.default_rng((self.seed, epoch))
        plan: List[tuple] = []
        for b, members in enumerate(self.bucket_members):
            if not members:
                continue
            order = np.array(members)
            if self.shuffle:
                rng.shuffle(order)
            bsz = self.batch_sizes[b]
            n_full = len(order) // bsz
            for k in range(n_full):
                plan.append((b, order[k * bsz : (k + 1) * bsz].tolist()))
            tail = order[n_full * bsz :]
            if len(tail) and not self.drop_remainder:
                plan.append((b, tail.tolist()))
        if self.shuffle:
            rng.shuffle(plan)
        return plan

    def plan_fingerprint(self, epoch: int = 0) -> int:
        """CRC32 over the batch sizes and the epoch plan: equal across
        ranks iff they will feed identical global batches."""
        h = zlib.crc32(np.asarray(self.batch_sizes, np.int64).tobytes())
        for b, idxs in self.plan(epoch):
            h = zlib.crc32(np.int64(b).tobytes(), h)
            h = zlib.crc32(np.asarray(idxs, np.int64).tobytes(), h)
        return h

    def epoch(self, epoch: Optional[int] = None,
              shard: Tuple[int, int] = (0, 1)) -> Iterator[Batch]:
        """Yield all batches for one epoch (numpy arrays); with ``shard =
        (index, count)`` each holds only that shard's rows."""
        if epoch is None:
            epoch = self._epoch
            self._epoch += 1
        for b, idxs in self.plan(epoch):
            bsz = self.batch_sizes[b]
            yield self._assemble(b, idxs, bsz, shard_rows(bsz, *shard))

    def device_epoch(self, epoch: Optional[int] = None, *, device,
                     prefetch: int = 2,
                     shard: Tuple[int, int] = (0, 1)) -> Iterator[Batch]:
        """Like :meth:`epoch`, with batches assembled by a producer thread
        ``prefetch`` ahead and copied to ``device`` (pinned host memory,
        ``non_blocking`` copies on a CUDA device)."""
        device = torch.device(device)
        cuda = device.type == "cuda"

        def put(batch: Batch) -> Batch:
            def dev(a):
                t = torch.from_numpy(a)
                if cuda:
                    t = t.pin_memory().to(device, non_blocking=True)
                return t

            return Batch(images=dev(batch.images), widths=dev(batch.widths),
                         labels=dev(batch.labels),
                         label_lengths=dev(batch.label_lengths),
                         valid=batch.valid, bucket=batch.bucket,
                         indices=batch.indices)

        q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        sentinel = object()
        err: List[BaseException] = []
        stop = threading.Event()

        def producer():
            try:
                for batch in self.epoch(epoch, shard):
                    if stop.is_set():
                        return
                    q.put(put(batch))
            except BaseException as e:  # propagate into the consumer
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # a consumer that stops early (max_steps) releases the producer
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
