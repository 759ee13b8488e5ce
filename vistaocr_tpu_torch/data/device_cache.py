"""Device-resident dataset cache: each bucket's lines on the device once,
every epoch's batches drawn by an on-device gather.

Counterpart of ``vistaocr_tpu/data/device_cache.py``. Height-normalised
uint8 lines are small (a 32-px line of 2048 px is 64 KiB), so a corpus
fits on the card: each bucket's lines go to ``device`` once as a
``[n, H, Wb]`` uint8 array beside int32 widths, labels and label
lengths, and each epoch's shuffle is an ``index_select`` by a permuted
index vector. The shuffle is the reference's, draw for draw (a fresh
membership every epoch), and no batch crosses from the host after the
cache is built.

``epoch``/``device_epoch`` give the batches of ``BatchPipeline.plan``,
in its order; ``epoch_plan`` gives the epoch-fused trainer
(``train.make_train_epoch``) each bucket's rows as one index matrix.
Under data parallelism every rank holds the whole split: the shuffle
sends any line of a bucket into any rank's rows of a global batch, so
each rank gathers its own rows (``shard_rows``) of every batch from the
whole arrays, as the reference replicates the resident arrays and
shards only the gather's output. The ranks of a model group take the
same rows.

The trainer falls back to streaming (``BatchPipeline.device_epoch``)
when the store exceeds ``max_bytes``.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import shard_rows
from .pipeline import Batch, BatchPipeline


class DeviceCache:
    """Wraps a ``BatchPipeline`` with its iteration contract (``epoch``,
    ``device_epoch``), batches gathered on ``device`` from the resident
    bucket arrays."""

    def __init__(self, pipe: BatchPipeline, *, device,
                 max_bytes: int = 4 * 2**30):
        self.pipe = pipe
        self.device = torch.device(device)
        total = 0
        for b, members in enumerate(pipe.bucket_members):
            spec = pipe.spec_for(b)
            total += len(members) * (spec.height * spec.width
                                     + 4 * spec.label_len)
        if total > max_bytes:
            raise MemoryError(
                f"dataset needs ~{total/2**20:.0f}MB on device > cap "
                f"{max_bytes/2**20:.0f}MB; use streaming"
            )
        # bucket -> (images, widths, labels, label lengths) on the device
        self.resident = {}
        ds = pipe.dataset
        for b, members in enumerate(pipe.bucket_members):
            if not members:
                continue
            spec = pipe.spec_for(b)
            n = len(members)
            imgs = np.full((n, spec.height, spec.width), 255, np.uint8)
            widths = np.zeros((n,), np.int32)
            labels = np.zeros((n, spec.label_len), np.int32)
            lls = np.zeros((n,), np.int32)
            for slot, i in enumerate(members):
                widths[slot] = ds.read_into(i, imgs[slot])
                enc = pipe.encoded[i]
                labels[slot, : len(enc)] = enc
                lls[slot] = len(enc)
            self.resident[b] = tuple(torch.from_numpy(a).to(self.device)
                                     for a in (imgs, widths, labels, lls))
        # slot -> dataset index, for evaluation's bookkeeping
        self.slot_to_index = {
            b: np.asarray(m, np.int64)
            for b, m in enumerate(pipe.bucket_members) if m}

    def epoch(self, epoch: Optional[int] = None,
              shard: Tuple[int, int] = (0, 1)) -> Iterator[Batch]:
        """Every batch of one epoch, gathered on the device; with ``shard
        = (index, count)`` each holds only that shard's rows. ``valid``
        and ``indices`` stay global numpy, as the pipeline's."""
        pipe = self.pipe
        if epoch is None:
            epoch = pipe._epoch
            pipe._epoch += 1
        for b, idxs in pipe.plan(epoch):
            # the plan's dataset indices as slots (members are ascending)
            slots = np.searchsorted(self.slot_to_index[b], idxs)
            bsz, k = pipe.batch_sizes[b], len(slots)
            if k < bsz:  # pad the tail by cyclic repeat, flagged in valid
                slots = np.resize(slots, bsz)
            rows = shard_rows(bsz, *shard)
            idx = torch.from_numpy(slots[rows].astype(np.int32)).to(
                self.device)
            imgs, w, lab, ll = (a.index_select(0, idx)
                                for a in self.resident[b])
            yield Batch(images=imgs, widths=w, labels=lab, label_lengths=ll,
                        valid=np.arange(bsz) < k, bucket=pipe.spec_for(b),
                        indices=self.slot_to_index[b][slots])

    def device_epoch(self, epoch: Optional[int] = None, *, device=None,
                     prefetch: int = 0,
                     shard: Tuple[int, int] = (0, 1)) -> Iterator[Batch]:
        """``epoch``: the batches are on the device already (``prefetch``
        is taken for the pipeline's signature and unused)."""
        if device is not None and torch.device(device) != self.device:
            raise ValueError(f"cache on {self.device}, batches asked on "
                             f"{torch.device(device)}")
        return self.epoch(epoch, shard)

    def _epoch_plan_host(self, epoch: int) -> List[tuple]:
        """One epoch's index matrices, [(bucket, idx [nb, B] int32)]."""
        pipe = self.pipe
        rng = np.random.default_rng((pipe.seed, epoch))
        plans = []
        for b in self.resident:
            n = len(pipe.bucket_members[b])
            bsz = pipe.batch_sizes[b]
            nb = n // bsz
            if nb == 0:
                continue
            order = np.arange(n)
            if pipe.shuffle:
                rng.shuffle(order)
            plans.append((b, order[: nb * bsz].reshape(nb, bsz)
                          .astype(np.int32)))
        if pipe.shuffle:
            rng.shuffle(plans)
        return plans

    def epoch_plan(self, epoch: int, stack: int = 1) -> List[tuple]:
        """``stack`` consecutive epochs as index matrices for the
        epoch-fused trainer: [(bucket, resident arrays, idx [nb, B] int32,
        weights [nb, B] f32)], idx and weights on the device. Each bucket's
        rows of the stacked epochs are concatenated in epoch order, the
        buckets in the order of their first appearance; full batches only
        (the tails are dropped, as ``drop_remainder`` does), weights of
        ones; ``stack=1`` is one epoch."""
        groups: dict = {}
        order = []
        for e in range(epoch, epoch + stack):
            for b, idx in self._epoch_plan_host(e):
                if b not in groups:
                    order.append(b)
                    groups[b] = []
                groups[b].append(idx)
        out = []
        for b in order:
            idx = np.concatenate(groups[b], axis=0)
            out.append((b, self.resident[b],
                        torch.from_numpy(idx).to(self.device),
                        torch.ones(idx.shape, dtype=torch.float32,
                                   device=self.device)))
        return out

    # the wrapped pipeline's metadata
    @property
    def dataset(self):
        return self.pipe.dataset

    @property
    def dropped(self):
        return self.pipe.dropped

    def batch_shapes(self) -> List[tuple]:
        return self.pipe.batch_shapes()
