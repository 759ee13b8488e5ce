"""Static-shape contract: width-bucket ladder + frame-count arithmetic.

Counterpart of ``vistaocr_tpu/data/buckets.py`` (``ShapeContract`` and
``BucketSpec``, same fields and same JSON, so a JAX snapshot's
``meta.json`` loads unchanged; ``make_ladder``, the same rungs). A copy,
not an import: the JAX ``data`` package imports PIL at package import.

Frame arithmetic: a stack of SAME-padded stride-2 stages (max-pool with
``ceil_mode=True`` in the port) gives ``ceil(width / width_stride)``
valid frames for any true width; ``tests/test_torch_port_model.py`` pins
it against the port's real conv output shapes.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Sequence, Tuple

import numpy as np


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class ShapeContract:
    """Fixed line height, ascending bucket-width ladder, CNN width stride
    and the label cap (see the JAX module for the full rationale)."""

    height: int = 32
    bucket_widths: Tuple[int, ...] = (128, 256, 384, 512, 768, 1024, 1536, 2048)
    width_stride: int = 4
    max_label_len: int = 256

    def __post_init__(self):
        ws = self.bucket_widths
        if list(ws) != sorted(set(ws)):
            raise ValueError("bucket_widths must be strictly ascending")
        for w in ws:
            if w % self.width_stride:
                raise ValueError(
                    f"bucket width {w} not a multiple of width_stride={self.width_stride}"
                )

    def frames_for_width(self, width):
        """True pixel width -> number of valid CTC frames (ints, numpy
        arrays and torch tensors alike)."""
        return -(-width // self.width_stride)

    def frames_for_bucket(self, bucket_width: int) -> int:
        return bucket_width // self.width_stride

    def label_cap(self, bucket_width: int) -> int:
        return min(self.max_label_len, self.frames_for_bucket(bucket_width))

    def bucket_for_width(self, width: int) -> int:
        """Smallest bucket index whose width >= ``width``; -1 if wider than
        the ladder."""
        for i, bw in enumerate(self.bucket_widths):
            if width <= bw:
                return i
        return -1

    def clamp_width(self, width: int) -> int:
        return min(width, self.bucket_widths[-1])

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, payload: str) -> "ShapeContract":
        obj = json.loads(payload)
        obj["bucket_widths"] = tuple(obj["bucket_widths"])
        return cls(**obj)


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Resolved static shapes for one bucket."""

    width: int
    height: int
    frames: int
    label_len: int

    @classmethod
    def of(cls, contract: ShapeContract, bucket_idx: int) -> "BucketSpec":
        w = contract.bucket_widths[bucket_idx]
        return cls(
            width=w,
            height=contract.height,
            frames=contract.frames_for_bucket(w),
            label_len=contract.label_cap(w),
        )


def make_ladder(
    widths: Sequence[int],
    *,
    stride: int = 4,
    align: int = 128,
    max_waste: float = 0.10,
    max_width: int = 4096,
) -> Tuple[int, ...]:
    """Bucket ladder from a corpus width histogram
    (``vistaocr_tpu/data/buckets.py:128-172``): ``align``-aligned rungs,
    greedily merged (dropping the rung whose removal wastes least) while
    the padding waste sum(bucket_w - w) / sum(bucket_w) stays within
    ``max_waste``. The same rungs as the JAX function; the waste of a
    trial ladder is summed per occupied width with numpy instead of per
    line, so a corpus of thousands of lines takes milliseconds."""
    if len(widths) == 0:
        raise ValueError("empty width histogram")
    lcm = align if align % stride == 0 else align * stride // math.gcd(align, stride)
    clamped = np.minimum(np.asarray(widths, dtype=np.int64), max_width)
    uniq, counts = np.unique(clamped, return_counts=True)
    ladder = sorted({int(ceil_div(int(w), lcm) * lcm) for w in uniq})

    def waste(rungs) -> float:
        r = np.asarray(rungs, dtype=np.int64)
        bw = r[np.searchsorted(r, uniq, side="left")]
        tot = int((bw * counts).sum())
        return int(((bw - uniq) * counts).sum()) / max(tot, 1)

    improved = True
    while improved and len(ladder) > 1:
        improved = False
        best = None
        for i in range(len(ladder) - 1):  # the last rung stays
            w = waste(ladder[:i] + ladder[i + 1:])
            if w <= max_waste and (best is None or w < best[1]):
                best = (i, w)
        if best is not None:
            ladder.pop(best[0])
            improved = True
    return tuple(ladder)
