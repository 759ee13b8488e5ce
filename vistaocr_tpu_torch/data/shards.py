"""Sharded line-image store, numpy only.

A copy of ``vistaocr_tpu/data/shards.py:37-285`` (``ShardWriter``,
``write_manifest``, ``ShardedLineDataset``, ``ConcatLineDataset``,
``open_dataset``): the same on-disk format, so a shard directory written
by either package reads in both (``tests/test_torch_port_train.py``). The
JAX module's notes follow.

The reference stores PNG-encoded line crops in LMDB keyed by line id
(SURVEY.md C6 [M]). The rebuild's store is designed for a zero-copy host
pipeline feeding a TPU:

- Images are height-normalized at PREP time (fixed ``height`` rows,
  grayscale uint8), so the online path is a pure memcpy: no decode, no
  resize, no PIL in the hot loop.
- Each shard is a flat binary file of concatenated row-major [H, W_i]
  uint8 images, memory-mapped at read time; an index JSON carries
  (id, offset, width, transcript) per line.
- Transcripts are uxxxx strings (C1), so the store is
  alphabet-independent; alphabets are built over manifests.

Layout::

    dataset_dir/
      manifest.json                  # height, splits -> shard lists
      shards/<split>-00000.bin       # concatenated uint8 line images
      shards/<split>-00000.idx.json  # per-line index entries

Reference parity: replaces src/ocr_dataset.py's LMDB env + JSON split
descriptor (SURVEY.md C6) with an equivalent self-describing artifact.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np


@dataclass
class LineRecord:
    """One text line: pixels + transcript + identity."""

    id: str
    image: np.ndarray  # [H, W] uint8, H == dataset height
    transcript: str  # uxxxx string
    width: int

    @property
    def text(self) -> str:
        from ..text import uxxxx_to_utf8

        return uxxxx_to_utf8(self.transcript)


class ShardWriter:
    """Writes one split's shards. Images must already be height-normalized
    [H, W] uint8 arrays (use data.transforms.normalize_line)."""

    def __init__(
        self,
        dataset_dir: str,
        split: str,
        height: int,
        max_shard_bytes: int = 512 * 1024 * 1024,
    ):
        self.dataset_dir = dataset_dir
        self.split = split
        self.height = height
        self.max_shard_bytes = max_shard_bytes
        self._shard_idx = -1
        self._bin = None
        self._offset = 0
        self._entries: List[dict] = []
        self._shards: List[str] = []
        os.makedirs(os.path.join(dataset_dir, "shards"), exist_ok=True)

    def _roll(self):
        self._flush_index()
        self._shard_idx += 1
        name = f"{self.split}-{self._shard_idx:05d}"
        self._shards.append(name)
        path = os.path.join(self.dataset_dir, "shards", name + ".bin")
        if self._bin:
            self._bin.close()
        self._bin = open(path, "wb")
        self._offset = 0
        self._entries = []

    def _flush_index(self):
        if self._shard_idx >= 0 and self._entries:
            name = self._shards[self._shard_idx]
            path = os.path.join(self.dataset_dir, "shards", name + ".idx.json")
            with open(path, "w") as f:
                json.dump(self._entries, f, ensure_ascii=False)

    def add(self, line_id: str, image: np.ndarray, transcript_uxxxx: str):
        if image.dtype != np.uint8 or image.ndim != 2 or image.shape[0] != self.height:
            raise ValueError(
                f"image must be [height={self.height}, W] uint8, got "
                f"{image.shape} {image.dtype}"
            )
        if self._bin is None or self._offset >= self.max_shard_bytes:
            self._roll()
        data = np.ascontiguousarray(image).tobytes()
        self._bin.write(data)
        self._entries.append(
            {
                "id": line_id,
                "offset": self._offset,
                "width": int(image.shape[1]),
                "transcript": transcript_uxxxx,
            }
        )
        self._offset += len(data)

    def close(self) -> List[str]:
        self._flush_index()
        if self._bin:
            self._bin.close()
            self._bin = None
        return list(self._shards)


def write_manifest(
    dataset_dir: str,
    height: int,
    splits: Dict[str, List[str]],
    extra: Optional[dict] = None,
):
    manifest = {"version": 1, "height": height, "splits": splits}
    if extra:
        manifest.update(extra)
    with open(os.path.join(dataset_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2, ensure_ascii=False)


class ShardedLineDataset:
    """Memory-mapped reader over one split. Random access by index; the
    mmap makes repeated epoch sweeps hit the page cache, not disk."""

    def __init__(self, dataset_dir: str, split: str):
        self.dataset_dir = dataset_dir
        self.split = split
        with open(os.path.join(dataset_dir, "manifest.json")) as f:
            self.manifest = json.load(f)
        self.height = int(self.manifest["height"])
        if split not in self.manifest["splits"]:
            raise KeyError(
                f"split {split!r} not in manifest (has {list(self.manifest['splits'])})"
            )
        self._mmaps: List[np.memmap] = []
        self._index: List[tuple] = []  # (shard_no, offset, width, id, transcript)
        for shard_name in self.manifest["splits"][split]:
            base = os.path.join(dataset_dir, "shards", shard_name)
            mm = np.memmap(base + ".bin", dtype=np.uint8, mode="r")
            shard_no = len(self._mmaps)
            self._mmaps.append(mm)
            with open(base + ".idx.json") as f:
                for e in json.load(f):
                    self._index.append(
                        (shard_no, e["offset"], e["width"], e["id"], e["transcript"])
                    )

    def __len__(self) -> int:
        return len(self._index)

    @property
    def widths(self) -> np.ndarray:
        return np.array([e[2] for e in self._index], dtype=np.int32)

    def transcript(self, i: int) -> str:
        return self._index[i][4]

    def ids(self) -> List[str]:
        return [e[3] for e in self._index]

    def id(self, i: int) -> str:
        return self._index[i][3]

    def transcripts(self) -> Iterator[str]:
        for e in self._index:
            yield e[4]

    def __getitem__(self, i: int) -> LineRecord:
        shard_no, offset, width, line_id, transcript = self._index[i]
        nbytes = self.height * width
        flat = self._mmaps[shard_no][offset : offset + nbytes]
        image = np.asarray(flat).reshape(self.height, width)
        return LineRecord(id=line_id, image=image, transcript=transcript, width=width)

    def read_into(self, i: int, out: np.ndarray) -> int:
        """Copy line ``i``'s pixels into ``out[:, :width]`` (a [H, Wb] uint8
        batch slot). Returns the true width. The single memcpy per line is
        the entire online decode path."""
        shard_no, offset, width, _, _ = self._index[i]
        w = min(width, out.shape[1])
        nbytes = self.height * width
        img = np.asarray(self._mmaps[shard_no][offset : offset + nbytes]).reshape(
            self.height, width
        )
        out[:, :w] = img[:, :w]
        return w


class ConcatLineDataset:
    """Several splits (usually the same split of several corpora) viewed
    as one dataset — the joint-training recipe (e.g. real IAM + synthetic
    lines, configs #2/#3 era practice). All parts must share the contract
    height; indices concatenate in argument order. Exposes exactly the
    surface BatchPipeline consumes (height, widths, transcript, read_into,
    ids, len)."""

    def __init__(self, parts: List["ShardedLineDataset"]):
        if not parts:
            raise ValueError("ConcatLineDataset needs at least one part")
        heights = {p.height for p in parts}
        if len(heights) != 1:
            raise ValueError(f"mixed dataset heights: {sorted(heights)}")
        self.parts = list(parts)
        self.height = parts[0].height
        self._offsets = np.cumsum([0] + [len(p) for p in parts])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def _loc(self, i: int):
        p = int(np.searchsorted(self._offsets, i, side="right") - 1)
        return self.parts[p], i - int(self._offsets[p])

    @property
    def widths(self) -> np.ndarray:
        return np.concatenate([p.widths for p in self.parts])

    def transcript(self, i: int) -> str:
        part, j = self._loc(i)
        return part.transcript(j)

    def transcripts(self) -> Iterator[str]:
        for p in self.parts:
            yield from p.transcripts()

    def ids(self) -> List[str]:
        out: List[str] = []
        for p in self.parts:
            out.extend(p.ids())
        return out

    def id(self, i: int) -> str:
        part, j = self._loc(i)
        return part.id(j)

    def __getitem__(self, i: int) -> LineRecord:
        part, j = self._loc(i)
        return part[j]

    def read_into(self, i: int, out: np.ndarray) -> int:
        part, j = self._loc(i)
        return part.read_into(j, out)


def open_dataset(spec: str, split: str):
    """Open one split from a dataset spec: a directory, or several
    comma-separated directories concatenated (joint training). Parts
    missing the split are skipped; raises KeyError when none has it."""
    dirs = [d for d in spec.split(",") if d]
    parts = []
    missing = []
    for d in dirs:
        try:
            parts.append(ShardedLineDataset(d, split))
        except KeyError:
            missing.append(d)
    if not parts:
        raise KeyError(
            f"split {split!r} missing from every dataset in {spec!r}"
        )
    if missing:
        import warnings

        warnings.warn(
            f"split {split!r} missing from {missing}; training/eval uses "
            f"only {[d for d in dirs if d not in missing]}",
            stacklevel=2,
        )
    if len(parts) == 1:
        return parts[0]
    return ConcatLineDataset(parts)
