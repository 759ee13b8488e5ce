"""Host-side image transforms in numpy, without PIL.

Counterpart of ``vistaocr_tpu/data/transforms.py``, byte for byte where
the JAX package converts or resizes with PIL:

- ``to_grayscale``: PIL's ``convert("L")`` of RGB and RGBA pixels, the
  integer luma ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16`` (alpha
  ignored); an object with ``.convert`` (a PIL image) is converted by its
  own method, so this module never imports PIL.
- ``height_normalize`` / ``normalize_line``: PIL's ``BILINEAR`` resize
  (``Image.resize``, Pillow's ``ImagingResample``), as two separable
  passes, horizontal then vertical, each with the triangle filter's
  support widened by the downscale factor, its weights normalised in
  double precision, rounded to 22-bit fixed point, and each output pixel
  rounded and clamped to uint8 after its pass.

Deskew (``do_deskew=True``) is not ported: it raises, naming its ROADMAP
item. Convention: stored lines are dark ink (0) on light paper (255).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

# PIL's fixed-point weights (Resample.c: PRECISION_BITS = 32 - 8 - 2)
_PRECISION_BITS = 22


def to_grayscale(img) -> np.ndarray:
    """Any PIL image or [H, W], [H, W, 1|3|4] array -> [H, W] uint8."""
    if not isinstance(img, np.ndarray):
        if not hasattr(img, "convert"):
            raise TypeError(f"unsupported image type {type(img).__name__}")
        return np.asarray(img.convert("L")).astype(np.uint8)
    if img.ndim == 2:
        return img.astype(np.uint8)
    if img.ndim == 3 and img.shape[2] in (1, 3, 4):
        if img.dtype != np.uint8:
            raise TypeError(f"colour arrays must be uint8, got {img.dtype}")
        if img.shape[2] == 1:
            return img[:, :, 0].copy()
        rgb = img[:, :, :3].astype(np.uint32)
        luma = (rgb[:, :, 0] * 19595 + rgb[:, :, 1] * 38470
                + rgb[:, :, 2] * 7471 + 0x8000) >> 16
        return luma.astype(np.uint8)
    raise ValueError(f"unsupported array shape {img.shape}")


def maybe_invert(img: np.ndarray) -> np.ndarray:
    """Ensure dark-ink-on-light-paper polarity: a mostly dark image
    (mean < 128) is a photographic negative and is flipped."""
    if float(img.mean()) < 128.0:
        return (255 - img).astype(np.uint8)
    return img


def _bilinear_weights(in_size: int,
                      out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    triangle filter over one axis: (first input index [out], fixed-point
    weights [out, taps] int64, zero past each pixel's support)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # the triangle's support (1) widened
    taps = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # (int)(x + 0.5): truncation toward zero, then clamped to the image
    first = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    last = np.minimum(np.trunc(center + support + 0.5), in_size)
    count = last.astype(np.int64) - first
    x = np.arange(taps)
    w = np.maximum(1.0 - np.abs(
        (x[None, :] + first[:, None] - center[:, None] + 0.5)
        * (1.0 / filterscale)), 0.0)
    w[x[None, :] >= count[:, None]] = 0.0
    total = np.zeros(out_size)
    for j in range(taps):  # summed in tap order, as the C loop does
        total = total + w[:, j]
    w = np.where(total[:, None] != 0.0,
                 w / np.where(total == 0.0, 1.0, total)[:, None], w)
    scaled = w * (1 << _PRECISION_BITS)
    fixed = np.where(scaled < 0, np.trunc(scaled - 0.5),
                     np.trunc(scaled + 0.5))
    return first, fixed.astype(np.int64)


def _clip8(acc: np.ndarray) -> np.ndarray:
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _resample_rows(img: np.ndarray, out_w: int) -> np.ndarray:
    """The horizontal pass: [h, w] uint8 -> [h, out_w] uint8."""
    w = img.shape[1]
    first, weights = _bilinear_weights(w, out_w)
    acc = np.full((img.shape[0], out_w), 1 << (_PRECISION_BITS - 1), np.int64)
    src = img.astype(np.int64)
    for j in range(weights.shape[1]):
        acc += src[:, np.minimum(first + j, w - 1)] * weights[:, j]
    return _clip8(acc)


def _resample_cols(img: np.ndarray, out_h: int) -> np.ndarray:
    """The vertical pass: [h, w] uint8 -> [out_h, w] uint8."""
    h = img.shape[0]
    first, weights = _bilinear_weights(h, out_h)
    acc = np.full((out_h, img.shape[1]), 1 << (_PRECISION_BITS - 1), np.int64)
    src = img.astype(np.int64)
    for j in range(weights.shape[1]):
        acc += src[np.minimum(first + j, h - 1), :] * weights[:, j, None]
    return _clip8(acc)


def _resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """PIL's ``Image.fromarray(img).resize((width, height), BILINEAR)`` of
    an [H, W] uint8 array of another size: the horizontal pass first,
    then the vertical one, each only where its size changes."""
    h, w = img.shape
    out = img
    if width != w:
        out = _resample_rows(out, width)
    if height != h:
        out = _resample_cols(out, height)
    return out


def height_normalize(
    img: np.ndarray, height: int, max_width: Optional[int] = None
) -> np.ndarray:
    """Scale [H, W] uint8 to the contract height, preserving aspect ratio;
    optionally clamp width by further rescaling (never truncation)."""
    h, w = img.shape
    new_w = max(1, round(w * height / h))
    if max_width is not None and new_w > max_width:
        new_w = max_width
    if (h, w) == (height, new_w):
        return img
    return _resize_bilinear(img, new_w, height)


def normalize_line(
    img,
    height: int,
    *,
    do_deskew: bool = False,
    max_width: Optional[int] = None,
) -> np.ndarray:
    """Full prep-time chain: grayscale -> polarity -> height normalize.
    Output is the shard-store format: [height, W] uint8."""
    if do_deskew:
        raise NotImplementedError(
            "do_deskew=True is not ported to vistaocr_tpu_torch yet "
            "(ROADMAP Queue 1: deskew)")
    arr = maybe_invert(to_grayscale(img))
    return height_normalize(arr, height, max_width=max_width)
