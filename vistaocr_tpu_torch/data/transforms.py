"""Host-side image transforms in numpy, without PIL.

Counterpart of ``vistaocr_tpu/data/transforms.py``, byte for byte where
the JAX package converts, resizes or rotates with PIL:

- ``to_grayscale``: PIL's ``convert("L")`` of RGB and RGBA pixels, the
  integer luma ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16`` (alpha
  ignored); an object with ``.convert`` (a PIL image) is converted by its
  own method, so this module never imports PIL.
- ``height_normalize`` / ``normalize_line``: PIL's ``BILINEAR`` resize
  (``Image.resize``, Pillow's ``ImagingResample``), as two separable
  passes, horizontal then vertical, each with the filter's support
  widened by the downscale factor, its weights normalised in double
  precision, rounded to 22-bit fixed point, and each output pixel
  rounded and clamped to uint8 after its pass. ``estimate_skew``'s
  subsampling uses PIL's default filter for mode ``L``, ``BICUBIC``
  (a = -0.5, support 2), through the same passes.
- ``estimate_skew`` / ``deskew`` (``do_deskew=True``): PIL's
  ``rotate(angle, BILINEAR, expand=..., fillcolor=...)``: the inverse
  affine matrix with entries ``round(cos, 15)``, the expanded size from
  the rotated corners (``ceil`` / ``floor``), each output pixel centre
  mapped back in double precision, two-tap interpolation in each axis
  with the edge taps clamped, truncated to uint8; pixels whose centre
  maps outside the source keep the fill colour. An angle of exactly 0
  (``estimate_skew``'s middle candidate) is PIL's copy.

Convention: stored lines are dark ink (0) on light paper (255).
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


def _bilinear_filter(x: np.ndarray) -> np.ndarray:
    return np.maximum(1.0 - np.abs(x), 0.0)


def _bicubic_filter(x: np.ndarray) -> np.ndarray:
    """Resample.c's ``bicubic_filter`` with a = -0.5, term for term."""
    x = np.abs(x)
    near = ((-0.5 + 2.0) * x - (-0.5 + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * -0.5
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


# PIL's filters by name: (filter, support before widening)
_FILTERS = {"bilinear": (_bilinear_filter, 1.0),
            "bicubic": (_bicubic_filter, 2.0)}


def _resample_weights(in_size: int, out_size: int,
                      kind: str) -> Tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for one
    axis: (first input index [out], fixed-point weights [out, taps]
    int64, zero past each pixel's support)."""
    filt, base_support = _FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    taps = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # (int)(x + 0.5): truncation toward zero, then clamped to the image
    first = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    last = np.minimum(np.trunc(center + support + 0.5), in_size)
    count = last.astype(np.int64) - first
    x = np.arange(taps)
    w = filt((x[None, :] + first[:, None] - center[:, None] + 0.5)
             * (1.0 / filterscale))
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


def _resample_rows(img: np.ndarray, out_w: int, kind: str) -> np.ndarray:
    """The horizontal pass: [h, w] uint8 -> [h, out_w] uint8."""
    w = img.shape[1]
    first, weights = _resample_weights(w, out_w, kind)
    acc = np.full((img.shape[0], out_w), 1 << (_PRECISION_BITS - 1), np.int64)
    src = img.astype(np.int64)
    for j in range(weights.shape[1]):
        acc += src[:, np.minimum(first + j, w - 1)] * weights[:, j]
    return _clip8(acc)


def _resample_cols(img: np.ndarray, out_h: int, kind: str) -> np.ndarray:
    """The vertical pass: [h, w] uint8 -> [out_h, w] uint8."""
    h = img.shape[0]
    first, weights = _resample_weights(h, out_h, kind)
    acc = np.full((out_h, img.shape[1]), 1 << (_PRECISION_BITS - 1), np.int64)
    src = img.astype(np.int64)
    for j in range(weights.shape[1]):
        acc += src[np.minimum(first + j, h - 1), :] * weights[:, j, None]
    return _clip8(acc)


def _resize(img: np.ndarray, width: int, height: int,
            kind: str = "bilinear") -> np.ndarray:
    """PIL's ``Image.fromarray(img).resize((width, height), kind)`` of an
    [H, W] uint8 array: the horizontal pass first, then the vertical
    one, each only where its size changes (the same size is PIL's
    copy)."""
    h, w = img.shape
    out = img
    if width != w:
        out = _resample_rows(out, width, kind)
    if height != h:
        out = _resample_cols(out, height, kind)
    return out


def _rotate(img: np.ndarray, angle: float, *, expand: bool,
            fillcolor: int) -> np.ndarray:
    """PIL's ``Image.fromarray(img).rotate(angle, BILINEAR, expand=expand,
    fillcolor=fillcolor)`` of an [H, W] uint8 array (``Image.rotate`` and
    Geometry.c's ``affine_transform`` / ``bilinear_filter8``)."""
    angle = angle % 360.0
    if angle == 0:
        return img.copy()
    if angle == 180:
        return np.ascontiguousarray(img[::-1, ::-1])
    h, w = img.shape
    if angle in (90, 270) and (expand or w == h):
        return np.ascontiguousarray(np.rot90(img, 1 if angle == 90 else -1))
    cx, cy = w / 2, h / 2
    rad = -math.radians(angle)
    m = [round(math.cos(rad), 15), round(math.sin(rad), 15), 0.0,
         round(-math.sin(rad), 15), round(math.cos(rad), 15), 0.0]

    def transform(x, y):
        a, b, c, d, e, f = m
        return a * x + b * y + c, d * x + e * y + f

    m[2], m[5] = transform(-cx, -cy)
    m[2] += cx
    m[5] += cy
    if expand:
        corners = [transform(x, y) for x, y in ((0, 0), (w, 0), (w, h),
                                                 (0, h))]
        xx = [c[0] for c in corners]
        yy = [c[1] for c in corners]
        nw = math.ceil(max(xx)) - math.floor(min(xx))
        nh = math.ceil(max(yy)) - math.floor(min(yy))
        m[2], m[5] = transform(-(nw - w) / 2.0, -(nh - h) / 2.0)
        w_out, h_out = nw, nh
    else:
        w_out, h_out = w, h
    xo = np.arange(w_out, dtype=np.float64)[None, :] + 0.5
    yo = np.arange(h_out, dtype=np.float64)[:, None] + 0.5
    xin = m[0] * xo + m[1] * yo + m[2]
    yin = m[3] * xo + m[4] * yo + m[5]
    inside = (xin >= 0.0) & (xin < w) & (yin >= 0.0) & (yin < h)
    xin = xin - 0.5
    yin = yin - 0.5
    x = np.floor(xin)
    y = np.floor(yin)
    dx = xin - x
    dy = yin - y
    x = x.astype(np.int64)
    y = y.astype(np.int64)
    src = img.astype(np.float64)
    x0 = np.clip(x, 0, w - 1)
    x1 = np.clip(x + 1, 0, w - 1)
    row0 = np.clip(y, 0, h - 1)
    has_row1 = (y + 1 >= 0) & (y + 1 < h)
    row1 = np.clip(y + 1, 0, h - 1)
    a, b = src[row0, x0], src[row0, x1]
    v1 = a + (b - a) * dx
    a, b = src[row1, x0], src[row1, x1]
    v2 = np.where(has_row1, a + (b - a) * dx, v1)
    v1 = v1 + (v2 - v1) * dy
    out = np.full((h_out, w_out), fillcolor, np.uint8)
    out[inside] = v1[inside].astype(np.uint8)  # (UINT8) truncation
    return out


def estimate_skew(img: np.ndarray, max_angle: float = 5.0,
                  steps: int = 21) -> float:
    """Projection-profile skew estimate in degrees: the candidate angle
    whose rotation of the ink maximises the variance of the row profile
    (the first maximum wins)."""
    h, w = img.shape
    if w < 8 or h < 8:
        return 0.0
    small = img
    if w > 512:  # subsample for speed; the estimate is scale-invariant
        small = _resize(img, 512, max(8, int(h * 512 / w)), "bicubic")
    ink = (255.0 - small.astype(np.float32)).astype(np.uint8)
    best_angle, best_score = 0.0, -1.0
    for a in np.linspace(-max_angle, max_angle, steps):
        rot = _rotate(ink, float(a), expand=False,
                      fillcolor=0).astype(np.float32)
        score = float(rot.sum(axis=1).var())
        if score > best_score:
            best_score, best_angle = score, float(a)
    return best_angle


def deskew(img: np.ndarray, max_angle: float = 5.0) -> np.ndarray:
    """Rotate by the estimated skew onto a paper (255) background, the
    canvas expanded to hold the whole line; below 0.25 degrees the input
    comes back unchanged."""
    angle = estimate_skew(img, max_angle=max_angle)
    if abs(angle) < 0.25:
        return img
    return _rotate(img, angle, expand=True, fillcolor=255)


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
    return _resize(img, new_w, height)


def normalize_line(
    img,
    height: int,
    *,
    do_deskew: bool = False,
    max_width: Optional[int] = None,
) -> np.ndarray:
    """Full prep-time chain: grayscale -> polarity -> (deskew) -> height
    normalize. Output is the shard-store format: [height, W] uint8."""
    arr = maybe_invert(to_grayscale(img))
    if do_deskew:
        arr = deskew(arr)
    return height_normalize(arr, height, max_width=max_width)
