"""Host-side request transforms (numpy only).

Counterpart of ``vistaocr_tpu/data/transforms.py:27-46``. The serving
path needs only ``to_grayscale`` and ``maybe_invert``; the geometric
resize runs on the device (``ops/resize.py``). PIL is not used: colour
conversion of 3/4-channel arrays and PIL images is not ported yet and
raises ``NotImplementedError`` (ROADMAP Queue 1, "host prep").

Convention: stored lines are dark ink (0) on light paper (255).
"""

from __future__ import annotations

import numpy as np


def to_grayscale(img) -> np.ndarray:
    """[H, W] (or [H, W, 1]) array -> [H, W] uint8."""
    if not isinstance(img, np.ndarray):
        raise NotImplementedError(
            "PIL images are not accepted by the port yet (ROADMAP Queue 1, "
            "host prep); pass an [H, W] uint8 array"
        )
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim == 3 and img.shape[2] in (3, 4):
        raise NotImplementedError(
            "colour input needs PIL's 'L' conversion, not ported yet "
            "(ROADMAP Queue 1, host prep); pass a grayscale [H, W] array"
        )
    if img.ndim != 2:
        raise ValueError(f"unsupported array shape {img.shape}")
    return img.astype(np.uint8)


def maybe_invert(img: np.ndarray) -> np.ndarray:
    """Ensure dark-ink-on-light-paper polarity: a mostly dark image
    (mean < 128) is a photographic negative and is flipped."""
    if float(img.mean()) < 128.0:
        return (255 - img).astype(np.uint8)
    return img
