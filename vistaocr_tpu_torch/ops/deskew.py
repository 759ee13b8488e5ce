"""On-device deskew: estimate each line's skew and undo it by a shear.

Counterpart of ``vistaocr_tpu/ops/deskew.py:37-112``, the same estimator
and correction: score a fan of candidate angles by the variance of the
ink row-profile of the vertically sheared line (``y' = y + (x-cx)tan``,
nearest row), take the best angle per sample, and apply the inverse
vertical shear with bilinear interpolation along H and background fill.
A shear keeps the width, so the routed bucket stays valid. Plain PyTorch
on the images' device: the JAX function is ``jnp`` under ``jit`` (no
Pallas kernel); the fan is a loop of 21 angles, as ``jax.lax.map`` runs
it.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

# Candidate fan matching the host estimator's defaults.
MAX_ANGLE_DEG = 5.0
NUM_ANGLES = 21


def _angles() -> list:
    """tan of each candidate angle, float32 values as Python floats."""
    t = torch.tensor(
        [math.tan(math.radians(a))
         for a in [-MAX_ANGLE_DEG + i * (2 * MAX_ANGLE_DEG)
                   / (NUM_ANGLES - 1) for i in range(NUM_ANGLES)]],
        dtype=torch.float32)
    return t.tolist()


def _centered_columns(widths: torch.Tensor, W: int) -> torch.Tensor:
    """[B, W] column offsets from each line's centre, (w - 1) / 2."""
    x = torch.arange(W, dtype=torch.float32, device=widths.device)
    return x[None, :] - (widths[:, None].float() - 1.0) / 2.0


def estimate_skew_tan(
    images: torch.Tensor,  # [B, H, W] uint8 (255 = background)
    widths: torch.Tensor,  # [B] true widths
) -> torch.Tensor:
    """Per-sample tan(skew angle), chosen from the candidate fan by the
    largest row-profile variance of the sheared ink image."""
    B, H, W = images.shape
    dev = images.device
    ink = 255.0 - images.float()
    col_mask = (torch.arange(W, device=dev)[None, :]
                < widths[:, None]).float()
    ink = ink * col_mask[:, None, :]
    x = _centered_columns(widths, W)
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    angles = _angles()
    scores = []
    for tan_a in angles:
        # profile[b, y] = sum_x ink[b, y + x*tan, x] (nearest row; rows
        # sheared in from outside contribute 0)
        src = ys[None, :, None] + x[:, None, :] * tan_a  # [B, H, W]
        idx = torch.clamp(torch.round(src).long(), 0, H - 1)
        inb = (src >= -0.5) & (src <= H - 0.5)
        gathered = torch.gather(ink, 1, idx)
        profile = torch.where(inb, gathered, 0.0).sum(dim=2)  # [B, H]
        scores.append(profile.var(dim=1, unbiased=False))
    best = torch.argmax(torch.stack(scores), dim=0)  # [B]
    return torch.tensor(angles, dtype=torch.float32, device=dev)[best]


def shear_deskew(
    images: torch.Tensor,  # [B, H, W] uint8
    widths: torch.Tensor,  # [B]
    tan_theta: torch.Tensor,  # [B] from estimate_skew_tan
) -> torch.Tensor:
    """The inverse vertical shear with bilinear interpolation along H;
    background (255) fills rows sheared in from outside. uint8 out."""
    B, H, W = images.shape
    img_f = images.float()
    x = _centered_columns(widths, W)
    ys = torch.arange(H, dtype=torch.float32, device=images.device)
    src = ys[None, :, None] + x[:, None, :] * tan_theta[:, None, None]
    lo = torch.clamp(torch.floor(src).long(), 0, H - 1)
    hi = torch.clamp(lo + 1, 0, H - 1)
    frac = src - lo.float()
    v = (torch.gather(img_f, 1, lo) * (1.0 - frac)
         + torch.gather(img_f, 1, hi) * frac)
    inb = (src >= 0.0) & (src <= H - 1.0)
    out = torch.where(inb, v, 255.0)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def device_deskew(images: torch.Tensor,
                  widths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Estimate and correct. Returns (deskewed uint8 [B, H, W], tan_theta
    [B]). A sample whose best angle is the fan's near-zero bin passes
    through unchanged (its shear is snapped to exactly 0)."""
    tan_theta = estimate_skew_tan(images, widths)
    tan_theta = torch.where(
        tan_theta.abs() < math.tan(math.radians(0.25)), 0.0, tan_theta)
    return shear_deskew(images, widths, tan_theta), tan_theta
