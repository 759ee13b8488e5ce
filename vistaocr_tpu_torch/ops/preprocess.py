"""On-device image preprocessing.

Counterpart of ``vistaocr_tpu/ops/preprocess.py:29-51``: polarity flip
(ink = 1, paper = 0), width mask, and per-image standardisation over the
VALID region only (``n = max(w*h, 1)``, ``rsqrt(var + eps)``), with the
padding forced back to exactly 0. Plain elementwise work and two small
reductions: no kernel of its own. ``augment_images`` is the train-time
degradation of ``vistaocr_tpu/ops/preprocess.py:54-83``.
"""

from __future__ import annotations

import torch


def preprocess_images(
    images: torch.Tensor,  # [B, H, W] uint8
    widths: torch.Tensor,  # [B] int32 true pixel widths
    *,
    standardize: bool = True,
    dtype: torch.dtype = torch.float32,
    eps: float = 1e-6,
) -> torch.Tensor:
    """uint8 line images -> normalised [B, H, W, 1] feature maps."""
    if images.dtype != torch.uint8:
        raise TypeError(f"expected uint8 images, got {images.dtype}")
    b, h, w = images.shape
    x = (255.0 - images.to(torch.float32)) * (1.0 / 255.0)
    col = torch.arange(w, device=images.device, dtype=torch.int32)
    mask = (col[None, None, :] < widths.to(torch.int32)[:, None, None]).to(
        torch.float32)
    x = x * mask
    if standardize:
        n = torch.clamp(widths.to(torch.float32) * h, min=1.0)[:, None, None]
        mean = x.sum(dim=(1, 2), keepdim=True) / n
        var = ((x - mean) ** 2 * mask).sum(dim=(1, 2), keepdim=True) / n
        x = (x - mean) * torch.rsqrt(var + eps)
        x = x * mask
    return x.to(dtype)[..., None]


def augment_images(
    x: torch.Tensor,  # [B, H, W, 1] preprocessed (ink-positive) images
    widths: torch.Tensor,  # [B]
    generator: torch.Generator,
    *,
    strength: float = 1.0,
) -> torch.Tensor:
    """Train-time degradation: per-image contrast jitter
    ``x * U[1-0.2s, 1+0.2s]``, per-image shift ``+ U[-0.1s, 0.1s]`` and
    pixel noise ``N(0, 0.05s)``, with the width mask re-applied so padding
    stays exactly 0. Every draw comes from ``generator`` (on x's device);
    the draws cannot match JAX's."""
    b, h, w, _ = x.shape
    kw = dict(generator=generator, device=x.device)
    contrast = 1.0 + (torch.rand((b, 1, 1, 1), **kw) * 0.4 - 0.2) * strength
    shift = (torch.rand((b, 1, 1, 1), **kw) * 0.2 - 0.1) * strength
    noise = torch.randn(x.shape, **kw) * (0.05 * strength)
    col = torch.arange(w, device=x.device)
    mask = (col[None, None, :] < widths.to(x.device)[:, None, None]).to(
        x.dtype)[..., None]
    out = (x * contrast.to(x.dtype) + shift.to(x.dtype) + noise.to(x.dtype))
    return out * mask
