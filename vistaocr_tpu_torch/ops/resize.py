"""On-device line height-normalisation.

Counterpart of ``vistaocr_tpu/ops/resize.py:36-132``: a separable
PIL-BILINEAR triangle filter with per-sample (dynamic) scales. For output
pixel i at scale s (src/dst): center = (i+0.5)*s, filterscale =
max(s, 1), taps j weighted max(0, 1 - |j+0.5-center|/fs), normalised
over in-bounds taps. Callers keep raw dims within ``MAX_SCALE`` x the
output dims (the service integer-pools taller lines on the host first),
so ``TAPS`` taps cover every reachable scale. The host computes each
sample's normalised width and passes it in; the device never rounds.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_SCALE = 2
TAPS = 2 * MAX_SCALE + 2


def _axis_weights(out_size: int, scale: torch.Tensor,
                  in_size_valid: torch.Tensor):
    """Tap indices + normalised triangle weights for one axis.
    scale: [B] f32; in_size_valid: [B] int. Returns (idx [B, O, TAPS]
    int64, w [B, O, TAPS] f32)."""
    dev = scale.device
    i = torch.arange(out_size, dtype=torch.float32, device=dev)
    center = (i[None, :] + 0.5) * scale[:, None]  # [B, O]
    fs = torch.clamp(scale, min=1.0)[:, None]  # [B, 1]
    base = torch.floor(center - fs + 0.5).to(torch.int64)
    t = torch.arange(TAPS, dtype=torch.int64, device=dev)
    idx = base[:, :, None] + t[None, None, :]  # [B, O, TAPS]
    dist = (idx.to(torch.float32) + 0.5 - center[:, :, None]) / fs[:, :, None]
    w = torch.clamp(1.0 - dist.abs(), min=0.0)
    valid = in_size_valid.to(torch.int64)[:, None, None]
    inb = (idx >= 0) & (idx < valid)
    w = torch.where(inb, w, torch.zeros_like(w))
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-8)
    idx = torch.minimum(torch.clamp(idx, min=0), valid - 1)
    return idx, w


def resize_lines(
    raw: torch.Tensor,  # [B, Hr, Wr] uint8 (or float), 255-padded
    heights: torch.Tensor,  # [B] int32 true heights (<= Hr)
    widths: torch.Tensor,  # [B] int32 true raw widths (<= Wr)
    new_widths: torch.Tensor,  # [B] int32 host-computed normalised widths
    *,
    out_h: int,
    out_w: int,
) -> torch.Tensor:
    """Per-sample aspect resize to the contract height. Output
    [B, out_h, out_w] float32 in [0, 255]; columns >= new_widths are
    forced to 255 (paper)."""
    B, Hr, Wr = raw.shape
    x = raw.to(torch.float32)
    hf = heights.to(torch.float32)
    wf = widths.to(torch.float32)
    nwf = torch.clamp(new_widths.to(torch.float32), min=1.0)

    idx_y, w_y = _axis_weights(out_h, hf / float(out_h), heights)
    g = torch.gather(
        x, 1, idx_y.reshape(B, out_h * TAPS, 1).expand(B, out_h * TAPS, Wr)
    ).reshape(B, out_h, TAPS, Wr)
    x = (g * w_y[:, :, :, None]).sum(dim=2)  # [B, out_h, Wr]

    idx_x, w_x = _axis_weights(out_w, wf / nwf, widths)
    g = torch.gather(
        x, 2, idx_x.reshape(B, 1, out_w * TAPS).expand(B, out_h, out_w * TAPS)
    ).reshape(B, out_h, out_w, TAPS)
    x = (g * w_x[:, None, :, :]).sum(dim=3)  # [B, out_h, out_w]

    col = torch.arange(out_w, device=raw.device)
    keep = col[None, None, :] < new_widths.to(torch.int64)[:, None, None]
    return torch.where(keep, x, torch.full_like(x, 255.0))


def resized_to_uint8(x: torch.Tensor) -> torch.Tensor:
    """Quantise as PIL does: round half away from zero, clip."""
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0).to(torch.uint8)


def host_pool(img: np.ndarray, cap: int) -> np.ndarray:
    """[H, W] uint8 -> mean-pooled uint8 with height <= cap via an integer
    box filter (pads to a multiple of k with paper). Only runs for
    unusually tall inputs."""
    h, w = img.shape
    if h <= cap:
        return img
    k = -(-h // cap)
    ph = -(-h // k) * k
    pw = -(-w // k) * k
    if (ph, pw) != (h, w):
        pad = np.full((ph, pw), 255, np.uint8)
        pad[:h, :w] = img
        img = pad
    pooled = img.reshape(ph // k, k, pw // k, k).mean(axis=(1, 3))
    return np.clip(np.floor(pooled + 0.5), 0, 255).astype(np.uint8)
