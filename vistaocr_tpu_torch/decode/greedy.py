"""Greedy CTC decoding.

Counterpart of ``vistaocr_tpu/decode/greedy.py:22-82``. The argmax, the
repeat collapse and the packed best-path score run on the device; the
host only filters zeros out of one int32 row per line.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..text import Alphabet

# Fixed-point scale of the packed best-path score column (nats * 1000).
SCORE_SCALE = 1000.0


def greedy_frames(log_probs: torch.Tensor,
                  frame_mask: torch.Tensor) -> torch.Tensor:
    """[B, T, K] log-probs + [B, T] bool mask -> [B, T] int32 holding the
    frame's symbol if it is valid, non-blank and differs from the previous
    frame's argmax, else 0."""
    best = torch.argmax(log_probs, dim=-1).to(torch.int32)
    zero = torch.zeros_like(best)
    best = torch.where(frame_mask, best, zero)
    prev = F.pad(best[:, :-1], (1, 0))
    fresh = (best != 0) & (best != prev) & frame_mask
    return torch.where(fresh, best, zero)


def greedy_frames_packed(log_probs: torch.Tensor,
                         frame_mask: torch.Tensor) -> torch.Tensor:
    """``greedy_frames`` plus one int32 column holding
    ``round(clip(sum_t max_c log p_t(c) * SCORE_SCALE, -2e9, 0))`` over
    valid frames: [B, T+1], one device->host copy per batch."""
    frames = greedy_frames(log_probs, frame_mask)
    best = torch.amax(log_probs, dim=-1)
    s = torch.where(frame_mask, best, torch.zeros_like(best)).sum(dim=-1)
    packed = torch.round(
        torch.clamp(s * SCORE_SCALE, -2.0e9, 0.0)).to(torch.int32)
    return torch.cat([frames, packed[:, None]], dim=1)


def collapse_frames(frames_row: np.ndarray, alphabet: Alphabet) -> str:
    """One sample's device output row -> uxxxx transcript string."""
    ids = frames_row[frames_row != 0]
    return alphabet.decode(ids.tolist())


def greedy_decode(
    log_probs: torch.Tensor,
    frame_mask: torch.Tensor,
    alphabet: Alphabet,
    valid: Optional[np.ndarray] = None,
) -> List[str]:
    """Batch greedy decode -> uxxxx transcripts; samples marked
    ``valid=False`` are skipped."""
    frames = greedy_frames(log_probs, frame_mask).cpu().numpy()
    out = []
    for b in range(frames.shape[0]):
        if valid is not None and not valid[b]:
            continue
        out.append(collapse_frames(frames[b], alphabet))
    return out
