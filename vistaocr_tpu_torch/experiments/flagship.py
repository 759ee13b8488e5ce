"""The flagship model's forward with both experiments in place: the fused
stem (``stem_cuda.fused_stem``) instead of ``preprocess_images`` +
``F.conv2d``, and the direction-stacked layer
(``lstm_bi_stacked.bilstm_layer_stacked``) instead of ``BLSTMStack``'s
recurrence, on the model's own parameters. It measures the experiments on
the production model; the production model never calls it.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..models import CnnLstmOcr
from .lstm_bi_stacked import bilstm_layer_stacked
from .stem_cuda import fused_stem


def forward_with_experiments(model: CnnLstmOcr, images: torch.Tensor,
                             widths: torch.Tensor, *, train: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``model.forward(images, widths, train)`` with the experiments'
    kernels: (log_probs [B, T, K], frame_mask [B, T]). Dropout and augment
    draw random numbers outside the fused ops, so a train-mode call needs
    a config with both off."""
    cfg = model.config
    if train and (cfg.dropout > 0 or cfg.augment > 0):
        raise ValueError("forward_with_experiments runs with dropout and "
                         "augment off (ModelConfig dropout=0, augment=0)")
    dt = cfg.dtype
    x = fused_stem(images, widths, model.stem_kernel, cfg.standardize_input,
                   dt)  # [B, C0, H, W]
    x = model.cnn(x, train=train)
    # From here on a copy of CnnLstmOcr.forward (models/cnnlstm.py:132-146,
    # the reshape, frame mask, bridge and head) with the stacked layer in
    # BLSTMStack's place: a change there must be made here too.
    b, c, hp, t = x.shape
    x = x.permute(0, 3, 2, 1).reshape(b, t, hp * c)  # C fastest
    frames = -(-widths.to(torch.int64) // cfg.width_stride)
    frame_mask = torch.arange(t, device=x.device)[None, :] < frames[:, None]
    x = F.relu(F.linear(x, model.bridge.weight.to(dt), model.bridge.bias.to(dt)))
    stack = model.blstm
    for k in range(stack.layers):
        p = [getattr(stack, f"l{k}_{d}_{n}") for d in ("fwd", "bwd")
             for n in ("wx", "wh", "b")]
        x = bilstm_layer_stacked(x, frame_mask, *p, dtype=dt).to(dt)
    logits = model.head(x.to(torch.float32))
    return torch.log_softmax(logits, dim=-1), frame_mask
