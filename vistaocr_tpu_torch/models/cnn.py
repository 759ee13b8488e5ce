"""CNN feature extractor.

Counterpart of ``vistaocr_tpu/models/cnn.py:28-112``: stages of
conv3x3 (bias-free, SAME) -> BatchNorm (eval, eps 1e-5) -> ReLU, each
stage closed by a max-pool. NCHW inside; the pooling uses
``ceil_mode=True`` because flax's SAME max-pool gives ``ceil(W/2)``
(``cnn.py:100-103``), which is what keeps the frame arithmetic
``ceil(width / width_stride)`` for widths that are not multiples of 4.

Parameters stay float32 (the JAX ``param_dtype``); ``forward`` casts them
to the compute dtype, as flax does inside each layer.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ConvStageSpec:
    """One stage: N same-channel 3x3 convs followed by a pool."""

    channels: int
    num_convs: int = 2
    pool: Tuple[int, int] = (2, 2)  # (pool_h, pool_w); (1, 1) = no pool


DEFAULT_STAGES: Tuple[ConvStageSpec, ...] = (
    ConvStageSpec(64, 2, (2, 2)),
    ConvStageSpec(128, 2, (2, 2)),
    ConvStageSpec(256, 2, (2, 1)),
)


def width_stride_of(stages: Sequence[ConvStageSpec]) -> int:
    s = 1
    for st in stages:
        s *= st.pool[1]
    return s


def height_stride_of(stages: Sequence[ConvStageSpec]) -> int:
    s = 1
    for st in stages:
        s *= st.pool[0]
    return s


class ConvStack(nn.Module):
    """``skip_first=True`` omits conv0_0 (the model's separate stem conv
    computes it) but still applies bn0_0 + ReLU, so the parameters line
    up with the JAX tree. ``in_channels`` is the input channel count of
    the first conv that this stack does run."""

    def __init__(self, stages: Tuple[ConvStageSpec, ...] = DEFAULT_STAGES,
                 *, in_channels: int = 1, skip_first: bool = False,
                 norm: str = "batch", pool_impl: str = "max"):
        super().__init__()
        if norm != "batch" or pool_impl != "max":
            raise NotImplementedError(
                f"conv_norm={norm!r}/conv_pool={pool_impl!r} ablation knobs "
                "are not ported yet (ROADMAP Queue 1, model ablations)"
            )
        self.stages = tuple(stages)
        self.skip_first = skip_first
        self.convs = nn.ModuleDict()
        self.bns = nn.ModuleDict()
        c_in = stages[0].channels if skip_first else in_channels
        for si, stage in enumerate(self.stages):
            for ci in range(stage.num_convs):
                if not (skip_first and si == 0 and ci == 0):
                    self.convs[f"conv{si}_{ci}"] = nn.Conv2d(
                        c_in, stage.channels, 3, padding=1, bias=False)
                self.bns[f"bn{si}_{ci}"] = nn.BatchNorm2d(
                    stage.channels, eps=1e-5)
                c_in = stage.channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C_in, H, W] -> [B, C_out, H', W'] in x's dtype (eval mode);
        W' = ceil(W / width_stride)."""
        dt = x.dtype
        for si, stage in enumerate(self.stages):
            for ci in range(stage.num_convs):
                name = f"conv{si}_{ci}"
                if name in self.convs:
                    x = F.conv2d(x, self.convs[name].weight.to(dt), padding=1)
                bn = self.bns[f"bn{si}_{ci}"]
                x = F.batch_norm(
                    x, bn.running_mean.to(dt), bn.running_var.to(dt),
                    bn.weight.to(dt), bn.bias.to(dt), training=False,
                    eps=bn.eps,
                )
                x = F.relu(x)
            if stage.pool != (1, 1):
                x = F.max_pool2d(x, stage.pool, stage.pool, ceil_mode=True)
        return x

    @property
    def width_stride(self) -> int:
        return width_stride_of(self.stages)

    @property
    def height_stride(self) -> int:
        return height_stride_of(self.stages)
