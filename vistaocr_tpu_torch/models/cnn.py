"""CNN feature extractor.

Counterpart of ``vistaocr_tpu/models/cnn.py:28-112``: stages of
conv3x3 (bias-free, SAME) -> BatchNorm (eps 1e-5) -> ReLU, each stage
closed by a max-pool. NCHW inside; the pooling uses
``ceil_mode=True`` because flax's SAME max-pool gives ``ceil(W/2)``
(``cnn.py:100-103``), which is what keeps the frame arithmetic
``ceil(width / width_stride)`` for widths that are not multiples of 4.

The JAX ablation knobs (``cnn.py:87-104``): ``norm="none"`` runs no
BatchNorm and holds no ``bns``; ``pool_impl="stride"`` subsamples,
``x[:, :, ::p0, ::p1]``, which gives the same ``ceil(W/p)`` frames.

Parameters stay float32 (the JAX ``param_dtype``); ``forward`` casts them
to the compute dtype, as flax does inside each layer.

BatchNorm follows flax ``nn.BatchNorm`` (``momentum=0.9``): eval mode
normalises with the running statistics; train mode (``batch_norm_train``)
normalises with the batch statistics, taken in float32 over every
position of the batch (padding included) with the biased variance
``E[x^2] - E[x]^2`` clamped at 0, and updates the running statistics as
``0.9 * running + 0.1 * batch`` with that biased variance (torch's own
``BatchNorm2d`` update would use the unbiased one). Under data
parallelism (a ``group`` of ranks, each with its rows of the global
batch) the statistics are those of the global batch, as GSPMD computes
flax's: the per-channel sums of x and x^2 are summed over the group
inside autograd, so the backward sums their gradient terms too.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import all_reduce_sum


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


NORMS = ("batch", "none")
POOLS = ("max", "stride")


def pool(x: torch.Tensor, window: Tuple[int, int], impl: str) -> torch.Tensor:
    """A stage's pool on NCHW ``x`` (any memory format): flax's SAME
    max-pool (``ceil_mode``), or the ``"stride"`` subsample; both give
    ``ceil(W / p)`` columns."""
    if window == (1, 1):
        return x
    if impl == "stride":
        return x[:, :, :: window[0], :: window[1]]
    return F.max_pool2d(x, window, window, ceil_mode=True)


BN_MOMENTUM = 0.9  # flax convention: running = m * running + (1 - m) * batch


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d,
                     group=None) -> torch.Tensor:
    """flax ``BatchNorm(use_running_average=False)`` on NCHW ``x``:
    statistics in f32 over (N, H, W), ``y = (x - mean) * (scale *
    rsqrt(var + eps)) + bias`` in f32, cast back to x's dtype; the running
    statistics of ``bn`` are updated in place (outside autograd). With a
    ``group``, N runs over every rank's rows (each rank holds as many)."""
    xf = x.to(torch.float32)
    if group is None:
        mean = xf.mean(dim=(0, 2, 3))
        sq = (xf * xf).mean(dim=(0, 2, 3))
    else:
        sums = all_reduce_sum(torch.stack([xf.sum(dim=(0, 2, 3)),
                                           (xf * xf).sum(dim=(0, 2, 3))]),
                              group)
        count = xf.numel() // xf.shape[1] * torch.distributed.get_world_size(
            group)
        mean, sq = sums[0] / count, sums[1] / count
    var = torch.clamp(sq - mean * mean, min=0.0)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]
    with torch.no_grad():
        m = BN_MOMENTUM
        bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean)
        bn.running_var.copy_(m * bn.running_var + (1 - m) * var)
    return y.to(x.dtype)


class ConvStack(nn.Module):
    """``skip_first=True`` omits conv0_0 (the model's separate stem conv
    computes it) but still applies bn0_0 (under ``norm="batch"``) + ReLU,
    so the parameters line up with the JAX tree. ``in_channels`` is the input channel count of
    the first conv that this stack does run."""

    def __init__(self, stages: Tuple[ConvStageSpec, ...] = DEFAULT_STAGES,
                 *, in_channels: int = 1, skip_first: bool = False,
                 norm: str = "batch", pool_impl: str = "max"):
        super().__init__()
        if norm not in NORMS:
            raise ValueError(f"unknown conv_norm {norm!r}; one of {NORMS}")
        if pool_impl not in POOLS:
            raise ValueError(
                f"unknown conv_pool {pool_impl!r}; one of {POOLS}")
        self.stages = tuple(stages)
        self.skip_first = skip_first
        self.norm = norm
        self.pool_impl = pool_impl
        self.convs = nn.ModuleDict()
        self.bns = nn.ModuleDict()
        c_in = stages[0].channels if skip_first else in_channels
        for si, stage in enumerate(self.stages):
            for ci in range(stage.num_convs):
                if not (skip_first and si == 0 and ci == 0):
                    self.convs[f"conv{si}_{ci}"] = nn.Conv2d(
                        c_in, stage.channels, 3, padding=1, bias=False)
                if norm == "batch":
                    self.bns[f"bn{si}_{ci}"] = nn.BatchNorm2d(
                        stage.channels, eps=1e-5)
                c_in = stage.channels

    def forward(self, x: torch.Tensor, train: bool = False,
                group=None) -> torch.Tensor:
        """[B, C_in, H, W] -> [B, C_out, H', W'] in x's dtype;
        W' = ceil(W / width_stride). ``train`` normalises with the batch
        statistics (of every rank of ``group``, when there is one) and
        updates the running ones in place."""
        dt = x.dtype
        for si, stage in enumerate(self.stages):
            for ci in range(stage.num_convs):
                name = f"conv{si}_{ci}"
                if name in self.convs:
                    x = F.conv2d(x, self.convs[name].weight.to(dt), padding=1)
                bn = (self.bns[f"bn{si}_{ci}"] if self.norm == "batch"
                      else None)
                if bn is not None and train:
                    x = batch_norm_train(x, bn, group)
                elif bn is not None:
                    x = F.batch_norm(
                        x, bn.running_mean.to(dt), bn.running_var.to(dt),
                        bn.weight.to(dt), bn.bias.to(dt), training=False,
                        eps=bn.eps,
                    )
                x = F.relu(x)
            x = pool(x, stage.pool, self.pool_impl)
        return x

    @property
    def width_stride(self) -> int:
        return width_stride_of(self.stages)

    @property
    def height_stride(self) -> int:
        return height_stride_of(self.stages)
