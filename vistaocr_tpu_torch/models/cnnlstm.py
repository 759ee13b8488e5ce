"""Flagship CNN-BLSTM-CTC line-OCR model.

Counterpart of ``vistaocr_tpu/models/cnnlstm.py:36-171``:

    uint8 lines [B,H,W] --preprocess--> [B,1,H,W]
      --stem conv + ConvStack--> [B,C,H',W']
      --width-major reshape--> [B, T=W', H'*C]  (C fastest)
      --bridge Linear+ReLU--> [B, T, D]
      --BLSTMStack--> [B, T, 2H]
      --head Linear (f32) + log-softmax--> [B, T, K]

``forward`` returns ``(log_probs, frame_mask)`` with
``frame_mask[b, t] = t < ceil(width_b / width_stride)``. With
``train=True`` it runs as the JAX model's ``train=True`` apply: BatchNorm
on batch statistics (running statistics updated in place), on-device
augmentation when ``augment > 0``, and dropout after the bridge ReLU and
between BLSTM layers, every random draw from the ``generator`` passed in.

Under tensor parallelism (``parallel.mesh.shard_model``) the bridge is
column-parallel: each rank holds its rows of ``bridge.weight`` (JAX's
kernel columns) and of ``bridge.bias``, computes those output columns and
gathers them before the ReLU; dropout then draws over the full width, as
with one rank. The head runs replicated.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.preprocess import augment_images, preprocess_images
from ..parallel.mesh import copy_to_model, gather_columns
from .blstm import BLSTMStack, dropout
from .cnn import DEFAULT_STAGES, ConvStack, ConvStageSpec, width_stride_of


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters, field for field the JAX
    ``ModelConfig``, so ``meta.json`` of either package loads in both."""

    num_classes: int  # |alphabet| incl. blank
    line_height: int = 32
    stages: Tuple[ConvStageSpec, ...] = DEFAULT_STAGES
    bridge_dim: int = 512
    lstm_hidden: int = 512
    lstm_layers: int = 2
    dropout: float = 0.1
    standardize_input: bool = True
    compute_dtype: str = "float32"  # "bfloat16" on the card
    lstm_impl: str = "auto"  # auto | scan | pallas | pallas_interpret
    # Legacy field ("auto"/"plain" only): the fused stem is an experiment
    # (vistaocr_tpu_torch/experiments/stem_cuda.py); kept so old snapshots
    # load.
    stem_impl: str = "auto"
    augment: float = 0.0  # train-time only
    conv_norm: str = "batch"
    conv_pool: str = "max"

    @property
    def width_stride(self) -> int:
        return width_stride_of(self.stages)

    @property
    def dtype(self) -> torch.dtype:
        dt = getattr(torch, self.compute_dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        return dt

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["stages"] = [dataclasses.asdict(s) for s in self.stages]
        return json.dumps(d)

    @classmethod
    def from_json(cls, payload: str) -> "ModelConfig":
        d = json.loads(payload)
        d["stages"] = tuple(
            ConvStageSpec(
                channels=s["channels"],
                num_convs=s["num_convs"],
                pool=tuple(s["pool"]),
            )
            for s in d["stages"]
        )
        return cls(**d)


class CnnLstmOcr(nn.Module):
    model_group = None  # the model axis's process group (shard_model)

    def __init__(self, config: ModelConfig):
        super().__init__()
        cfg = config
        if cfg.stem_impl not in ("auto", "plain"):
            raise ValueError(
                f"stem_impl={cfg.stem_impl!r}: the fused stem is not a model "
                "option; it is the experiment "
                "vistaocr_tpu_torch/experiments/stem_cuda.py (fused_stem)"
            )
        self.config = cfg
        c0 = cfg.stages[0].channels
        self.stem_kernel = nn.Parameter(torch.empty(c0, 1, 3, 3))  # OIHW
        self.cnn = ConvStack(cfg.stages, skip_first=True,
                             norm=cfg.conv_norm, pool_impl=cfg.conv_pool)
        hp = cfg.line_height
        for st in cfg.stages:
            hp = -(-hp // st.pool[0])
        self.bridge = nn.Linear(hp * cfg.stages[-1].channels, cfg.bridge_dim)
        self.blstm = BLSTMStack(cfg.bridge_dim, cfg.lstm_hidden,
                                cfg.lstm_layers, impl=cfg.lstm_impl)
        self.head = nn.Linear(2 * cfg.lstm_hidden, cfg.num_classes)
        self.eval()

    def forward(
        self,
        images: torch.Tensor,  # [B, H, W] uint8
        widths: torch.Tensor,  # [B] int32
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        group=None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``train=True`` needs ``generator`` (on the images' device) when
        ``dropout`` or ``augment`` is non-zero; under data parallelism
        ``group`` is the data axis's process group (BatchNorm's statistics
        over the global batch)."""
        cfg = self.config
        dt = cfg.dtype
        x = preprocess_images(images, widths, standardize=cfg.standardize_input,
                              dtype=dt)
        if train and cfg.augment > 0:
            x = augment_images(x, widths, generator, strength=cfg.augment)
        x = x.permute(0, 3, 1, 2)  # [B, 1, H, W]
        x = F.conv2d(x, self.stem_kernel.to(dt), padding=1)
        x = self.cnn(x, train=train, group=group)  # [B, C, H', T]

        b, c, hp, t = x.shape
        x = x.permute(0, 3, 2, 1).reshape(b, t, hp * c)  # C fastest
        return self.sequence_head(x, widths, train=train, generator=generator)

    def sequence_head(
        self,
        x: torch.Tensor,  # [B, T, H' * C] width-major features, C fastest
        widths: torch.Tensor,  # [B]
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Bridge + ReLU, BLSTM and the f32 head with log-softmax over the
        conv features; also the tail of the int8 path (``models/quant.py``
        ``sequence_head_apply``). Returns (log_probs, frame_mask)."""
        cfg = self.config
        dt = cfg.dtype
        t = x.shape[1]
        frames = -(-widths.to(torch.int64) // cfg.width_stride)
        tpos = torch.arange(t, device=x.device)
        frame_mask = tpos[None, :] < frames[:, None]

        tp = self.model_group  # column-parallel bridge; None: one rank
        x = F.relu(gather_columns(F.linear(
            copy_to_model(x, tp), self.bridge.weight.to(dt),
            self.bridge.bias.to(dt)), tp))
        rate = cfg.dropout if train else 0.0
        if rate > 0:
            x = dropout(x, rate, generator)
        x = self.blstm(x, frame_mask, dt, rate=rate, generator=generator)
        logits = self.head(x.to(torch.float32))
        return torch.log_softmax(logits, dim=-1), frame_mask


def _xavier_uniform_(w: torch.Tensor, fan_in: int, fan_out: int,
                     g: torch.Generator) -> None:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    w.copy_((torch.rand(w.shape, generator=g) * 2.0 - 1.0) * bound)


def _lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    """flax ``lecun_normal()`` = ``variance_scaling(1, "fan_in",
    "truncated_normal")``: a normal cut at +-2 sigma0, sigma0 =
    sqrt(1/fan_in) / 0.87962566 (the cut normal's std is sqrt(1/fan_in))."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                generator=g)


def init_parameters(model: CnnLstmOcr, generator: torch.Generator) -> None:
    """Seeded initialisation with the JAX initialisers' distributions:
    xavier-uniform stem and ``wx``; lecun-normal (truncated, as flax's
    default ``nn.Conv``/``nn.Dense`` kernel init) ConvStack convs,
    ``bridge`` and ``head`` with zero bias; orthogonal ``wh``; zero LSTM
    bias with the forget-gate slice at +1; BatchNorm scale 1, bias 0,
    mean 0, var 1. Runs on the CPU generator; move the model to its device
    afterwards."""
    g = generator
    with torch.no_grad():
        k = model.stem_kernel
        _xavier_uniform_(k, 9 * k.shape[1], 9 * k.shape[0], g)
        for conv in model.cnn.convs.values():
            o, i, kh, kw = conv.weight.shape
            _lecun_normal_(conv.weight, i * kh * kw, g)
        for bn in model.cnn.bns.values():
            bn.weight.fill_(1.0)
            bn.bias.zero_()
            bn.running_mean.zero_()
            bn.running_var.fill_(1.0)
        for lin in (model.bridge, model.head):
            _lecun_normal_(lin.weight, lin.weight.shape[1], g)
            lin.bias.zero_()
        H = model.blstm.hidden
        for name, p in model.blstm.named_parameters():
            if name.endswith("_wx"):
                _xavier_uniform_(p, p.shape[0], p.shape[1], g)
            elif name.endswith("_wh"):
                a = torch.randn(p.shape[1], p.shape[0], generator=g)
                q, r = torch.linalg.qr(a)  # [4H, H], orthonormal columns
                q = q * torch.sign(torch.diagonal(r))[None, :]
                p.copy_(q.T)
            else:
                p.zero_()
                p[H:2 * H] = 1.0
