"""Flagship CNN-BLSTM-CTC line-OCR model.

Counterpart of ``vistaocr_tpu/models/cnnlstm.py:36-171``:

    uint8 lines [B,H,W] --preprocess--> [B,1,H,W]
      --stem conv + ConvStack--> [B,C,H',W']
      --width-major reshape--> [B, T=W', H'*C]  (C fastest)
      --bridge Linear+ReLU--> [B, T, D]
      --BLSTMStack--> [B, T, 2H]
      --head Linear (f32) + log-softmax--> [B, T, K]

``forward`` returns ``(log_probs, frame_mask)`` with
``frame_mask[b, t] = t < ceil(width_b / width_stride)``. Eval only:
dropout and augmentation are training knobs and are not applied.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.preprocess import preprocess_images
from .blstm import BLSTMStack
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
    # Legacy field ("auto"/"plain" only): the fused stem lives in
    # experiments/ of the JAX package; kept so old snapshots load.
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
    def __init__(self, config: ModelConfig):
        super().__init__()
        cfg = config
        if cfg.stem_impl not in ("auto", "plain"):
            raise ValueError(
                f"stem_impl={cfg.stem_impl!r}: the fused stem was rejected "
                "on measurement and lives in experiments/stem_pallas.py"
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
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        dt = cfg.dtype
        x = preprocess_images(images, widths, standardize=cfg.standardize_input,
                              dtype=dt)
        x = x.permute(0, 3, 1, 2)  # [B, 1, H, W]
        x = F.conv2d(x, self.stem_kernel.to(dt), padding=1)
        x = self.cnn(x)  # [B, C, H', T]

        b, c, hp, t = x.shape
        x = x.permute(0, 3, 2, 1).reshape(b, t, hp * c)  # C fastest

        frames = -(-widths.to(torch.int64) // cfg.width_stride)
        tpos = torch.arange(t, device=x.device)
        frame_mask = tpos[None, :] < frames[:, None]

        x = F.relu(F.linear(x, self.bridge.weight.to(dt),
                            self.bridge.bias.to(dt)))
        x = self.blstm(x, frame_mask, dt)
        logits = self.head(x.to(torch.float32))
        return torch.log_softmax(logits, dim=-1), frame_mask


def _xavier_uniform_(w: torch.Tensor, fan_in: int, fan_out: int,
                     g: torch.Generator) -> None:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    w.copy_((torch.rand(w.shape, generator=g) * 2.0 - 1.0) * bound)


def init_parameters(model: CnnLstmOcr, generator: torch.Generator) -> None:
    """Seeded initialisation with the JAX initialisers' distributions:
    xavier-uniform convs, stem and ``wx``; orthogonal ``wh``; zero LSTM
    bias with the forget-gate slice at +1; lecun-normal Dense kernels
    with zero bias; BatchNorm scale 1, bias 0, mean 0, var 1. Runs on the
    CPU generator; move the model to its device afterwards."""
    g = generator
    with torch.no_grad():
        k = model.stem_kernel
        _xavier_uniform_(k, 9 * k.shape[1], 9 * k.shape[0], g)
        for conv in model.cnn.convs.values():
            o, i, kh, kw = conv.weight.shape
            _xavier_uniform_(conv.weight, i * kh * kw, o * kh * kw, g)
        for bn in model.cnn.bns.values():
            bn.weight.fill_(1.0)
            bn.bias.zero_()
            bn.running_mean.zero_()
            bn.running_var.fill_(1.0)
        for lin in (model.bridge, model.head):
            fan_in = lin.weight.shape[1]
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=g)
                             / math.sqrt(fan_in))
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
