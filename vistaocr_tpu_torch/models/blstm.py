"""Width-major bidirectional LSTM stack.

Counterpart of ``vistaocr_tpu/models/blstm.py:39-192``. The input
projection of every frame is hoisted out of the recurrence into one
matmul per layer-direction; only ``h @ wh`` stays inside, in the CUDA
kernel (``ops/lstm_cuda.py``). Padded frames freeze the carry, so the
reverse direction starts from the zero state at each sample's last valid
frame. The stack runs time-major end to end (one transpose pair per
stack, as ``blstm.py:124-129``), and both directions of a layer share
one kernel launch.

Parameters keep the JAX names and layouts (``l{k}_{fwd|bwd}_{wx,wh,b}``:
``wx [D,4H]``, ``wh [H,4H]``, ``b [4H]``, gates i, f, g, o) so a JAX
snapshot loads without reshaping.

``impl`` takes the JAX values, so JAX snapshots load unchanged:

- ``"auto"``: the kernel for CUDA tensors, the plain version for CPU
  tensors (on CUDA a kernel failure raises; there is no fallback);
- ``"scan"``: the plain version on any device;
- ``"pallas"``: the kernel; raises off CUDA;
- ``"pallas_interpret"``: the plain version (the JAX value meant "the
  kernel's semantics, run without the accelerator").
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import lstm_cuda

IMPLS = ("auto", "scan", "pallas", "pallas_interpret")


def uses_kernel(impl: str, device: torch.device) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"unknown lstm_impl {impl!r}; one of {IMPLS}")
    if impl == "pallas":
        if device.type != "cuda":
            raise RuntimeError(
                "lstm_impl='pallas' runs the CUDA kernel and needs CUDA "
                f"tensors, got {device}"
            )
        return True
    if impl == "auto":
        return device.type == "cuda"
    return False


class BLSTMStack(nn.Module):
    """[B, T, D] -> [B, T, 2H] (forward ++ backward states) in the
    compute dtype. Eval only: dropout between layers is a training knob."""

    def __init__(self, d_in: int, hidden: int = 512, layers: int = 2,
                 *, impl: str = "auto"):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"unknown lstm_impl {impl!r}; one of {IMPLS}")
        self.hidden = hidden
        self.layers = layers
        self.impl = impl
        for layer in range(layers):
            for direction in ("fwd", "bwd"):
                p = f"l{layer}_{direction}"
                self.register_parameter(
                    f"{p}_wx", nn.Parameter(torch.empty(d_in, 4 * hidden)))
                self.register_parameter(
                    f"{p}_wh", nn.Parameter(torch.empty(hidden, 4 * hidden)))
                self.register_parameter(
                    f"{p}_b", nn.Parameter(torch.zeros(4 * hidden)))
            d_in = 2 * hidden

    def forward(self, x: torch.Tensor, frame_mask: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        use_kernel = uses_kernel(self.impl, x.device)
        x = x.transpose(0, 1)  # [T, B, D]
        mask = frame_mask.transpose(0, 1).to(torch.float32)[:, None, :]
        mask = mask.contiguous()  # [T, 1, B]
        for layer in range(self.layers):
            p = {d: tuple(getattr(self, f"l{layer}_{d}_{n}")
                          for n in ("wx", "wh", "b"))
                 for d in ("fwd", "bwd")}
            xw_f = lstm_cuda.input_projection(x, p["fwd"][0], p["fwd"][2],
                                              dtype)
            xw_b = lstm_cuda.input_projection(x, p["bwd"][0], p["bwd"][2],
                                              dtype)
            if use_kernel:
                ys_f, ys_b = lstm_cuda.blstm_recurrence(
                    xw_f, xw_b, mask, p["fwd"][1], p["bwd"][1], dtype=dtype)
            else:
                ys_f = lstm_cuda.lstm_recurrence_ref(
                    xw_f, mask, p["fwd"][1], reverse=False, dtype=dtype)
                ys_b = lstm_cuda.lstm_recurrence_ref(
                    xw_b, mask, p["bwd"][1], reverse=True, dtype=dtype)
            x = torch.cat([ys_f, ys_b], dim=-1)  # [T, B, 2H]
        return x.transpose(0, 1)  # [B, T, 2H]
