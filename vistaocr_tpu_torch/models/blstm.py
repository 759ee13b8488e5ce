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

- ``"auto"``: the kernels for CUDA tensors, the plain versions for CPU
  tensors (on CUDA a kernel failure raises; there is no fallback);
- ``"scan"``: the plain forward loop on any device, differentiated by
  autograd (the oracle);
- ``"pallas"``: the kernels; raises off CUDA;
- ``"pallas_interpret"``: the plain versions behind the kernels'
  autograd Function (``lstm_cuda.BLstmRecurrence``); the JAX value meant
  "the kernels' semantics, run without the accelerator".

In train mode, dropout (``rate``, drawn from an explicit generator) runs
between layers, never after the last (``blstm.py:188-189``).

Under tensor parallelism (``parallel.mesh.shard_model`` sets
``model_group``) each rank holds the column shard of every ``wx``, ``wh``
and ``b`` (gates ``[4H / model]``): it projects its gate columns and
gathers them to ``[T, B, 4H]``, gathers ``wh`` whole, and runs the
recurrence kernels whole-H on its rows, as GSPMD does around JAX's
Pallas calls (``lstm_pallas.py:180,189`` pin every non-batch dimension).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import lstm_cuda
from ..parallel.mesh import copy_to_model, gather_columns

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


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale the kept
    values by 1 / (1 - rate), in x's dtype. The mask comes from
    ``generator`` (on x's device), so a resumed run draws the same masks;
    it cannot match JAX's."""
    keep = 1.0 - rate
    kept = dropout_mask(x, rate, generator)
    return torch.where(kept, x / keep, torch.zeros_like(x))


def dropout_mask(x: torch.Tensor, rate: float,
                 generator: torch.Generator) -> torch.Tensor:
    """``dropout``'s keep mask over x's shape: one uniform draw from
    ``generator`` a value."""
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return u < 1.0 - rate


class BLSTMStack(nn.Module):
    """[B, T, D] -> [B, T, 2H] (forward ++ backward states) in the
    compute dtype."""

    model_group = None  # the model axis's process group (shard_model)

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
                dtype: torch.dtype, *, rate: float = 0.0,
                generator: torch.Generator = None) -> torch.Tensor:
        """``rate > 0`` applies dropout between layers (train mode)."""
        use_kernel = uses_kernel(self.impl, x.device)
        x = x.transpose(0, 1)  # [T, B, D]
        mask = frame_mask.transpose(0, 1).to(torch.float32)[:, None, :]
        mask = mask.contiguous()  # [T, 1, B]
        tp = self.model_group  # None: the whole gates on this rank
        for layer in range(self.layers):
            p = {d: tuple(getattr(self, f"l{layer}_{d}_{n}")
                          for n in ("wx", "wh", "b"))
                 for d in ("fwd", "bwd")}
            # column-parallel gate inputs, then the whole gates and wh
            xin = copy_to_model(x, tp)
            xw_f, xw_b = (gather_columns(lstm_cuda.input_projection(
                xin, p[d][0], p[d][2], dtype), tp) for d in ("fwd", "bwd"))
            wh_f, wh_b = (gather_columns(p[d][1], tp) for d in ("fwd", "bwd"))
            if self.impl == "scan":
                ys_f = lstm_cuda.lstm_recurrence_ref(
                    xw_f, mask, wh_f, reverse=False, dtype=dtype)
                ys_b = lstm_cuda.lstm_recurrence_ref(
                    xw_b, mask, wh_b, reverse=True, dtype=dtype)
            else:
                ys_f, ys_b = lstm_cuda.blstm_recurrence(
                    xw_f, xw_b, mask, wh_f, wh_b, dtype=dtype,
                    plain=not use_kernel)
            x = torch.cat([ys_f, ys_b], dim=-1)  # [T, B, 2H]
            if rate > 0 and layer < self.layers - 1:
                x = dropout(x, rate, generator)
        return x.transpose(0, 1)  # [B, T, 2H]
