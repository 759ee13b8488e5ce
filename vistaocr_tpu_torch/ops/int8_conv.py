"""The int8 3x3 SAME convolution of the int8 serving path: the wrapper of
the CUDA kernel (``csrc/int8_conv.cu``), its plain version, and the
weight packing.

Counterpart of the conv body of ``vistaocr_tpu/models/quant.py:209-222``
(an XLA int8 x int8 -> int32 conv there; no TPU kernel): quantize the
input with the frozen per-conv scale, convolve the int8 values with int32
accumulation, dequantize, add the folded bias, round to the compute type
and apply ReLU. Layout NHWC (``[B, H, W, C]``, contiguous), so the
reduction over channels reads contiguous runs.

- ``pack_weights``: int8 OIHW ``[CO, CI, 3, 3]`` -> ``[CO, KP]`` with
  ``k = (kh*3 + kw)*CI + c``, zero-padded to ``KP``, the next multiple of
  32; done once at load time (``models/quant.QuantizedStack``).
- ``int8_conv``: on a CUDA tensor it launches the kernel or raises; on a
  CPU tensor it runs ``int8_conv_ref``.
- ``int8_conv_ref``: the same quantize (``clamp(round(x * inv_s), -127,
  127)``, half to even), the conv of the int8 values in float64 (exact:
  every sum is far below 2**53) cast to int32 (``conv_acc_ref``), and
  the same epilogue, each product and sum its own op.
- ``LAUNCHES``: one per kernel launch.

``inv_s`` is the float32 value of ``1 / s_in`` and ``scale`` the float32
product ``s_in * wscale`` (as JAX forms them); both the kernel and the
plain version take ``inv_s`` as a float32 value.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
import torch.nn.functional as F

LAUNCHES = 0
_count_lock = threading.Lock()
_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
K_STEP = 32  # the kernel's K step (bytes): KP is a multiple of it


def padded_k(ci: int) -> int:
    return -(-9 * ci // K_STEP) * K_STEP


def pack_weights(wq: torch.Tensor) -> torch.Tensor:
    """int8 OIHW [CO, CI, 3, 3] -> [CO, KP] int8, K in (kh, kw, ci) order,
    zero past 9*CI."""
    if wq.dtype != torch.int8 or wq.dim() != 4 or tuple(wq.shape[2:]) != (3, 3):
        raise ValueError(f"expected int8 [CO, CI, 3, 3] weights, got "
                         f"{wq.dtype} {tuple(wq.shape)}")
    co, ci = wq.shape[:2]
    out = torch.zeros((co, padded_k(ci)), dtype=torch.int8, device=wq.device)
    out[:, : 9 * ci] = wq.permute(0, 2, 3, 1).reshape(co, 9 * ci)
    return out


def _unpack(wp: torch.Tensor, ci: int) -> torch.Tensor:
    co = wp.shape[0]
    return wp[:, : 9 * ci].reshape(co, 3, 3, ci).permute(0, 3, 1, 2)


def quantize_ref(x: torch.Tensor, inv_s: float) -> torch.Tensor:
    """clamp(round(x_f32 * inv_s), -127, 127) as int8."""
    return torch.round(x.to(torch.float32) * inv_s).clamp_(-127, 127).to(
        torch.int8)


def conv_acc_ref(xq: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """int32 sums of the SAME 3x3 conv of int8 NHWC ``xq`` with packed
    weights: [B, H, W, CI] -> [B, H, W, CO], through a float64 conv."""
    w = _unpack(wp, xq.shape[-1]).to(torch.float64)
    acc = F.conv2d(xq.permute(0, 3, 1, 2).to(torch.float64), w, padding=1)
    return acc.permute(0, 2, 3, 1).to(torch.int32)


def epilogue_ref(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """relu(round_to_dtype(acc_f32 * scale + bias)), ReLU giving +0."""
    y = (acc.to(torch.float32) * scale + bias).to(dtype)
    return torch.where(y > 0, y, torch.zeros_like(y)).contiguous()


def int8_conv_ref(x, wp, scale, bias, inv_s: float) -> torch.Tensor:
    """The plain version: [B, H, W, CI] f32|bf16 -> [B, H, W, CO] in x's
    type."""
    inv_s = float(np.float32(inv_s))
    return epilogue_ref(conv_acc_ref(quantize_ref(x, inv_s), wp), scale,
                        bias, x.dtype)


def _check(x, wp, scale, bias) -> None:
    for name, t in (("weights", wp), ("scale", scale), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"int8_conv: {name} on {t.device}, x on "
                             f"{x.device}")
    if x.dtype not in _TYPE_CODES:
        raise ValueError(f"int8_conv takes float32 or bfloat16 x, got "
                         f"{x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("int8_conv takes a contiguous NHWC [B, H, W, CI] x")
    co = wp.shape[0]
    if (wp.dtype != torch.int8 or wp.dim() != 2 or not wp.is_contiguous()
            or wp.shape[1] != padded_k(x.shape[-1])):
        raise ValueError(
            f"int8_conv takes packed int8 weights [CO, {padded_k(x.shape[-1])}]"
            f", got {wp.dtype} {tuple(wp.shape)}")
    for name, t in (("scale", scale), ("bias", bias)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (co,)
                or not t.is_contiguous()):
            raise ValueError(f"int8_conv takes a contiguous float32 [{co}] "
                             f"{name}")


def int8_conv(x, wp, scale, bias, inv_s: float) -> torch.Tensor:
    """Quantize, int8 conv, dequantize + bias + ReLU: the kernel on CUDA
    tensors (one launch), the plain version on CPU tensors."""
    global LAUNCHES
    _check(x, wp, scale, bias)
    if not x.is_cuda:
        return int8_conv_ref(x, wp, scale, bias, inv_s)
    import ctypes

    from . import _build

    B, H, W, ci = x.shape
    co = wp.shape[0]
    y = torch.empty((B, H, W, co), dtype=x.dtype, device=x.device)
    err = _build.load().vo_int8_conv(
        _TYPE_CODES[x.dtype], B, H, W, ci, co, wp.shape[1], x.data_ptr(),
        wp.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        ctypes.c_float(float(np.float32(inv_s))), y.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "vo_int8_conv")
    with _count_lock:
        LAUNCHES += 1
    return y
