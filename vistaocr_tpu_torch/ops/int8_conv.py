"""The int8 3x3 SAME convolutions of the int8 serving path: the wrappers of
the CUDA kernels (``csrc/int8_conv.cu``), their plain versions, and the
weight packing.

Counterpart of the conv body of ``vistaocr_tpu/models/quant.py:209-222``
(an XLA int8 x int8 -> int32 conv there; no TPU kernel): quantize the
input with the frozen per-conv scale, convolve the int8 values with int32
accumulation, dequantize, add the folded bias, round to the compute type
and apply ReLU; then the stage's pool (``quant.py:88`` ``_pool``) and the
next conv's quantize. Layout NHWC (``[B, H, W, C]``, contiguous), so the
reduction over channels reads contiguous runs.

- ``pack_weights``: int8 OIHW ``[CO, CI, 3, 3]`` -> ``[CO, KP]`` with
  ``k = (kh*3 + kw)*CI + c``, zero-padded to ``KP``, the next multiple of
  32; done once at load time (``models/quant.QuantizedStack``).
- ``int8_conv_fused``: one conv of the int8 stack with its epilogue, the
  stage's pool (``window`` of 1 or 2 each way, ``"max"`` or
  ``"stride"``) and, given ``inv_s_next``, the next conv's quantize (int8
  out; else the compute type). ``x`` is int8 (quantized by the conv
  before) or float (quantized here with ``inv_s``). On a CUDA tensor it
  launches a kernel or raises: ``int8_conv_tc`` (TMA + s8 wgmma) where
  ``conv_design`` says ``"tc"``, after one ``quantize`` pass if ``x`` is
  float, else ``int8_conv_direct``, which quantizes a float ``x`` as it
  loads it. On a CPU tensor it runs ``int8_conv_fused_ref``.
- ``int8_conv``: ``int8_conv_fused`` with no pool and no next quantize,
  float ``x`` in, ``x``'s type out; ``int8_conv_ref`` its plain version.
- ``quantize``: ``clamp(round(x * inv_s), -127, 127)`` as int8, the
  kernel on the card.
- The plain versions: the same quantize (half to even), the conv of the
  int8 values in float64 (exact: every sum is far below 2**53) cast to
  int32 (``conv_acc_ref``), the same epilogue, each product and sum its
  own op, the pool, the quantize.
- ``LAUNCHES``: one per conv kernel launch (either design);
  ``QUANTIZE_LAUNCHES``: one per quantize pass.

``inv_s`` is the float32 value of ``1 / s_in`` and ``scale`` the float32
product ``s_in * wscale`` (as JAX forms them); the kernels and the plain
versions take ``inv_s`` as a float32 value.
"""

from __future__ import annotations

import functools
import threading
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

LAUNCHES = 0
QUANTIZE_LAUNCHES = 0
_count_lock = threading.Lock()
_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
K_STEP = 32  # KP is a multiple of it
DESIGNS = ("direct", "tc")  # vo_int8_conv_design's codes
POOL_IMPLS = ("max", "stride")


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


@functools.lru_cache(maxsize=None)
def conv_design(ci: int, co: int, out_dtype: torch.dtype = torch.int8,
                window=(1, 1)) -> str:
    """The kernel a conv of ``ci`` -> ``co`` channels, writing
    ``out_dtype`` values pooled by ``window``, takes on the card: ``"tc"``
    or ``"direct"``, as ``csrc/int8_conv.cu`` ``vo_int8_conv_design``
    reckons it from the tc kernel's launch plan. Builds the kernels on
    first use; CUDA only."""
    from . import _build

    code = _build.load().vo_int8_conv_design(
        ci, co, _TYPE_CODES[out_dtype], *(int(p) for p in window))
    if code < 0:
        raise ValueError(f"no int8 conv design takes CI={ci}, CO={co}, "
                         f"{out_dtype}, window {window}")
    return DESIGNS[code]


def fusable_window(window) -> bool:
    """A pool the kernels fold into their epilogue: 1 or 2 each way."""
    return all(p in (1, 2) for p in window)


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


def pool_ref(y: torch.Tensor, window, impl: str) -> torch.Tensor:
    """A stage's pool on NHWC ``y``: flax's SAME max-pool (``ceil_mode``)
    or the ``"stride"`` subsample, as ``models/cnn.pool``."""
    from ..models.cnn import pool

    return pool(y.permute(0, 3, 1, 2), tuple(window), impl).permute(
        0, 2, 3, 1).contiguous()


def int8_conv_fused_ref(x, wp, scale, bias, *, inv_s: Optional[float] = None,
                        dtype: Optional[torch.dtype] = None,
                        window: Tuple[int, int] = (1, 1),
                        pool_impl: str = "max",
                        inv_s_next: Optional[float] = None) -> torch.Tensor:
    """The plain version of ``int8_conv_fused``: quantize (a float ``x``),
    conv, epilogue in ``dtype``, pool, and the next quantize."""
    xq = x if x.dtype == torch.int8 else quantize_ref(
        x, float(np.float32(inv_s)))
    y = epilogue_ref(conv_acc_ref(xq, wp), scale, bias, _out_type(x, dtype))
    y = pool_ref(y, window, pool_impl)
    if inv_s_next is None:
        return y
    return quantize_ref(y, float(np.float32(inv_s_next)))


def int8_conv_ref(x, wp, scale, bias, inv_s: float) -> torch.Tensor:
    """The plain version of ``int8_conv``: [B, H, W, CI] f32|bf16 -> [B, H,
    W, CO] in x's type."""
    return int8_conv_fused_ref(x, wp, scale, bias, inv_s=inv_s)


def _out_type(x, dtype) -> torch.dtype:
    """The compute type: ``dtype``, or a float ``x``'s own."""
    if dtype is None:
        if x.dtype == torch.int8:
            raise ValueError("int8_conv_fused needs dtype for an int8 x")
        return x.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int8_conv_fused computes in float32 or bfloat16, "
                         f"got {dtype}")
    return dtype


def _check(x, wp, scale, bias) -> None:
    for name, t in (("weights", wp), ("scale", scale), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"int8_conv: {name} on {t.device}, x on "
                             f"{x.device}")
    if x.dtype not in _TYPE_CODES:
        raise ValueError(f"int8_conv takes int8, float32 or bfloat16 x, got "
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


def _count(name: str) -> None:
    global LAUNCHES, QUANTIZE_LAUNCHES
    with _count_lock:
        if name == "conv":
            LAUNCHES += 1
        else:
            QUANTIZE_LAUNCHES += 1


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def quantize(x: torch.Tensor, inv_s: float) -> torch.Tensor:
    """clamp(round(x_f32 * inv_s), -127, 127) as int8, x f32 or bf16: the
    kernel on CUDA tensors (one launch), ``quantize_ref`` on CPU ones."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"quantize takes float32 or bfloat16, got {x.dtype}")
    if not x.is_cuda:
        return quantize_ref(x, float(np.float32(inv_s)))
    import ctypes

    from . import _build

    x = x.contiguous()
    y = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel():
        err = _build.load().vo_int8_quantize(
            _TYPE_CODES[x.dtype], x.numel(), x.data_ptr(),
            ctypes.c_float(float(np.float32(inv_s))), y.data_ptr(),
            _stream(x))
        _build.check(err, "vo_int8_quantize")
        _count("quantize")
    return y


def int8_conv_fused(x, wp, scale, bias, *, inv_s: Optional[float] = None,
                    dtype: Optional[torch.dtype] = None,
                    window: Tuple[int, int] = (1, 1), pool_impl: str = "max",
                    inv_s_next: Optional[float] = None) -> torch.Tensor:
    """One int8 conv with its epilogue, pool and next quantize (see the
    module's docstring): [B, H, W, CI] int8 (or float, quantized with
    ``inv_s``) -> [B, ceil(H/ph), ceil(W/pw), CO], int8 if ``inv_s_next``
    is given, else ``dtype`` (default: a float ``x``'s type). The kernel
    is the one ``conv_design`` names."""
    _check(x, wp, scale, bias)
    out_type = _out_type(x, dtype)
    window = tuple(int(p) for p in window)
    if not fusable_window(window) or len(window) != 2:
        raise ValueError(f"int8_conv_fused pools by 1 or 2 each way, got "
                         f"{window}")
    if pool_impl not in POOL_IMPLS:
        raise ValueError(f"pool_impl {pool_impl!r} not in {POOL_IMPLS}")
    if x.dtype != torch.int8 and inv_s is None:
        raise ValueError("int8_conv_fused needs inv_s for a float x")
    if not x.is_cuda:
        return int8_conv_fused_ref(x, wp, scale, bias, inv_s=inv_s,
                                   dtype=out_type, window=window,
                                   pool_impl=pool_impl, inv_s_next=inv_s_next)
    import ctypes

    from . import _build

    B, H, W, ci = x.shape
    co = wp.shape[0]
    y_type = torch.int8 if inv_s_next is not None else out_type
    design = conv_design(ci, co, y_type, window)
    if design == "tc" and x.dtype != torch.int8:
        x = quantize(x, inv_s)
    ph, pw = window
    y = torch.empty((B, -(-H // ph), -(-W // pw), co), dtype=y_type,
                    device=x.device)
    err = _build.load().vo_int8_conv_fused(
        DESIGNS.index(design), _TYPE_CODES[x.dtype],
        int(out_type == torch.bfloat16), _TYPE_CODES[y.dtype], B, H, W, ci,
        co, wp.shape[1], ph, pw, int(pool_impl == "stride"), x.data_ptr(),
        wp.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        ctypes.c_float(float(np.float32(inv_s or 0.0))),
        ctypes.c_float(float(np.float32(inv_s_next or 0.0))), y.data_ptr(),
        _stream(x))
    _build.check(err, "vo_int8_conv_fused")
    _count("conv")
    return y


def int8_conv(x, wp, scale, bias, inv_s: float) -> torch.Tensor:
    """Quantize, int8 conv, dequantize + bias + ReLU: [B, H, W, CI] f32|bf16
    -> [B, H, W, CO] in x's type; a kernel on CUDA tensors (one conv
    launch, after a quantize pass where the tc design runs), the plain
    version on CPU tensors."""
    if x.dtype == torch.int8:
        raise ValueError("int8_conv takes float32 or bfloat16 x, got int8")
    return int8_conv_fused(x, wp, scale, bias, inv_s=inv_s)
