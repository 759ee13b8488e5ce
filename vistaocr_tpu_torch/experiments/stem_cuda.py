"""Fused input stem: preprocess + the first 3x3 convolution (C_in = 1) as
one CUDA kernel pair, and the gradient of its kernel.

Counterpart of ``experiments/stem_pallas.py:46-176``. The kernels are
``csrc/stem.cu`` (``stem_moments`` + ``stem_conv`` for ``_stem_kernel``,
``stem_dk_partial`` + ``stem_dk_sum`` for ``_dk_kernel``); its source note
says what bounds them on the card and what the design does about it.
The design follows the type alone (``stem_design``): dK runs on the
tensor cores in bf16 and on the FMA units in f32.

Layout: the port is NCHW, so the output is ``[B, CO, H, W]`` (it feeds
``CnnLstmOcr.cnn`` directly) and the weight is the port's OIHW
``[CO, 1, 3, 3]`` (``model.stem_kernel``).

Rounding contract (the experiment's, not production's): the conv runs in
f32 on the UNROUNDED standardised image with the f32 kernel and rounds
only its output to ``dtype``; the residual ``xn`` is stored rounded to
``dtype`` and dK reads that rounded ``xn``. In bf16 this differs from
``preprocess_images`` + ``F.conv2d``, which rounds the image and the
kernel before the product.

- ``fused_stem``: the entry point, an autograd Function (``FusedStem``)
  whose backward returns dK only, as ``_bwd_rule`` (``:169-173``). On a
  CUDA tensor it launches the kernels or raises; on a CPU tensor (or with
  ``plain=True``) it runs the plain versions. No fallback.
- ``fused_stem_ref`` / ``stem_dk_ref``: the plain PyTorch versions.
- ``stem_fwd_cuda`` / ``stem_dk_cuda``: the kernel wrappers (CUDA tensors
  only), each adding one to ``STEM_LAUNCHES`` / ``STEM_DK_LAUNCHES`` per
  call of its C entry point.
- ``stem_design``: the names of the kernels a call runs.
"""

from __future__ import annotations

import threading
from typing import Tuple

import torch
import torch.nn.functional as F

from ..ops.preprocess import preprocess_images

STEM_LAUNCHES = 0
STEM_DK_LAUNCHES = 0
_count_lock = threading.Lock()

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _count(name: str) -> None:
    with _count_lock:
        globals()[name] += 1


def _check(images, widths, kernel, dtype) -> None:
    if images.dtype != torch.uint8 or images.dim() != 3:
        raise TypeError(f"images must be uint8 [B, H, W], got {images.dtype} "
                        f"{tuple(images.shape)}")
    if tuple(widths.shape) != (images.shape[0],):
        raise ValueError(f"widths must be [{images.shape[0]}], got "
                         f"{tuple(widths.shape)}")
    if kernel.dim() != 4 or tuple(kernel.shape[1:]) != (1, 3, 3):
        raise ValueError(f"kernel must be [CO, 1, 3, 3], got "
                         f"{tuple(kernel.shape)}")
    if dtype not in _TYPE_CODES:
        raise TypeError(f"unsupported dtype {dtype}")
    if not (images.device == widths.device == kernel.device):
        raise ValueError("images, widths and kernel must be on one device")


def fused_stem_ref(images: torch.Tensor, widths: torch.Tensor,
                   kernel: torch.Tensor, standardize: bool = True,
                   dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain stem: (out [B, CO, H, W], xn [B, H, W]), both in ``dtype``;
    an f32 SAME convolution of the f32 image (``preprocess_images``, the
    formula of ``stem_pallas.py:50-61``), rounded once."""
    x = preprocess_images(images, widths, standardize=standardize)[..., 0]
    out = F.conv2d(x[:, None], kernel.to(torch.float32), padding=1)
    return out.to(dtype), x.to(dtype)


def stem_dk_ref(xn: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """Plain dK [CO, 1, 3, 3] f32: for each tap (dh, dw), the sum over
    (b, h, w) of ``dout[b, co, h, w] * pad(xn)[b, h+dh, w+dw]``."""
    B, H, W = xn.shape
    xp = F.pad(xn.to(torch.float32), (1, 1, 1, 1))
    d = dout.to(torch.float32)
    taps = [torch.einsum("bchw,bhw->c", d, xp[:, dh:dh + H, dw:dw + W])
            for dh in range(3) for dw in range(3)]
    return torch.stack(taps, dim=1).reshape(-1, 1, 3, 3)


def _check_launch(*tensors) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError("the stem kernels take CUDA tensors only")
        if not t.is_contiguous():
            raise ValueError("the stem kernels take contiguous tensors only")


def stem_design(dtype: torch.dtype, standardize: bool = True) -> dict:
    """The kernels of ``stem.cu`` that K7a and K7b run for ``dtype``:
    K7a the moments of each image (when it standardises), behind which the
    conv is launched; K7b the persistent partial sums, on the tensor cores
    (``mma``) in bf16 and on the FMA units (``fma``) in f32, then the
    fixed-order sum of the partial rows."""
    if dtype not in _TYPE_CODES:
        raise TypeError(f"unsupported dtype {dtype}")
    return {"fwd": ("stem_moments+stem_conv" if standardize else "stem_conv"),
            "dk": "stem_dk_partial:" + ("mma" if dtype == torch.bfloat16
                                        else "fma") + "+stem_dk_sum"}


def stem_fwd_cuda(images, widths, kernel, standardize: bool,
                  dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7a on the card: (out [B, CO, H, W], xn [B, H, W]) in ``dtype``."""
    from ..ops import _build

    _check(images, widths, kernel, dtype)
    _check_launch(images, widths, kernel)
    if widths.dtype != torch.int32 or kernel.dtype != torch.float32:
        raise TypeError("widths must be int32 and kernel float32")
    B, H, W = images.shape
    CO = kernel.shape[0]
    lib = _build.load()
    out = torch.empty((B, CO, H, W), dtype=dtype, device=images.device)
    xn = torch.empty((B, H, W), dtype=dtype, device=images.device)
    # (sum x, sum x^2) of each 4 KB slice of each image, in float64
    moments = torch.empty((B, lib.vo_stem_moment_chunks(H, W), 2),
                          dtype=torch.float64, device=images.device)
    err = lib.vo_stem_fwd(_TYPE_CODES[dtype], B, H, W, CO, int(standardize),
                          images.data_ptr(), widths.data_ptr(),
                          kernel.data_ptr(), moments.data_ptr(),
                          out.data_ptr(), xn.data_ptr(),
                          torch.cuda.current_stream(images.device).cuda_stream)
    _build.check(err, "vo_stem_fwd")
    _count("STEM_LAUNCHES")
    return out, xn


def stem_dk_cuda(xn: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """K7b on the card: dK [CO, 1, 3, 3] f32 from xn and dout (one dtype)."""
    from ..ops import _build

    _check_launch(xn, dout)
    B, H, W = xn.shape
    CO = dout.shape[1]
    if tuple(dout.shape) != (B, CO, H, W) or dout.dtype != xn.dtype:
        raise ValueError(f"dout must be [{B}, CO, {H}, {W}] in {xn.dtype}, "
                         f"got {dout.dtype} {tuple(dout.shape)}")
    if xn.dtype not in _TYPE_CODES:
        raise TypeError(f"unsupported dtype {xn.dtype}")
    lib = _build.load()
    rows = lib.vo_stem_partials(B, H, W)  # the CTAs K7b runs on this card
    if rows < 1:
        raise RuntimeError(f"vo_stem_partials({B}, {H}, {W}) gave {rows}")
    partial = torch.empty((rows, CO * 9), dtype=torch.float32,
                          device=xn.device)
    dk = torch.empty((CO, 1, 3, 3), dtype=torch.float32, device=xn.device)
    err = lib.vo_stem_dk(_TYPE_CODES[xn.dtype], B, H, W, CO, xn.data_ptr(),
                         dout.data_ptr(), partial.data_ptr(), dk.data_ptr(),
                         torch.cuda.current_stream(xn.device).cuda_stream)
    _build.check(err, "vo_stem_dk")
    _count("STEM_DK_LAUNCHES")
    return dk


class FusedStem(torch.autograd.Function):
    """``apply(images, widths, kernel, standardize, dtype, plain)`` ->
    out [B, CO, H, W]; the backward gives dK only (the images are data),
    in the kernel's dtype, as ``_bwd_rule``."""

    @staticmethod
    def forward(ctx, images, widths, kernel, standardize, dtype, plain):
        if images.is_cuda and not plain:
            out, xn = stem_fwd_cuda(images, widths.to(torch.int32).contiguous(),
                                    kernel.to(torch.float32).contiguous(),
                                    standardize, dtype)
        else:
            out, xn = fused_stem_ref(images, widths, kernel, standardize,
                                     dtype)
        ctx.save_for_backward(xn)
        ctx.meta = (kernel.dtype, plain)
        return out

    @staticmethod
    def backward(ctx, dout):
        (xn,) = ctx.saved_tensors
        kdtype, plain = ctx.meta
        dout = dout.to(xn.dtype).contiguous()
        if xn.is_cuda and not plain:
            dk = stem_dk_cuda(xn, dout)
        else:
            dk = stem_dk_ref(xn, dout)
        return None, None, dk.to(kdtype), None, None, None


def fused_stem(images: torch.Tensor, widths: torch.Tensor,
               kernel: torch.Tensor, standardize: bool = True,
               dtype: torch.dtype = torch.float32, *,
               plain: bool = False) -> torch.Tensor:
    """uint8 [B, H, W] + widths [B] + kernel [CO, 1, 3, 3] -> [B, CO, H, W]
    in ``dtype``: ``preprocess_images`` followed by a SAME 3x3 conv, fused
    (``stem_pallas.fused_stem``). Differentiable in ``kernel``."""
    _check(images, widths, kernel, dtype)
    return FusedStem.apply(images, widths, kernel, standardize, dtype, plain)
