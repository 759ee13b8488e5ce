"""Masked LSTM recurrence: wrapper of the CUDA kernel and its plain version.

Counterpart of ``vistaocr_tpu/ops/lstm_pallas.py:115-163, 455-552``
(inference form). The kernel is ``csrc/lstm_fwd.cu``; its source note
says what it replaces, what bounds it and what its design does about it.

- ``lstm_recurrence`` / ``blstm_recurrence``: on a CUDA tensor they
  launch the kernel or raise; on a CPU tensor they run
  ``lstm_recurrence_ref``. There is no fallback from the kernel to the
  plain version.
- ``lstm_recurrence_ref``: the plain PyTorch version, a Python loop over
  T with the kernel's exact arithmetic contract (h rounded to the compute
  dtype before the product, f32 accumulation, f32 carry and gate math).
- ``lstm_layer``: the hoisted input projection + recurrence, time-major.
- ``LAUNCHES``: one per kernel launch (one call of the C entry point,
  which runs the whole recurrence of one or two directions).

Only the inference form exists: the backward kernels (and the
``save_cell`` form that feeds them) come with training, so the wrappers
raise when autograd would need a gradient through them.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple

import torch

LAUNCHES = 0
_count_lock = threading.Lock()

_TYPE_CODES = {
    (torch.float32, torch.float32): 0,
    (torch.bfloat16, torch.bfloat16): 1,
    (torch.float32, torch.bfloat16): 2,
    (torch.bfloat16, torch.float32): 3,
}


def _check(xw, mask, wh, dtype) -> torch.dtype:
    """Validate one direction's operands; returns the compute dtype."""
    dtype = wh.dtype if dtype is None else dtype
    if xw.dim() != 3 or xw.shape[2] % 4:
        raise ValueError(f"xw must be [T, B, 4H], got {tuple(xw.shape)}")
    T, B, G = xw.shape
    H = G // 4
    if T < 1 or B < 1 or H < 1:
        raise ValueError(f"empty recurrence: xw {tuple(xw.shape)}")
    if tuple(wh.shape) != (H, G):
        raise ValueError(f"wh must be [{H}, {G}], got {tuple(wh.shape)}")
    if tuple(mask.shape) != (T, 1, B):
        raise ValueError(f"mask must be [{T}, 1, {B}], got {tuple(mask.shape)}")
    if mask.dtype != torch.float32:
        raise TypeError(f"mask must be float32, got {mask.dtype}")
    if (xw.dtype, dtype) not in _TYPE_CODES:
        raise TypeError(
            f"unsupported stream/compute dtypes {xw.dtype}/{dtype}"
        )
    if not (xw.device == mask.device == wh.device):
        raise ValueError("xw, mask and wh must be on one device")
    if torch.is_grad_enabled() and (xw.requires_grad or wh.requires_grad):
        raise NotImplementedError(
            "the LSTM recurrence has no backward yet (ROADMAP Queue 1, "
            "training); call it under torch.no_grad()/inference_mode()"
        )
    return dtype


def lstm_recurrence_ref(
    xw: torch.Tensor,  # [T, B, 4H] stream dtype
    mask: torch.Tensor,  # [T, 1, B] float32
    wh: torch.Tensor,  # [H, 4H]
    *,
    reverse: bool = False,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain PyTorch recurrence; ys [T, B, H] in xw's dtype."""
    dtype = _check(xw, mask, wh, dtype)
    T, B, G = xw.shape
    H = G // 4
    w = wh.to(dtype).to(torch.float32)
    h = torch.zeros((B, H), dtype=torch.float32, device=xw.device)
    c = torch.zeros_like(h)
    ys = torch.empty((T, B, H), dtype=xw.dtype, device=xw.device)
    for t in (reversed(range(T)) if reverse else range(T)):
        gates = xw[t].to(torch.float32) + torch.matmul(
            h.to(dtype).to(torch.float32), w)
        i = torch.sigmoid(gates[:, :H])
        f = torch.sigmoid(gates[:, H:2 * H])
        g = torch.tanh(gates[:, 2 * H:3 * H])
        o = torch.sigmoid(gates[:, 3 * H:])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        m = mask[t, 0][:, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        ys[t] = h.to(xw.dtype)
    return ys


def _launch(dirs: Sequence[Tuple[torch.Tensor, torch.Tensor, bool]],
            mask: torch.Tensor, dtype: torch.dtype):
    """Run the kernel over one or two directions that share T, B, H, the
    dtypes and the mask. ``dirs``: (xw, wh already in ``dtype``, reverse)."""
    global LAUNCHES
    from . import _build

    xw0 = dirs[0][0]
    T, B, G = xw0.shape
    H = G // 4
    for xw, wh, _ in dirs:
        if not xw.is_cuda:
            raise ValueError("the LSTM kernel takes CUDA tensors only")
        if not (xw.is_contiguous() and wh.is_contiguous()
                and mask.is_contiguous()):
            raise ValueError("the LSTM kernel takes contiguous tensors only")
        if xw.shape != xw0.shape or xw.dtype != xw0.dtype:
            raise ValueError("both directions must share shape and dtype")
        if wh.dtype != dtype:
            raise TypeError(f"wh must be {dtype}, got {wh.dtype}")
    lib = _build.load()
    # Outputs and the zeroed (h ping, h pong, c) scratch are allocated on
    # the launch stream; the caching allocator reuses a freed block only
    # for work queued after the kernel on that stream.
    outs = [torch.empty((T, B, H), dtype=xw0.dtype, device=xw0.device)
            for _ in dirs]
    scratch = [torch.zeros((3, B, H), dtype=torch.float32, device=xw0.device)
               for _ in dirs]
    args = []
    for (xw, wh, rev), ys, sc in zip(dirs, outs, scratch):
        args += [xw.data_ptr(), wh.data_ptr(), ys.data_ptr(), sc.data_ptr(),
                 int(rev)]
    if len(dirs) == 1:
        args *= 2  # the second direction's slots are not read
    stream = torch.cuda.current_stream(xw0.device).cuda_stream
    err = lib.vo_lstm_fwd(
        _TYPE_CODES[(xw0.dtype, dtype)], T, B, H, len(dirs),
        mask.data_ptr(), *args, stream,
    )
    _build.check(err, "vo_lstm_fwd")
    with _count_lock:
        LAUNCHES += 1
    return outs


def lstm_recurrence(
    xw: torch.Tensor,  # [T, B, 4H] stream dtype (f32 or bf16)
    mask: torch.Tensor,  # [T, 1, B] float32, 1 = valid
    wh: torch.Tensor,  # [H, 4H]
    *,
    reverse: bool = False,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Masked LSTM recurrence; ys [T, B, H] in xw's dtype. ``dtype`` is
    the compute dtype h and wh are rounded to before the product
    (default: wh's dtype). ``reverse`` walks time back to front inside the
    kernel; inputs and outputs stay in natural time order."""
    dtype = _check(xw, mask, wh, dtype)
    if xw.device.type == "cpu":
        return lstm_recurrence_ref(xw, mask, wh, reverse=reverse, dtype=dtype)
    return _launch([(xw, wh.to(dtype).contiguous(), reverse)], mask, dtype)[0]


def blstm_recurrence(
    xw_fwd: torch.Tensor,
    xw_bwd: torch.Tensor,
    mask: torch.Tensor,
    wh_fwd: torch.Tensor,
    wh_bwd: torch.Tensor,
    *,
    dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both directions of one BLSTM layer: forward over ``xw_fwd``,
    reverse over ``xw_bwd``, in ONE kernel launch on CUDA."""
    dtype = _check(xw_fwd, mask, wh_fwd, dtype)
    _check(xw_bwd, mask, wh_bwd, dtype)
    if xw_fwd.device.type == "cpu":
        return (
            lstm_recurrence_ref(xw_fwd, mask, wh_fwd, reverse=False,
                                dtype=dtype),
            lstm_recurrence_ref(xw_bwd, mask, wh_bwd, reverse=True,
                                dtype=dtype),
        )
    ys_f, ys_b = _launch(
        [(xw_fwd, wh_fwd.to(dtype).contiguous(), False),
         (xw_bwd, wh_bwd.to(dtype).contiguous(), True)],
        mask, dtype,
    )
    return ys_f, ys_b


def input_projection(x: torch.Tensor, wx: torch.Tensor, b: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """Hoisted gate inputs ``(x @ wx + b)`` for every frame at once, cast
    to the stream dtype: x [T, B, D] -> xw [T, B, 4H] (as
    ``lstm_pallas.py:546-550``: product in the compute dtype, bias added
    in f32, then one rounding to the stream dtype)."""
    xw = torch.matmul(x.to(dtype), wx.to(dtype)).to(torch.float32)
    return (xw + b.to(torch.float32)).to(dtype).contiguous()


def lstm_layer(
    x: torch.Tensor,  # [T, B, D] time-major
    mask: torch.Tensor,  # [T, 1, B] float32
    wx: torch.Tensor,
    wh: torch.Tensor,
    b: torch.Tensor,
    *,
    reverse: bool = False,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """One directional layer, time-major: ys [T, B, H] in ``dtype``
    (counterpart of ``lstm_pallas.lstm_layer_pallas(time_major=True)``)."""
    xw = input_projection(x, wx, b, dtype)
    return lstm_recurrence(xw, mask, wh, reverse=reverse, dtype=dtype)
