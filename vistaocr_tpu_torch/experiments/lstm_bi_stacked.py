"""Direction-stacked BLSTM layer: both directions of one layer as the two
planes of a ``[T, 2, B, *]`` layout.

Counterpart of ``experiments/lstm_bi_stacked.py:65-278``. The C entries
are ``csrc/lstm_bi_stacked.cu``'s ``vo_bi_lstm_fwd`` (``_bi_fwd_kernel``)
and ``vo_bi_lstm_bwd`` (``_bi_bwd_kernel``): they run the layer kernels'
designs (``csrc/lstm_fwd.cu``, ``csrc/lstm_bwd.cu``) on the two planes in
place, as a layer's two directions with a frame pitch of 2B rows and a
mask each; its source note says how. ``bi_design`` names the designs a
shape runs.

Contract (the experiment's, not production's ``lstm_cuda``): ``xw``
``[T, 2, B, 4H]`` and the outputs ``ys``/``cs`` ``[T, 2, B, H]`` are f32;
plane 1 holds the backward direction flipped in time, with its own mask
plane (``mask [T, 2, B]`` f32); ``wh [2, H, 4H]`` is rounded to the
compute ``dtype``, and so is h before each product; carries and gate
math are f32; ``dwh`` is f32.

- ``bilstm_layer_stacked``: one bidirectional layer, as
  ``bilstm_layer_pallas`` (``:248-278``): the fused ``[D, 8H]`` input
  projection (a plain GEMM, f32 accumulation, f32 bias), the flips and
  stacks, and ``BiRecurrence``.
- ``BiRecurrence``: the autograd Function of ``bi_recurrence_pallas``
  (``:222-245``): the forward saves ``cs``; the backward returns ``dxw``,
  ``None`` and ``dwh`` in ``wh``'s dtype. On a CUDA tensor it launches
  the kernels or raises; on a CPU tensor (or with ``plain=True``) it runs
  the plain versions. No fallback.
- ``bi_recurrence_ref`` / ``bi_bptt_ref``: the plain versions, Python
  loops over T with the kernels' rounding.
- ``bi_lstm_fwd_cuda`` / ``bi_lstm_bwd_cuda``: the kernel wrappers (CUDA
  tensors only), each adding one to ``BI_FWD_LAUNCHES`` /
  ``BI_BWD_LAUNCHES`` per call of its C entry point (which runs all T
  frames of both planes); ``lstm_cuda``'s counters do not move, since
  the entries call the layer's C route directly.
- ``bi_planes``: the per-plane mapping the entries run, as the layer's
  plain versions take it (plane views, a mask each, ``reverse=False``).
"""

from __future__ import annotations

import threading
from typing import Tuple

import torch

BI_FWD_LAUNCHES = 0
BI_BWD_LAUNCHES = 0
_count_lock = threading.Lock()

_W_TYPES = {torch.float32: 0, torch.bfloat16: 1}
# the layer's design names (ops/lstm_cuda.py), by the C codes
# vo_bi_lstm_design returns
_FWD_DESIGNS = ("step", "grid", "tc", "persistent", "rows")
_GEMM_DESIGNS = ("fma", "wide")
_LOOP_DESIGNS = ("split", "fold", "persistent", "tc", "rows")
_DWH_DESIGNS = ("tiles", "wide")


def _count(name: str) -> None:
    with _count_lock:
        globals()[name] += 1


def _check(xw, mask, wh, dtype) -> None:
    if xw.dim() != 4 or xw.shape[1] != 2 or xw.shape[3] % 4:
        raise ValueError(f"xw must be [T, 2, B, 4H], got {tuple(xw.shape)}")
    T, _, B, G = xw.shape
    H = G // 4
    if T < 1 or B < 1 or H < 1:
        raise ValueError(f"empty recurrence: xw {tuple(xw.shape)}")
    if xw.dtype != torch.float32 or mask.dtype != torch.float32:
        raise TypeError("xw and mask must be float32")
    if tuple(mask.shape) != (T, 2, B):
        raise ValueError(f"mask must be [{T}, 2, {B}], got {tuple(mask.shape)}")
    if tuple(wh.shape) != (2, H, G):
        raise ValueError(f"wh must be [2, {H}, {G}], got {tuple(wh.shape)}")
    if dtype not in _W_TYPES:
        raise TypeError(f"unsupported compute dtype {dtype}")
    if not (xw.device == mask.device == wh.device):
        raise ValueError("xw, mask and wh must be on one device")


def _gates(xw_t, h, w, dtype):
    """i, f, g, o of one frame of both planes: xw_t + round(h) @ w."""
    H = w.shape[1]
    gates = xw_t + torch.bmm(h.to(dtype).to(torch.float32), w)
    return (torch.sigmoid(gates[..., :H]), torch.sigmoid(gates[..., H:2 * H]),
            torch.tanh(gates[..., 2 * H:3 * H]),
            torch.sigmoid(gates[..., 3 * H:]))


def bi_recurrence_ref(xw: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
                      dtype: torch.dtype = torch.float32,
                      save_cell: bool = False):
    """Plain ``_bi_fwd_kernel``: ys [T, 2, B, H] f32 (and cs with
    ``save_cell``)."""
    _check(xw, mask, wh, dtype)
    T, _, B, G = xw.shape
    w = wh.to(dtype).to(torch.float32)
    h = torch.zeros((2, B, G // 4), dtype=torch.float32, device=xw.device)
    c = torch.zeros_like(h)
    ys, cs = [], []
    for t in range(T):
        i, f, g, o = _gates(xw[t], h, w, dtype)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        m = mask[t][:, :, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        ys.append(h)
        cs.append(c)
    if save_cell:
        return torch.stack(ys), torch.stack(cs)
    return torch.stack(ys)


def bi_bptt_ref(xw: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
                ys: torch.Tensor, cs: torch.Tensor, dys: torch.Tensor,
                dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain ``_bi_bwd_kernel``, frame by frame from T-1 down to 0:
    (dxw [T, 2, B, 4H] f32, masked; dwh [2, H, 4H] f32 summed in the loop
    from the rounded h_prev and the rounded dgates)."""
    _check(xw, mask, wh, dtype)
    T, _, B, G = xw.shape
    H = G // 4
    w = wh.to(dtype).to(torch.float32)
    f32 = dict(dtype=torch.float32, device=xw.device)
    dh = torch.zeros((2, B, H), **f32)
    dc = torch.zeros((2, B, H), **f32)
    dwh = torch.zeros((2, H, G), **f32)
    dxw = torch.empty_like(xw)
    zero = torch.zeros((2, B, H), **f32)
    for t in reversed(range(T)):
        h_prev = ys[t - 1] if t > 0 else zero
        c_prev = cs[t - 1] if t > 0 else zero
        i, f, g, o = _gates(xw[t], h_prev, w, dtype)
        tc = torch.tanh(cs[t])
        m = mask[t][:, :, None]
        dh_t = dh + dys[t]
        dc_t = dc + dh_t * o * (1.0 - tc * tc)
        dxw[t] = torch.cat([
            (dc_t * g) * i * (1.0 - i) * m,
            (dc_t * c_prev) * f * (1.0 - f) * m,
            (dc_t * i) * (1.0 - g * g) * m,
            (dh_t * tc) * o * (1.0 - o) * m,
        ], dim=-1)
        dg = dxw[t].to(dtype).to(torch.float32)
        dwh += torch.bmm(h_prev.to(dtype).to(torch.float32).transpose(1, 2),
                         dg)
        dh = torch.bmm(dg, w.transpose(1, 2)) + (1.0 - m) * dh_t
        dc = m * (dc_t * f) + (1.0 - m) * dc
    return dxw, dwh


def bi_planes(xw: torch.Tensor, mask: torch.Tensor, ys=None, cs=None,
              dys=None):
    """The stacked layout as the layer's two directions, the mapping
    ``vo_bi_lstm_fwd`` / ``vo_bi_lstm_bwd`` run on the card: for plane p,
    views ``xw[:, p]`` (and ``ys``, ``cs``, ``dys``; frames 2B rows apart),
    its own mask ``mask[:, p:p+1]`` [T, 1, B] and ``reverse=False``.
    Returns a list of two dicts, one a plane."""
    out = []
    for p in range(2):
        plane = {"xw": xw[:, p], "mask": mask[:, p:p + 1], "reverse": False}
        for name, t in (("ys", ys), ("cs", cs), ("dys", dys)):
            if t is not None:
                plane[name] = t[:, p]
        out.append(plane)
    return out


def bi_design(dtype: torch.dtype, B: int, H: int) -> dict:
    """The layer designs the stacked entries run with weights in ``dtype``
    at B, H (the names of ``lstm_cuda.FWD_DESIGNS``, ``GEMM_DESIGNS``,
    ``LOOP_DESIGNS`` and ``DWH_DESIGNS``; dwh ``"fma"`` for f32 weights):
    the forward, the BPTT's gate GEMM and frame loop, and dwh. Builds the
    kernels on first use; CUDA only."""
    import ctypes

    from ..ops import _build

    if dtype not in _W_TYPES:
        raise TypeError(f"unsupported compute dtype {dtype}")
    out = (ctypes.c_int * 4)()
    _build.check(_build.load().vo_bi_lstm_design(_W_TYPES[dtype], B, H, out),
                 "vo_bi_lstm_design")
    return {"forward": _FWD_DESIGNS[out[0]], "gemm": _GEMM_DESIGNS[out[1]],
            "loop": _LOOP_DESIGNS[out[2]],
            "dwh": "fma" if out[3] < 0 else _DWH_DESIGNS[out[3]]}


def _check_launch(*tensors) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError("the stacked BLSTM kernels take CUDA tensors only")
        if not t.is_contiguous():
            raise ValueError(
                "the stacked BLSTM kernels take contiguous tensors only")


def bi_lstm_fwd_cuda(xw: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
                     dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6a on the card: (ys, cs) [T, 2, B, H] f32; ``wh`` already in
    ``dtype``."""
    from ..ops import _build

    _check(xw, mask, wh, dtype)
    _check_launch(xw, mask, wh)
    if wh.dtype != dtype:
        raise TypeError(f"wh must be {dtype}, got {wh.dtype}")
    T, _, B, G = xw.shape
    lib = _build.load()
    ys = torch.empty((T, 2, B, G // 4), dtype=torch.float32, device=xw.device)
    cs = torch.empty_like(ys)
    err = lib.vo_bi_lstm_fwd(_W_TYPES[dtype], T, B, G // 4, xw.data_ptr(),
                             mask.data_ptr(), wh.data_ptr(), ys.data_ptr(),
                             cs.data_ptr(),
                             torch.cuda.current_stream(xw.device).cuda_stream)
    _build.check(err, "vo_bi_lstm_fwd")
    _count("BI_FWD_LAUNCHES")
    return ys, cs


def bi_lstm_bwd_cuda(xw, mask, wh, ys, cs, dys,
                     dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6b on the card: (dxw [T, 2, B, 4H], dwh [2, H, 4H]) f32; ``wh``
    already in ``dtype``."""
    from ..ops import _build

    _check(xw, mask, wh, dtype)
    _check_launch(xw, mask, wh, ys, cs, dys)
    if wh.dtype != dtype:
        raise TypeError(f"wh must be {dtype}, got {wh.dtype}")
    T, _, B, G = xw.shape
    H = G // 4
    for name, t in (("ys", ys), ("cs", cs), ("dys", dys)):
        if tuple(t.shape) != (T, 2, B, H) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [{T}, 2, {B}, {H}]")
    lib = _build.load()
    dxw = torch.empty_like(xw)
    dwh = torch.empty((2, H, G), dtype=torch.float32, device=xw.device)
    err = lib.vo_bi_lstm_bwd(_W_TYPES[dtype], T, B, H, xw.data_ptr(),
                             mask.data_ptr(), wh.data_ptr(), ys.data_ptr(),
                             cs.data_ptr(), dys.data_ptr(), dxw.data_ptr(),
                             dwh.data_ptr(), None,
                             torch.cuda.current_stream(xw.device).cuda_stream)
    _build.check(err, "vo_bi_lstm_bwd")
    _count("BI_BWD_LAUNCHES")
    return dxw, dwh


class BiRecurrence(torch.autograd.Function):
    """``apply(xw, mask, wh, dtype, plain)`` -> ys [T, 2, B, H] f32: the
    kernels on CUDA (unless ``plain``), the plain loops on the CPU."""

    @staticmethod
    def forward(ctx, xw, mask, wh, dtype, plain):
        if xw.is_cuda and not plain:
            ys, cs = bi_lstm_fwd_cuda(xw, mask, wh.to(dtype).contiguous(),
                                      dtype)
        else:
            ys, cs = bi_recurrence_ref(xw, mask, wh, dtype, save_cell=True)
        ctx.save_for_backward(xw, mask, wh, ys, cs)
        ctx.meta = (dtype, plain)
        return ys

    @staticmethod
    def backward(ctx, dys):
        xw, mask, wh, ys, cs = ctx.saved_tensors
        dtype, plain = ctx.meta
        dys = dys.to(torch.float32).contiguous()
        if xw.is_cuda and not plain:
            dxw, dwh = bi_lstm_bwd_cuda(xw, mask, wh.to(dtype).contiguous(),
                                        ys, cs, dys, dtype)
        else:
            dxw, dwh = bi_bptt_ref(xw, mask, wh, ys, cs, dys, dtype)
        return dxw, None, dwh.to(wh.dtype), None, None


def bi_recurrence(xw: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
                  dtype: torch.dtype = torch.float32, *,
                  plain: bool = False) -> torch.Tensor:
    """``bi_recurrence_pallas``: xw [T, 2, B, 4H] f32, mask [T, 2, B] f32,
    wh [2, H, 4H] -> ys [T, 2, B, H] f32."""
    _check(xw, mask, wh, dtype)
    return BiRecurrence.apply(xw, mask, wh, dtype, plain)


def bilstm_layer_stacked(
    x: torch.Tensor,  # [B, T, D]
    mask: torch.Tensor,  # [B, T] bool
    wx_f, wh_f, b_f, wx_b, wh_b, b_b,
    dtype: torch.dtype = torch.float32,
    *,
    plain: bool = False,
) -> torch.Tensor:
    """One bidirectional layer -> [B, T, 2H] f32 (forward ++ backward
    states): both input projections in one [B*T, D] @ [D, 8H] product,
    both recurrences in one kernel pair."""
    H = wh_f.shape[0]
    wx_both = torch.cat([wx_f, wx_b], dim=1)  # [D, 8H]
    b_both = torch.cat([b_f, b_b], dim=0)  # [8H]
    xw = (torch.matmul(x.to(dtype).to(torch.float32),
                       wx_both.to(dtype).to(torch.float32))
          + b_both.to(torch.float32))  # [B, T, 8H]
    xw = xw.transpose(0, 1)  # [T, B, 8H]
    xw2 = torch.stack([xw[..., :4 * H], torch.flip(xw[..., 4 * H:], [0])],
                      dim=1).contiguous()  # [T, 2, B, 4H]
    m = mask.transpose(0, 1).to(torch.float32)  # [T, B]
    m2 = torch.stack([m, torch.flip(m, [0])], dim=1).contiguous()  # [T, 2, B]
    wh2 = torch.stack([wh_f, wh_b], dim=0)  # [2, H, 4H]
    ys = bi_recurrence(xw2, m2, wh2, dtype, plain=plain)  # [T, 2, B, H]
    ys_f = ys[:, 0].transpose(0, 1)
    ys_b = torch.flip(ys[:, 1], [0]).transpose(0, 1)
    return torch.cat([ys_f, ys_b], dim=-1)
