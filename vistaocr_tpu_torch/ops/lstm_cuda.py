"""Masked LSTM recurrence and its BPTT: wrappers of the CUDA kernels and
their plain versions.

Counterpart of ``vistaocr_tpu/ops/lstm_pallas.py:51-163, 230-552``. The
kernels are ``csrc/lstm_fwd.cu`` (``_fwd_kernel``, inference and
``save_cell`` forms) and ``csrc/lstm_bwd.cu`` (``_bwd_kernel`` and
``_bwd_kernel_rev`` with ``_bptt_frame``, plus the dwh reduction); their
source notes say what they replace, what bounds them and what their
design does about it.

- ``lstm_recurrence`` / ``blstm_recurrence``: under ``no_grad`` /
  ``inference_mode`` they run the inference form; when autograd needs a
  gradient they go through ``BLstmRecurrence`` (the ``save_cell`` form
  forward, the BPTT backward), as ``_fwd_rule`` / ``_bwd_rule``
  (``lstm_pallas.py:476-490``) do. On a CUDA tensor they launch the
  kernels or raise; on a CPU tensor (or with ``plain=True``, the
  ``"pallas_interpret"`` path) they run the plain versions. There is no
  fallback from a kernel to its plain version.
- ``lstm_recurrence_ref`` / ``lstm_bptt_ref`` (= ``bptt_gates_ref`` then
  ``bptt_frames_ref``) / ``lstm_dwh_ref``: the plain PyTorch versions,
  Python loops over T with the kernels' exact rounding contract (h
  rounded to the compute dtype before each product, f32 accumulation,
  f32 carries and gate math, streams in the stream dtype).
  ``lstm_recurrence_ref`` is differentiable by autograd: it is the
  ``"scan"`` oracle.
- ``input_projection`` / ``lstm_layer``: the hoisted input projection
  (+ recurrence), time-major.
- Launch counters, one per call of a C entry point (which runs the whole
  recurrence of one or two directions): ``LAUNCHES`` (forward kernel,
  both forms), ``SAVE_CELL_LAUNCHES`` (of which the ``save_cell`` form),
  ``FWD_GRID_LAUNCHES`` (of which f32 weights on ``lstm_fwd_grid``: one
  launch), ``FWD_ROWS_LAUNCHES`` (of which f32 weights on
  ``lstm_fwd_rows``: one launch), ``FWD_TC_LAUNCHES`` (of which bf16
  weights above ``PERSISTENT_MAX_H`` on ``lstm_fwd_tc``: one launch),
  ``STEP_LAUNCHES`` (f32 weights on ``lstm_step``: T a call),
  ``BWD_LAUNCHES`` (BPTT frames), ``GATES_GEMM_LAUNCHES`` (of which the
  gate GEMM, any design: one launch), ``GATES_WIDE_LAUNCHES`` (of which
  ``bptt_gates_gemm_wide``),
  ``BWD_PERSISTENT_LAUNCHES`` (of which the persistent frame loop: one
  launch), ``BWD_TC_LAUNCHES`` (of which ``lstm_bwd_tc``: one launch),
  ``BWD_ROWS_LAUNCHES`` (of which the f32-weight ``lstm_bwd_rows``: one
  launch), ``FRAME_LAUNCHES``, ``CELL_LAUNCHES`` and ``DH_LAUNCHES`` (the
  f32-weight per-frame loops' kernels, each counted T a call) and
  ``DWH_LAUNCHES`` (dwh reduction: one launch).
- Routes. bf16 weights: a BPTT call's gate GEMM (every frame's gate
  recompute as one GEMM) is ``bptt_gates_gemm_wide``, persistent 128 x
  256 wgmma tiles whose stores of ``pre`` drain under the next tile's
  products (its operands are bf16 values, as wgmma takes them). Up to
  ``PERSISTENT_MAX_H`` a forward call is one kernel launch for all frames
  (``lstm_fwd_persistent``), the BPTT's frame loop one more
  (``lstm_bwd_persistent``, a cluster taking 32, 16 or 8 batch rows by B:
  ``persistent_plan``) and dwh ``lstm_dwh_tc``. Above it (F2) no
  cluster holds wh: the forward is ``lstm_fwd_tc`` (one cooperative
  launch over the card, each CTA's bf16 slice of wh in registers as
  ``mma.sync`` fragments, h exchanged in bf16 through L2 behind a frame
  counter) and the frame loop ``lstm_bwd_tc`` (the same skeleton: one
  cooperative launch, each CTA's bf16 rows of wh in registers, the
  dgates of every unit exchanged in bf16 through L2 a frame, CTA pairs
  sharing each copy by multicast), both up to
  H=1056 for two directions; beyond it both run on the f32-weight kernels
  below, wh widened to f32 (exact; the wrapper passes wh in both types)
  and the products' operands rounded to bf16 where the plain versions
  round them; dwh is ``lstm_dwh_tc`` in 128 x 256 tiles, which ask the L2
  for a third fewer bytes a product than its 128 x 128 ones (at F2's
  H=1000 the rows are not whole 128-byte lines, and the L2 is what bounds
  dwh). The frame loop's design is the library's choice by weight type,
  B and H (``loop_design``, chosen on an H100).
  f32 weights: the forward by shape
  (``forward_design``, chosen on an H100) as one cooperative
  ``lstm_fwd_grid`` launch (a direction spread over the card, each CTA's
  slice of wh on chip, h exchanged through L2 behind a frame counter;
  H=512 up to B=320), from B=385 at H=512 to 528 (two directions) one
  cooperative ``lstm_fwd_rows`` launch (CTAs over unit slices x row
  groups, each row group waiting only on its own CTAs), else one
  ``lstm_step`` launch per frame; the BPTT is ``bptt_gates_gemm``'s f32
  form on the FMA units (TF32 would change the numbers), then by B
  (``loop_design``):
  ``bptt_frame`` a frame (the cell backward and the dh product in one
  launch; 1 + T launches, B <= 32), beyond it one cooperative
  ``lstm_bwd_rows`` launch (the same skeleton turned around: the cell
  backward of a CTA's units and rows, then their dh from every unit's
  dgates, exchanged through L2; 2 launches) for two directions up to
  H=528, else
  ``bptt_cell`` and ``bptt_dh`` a frame (1 + 2T launches); dwh
  is ``lstm_dwh_fma``, exact f32 FMAs with the rows split into ranges of
  at most 2048 (and enough ranges for two CTAs an SM), the partial tiles
  added in split order inside the launch.
  ``FWD_DESIGNS``, ``GEMM_DESIGNS``, ``LOOP_DESIGNS`` and ``DWH_DESIGNS``
  name the designs, so that each can be held to the plain version and
  timed beside the library's choice.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import torch

LAUNCHES = 0
SAVE_CELL_LAUNCHES = 0
BWD_LAUNCHES = 0
GATES_GEMM_LAUNCHES = 0
GATES_WIDE_LAUNCHES = 0
BWD_PERSISTENT_LAUNCHES = 0
BWD_TC_LAUNCHES = 0
BWD_ROWS_LAUNCHES = 0
FRAME_LAUNCHES = 0
CELL_LAUNCHES = 0
DH_LAUNCHES = 0
DWH_LAUNCHES = 0
FWD_GRID_LAUNCHES = 0
FWD_ROWS_LAUNCHES = 0
FWD_TC_LAUNCHES = 0
STEP_LAUNCHES = 0
_count_lock = threading.Lock()

# the largest H the persistent bf16-weight kernels take (MAX_H of
# csrc/lstm_fwd.cu, BMAX_H of csrc/lstm_bwd.cu: a 16-CTA cluster holds all
# of wh); above it bf16 weights run on the f32-weight kernels
PERSISTENT_MAX_H = 512

# the gate GEMM's designs, by their codes in csrc/lstm_bwd.cu: "fma"
# (bptt_gates_gemm's f32 form on the FMA units; f32 weights, and the
# route bf16 weights above PERSISTENT_MAX_H took before "wide") and
# "wide" (bptt_gates_gemm_wide, persistent 128 x 256 wgmma tiles; bf16
# weights only). dwh's designs for bf16 operands: lstm_dwh_tc in "tiles"
# of 128 x 128 (the library's up to PERSISTENT_MAX_H) or "wide" ones of
# 128 x 256 (above it).
GEMM_DESIGNS = ("fma", "wide")
DWH_DESIGNS = ("tiles", "wide")
# the BPTT frame loop's designs, by their codes in csrc/lstm_bwd.cu
# (vo_lstm_bwd_named's loop): the f32-weight loops "split" (bptt_cell and
# bptt_dh a frame), "fold" (bptt_frame a frame) and "rows" (lstm_bwd_rows,
# one launch), wh in f32; bf16 weights' "persistent" (lstm_bwd_persistent,
# up to PERSISTENT_MAX_H) and "tc" (lstm_bwd_tc, above it up to H=1056 for
# two directions), wh in bf16
LOOP_DESIGNS = ("split", "fold", "persistent", "tc", "rows")
# the forward's designs, by their codes in csrc/lstm_fwd.cu
# (vo_lstm_fwd_named): the f32-weight route's "step" (lstm_step a frame),
# "grid" (lstm_fwd_grid) and "rows" (lstm_fwd_rows), wh in f32; "tc"
# (lstm_fwd_tc, bf16 weights above PERSISTENT_MAX_H) and "persistent"
# (lstm_fwd_persistent, bf16 weights up to it), wh in bf16
FWD_DESIGNS = ("step", "grid", "tc", "persistent", "rows")
# the designs that read wh in bf16 (bf16 weights only)
_BF16_WH = ("tc", "persistent")

_TYPE_CODES = {
    (torch.float32, torch.float32): 0,
    (torch.bfloat16, torch.bfloat16): 1,
    (torch.float32, torch.bfloat16): 2,
    (torch.bfloat16, torch.float32): 3,
}


def _count(name: str, n: int = 1) -> None:
    with _count_lock:
        globals()[name] += n


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
    return dtype


def _gates(xw_t, h, w, dtype):
    """i, f, g, o of one frame: f32(xw_t) + round(h) @ w."""
    H = w.shape[0]
    gates = xw_t.to(torch.float32) + torch.matmul(
        h.to(dtype).to(torch.float32), w)
    return (torch.sigmoid(gates[:, :H]), torch.sigmoid(gates[:, H:2 * H]),
            torch.tanh(gates[:, 2 * H:3 * H]), torch.sigmoid(gates[:, 3 * H:]))


def lstm_recurrence_ref(
    xw: torch.Tensor,  # [T, B, 4H] stream dtype
    mask: torch.Tensor,  # [T, 1, B] float32
    wh: torch.Tensor,  # [H, 4H]
    *,
    reverse: bool = False,
    dtype: Optional[torch.dtype] = None,
    save_cell: bool = False,
):
    """Plain PyTorch recurrence: ys [T, B, H] in xw's dtype, and with
    ``save_cell`` also cs [T, B, H] (c after the mask freeze, in xw's
    dtype, as ``_fwd_kernel:91-92`` stores it)."""
    dtype = _check(xw, mask, wh, dtype)
    T, B, G = xw.shape
    H = G // 4
    w = wh.to(dtype).to(torch.float32)
    h = torch.zeros((B, H), dtype=torch.float32, device=xw.device)
    c = torch.zeros_like(h)
    ys: List[torch.Tensor] = [h] * T
    cs: List[torch.Tensor] = [c] * T
    for t in (reversed(range(T)) if reverse else range(T)):
        i, f, g, o = _gates(xw[t], h, w, dtype)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        m = mask[t, 0][:, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        ys[t] = h.to(xw.dtype)
        cs[t] = c.to(xw.dtype)
    if save_cell:
        return torch.stack(ys), torch.stack(cs)
    return torch.stack(ys)


def bptt_gates_ref(
    xw: torch.Tensor,  # [T, B, 4H] stream dtype
    ys: torch.Tensor,  # [T, B, H] stream dtype (saved by the forward)
    wh: torch.Tensor,  # [H, 4H]
    *,
    reverse: bool = False,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The BPTT's gate recompute for every frame at once (the first stage
    of ``lstm_bptt_ref``): f32 pre [T, B, 4H] = f32(xw[t]) +
    round(ys[tp]) @ round(wh), with ys[tp] the scan predecessor's saved
    row, zero at the edge frame (whose pre is f32(xw) alone)."""
    dtype = wh.dtype if dtype is None else dtype
    h_prev = torch.zeros_like(ys)
    if reverse:
        h_prev[:-1] = ys[1:]
    else:
        h_prev[1:] = ys[:-1]
    return xw.to(torch.float32) + torch.matmul(
        h_prev.to(dtype).to(torch.float32), wh.to(dtype).to(torch.float32))


def bptt_frames_ref(
    pre: torch.Tensor,  # [T, B, 4H] float32, from bptt_gates_ref
    mask: torch.Tensor,  # [T, 1, B] float32
    wh: torch.Tensor,  # [H, 4H]
    cs: torch.Tensor,  # [T, B, H] stream dtype (saved by the forward)
    dys: torch.Tensor,  # [T, B, H] stream dtype
    *,
    reverse: bool = False,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The BPTT's frame loop over recomputed gates (the second stage of
    ``lstm_bptt_ref``), in the forward scan's order walked backwards:
    dxw [T, B, 4H] in the stream dtype (``dys``'s). Only the chain dxw[t]
    -> dh -> dxw[t-1] is sequential."""
    dtype = wh.dtype if dtype is None else dtype
    T, B, G = pre.shape
    H = G // 4
    sdt = dys.dtype
    w = wh.to(dtype).to(torch.float32)
    f32 = dict(dtype=torch.float32, device=pre.device)
    dh = torch.zeros((B, H), **f32)
    dc = torch.zeros((B, H), **f32)
    dxw = torch.empty((T, B, G), dtype=sdt, device=pre.device)
    for t in (range(T) if reverse else reversed(range(T))):
        tp = t + 1 if reverse else t - 1
        c_prev = (cs[tp].to(torch.float32) if 0 <= tp < T
                  else torch.zeros((B, H), **f32))
        gates = pre[t]
        i, f = torch.sigmoid(gates[:, :H]), torch.sigmoid(gates[:, H:2 * H])
        g, o = torch.tanh(gates[:, 2 * H:3 * H]), torch.sigmoid(gates[:, 3 * H:])
        tc = torch.tanh(cs[t].to(torch.float32))
        m = mask[t, 0][:, None]
        dh_t = dh + dys[t].to(torch.float32)
        dc_t = dc + dh_t * o * (1.0 - tc * tc)
        dxw[t] = torch.cat([
            (dc_t * g) * i * (1.0 - i) * m,
            (dc_t * c_prev) * f * (1.0 - f) * m,
            (dc_t * i) * (1.0 - g * g) * m,
            (dh_t * tc) * o * (1.0 - o) * m,
        ], dim=1).to(sdt)
        dg = dxw[t].to(dtype).to(torch.float32)
        dh = torch.matmul(dg, w.T) + (1.0 - m) * dh_t
        dc = m * (dc_t * f) + (1.0 - m) * dc
    return dxw


def lstm_bptt_ref(
    xw: torch.Tensor,  # [T, B, 4H] stream dtype
    mask: torch.Tensor,  # [T, 1, B] float32
    wh: torch.Tensor,  # [H, 4H]
    ys: torch.Tensor,  # [T, B, H] stream dtype (saved by the forward)
    cs: torch.Tensor,  # [T, B, H] stream dtype (saved by the forward)
    dys: torch.Tensor,  # [T, B, H] stream dtype
    *,
    reverse: bool = False,
    dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain BPTT, ``_bptt_frame`` (``lstm_pallas.py:230-278``) in two
    stages, as the bf16-weight kernels run it: the gates of every frame
    recomputed at once (``bptt_gates_ref``; the recompute reads the saved
    ys, so nothing in it waits on the recurrence), then the frame loop
    (``bptt_frames_ref``), with the same rounding points as the TPU
    kernel's frame. Returns (dxw [T, B, 4H] in xw's dtype, dwh [H, 4H]
    float32)."""
    dtype = _check(xw, mask, wh, dtype)
    pre = bptt_gates_ref(xw, ys, wh, reverse=reverse, dtype=dtype)
    dxw = bptt_frames_ref(pre, mask, wh, cs, dys.to(xw.dtype),
                          reverse=reverse, dtype=dtype)
    return dxw, lstm_dwh_ref(ys, dxw, reverse=reverse, dtype=dtype)


def lstm_dwh_ref(ys: torch.Tensor, dxw: torch.Tensor, *, reverse: bool = False,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain dwh [H, 4H] f32 = sum over frames, in the BPTT's order, of
    round(h_prev)^T @ round(dxw[t]) (h_prev: the scan predecessor's ys row,
    zero at the edge)."""
    T = ys.shape[0]
    dwh = torch.zeros((ys.shape[2], dxw.shape[2]), dtype=torch.float32,
                      device=ys.device)
    for t in (range(T) if reverse else reversed(range(T))):
        tp = t + 1 if reverse else t - 1
        if 0 <= tp < T:
            dwh += torch.matmul(ys[tp].to(dtype).to(torch.float32).T,
                                dxw[t].to(dtype).to(torch.float32))
    return dwh


def _check_launch(tensors: Sequence[torch.Tensor]) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError("the LSTM kernels take CUDA tensors only")
        if not t.is_contiguous():
            raise ValueError("the LSTM kernels take contiguous tensors only")


def _dir_args(per_dir: List[list], n_fields: int) -> list:
    """Flatten per-direction C arguments; with one direction the second
    direction's slots repeat the first (the kernel does not read them)."""
    args = [a for d in per_dir for a in d]
    if len(per_dir) == 1:
        args *= 2
    assert len(args) == 2 * n_fields
    return args


def lstm_fwd(dirs: Sequence[Tuple[torch.Tensor, torch.Tensor, bool]],
             mask: torch.Tensor, dtype: torch.dtype, *,
             save_cell: bool = False, design: Optional[str] = None):
    """The forward kernel over one or two directions that share T, B, H,
    the dtypes and the mask (CUDA only). ``dirs``: (xw, wh already in
    ``dtype``, reverse). Returns (ys list, cs list or None). The library
    chooses the design by weight type and shape (``forward_design``);
    ``design`` (``FWD_DESIGNS``) names one instead (the f32-weight route's
    "grid", "rows" and "step" take any weight type, each at the H it
    fits), so that each can be held to the plain version and timed at any
    shape it takes; a bad name raises before anything is built."""
    from . import _build

    if design is not None and design not in FWD_DESIGNS:
        raise ValueError(f"unknown forward design {design!r}; one of "
                         f"{FWD_DESIGNS}")
    if design in _BF16_WH and dtype != torch.bfloat16:
        raise ValueError(f"the {design} forward takes bf16 weights only")
    xw0 = dirs[0][0]
    T, B, G = xw0.shape
    H = G // 4
    for xw, wh, _ in dirs:
        _check_launch((xw, wh, mask))
        if xw.shape != xw0.shape or xw.dtype != xw0.dtype:
            raise ValueError("both directions must share shape and dtype")
        if wh.dtype != dtype:
            raise TypeError(f"wh must be {dtype}, got {wh.dtype}")
    lib = _build.load()
    code = _TYPE_CODES[(xw0.dtype, dtype)]
    d = (lib.vo_lstm_fwd_design(code, B, H, len(dirs)) if design is None
         else FWD_DESIGNS.index(design))
    name = FWD_DESIGNS[d]
    # the bf16-weight kernels read wh in bf16, the f32-weight route in f32
    # (bf16 weights widened, exactly)
    bf16_wh = name in _BF16_WH
    # Outputs (and the zeroed scratch: the cooperative designs' h(t) by
    # step parity, their carries and frame counters; lstm_step's h and c)
    # are allocated on the launch stream; the caching allocator
    # reuses a freed block only for work queued after the kernel on that
    # stream.
    new = dict(dtype=xw0.dtype, device=xw0.device)
    ys = [torch.empty((T, B, H), **new) for _ in dirs]
    cs = [torch.empty((T, B, H), **new) for _ in dirs] if save_cell else None
    scratch = [None if name == "persistent" else torch.zeros(
        lib.vo_lstm_fwd_scratch(B, H), dtype=torch.float32,
        device=xw0.device) for _ in dirs]
    whs = [wh if bf16_wh else wh.to(torch.float32).contiguous()
           for _, wh, _ in dirs]
    args = _dir_args([
        [xw.data_ptr(), whs[k].data_ptr(), ys[k].data_ptr(),
         cs[k].data_ptr() if save_cell else None,
         None if scratch[k] is None else scratch[k].data_ptr(), int(rev)]
        for k, (xw, _, rev) in enumerate(dirs)], 6)
    call = (code, T, B, H, len(dirs), mask.data_ptr(), *args,
            torch.cuda.current_stream(xw0.device).cuda_stream)
    if design is None:
        _build.check(lib.vo_lstm_fwd(*call), "vo_lstm_fwd")
    else:
        _build.check(lib.vo_lstm_fwd_named(d, *call), "vo_lstm_fwd_named")
    _count("LAUNCHES")
    if save_cell:
        _count("SAVE_CELL_LAUNCHES")
    if name == "grid":
        _count("FWD_GRID_LAUNCHES")
    elif name == "rows":
        _count("FWD_ROWS_LAUNCHES")
    elif name == "step":
        _count("STEP_LAUNCHES", T)
    elif name == "tc":
        _count("FWD_TC_LAUNCHES")
    return ys, cs


def forward_design(dtype: torch.dtype, B: int, H: int, ndir: int = 2) -> str:
    """The forward design (``FWD_DESIGNS``) the library runs for ``ndir``
    directions with weights in ``dtype`` at B, H; builds the kernels on
    first use."""
    from . import _build

    code = 1 if dtype == torch.bfloat16 else 0
    return FWD_DESIGNS[_build.load().vo_lstm_fwd_design(code, B, H, ndir)]


def _gemm_code(lib, gemm: Optional[str], code: int, H: int) -> int:
    if gemm is None:
        return lib.vo_lstm_bwd_gates_design(code, H)
    return GEMM_DESIGNS.index(gemm)


def _loop_name(loop: Optional[str], dtype: torch.dtype) -> Optional[str]:
    """The frame loop design named by ``loop`` (``LOOP_DESIGNS``), or None
    for the library's; raises on a bad name, before any kernel is
    built."""
    if loop is not None and loop not in LOOP_DESIGNS:
        raise ValueError(f"unknown frame loop {loop!r}; one of {LOOP_DESIGNS}")
    if loop in _BF16_WH and dtype != torch.bfloat16:
        raise ValueError(f"the {loop} frame loop takes bf16 weights only")
    return loop


def loop_design(dtype: torch.dtype, B: int, H: int, ndir: int = 2) -> str:
    """The frame loop design (``LOOP_DESIGNS``) the library runs for
    ``ndir`` directions with weights in ``dtype`` at B, H; builds the
    kernels on first use."""
    from . import _build

    code = 1 if dtype == torch.bfloat16 else 0
    return LOOP_DESIGNS[_build.load().vo_lstm_bwd_loop_design(code, B, H,
                                                              ndir)]


def persistent_plan(B: int, H: int, ndir: int = 2,
                    stream: torch.dtype = torch.bfloat16) -> dict:
    """The plan ``lstm_bwd_persistent`` runs for ``ndir`` directions with
    bf16 weights, streams in ``stream``, at B and H (up to
    ``PERSISTENT_MAX_H``): the batch ``rows`` a cluster takes (the wgmma N:
    32, 16 or 8, chosen by B), the ``clusters`` it launches, how many the
    card holds at once (``resident``) and the ``waves`` that makes. Builds
    the kernels on first use; CUDA only."""
    import ctypes

    from . import _build

    out = (ctypes.c_int * 3)()
    _build.check(_build.load().vo_lstm_bwd_persistent_plan(
        _TYPE_CODES[(stream, torch.bfloat16)], B, H, ndir, out),
        "vo_lstm_bwd_persistent_plan")
    rows, clusters, resident = out
    return {"rows": rows, "clusters": clusters, "resident": resident,
            "waves": -(-clusters // resident)}


def lstm_bptt_frames(dirs, mask: torch.Tensor, dtype: torch.dtype,
                     *, return_gates: bool = False,
                     gemm: Optional[str] = None,
                     loop: Optional[str] = None):
    """The BPTT frame kernels over one or two directions (CUDA only): the
    gate GEMM (every frame's gate recompute as one GEMM: f32 weights
    ``bptt_gates_gemm``'s FMA form, bf16 weights
    ``bptt_gates_gemm_wide``), then the frame loop, by the library's
    choice (``loop_design``): with bf16 weights ``lstm_bwd_persistent`` up
    to ``PERSISTENT_MAX_H`` and ``lstm_bwd_tc`` above it where it fits
    (one launch each), else (f32 weights; bf16 weights beyond, read
    widened to f32) by B ``bptt_frame`` per frame (folded, B <= 32), or
    ``lstm_bwd_rows`` (one launch) where it fits, or ``bptt_cell`` and
    ``bptt_dh`` per frame (split). ``dirs``: (xw, wh
    already in ``dtype``, ys, cs, dys in the stream dtype, reverse).
    Returns dxw per direction, and with ``return_gates`` also the
    recomputed gates ``pre`` [T, B, 4H] f32 per direction (what
    ``bptt_gates_ref`` computes), so that each kernel can be held to its
    plain version. ``loop`` (``LOOP_DESIGNS``) names the frame loop's
    design and ``gemm`` the gate GEMM's (``GEMM_DESIGNS``) instead of the
    library's choice, so that
    each design can be held to the plain version and timed at any shape
    it takes (the f32-weight loops take bf16 weights at any H;
    ``gemm="fma"`` with bf16 weights above ``PERSISTENT_MAX_H`` is the
    route they took before the wide GEMM)."""
    from . import _build

    name = _loop_name(loop, dtype)
    xw0 = dirs[0][0]
    T, B, G = xw0.shape
    H = G // 4
    for xw, wh, ys, cs, dys, _ in dirs:
        _check_launch((xw, wh, ys, cs, dys, mask))
        if xw.shape != xw0.shape or not (
                xw.dtype == ys.dtype == cs.dtype == dys.dtype == xw0.dtype):
            raise ValueError("both directions must share shape and dtype")
        if not ys.shape == cs.shape == dys.shape == (T, B, H):
            raise ValueError("ys, cs and dys must be [T, B, H]")
        if wh.dtype != dtype:
            raise TypeError(f"wh must be {dtype}, got {wh.dtype}")
    lib = _build.load()
    code = _TYPE_CODES[(xw0.dtype, dtype)]
    g = _gemm_code(lib, gemm, code, H)
    if g != 0 and dtype != torch.bfloat16:
        raise ValueError(f"the {GEMM_DESIGNS[g]} gate GEMM takes bf16 "
                         f"weights only")
    lp = (lib.vo_lstm_bwd_loop_design(code, B, H, len(dirs)) if name is None
          else LOOP_DESIGNS.index(name))
    name = LOOP_DESIGNS[lp]
    dxw = [torch.empty_like(d[0]) for d in dirs]
    # the recomputed gates [T, B, 4H] f32, and behind them the frame loop's
    # own (the per-frame loops' carries; the cooperative loops' frame
    # counters, dgates exchange and carries, which the library zeroes where
    # it must); freed
    # after the call on the launch stream
    n_pre = T * B * G
    scratch = [torch.empty(lib.vo_lstm_bwd_scratch(lp, T, B, H) // 4,
                           dtype=torch.float32, device=xw0.device)
               for _ in dirs]
    # wh in f32 where the FMA gate GEMM or an f32 frame loop reads it (bf16
    # weights widened, exactly)
    widen = dtype == torch.bfloat16 and (g == 0 or name not in _BF16_WH)
    whf = [d[1].to(torch.float32).contiguous() if widen else d[1]
           for d in dirs]
    args = _dir_args([
        [xw.data_ptr(), wh.data_ptr(), whf[k].data_ptr(), ys.data_ptr(),
         cs.data_ptr(), dys.data_ptr(), dxw[k].data_ptr(),
         scratch[k].data_ptr(), int(rev)]
        for k, (xw, wh, ys, cs, dys, rev) in enumerate(dirs)], 9)
    _build.check(lib.vo_lstm_bwd_named(
        g, lp, code, T, B, H, len(dirs), mask.data_ptr(), *args,
        torch.cuda.current_stream(xw0.device).cuda_stream),
        "vo_lstm_bwd_named")
    _count("BWD_LAUNCHES")
    _count_gates(g)
    if name == "persistent":
        _count("BWD_PERSISTENT_LAUNCHES")
    elif name == "tc":
        _count("BWD_TC_LAUNCHES")
    elif name == "rows":
        _count("BWD_ROWS_LAUNCHES")
    elif name == "fold":
        _count("FRAME_LAUNCHES", T)
    else:
        _count("CELL_LAUNCHES", T)
        _count("DH_LAUNCHES", T)
    if return_gates:
        return dxw, [s[:n_pre].view(T, B, G) for s in scratch]
    return dxw


def _count_gates(g: int) -> None:
    _count("GATES_GEMM_LAUNCHES")
    if GEMM_DESIGNS[g] == "wide":
        _count("GATES_WIDE_LAUNCHES")


def lstm_dwh(dirs, dtype: torch.dtype, *,
             design: Optional[str] = None) -> List[torch.Tensor]:
    """The dwh reduction kernel over one or two directions (CUDA only).
    ``dirs``: (ys, dxw, reverse) in the stream dtype. Returns dwh [H, 4H]
    float32 per direction. With bf16 operands (every type pair but f32
    streams with f32 weights) the library runs ``lstm_dwh_tc`` in 128 x
    128 tiles up to ``PERSISTENT_MAX_H`` and in 128 x 256 above it (the
    rows split into ranges of at most 4096, one CTA each, the partial
    tiles added in order in a workspace allocated here); ``design``
    (``DWH_DESIGNS``) names one instead. f32 operands take
    ``lstm_dwh_fma`` (its split's workspace allocated here as well)."""
    from . import _build

    ys0 = dirs[0][0]
    T, B, H = ys0.shape
    for ys, dxw, _ in dirs:
        _check_launch((ys, dxw))
        if ys.shape != ys0.shape or dxw.shape != (T, B, 4 * H) or not (
                ys.dtype == dxw.dtype == ys0.dtype):
            raise ValueError("ys [T, B, H] and dxw [T, B, 4H] must share "
                             "T, B and the stream dtype")
    lib = _build.load()
    code = _TYPE_CODES[(ys0.dtype, dtype)]
    if design is not None and code == 0:
        raise ValueError("f32 streams and weights have one dwh design")
    d = lib.vo_lstm_dwh_design(code, H) if design is None else (
        DWH_DESIGNS.index(design))
    dwh = [torch.empty((H, 4 * H), dtype=torch.float32, device=ys0.device)
           for _ in dirs]
    # the wide tiles' split contraction: tickets and partial tiles
    nbytes = lib.vo_lstm_dwh_workspace(d, code, T, B, H, len(dirs))
    work = torch.empty(nbytes, dtype=torch.uint8, device=ys0.device) if (
        nbytes) else None
    args = _dir_args([
        [ys.data_ptr(), dxw.data_ptr(), dwh[k].data_ptr(), int(rev)]
        for k, (ys, dxw, rev) in enumerate(dirs)], 4)
    err = lib.vo_lstm_dwh(d, code, T, B, H, len(dirs), *args,
                          None if work is None else work.data_ptr(),
                          torch.cuda.current_stream(ys0.device).cuda_stream)
    _build.check(err, "vo_lstm_dwh")
    _count("DWH_LAUNCHES")
    return dwh


def lstm_forward_cells(dirs, mask: torch.Tensor, dtype: torch.dtype,
                       *, plain: bool = False):
    """The ``save_cell`` forward of one or two directions: ``dirs`` is a
    sequence of (xw, wh, reverse); returns [(ys, cs), ...]. One kernel
    launch on CUDA (unless ``plain``); the plain version on the CPU."""
    if dirs[0][0].is_cuda and not plain:
        ys, cs = lstm_fwd([(xw, wh.to(dtype).contiguous(), r)
                           for xw, wh, r in dirs], mask, dtype,
                          save_cell=True)
        return list(zip(ys, cs))
    return [lstm_recurrence_ref(xw, mask, wh, reverse=r, dtype=dtype,
                                save_cell=True) for xw, wh, r in dirs]


def lstm_bptt(dirs, mask: torch.Tensor, dtype: torch.dtype,
              *, plain: bool = False):
    """BPTT of one or two directions: ``dirs`` is a sequence of (xw, wh,
    ys, cs, dys, reverse); returns [(dxw, dwh float32), ...]. The kernels
    on CUDA (unless ``plain``); the plain version on the CPU."""
    if dirs[0][0].is_cuda and not plain:
        dxw = lstm_bptt_frames([(xw, wh.to(dtype).contiguous(), ys, cs, dys, r)
                                for xw, wh, ys, cs, dys, r in dirs],
                               mask, dtype)
        dwh = lstm_dwh([(d[2], g, d[5]) for d, g in zip(dirs, dxw)], dtype)
        return list(zip(dxw, dwh))
    return [lstm_bptt_ref(xw, mask, wh, ys, cs, dys, reverse=r, dtype=dtype)
            for xw, wh, ys, cs, dys, r in dirs]


class BLstmRecurrence(torch.autograd.Function):
    """The recurrence of one or two directions with a hand-written
    backward (``jax.custom_vjp`` of ``lstm_recurrence_pallas``):
    ``apply(mask, dtype, reverses, plain, xw0, wh0[, xw1, wh1])`` returns
    ys per direction. The forward saves the cell states (``save_cell``
    form); the backward runs the BPTT, with dys cast to the stream dtype
    first and dwh cast back to wh's dtype (``_bwd_rule``)."""

    @staticmethod
    def forward(ctx, mask, dtype, reverses, plain, *xw_wh):
        xws, whs = xw_wh[0::2], xw_wh[1::2]
        out = lstm_forward_cells(list(zip(xws, whs, reverses)), mask, dtype,
                                 plain=plain)
        ys = [y for y, _ in out]
        ctx.save_for_backward(mask, *xws, *whs, *ys, *(c for _, c in out))
        ctx.meta = (dtype, reverses, plain, len(xws))
        return tuple(ys)

    @staticmethod
    def backward(ctx, *dys):
        dtype, reverses, plain, n = ctx.meta
        mask, *saved = ctx.saved_tensors
        xws, whs, ys, cs = (saved[k * n:(k + 1) * n] for k in range(4))
        dys = [torch.zeros_like(y) if d is None
               else d.to(y.dtype).contiguous() for d, y in zip(dys, ys)]
        res = lstm_bptt(list(zip(xws, whs, ys, cs, dys, reverses)), mask,
                        dtype, plain=plain)
        grads = []
        for (dxw, dwh), wh in zip(res, whs):
            grads += [dxw, dwh.to(wh.dtype)]
        return (None, None, None, None, *grads)


def _recurrence(dirs, mask, dtype, plain: bool):
    """ys per direction of ``dirs`` = (xw, wh, reverse): through
    ``BLstmRecurrence`` when autograd needs a gradient, else the inference
    form (one kernel launch on CUDA, the plain loop on the CPU)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for xw, wh, _ in dirs for t in (xw, wh)):
        flat = [t for xw, wh, _ in dirs for t in (xw, wh)]
        return BLstmRecurrence.apply(mask, dtype,
                                     tuple(r for *_, r in dirs), plain, *flat)
    if dirs[0][0].is_cuda and not plain:
        ys, _ = lstm_fwd([(xw, wh.to(dtype).contiguous(), r)
                          for xw, wh, r in dirs], mask, dtype)
        return ys
    return [lstm_recurrence_ref(xw, mask, wh, reverse=r, dtype=dtype)
            for xw, wh, r in dirs]


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
    return _recurrence([(xw, wh, reverse)], mask, dtype, False)[0]


def blstm_recurrence(
    xw_fwd: torch.Tensor,
    xw_bwd: torch.Tensor,
    mask: torch.Tensor,
    wh_fwd: torch.Tensor,
    wh_bwd: torch.Tensor,
    *,
    dtype: Optional[torch.dtype] = None,
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both directions of one BLSTM layer: forward over ``xw_fwd``,
    reverse over ``xw_bwd``, in ONE kernel launch on CUDA (one per pass:
    forward, BPTT frames, dwh). ``plain`` runs the plain versions on any
    device (``lstm_impl="pallas_interpret"``)."""
    dtype = _check(xw_fwd, mask, wh_fwd, dtype)
    _check(xw_bwd, mask, wh_bwd, dtype)
    ys_f, ys_b = _recurrence([(xw_fwd, wh_fwd, False), (xw_bwd, wh_bwd, True)],
                             mask, dtype, plain)
    return ys_f, ys_b


def input_projection(x: torch.Tensor, wx: torch.Tensor, b: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """Hoisted gate inputs ``(x @ wx + b)`` for every frame at once, cast
    to the stream dtype: x [T, B, D] -> xw [T, B, 4H]. As
    ``lstm_pallas.py:546-550`` (``preferred_element_type=f32``): the
    operands are rounded to ``dtype``, their product is accumulated and
    kept in f32, the f32 bias is added, and the sum is rounded once.

    On CUDA without autograd, a bf16 product runs as one cuBLAS bf16 GEMM
    with f32 output (``torch.mm(..., out_dtype=torch.float32)``, which has
    no derivative); otherwise the operands are rounded and multiplied in
    f32, which is the same product."""
    xq, wq = x.to(dtype), wx.to(dtype)
    grad = torch.is_grad_enabled() and (xq.requires_grad or wq.requires_grad)
    if xq.is_cuda and dtype == torch.bfloat16 and not grad:
        xw = torch.mm(xq.reshape(-1, xq.shape[-1]), wq,
                      out_dtype=torch.float32).reshape(*xq.shape[:-1], -1)
    else:
        xw = torch.matmul(xq.to(torch.float32), wq.to(torch.float32))
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
