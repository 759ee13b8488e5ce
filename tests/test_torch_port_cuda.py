"""Tests of the port that need an NVIDIA GPU: the CUDA kernels
(csrc/lstm_fwd.cu in both forms: the persistent bf16-weight kernel at the
main path's B, T and H, its determinism, its one launch per layer call
and its H limit; the f32-weight grid kernel at ragged B, H on both sides
of its resident-weight limit and T = 1 and 7, its determinism, its one
launch per layer call and the library's choice between it and the
per-frame f32 kernel; csrc/lstm_bwd.cu's BPTT
and dwh in all four stream/weight type pairs: with bf16 weights the gate
GEMM and the persistent frame loop at ragged B, T and H, their
determinism, their two launches per layer call and their H limit, with
f32 weights the f32 gate GEMM and the per-frame kernel at the GEMM's
tile edges, several clusters and H > 512, their determinism and their
1 + T launches; the f32 dwh (``lstm_dwh_fma``, ``-k f32_dwh``) at an
odd shape, H % 4 != 0, misaligned views, T = 1 and 2 and R on both sides
of a 4096-row chain, one or two directions, against the plain version
and the exact sum (no farther than one torch.mm), its reruns and its one
launch; bf16 weights above H=512 (type codes 1 and 2): the forward on
``lstm_fwd_tc`` (``-k f2``: H 520, 1000 and 1056, B 1 to 129, both forms,
reverse, reruns, one launch, the library's rule) and, named, on the
f32-weight kernels, the frame loop on ``lstm_bwd_tc`` (``-k
f2_tc_bptt``: H 520, 1000 and 1056, B 5 to 128, T 1 to 24, one
direction or two, reruns, one launch, H=1064 on the f32-weight loop)
and, named, on the f32-weight kernels, the gate GEMM and dwh on the
wide wgmma kernels, at H=520 and 1000 on both sides
of a 32-row tile, their determinism, their launches (counters and
profiler) and autograd, and the wide kernels alone (the persistent gate
GEMM and dwh's 128 x 256 tiles at ragged shapes, one or two directions,
against the plain version, the other designs, one torch.mm and the
exact sum); csrc/ctc.cu's alpha/beta at the
three train buckets, S > 1024 and T below its ring depth, their
determinism and their one launch each a call) against their plain
PyTorch versions, including ragged B/H edges and the tile edges, T = 1,
S = 1, empty labels and an infeasible CTC sample; the BPTT
kernels' determinism and dwh against one cuBLAS GEMM; their launch
counters; the autograd Functions' backward on the card; the model and
service paths that launch them; and the device beam search (every
variant's CUDA graph against the CPU search, replays bit-equal and equal
to the eager form, a graph per shape, a failed capture raising) and
deskew on the card against the CPU; and csrc/int8_conv.cu (the int8
conv of the int8 serving path, ``-k int8``): bit-equal to its plain
version over ragged shapes and both input types, half-even rounding and
clamping at the quantum edges, reruns bit-equal, its launch counter,
refusals of what it does not take, a CUDA graph replay, and an int8
service on the card. Every test is marked
``cuda`` and skips without a card. This file imports no JAX, so it runs
on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -q
"""

import tempfile

import numpy as np
import pytest
import torch

from vistaocr_tpu_torch.ops import _build, lstm_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _operands(dev, B, T, H, dtype, seed):
    rng = np.random.default_rng(seed)
    xw = torch.from_numpy(rng.normal(0, 1, (T, B, 4 * H)).astype(np.float32))
    wh = torch.from_numpy(
        rng.normal(0, 1 / np.sqrt(H), (H, 4 * H)).astype(np.float32))
    lengths = rng.integers(1, T + 1, B)
    lengths[0] = T
    mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    return (xw.to(dev, dtype), torch.from_numpy(mask[:, None, :]).to(dev),
            wh.to(dev, dtype))


# The persistent kernel (bf16 weights: type codes 1 and 2) at every B the
# main path makes around its 32-row cluster tiles (serving's max_batch of
# 128; training's 2**21 / (32 W) rows, 512 at W=128 and 1024 at W=64), T
# from 1 to a 2048-px line, the odd H=40 and the flagship H=512. B * T
# stays within what one bucket holds (B * T <= 2**21 / 128 in training,
# 128 * 512 in serving), so B=512 and 1024 come with T <= 2.
PERSISTENT_SHAPES = [(B, T, H) for B in (1, 33, 64, 65, 129, 512, 1024)
                     for T in (1, 2, 512) for H in (40, 512)
                     if B * T <= 129 * 512]
BF16_WEIGHT_TYPES = [(torch.bfloat16, torch.bfloat16, 3e-2),
                     (torch.float32, torch.bfloat16, 3e-2)]
PERSISTENT_CASES = [(shape, *types) for shape in PERSISTENT_SHAPES
                    for types in BF16_WEIGHT_TYPES]


def _typed(shapes):
    """(shape, stream, compute, tol): f32 and bf16 at ``shapes``."""
    return [(shape, dt, dt, tol) for shape in shapes
            for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2))]


def _device_operands(dev, B, T, H, stream, compute, seed, ndir=1):
    """xw per direction, a ragged mask [T, 1, B] (row 0 full) and wh per
    direction, drawn on the card (the large shapes are 10**8 values)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lengths = torch.randint(1, T + 1, (B,), generator=g, device=dev)
    lengths[0] = T
    mask = (torch.arange(T, device=dev)[:, None] < lengths[None, :]).float()
    xw = [torch.randn((T, B, 4 * H), generator=g, device=dev).to(stream)
          for _ in range(ndir)]
    wh = [(torch.randn((H, 4 * H), generator=g, device=dev) / H ** 0.5
           ).to(compute) for _ in range(ndir)]
    return xw, mask[:, None, :].contiguous(), wh


@pytest.mark.parametrize(
    "shape,stream,compute,tol",
    _typed([(5, 7, 40), (33, 20, 64), (1, 1, 1), (70, 9, 100)])
    + PERSISTENT_CASES)
@pytest.mark.parametrize("reverse", [False, True])
def test_kernel_matches_plain(dev, shape, stream, compute, tol, reverse):
    B, T, H = shape
    (xw,), mask, (wh,) = _device_operands(dev, B, T, H, stream, compute,
                                          seed=B * T + H)
    before = lstm_cuda.LAUNCHES
    with torch.no_grad():
        ys = lstm_cuda.lstm_recurrence(xw, mask, wh, reverse=reverse)
        ref = lstm_cuda.lstm_recurrence_ref(xw, mask, wh, reverse=reverse)
    torch.cuda.synchronize()
    assert lstm_cuda.LAUNCHES == before + 1
    assert ys.dtype == stream and ys.shape == (T, B, H)
    err = (ys.float() - ref.float()).abs().max().item()
    assert err <= tol, err


@pytest.mark.parametrize("stream,compute", [(torch.float32, torch.bfloat16),
                                            (torch.bfloat16, torch.float32)])
def test_mixed_stream_and_compute_dtypes(dev, stream, compute):
    xw, mask, wh = _operands(dev, 9, 11, 24, torch.float32, seed=3)
    xw = xw.to(stream)
    with torch.no_grad():
        ys = lstm_cuda.lstm_recurrence(xw, mask, wh, dtype=compute)
        ref = lstm_cuda.lstm_recurrence_ref(xw, mask, wh, dtype=compute)
    assert ys.dtype == stream
    assert (ys.float() - ref.float()).abs().max().item() <= 3e-2


@pytest.mark.parametrize(
    "shape,stream,compute,tol",
    [((17, 13, 48), torch.float32, torch.float32, 1e-4)] + PERSISTENT_CASES)
def test_both_directions_in_one_launch(dev, shape, stream, compute, tol):
    B, T, H = shape
    xw, mask, wh = _device_operands(dev, B, T, H, stream, compute, seed=5,
                                    ndir=2)
    before = lstm_cuda.LAUNCHES
    with torch.no_grad():
        f, r = lstm_cuda.blstm_recurrence(xw[0], xw[1], mask, wh[0], wh[1])
        rf = lstm_cuda.lstm_recurrence_ref(xw[0], mask, wh[0])
        rr = lstm_cuda.lstm_recurrence_ref(xw[1], mask, wh[1], reverse=True)
    torch.cuda.synchronize()
    assert lstm_cuda.LAUNCHES == before + 1
    assert (f.float() - rf.float()).abs().max().item() <= tol
    assert (r.float() - rr.float()).abs().max().item() <= tol


def test_persistent_kernel_is_deterministic(dev):
    """One owner per h/c element, no atomics: two runs, the same bits."""
    for stream, compute, _ in BF16_WEIGHT_TYPES:
        xw, mask, wh = _device_operands(dev, 129, 64, 512, stream, compute,
                                        seed=8, ndir=2)
        dirs = [(xw[0], wh[0], False), (xw[1], wh[1], True)]
        with torch.no_grad():
            runs = [lstm_cuda.lstm_forward_cells(dirs, mask, compute)
                    for _ in range(2)]
            inf = [lstm_cuda.blstm_recurrence(xw[0], xw[1], mask, wh[0],
                                              wh[1]) for _ in range(2)]
        for (ys_a, cs_a), (ys_b, cs_b) in zip(*runs):
            assert torch.equal(ys_a, ys_b) and torch.equal(cs_a, cs_b)
        for a, b in zip(*inf):
            assert torch.equal(a, b)


def test_one_forward_launch_per_layer_call(dev):
    """bf16 at B=32, T=512 (the W=2048 bucket): a torch.profiler window
    over one blstm_recurrence call, and over one save_cell call, holds one
    launch of the persistent forward kernel and none of the per-frame one.
    The window opens with small launches and a synchronise: the profiler
    misses kernels launched just after it starts."""
    from torch.profiler import ProfilerActivity, profile

    xw, mask, wh = _device_operands(dev, 32, 512, 512, torch.bfloat16,
                                    torch.bfloat16, seed=9, ndir=2)
    dirs = [(xw[0], wh[0], False), (xw[1], wh[1], True)]
    calls = [lambda: lstm_cuda.blstm_recurrence(xw[0], xw[1], mask, wh[0],
                                                wh[1]),
             lambda: lstm_cuda.lstm_forward_cells(dirs, mask, torch.bfloat16)]
    for call in calls:
        with torch.no_grad():
            call()  # built and warm
            torch.cuda.synchronize()
            pad = torch.zeros(1, device=dev)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(64):
                    pad.add_(1.0)
                torch.cuda.synchronize()
                call()
                torch.cuda.synchronize()
        counts = {}
        for e in prof.events():
            for name in ("lstm_fwd_persistent", "lstm_step"):
                if name in e.name:
                    counts[name] = counts.get(name, 0) + 1
        assert counts == {"lstm_fwd_persistent": 1}, counts


# The f32-weight grid kernel (type codes 0 and 3: lstm_fwd_grid) at ragged
# B around its 32-row tiles, H on both sides of where its wh slice stops
# fitting in shared memory (40 and 520 resident; 1000 streamed from L2) and
# T = 1 and 7, named explicitly (the library's shape rule is its own test).
F32_GRID_SHAPES = [(B, T, H) for B in (1, 5, 33, 129) for H in (40, 520, 1000)
                   for T in (1, 7)]
F32_WEIGHT_TYPES = [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)]


@pytest.mark.parametrize("shape", F32_GRID_SHAPES)
@pytest.mark.parametrize("stream,tol", F32_WEIGHT_TYPES)
def test_f32_grid_kernel_matches_plain(dev, shape, stream, tol):
    """Both forms, both directions in one launch, ragged mask: ys (and cs)
    against lstm_recurrence_ref; a second run gives the same bits."""
    B, T, H = shape
    xw, mask, wh = _device_operands(dev, B, T, H, stream, torch.float32,
                                    seed=B * T + H, ndir=2)
    dirs = [(xw[0], wh[0], False), (xw[1], wh[1], True)]
    before = (lstm_cuda.FWD_GRID_LAUNCHES, lstm_cuda.STEP_LAUNCHES)
    with torch.no_grad():
        refs = [lstm_cuda.lstm_recurrence_ref(x, mask, w, reverse=r,
                                              save_cell=True)
                for x, w, r in dirs]
        for save_cell in (False, True):
            runs = [lstm_cuda.lstm_fwd(dirs, mask, torch.float32,
                                       save_cell=save_cell, design="grid")
                    for _ in range(2)]
            torch.cuda.synchronize()
            (ys, cs), (ys2, cs2) = runs
            for k, (rys, rcs) in enumerate(refs):
                assert ys[k].dtype == stream and ys[k].shape == (T, B, H)
                assert (ys[k].float() - rys.float()).abs().max() <= tol
                assert torch.equal(ys[k], ys2[k])
                if save_cell:
                    assert (cs[k].float() - rcs.float()).abs().max() <= tol
                    assert torch.equal(cs[k], cs2[k])
            assert (cs is None) == (not save_cell)
    assert lstm_cuda.FWD_GRID_LAUNCHES == before[0] + 4
    assert lstm_cuda.STEP_LAUNCHES == before[1]


def test_f32_grid_kernel_one_direction_and_mixed_types(dev):
    """One direction a call (a grid of its own shape: twice the CTAs a
    direction) and type code 3 (bf16 streams, f32 weights) through the
    public entry points."""
    for stream, tol in F32_WEIGHT_TYPES:
        for B, T, H in ((33, 9, 512), (4, 5, 1000)):
            (xw,), mask, (wh,) = _device_operands(dev, B, T, H, stream,
                                                  torch.float32, seed=H + B)
            with torch.no_grad():
                for reverse in (False, True):
                    (ys,), _ = lstm_cuda.lstm_fwd([(xw, wh, reverse)], mask,
                                                  torch.float32,
                                                  design="grid")
                    ref = lstm_cuda.lstm_recurrence_ref(xw, mask, wh,
                                                        reverse=reverse)
                    assert (ys.float() - ref.float()).abs().max() <= tol


def _forward_kernel_counts(dev, B, T, H, save_cell,
                           names=("lstm_fwd_grid<", "lstm_step<")):
    """Launches of the f32-weight forward kernels (``names``) in a
    profiler window over one f32-weight forward call of both directions
    (the library's route)."""
    xw, mask, wh = _device_operands(dev, B, T, H, torch.float32,
                                    torch.float32, seed=9, ndir=2)
    dirs = [(xw[0], wh[0], False), (xw[1], wh[1], True)]
    if save_cell:
        def call():
            return lstm_cuda.lstm_forward_cells(dirs, mask, torch.float32)
    else:
        def call():
            return lstm_cuda.blstm_recurrence(xw[0], xw[1], mask, wh[0],
                                              wh[1])
    with torch.no_grad():
        return _profiled_counts(call, names)


@pytest.mark.parametrize("save_cell", [False, True])
def test_f32_grid_one_forward_launch_per_layer_call(dev, save_cell):
    """f32 weights at B=32, T=512, H=512 (the W=2048 bucket): one launch of
    lstm_fwd_grid for the whole layer call, and no lstm_step."""
    counts = _forward_kernel_counts(dev, 32, 512, 512, save_cell)
    assert counts == {"lstm_fwd_grid<": 1, "lstm_step<": 0}, counts


@pytest.mark.parametrize("B,H,design", [
    (32, 512, "grid"), (128, 512, "grid"), (320, 512, "grid"),
    (384, 512, "step"), (448, 512, "rows"), (512, 512, "rows"),
    (512, 528, "rows"), (512, 576, "step"), (512, 384, "step"),
    (128, 256, "grid"), (256, 256, "step"), (32, 1000, "grid"),
    (128, 1000, "step")])
def test_f32_grid_route_follows_the_library_rule(dev, B, H, design):
    """Each shape takes the route the library names (forward_design, as
    timed in turns on an H100: lstm_fwd_grid or lstm_fwd_rows, one launch,
    or lstm_step, T launches), and the launch counters say the same."""
    T = 3
    assert lstm_cuda.forward_design(torch.float32, B, H) == design
    names = {"grid": "lstm_fwd_grid<", "rows": "lstm_fwd_rows<",
             "step": "lstm_step<"}
    counters = {"grid": "FWD_GRID_LAUNCHES", "rows": "FWD_ROWS_LAUNCHES",
                "step": "STEP_LAUNCHES"}
    before = {d: getattr(lstm_cuda, c) for d, c in counters.items()}
    counts = _forward_kernel_counts(dev, B, T, H, save_cell=False,
                                    names=tuple(names.values()))
    assert counts == {n: (T if d == "step" else 1) if d == design else 0
                      for d, n in names.items()}, counts
    # the profiled call and its warm-up
    assert {d: getattr(lstm_cuda, c) - before[d]
            for d, c in counters.items()} == {
        d: (2 * T if d == "step" else 2) if d == design else 0
        for d in counters}


# The f32-weight cooperative forward at large B (lstm_fwd_rows: CTAs over
# 16-unit slices x row groups, 32-row tiles a warp): B across the tiles
# and row groups (33, 129, 321, 385, 511, 513), H = 40 and 520, T = 1 and
# 7, a row masked throughout (row 3), named explicitly; one direction at
# H=520 and at H=640, the largest slice of wh that fits (H=1000 does not:
# test_f32_rows_forward_limits).
F32_ROWS_SHAPES = [(B, T, H) for B in (33, 129, 321, 385, 511, 513)
                   for H in (40, 520) for T in (1, 7)]
F32_ROWS_ONE_DIR = [(70, 7, 520), (385, 2, 640)]


def _masked_row3(mask):
    mask = mask.clone()
    mask[:, 0, 3] = 0.0
    return mask


@pytest.mark.parametrize("shape", F32_ROWS_SHAPES + F32_ROWS_ONE_DIR)
@pytest.mark.parametrize("stream,tol", F32_WEIGHT_TYPES)
def test_f32_rows_forward_matches_plain(dev, shape, stream, tol):
    """Both forms against lstm_recurrence_ref (both directions in one
    launch; one direction alone at F32_ROWS_ONE_DIR), a row invalid
    throughout (its ys and cs stay zero); a second run gives the same
    bits; one launch a layer call."""
    B, T, H = shape
    ndir = 1 if shape in F32_ROWS_ONE_DIR else 2
    xw, mask, wh = _device_operands(dev, B, T, H, stream, torch.float32,
                                    seed=B * T + H, ndir=ndir)
    mask = _masked_row3(mask)
    dirs = [(x, w, r) for x, w, r in zip(xw, wh, (False, True))]
    before = (lstm_cuda.FWD_ROWS_LAUNCHES, lstm_cuda.STEP_LAUNCHES,
              lstm_cuda.FWD_GRID_LAUNCHES)
    with torch.no_grad():
        refs = [lstm_cuda.lstm_recurrence_ref(x, mask, w, reverse=r,
                                              save_cell=True)
                for x, w, r in dirs]
        for save_cell in (False, True):
            runs = [lstm_cuda.lstm_fwd(dirs, mask, torch.float32,
                                       save_cell=save_cell, design="rows")
                    for _ in range(2)]
            torch.cuda.synchronize()
            (ys, cs), (ys2, cs2) = runs
            for k, (rys, rcs) in enumerate(refs):
                assert ys[k].dtype == stream and ys[k].shape == (T, B, H)
                assert (ys[k].float() - rys.float()).abs().max() <= tol
                assert torch.equal(ys[k], ys2[k])
                assert not ys[k][:, 3].float().abs().max().item()
                if save_cell:
                    assert (cs[k].float() - rcs.float()).abs().max() <= tol
                    assert torch.equal(cs[k], cs2[k])
            assert (cs is None) == (not save_cell)
    assert (lstm_cuda.FWD_ROWS_LAUNCHES, lstm_cuda.STEP_LAUNCHES,
            lstm_cuda.FWD_GRID_LAUNCHES) == (before[0] + 4, *before[1:])


@pytest.mark.parametrize("ndir", [1, 2])
def test_f32_rows_forward_limits(dev, ndir):
    """At H=1000 a CTA's [H, 64] f32 slice of wh does not fit in shared
    memory: naming lstm_fwd_rows raises (no fallback), the launch counter
    stays, and the library runs lstm_step there."""
    xw, mask, wh = _device_operands(dev, 5, 2, 1000, torch.float32,
                                    torch.float32, seed=4, ndir=ndir)
    dirs = [(x, w, r) for x, w, r in zip(xw, wh, (False, True))]
    before = lstm_cuda.FWD_ROWS_LAUNCHES
    with torch.no_grad(), pytest.raises(RuntimeError,
                                        match="vo_lstm_fwd_named"):
        lstm_cuda.lstm_fwd(dirs, mask, torch.float32, design="rows")
    assert lstm_cuda.FWD_ROWS_LAUNCHES == before
    assert lstm_cuda.forward_design(torch.float32, 512, 1000, ndir) == "step"


@pytest.mark.parametrize("save_cell", [False, True])
def test_f32_rows_one_forward_launch_per_layer_call(dev, save_cell):
    """f32 weights at B=512, T=32, H=512 (the W=128 bucket): one launch of
    lstm_fwd_rows for the whole layer call, and no lstm_step or
    lstm_fwd_grid (profiler)."""
    xw, mask, wh = _device_operands(dev, 512, 32, 512, torch.float32,
                                    torch.float32, seed=9, ndir=2)
    dirs = [(xw[0], wh[0], False), (xw[1], wh[1], True)]
    with torch.no_grad():
        counts = _profiled_counts(
            lambda: lstm_cuda.lstm_fwd(dirs, mask, torch.float32,
                                       save_cell=save_cell),
            ("lstm_fwd_rows<", "lstm_fwd_grid<", "lstm_step<"))
    assert counts == {"lstm_fwd_rows<": 1, "lstm_fwd_grid<": 0,
                      "lstm_step<": 0}, counts


def test_persistent_kernel_refuses_h_above_512(dev):
    """Above H=512 the persistent kernel is not launched: bf16 weights
    take lstm_fwd_tc (B=4 at H=520: one launch) and agree with the plain
    version as the persistent kernel does."""
    xw, mask, wh = _device_operands(dev, 4, 3, 520, torch.bfloat16,
                                    torch.bfloat16, seed=1)
    before = (lstm_cuda.LAUNCHES, lstm_cuda.FWD_TC_LAUNCHES,
              lstm_cuda.FWD_GRID_LAUNCHES, lstm_cuda.STEP_LAUNCHES)
    with torch.no_grad():
        ys = lstm_cuda.lstm_recurrence(xw[0], mask, wh[0])
        ref = lstm_cuda.lstm_recurrence_ref(xw[0], mask, wh[0])
    torch.cuda.synchronize()
    assert (lstm_cuda.LAUNCHES, lstm_cuda.FWD_TC_LAUNCHES,
            lstm_cuda.FWD_GRID_LAUNCHES, lstm_cuda.STEP_LAUNCHES) == (
        before[0] + 1, before[1] + 1, before[2], before[3])
    assert ys.dtype == torch.bfloat16
    assert (ys.float() - ref.float()).abs().max().item() <= 3e-2


# bf16 weights above H=512 (type codes 1 and 2): the library's
# lstm_fwd_tc, and the f32-weight kernels named (wh widened to f32 and h
# rounded to bf16 where the product reads it): H on both sides of the grid
# kernel's resident-weight limit, B on both sides of a 32-row tile, a
# ragged mask
F2_SHAPES = [(B, 7, H) for B in (5, 33) for H in (520, 1000)]
_FWD_COUNTERS = ("FWD_GRID_LAUNCHES", "STEP_LAUNCHES", "FWD_TC_LAUNCHES")


@pytest.mark.parametrize("shape", F2_SHAPES)
@pytest.mark.parametrize("stream,compute,tol", BF16_WEIGHT_TYPES)
def test_bf16_weights_above_512_forward_matches_plain(dev, shape, stream,
                                                      compute, tol):
    """Both forms and both directions against lstm_recurrence_ref within
    the persistent kernel's bound, through lstm_fwd_grid, lstm_step and the
    library's choice (lstm_fwd_tc: one launch a call); a second run gives
    the same bits."""
    B, T, H = shape
    xw, mask, wh = _device_operands(dev, B, T, H, stream, compute,
                                    seed=B * T + H, ndir=2)
    dirs = [(xw[0], wh[0], False), (xw[1], wh[1], True)]
    assert lstm_cuda.forward_design(compute, B, H) == "tc"
    with torch.no_grad():
        refs = [lstm_cuda.lstm_recurrence_ref(x, mask, w, reverse=r,
                                              save_cell=True)
                for x, w, r in dirs]
        for design in ("grid", "step", None):
            for save_cell in (False, True):
                before = [getattr(lstm_cuda, n) for n in _FWD_COUNTERS]
                runs = [lstm_cuda.lstm_fwd(dirs, mask, compute,
                                           save_cell=save_cell, design=design)
                        for _ in range(2)]
                torch.cuda.synchronize()
                assert [getattr(lstm_cuda, n) - b for n, b in zip(
                    _FWD_COUNTERS, before)] == {
                    None: [0, 0, 2], "grid": [2, 0, 0],
                    "step": [0, 2 * T, 0]}[design]
                (ys, cs), (ys2, cs2) = runs
                for k, (rys, rcs) in enumerate(refs):
                    assert ys[k].dtype == stream
                    assert (ys[k].float() - rys.float()).abs().max() <= tol
                    assert torch.equal(ys[k], ys2[k])
                    if save_cell:
                        assert (cs[k].float() - rcs.float()).abs().max() <= tol
                        assert torch.equal(cs[k], cs2[k])


def test_non_contiguous_input_raises(dev):
    xw = torch.zeros((4, 3, 8), device=dev).transpose(0, 1)
    wh = torch.zeros((2, 8), device=dev)
    mask = torch.ones((3, 1, 4), device=dev)
    assert not xw.is_contiguous()
    with torch.no_grad(), pytest.raises(ValueError):
        lstm_cuda.lstm_recurrence(xw, mask, wh)


def _tiny_snapshot(path, **cfg_kw):
    from vistaocr_tpu_torch.checkpoint import save_snapshot
    from vistaocr_tpu_torch.data import ShapeContract
    from vistaocr_tpu_torch.models import (CnnLstmOcr, ConvStageSpec,
                                           ModelConfig, init_parameters)
    from vistaocr_tpu_torch.text import Alphabet

    alphabet = Alphabet.from_charset("abcdefghij")
    cfg = ModelConfig(
        num_classes=alphabet.num_classes,
        stages=(ConvStageSpec(8, 2, (2, 2)), ConvStageSpec(16, 2, (2, 2)),
                ConvStageSpec(16, 2, (2, 1))),
        bridge_dim=32, lstm_hidden=24, **cfg_kw)
    model = CnnLstmOcr(cfg)
    init_parameters(model, torch.Generator().manual_seed(0))
    save_snapshot(path, state_dict=model.state_dict(), model_config=cfg,
                  alphabet=alphabet,
                  contract=ShapeContract(bucket_widths=(128, 256)))


def test_model_kernel_matches_plain_and_cpu(dev):
    from vistaocr_tpu_torch.checkpoint import load_model

    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (4, 32, 96), np.uint8))
    widths = torch.tensor([96, 93, 61, 5], dtype=torch.int32)
    with tempfile.TemporaryDirectory() as d:
        _tiny_snapshot(d)
        out = {}
        for name, device, impl in (("kernel", dev, "pallas"),
                                   ("plain", dev, "scan"),
                                   ("cpu", torch.device("cpu"), "auto")):
            model, _, _ = load_model(d, device, lstm_impl=impl)
            with torch.inference_mode():
                lp, fm = model(images.to(device), widths.to(device))
            out[name] = (lp.cpu(), fm.cpu())
    fm = out["cpu"][1]
    for name in ("kernel", "plain"):
        assert torch.equal(out[name][1], fm)
        err = (out[name][0] - out["cpu"][0]).abs()[fm].max().item()
        assert err <= 1e-4, (name, err)


def test_service_launches_the_kernel(dev):
    from vistaocr_tpu_torch.serve import OcrService, ServiceConfig

    rng = np.random.default_rng(1)
    lines = [rng.integers(0, 256, (32, int(w)), np.uint8)
             for w in rng.integers(20, 250, 6)]
    lines.append(rng.integers(0, 256, (48, 150), np.uint8))
    with tempfile.TemporaryDirectory() as d:
        _tiny_snapshot(d, compute_dtype="bfloat16")
        svc = OcrService(d, ServiceConfig(max_batch=8, warmup=False),
                         device="cuda")
        try:
            before = lstm_cuda.LAUNCHES
            results = svc.ocr_lines(lines)
            results.append(svc.submit(lines[0]).result(timeout=60))
            assert lstm_cuda.LAUNCHES > before
            assert all(isinstance(r.text, str) for r in results)
            assert all(0 < r.confidence <= 1 for r in results)
        finally:
            svc.close()


# --- the device beam search and deskew --------------------------------------

def _beam_posteriors(seed, B=6, T=40, K=8):
    """Blank-heavy seeded log-probs and a ragged mask, numpy."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2.5, (B, T, K)).astype(np.float32)
    logits[..., 0] += 1.5
    lp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))
          ).astype(np.float32)
    frames = rng.integers(4, T + 1, B)
    frames[0] = T
    return lp, np.arange(T)[None, :] < frames[:, None]


def _beam_variants():
    """(name, search keywords with host tables) for every variant of the
    search: plain and all-beams, the char LM at order 2, 3 and 4, the
    lexicon hard and with the unk bypass, the word LM dense, hashed
    bigram and hashed trigram, and the full stack with n-best finals."""
    from vistaocr_tpu_torch.decode import lm as plm
    from vistaocr_tpu_torch.decode.lexicon import Lexicon
    from vistaocr_tpu_torch.text import Alphabet, utf8_to_uxxxx

    al = Alphabet.from_charset("abcdef ")
    rng = np.random.default_rng(5)
    words = sorted({"".join(rng.choice(list("abcdef"), rng.integers(1, 5)))
                    for _ in range(15)})
    lex = Lexicon.from_words(al, words)
    corpus = [" ".join(rng.choice(words, 3)) for _ in range(100)]
    chars = [utf8_to_uxxxx(t) for t in corpus]
    lm2, lm3, lm4 = (plm.train_char_lm(chars, order=o) for o in (2, 3, 4))
    wlm2 = plm.train_char_lm(corpus, order=2)
    wlm3 = plm.train_char_lm(corpus, order=3)
    h4 = plm.hashed_logp_table(lm4, al)
    hw = plm.hashed_word_logp_table(wlm2, lex.words)
    nt, bd = lex.dense_tables()
    ntu, bdu = lex.dense_tables(unk=True)
    hard = dict(lex_next=nt, lex_boundary=bd)
    word = dict(space_id=lex.space_id, word_alpha=0.7, word_beta=0.3)
    char = dict(lm_alpha=0.5, lm_beta=0.2)
    dense_word = dict(word_table=plm.dense_word_logp_table(wlm2, lex.words),
                      word_ids=lex.word_id_table())
    return [
        ("plain", {}),
        ("plain_all_beams", dict(all_beams=True)),
        ("char_lm2", dict(lm_table=plm.dense_logp_table(lm2, al), **char)),
        ("char_lm3", dict(lm_table=plm.dense_logp_table(lm3, al), **char)),
        ("char_lm4", dict(lm_table=h4["t3"], lm_hash_keys=h4["keys"],
                          lm_hash_vals=h4["vals"], lm_rows=h4["rows"],
                          lm_probes=int(h4["probes"]), **char)),
        ("lexicon", hard),
        ("lexicon_unk", dict(lex_next=ntu, lex_boundary=bdu,
                             lex_unk_logp=-2.0, space_id=lex.space_id)),
        ("word_dense", dict(**hard, **dense_word, **word)),
        ("word_hashed", dict(**hard, word_uni=hw["uni"], word_bo=hw["bo"],
                             word_hash_keys=hw["keys"],
                             word_hash_vals=hw["vals"],
                             word_probes=int(hw["probes"]),
                             word_ids=lex.word_id_table(), **word)),
        ("word_trigram_unk", dict(
            lex_next=ntu, lex_boundary=bdu, lex_unk_logp=-1.5,
            word_unk_logp=plm.word_unk_logp(wlm3),
            word_ids=lex.word_id_table(unk=True),
            **plm.device_word_tables(wlm3, lex.words), **word)),
        ("full_stack_nbest", dict(lm_table=plm.dense_logp_table(lm3, al),
                                  all_beams=True, **char, **hard,
                                  **dense_word, **word)),
    ]


BEAM_VARIANTS = ["plain", "plain_all_beams", "char_lm2", "char_lm3",
                 "char_lm4", "lexicon", "lexicon_unk", "word_dense",
                 "word_hashed", "word_trigram_unk", "full_stack_nbest"]


def _beam_program(kw, device):
    """A BeamProgram of the variant, and its call's tables on device."""
    import functools

    from vistaocr_tpu_torch.decode import device_beam as db

    static = {k: v for k, v in kw.items()
              if k in ("all_beams", "lm_alpha", "lm_beta")}
    tables = db.device_tables(
        {k: v for k, v in kw.items() if k not in static}, device)
    prog = db.BeamProgram(functools.partial(
        db.beam_scan_collapsed, beam_width=8, topk=4, prune_logp=-12.0,
        **static))
    return prog, tables


@pytest.mark.parametrize("name", BEAM_VARIANTS)
def test_device_beam_on_cuda_matches_cpu(dev, name):
    """Each variant's graph on the card against the same search on the
    CPU: integer rows equal, scores within 1e-5; two replays bit-equal
    and equal to the eager form on the card."""
    from vistaocr_tpu_torch.decode import device_beam as db

    kw = dict(_beam_variants())[name]
    lp, mask = _beam_posteriors(len(name))
    cpu_prog, cpu_tables = _beam_program(kw, "cpu")
    want = cpu_prog(torch.from_numpy(lp), torch.from_numpy(mask),
                    **cpu_tables)
    prog, tables = _beam_program(kw, dev)
    lp_d, mask_d = torch.from_numpy(lp).to(dev), torch.from_numpy(mask).to(dev)
    captures = db.GRAPH_CAPTURES
    replays = db.GRAPH_REPLAYS
    first = prog(lp_d, mask_d, **tables)
    second = prog(lp_d, mask_d, **tables)
    eager = prog(lp_d, mask_d, graph=False, **tables)
    assert db.GRAPH_CAPTURES == captures + 1
    assert db.GRAPH_REPLAYS == replays + 2
    assert len(first) == len(want)
    for g, g2, e, w in zip(first, second, eager, want):
        assert g.is_cuda and g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, g2) and torch.equal(g, e)
        g = g.cpu()
        if w.is_floating_point():
            assert torch.equal(torch.isfinite(g), torch.isfinite(w))
            fin = torch.isfinite(w)
            assert torch.equal(g[~fin], w[~fin])
            assert (g[fin] - w[fin]).abs().max().item() <= 1e-5
        else:
            assert torch.equal(g, w)


def test_device_beam_graph_per_shape_and_new_inputs(dev):
    """A second shape captures its own graph; new inputs of a captured
    shape replay it and give the eager result."""
    from vistaocr_tpu_torch.decode import device_beam as db

    prog, tables = _beam_program(dict(_beam_variants())["char_lm3"], dev)
    for seed, (B, T) in enumerate([(6, 40), (3, 17), (6, 40)]):
        lp, mask = _beam_posteriors(seed, B=B, T=T)
        lp_d = torch.from_numpy(lp).to(dev)
        mask_d = torch.from_numpy(mask).to(dev)
        got = prog(lp_d, mask_d, **tables)
        want = prog(lp_d, mask_d, graph=False, **tables)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert len(prog._graphs) == 2


def test_device_beam_captures_while_another_thread_copies(dev):
    """Captures run while another thread pins host memory, copies it to
    the card and waits on its event, as ``infer``'s batch producer and the
    service's host copies do: every shape captures, and its graph gives
    the eager result."""
    import threading

    from vistaocr_tpu_torch.decode import device_beam as db

    prog, tables = _beam_program(dict(_beam_variants())["char_lm3"], dev)
    stop, errors = threading.Event(), []

    def churn():
        try:
            rng = np.random.default_rng(0)
            while not stop.is_set():
                a = torch.from_numpy(rng.integers(
                    0, 256, int(rng.integers(1 << 10, 1 << 20)), np.uint8))
                d = a.pin_memory().to(dev, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                event.synchronize()
                del d
        except BaseException as e:
            errors.append(e)

    thread = threading.Thread(target=churn, daemon=True)
    thread.start()
    try:
        captures = db.GRAPH_CAPTURES
        for seed, T in enumerate(range(20, 44, 3)):
            lp, mask = _beam_posteriors(seed, B=5, T=T)
            lp_d = torch.from_numpy(lp).to(dev)
            mask_d = torch.from_numpy(mask).to(dev)
            got = prog(lp_d, mask_d, **tables)
            want = prog(lp_d, mask_d, graph=False, **tables)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert db.GRAPH_CAPTURES == captures + 8
    finally:
        stop.set()
        thread.join()
    assert not errors, errors


def test_device_beam_graph_serves_other_tables_of_its_shapes(dev):
    """Tables of the same shapes but other values (another LM) reuse the
    graph: the program copies them into its own tables before the
    replay, so each call gives that call's eager result."""
    from vistaocr_tpu_torch.decode import device_beam as db

    variants = dict(_beam_variants())
    prog, tables = _beam_program(variants["char_lm3"], dev)
    other = {k: (v.flip(-1).contiguous() if v.is_floating_point() else v)
             for k, v in tables.items()}
    lp, mask = _beam_posteriors(7)
    lp_d, mask_d = torch.from_numpy(lp).to(dev), torch.from_numpy(mask).to(dev)
    captures = db.GRAPH_CAPTURES
    for kw in (tables, other, tables, other):
        got = prog(lp_d, mask_d, **kw)
        want = prog(lp_d, mask_d, graph=False, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert db.GRAPH_CAPTURES == captures + 1
    table = tables["lm_table"]
    table.mul_(0.5)  # written in place: copied in again
    got = prog(lp_d, mask_d, **tables)
    want = prog(lp_d, mask_d, graph=False, **tables)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_device_beam_capture_failure_raises(dev, monkeypatch):
    """A search that fails while its graph is captured raises from the
    program; nothing runs eagerly in its place, no graph is kept, and the
    card captures a sound search afterwards."""
    from vistaocr_tpu_torch.decode import device_beam as db

    lp, mask = _beam_posteriors(1)
    lp_d, mask_d = torch.from_numpy(lp).to(dev), torch.from_numpy(mask).to(dev)
    real = db._backtrace

    def failing_backtrace(parents, tokens):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("not capturable")
        return real(parents, tokens)

    monkeypatch.setattr(db, "_backtrace", failing_backtrace)
    prog, tables = _beam_program({}, dev)
    replays = db.GRAPH_REPLAYS
    with pytest.raises(RuntimeError, match="not capturable"):
        prog(lp_d, mask_d, **tables)
    assert db.GRAPH_REPLAYS == replays and not prog._graphs
    monkeypatch.setattr(db, "_backtrace", real)
    prog, tables = _beam_program({}, dev)
    got = prog(lp_d, mask_d, **tables)
    want = prog(lp_d, mask_d, graph=False, **tables)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_device_beam_tables_on_another_device_raise(dev):
    prog, tables = _beam_program(dict(_beam_variants())["lexicon"], "cpu")
    lp, mask = _beam_posteriors(2)
    with pytest.raises(ValueError, match="table"):
        prog(torch.from_numpy(lp).to(dev), torch.from_numpy(mask).to(dev),
             **tables)


def test_device_deskew_on_cuda_matches_cpu(dev):
    from vistaocr_tpu_torch.ops.deskew import device_deskew

    rng = np.random.default_rng(3)
    H, W = 32, 200
    images = np.full((5, H, W), 255, np.uint8)
    widths = np.array([200, 180, 150, 90, 200], np.int32)
    for b, deg in enumerate((-3.0, -1.0, 0.0, 2.0, 4.0)):
        for x in range(8, widths[b] - 8, 5):
            y = int(16 + (x - widths[b] / 2) * np.tan(np.radians(deg)))
            images[b, max(y - 4, 0): y + 4, x: x + 3] = rng.integers(0, 60)
    out_c, tan_c = device_deskew(torch.from_numpy(images),
                                 torch.from_numpy(widths))
    out_d, tan_d = device_deskew(torch.from_numpy(images).to(dev),
                                 torch.from_numpy(widths).to(dev))
    assert (tan_d.cpu() - tan_c).abs().max().item() <= 1e-5
    diff = (out_d.cpu().int() - out_c.int()).abs().max().item()
    assert diff <= 1
    assert (tan_c != 0).sum().item() >= 3


def test_service_device_beam_on_cuda_matches_cpu(dev):
    """OcrService with the device beam (the default beam_impl) and
    device deskew on the card: the warm-up captures a graph per shape,
    each batch replays one, and the texts equal the CPU service's."""
    from vistaocr_tpu_torch.decode import device_beam as db
    from vistaocr_tpu_torch.serve import OcrService, ServiceConfig

    rng = np.random.default_rng(4)
    lines = [rng.integers(0, 256, (32, int(w)), np.uint8)
             for w in rng.integers(20, 250, 9)]
    lines.append(rng.integers(0, 256, (48, 150), np.uint8))
    cfg = dict(decoder="beam", max_batch=8, device_deskew=True)
    with tempfile.TemporaryDirectory() as d:
        _tiny_snapshot(d)
        out = {}
        for device in ("cpu", "cuda"):
            captures = db.GRAPH_CAPTURES
            svc = OcrService(d, ServiceConfig(**cfg), device=device)
            try:
                replays = db.GRAPH_REPLAYS
                out[device] = svc.ocr_lines(lines)
                if device == "cuda":
                    assert db.GRAPH_CAPTURES == captures + 2  # 2 buckets
                    assert db.GRAPH_REPLAYS > replays
                else:
                    assert db.GRAPH_CAPTURES == captures
            finally:
                svc.close()
    assert [r.text for r in out["cuda"]] == [r.text for r in out["cpu"]]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert abs(a.confidence - b.confidence) <= 1e-3


# --- training kernels: save_cell forward, BPTT, dwh, CTC alpha/beta --------

_BF16_REL = 2e-2  # bf16 streams: one stream ulp is 2^-8 relative


def _rel_err(a, b):
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-6)).item()


def _bf16_flips(a, b, slack=2e-6):
    """(largest (|a - b| - slack) in bf16 ulps of the larger magnitude,
    share of the elements that differ at all): roundings to bf16 of two
    f32 values at most ``slack`` apart differ by at most ``slack`` plus one
    ulp (near a cancelling sum's zero that is many ulps), and rarely."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    d = (a - b).abs()
    return (((d - slack).clamp(min=0) / ulp).max().item(),
            (d > 0).float().mean().item())


@pytest.mark.parametrize(
    "shape,stream,compute,tol",
    _typed([(5, 7, 40), (33, 20, 64), (1, 1, 1), (70, 1, 100), (3, 9, 17)])
    + PERSISTENT_CASES)
def test_save_cell_matches_plain_and_inference(dev, shape, stream, compute,
                                               tol):
    B, T, H = shape
    (xw, xw2), mask, (wh, wh2) = _device_operands(
        dev, B, T, H, stream, compute, seed=B + T + H, ndir=2)
    before = (lstm_cuda.LAUNCHES, lstm_cuda.SAVE_CELL_LAUNCHES)
    with torch.no_grad():
        (ys_f, cs_f), (ys_b, cs_b) = lstm_cuda.lstm_forward_cells(
            [(xw, wh, False), (xw2, wh2, True)], mask, compute)
        inf_f, inf_b = lstm_cuda.blstm_recurrence(xw, xw2, mask, wh, wh2)
        ref = [lstm_cuda.lstm_recurrence_ref(x, mask, w, reverse=r,
                                             save_cell=True)
               for x, w, r in ((xw, wh, False), (xw2, wh2, True))]
    torch.cuda.synchronize()
    assert lstm_cuda.SAVE_CELL_LAUNCHES == before[1] + 1
    assert lstm_cuda.LAUNCHES == before[0] + 2
    assert torch.equal(ys_f, inf_f) and torch.equal(ys_b, inf_b)
    for (ys, cs), (rys, rcs) in zip(((ys_f, cs_f), (ys_b, cs_b)), ref):
        assert cs.dtype == stream and cs.shape == (T, B, H)
        assert (ys.float() - rys.float()).abs().max().item() <= tol
        assert (cs.float() - rcs.float()).abs().max().item() <= tol


def _bptt_operands(dev, B, T, H, dtype, seed):
    xw, mask, wh = _operands(dev, B, T, H, dtype, seed)
    with torch.no_grad():
        ys, cs = lstm_cuda.lstm_recurrence_ref(xw, mask, wh, save_cell=True)
        ysr, csr = lstm_cuda.lstm_recurrence_ref(xw, mask, wh, reverse=True,
                                                 save_cell=True)
    rng = np.random.default_rng(seed + 7)
    dys = torch.from_numpy(rng.normal(0, 1, (2, T, B, H)).astype(np.float32))
    dys = dys.to(dev, dtype)
    return [(xw, wh, ys, cs, dys[0], False), (xw, wh, ysr, csr, dys[1], True)], mask


@pytest.mark.parametrize("shape", [(5, 7, 40), (33, 20, 64), (1, 1, 1),
                                   (70, 1, 100), (3, 9, 17)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bptt_matches_plain(dev, shape, dtype):
    B, T, H = shape
    dirs, mask = _bptt_operands(dev, B, T, H, dtype, seed=B * T + H)
    before = (lstm_cuda.BWD_LAUNCHES, lstm_cuda.DWH_LAUNCHES)
    with torch.no_grad():
        got = lstm_cuda.lstm_bptt(dirs, mask, dtype)
        ref = lstm_cuda.lstm_bptt(dirs, mask, dtype, plain=True)
    torch.cuda.synchronize()
    assert lstm_cuda.BWD_LAUNCHES == before[0] + 1
    assert lstm_cuda.DWH_LAUNCHES == before[1] + 1
    for (dxw, dwh), (rdxw, rdwh) in zip(got, ref):
        assert dxw.dtype == dtype and dwh.dtype == torch.float32
        if dtype == torch.float32:
            # summation order only (tiled products vs torch.matmul, dwh as
            # one sum over (T-1)*B rows vs frame by frame)
            torch.testing.assert_close(dxw, rdxw, atol=2e-4, rtol=1e-3)
            torch.testing.assert_close(dwh, rdwh, atol=2e-4, rtol=1e-3)
        else:
            assert _rel_err(dxw, rdxw) <= _BF16_REL
            assert _rel_err(dwh, rdwh) <= _BF16_REL


_TYPE_PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)]


def _typed_bptt_operands(dev, B, T, H, stream, compute, seed):
    """Both directions' BPTT operands with the streams in ``stream`` and
    the saved states from the plain forward at ``compute``."""
    xw, mask, wh = _operands(dev, B, T, H, torch.float32, seed)
    xw = xw.to(stream)
    rng = np.random.default_rng(seed + 7)
    dirs = []
    for rev in (False, True):
        with torch.no_grad():
            ys, cs = lstm_cuda.lstm_recurrence_ref(
                xw, mask, wh, reverse=rev, dtype=compute, save_cell=True)
        dys = torch.from_numpy(rng.normal(0, 1, (T, B, H)).astype(np.float32))
        dirs.append((xw, wh, ys, cs, dys.to(dev, stream), rev))
    return dirs, mask


def _check_bptt(dev, B, T, H, stream, compute):
    """lstm_bptt against its plain version (bf16 weights above H=512: the
    f32-weight kernels, with the persistent kernels' bound)."""
    dirs, mask = _typed_bptt_operands(dev, B, T, H, stream, compute,
                                      seed=B * T + H)
    before = (lstm_cuda.BWD_LAUNCHES, lstm_cuda.DWH_LAUNCHES)
    with torch.no_grad():
        got = lstm_cuda.lstm_bptt(dirs, mask, compute)
        ref = lstm_cuda.lstm_bptt(dirs, mask, compute, plain=True)
    torch.cuda.synchronize()
    assert lstm_cuda.BWD_LAUNCHES == before[0] + 1
    assert lstm_cuda.DWH_LAUNCHES == before[1] + 1
    for (dxw, dwh), (rdxw, rdwh) in zip(got, ref):
        assert dxw.dtype == stream and dxw.shape == (T, B, 4 * H)
        assert dwh.dtype == torch.float32 and dwh.shape == (H, 4 * H)
        if stream == compute == torch.float32:  # summation order only
            torch.testing.assert_close(dxw, rdxw, atol=2e-4, rtol=1e-3)
            torch.testing.assert_close(dwh, rdwh, atol=2e-4, rtol=1e-3)
        else:
            assert _rel_err(dxw, rdxw) <= _BF16_REL
            assert _rel_err(dwh, rdwh) <= _BF16_REL


@pytest.mark.parametrize("shape", [(5, 7, 40), (33, 20, 64), (1, 1, 1),
                                   (3, 9, 17)])
@pytest.mark.parametrize("stream,compute", _TYPE_PAIRS[2:])
def test_bptt_mixed_types_match_plain(dev, shape, stream, compute):
    """Type codes 2 (f32 streams, bf16 W) and 3 (bf16 streams, f32 W)."""
    _check_bptt(dev, *shape, stream, compute)


# The f32-weight gate GEMM's edges (bptt_gates_gemm's f32 form: 128 x 128
# tiles, 16-column stages, 16-byte rows when H % 4 (f32 ys) or H % 8 (bf16
# ys) is 0): (T-1)*B at and across 128, 4H across an N tile (H = 33, 65),
# T = 1 and 2, and H = 520 and 1000, which only f32 weights take
F32_GEMM_SHAPES = [(129, 2, 65), (8, 17, 64), (5, 7, 33), (6, 3, 65),
                   (7, 1, 40), (9, 2, 24), (4, 3, 520), (3, 2, 1000)]
# bptt_frame's clusters: 64 dh units and 32 rows each, CTA r contracting
# over an eighth of the units in chunks of 64; several clusters a
# direction, so that the carries' ping-pong crosses clusters (B=70, H=200:
# 4 x 3 clusters), and a row invalid throughout (row 3); bptt_dh's
# clusters of 64 units and 32 rows the same
F32_FRAME_SHAPES = [(70, 5, 200), (33, 4, 1000)]

# the edges of the tiles: the f32 frame loop's 64 units x 32 batch rows
# (bptt_frame at B <= 32, its eighths of H and 64-unit chunks; bptt_cell
# and bptt_dh beyond), bptt_gates_gemm's and
# lstm_dwh's 128 x 128 tiles, stages and 16-byte rows (H % 8),
# lstm_bwd_persistent's 32-unit CTAs and 32-row clusters (bf16 W; H > 512
# takes the f32-weight kernels there), and T = 1 (no dwh rows) and 2 (one
# frame's rows)
@pytest.mark.parametrize("shape", [(8, 2, 64), (9, 2, 65), (128, 3, 64),
                                   (129, 2, 65), (8, 1, 520), (9, 3, 520),
                                   *F32_GEMM_SHAPES, *F32_FRAME_SHAPES])
@pytest.mark.parametrize("stream,compute", _TYPE_PAIRS)
def test_bptt_tile_edges_match_plain(dev, shape, stream, compute):
    _check_bptt(dev, *shape, stream, compute)


@pytest.mark.parametrize("stream,compute", _TYPE_PAIRS)
def test_bptt_and_dwh_are_deterministic(dev, stream, compute):
    """Fixed summation orders, no float atomics: two runs, the same bits,
    also with several frame-loop clusters a direction and H > 512 (f32
    weights, both frame-loop designs; bf16 weights, the library's)."""
    f32 = compute == torch.float32
    for B, T, H in [(33, 9, 72), (129, 2, 65), *F32_FRAME_SHAPES]:
        dirs, mask = _typed_bptt_operands(dev, B, T, H, stream, compute,
                                          seed=2)
        kdirs = [(x, w.to(compute).contiguous(), y, c, dy, r)
                 for x, w, y, c, dy, r in dirs]
        for fold in ((True, False) if f32 else (None,)):
            with torch.no_grad():
                runs = [lstm_cuda.lstm_bptt_frames(kdirs, mask, compute,
                                                   loop=_LOOPS[fold])
                        for _ in range(2)]
                dwhs = [lstm_cuda.lstm_dwh([(d[2], g, d[5]) for d, g
                                            in zip(dirs, runs[0])], compute)
                        for _ in range(2)]
            for a, b in zip(*runs):
                assert torch.equal(a, b)
            for a, b in zip(*dwhs):
                assert torch.equal(a, b)


def _masked_row_operands(dev, B, T, H, stream, compute, seed):
    """As _typed_bptt_operands, with row 3 invalid throughout (B > 3)
    and the saved states recomputed under that mask."""
    dirs, mask = _typed_bptt_operands(dev, B, T, H, stream, compute, seed)
    if B > 3:
        mask = mask.clone()
        mask[:, 0, 3] = 0.0
        dirs = [(x, w, *lstm_cuda.lstm_recurrence_ref(
                    x, mask, w, reverse=r, dtype=compute, save_cell=True),
                 dy, r) for x, w, _, _, dy, r in dirs]
    return dirs, mask


# the f32-weight frame loop a test's ``fold`` names: the fold, the split,
# or (None) the library's
_LOOPS = {True: "fold", False: "split", None: None}

_F32_COUNTERS = ("GATES_GEMM_LAUNCHES", "FRAME_LAUNCHES", "CELL_LAUNCHES",
                 "DH_LAUNCHES", "BWD_PERSISTENT_LAUNCHES")
_WIDE_COUNTERS = ("GATES_WIDE_LAUNCHES", "DWH_LAUNCHES")
_TC_COUNTERS = ("BWD_TC_LAUNCHES",)


@pytest.mark.parametrize("shape", F32_GEMM_SHAPES + F32_FRAME_SHAPES)
@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fold", [True, False])
def test_f32_weight_gates_gemm_and_frames_match_plain(dev, shape, stream,
                                                      fold):
    """Type codes 0 and 3: the f32 gate GEMM against bptt_gates_ref
    within 1e-5 of the largest magnitude (the same f32 products, summed in
    another order), and the frame loop of either design (bptt_frame, or
    bptt_cell + bptt_dh), on the kernel's own gates, against
    bptt_frames_ref (f32 sums in another order; a bf16 dxw element may
    round one ulp apart); an invalid row's gradients are zeros."""
    B, T, H = shape
    dirs, mask = _masked_row_operands(dev, B, T, H, stream, torch.float32,
                                      seed=B + T * H)
    before = [getattr(lstm_cuda, n) for n in _F32_COUNTERS]
    with torch.no_grad():
        dxw, pre = lstm_cuda.lstm_bptt_frames(dirs, mask, torch.float32,
                                              return_gates=True,
                                              loop=_LOOPS[fold])
        for (x, w, ys, cs, dy, r), g, p in zip(dirs, dxw, pre):
            assert p.shape == (T, B, 4 * H) and p.dtype == torch.float32
            ref = lstm_cuda.bptt_gates_ref(x, ys, w, reverse=r,
                                           dtype=torch.float32)
            assert _rel_err(p, ref) <= 1e-5
            loop = lstm_cuda.bptt_frames_ref(p, mask, w, cs, dy, reverse=r,
                                             dtype=torch.float32)
            assert g.dtype == stream
            if stream == torch.float32:
                torch.testing.assert_close(g, loop, atol=2e-4, rtol=1e-3)
            else:
                assert _rel_err(g, loop) <= _BF16_REL
            if B > 3:
                assert not g[:, 3].float().abs().max().item()
    torch.cuda.synchronize()
    frames = (T, 0, 0) if fold else (0, T, T)
    assert [getattr(lstm_cuda, n) - b for n, b in zip(
        _F32_COUNTERS, before)] == [1, *frames, 0]


# The bf16-weight BPTT (type codes 1 and 2: bptt_gates_gemm, then one
# lstm_bwd_persistent launch) at ragged shapes: H not a multiple of 32 or 8
# and H < 64 (one or two CTAs a cluster), B > 32 (several clusters), B=512
# (16 clusters a direction, in waves), T = 1 (no product), and a row that
# is invalid throughout (row 3; row 0 is full). The library takes 32, 16
# or 8 batch rows a cluster by B (lstm_cuda.persistent_plan); at H=512, two
# directions, on an H100 its choice changes between B = 24 and 25, 48 and
# 49, 56 and 57, 96 and 97: each pair is here, and every row count the
# rule takes (test_bf16_bptt_shapes_run_every_row_count).
BF16_BPTT_SHAPES = [(5, 7, 17), (6, 9, 40), (33, 5, 100), (70, 4, 72),
                    (129, 3, 512), (512, 3, 40), (512, 2, 512), (4, 1, 512),
                    (40, 1, 36), (32, 64, 512), (24, 3, 512), (25, 2, 512),
                    (48, 2, 512), (49, 3, 512), (56, 1, 512), (57, 3, 512),
                    (96, 2, 512), (97, 1, 512), (9, 1, 60), (17, 4, 48)]


def _bf16_bptt_operands(dev, B, T, H, stream, seed):
    return _masked_row_operands(dev, B, T, H, stream, torch.bfloat16, seed)


@pytest.mark.parametrize("shape", BF16_BPTT_SHAPES)
@pytest.mark.parametrize("stream", [torch.bfloat16, torch.float32])
def test_bf16_weight_bptt_matches_plain(dev, shape, stream):
    B, T, H = shape
    dirs, mask = _bf16_bptt_operands(dev, B, T, H, stream, seed=B + T * H)
    before = (lstm_cuda.BWD_LAUNCHES, lstm_cuda.GATES_GEMM_LAUNCHES,
              lstm_cuda.BWD_PERSISTENT_LAUNCHES)
    with torch.no_grad():
        got = lstm_cuda.lstm_bptt(dirs, mask, torch.bfloat16)
        ref = lstm_cuda.lstm_bptt(dirs, mask, torch.bfloat16, plain=True)
    torch.cuda.synchronize()
    assert (lstm_cuda.BWD_LAUNCHES, lstm_cuda.GATES_GEMM_LAUNCHES,
            lstm_cuda.BWD_PERSISTENT_LAUNCHES) == tuple(b + 1 for b in before)
    for (dxw, dwh), (rdxw, rdwh) in zip(got, ref):
        assert dxw.dtype == stream and dxw.shape == (T, B, 4 * H)
        assert _rel_err(dxw, rdxw) <= _BF16_REL
        assert _rel_err(dwh, rdwh) <= _BF16_REL
        if B > 3:  # the invalid row's gradients are zeros
            assert not dxw[:, 3].float().abs().max().item()


def test_bf16_weight_bptt_is_deterministic(dev):
    """One owner per dh element, partials summed in rank order: two runs,
    the same bits, in both type codes and with several clusters."""
    for stream in (torch.bfloat16, torch.float32):
        dirs, mask = _bf16_bptt_operands(dev, 129, 20, 512, stream, seed=3)
        kdirs = [(x, w.to(torch.bfloat16).contiguous(), y, c, dy, r)
                 for x, w, y, c, dy, r in dirs]
        with torch.no_grad():
            runs = [lstm_cuda.lstm_bptt_frames(kdirs, mask, torch.bfloat16)
                    for _ in range(2)]
        for a, b in zip(*runs):
            assert torch.equal(a, b)


@pytest.mark.parametrize("B", [20, 32, 96])
def test_bf16_weight_bptt_is_deterministic_at_each_row_count(dev, B):
    """lstm_bwd_persistent at 8, 16 and 32 batch rows a cluster (the
    library's choice at B = 20, 32 and 96, H=512): two runs, the same bits,
    in both type codes."""
    for stream in (torch.bfloat16, torch.float32):
        dirs, mask = _bf16_bptt_operands(dev, B, 12, 512, stream, seed=B)
        kdirs = [(x, w.to(torch.bfloat16).contiguous(), y, c, dy, r)
                 for x, w, y, c, dy, r in dirs]
        with torch.no_grad():
            runs = [lstm_cuda.lstm_bptt_frames(kdirs, mask, torch.bfloat16)
                    for _ in range(2)]
        for a, b in zip(*runs):
            assert torch.equal(a, b)
    assert {20: 8, 32: 16, 96: 32}[B] == lstm_cuda.persistent_plan(
        B, 512)["rows"]


def test_bf16_bptt_shapes_run_every_row_count(dev):
    """Every row count the library takes for lstm_bwd_persistent at the
    flagship's H=512 (B from 1 to 1024, one or two directions) is the
    choice at one of BF16_BPTT_SHAPES at least."""
    chosen = {lstm_cuda.persistent_plan(B, 512, ndir)["rows"]
              for B in range(1, 1025) for ndir in (1, 2)}
    tested = {lstm_cuda.persistent_plan(B, H)["rows"]
              for B, _, H in BF16_BPTT_SHAPES if H <= 512}
    assert chosen <= tested, (chosen, tested)
    assert chosen == {8, 16, 32}


# the library's rows a cluster at the flagship's train buckets (B, T) at
# H=512, as PERF.md records them (an H100 holds 7 clusters of 16 CTAs)
PERSISTENT_ROWS = {(32, 512): 16, (64, 256): 32, (128, 128): 16,
                   (512, 32): 32}


@pytest.mark.parametrize("bucket", sorted(PERSISTENT_ROWS))
def test_bf16_bptt_rows_at_each_train_bucket(dev, bucket):
    B, _ = bucket
    plan = lstm_cuda.persistent_plan(B, 512)
    assert plan["rows"] == PERSISTENT_ROWS[bucket], plan
    assert plan["clusters"] == 2 * -(-B // plan["rows"])
    assert plan["waves"] == -(-plan["clusters"] // plan["resident"])


def _profiled_counts(call, names):
    """Launches of each kernel name in a torch.profiler window over one
    call; the window opens with small launches, a synchronise and a 20 ms
    pause, and closes after a synchronise and another pause (the profiler
    drops device events near its edges: a lone launch that ends just
    before the closing synchronise returns was missed)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    call()  # built and warm
    torch.cuda.synchronize()
    pad = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            pad.add_(1.0)
        torch.cuda.synchronize()
        time.sleep(0.02)
        call()
        torch.cuda.synchronize()
        time.sleep(0.02)
    return {n: sum(n in e.name for e in prof.events()) for n in names}


_BPTT_KERNELS = ("bptt_gates_gemm<", "lstm_bwd_persistent<", "bptt_gates<",
                 "bptt_frame<", "bptt_cell<", "bptt_dh<", "lstm_bwd_rows<",
                 "lstm_dwh")


def test_bf16_weight_bptt_launches_two_kernels_per_layer_call(dev):
    """B=32, T=512, H=512 (the W=2048 bucket), both directions: one
    lstm_bptt call makes one bptt_gates_gemm_wide (the library's gate GEMM
    for bf16 weights), one lstm_bwd_persistent and one dwh launch (the
    128 x 128 lstm_dwh_tc at this H), and no per-frame kernel."""
    dirs, mask = _bf16_bptt_operands(dev, 32, 512, 512, torch.bfloat16,
                                     seed=9)
    with torch.no_grad():
        counts = _profiled_counts(
            lambda: lstm_cuda.lstm_bptt(dirs, mask, torch.bfloat16),
            _BPTT_KERNELS + ("bptt_gates_gemm_wide<",))
    assert counts == {"bptt_gates_gemm<": 0, "lstm_bwd_persistent<": 1,
                      "bptt_gates<": 0, "bptt_frame<": 0, "bptt_cell<": 0,
                      "bptt_dh<": 0, "lstm_bwd_rows<": 0, "lstm_dwh": 1,
                      "bptt_gates_gemm_wide<": 1}, counts
    assert lstm_cuda.DWH_DESIGNS[_build.load().vo_lstm_dwh_design(
        1, 512)] == "tiles"


@pytest.mark.parametrize("B", [32, 33, 128])
def test_f32_weight_bptt_launches_one_gemm_and_a_kernel_a_frame(dev, B):
    """f32 weights, both directions, T=24: one lstm_bptt call makes one
    bptt_gates_gemm (f32 form), then up to B=32 T bptt_frame launches (the
    cell backward and the dh product of a frame), beyond one lstm_bwd_rows
    launch for all frames (no bptt_cell or bptt_dh), and one dwh launch;
    no per-frame bptt_gates."""
    T = 24
    dirs, mask = _typed_bptt_operands(dev, B, T, 64, torch.float32,
                                      torch.float32, seed=10)
    with torch.no_grad():
        counts = _profiled_counts(
            lambda: lstm_cuda.lstm_bptt(dirs, mask, torch.float32),
            _BPTT_KERNELS)
    frames = (T, 0) if B <= 32 else (0, 1)
    assert counts == {"bptt_gates_gemm<": 1, "lstm_bwd_persistent<": 0,
                      "bptt_gates<": 0, "bptt_frame<": frames[0],
                      "bptt_cell<": 0, "bptt_dh<": 0,
                      "lstm_bwd_rows<": frames[1], "lstm_dwh": 1}, counts


# The f32-weight cooperative frame loop (lstm_bwd_rows: CTAs over 16-unit
# slices x row groups, tiles of 32 rows, or 64 where every row group gets
# one): B across the tiles and row groups, H = 40 and 520, T = 1 (no
# product) and 7, row 3 invalid throughout, on the kernel's own gates
# against bptt_frames_ref within the split loop's bounds; one direction at
# F32_ROWS_ONE_DIR (H=1000 does not fit: test_f32_rows_loop_limits)
F32_LOOP_ROWS_SHAPES = [(B, T, H) for B in (33, 129, 321, 385, 511, 513)
                        for H in (40, 520) for T in (1, 7)]


@pytest.mark.parametrize("shape", F32_LOOP_ROWS_SHAPES + F32_ROWS_ONE_DIR)
@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16])
def test_f32_rows_loop_matches_plain(dev, shape, stream):
    """Type codes 0 and 3: lstm_bwd_rows on the f32 gate GEMM's gates
    against bptt_frames_ref (f32 sums in another order; a bf16 dxw element
    may round one ulp apart), the invalid row's gradients zeros, a second
    run the same bits, one launch a layer call."""
    B, T, H = shape
    dirs, mask = _masked_row_operands(dev, B, T, H, stream, torch.float32,
                                      seed=B + T * H)
    if shape in F32_ROWS_ONE_DIR:
        dirs = dirs[:1]
    before = [getattr(lstm_cuda, n) for n in _F32_COUNTERS + (
        "BWD_ROWS_LAUNCHES",)]
    with torch.no_grad():
        dxw, pre = lstm_cuda.lstm_bptt_frames(dirs, mask, torch.float32,
                                              return_gates=True, loop="rows")
        again = lstm_cuda.lstm_bptt_frames(dirs, mask, torch.float32,
                                           loop="rows")
        for (x, w, ys, cs, dy, r), g, p, g2 in zip(dirs, dxw, pre, again):
            loop = lstm_cuda.bptt_frames_ref(p, mask, w, cs, dy, reverse=r,
                                             dtype=torch.float32)
            assert g.dtype == stream and g.shape == (T, B, 4 * H)
            if stream == torch.float32:
                torch.testing.assert_close(g, loop, atol=2e-4, rtol=1e-3)
            else:
                assert _rel_err(g, loop) <= _BF16_REL
            assert not g[:, 3].float().abs().max().item()
            assert torch.equal(g, g2)
    torch.cuda.synchronize()
    assert [getattr(lstm_cuda, n) - b for n, b in zip(
        _F32_COUNTERS + ("BWD_ROWS_LAUNCHES",), before)] == [2, 0, 0, 0, 0, 2]


@pytest.mark.parametrize("ndir", [1, 2])
def test_f32_rows_loop_limits(dev, ndir):
    """At H=1000 a CTA's 16 f32 rows of wh do not fit in shared memory:
    naming lstm_bwd_rows raises (no fallback), the launch counter stays,
    and the library runs the split loop beyond B=32 there."""
    dirs, mask = _typed_bptt_operands(dev, 5, 2, 1000, torch.float32,
                                      torch.float32, seed=4)
    dirs = dirs[:ndir]
    before = lstm_cuda.BWD_ROWS_LAUNCHES
    with torch.no_grad(), pytest.raises(RuntimeError,
                                        match="vo_lstm_bwd_named"):
        lstm_cuda.lstm_bptt_frames(dirs, mask, torch.float32, loop="rows")
    assert lstm_cuda.BWD_ROWS_LAUNCHES == before
    assert lstm_cuda.loop_design(torch.float32, 128, 1000, ndir) == "split"


@pytest.mark.parametrize("B,H,ndir,loop", [
    (32, 512, 2, "fold"), (33, 512, 2, "rows"), (64, 64, 2, "rows"),
    (512, 384, 2, "rows"), (128, 528, 2, "rows"), (128, 576, 2, "split"),
    (512, 688, 2, "split"), (128, 512, 1, "split")])
def test_f32_loop_rule_stays_where_it_was_timed(dev, B, H, ndir, loop):
    """The library's f32-weight frame loop (loop_design): the fold up to
    B=32, lstm_bwd_rows beyond it for two directions while the card holds
    two row groups (H <= 528 on 132 SMs, as timed on an H100), the split
    above (where it fits but loses) and for one direction (not timed)."""
    assert lstm_cuda.loop_design(torch.float32, B, H, ndir) == loop


@pytest.mark.parametrize("B,T", [(64, 256), (128, 128), (512, 32)])
def test_f32_rows_loop_is_deterministic_at_the_train_buckets(dev, B, T):
    """The f32 train buckets' shapes at H=512, both directions: the
    library's lstm_bwd_rows twice, the same bits, within the split loop's
    bounds of it."""
    dirs, mask = _typed_bptt_operands(dev, B, T, 512, torch.float32,
                                      torch.float32, seed=B)
    with torch.no_grad():
        a = lstm_cuda.lstm_bptt_frames(dirs, mask, torch.float32)
        b = lstm_cuda.lstm_bptt_frames(dirs, mask, torch.float32)
        split = lstm_cuda.lstm_bptt_frames(dirs, mask, torch.float32,
                                           loop="split")
    assert lstm_cuda.loop_design(torch.float32, B, 512) == "rows"
    for x, y, z in zip(a, b, split):
        assert torch.equal(x, y)
        torch.testing.assert_close(x, z, atol=2e-4, rtol=1e-3)


def test_bf16_weight_bptt_refuses_h_above_512(dev):
    """Above H=512 lstm_bwd_persistent is not launched: bf16 weights take
    the wide gate GEMM and lstm_bwd_tc (B=4: one launch of each), against
    bptt_frames_ref within the persistent kernel's bound."""
    T = 3
    dirs, mask = _typed_bptt_operands(dev, 4, T, 520, torch.bfloat16,
                                      torch.bfloat16, seed=1)
    kdirs = [(x, w.to(torch.bfloat16).contiguous(), y, c, dy, r)
             for x, w, y, c, dy, r in dirs]
    before = [getattr(lstm_cuda, n) for n in _F32_COUNTERS + _TC_COUNTERS]
    with torch.no_grad():
        got = lstm_cuda.lstm_bptt_frames(kdirs, mask, torch.bfloat16)
        ref = lstm_cuda.lstm_bptt(dirs, mask, torch.bfloat16, plain=True)
    torch.cuda.synchronize()
    assert [getattr(lstm_cuda, n) - b for n, b in zip(
        _F32_COUNTERS + _TC_COUNTERS, before)] == [1, 0, 0, 0, 0, 1]
    for dxw, (rdxw, _) in zip(got, ref):
        assert _rel_err(dxw, rdxw) <= _BF16_REL


@pytest.mark.parametrize("shape", F2_SHAPES)
@pytest.mark.parametrize("stream", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fold", [True, False, None])
def test_bf16_weights_above_512_bptt_matches_plain(dev, shape, stream, fold):
    """Type codes 1 and 2 above H=512: the wide gate GEMM against
    bptt_gates_ref within 1e-5 of the largest magnitude (the same
    bf16-rounded products in f32), the f32-weight frame loop of each design
    and the library's (lstm_bwd_tc) on the kernel's own gates against
    bptt_frames_ref, the wide dwh against lstm_dwh_ref, within the
    persistent kernels' bound; an invalid row's gradients are zeros; two
    runs give the same bits; one wide gate GEMM and T bptt_frame, or T
    bptt_cell and T bptt_dh, or one lstm_bwd_tc launch a call, and one dwh
    (the library's wide tiles)."""
    B, T, H = shape
    dirs, mask = _masked_row_operands(dev, B, T, H, stream, torch.bfloat16,
                                      seed=B + T * H)
    kdirs = [(x, w.to(torch.bfloat16).contiguous(), y, c, dy, r)
             for x, w, y, c, dy, r in dirs]
    counters = _F32_COUNTERS + _WIDE_COUNTERS + _TC_COUNTERS
    before = [getattr(lstm_cuda, n) for n in counters]
    with torch.no_grad():
        (dxw, pre), (dxw2, pre2) = (lstm_cuda.lstm_bptt_frames(
            kdirs, mask, torch.bfloat16, return_gates=True,
            loop=_LOOPS[fold])
            for _ in range(2))
        dwh = [lstm_cuda.lstm_dwh([(d[2], g, d[5]) for d, g in zip(dirs, dxw)],
                                  torch.bfloat16) for _ in range(2)]
        for k, (x, w, ys, cs, dy, r) in enumerate(dirs):
            ref = lstm_cuda.bptt_gates_ref(x, ys, w, reverse=r,
                                           dtype=torch.bfloat16)
            assert _rel_err(pre[k], ref) <= 1e-5
            loop = lstm_cuda.bptt_frames_ref(pre[k], mask, w, cs, dy,
                                             reverse=r, dtype=torch.bfloat16)
            assert dxw[k].dtype == stream
            assert _rel_err(dxw[k], loop) <= _BF16_REL
            rdwh = lstm_cuda.lstm_dwh_ref(ys, dxw[k], reverse=r,
                                          dtype=torch.bfloat16)
            assert _rel_err(dwh[0][k], rdwh) <= 1e-5
            assert torch.equal(dxw[k], dxw2[k]) and torch.equal(pre[k], pre2[k])
            assert torch.equal(dwh[0][k], dwh[1][k])
            if B > 3:
                assert not dxw[k][:, 3].float().abs().max().item()
    torch.cuda.synchronize()
    assert lstm_cuda.loop_design(torch.bfloat16, B, H) == "tc"
    frames = {True: (T, 0, 0), False: (0, T, T), None: (0, 0, 0)}[fold]
    assert [getattr(lstm_cuda, n) - b for n, b in zip(counters, before)] == [
        2, *(2 * f for f in frames), 0, 2, 2, 2 if fold is None else 0]


@pytest.mark.parametrize("H", [520, 1000])
def test_bf16_weights_above_512_launch_the_f32_kernels(dev, H):
    """B=32, T=24, bf16 streams and weights, both directions: a forward
    call is one lstm_fwd_tc launch (no f32-weight forward), a BPTT call one
    bptt_gates_gemm_wide, one lstm_bwd_tc and one dwh launch (lstm_dwh_tc,
    the library's wide tiles at these H), and no persistent kernel, no
    f32-weight frame loop nor the FMA gate GEMM (profiler)."""
    T = 24
    xw, mask, wh = _device_operands(dev, 32, T, H, torch.bfloat16,
                                    torch.bfloat16, seed=H, ndir=2)
    with torch.no_grad():
        fwd = _profiled_counts(
            lambda: lstm_cuda.blstm_recurrence(xw[0], xw[1], mask, wh[0],
                                               wh[1]),
            ("lstm_fwd_tc<", "lstm_fwd_grid<", "lstm_step<",
             "lstm_fwd_persistent<"))
    assert fwd == {"lstm_fwd_tc<": 1, "lstm_fwd_grid<": 0, "lstm_step<": 0,
                   "lstm_fwd_persistent<": 0}, fwd
    dirs, mask = _bf16_bptt_operands(dev, 32, T, H, torch.bfloat16, seed=H)
    with torch.no_grad():
        counts = _profiled_counts(
            lambda: lstm_cuda.lstm_bptt(dirs, mask, torch.bfloat16),
            _BPTT_KERNELS + ("bptt_gates_gemm_wide<", "lstm_bwd_tc<"))
    assert counts == {"bptt_gates_gemm<": 0, "lstm_bwd_persistent<": 0,
                      "bptt_gates<": 0, "bptt_frame<": 0, "bptt_cell<": 0,
                      "bptt_dh<": 0, "lstm_bwd_rows<": 0, "lstm_dwh": 1,
                      "bptt_gates_gemm_wide<": 1, "lstm_bwd_tc<": 1}, counts
    assert lstm_cuda.DWH_DESIGNS[_build.load().vo_lstm_dwh_design(
        1, H)] == "wide"


def test_bf16_weights_above_512_autograd_matches_plain(dev):
    """BLstmRecurrence at H=520 with bf16 weights (the model's route
    through lstm_impl="auto"): the forward on lstm_fwd_tc and the
    backward on the wide gate GEMM and lstm_bwd_tc against the plain
    forward and BPTT."""
    B, T, H = 6, 5, 520
    dirs, mask = _bptt_operands(dev, B, T, H, torch.bfloat16, seed=12)
    xw, wh = dirs[0][0], dirs[0][1]
    xf = xw.clone().requires_grad_(True)
    xb = (xw * 0.5).requires_grad_(True)
    wf = wh.clone().requires_grad_(True)
    wb = (wh * 0.7).requires_grad_(True)
    before = (lstm_cuda.FWD_TC_LAUNCHES, lstm_cuda.GATES_WIDE_LAUNCHES,
              lstm_cuda.BWD_PERSISTENT_LAUNCHES, lstm_cuda.DWH_LAUNCHES,
              lstm_cuda.BWD_TC_LAUNCHES)
    ys_f, ys_b = lstm_cuda.blstm_recurrence(xf, xb, mask, wf, wb)
    (ys_f * dirs[0][4] + ys_b * dirs[1][4]).sum().backward()
    assert (lstm_cuda.FWD_TC_LAUNCHES, lstm_cuda.GATES_WIDE_LAUNCHES,
            lstm_cuda.BWD_PERSISTENT_LAUNCHES, lstm_cuda.DWH_LAUNCHES,
            lstm_cuda.BWD_TC_LAUNCHES) == (before[0] + 1, before[1] + 1,
                                           before[2], before[3] + 1,
                                           before[4] + 1)
    with torch.no_grad():
        for x, w, dy, r, g_x, g_w in ((xf, wf, dirs[0][4], False, xf.grad,
                                       wf.grad),
                                      (xb, wb, dirs[1][4], True, xb.grad,
                                       wb.grad)):
            ys, cs = lstm_cuda.lstm_recurrence_ref(x, mask, w, reverse=r,
                                                   save_cell=True)
            rdx, rdw = lstm_cuda.lstm_bptt_ref(x, mask, w, ys, cs, dy,
                                               reverse=r)
            assert g_x.dtype == g_w.dtype == torch.bfloat16
            assert _rel_err(g_x, rdx) <= _BF16_REL
            assert _rel_err(g_w, rdw) <= _BF16_REL


# lstm_bwd_tc (bf16 weights above H=512: one cooperative launch, each CTA's
# 16 units of wh in registers, the dgates exchanged through L2) at H 520
# (33 CTAs, the last owning 8 units), 1000 and 1056 (the most it takes for
# two directions), B below, across and beyond a 32-row tile, T = 1 (no
# product), 2 and 24, both type codes, one direction (either) and two, row
# 3 invalid throughout
TC_BWD_SHAPES = [(B, T, H) for H in (520, 1000, 1056) for B in (5, 33, 128)
                 for T in (1, 2, 24)]
TC_BWD_DIRS = {"both": (0, 1), "reverse": (1,)}


@pytest.mark.parametrize("shape", TC_BWD_SHAPES)
@pytest.mark.parametrize("stream", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("which", list(TC_BWD_DIRS))
def test_f2_tc_bptt_matches_plain(dev, shape, stream, which):
    """lstm_bwd_tc on the wide gate GEMM's gates against bptt_frames_ref
    within the persistent kernels' bound (the dh products summed in
    another order, the dxw elements rounding a bf16 ulp apart); the invalid
    row's dxw all zeros; two runs the same bits; one launch a call."""
    B, T, H = shape
    dirs, mask = _masked_row_operands(dev, B, T, H, stream, torch.bfloat16,
                                      seed=B + T * H)
    kdirs = [(x, w.to(torch.bfloat16).contiguous(), y, c, dy, r)
             for k, (x, w, y, c, dy, r) in enumerate(dirs)
             if k in TC_BWD_DIRS[which]]
    before = lstm_cuda.BWD_TC_LAUNCHES
    with torch.no_grad():
        (dxw, pre), (dxw2, _) = (lstm_cuda.lstm_bptt_frames(
            kdirs, mask, torch.bfloat16, return_gates=True, loop="tc")
            for _ in range(2))
        for k, (_, w, _, cs, dy, r) in enumerate(kdirs):
            ref = lstm_cuda.bptt_frames_ref(pre[k], mask, w, cs, dy,
                                            reverse=r, dtype=torch.bfloat16)
            assert dxw[k].dtype == stream and dxw[k].shape == (T, B, 4 * H)
            assert _rel_err(dxw[k], ref) <= _BF16_REL
            assert torch.equal(dxw[k], dxw2[k])
            assert not dxw[k][:, 3].float().abs().max().item()
    torch.cuda.synchronize()
    assert lstm_cuda.BWD_TC_LAUNCHES == before + 2


def test_f2_tc_bptt_one_direction_is_the_both_directions_result(dev):
    """A direction's dxw is the same bits alone as beside the other one
    (each direction's CTAs, counter and exchange are their own)."""
    B, T, H = 33, 5, 1000
    dirs, mask = _masked_row_operands(dev, B, T, H, torch.bfloat16,
                                      torch.bfloat16, seed=4)
    kdirs = [(x, w.to(torch.bfloat16).contiguous(), y, c, dy, r)
             for x, w, y, c, dy, r in dirs]
    with torch.no_grad():
        both = lstm_cuda.lstm_bptt_frames(kdirs, mask, torch.bfloat16,
                                          loop="tc")
        alone = [lstm_cuda.lstm_bptt_frames([d], mask, torch.bfloat16,
                                            loop="tc")[0] for d in kdirs]
    for a, b in zip(both, alone):
        assert torch.equal(a, b)


@pytest.mark.parametrize("stream", [torch.bfloat16, torch.float32])
def test_f2_tc_bptt_is_one_launch_and_deterministic_at_b32_t512(dev, stream):
    """The main path's shape (B=32, T=512, H=1000, both directions): one
    lstm_bwd_tc launch behind one gate GEMM (profiler), no f32-weight
    frame kernel, and two calls the same bits."""
    B, T, H = 32, 512, 1000
    dirs, mask = _masked_row_operands(dev, B, T, H, stream, torch.bfloat16,
                                      seed=5)
    kdirs = [(x, w.to(torch.bfloat16).contiguous(), y, c, dy, r)
             for x, w, y, c, dy, r in dirs]
    with torch.no_grad():
        counts = _profiled_counts(
            lambda: lstm_cuda.lstm_bptt_frames(kdirs, mask, torch.bfloat16),
            ("bptt_gates_gemm_wide<", "lstm_bwd_tc<", "bptt_frame<",
             "bptt_cell<", "bptt_dh<"))
        runs = [lstm_cuda.lstm_bptt_frames(kdirs, mask, torch.bfloat16)
                for _ in range(2)]
    assert counts == {"bptt_gates_gemm_wide<": 1, "lstm_bwd_tc<": 1,
                      "bptt_frame<": 0, "bptt_cell<": 0, "bptt_dh<": 0}, counts
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_f2_tc_bptt_limits(dev):
    """H=1064 is past what lstm_bwd_tc takes for two directions (67 CTAs
    a direction, 34 k16 steps a slice): the library runs the f32-weight
    loop there, and naming the kernel raises; loop="tc" and "persistent"
    refuse f32 weights before any launch."""
    B, T, H = 33, 2, 1064
    assert lstm_cuda.loop_design(torch.bfloat16, B, H) == "split"
    assert lstm_cuda.loop_design(torch.bfloat16, 32, H) == "fold"
    dirs, mask = _masked_row_operands(dev, B, T, H, torch.bfloat16,
                                      torch.bfloat16, seed=6)
    kdirs = [(x, w.to(torch.bfloat16).contiguous(), y, c, dy, r)
             for x, w, y, c, dy, r in dirs]
    before = [getattr(lstm_cuda, n) for n in _F32_COUNTERS + _TC_COUNTERS]
    with torch.no_grad():
        got, pre = lstm_cuda.lstm_bptt_frames(kdirs, mask, torch.bfloat16,
                                              return_gates=True)
        for k, (_, w, _, cs, dy, r) in enumerate(kdirs):
            ref = lstm_cuda.bptt_frames_ref(pre[k], mask, w, cs, dy,
                                            reverse=r, dtype=torch.bfloat16)
            assert _rel_err(got[k], ref) <= _BF16_REL
        torch.cuda.synchronize()
        assert [getattr(lstm_cuda, n) - b for n, b in zip(
            _F32_COUNTERS + _TC_COUNTERS, before)] == [1, 0, T, T, 0, 0]
        with pytest.raises(RuntimeError, match="vo_lstm_bwd_named"):
            lstm_cuda.lstm_bptt_frames(kdirs, mask, torch.bfloat16,
                                       loop="tc")
        fdirs = [(x.float(), w.float(), y.float(), c.float(), dy.float(), r)
                 for x, w, y, c, dy, r in kdirs]
        for name in ("tc", "persistent"):
            with pytest.raises(ValueError, match="bf16 weights only"):
                lstm_cuda.lstm_bptt_frames(fdirs, mask, torch.float32,
                                           loop=name)


def test_dwh_matches_torch_mm_at_flagship(dev):
    """bf16 at B=32, T=512, H=512: the wgmma kernel against one cuBLAS
    bf16 GEMM with f32 output over the same (T-1)*B rows (the same
    products; f32 sums in another order)."""
    B, T, H = 32, 512, 512
    rng = np.random.default_rng(11)
    dirs = []
    for rev in (False, True):
        ys, dxw = (torch.from_numpy(rng.normal(0, 1, shp).astype(np.float32))
                   .to(dev, torch.bfloat16)
                   for shp in ((T, B, H), (T, B, 4 * H)))
        dirs.append((ys, dxw, rev))
    got = lstm_cuda.lstm_dwh(dirs, torch.bfloat16)
    for dwh, (ys, dxw, rev) in zip(got, dirs):
        a = (ys[1:] if rev else ys[:-1]).reshape(-1, H)
        c = (dxw[:-1] if rev else dxw[1:]).reshape(-1, 4 * H)
        ref = torch.mm(a.T, c, out_dtype=torch.float32)
        assert _rel_err(dwh, ref) <= 1e-5


# The wide designs (bf16 weights above H=512; any H when named): the gate
# GEMM's persistent 128 x 256 tiles and dwh's 128 x 256 tiles at H = 520
# and 1000 (TMA) and 516 (H % 8 != 0: the producer's loads), type codes 1
# and 2, one direction (either) and two, T = 1 (edge tiles only: no
# product) and 2, R = T*B not a multiple of 128 and B past a 128-row tile
# (the forward edge frame spans two tiles), persistent grids of 336
# and 672 tiles (B=64, T=40, H=1000: not multiples of 132 SMs), and a
# longer contraction (B=32, T=160: 5088 rows)
WIDE_SHAPES = [(32, 3, 1000), (5, 7, 520), (33, 2, 516), (7, 1, 1000),
               (9, 2, 520), (64, 40, 1000), (130, 4, 520), (32, 160, 1000)]
WIDE_DIRS = {"both": (False, True), "forward": (False,), "reverse": (True,)}


def _wide_operands(dev, B, T, H, stream, seed):
    rng = np.random.default_rng(seed)

    def t_(shape, scale, dtype=stream):
        return torch.from_numpy(rng.normal(0, scale, shape).astype(
            np.float32)).to(dev, dtype)

    return [(t_((T, B, 4 * H), 1.0), t_((H, 4 * H), H ** -0.5,
                                        torch.bfloat16),
             t_((T, B, H), 0.5), t_((T, B, 4 * H), 0.1))
            for _ in range(2)]


def _gates(dev, dirs, B, T, H, stream, gemm=None):
    """The gate GEMM's pre per direction of ``dirs`` (xw, wh, ys,
    reverse), through lstm_bptt_frames (random cell states and dys, every
    row valid) by the library's design or the one ``gemm`` names."""
    rng = np.random.default_rng(B + T + H)
    bdirs = [(x, w, ys, torch.from_numpy(rng.normal(
        0, 1, (T, B, H)).astype(np.float32)).to(dev, stream), torch.zeros(
        T, B, H, device=dev, dtype=stream), r) for x, w, ys, r in dirs]
    mask = torch.ones(T, 1, B, device=dev)
    return lstm_cuda.lstm_bptt_frames(bdirs, mask, torch.bfloat16,
                                      return_gates=True, gemm=gemm)[1]


def _dwh_mm(ys, dxw, rev):
    """One cuBLAS bf16 GEMM with f32 output over the (T-1)*B rows at a
    one-frame offset: dwh's function on the same bf16 operands."""
    H = ys.shape[2]
    a = (ys[1:] if rev else ys[:-1]).reshape(-1, H).to(torch.bfloat16)
    c = (dxw[:-1] if rev else dxw[1:]).reshape(-1, 4 * H).to(torch.bfloat16)
    return torch.mm(a.T, c, out_dtype=torch.float32)


@pytest.mark.parametrize("shape", WIDE_SHAPES)
@pytest.mark.parametrize("stream", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("which", list(WIDE_DIRS))
def test_f2_wide_gates_gemm_matches_plain(dev, shape, stream, which):
    """bptt_gates_gemm_wide against bptt_gates_ref within 1e-5 of the
    largest magnitude (the same bf16 products, f32 sums in another order)
    and against the FMA form on the same inputs; the edge frame's rows are
    f32(xw) exactly; two runs, the same bits; one launch a call, counted."""
    B, T, H = shape
    ops = _wide_operands(dev, B, T, H, stream, seed=B + T + H)
    dirs = [(x, w, ys, r) for (x, w, ys, _), r in zip(ops, WIDE_DIRS[which])]
    before = (lstm_cuda.GATES_GEMM_LAUNCHES, lstm_cuda.GATES_WIDE_LAUNCHES)
    with torch.no_grad():
        runs = [_gates(dev, dirs, B, T, H, stream) for _ in range(2)]
        others = [_gates(dev, dirs, B, T, H, stream, gemm="fma")]
    torch.cuda.synchronize()
    assert (lstm_cuda.GATES_GEMM_LAUNCHES,
            lstm_cuda.GATES_WIDE_LAUNCHES) == (before[0] + 3, before[1] + 2)
    for k, (x, w, ys, r) in enumerate(dirs):
        pre = runs[0][k]
        assert pre.shape == (T, B, 4 * H) and pre.dtype == torch.float32
        ref = lstm_cuda.bptt_gates_ref(x, ys, w, reverse=r,
                                       dtype=torch.bfloat16)
        assert _rel_err(pre, ref) <= 1e-5
        for other in others:
            assert _rel_err(pre, other[k]) <= 1e-5
        edge = T - 1 if r else 0
        assert torch.equal(pre[edge], x[edge].float())
        assert torch.equal(pre, runs[1][k])


@pytest.mark.parametrize("shape", WIDE_SHAPES)
@pytest.mark.parametrize("stream", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("which", list(WIDE_DIRS))
def test_f2_wide_dwh_matches_torch_mm(dev, shape, stream, which):
    """dwh's wide tiles (the library's above H=512) against one torch.mm
    of the same bf16 operands and against the 128 x 128 tiles within 1e-5
    relative (f32 sums in another order), zeros at T = 1; two runs, the
    same bits; one launch a call, counted."""
    B, T, H = shape
    ops = _wide_operands(dev, B, T, H, stream, seed=B * T + H)
    dirs = [(ys, g, r) for (_, _, ys, g), r in zip(ops, WIDE_DIRS[which])]
    before = lstm_cuda.DWH_LAUNCHES
    with torch.no_grad():
        runs = [lstm_cuda.lstm_dwh(dirs, torch.bfloat16) for _ in range(2)]
        tiles = lstm_cuda.lstm_dwh(dirs, torch.bfloat16, design="tiles")
    torch.cuda.synchronize()
    assert lstm_cuda.DWH_LAUNCHES == before + 3
    assert lstm_cuda.DWH_DESIGNS[_build.load().vo_lstm_dwh_design(
        1, H)] == "wide"
    for k, (ys, g, r) in enumerate(dirs):
        got = runs[0][k]
        assert got.shape == (H, 4 * H) and got.dtype == torch.float32
        assert torch.equal(got, runs[1][k])
        if T == 1:
            assert not got.abs().max().item()
            assert not tiles[k].abs().max().item()
            continue
        assert _rel_err(got, _dwh_mm(ys, g, r)) <= 1e-5
        assert _rel_err(got, tiles[k]) <= 1e-5


def test_f2_wide_designs_named_at_flagship_match(dev):
    """At the flagship's B=32, T=512, H=512 (where the library keeps dwh's
    128 x 128 tiles) dwh's designs, named: dwh sums 16352 rows, where f32
    orders part by about 1e-5, so each design is held to the exact sum
    (f64 products of the bf16 values): within
    1e-5 of it, or no further from it than one torch.mm of the same
    operands; the gate GEMM within 1e-5 relative of bptt_gates_ref."""
    B, T, H = 32, 512, 512
    ops = _wide_operands(dev, B, T, H, torch.bfloat16, seed=5)
    gdirs = [(x, w, ys, r) for (x, w, ys, _), r in zip(ops, (False, True))]
    ddirs = [(ys, g, r) for (_, _, ys, g), r in zip(ops, (False, True))]
    with torch.no_grad():
        pre = _gates(dev, gdirs, B, T, H, torch.bfloat16)
        dwh = {d: lstm_cuda.lstm_dwh(ddirs, torch.bfloat16, design=d)
               for d in lstm_cuda.DWH_DESIGNS}
    for p, (x, w, ys, r) in zip(pre, gdirs):
        assert _rel_err(p, lstm_cuda.bptt_gates_ref(
            x, ys, w, reverse=r, dtype=torch.bfloat16)) <= 1e-5
    for k, (ys, g, r) in enumerate(ddirs):
        a = (ys[1:] if r else ys[:-1]).reshape(-1, H).double()
        c = (g[:-1] if r else g[1:]).reshape(-1, 4 * H).double()
        exact = (a.T @ c).float()
        library = _rel_err(_dwh_mm(ys, g, r), exact)
        for design, got in dwh.items():
            assert _rel_err(got[k], exact) <= max(1e-5, library), design


# lstm_fwd_tc (bf16 weights above H=512, the library's up to H=1056 for
# two directions): H at F2's 520 and 1000 and at the largest H it takes
# (1056: 132 CTAs, 17 k16 steps a slice), B on both sides of a 32-row tile
# and of four (one tile to five), T = 1 and 7, a ragged mask
TC_SHAPES = [(B, T, H) for B in (1, 5, 33, 129) for H in (520, 1000, 1056)
             for T in (1, 7)]


@pytest.mark.parametrize("shape", TC_SHAPES)
@pytest.mark.parametrize("stream,compute,tol", BF16_WEIGHT_TYPES)
def test_f2_tc_forward_matches_plain(dev, shape, stream, compute, tol):
    """lstm_fwd_tc in both forms, both directions in one launch and each
    direction alone (the library's route through lstm_recurrence),
    against lstm_recurrence_ref with bf16 rounding within the persistent
    kernel's bound; two runs give the same bits; one launch a call."""
    B, T, H = shape
    xw, mask, wh = _device_operands(dev, B, T, H, stream, compute,
                                    seed=B * T + H, ndir=2)
    dirs = [(xw[0], wh[0], False), (xw[1], wh[1], True)]
    before = lstm_cuda.FWD_TC_LAUNCHES
    with torch.no_grad():
        refs = [lstm_cuda.lstm_recurrence_ref(x, mask, w, reverse=r,
                                              save_cell=True)
                for x, w, r in dirs]
        for save_cell in (False, True):
            (ys, cs), (ys2, cs2) = (lstm_cuda.lstm_fwd(
                dirs, mask, compute, save_cell=save_cell, design="tc")
                for _ in range(2))
            torch.cuda.synchronize()
            assert (cs is None) == (not save_cell)
            for k, (rys, rcs) in enumerate(refs):
                assert ys[k].dtype == stream and ys[k].shape == (T, B, H)
                assert (ys[k].float() - rys.float()).abs().max() <= tol
                assert torch.equal(ys[k], ys2[k])
                if save_cell:
                    assert (cs[k].float() - rcs.float()).abs().max() <= tol
                    assert torch.equal(cs[k], cs2[k])
        for (x, w, r), (rys, _) in zip(dirs, refs):
            ys = lstm_cuda.lstm_recurrence(x, mask, w, reverse=r)
            assert (ys.float() - rys.float()).abs().max() <= tol
    assert lstm_cuda.FWD_TC_LAUNCHES == before + 6


@pytest.mark.parametrize("B,H,ndir,design", [
    (32, 520, 2, "tc"), (512, 1000, 2, "tc"), (32, 1056, 2, "tc"),
    (32, 1088, 1, "tc"), (32, 1100, 1, "grid"), (128, 1100, 1, "step"),
    (32, 1100, 2, "step"), (32, 512, 2, "persistent")])
def test_f2_forward_design_follows_the_library_rule(dev, B, H, ndir, design):
    """bf16 weights: lstm_fwd_persistent up to H=512, lstm_fwd_tc above it
    while its slice of wh fits in registers and its CTAs on the card (H <=
    1056 for two directions, 1088 for one), the f32-weight route's shape
    rule beyond; the f32 route names lstm_fwd_tc only for bf16 weights."""
    assert lstm_cuda.forward_design(torch.bfloat16, B, H, ndir) == design
    assert lstm_cuda.forward_design(torch.float32, B, H, ndir) != "tc"
    (xw,), mask, (wh,) = _device_operands(dev, 2, 2, 40, torch.float32,
                                          torch.float32, seed=1)
    with torch.no_grad(), pytest.raises(ValueError):
        lstm_cuda.lstm_fwd([(xw, wh, False)], mask, torch.float32,
                           design="tc")


def test_f2_tc_forward_is_one_launch_and_deterministic_at_b32_t512(dev):
    """F2's train shape (B=32, T=512, H=1000, bf16, both directions,
    save_cell): one lstm_fwd_tc launch (profiler), two runs the same bits,
    within 3e-2 of the plain version."""
    B, T, H = 32, 512, 1000
    xw, mask, wh = _device_operands(dev, B, T, H, torch.bfloat16,
                                    torch.bfloat16, seed=3, ndir=2)
    dirs = [(xw[0], wh[0], False), (xw[1], wh[1], True)]
    with torch.no_grad():
        counts = _profiled_counts(
            lambda: lstm_cuda.lstm_forward_cells(dirs, mask, torch.bfloat16),
            ("lstm_fwd_tc<", "lstm_fwd_grid<", "lstm_step<"))
        runs = [lstm_cuda.lstm_forward_cells(dirs, mask, torch.bfloat16)
                for _ in range(2)]
        refs = lstm_cuda.lstm_forward_cells(dirs, mask, torch.bfloat16,
                                            plain=True)
    assert counts == {"lstm_fwd_tc<": 1, "lstm_fwd_grid<": 0,
                      "lstm_step<": 0}, counts
    for (ys, cs), (ys2, cs2), (rys, rcs) in zip(*runs, refs):
        assert torch.equal(ys, ys2) and torch.equal(cs, cs2)
        assert (ys.float() - rys.float()).abs().max() <= 3e-2
        assert (cs.float() - rcs.float()).abs().max() <= 3e-2


# lstm_dwh_fma (f32 streams and weights): an odd shape, H % 4 != 0 (rows
# of partial float4s, loaded value by value), T = 1 (no rows) and 2, and
# R = (T-1)*B = 4095, 4096, 4097 (either side of two 2048-row chains) and
# 16352 (B=32, T=512: eight chains)
F32_DWH_SHAPES = [(5, 7, 40), (3, 9, 42), (7, 1, 40), (9, 2, 36),
                  (63, 66, 40), (64, 65, 40), (4097, 2, 36), (32, 512, 40)]


def _f32_dwh_dirs(dev, B, T, H, which, seed, offset=0):
    """(ys, dxw, reverse) per direction of ``which``, seeded normal values;
    with ``offset`` each tensor is a contiguous view that many floats into
    its buffer (rows not 16-byte aligned)."""
    rng = np.random.default_rng(seed)

    def t_(shape, scale):
        n = int(np.prod(shape))
        buf = torch.empty(n + offset, device=dev)
        buf[offset:] = torch.from_numpy(
            rng.normal(0, scale, n).astype(np.float32)).to(dev)
        return buf[offset:].view(shape)

    return [(t_((T, B, H), 0.5), t_((T, B, 4 * H), 0.1), r)
            for r in WIDE_DIRS[which]]


def _exact_distances(got, ys, dxw, rev):
    """The distances of ``got`` and of one torch.mm of the same f32
    operands to the exact (f64) sum, relative to its largest magnitude."""
    H = ys.shape[2]
    a = (ys[1:] if rev else ys[:-1]).reshape(-1, H)
    c = (dxw[:-1] if rev else dxw[1:]).reshape(-1, 4 * H)
    exact = a.double().T @ c.double()
    return _rel_err(got, exact), _rel_err(torch.mm(a.T, c), exact)


@pytest.mark.parametrize("shape", F32_DWH_SHAPES)
@pytest.mark.parametrize("which", list(WIDE_DIRS))
def test_f32_dwh_matches_plain_and_the_exact_sum(dev, shape, which):
    """lstm_dwh_fma against lstm_dwh_ref (atol 2e-4, rtol 1e-3: f32 sums
    in another order) and against the exact sum: no farther from it than
    one torch.mm of the same operands, or within 1e-6 of it (a few rows
    leave both a rounding or two away); zeros at T = 1; two runs give the
    same bits; one launch a call, counted."""
    B, T, H = shape
    dirs = _f32_dwh_dirs(dev, B, T, H, which, seed=B + T + H)
    before = lstm_cuda.DWH_LAUNCHES
    with torch.no_grad():
        runs = [lstm_cuda.lstm_dwh(dirs, torch.float32) for _ in range(2)]
    torch.cuda.synchronize()
    assert lstm_cuda.DWH_LAUNCHES == before + 2
    for k, (ys, g, r) in enumerate(dirs):
        got = runs[0][k]
        assert got.shape == (H, 4 * H) and got.dtype == torch.float32
        assert torch.equal(got, runs[1][k])
        if T == 1:
            assert not got.abs().max().item()
            continue
        torch.testing.assert_close(got, lstm_cuda.lstm_dwh_ref(
            ys, g, reverse=r), atol=2e-4, rtol=1e-3)
        err, mm = _exact_distances(got, ys, g, r)
        assert err <= max(1e-6, mm), (err, mm)


@pytest.mark.parametrize("offset", [1, 2])
def test_f32_dwh_misaligned_views(dev, offset):
    """Rows that do not start on 16 bytes (views 4 or 8 bytes into their
    buffers; H=40, so the row length alone would allow float4s) take the
    value-by-value loads and give what aligned copies of the same values
    give, bit for bit."""
    B, T, H = 33, 9, 40
    dirs = _f32_dwh_dirs(dev, B, T, H, "both", seed=4, offset=offset)
    assert all(ys.data_ptr() % 16 for ys, _, _ in dirs)
    copies = [(ys.clone(), g.clone(), r) for ys, g, r in dirs]
    with torch.no_grad():
        got = lstm_cuda.lstm_dwh(dirs, torch.float32)
        want = lstm_cuda.lstm_dwh(copies, torch.float32)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_f32_dwh_one_launch_at_the_main_shape(dev):
    """B=32, T=512, H=512, both directions (the rows split over eight
    ranges): one lstm_dwh_fma launch a call (profiler), no farther from
    the exact sum than one torch.mm, within lstm_dwh_ref's bounds."""
    B, T, H = 32, 512, 512
    dirs = _f32_dwh_dirs(dev, B, T, H, "both", seed=6)
    with torch.no_grad():
        counts = _profiled_counts(
            lambda: lstm_cuda.lstm_dwh(dirs, torch.float32),
            ("lstm_dwh_fma", "lstm_dwh_tc"))
        got = lstm_cuda.lstm_dwh(dirs, torch.float32)
    assert counts == {"lstm_dwh_fma": 1, "lstm_dwh_tc": 0}, counts
    for dwh, (ys, g, r) in zip(got, dirs):
        torch.testing.assert_close(dwh, lstm_cuda.lstm_dwh_ref(
            ys, g, reverse=r), atol=2e-4, rtol=1e-3)
        err, mm = _exact_distances(dwh, ys, g, r)
        assert err <= mm, (err, mm)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_backward_on_cuda_matches_plain_bptt(dev, dtype):
    """f32: bptt_gates_gemm (f32 form) + bptt_frame (B <= 32); bf16:
    bptt_gates_gemm + lstm_bwd_persistent (bf16 streams and weights)."""
    B, T, H = 6, 11, 24
    dirs, mask = _bptt_operands(dev, B, T, H, dtype, seed=4)
    xw, wh = dirs[0][0], dirs[0][1]
    xf = xw.clone().requires_grad_(True)
    xb = (xw * 0.5).requires_grad_(True)
    wf = wh.clone().requires_grad_(True)
    wb = (wh * 0.7).requires_grad_(True)
    before = lstm_cuda.BWD_LAUNCHES
    ys_f, ys_b = lstm_cuda.blstm_recurrence(xf, xb, mask, wf, wb)
    (ys_f * dirs[0][4] + ys_b * dirs[1][4]).sum().backward()
    assert lstm_cuda.BWD_LAUNCHES == before + 1
    with torch.no_grad():
        ref = []
        for x, w, dy, r in ((xf, wf, dirs[0][4], False),
                            (xb, wb, dirs[1][4], True)):
            ys, cs = lstm_cuda.lstm_recurrence_ref(x, mask, w, reverse=r,
                                                   save_cell=True)
            ref.append(lstm_cuda.lstm_bptt_ref(x, mask, w, ys, cs, dy,
                                               reverse=r))
    for (x, w), (rdx, rdw) in zip(((xf, wf), (xb, wb)), ref):
        if dtype == torch.float32:
            torch.testing.assert_close(x.grad, rdx, atol=2e-4, rtol=1e-3)
            torch.testing.assert_close(w.grad, rdw, atol=2e-4, rtol=1e-3)
        else:  # the kernels' forward and BPTT against the plain ones
            assert x.grad.dtype == w.grad.dtype == torch.bfloat16
            assert _rel_err(x.grad, rdx) <= _BF16_REL
            assert _rel_err(w.grad, rdw) <= _BF16_REL


def _ctc_case(dev, B, T, K, L, seed, infeasible=False):
    rng = np.random.default_rng(seed)
    lp = torch.log_softmax(
        torch.from_numpy(rng.normal(0, 2, (B, T, K)).astype(np.float32)), -1)
    labels = rng.integers(1, K, (B, L)).astype(np.int32)
    if L > 1:
        labels[0, 1] = labels[0, 0]  # a repeat
    ll = rng.integers(0, L + 1, B).astype(np.int32)
    ll[0] = L
    il = rng.integers(1, T + 1, B).astype(np.int32)
    il[0] = T
    if B > 1:
        ll[1] = 0  # an empty label
    if infeasible and B > 2:
        ll[2], il[2] = L, min(T, max(1, L // 2))
    return (lp.to(dev), torch.from_numpy(il).to(dev),
            torch.from_numpy(labels).to(dev), torch.from_numpy(ll).to(dev))


# (B, T, K, L), S = 2L+1: odd shapes; S = 1 (no labels); the three train
# buckets at K=96 (W=2048: B=32, T=512, S=513; W=512: B=128, T=128; W=128:
# B=512, T=32); S > 1024, where the kernels' ring has 4 stages and a
# thread owns 2, 3 or 4 states (L=700, 1100 and 2047: S=4095 is the
# largest S but one); T below the ring depth (16 stages, and 4 above)
CTC_SHAPES = [(5, 20, 9, 6), (1, 1, 4, 1), (7, 33, 12, 15), (3, 64, 96, 255),
              (2, 4, 5, 0), (32, 512, 96, 256), (128, 128, 96, 128),
              (512, 32, 96, 32), (4, 1500, 96, 700), (2, 2300, 40, 1100),
              (3, 700, 12, 2047), (6, 5, 12, 3), (3, 3, 40, 600)]
CTC_FLAGSHIP = [(32, 512, 96, 256), (128, 128, 96, 128), (512, 32, 96, 32),
                (4, 1500, 96, 700)]


def _ctc_kernel_inputs(dev, shape):
    """The alpha kernel's inputs, and the beta kernel's (log P from the
    plain alphas), of ``_ctc_case`` at (B, T, K, L)."""
    from vistaocr_tpu_torch.ops import ctc_cuda

    B, T, K, L = shape
    lp, il, labels, ll = _ctc_case(dev, B, T, K, L, seed=T + L,
                                   infeasible=True)
    lp_ext, skip, active, islast = ctc_cuda._prepare(lp, il, labels, 0)
    svalid, terminal = ctc_cuda._state_masks(ll, lp_ext.shape[2])
    ref_a = ctc_cuda.ctc_alpha_ref(lp_ext, active, skip, svalid)
    logp = ctc_cuda._loss_from_alphas(ref_a, il, ll).contiguous()
    skip2 = torch.cat([skip[:, 2:], torch.zeros_like(skip[:, :2])],
                      1).contiguous()
    return ((lp_ext, active, skip, svalid),
            (lp_ext, active, islast, skip2, svalid, terminal, ref_a, logp))


@pytest.mark.parametrize("shape", CTC_SHAPES)
def test_ctc_kernels_match_plain(dev, shape):
    from vistaocr_tpu_torch.ops import ctc_cuda

    a_in, b_in = _ctc_kernel_inputs(dev, shape)
    assert a_in[0].shape[2] == 2 * shape[3] + 1
    before = (ctc_cuda.ALPHA_LAUNCHES, ctc_cuda.BETA_LAUNCHES)
    alphas = ctc_cuda.ctc_alpha(*a_in)
    dlp = ctc_cuda.ctc_beta(*b_in)
    ref_a = b_in[6]
    ref_d = ctc_cuda.ctc_beta_ref(*b_in)
    torch.cuda.synchronize()
    assert ctc_cuda.ALPHA_LAUNCHES == before[0] + 1
    assert ctc_cuda.BETA_LAUNCHES == before[1] + 1
    svalid = a_in[3]
    valid = svalid[None].expand_as(alphas) > 0
    reach = ref_a > -1e29
    assert torch.equal(alphas > -1e29, reach)
    torch.testing.assert_close(alphas[reach & valid], ref_a[reach & valid],
                               atol=2e-5, rtol=1e-5)
    torch.testing.assert_close(dlp, ref_d, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", CTC_FLAGSHIP)
def test_ctc_kernels_are_deterministic_and_launch_once(dev, shape):
    """Two runs on the same inputs are bit-equal, and one call of each
    wrapper is one launch of its kernel (torch.profiler, which can miss a
    launch just after its window opens, as chip_smoke._kernel_us says)."""
    from vistaocr_tpu_torch.ops import ctc_cuda

    a_in, b_in = _ctc_kernel_inputs(dev, shape)
    runs = [(ctc_cuda.ctc_alpha(*a_in), ctc_cuda.ctc_beta(*b_in))
            for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    for _ in range(3):  # a window that missed a launch is taken again
        counts = _profiled_counts(
            lambda: (ctc_cuda.ctc_alpha(*a_in), ctc_cuda.ctc_beta(*b_in)),
            ("ctc_alpha_kernel", "ctc_beta_kernel"))
        if all(counts.values()):
            break
    assert counts == {"ctc_alpha_kernel": 1, "ctc_beta_kernel": 1}, counts


def test_ctc_loss_kernel_grads_match_plain(dev):
    from vistaocr_tpu_torch.ops import ctc_cuda
    from vistaocr_tpu_torch.ops.ctc import mean_ctc_loss

    lp, il, labels, ll = _ctc_case(dev, 6, 40, 11, 12, seed=3,
                                   infeasible=True)
    out = {}
    before = ctc_cuda.BETA_LAUNCHES
    for impl in ("pallas", "pallas_interpret", "scan"):
        x = lp.clone().requires_grad_(True)
        loss = mean_ctc_loss(x, il, labels, ll, impl=impl,
                             sample_weights=torch.ones(6, device=dev))
        loss.backward()
        out[impl] = (loss.item(), x.grad.clone())
    assert ctc_cuda.BETA_LAUNCHES == before + 1
    assert np.isfinite(out["pallas"][0]) and out["pallas"][0] > 1e28
    assert torch.isfinite(out["pallas"][1]).all()
    for other in ("pallas_interpret", "scan"):
        assert out["pallas"][0] == pytest.approx(out[other][0], rel=1e-5)
        torch.testing.assert_close(out["pallas"][1], out[other][1],
                                   atol=2e-5, rtol=1e-4)


# --- experiments: fused stem (K7a/K7b), direction-stacked BLSTM (K6a/K6b) ----

# (B, H, W, CO): an odd shape with one width < W, and the two flagship
# train shapes (2**21-pixel batches)
STEM_SHAPES = [(3, 32, 45, 64), (32, 32, 2048, 64), (128, 32, 512, 64)]
# (B, T, H): an odd shape with a ragged mask, and the flagship train shapes
BI_SHAPES = [(5, 7, 40), (32, 512, 512), (128, 128, 512)]
# bf16 bounds of kernel against plain, both reading the same bf16 operands
# (the card's readings are in PERF.md): stored bf16 values one ulp (plus
# the f32 difference, 2e-6) apart in at most this share of the elements; f32 ys/cs within one bf16 ulp of a
# value in [0.5, 1); dxw, dwh and dK relative to their tensor's scale
BF16_FLIP_SHARE = 2e-3
BF16_YS_ABS = 2.0 ** -8
BF16_BPTT_REL = 5e-3


def _stem_operands(dev, B, H, W, CO, seed):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B, H, W), np.uint8)
    widths = rng.integers(W // 3, W + 1, B).astype(np.int32)
    widths[0], widths[-1] = W, W - 7
    # kernel scale 0.1 keeps |out| < 2, where one bf16 ulp is <= 2**-7
    kernel = rng.normal(0, 0.1, (CO, 1, 3, 3)).astype(np.float32)
    return (torch.from_numpy(images).to(dev), torch.from_numpy(widths).to(dev),
            torch.from_numpy(kernel).to(dev))


@pytest.mark.parametrize("shape", STEM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("standardize", [True, False])
def test_stem_kernel_matches_plain(dev, shape, dtype, standardize):
    from vistaocr_tpu_torch.experiments import stem_cuda

    images, widths, kernel = _stem_operands(dev, *shape, seed=sum(shape))
    before = stem_cuda.STEM_LAUNCHES
    out, xn = stem_cuda.stem_fwd_cuda(images, widths, kernel, standardize,
                                      dtype)
    ref_out, ref_xn = stem_cuda.fused_stem_ref(images, widths, kernel,
                                               standardize, dtype)
    torch.cuda.synchronize()
    assert stem_cuda.STEM_LAUNCHES == before + 1
    assert out.dtype == xn.dtype == dtype
    assert out.shape == ref_out.shape and xn.shape == ref_xn.shape
    for a, b in ((out, ref_out), (xn, ref_xn)):
        if dtype == torch.float32:
            assert (a - b).abs().max().item() <= 1e-4
        else:  # the same f32 values, rounded once on each side
            ulps, share = _bf16_flips(a, b)
            assert ulps <= 1 and share <= BF16_FLIP_SHARE
    assert torch.equal(out[-1, :, :, shape[2] - 6:],
                       torch.zeros_like(out[-1, :, :, shape[2] - 6:]))


@pytest.mark.parametrize("shape", STEM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_dk_kernel_matches_plain(dev, shape, dtype):
    from vistaocr_tpu_torch.experiments import stem_cuda

    B, H, W, CO = shape
    images, widths, kernel = _stem_operands(dev, *shape, seed=sum(shape) + 1)
    _, xn = stem_cuda.fused_stem_ref(images, widths, kernel, True, dtype)
    rng = np.random.default_rng(B + W)
    dout = torch.from_numpy(rng.normal(0, 1, (B, CO, H, W)).astype(
        np.float32)).to(dev, dtype)
    before = stem_cuda.STEM_DK_LAUNCHES
    dk = stem_cuda.stem_dk_cuda(xn, dout)
    again = stem_cuda.stem_dk_cuda(xn, dout)
    ref = stem_cuda.stem_dk_ref(xn, dout)
    torch.cuda.synchronize()
    assert stem_cuda.STEM_DK_LAUNCHES == before + 2
    assert dk.dtype == torch.float32 and dk.shape == (CO, 1, 3, 3)
    assert torch.equal(dk, again)  # deterministic: no float atomics
    # a sum over B*H*W products: f32 order alone, relative to its scale
    assert _rel_err(dk, ref) <= 1e-4


def _bi_operands(dev, B, T, H, seed):
    rng = np.random.default_rng(seed)
    xw = rng.normal(0, 1, (T, 2, B, 4 * H)).astype(np.float32)
    wh = rng.normal(0, 1 / np.sqrt(H), (2, H, 4 * H)).astype(np.float32)
    lengths = rng.integers(1, T + 1, B)
    lengths[0] = T
    m = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    mask = np.ascontiguousarray(np.stack([m, m[::-1]], axis=1))  # [T, 2, B]
    dys = rng.normal(0, 1, (T, 2, B, H)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (xw, mask, wh, dys)]


@pytest.mark.parametrize("shape", BI_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bi_lstm_fwd_kernel_matches_plain(dev, shape, dtype):
    from vistaocr_tpu_torch.experiments import lstm_bi_stacked as bi

    B, T, H = shape
    xw, mask, wh, _ = _bi_operands(dev, B, T, H, seed=B + T + H)
    before = bi.BI_FWD_LAUNCHES
    ys, cs = bi.bi_lstm_fwd_cuda(xw, mask, wh.to(dtype), dtype)
    ref_ys, ref_cs = bi.bi_recurrence_ref(xw, mask, wh, dtype, save_cell=True)
    torch.cuda.synchronize()
    assert bi.BI_FWD_LAUNCHES == before + 1
    assert ys.dtype == cs.dtype == torch.float32 and ys.shape == (T, 2, B, H)
    if dtype == torch.float32:
        assert (ys - ref_ys).abs().max().item() <= 1e-4
        assert _rel_err(cs, ref_cs) <= 1e-4
    else:  # rare one-ulp flips of the rounded h, carried through T frames
        assert (ys - ref_ys).abs().max().item() <= BF16_YS_ABS
        assert (cs - ref_cs).abs().max().item() <= BF16_YS_ABS


@pytest.mark.parametrize("shape", BI_SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, BF16_BPTT_REL)])
def test_bi_lstm_bwd_kernel_matches_plain(dev, shape, dtype, tol):
    from vistaocr_tpu_torch.experiments import lstm_bi_stacked as bi

    B, T, H = shape
    xw, mask, wh, dys = _bi_operands(dev, B, T, H, seed=B * T + H)
    ys, cs = bi.bi_recurrence_ref(xw, mask, wh, dtype, save_cell=True)
    before = bi.BI_BWD_LAUNCHES
    dxw, dwh = bi.bi_lstm_bwd_cuda(xw, mask, wh.to(dtype), ys, cs, dys, dtype)
    ref_dxw, ref_dwh = bi.bi_bptt_ref(xw, mask, wh, ys, cs, dys, dtype)
    torch.cuda.synchronize()
    assert bi.BI_BWD_LAUNCHES == before + 1
    assert dxw.shape == xw.shape and dwh.shape == wh.shape
    # relative to each tensor's scale: dwh sums (T-1)*B products per entry,
    # in one product after the loop instead of frame by frame
    assert _rel_err(dxw, ref_dxw) <= tol
    assert _rel_err(dwh, ref_dwh) <= tol


def test_experiment_kernels_refuse_cpu_tensors(dev):
    """plain=False never runs a plain version in a kernel's place: the
    wrappers raise on CPU tensors, and so does a call that mixes devices."""
    from vistaocr_tpu_torch.experiments import lstm_bi_stacked as bi
    from vistaocr_tpu_torch.experiments import stem_cuda

    images, widths, kernel = _stem_operands(torch.device("cpu"), 2, 8, 16, 4,
                                            seed=1)
    xw, mask, wh, dys = _bi_operands(torch.device("cpu"), 2, 3, 4, seed=1)
    calls = [
        lambda: stem_cuda.stem_fwd_cuda(images, widths, kernel, True,
                                        torch.float32),
        lambda: stem_cuda.stem_dk_cuda(images.float(),
                                       torch.zeros((2, 4, 8, 16))),
        lambda: bi.bi_lstm_fwd_cuda(xw, mask, wh, torch.float32),
        lambda: bi.bi_lstm_bwd_cuda(xw, mask, wh, dys, dys, dys,
                                    torch.float32),
        lambda: stem_cuda.fused_stem(images, widths, kernel.to(dev),
                                     plain=False),
        lambda: bi.bi_recurrence(xw, mask, wh.to(dev), plain=False),
    ]
    for call in calls:
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_experiment_functions_backward_on_cuda(dev, dtype):
    """The autograd Functions run both kernels of each pair on the card
    and agree with their plain runs (``plain=True``) there; in bf16 they
    also cast the incoming gradients and ``wh`` as the plain runs do."""
    from vistaocr_tpu_torch.experiments import lstm_bi_stacked as bi
    from vistaocr_tpu_torch.experiments import stem_cuda

    images, widths, kernel = _stem_operands(dev, 4, 32, 96, 16, seed=2)
    rng = np.random.default_rng(3)
    B, T, D, H = 6, 9, 12, 20
    x = torch.from_numpy(rng.normal(0, 1, (B, T, D)).astype(np.float32)).to(dev)
    w = [torch.from_numpy(rng.normal(0, s, shp).astype(np.float32)).to(dev)
         for _ in range(2) for s, shp in ((0.3, (D, 4 * H)), (0.3, (H, 4 * H)),
                                           (0.1, (4 * H,)))]
    lengths = torch.tensor([9, 7, 1, 5, 9, 3], device=dev)
    fmask = torch.arange(T, device=dev)[None, :] < lengths[:, None]
    before = (stem_cuda.STEM_LAUNCHES, stem_cuda.STEM_DK_LAUNCHES,
              bi.BI_FWD_LAUNCHES, bi.BI_BWD_LAUNCHES)
    grads = []
    for plain in (False, True):
        k = kernel.clone().requires_grad_(True)
        out = stem_cuda.fused_stem(images, widths, k, True, dtype,
                                   plain=plain)
        assert out.dtype == dtype
        (out * out).sum().backward()
        ws = [t.clone().requires_grad_(True) for t in w]
        ys = bi.bilstm_layer_stacked(x, fmask, *ws, dtype=dtype, plain=plain)
        (ys * ys).sum().backward()
        grads.append([out, k.grad, ys] + [t.grad for t in ws])
    assert (stem_cuda.STEM_LAUNCHES, stem_cuda.STEM_DK_LAUNCHES,
            bi.BI_FWD_LAUNCHES, bi.BI_BWD_LAUNCHES) == tuple(
                n + 1 for n in before)
    (out_k, *rest_k), (out_p, *rest_p) = grads
    if dtype == torch.float32:
        assert _rel_err(out_k, out_p) <= 1e-4
    else:
        ulps, share = _bf16_flips(out_k, out_p)
        assert ulps <= 1 and share <= BF16_FLIP_SHARE
    tol = 1e-4 if dtype == torch.float32 else BF16_BPTT_REL
    for a, b in zip(rest_k, rest_p):
        assert _rel_err(a, b) <= tol


# --- the int8 conv (csrc/int8_conv.cu) ---------------------------------------
def _int8_operands(dev, B, H, W, ci, co, dtype, seed):
    from vistaocr_tpu_torch.ops import int8_conv

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (B, H, W, ci)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-127, 128, (co, ci, 3, 3)).astype(
        np.int8))
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-3, co).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.1, co).astype(np.float32))
    inv_s = float(np.float32(127.0 / 3.0))
    return (x.to(dev, dtype), int8_conv.pack_weights(wq).to(dev),
            scale.to(dev), bias.to(dev), inv_s)


INT8_SHAPES = [(B, 5, W, ci, co) for ci in (1, 5, 64) for co in (8, 24)
               for B in (1, 3) for W in (1, 37)]
INT8_SHAPES += [(4, 32, 64, 1, 64), (2, 16, 33, 64, 128),
                (3, 8, 17, 128, 256), (1, 4, 9, 256, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", INT8_SHAPES)
def test_int8_conv_matches_plain(dev, shape, dtype):
    from vistaocr_tpu_torch.ops import int8_conv

    ops = _int8_operands(dev, *shape, dtype, seed=sum(shape))
    got = int8_conv.int8_conv(*ops)
    want = int8_conv.int8_conv_ref(*ops)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert got.shape == (*shape[:3], shape[4])
    assert torch.equal(got, want)
    # the plain version on the CPU: the same arithmetic
    cpu = int8_conv.int8_conv_ref(*(o.cpu() if torch.is_tensor(o) else o
                                    for o in ops))
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_conv_rounds_half_even_and_clamps(dev, dtype):
    """Inputs exactly on a .5 quantum and beyond +-127 s: a centre-tap
    weight of +1 (channel 0) and -1 (channel 1) with scale 1, bias 0 gives
    relu(xq) and relu(-xq), so xq = y0 - y1."""
    from vistaocr_tpu_torch.ops import int8_conv

    inv_s = 4.0  # s = 0.25: (k + 0.5) / 4 is exact in bf16 for small k
    k = torch.arange(-140, 140, dtype=torch.float32)
    x = torch.cat([(k + 0.5) / inv_s, k / inv_s, torch.tensor(
        [1e3, -1e3, 31.875, -31.875, 40.0, -40.0])])
    x = x.to(dtype)
    wq = torch.zeros((2, 1, 3, 3), dtype=torch.int8)
    wq[0, 0, 1, 1], wq[1, 0, 1, 1] = 1, -1
    args = (x.reshape(1, 1, -1, 1).contiguous().to(dev),
            int8_conv.pack_weights(wq).to(dev),
            torch.ones(2, device=dev), torch.zeros(2, device=dev), inv_s)
    y = int8_conv.int8_conv(*args)
    assert torch.equal(y, int8_conv.int8_conv_ref(*args))
    xq = (y[..., 0] - y[..., 1]).float().reshape(-1).cpu()
    want = torch.round(x.float() * inv_s).clamp(-127, 127)
    assert torch.equal(xq, want)
    assert want.abs().max() == 127
    # -0.5, 0.5, 1.5 (k = -1, 0, 1) round to -0, 0, 2
    assert torch.equal(want[139:142], torch.tensor([0.0, 0.0, 2.0]))


def test_int8_conv_is_deterministic_and_counts(dev):
    from vistaocr_tpu_torch.ops import int8_conv

    ops = _int8_operands(dev, 8, 32, 200, 64, 64, torch.bfloat16, seed=3)
    before = int8_conv.LAUNCHES
    a = int8_conv.int8_conv(*ops)
    b = int8_conv.int8_conv(*ops)
    assert int8_conv.LAUNCHES == before + 2
    int8_conv.int8_conv_ref(*ops)
    assert int8_conv.LAUNCHES == before + 2
    assert torch.equal(a, b)


def test_int8_conv_refuses_what_it_does_not_take(dev):
    from vistaocr_tpu_torch.ops import int8_conv

    x, wp, scale, bias, inv_s = _int8_operands(dev, 2, 4, 9, 5, 8,
                                               torch.float32, seed=1)
    for bad in ((x, wp.cpu(), scale, bias), (x, wp, scale.cpu(), bias),
                (x.half(), wp, scale, bias),
                (x.transpose(1, 2), wp, scale, bias),
                (x, wp[:, :32].contiguous(), scale, bias),
                (x, wp, scale.double(), bias)):
        with pytest.raises(ValueError):
            int8_conv.int8_conv(*bad, inv_s)


def test_int8_conv_replays_in_a_cuda_graph(dev):
    from vistaocr_tpu_torch.ops import int8_conv

    ops = _int8_operands(dev, 3, 16, 40, 64, 128, torch.bfloat16, seed=4)
    x = ops[0].clone()
    eager = int8_conv.int8_conv(*ops)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        int8_conv.int8_conv(x, *ops[1:])  # warm-up on the side stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = int8_conv.int8_conv(x, *ops[1:])
    x.copy_(ops[0])
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    x.copy_(-ops[0])
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, int8_conv.int8_conv_ref(-ops[0], *ops[1:]))


def test_int8_service_launches_the_kernel(dev):
    """An int8 service on the card (a tiny snapshot, its qstack
    calibrated by the port): every route through the int8 conv (six
    launches a batch) and K1 (one launch a BLSTM layer and batch), greedy
    and the device beam, against the same service on the CPU."""
    from vistaocr_tpu_torch.checkpoint import load_model
    from vistaocr_tpu_torch.models import quant
    from vistaocr_tpu_torch.ops import int8_conv, lstm_cuda
    from vistaocr_tpu_torch.serve import OcrService, ServiceConfig

    rng = np.random.default_rng(2)
    lines = [rng.integers(0, 256, (32, int(w)), np.uint8)
             for w in rng.integers(20, 250, 12)]
    with tempfile.TemporaryDirectory() as d:
        _tiny_snapshot(d)
        model, _, _ = load_model(d, "cpu")
        calib = [(np.stack([np.pad(x[:, :100], ((0, 0), (0, 100 - min(
            100, x.shape[1])))) for x in lines[:4]]),
                  np.full(4, 100, np.int32))]
        quant.save_qstack(d, quant.quantize_model(model, calib))
        for decoder in ("greedy", "beam"):
            cfg = ServiceConfig(max_batch=8, warmup=False, quantize="int8",
                                decoder=decoder)
            texts = {}
            for device in ("cuda", "cpu"):
                svc = OcrService(d, cfg, device=device)
                try:
                    before = (int8_conv.LAUNCHES, lstm_cuda.LAUNCHES,
                              svc.stats["batches"])
                    texts[device] = [r.text for r in svc.ocr_lines(lines)]
                    launched = int8_conv.LAUNCHES - before[0]
                    k1 = lstm_cuda.LAUNCHES - before[1]
                    batches = svc.stats["batches"] - before[2]
                finally:
                    svc.close()
                on_card = device == "cuda"
                assert batches > 0
                assert launched == 6 * batches * on_card
                assert k1 == model.config.lstm_layers * batches * on_card
            same = np.mean([a == b for a, b in zip(*texts.values())])
            assert same >= 0.9, texts


# the fused entry points (int8_conv_fused): TMA box edges (W below, and
# not a multiple of, the 16-column tile; W = 1; odd H), every CI and CO
# the stack can meet, both designs (the tc kernel at CI % 64 == 0 with CO
# 64, 128 or 256 where its plan fits, the direct one elsewhere)
INT8_FUSED_SHAPES = [
    (2, 5, 1, 64, 64), (1, 7, 5, 64, 64), (3, 9, 17, 64, 128),
    (2, 8, 16, 128, 128), (1, 5, 37, 128, 256), (2, 4, 9, 256, 256),
    (1, 3, 7, 256, 64), (2, 6, 33, 32, 128), (1, 5, 23, 5, 24),
    (2, 9, 11, 1, 64), (1, 4, 13, 32, 8), (1, 5, 21, 128, 24)]
INT8_POOLS = [((1, 1), "max"), ((2, 2), "max"), ((2, 1), "max"),
              ((2, 2), "stride"), ((2, 1), "stride")]


def _int8_fused_operands(dev, B, H, W, ci, co, dtype, seed):
    """(xq int8, x float, weights, scale, bias, inv_s, inv_next): x's
    quantize spans the clamp, the outputs' quantize lands on both sides of
    the rounding."""
    from vistaocr_tpu_torch.ops import int8_conv

    x, wp, scale, bias, inv_s = _int8_operands(dev, B, H, W, ci, co, dtype,
                                                seed)
    xq = int8_conv.quantize_ref(x, inv_s)
    inv_next = float(np.float32(1.0 / (0.02 * np.sqrt(ci))))
    return xq, x, wp, scale, bias, inv_s, inv_next


@pytest.mark.parametrize("out_int8", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool", INT8_POOLS)
@pytest.mark.parametrize("shape", INT8_FUSED_SHAPES)
def test_int8_fused_matches_plain(dev, shape, pool, dtype, out_int8):
    from vistaocr_tpu_torch.ops import int8_conv as ic

    xq, x, wp, scale, bias, inv_s, inv_next = _int8_fused_operands(
        dev, *shape, dtype, seed=sum(shape))
    kw = dict(dtype=dtype, window=pool[0], pool_impl=pool[1],
              inv_s_next=inv_next if out_int8 else None)
    want = ic.int8_conv_fused_ref(xq, wp, scale, bias, **kw)
    B, H, W, ci, co = shape
    assert want.shape == (B, -(-H // pool[0][0]), -(-W // pool[0][1]), co)
    assert want.dtype == (torch.int8 if out_int8 else dtype)
    design = ic.conv_design(ci, co, want.dtype, pool[0])
    got = ic.int8_conv_fused(xq, wp, scale, bias, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape, design
    assert torch.equal(got, want), design
    # a float x: quantized by the direct kernel's load, or by one pass
    # before the tc kernel
    got = ic.int8_conv_fused(x, wp, scale, bias, inv_s=inv_s, **kw)
    assert torch.equal(got, want)
    cpu = ic.int8_conv_fused_ref(xq.cpu(), wp.cpu(), scale.cpu(), bias.cpu(),
                                 **kw)
    assert torch.equal(want.cpu(), cpu)


@pytest.mark.parametrize("out_int8", [True, False])
@pytest.mark.parametrize("chans", [(64, 64), (64, 128), (128, 128),
                                   (128, 256), (256, 256)])
def test_int8_fused_walks_many_tiles(dev, chans, out_int8):
    """608 tiles: every CTA of the persistent grid walks several, so both
    warpgroups' rings (ping-pong at CO = 64) and the staging buffer's
    reuse behind the TMA store are exercised."""
    from vistaocr_tpu_torch.ops import int8_conv as ic

    xq, _, wp, scale, bias, _, inv_next = _int8_fused_operands(
        dev, 4, 32, 600, *chans, torch.bfloat16, seed=sum(chans))
    kw = dict(dtype=torch.bfloat16, window=(2, 2),
              inv_s_next=inv_next if out_int8 else None)
    out = torch.int8 if out_int8 else torch.bfloat16
    assert ic.conv_design(*chans, out, (2, 2)) == "tc"
    got = ic.int8_conv_fused(xq, wp, scale, bias, **kw)
    assert torch.equal(got, ic.int8_conv_fused_ref(xq, wp, scale, bias, **kw))
    assert torch.equal(got, ic.int8_conv_fused(xq, wp, scale, bias, **kw))


def test_int8_first_conv_after_a_float_prefix(dev):
    """A float x into the tc kernel: one quantize pass, one conv launch,
    bit-equal to the plain version; into the direct kernel: one launch."""
    from vistaocr_tpu_torch.ops import int8_conv as ic

    for shape, passes in (((2, 16, 37, 64, 128), 1), ((2, 32, 37, 1, 64), 0)):
        _, x, wp, scale, bias, inv_s, inv_next = _int8_fused_operands(
            dev, *shape, torch.bfloat16, seed=7)
        before = (ic.LAUNCHES, ic.QUANTIZE_LAUNCHES)
        got = ic.int8_conv_fused(x, wp, scale, bias, inv_s=inv_s,
                                 window=(2, 2), inv_s_next=inv_next)
        assert (ic.LAUNCHES, ic.QUANTIZE_LAUNCHES) == (before[0] + 1,
                                                       before[1] + passes)
        assert torch.equal(got, ic.int8_conv_fused_ref(
            x, wp, scale, bias, inv_s=inv_s, window=(2, 2),
            inv_s_next=inv_next))
        assert torch.equal(ic.quantize(x, inv_s), ic.quantize_ref(x, inv_s))


def test_int8_fused_reruns_bit_equal_and_counts(dev):
    from vistaocr_tpu_torch.ops import int8_conv as ic

    xq, _, wp, scale, bias, _, inv_next = _int8_fused_operands(
        dev, 8, 16, 200, 128, 256, torch.bfloat16, seed=3)
    kw = dict(dtype=torch.bfloat16, window=(2, 2), inv_s_next=inv_next)
    before = (ic.LAUNCHES, ic.QUANTIZE_LAUNCHES)
    a = ic.int8_conv_fused(xq, wp, scale, bias, **kw)
    b = ic.int8_conv_fused(xq, wp, scale, bias, **kw)
    ic.int8_conv_fused_ref(xq, wp, scale, bias, **kw)
    assert (ic.LAUNCHES, ic.QUANTIZE_LAUNCHES) == (before[0] + 2, before[1])
    assert torch.equal(a, b)


def test_int8_fused_refuses_what_it_does_not_take(dev):
    from vistaocr_tpu_torch.ops import int8_conv as ic

    xq, x, wp, scale, bias, inv_s, _ = _int8_fused_operands(
        dev, 2, 5, 9, 5, 8, torch.float32, seed=1)
    for bad in (dict(dtype=torch.float32, window=(3, 3)),
                dict(dtype=torch.float32, pool_impl="avg"),
                dict(dtype=torch.float16),
                dict()):  # an int8 x names its compute type
        with pytest.raises(ValueError):
            ic.int8_conv_fused(xq, wp, scale, bias, **bad)
    with pytest.raises(ValueError):  # a float x needs its inv_s
        ic.int8_conv_fused(x, wp, scale, bias)
    with pytest.raises(ValueError):
        ic.int8_conv(xq, wp, scale, bias, inv_s)
    with pytest.raises(ValueError):
        ic.quantize(xq, inv_s)


def test_int8_design_rule(dev):
    """The tc kernel takes 64-byte channel chunks and a wgmma N of all of
    CO, and needs a ring of two stages (four in ping-pong) beside its
    output's staging buffers; the rule is the launcher's own."""
    from vistaocr_tpu_torch.ops import int8_conv as ic

    assert ic.conv_design(1, 64) == "direct"
    assert ic.conv_design(32, 64) == "direct"
    assert ic.conv_design(64, 24) == "direct"
    for ci, co in ((64, 64), (64, 128), (128, 128), (128, 256), (256, 256)):
        assert ic.conv_design(ci, co) == "tc"
    assert ic.conv_design(256, 256, torch.float32, (2, 1)) == "tc"
    assert ic.conv_design(128, 256, torch.float32, (1, 1)) == "direct"
    with pytest.raises(ValueError):
        ic.conv_design(64, 64, torch.int8, (3, 3))


def _int8_stack(dev, dtype, conv_pool, seed=0):
    """The flagship's conv widths (64/128/256 x 2), its qstack from seeded
    folded kernels and a calibration on the batch, on ``dev``."""
    from vistaocr_tpu_torch.models import ModelConfig, quant

    cfg = ModelConfig(num_classes=11, compute_dtype=dtype,
                      conv_pool=conv_pool)
    rng = np.random.default_rng(seed)
    chans = [1] + [st.channels for st in cfg.stages
                   for _ in range(st.num_convs)]
    ks = [rng.normal(0, np.sqrt(2 / (9 * chans[i])),
                     (chans[i + 1], chans[i], 3, 3)).astype(np.float32)
          for i in range(len(chans) - 1)]
    bs = [rng.normal(0, 0.1, c).astype(np.float32) for c in chans[1:]]
    images = torch.from_numpy(rng.integers(0, 256, (3, 32, 75), np.uint8))
    widths = torch.tensor([75, 61, 9], dtype=torch.int32)
    scales = quant.calibrate_in_scales(ks, bs, cfg, [(images, widths)],
                                       device="cpu")
    qstack = quant.quantize_conv_stack(ks, bs, scales)
    return cfg, qstack, images, widths


@pytest.mark.parametrize("prefix", [0, 1, 2, 3, 6])
@pytest.mark.parametrize("conv_pool", ["max", "stride"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_stack_matches_the_cpu(dev, dtype, conv_pool, prefix):
    """quantized_conv_features at the flagship's widths on odd W: bit-equal
    to its plan run with the plain int8 steps on the card (and, with every
    conv int8, to the plain stack on the CPU), six minus the prefix conv
    launches, and a quantize pass only in front of a tc conv after a float
    prefix."""
    from vistaocr_tpu_torch.models import quant
    from vistaocr_tpu_torch.ops import int8_conv as ic

    from vistaocr_tpu_torch.ops.preprocess import preprocess_images

    cfg, qstack, images, widths = _int8_stack(dev, dtype, conv_pool)
    qs = quant.QuantizedStack(qstack, dev, cfg.dtype)
    img, wid = images.to(dev), widths.to(dev)
    before = (ic.LAUNCHES, ic.QUANTIZE_LAUNCHES)
    got = quant.quantized_conv_features(qs, img, wid, cfg,
                                        float_prefix=prefix)
    torch.cuda.synchronize()
    assert (ic.LAUNCHES - before[0], ic.QUANTIZE_LAUNCHES - before[1]) == (
        6 - prefix, int(0 < prefix < 6))
    # the same plan with every int8 step's plain version, on the card
    x = preprocess_images(img, wid, standardize=cfg.standardize_input,
                          dtype=cfg.dtype)
    for step in quant.conv_plan(cfg, prefix):
        if step[0] == "pool":
            x = quant._nhwc_pool(x, step[1], conv_pool)
            continue
        c = qs.convs[step[1]]
        if step[0] == "float":
            x = quant._float_conv(x, qs.fkernels[step[1]], c.bias, cfg.dtype)
        else:
            x = ic.int8_conv_fused_ref(
                x, c.weight, c.scale, c.bias, inv_s=c.inv_s,
                dtype=cfg.dtype, window=step[2], pool_impl=conv_pool,
                inv_s_next=qs.convs[step[1] + 1].inv_s if step[3] else None)
    assert got.dtype == x.dtype and torch.equal(got, x)
    if prefix == 0:  # every conv int8: the CPU's plain stack too
        cpu = quant.quantized_conv_features(
            quant.QuantizedStack(qstack, "cpu", cfg.dtype), images, widths,
            cfg)
        assert torch.equal(got.cpu(), cpu)


def test_int8_stack_replays_in_a_cuda_graph(dev):
    from vistaocr_tpu_torch.models import quant

    cfg, qstack, images, widths = _int8_stack(dev, "bfloat16", "max", seed=1)
    qs = quant.QuantizedStack(qstack, dev, cfg.dtype)
    img, wid = images.to(dev), widths.to(dev)
    eager = quant.quantized_conv_features(qs, img, wid, cfg)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        quant.quantized_conv_features(qs, img, wid, cfg)  # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = quant.quantized_conv_features(qs, img, wid, cfg)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    img.copy_(255 - images.to(dev))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), quant.quantized_conv_features(
        quant.QuantizedStack(qstack, "cpu", cfg.dtype), 255 - images,
        widths, cfg))


# --- the epoch-fused trainer's CUDA graphs (-k fused) -------------------------
FUSED_B, FUSED_W, FUSED_H = 8, 128, 64  # T = 32 frames


def _fused_case(dev, compute_dtype, dropout=0.1, n=40, nb=4, seed=0):
    """A small model (H=64, 2 BLSTM layers) from a seeded init, n seeded
    lines of one bucket resident on the card, and nb rows of B indices."""
    from vistaocr_tpu_torch.models import (CnnLstmOcr, ConvStageSpec,
                                           ModelConfig, init_parameters)

    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, 32, FUSED_W), np.uint8)
    widths = rng.integers(FUSED_W // 2, FUSED_W + 1, n).astype(np.int32)
    lls = rng.integers(1, 9, n).astype(np.int32)
    labels = np.zeros((n, 15), np.int32)
    for i in range(n):
        labels[i, :lls[i]] = rng.integers(1, 11, lls[i])
    arrays = [torch.from_numpy(a).to(dev)
              for a in (images, widths, labels, lls)]
    idx = np.stack([rng.permutation(n)[:FUSED_B] for _ in range(nb)])
    idx = torch.from_numpy(idx.astype(np.int32)).to(dev)
    cfg = ModelConfig(
        num_classes=11,
        stages=(ConvStageSpec(8, 2, (2, 2)), ConvStageSpec(16, 2, (2, 2)),
                ConvStageSpec(16, 2, (2, 1))),
        bridge_dim=32, lstm_hidden=FUSED_H, dropout=dropout,
        compute_dtype=compute_dtype)
    model = CnnLstmOcr(cfg)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(dev), arrays, idx, torch.ones(idx.shape, device=dev)


def _fresh(model):
    import copy

    from vistaocr_tpu_torch import train as T

    m = copy.deepcopy(model)
    tx = T.Optimizer("adam")
    return m, tx, T.TrainState(model=m,
                               opt_state=tx.init(dict(m.named_parameters())))


def _eager_steps(model, arrays, idx, w):
    """train_step over the rows of idx on a copy of model: (losses,
    model)."""
    from vistaocr_tpu_torch import train as T

    m, tx, state = _fresh(model)
    step = T.make_train_step(m, tx, False, "auto", grad_clip=5.0, seed=3)
    losses = []
    for k in range(idx.shape[0]):
        losses.append(step(state, *(a.index_select(0, idx[k])
                                    for a in arrays), w[k], 1e-3)["loss"])
    return torch.stack(losses).cpu(), m


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2.0 ** -8),
                                       ("float32", 1e-5)])
def test_fused_graph_segment_matches_eager_steps(dev, dtype, tol):
    """One segment of nb rows: one capture, nb replays, the mean and last
    loss and the norm against nb eager train_steps on the same rows
    (bf16 within 2**-8 relative, f32 within 1e-5; gnorm within 10x
    that), parameters within atol 3e-3 / rtol 2e-2. With f32 weights at
    B=8, H=64 the forward is lstm_fwd_grid's cooperative launch."""
    from vistaocr_tpu_torch import train as T

    model, arrays, idx, w = _fused_case(dev, dtype)
    if dtype == "float32":
        assert lstm_cuda.forward_design(torch.float32, FUSED_B,
                                        FUSED_H) == "grid"
    m, tx, state = _fresh(model)
    epoch = T.make_train_epoch(m, tx, False, "auto", grad_clip=5.0, seed=3)
    assert epoch.graphs
    before = (T.GRAPH_CAPTURES, T.GRAPH_REPLAYS, T.FUSED_EAGER_STEPS)
    out = epoch(state, arrays, idx, w, 1e-3)
    assert (T.GRAPH_CAPTURES - before[0], T.GRAPH_REPLAYS - before[1],
            T.FUSED_EAGER_STEPS - before[2]) == (1, idx.shape[0], 0)
    assert state.step == idx.shape[0]
    losses, eager = _eager_steps(model, arrays, idx, w)
    for key, ref, bound in (("loss", losses.mean(), tol),
                            ("last_loss", losses[-1], tol)):
        got = out[key].item()
        assert np.isfinite(got) and abs(got - ref.item()) <= bound * abs(
            ref.item()), (key, got, ref.item())
    for (k, a), e in zip(m.state_dict().items(),
                         eager.state_dict().values()):
        if a.is_floating_point():
            assert bool(((a - e).abs() <= 3e-3 + 2e-2 * e.abs()).all()), k
    # a second call of the same shape replays the same graph
    epoch(state, arrays, idx[:2], w[:2], 1e-3)
    assert T.GRAPH_CAPTURES - before[0] == 1
    assert T.GRAPH_REPLAYS - before[1] == idx.shape[0] + 2


def test_fused_replays_draw_the_per_step_masks(dev):
    """dropout 0.1, bf16: replay s draws the masks of step_generator(seed,
    s), those of the eager train_step s, and steps draw anew."""
    from vistaocr_tpu_torch import train as T
    from vistaocr_tpu_torch.models import blstm

    model, arrays, idx, w = _fused_case(dev, "bfloat16")
    real = blstm.dropout_mask
    rec = []

    def record(x, rate, generator):
        mask = real(x, rate, generator)
        rec.append(mask)
        return mask

    blstm.dropout_mask = record
    try:
        m, tx, state = _fresh(model)
        epoch = T.make_train_epoch(m, tx, False, "auto", grad_clip=5.0,
                                   seed=3)
        replayed = []
        for k in range(idx.shape[0]):  # one replay a call
            epoch(state, arrays, idx[k:k + 1], w[k:k + 1], 1e-3)
            if k == 0:  # the warm-up's masks, then the graph's own
                live = rec[len(rec) // 2:]
            replayed.append([t.clone() for t in live])
        n0 = len(rec)
        _eager_steps(model, arrays, idx, w)
        eager = rec[n0:]
    finally:
        blstm.dropout_mask = real
    assert len(live) == 2  # after the bridge and between the layers
    assert len(eager) == 2 * idx.shape[0]
    per_step = [eager[2 * s:2 * s + 2] for s in range(idx.shape[0])]
    for s, (a, b) in enumerate(zip(replayed, per_step)):
        assert all(torch.equal(x, y) for x, y in zip(a, b)), s
    assert not torch.equal(replayed[0][0], replayed[1][0])


@pytest.mark.parametrize("dtype,kernels", [
    ("bfloat16", ("lstm_fwd_persistent", "bptt_gates_gemm",
                  "lstm_bwd_persistent", "lstm_dwh", "ctc_alpha_kernel",
                  "ctc_beta_kernel")),
    ("float32", ("lstm_fwd_grid", "bptt_gates_gemm", "bptt_frame",
                 "lstm_dwh", "ctc_alpha_kernel", "ctc_beta_kernel"))])
def test_fused_replays_run_the_kernels(dev, dtype, kernels):
    """In a profiler window over replays only (no capture in it), each
    step runs K1 (f32: lstm_fwd_grid's cooperative launch), K2/K3 and
    K4/K5 on the device, two layers' worth of the LSTM kernels."""
    from vistaocr_tpu_torch import train as T

    model, arrays, idx, w = _fused_case(dev, dtype, dropout=0.0)
    m, tx, state = _fresh(model)
    epoch = T.make_train_epoch(m, tx, False, "auto", grad_clip=5.0)
    epoch(state, arrays, idx[:1], w[:1], 1e-3)  # captures
    captures = T.GRAPH_CAPTURES
    counts = _profiled_counts(
        lambda: epoch(state, arrays, idx, w, 1e-3), kernels)
    assert T.GRAPH_CAPTURES == captures
    nb = idx.shape[0]
    assert all(counts[k] >= nb for k in kernels), counts
    assert counts[kernels[0]] == 2 * nb, counts  # one a layer, both ways


def test_fused_capture_failure_raises(dev, monkeypatch):
    """A step that fails while its graph is captured raises from the
    trainer; nothing runs eagerly in its place, the warm-up's writes are
    undone, and the same trainer captures a sound step afterwards."""
    from vistaocr_tpu_torch import train as T

    model, arrays, idx, w = _fused_case(dev, "float32", dropout=0.0)
    m, tx, state = _fresh(model)
    epoch = T.make_train_epoch(m, tx, False, "auto", grad_clip=5.0)
    real = T.global_norm

    def failing_norm(*a):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("not capturable")
        return real(*a)

    monkeypatch.setattr(T, "global_norm", failing_norm)
    before = (T.GRAPH_CAPTURES, T.GRAPH_REPLAYS, T.FUSED_EAGER_STEPS)
    with pytest.raises(RuntimeError, match="not capturable"):
        epoch(state, arrays, idx, w, 1e-3)
    assert (T.GRAPH_CAPTURES, T.GRAPH_REPLAYS,
            T.FUSED_EAGER_STEPS) == before
    assert state.step == 0
    for (k, a), b in zip(m.state_dict().items(),
                         model.state_dict().values()):
        assert torch.equal(a, b), k
    monkeypatch.setattr(T, "global_norm", real)
    out = epoch(state, arrays, idx[:1], w[:1], 1e-3)
    losses, _ = _eager_steps(model, arrays, idx[:1], w[:1])
    assert abs(out["loss"].item() - losses[0].item()) <= 1e-5 * abs(
        losses[0].item())
