"""The port's LSTM training path (ops/lstm_cuda.py) against the JAX
package: the ``save_cell`` forward against ``_lstm_fwd_local(save_cell=
True, interpret=True)`` (ys and cs within 1e-5), the plain BPTT
``lstm_bptt_ref`` (two stages: ``bptt_gates_ref``, ``bptt_frames_ref``)
against ``_lstm_bwd_local(interpret=True)`` (dxw and dwh within atol
2e-4, rtol 1e-3, tests/test_lstm_pallas.py:77; with a bf16 stream or
compute dtype within 2**-8 of the tensor's largest magnitude), both
directions with ragged masks; the gate recompute against the frame
loop's gates and its ``torch.mm`` yardstick; the autograd Function
against torch autograd through the plain loop; bf16 streams against the
f32 oracle within 3e-2. The CUDA kernels' own tests are in
tests/test_torch_port_cuda.py."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from vistaocr_tpu.ops.lstm_pallas import _lstm_bwd_local, _lstm_fwd_local
from vistaocr_tpu.ops.lstm_pallas import lstm_layer_pallas
from vistaocr_tpu_torch.models.blstm import BLSTMStack
from vistaocr_tpu_torch.ops import lstm_cuda

torch.set_num_threads(2)


def _case(seed, T=9, B=5, H=8):
    rng = np.random.default_rng(seed)
    xw = rng.normal(0, 1, (T, B, 4 * H)).astype(np.float32)
    wh = rng.normal(0, 0.3, (H, 4 * H)).astype(np.float32)
    lengths = rng.integers(1, T + 1, B)
    lengths[0] = T
    mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    dys = rng.normal(0, 1, (T, B, H)).astype(np.float32)
    return xw, mask[:, None, :], wh, dys


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("reverse", [False, True])
def test_save_cell_forward_matches_pallas_interpret(seed, reverse):
    xw, mask, wh, _ = _case(seed)
    ys_j, cs_j = _lstm_fwd_local(jnp.asarray(xw), jnp.asarray(mask),
                                 jnp.asarray(wh), dtype=jnp.float32,
                                 interpret=True, save_cell=True,
                                 reverse=reverse)
    ys, cs = lstm_cuda.lstm_recurrence_ref(
        torch.from_numpy(xw), torch.from_numpy(mask), torch.from_numpy(wh),
        reverse=reverse, save_cell=True)
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), atol=1e-5)
    np.testing.assert_allclose(cs.numpy(), np.asarray(cs_j), atol=1e-5)


@pytest.mark.parametrize("seed", [2, 3])
@pytest.mark.parametrize("reverse", [False, True])
def test_bptt_matches_pallas_interpret(seed, reverse):
    xw, mask, wh, dys = _case(seed)
    args_j = [jnp.asarray(a) for a in (xw, mask, wh)]
    ys_j, cs_j = _lstm_fwd_local(*args_j, dtype=jnp.float32, interpret=True,
                                 save_cell=True, reverse=reverse)
    dxw_j, dwh_j = _lstm_bwd_local(*args_j, ys_j, cs_j, jnp.asarray(dys),
                                   dtype=jnp.float32, interpret=True,
                                   reverse=reverse)
    t = [torch.from_numpy(a) for a in (xw, mask, wh)]
    ys, cs = lstm_cuda.lstm_recurrence_ref(*t, reverse=reverse,
                                           save_cell=True)
    dxw, dwh = lstm_cuda.lstm_bptt_ref(*t, ys, cs, torch.from_numpy(dys),
                                       reverse=reverse)
    assert dxw.dtype == torch.float32 and dwh.shape == wh.shape
    np.testing.assert_allclose(dxw.numpy(), np.asarray(dxw_j), atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(dwh.numpy(), np.asarray(dwh_j), atol=2e-4,
                               rtol=1e-3)


@pytest.mark.parametrize("reverse", [False, True])
def test_function_matches_autograd_through_plain_loop(reverse):
    xw, mask, wh, dys = _case(4, T=7, B=4, H=6)
    grads = []
    for fn in (lstm_cuda.lstm_recurrence, lstm_cuda.lstm_recurrence_ref):
        x = torch.tensor(xw, requires_grad=True)
        w = torch.tensor(wh, requires_grad=True)
        ys = fn(x, torch.from_numpy(mask), w, reverse=reverse)
        (ys * torch.from_numpy(dys)).sum().backward()
        grads.append((x.grad, w.grad))
    torch.testing.assert_close(grads[0][0], grads[1][0], atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(grads[0][1], grads[1][1], atol=1e-6, rtol=1e-5)


def test_bf16_streams_close_to_f32_oracle():
    xw, mask, wh, dys = _case(5)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.tensor(xw).to(dt).requires_grad_(True)
        w = torch.tensor(wh, requires_grad=True)
        ys_f, ys_b = lstm_cuda.blstm_recurrence(x, x, torch.from_numpy(mask),
                                                w, w, dtype=dt)
        d = torch.from_numpy(dys).to(dt)
        ((ys_f * d).float().sum() + (ys_b * d).float().sum()).backward()
        assert x.grad.dtype == dt and w.grad.dtype == torch.float32
        out[dt] = (ys_f.float(), x.grad.float(), w.grad)
    for a, b in zip(out[torch.bfloat16], out[torch.float32]):
        scale = max(1.0, b.abs().max().item())
        assert (a - b).abs().max().item() <= 3e-2 * scale


def test_stack_gradient_matches_pallas_interpret_layer():
    """dL/d(x, wx, wh, b) of one BLSTM layer in the port's stack (kernel
    path semantics, plain versions on the CPU) against jax.grad through
    ``lstm_layer_pallas(interpret=True)``."""
    import jax

    rng = np.random.default_rng(6)
    B, T, D, H = 3, 8, 6, 5
    x = rng.normal(0, 1, (B, T, D)).astype(np.float32)
    lengths = np.array([8, 5, 2])
    fm = np.arange(T)[None, :] < lengths[:, None]
    wx = rng.normal(0, 0.3, (D, 4 * H)).astype(np.float32)
    wh = rng.normal(0, 0.3, (H, 4 * H)).astype(np.float32)
    b = rng.normal(0, 0.1, (4 * H,)).astype(np.float32)
    cot = rng.normal(0, 1, (B, T, 2 * H)).astype(np.float32)

    def jax_loss(x_, wx_, wh_, b_):
        f = lstm_layer_pallas(x_, jnp.asarray(fm), wx_, wh_, b_,
                              interpret=True)
        r = lstm_layer_pallas(x_, jnp.asarray(fm), wx_ * 0.5, wh_ * 0.5,
                              b_, reverse=True, interpret=True)
        return jnp.sum(jnp.concatenate([f, r], -1) * cot)

    ref = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, wx, wh, b)))

    stack = BLSTMStack(D, hidden=H, layers=1, impl="pallas_interpret")
    with torch.no_grad():
        stack.l0_fwd_wx.copy_(torch.from_numpy(wx))
        stack.l0_fwd_wh.copy_(torch.from_numpy(wh))
        stack.l0_fwd_b.copy_(torch.from_numpy(b))
        stack.l0_bwd_wx.copy_(torch.from_numpy(wx) * 0.5)
        stack.l0_bwd_wh.copy_(torch.from_numpy(wh) * 0.5)
        stack.l0_bwd_b.copy_(torch.from_numpy(b))
    xt = torch.tensor(x, requires_grad=True)
    out = stack(xt, torch.from_numpy(fm), torch.float32)
    (out * torch.from_numpy(cot)).sum().backward()
    got = (xt.grad, stack.l0_fwd_wx.grad + 0.5 * stack.l0_bwd_wx.grad,
           stack.l0_fwd_wh.grad + 0.5 * stack.l0_bwd_wh.grad,
           stack.l0_fwd_b.grad + stack.l0_bwd_b.grad)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-4,
                                   rtol=1e-3)


_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.mark.parametrize("stream,compute", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("reverse", [False, True])
def test_dwh_yardstick_is_the_kernels_function(stream, compute, reverse):
    """The one-product form ``chip_smoke.dwh_one_product`` times beside
    the ``lstm_dwh`` kernel (one ``torch.mm`` over the (T-1)*B rows at a
    one-frame offset, operands rounded to the compute dtype, f32 sums)
    equals the plain ``lstm_dwh_ref`` and the dwh of ``_bwd_kernel`` /
    ``_bwd_kernel_rev`` in interpret mode, for each stream/compute pair."""
    import chip_smoke

    xw, mask, wh, dys = _case(7)
    args_j = [jnp.asarray(xw).astype(_JDT[stream]), jnp.asarray(mask),
              jnp.asarray(wh).astype(_JDT[compute])]
    ys_j, cs_j = _lstm_fwd_local(*args_j, dtype=_JDT[compute], interpret=True,
                                 save_cell=True, reverse=reverse)
    dxw_j, dwh_j = _lstm_bwd_local(
        *args_j, ys_j, cs_j, jnp.asarray(dys).astype(_JDT[stream]),
        dtype=_JDT[compute], interpret=True, reverse=reverse)
    ys, dxw = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(stream)
               for a in (ys_j, dxw_j))
    got = chip_smoke.dwh_one_product(ys, dxw, reverse, compute)
    assert got.dtype == torch.float32 and got.shape == wh.shape
    ref = lstm_cuda.lstm_dwh_ref(ys, dxw, reverse=reverse, dtype=compute)
    # the same products, summed in another order
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(dwh_j), atol=2e-4,
                               rtol=1e-3)


# bf16 stream or compute dtype: the two frameworks round at the same points
# (lstm_bptt_ref follows _bptt_frame), but a stored bf16 dxw element may
# land one ulp apart where the f32 sums before the rounding differ in
# their last bits; one ulp of the largest element is 2**-8 of the
# tensor's largest magnitude (read: dxw 2.7e-5, dwh 1.3e-5 over seeds
# 8-11, both directions, all four pairs)
_BF16_JAX_REL = 2.0 ** -8


def _jax_bptt(seed, stream, compute, reverse, shape=None):
    """The JAX kernels' forward and BPTT in interpret mode, and the same
    inputs (the JAX saved states included) as torch tensors; ``shape``
    (T, B, H), else ``_case``'s."""
    xw, mask, wh, dys = _case(seed, *(shape or ()))
    args_j = [jnp.asarray(xw).astype(_JDT[stream]), jnp.asarray(mask),
              jnp.asarray(wh).astype(_JDT[compute])]
    ys_j, cs_j = _lstm_fwd_local(*args_j, dtype=_JDT[compute], interpret=True,
                                 save_cell=True, reverse=reverse)
    dys_j = jnp.asarray(dys).astype(_JDT[stream])
    dxw_j, dwh_j = _lstm_bwd_local(*args_j, ys_j, cs_j, dys_j,
                                   dtype=_JDT[compute], interpret=True,
                                   reverse=reverse)

    def t(a, dt):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(dt)

    inputs = (t(args_j[0], stream), torch.from_numpy(mask),
              t(args_j[2], compute), t(ys_j, stream), t(cs_j, stream),
              t(dys_j, stream))
    return inputs, t(dxw_j, torch.float32), t(dwh_j, torch.float32)


_PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)]
# (stream, compute, shape): each pair at _case's shape, then the f32-weight
# pairs at the shapes only their kernels served until bf16 weights above
# H=512 went to them too, H above 512 and T = 1 (no frame has a
# predecessor), and the bf16-weight pairs above H=512 (on the card the
# wide gate GEMM and dwh around lstm_bwd_tc), at H=520 and at H=1000, the
# H of F2's timed shape, and at B=33, one row past lstm_bwd_tc's 32-row
# tile
_BPTT_CASES = [pytest.param(s, c, None, id=f"stream{i}-compute{i}")
               for i, (s, c) in enumerate(_PAIRS)] + [
    pytest.param(s, c, shape, id=f"{name}-T{shape[0]}-B{shape[1]}-H{shape[2]}")
    for s, c, name in ((torch.float32, torch.float32, "f32-f32"),
                       (torch.bfloat16, torch.float32, "bf16-f32"))
    for shape in ((4, 3, 520), (1, 5, 8))] + [
    pytest.param(s, c, shape, id=f"{name}-T{shape[0]}-B{shape[1]}-H{shape[2]}")
    for s, c, name in ((torch.bfloat16, torch.bfloat16, "bf16-bf16"),
                       (torch.float32, torch.bfloat16, "f32-bf16"))
    for shape in ((4, 3, 520), (3, 2, 1000), (2, 33, 520))]


# Shapes whose dwh is held to JAX's through dxw: at T=3, B=2, H=1000 a
# bf16 dxw element that rounds one ulp apart in the last frame of the
# walk moves dh by 4000 products, and the next frame's elements follow
# (seed 8, forward: 13% of frame 0's elements differ, dxw within 2.96e-3 of
# its largest magnitude, under 2**-8). dwh there is two rank-one terms (one
# row valid), so that gap reaches 6.04e-3 of dwh's largest magnitude,
# about twice dxw's. So dwh must lie within what dxw's gap carries through
# the product, sum_r |ys_r|^T |dxw_r - dxw_jax_r| at the one-frame offset
# (operands rounded to the compute dtype), plus 1e-5 of its largest
# magnitude for the f32 sums' order.
_DWH_BY_PROPAGATION = {(3, 2, 1000)}


@pytest.mark.parametrize("stream,compute,shape", _BPTT_CASES)
@pytest.mark.parametrize("reverse", [False, True])
def test_two_stage_bptt_matches_pallas_interpret(stream, compute, shape,
                                                 reverse):
    """The two-stage ``lstm_bptt_ref`` (every frame's gates at once, then
    the frame loop) against ``_bwd_kernel`` / ``_bwd_kernel_rev`` in
    interpret mode, for each stream/compute pair, ragged masks."""
    for seed in (8, 9):
        (xw, mask, wh, ys, cs, dys), dxw_j, dwh_j = _jax_bptt(
            seed, stream, compute, reverse, shape)
        dxw, dwh = lstm_cuda.lstm_bptt_ref(xw, mask, wh, ys, cs, dys,
                                           reverse=reverse, dtype=compute)
        assert dxw.dtype == stream and dwh.dtype == torch.float32
        if stream == compute == torch.float32:
            np.testing.assert_allclose(dxw.numpy(), dxw_j.numpy(), atol=2e-4,
                                       rtol=1e-3)
            np.testing.assert_allclose(dwh.numpy(), dwh_j.numpy(), atol=2e-4,
                                       rtol=1e-3)
        elif shape in _DWH_BY_PROPAGATION:
            err = (dxw.float() - dxw_j).abs().max() / dxw_j.abs().max()
            assert err.item() <= _BF16_JAX_REL, err.item()
            # the product's operands, rounded to the compute dtype
            carried = lstm_cuda.lstm_dwh_ref(
                ys.to(compute).float().abs(),
                (dxw.to(compute).float() - dxw_j.to(compute).float()).abs(),
                reverse=reverse)
            gap = (dwh - dwh_j).abs() - carried
            assert gap.max().item() <= 1e-5 * dwh_j.abs().max().item()
        else:
            for got, ref in ((dxw.float(), dxw_j), (dwh, dwh_j)):
                if not ref.abs().max().item():  # T = 1: no dwh terms at all
                    assert not got.abs().max().item()
                    continue
                err = (got - ref).abs().max() / ref.abs().max()
                assert err.item() <= _BF16_JAX_REL, err.item()


@pytest.mark.parametrize("stream,compute,shape", _BPTT_CASES)
@pytest.mark.parametrize("reverse", [False, True])
def test_gates_yardstick_is_the_kernels_function(stream, compute, shape,
                                                 reverse):
    """``bptt_gates_ref`` (the function of the ``bptt_gates_gemm``
    kernel) equals the gates that the frame-by-frame loop recomputes,
    f32(xw[t]) + round(ys[tp]) @ round(wh) with zeros at the edge, and
    the one-product form ``chip_smoke.gates_one_product`` times beside
    the kernel."""
    import chip_smoke

    (xw, mask, wh, ys, _, _), _, _ = _jax_bptt(7, stream, compute, reverse,
                                               shape)
    pre = lstm_cuda.bptt_gates_ref(xw, ys, wh, reverse=reverse, dtype=compute)
    T = xw.shape[0]
    w = wh.to(compute).float()
    for t in range(T):
        tp = t + 1 if reverse else t - 1
        h = (ys[tp].to(compute).float() if 0 <= tp < T
             else torch.zeros_like(ys[0], dtype=torch.float32))
        torch.testing.assert_close(pre[t], xw[t].float() + h @ w, atol=1e-6,
                                   rtol=1e-6)
    edge = T - 1 if reverse else 0
    assert torch.equal(pre[edge], xw[edge].float())
    got = chip_smoke.gates_one_product(xw, ys, wh, reverse, compute)
    assert got.dtype == torch.float32 and got.shape == pre.shape
    # the same products, summed in another order
    torch.testing.assert_close(got, pre, atol=1e-5, rtol=1e-5)


def test_loop_designs_follow_the_kernels_codes():
    """``LOOP_DESIGNS`` names the frame loops in the order of their codes
    in csrc/lstm_bwd.cu (``vo_lstm_bwd_named``'s ``loop``)."""
    import os
    import re

    path = os.path.join(os.path.dirname(lstm_cuda.__file__), "..", "csrc",
                        "lstm_bwd.cu")
    with open(path) as f:
        codes = re.findall(r"constexpr int LOOP_([A-Z]+) = (\d+);", f.read())
    assert [n.lower() for n, _ in sorted(codes, key=lambda c: int(c[1]))] == (
        list(lstm_cuda.LOOP_DESIGNS))


@pytest.mark.parametrize("kw,match", [
    ({"loop": "frames"}, "unknown frame loop"),
    ({"loop": "Rows"}, "unknown frame loop"),
    ({"loop": "tc", "dtype": torch.float32}, "bf16 weights only"),
    ({"loop": "persistent", "dtype": torch.float32}, "bf16 weights only"),
])
def test_bptt_frames_refuses_a_bad_loop_before_building(kw, match,
                                                        monkeypatch):
    """``lstm_bptt_frames`` refuses a frame loop it cannot name (or one
    that takes bf16 weights only, named for f32 weights) before it builds
    or loads a kernel."""
    from vistaocr_tpu_torch.ops import _build

    def no_build():
        raise AssertionError("the kernels were built")

    monkeypatch.setattr(_build, "load", no_build)
    kw = dict(kw)
    dtype = kw.pop("dtype", torch.bfloat16)
    T, B, H = 2, 3, 8
    dirs = [(torch.zeros(T, B, 4 * H), torch.zeros(H, 4 * H, dtype=dtype),
             torch.zeros(T, B, H), torch.zeros(T, B, H), torch.zeros(T, B, H),
             False)]
    with pytest.raises(ValueError, match=match):
        lstm_cuda.lstm_bptt_frames(dirs, torch.ones(T, 1, B), dtype, **kw)


def test_fwd_designs_follow_the_kernels_codes():
    """``FWD_DESIGNS`` names the forward designs in the order of their
    codes in csrc/lstm_fwd.cu (``vo_lstm_fwd_named``'s ``design``)."""
    import os
    import re

    path = os.path.join(os.path.dirname(lstm_cuda.__file__), "..", "csrc",
                        "lstm_fwd.cu")
    with open(path) as f:
        codes = re.findall(r"constexpr int FWD_([A-Z]+) = (\d+);", f.read())
    assert [n.lower() for n, _ in sorted(codes, key=lambda c: int(c[1]))] == (
        list(lstm_cuda.FWD_DESIGNS))


def _no_build(monkeypatch):
    from vistaocr_tpu_torch.ops import _build

    def no_build():
        raise AssertionError("the kernels were built")

    monkeypatch.setattr(_build, "load", no_build)


@pytest.mark.parametrize("design,match", [
    ("wide", "unknown forward design"),
    ("Rows", "unknown forward design"),
    ("tc", "bf16 weights only"),
    ("persistent", "bf16 weights only"),
])
def test_lstm_fwd_refuses_a_bad_design_before_building(design, match,
                                                       monkeypatch):
    """``lstm_fwd`` refuses a design it cannot name, or one that takes
    bf16 weights only named for f32 weights, before it builds or loads a
    kernel."""
    _no_build(monkeypatch)
    T, B, H = 2, 3, 8
    dirs = [(torch.zeros(T, B, 4 * H), torch.zeros(H, 4 * H), False)]
    with pytest.raises(ValueError, match=match):
        lstm_cuda.lstm_fwd(dirs, torch.ones(T, 1, B), torch.float32,
                           design=design)


@pytest.mark.parametrize("design", ["rows", "grid", "step"])
def test_lstm_fwd_takes_the_f32_designs_by_name(design, monkeypatch):
    """The f32-weight designs' names pass ``lstm_fwd``'s check: on CPU
    tensors the call gets as far as the device check, and builds
    nothing."""
    _no_build(monkeypatch)
    T, B, H = 2, 3, 8
    dirs = [(torch.zeros(T, B, 4 * H), torch.zeros(H, 4 * H), False)]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        lstm_cuda.lstm_fwd(dirs, torch.ones(T, 1, B), torch.float32,
                           design=design)


@pytest.mark.parametrize("loop", ["rows", "split", "fold"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bptt_frames_takes_the_f32_loops_by_name(loop, dtype, monkeypatch):
    """The f32-weight frame loops' names (``rows`` too, which bf16
    weights take widened) pass ``lstm_bptt_frames``' check for either
    weight type: on CPU tensors the call gets as far as the device check,
    and builds nothing."""
    _no_build(monkeypatch)
    T, B, H = 2, 3, 8
    dirs = [(torch.zeros(T, B, 4 * H), torch.zeros(H, 4 * H, dtype=dtype),
             torch.zeros(T, B, H), torch.zeros(T, B, H), torch.zeros(T, B, H),
             False)]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        lstm_cuda.lstm_bptt_frames(dirs, torch.ones(T, 1, B), dtype,
                                   loop=loop)


# The row counts the f32-weight cooperative designs split on the card
# (lstm_fwd_rows and lstm_bwd_rows: tiles of 32 or 64 rows, spread over
# row groups): B = 70 and 130 end two and four 32-row tiles ragged (a
# 64-row tile too), at a small H and T
_ROW_TILE_SHAPES = [(3, 70, 24), (3, 130, 24)]


@pytest.mark.parametrize("shape", _ROW_TILE_SHAPES,
                         ids=lambda s: f"T{s[0]}-B{s[1]}-H{s[2]}")
@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_plain_versions_match_pallas_interpret_across_row_tiles(
        shape, stream, reverse):
    """The plain versions the card holds lstm_fwd_rows and lstm_bwd_rows
    to: ``lstm_recurrence_ref`` (``save_cell``) against JAX's
    ``_fwd_kernel`` and ``bptt_frames_ref`` (on ``bptt_gates_ref``'s
    gates, from JAX's saved states) against ``_bwd_kernel`` /
    ``_bwd_kernel_rev``, both in interpret mode, f32 weights, ragged
    masks. f32 streams within the bounds above; bf16 streams within one
    stream ulp of each tensor's largest magnitude."""
    for seed in (12, 13):
        (xw, mask, wh, ys_j, cs_j, dys), dxw_j, _ = _jax_bptt(
            seed, stream, torch.float32, reverse, shape)
        ys, cs = lstm_cuda.lstm_recurrence_ref(xw, mask, wh, reverse=reverse,
                                               save_cell=True)
        pre = lstm_cuda.bptt_gates_ref(xw, ys_j, wh, reverse=reverse)
        dxw = lstm_cuda.bptt_frames_ref(pre, mask, wh, cs_j, dys,
                                        reverse=reverse)
        assert ys.dtype == cs.dtype == dxw.dtype == stream
        if stream == torch.float32:
            np.testing.assert_allclose(ys.numpy(), ys_j.numpy(), atol=1e-5)
            np.testing.assert_allclose(cs.numpy(), cs_j.numpy(), atol=1e-5)
            np.testing.assert_allclose(dxw.numpy(), dxw_j.numpy(), atol=2e-4,
                                       rtol=1e-3)
        else:
            for got, ref in ((ys, ys_j), (cs, cs_j), (dxw, dxw_j)):
                ref = ref.float()
                err = (got.float() - ref).abs().max() / ref.abs().max()
                assert err.item() <= _BF16_JAX_REL, err.item()
