"""The port's LSTM recurrence (ops/lstm_cuda.py, models/blstm.py) against
the JAX package: the lax.scan oracle (``models.blstm.lstm_layer``) and the
Pallas kernel in interpret mode (``ops.lstm_pallas.lstm_layer_pallas``).
Same numpy inputs, forward and reverse, ragged masks; f32 within 1e-5
(the JAX kernel's own bound, tests/test_lstm_pallas.py:37-38), bf16
streams against the f32 oracle within 3e-2 (tests/test_lstm_pallas.py:
112-115). On the CPU the wrappers run the plain version; the CUDA
kernel's own tests are in tests/test_torch_port_cuda.py."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from vistaocr_tpu.models.blstm import lstm_layer as jax_lstm_layer
from vistaocr_tpu.ops.lstm_pallas import _lstm_fwd_local, lstm_layer_pallas
from vistaocr_tpu_torch.models.blstm import BLSTMStack, uses_kernel
from vistaocr_tpu_torch.ops import lstm_cuda

torch.set_num_threads(2)


def _case(seed, B=8, T=12, D=16, H=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, T, D)).astype(np.float32)
    wx = rng.normal(0, 0.3, (D, 4 * H)).astype(np.float32)
    wh = rng.normal(0, 0.3, (H, 4 * H)).astype(np.float32)
    b = rng.normal(0, 0.1, (4 * H,)).astype(np.float32)
    lengths = rng.integers(1, T + 1, B)
    lengths[0] = T
    mask = np.arange(T)[None, :] < lengths[:, None]
    return x, mask, wx, wh, b


def _port_layer(x, mask, wx, wh, b, *, reverse, dtype=torch.float32):
    """Port layer on [B, T, *] numpy inputs -> [B, T, H] float32 numpy."""
    xt = torch.from_numpy(x).transpose(0, 1)
    m = torch.from_numpy(mask.T.astype(np.float32))[:, None, :].contiguous()
    with torch.no_grad():
        ys = lstm_cuda.lstm_layer(
            xt, m, torch.from_numpy(wx), torch.from_numpy(wh),
            torch.from_numpy(b), reverse=reverse, dtype=dtype)
    assert ys.dtype == dtype
    return ys.transpose(0, 1).to(torch.float32).numpy()


class TestAgainstJax:
    @pytest.mark.parametrize("seed", [0, 1])
    @pytest.mark.parametrize("reverse", [False, True])
    def test_matches_scan_oracle(self, seed, reverse):
        x, mask, wx, wh, b = _case(seed)
        ref = jax_lstm_layer(*map(jnp.asarray, (x, mask, wx, wh, b)),
                             reverse=reverse)
        ours = _port_layer(x, mask, wx, wh, b, reverse=reverse)
        np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)

    @pytest.mark.parametrize("seed", [2, 3])
    @pytest.mark.parametrize("reverse", [False, True])
    def test_matches_pallas_interpret(self, seed, reverse):
        x, mask, wx, wh, b = _case(seed, B=5, T=9, D=12, H=8)
        ref = lstm_layer_pallas(*map(jnp.asarray, (x, mask, wx, wh, b)),
                                reverse=reverse, interpret=True)
        ours = _port_layer(x, mask, wx, wh, b, reverse=reverse)
        np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)

    @pytest.mark.parametrize("reverse", [False, True])
    def test_bf16_stream_close_to_f32_oracle(self, reverse):
        x, mask, wx, wh, b = _case(0)
        ref = jax_lstm_layer(*map(jnp.asarray, (x, mask, wx, wh, b)),
                             reverse=reverse)
        ours = _port_layer(x, mask, wx, wh, b, reverse=reverse,
                           dtype=torch.bfloat16)
        np.testing.assert_allclose(ours, np.asarray(ref), atol=3e-2,
                                   rtol=3e-2)

    def test_full_mask(self):
        x, _, wx, wh, b = _case(3)
        mask = np.ones(x.shape[:2], bool)
        ref = jax_lstm_layer(*map(jnp.asarray, (x, mask, wx, wh, b)))
        ours = _port_layer(x, mask, wx, wh, b, reverse=False)
        np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)


class TestOracleAtCardEdges:
    """The plain f32 forward, which the card tests hold the f32 grid kernel
    to, pinned to the JAX Pallas kernel (interpret mode) at the card tests'
    edge shapes: a batch one row past a 32-row tile with H past 512 (65
    CTAs a direction, the contraction padded to 640), and a small odd
    shape; both forms, both directions, the same numpy-seeded operands."""

    @pytest.mark.parametrize("B,T,H", [(33, 7, 520), (5, 7, 40)])
    @pytest.mark.parametrize("reverse", [False, True])
    @pytest.mark.parametrize("save_cell", [False, True])
    def test_plain_forward_matches_pallas_interpret(self, B, T, H, reverse,
                                                     save_cell):
        rng = np.random.default_rng(B * H + T)
        xw = rng.normal(0, 1, (T, B, 4 * H)).astype(np.float32)
        wh = rng.normal(0, 1 / np.sqrt(H), (H, 4 * H)).astype(np.float32)
        lengths = rng.integers(1, T + 1, B)
        lengths[0] = T
        mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
        mask = mask[:, None, :]
        ys_j, cs_j = _lstm_fwd_local(
            jnp.asarray(xw), jnp.asarray(mask), jnp.asarray(wh),
            dtype=jnp.float32, interpret=True, save_cell=save_cell,
            reverse=reverse)
        with torch.no_grad():
            out = lstm_cuda.lstm_recurrence_ref(
                torch.from_numpy(xw), torch.from_numpy(mask),
                torch.from_numpy(wh), reverse=reverse, dtype=torch.float32,
                save_cell=save_cell)
        ys, cs = out if save_cell else (out, None)
        np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), atol=1e-5,
                                   rtol=1e-5)
        if save_cell:
            np.testing.assert_allclose(cs.numpy(), np.asarray(cs_j),
                                       atol=1e-5, rtol=1e-5)
        else:
            assert cs_j is None

    @pytest.mark.parametrize("stream", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("reverse", [False, True])
    def test_plain_bf16_forward_matches_pallas_interpret(self, stream,
                                                          reverse):
        """bf16 weights above H=512 (type codes 1 and 2, which the card
        runs on the f32-weight kernels with h rounded to bf16): the plain
        save_cell forward against the Pallas kernel within the bf16 bound
        of this file (3e-2)."""
        B, T, H = 33, 7, 520
        rng = np.random.default_rng(B * H + T + 1)
        xw = rng.normal(0, 1, (T, B, 4 * H)).astype(np.float32)
        wh = rng.normal(0, 1 / np.sqrt(H), (H, 4 * H)).astype(np.float32)
        lengths = rng.integers(1, T + 1, B)
        lengths[0] = T
        mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
        mask = mask[:, None, :]
        jdt = jnp.bfloat16 if stream == torch.bfloat16 else jnp.float32
        ys_j, cs_j = _lstm_fwd_local(
            jnp.asarray(xw).astype(jdt), jnp.asarray(mask),
            jnp.asarray(wh).astype(jnp.bfloat16), dtype=jnp.bfloat16,
            interpret=True, save_cell=True, reverse=reverse)
        with torch.no_grad():
            ys, cs = lstm_cuda.lstm_recurrence_ref(
                torch.from_numpy(xw).to(stream), torch.from_numpy(mask),
                torch.from_numpy(wh).to(torch.bfloat16), reverse=reverse,
                dtype=torch.bfloat16, save_cell=True)
        assert ys.dtype == cs.dtype == stream
        for ours, ref in ((ys, ys_j), (cs, cs_j)):
            np.testing.assert_allclose(ours.float().numpy(),
                                       np.asarray(ref.astype(jnp.float32)),
                                       atol=3e-2, rtol=3e-2)


class TestWrapper:
    def _operands(self, T=6, B=3, H=5):
        rng = np.random.default_rng(0)
        xw = torch.from_numpy(rng.normal(0, 1, (T, B, 4 * H)).astype(np.float32))
        wh = torch.from_numpy(rng.normal(0, 0.3, (H, 4 * H)).astype(np.float32))
        mask = torch.ones((T, 1, B), dtype=torch.float32)
        return xw, mask, wh

    def test_cpu_tensor_runs_plain_and_leaves_launches(self):
        lstm_cuda.LAUNCHES = 0
        xw, mask, wh = self._operands()
        with torch.no_grad():
            ys = lstm_cuda.lstm_recurrence(xw, mask, wh, reverse=True)
            ref = lstm_cuda.lstm_recurrence_ref(xw, mask, wh, reverse=True)
            pair = lstm_cuda.blstm_recurrence(xw, xw, mask, wh, wh)
        assert lstm_cuda.LAUNCHES == 0
        assert torch.equal(ys, ref)
        assert torch.equal(pair[1], ref)

    def test_bidirectional_equals_two_single_directions(self):
        xw, mask, wh = self._operands()
        mask[4:, :, 1] = 0.0
        with torch.no_grad():
            f, r = lstm_cuda.blstm_recurrence(xw, xw * 0.5, mask, wh, wh * 2)
            f1 = lstm_cuda.lstm_recurrence(xw, mask, wh, reverse=False)
            r1 = lstm_cuda.lstm_recurrence(xw * 0.5, mask, wh * 2,
                                           reverse=True)
        assert torch.equal(f, f1) and torch.equal(r, r1)

    def test_masked_frames_freeze_the_carry(self):
        xw, mask, wh = self._operands()
        mask[3:, :, 2] = 0.0
        ys = lstm_cuda.lstm_recurrence(xw, mask, wh)
        for t in range(3, ys.shape[0]):
            assert torch.equal(ys[t, 2], ys[2, 2])
        # reverse: frames past the sample's end keep the zero initial state
        ys_r = lstm_cuda.lstm_recurrence(xw, mask, wh, reverse=True)
        assert torch.count_nonzero(ys_r[3:, 2]) == 0

    @pytest.mark.parametrize("bad", ["xw_rank", "wh_shape", "mask_shape",
                                     "mask_dtype", "dtype"])
    def test_rejects_what_the_kernel_does_not_take(self, bad):
        xw, mask, wh = self._operands()
        kw = {}
        if bad == "xw_rank":
            xw = xw[0]
        elif bad == "wh_shape":
            wh = wh[:, :-4]
        elif bad == "mask_shape":
            mask = mask[:, 0]
        elif bad == "mask_dtype":
            mask = mask.to(torch.float64)
        else:
            kw["dtype"] = torch.float16
        with pytest.raises((ValueError, TypeError)):
            lstm_cuda.lstm_recurrence(xw, mask, wh, **kw)

    def test_raises_when_a_gradient_would_be_needed(self):
        """Once the wrapper raised where autograd needed a gradient; now
        the gradient flows (the BPTT behind ``BLstmRecurrence``) and
        matches autograd through the plain loop, and no_grad keeps the
        inference form."""
        xw, mask, wh = self._operands()
        xw.requires_grad_(True)
        wh.requires_grad_(True)
        lstm_cuda.lstm_recurrence(xw, mask, wh).sum().backward()
        got = (xw.grad.clone(), wh.grad.clone())
        xw.grad = wh.grad = None
        lstm_cuda.lstm_recurrence_ref(xw, mask, wh).sum().backward()
        torch.testing.assert_close(got[0], xw.grad, atol=1e-6, rtol=1e-5)
        torch.testing.assert_close(got[1], wh.grad, atol=1e-6, rtol=1e-5)
        with torch.no_grad():
            assert not lstm_cuda.lstm_recurrence(xw, mask, wh).requires_grad


class TestImplSwitch:
    def test_auto_is_plain_on_cpu_kernel_on_cuda(self):
        assert not uses_kernel("auto", torch.device("cpu"))
        assert uses_kernel("auto", torch.device("cuda"))
        assert not uses_kernel("scan", torch.device("cuda"))
        assert not uses_kernel("pallas_interpret", torch.device("cuda"))

    def test_pallas_on_cpu_raises(self):
        stack = BLSTMStack(8, hidden=4, layers=1, impl="pallas")
        x = torch.zeros((2, 5, 8))
        fm = torch.ones((2, 5), dtype=torch.bool)
        with torch.no_grad(), pytest.raises(RuntimeError):
            stack(x, fm, torch.float32)

    def test_unknown_impl_raises(self):
        with pytest.raises(ValueError):
            BLSTMStack(8, hidden=4, layers=1, impl="cudnn")



def test_profile_script_finds_its_anchors_in_the_kernel():
    """profile_lstm_fwd.py places its clock64 stamps in a copy of
    csrc/lstm_fwd.cu by text anchors: each must be found exactly once in
    the kernel as it stands (a kernel edit that moves one fails here, not
    on the card)."""
    import os

    import profile_lstm_fwd

    path = os.path.join(os.path.dirname(lstm_cuda.__file__), "..", "csrc",
                        "lstm_fwd.cu")
    with open(path) as f:
        src = profile_lstm_fwd.instrumented_source(f.read())
    assert src.count("P[") >= len(profile_lstm_fwd.PHASES)
    assert "vo_prof_read" in src


@pytest.mark.parametrize("variant", ["lds_once", "fma_eighth", "neither"])
def test_dwh_profile_script_finds_its_anchors_in_the_kernel(variant):
    """profile_lstm_dwh_fma.py cuts work out of copies of csrc/lstm_bwd.cu
    by text anchors: each must be found exactly once in the kernel as it
    stands, and each copy must differ from it."""
    import os

    import profile_lstm_dwh_fma

    path = os.path.join(os.path.dirname(lstm_cuda.__file__), "..", "csrc",
                        "lstm_bwd.cu")
    with open(path) as f:
        src = f.read()
    cut = profile_lstm_dwh_fma.variant_source(src, variant)
    assert cut != src
    assert profile_lstm_dwh_fma.variant_source(src, "full") == src


@pytest.mark.parametrize("variant", ["no_multicast", "release_cluster",
                                     "tiny_dg_copies", "half_dg_copies",
                                     "clusters_of_four", "stamps"])
def test_bwd_tc_profile_script_finds_its_anchors_in_the_kernel(variant):
    """profile_lstm_bwd_tc.py edits copies of csrc/lstm_bwd.cu by text
    anchors: each must be found exactly once in the kernel as it stands,
    and each copy must differ from it."""
    import os

    import profile_lstm_bwd_tc

    path = os.path.join(os.path.dirname(lstm_cuda.__file__), "..", "csrc",
                        "lstm_bwd.cu")
    with open(path) as f:
        src = f.read()
    assert profile_lstm_bwd_tc.variant_source(src, variant) != src
    assert profile_lstm_bwd_tc.variant_source(src, "full") == src


@pytest.mark.parametrize("variant", ["no_exchange", "no_sum", "no_product",
                                     "no_epilogue", "stamps", "rows_32",
                                     "rows_16", "rows_8"])
def test_bwd_persistent_profile_script_finds_its_anchors_in_the_kernel(
        variant):
    """profile_lstm_bwd_persistent.py edits copies of csrc/lstm_bwd.cu by
    text anchors: one of each variant's recipes must find its anchors
    exactly once in the kernel as it stands, and each copy must differ from
    the kernel with the profile's plan query alone (the ``full`` copy)."""
    import os

    import profile_lstm_bwd_persistent as prof

    path = os.path.join(os.path.dirname(lstm_cuda.__file__), "..", "csrc",
                        "lstm_bwd.cu")
    with open(path) as f:
        src = f.read()
    full = prof.variant_source(src, "full")
    assert full != src and "vo_prof_plan" in full
    assert prof.variant_source(src, variant) != full


@pytest.mark.parametrize("key", [f"{f}:{v}" for f, v in __import__(
    "profile_lstm_f32_wide").VARIANTS])
def test_f32_wide_profile_script_finds_its_anchors_in_the_kernels(key):
    """profile_lstm_f32_wide.py edits copies of csrc/lstm_fwd.cu and
    csrc/lstm_bwd.cu by text anchors: each must be found exactly once in
    the kernel as it stands, and each copy must differ from it."""
    import os

    import profile_lstm_f32_wide as prof

    name, variant = key.split(":")
    path = os.path.join(os.path.dirname(lstm_cuda.__file__), "..", "csrc",
                        name)
    with open(path) as f:
        src = f.read()
    assert prof.variant_source(src, prof.VARIANTS[(name, variant)]) != src
