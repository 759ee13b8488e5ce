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
from vistaocr_tpu.ops.lstm_pallas import lstm_layer_pallas
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
        xw, mask, wh = self._operands()
        wh.requires_grad_(True)
        with pytest.raises(NotImplementedError):
            lstm_cuda.lstm_recurrence(xw, mask, wh)
        with torch.no_grad():
            lstm_cuda.lstm_recurrence(xw, mask, wh)


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

