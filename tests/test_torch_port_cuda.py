"""Tests of the port that need an NVIDIA GPU: the CUDA LSTM kernel
(csrc/lstm_fwd.cu) against its plain PyTorch version, its launch counter,
and the model and service paths that launch it. Every test is marked
``cuda`` and skips without a card. This file imports no JAX, so it runs
on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -q
"""

import tempfile

import numpy as np
import pytest
import torch

from vistaocr_tpu_torch.ops import lstm_cuda

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


@pytest.mark.parametrize("shape", [(5, 7, 40), (33, 20, 64), (1, 1, 1),
                                   (70, 9, 100)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("reverse", [False, True])
def test_kernel_matches_plain(dev, shape, dtype, tol, reverse):
    B, T, H = shape
    xw, mask, wh = _operands(dev, B, T, H, dtype, seed=B * T + H)
    before = lstm_cuda.LAUNCHES
    with torch.no_grad():
        ys = lstm_cuda.lstm_recurrence(xw, mask, wh, reverse=reverse)
        ref = lstm_cuda.lstm_recurrence_ref(xw, mask, wh, reverse=reverse)
    torch.cuda.synchronize()
    assert lstm_cuda.LAUNCHES == before + 1
    assert ys.dtype == dtype and ys.shape == (T, B, H)
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


def test_both_directions_in_one_launch(dev):
    xw, mask, wh = _operands(dev, 17, 13, 48, torch.float32, seed=5)
    before = lstm_cuda.LAUNCHES
    with torch.no_grad():
        f, r = lstm_cuda.blstm_recurrence(xw, xw * 0.5, mask, wh, wh * 2)
        rf = lstm_cuda.lstm_recurrence_ref(xw, mask, wh)
        rr = lstm_cuda.lstm_recurrence_ref(xw * 0.5, mask, wh * 2,
                                           reverse=True)
    assert lstm_cuda.LAUNCHES == before + 1
    assert (f - rf).abs().max().item() <= 1e-4
    assert (r - rr).abs().max().item() <= 1e-4


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
