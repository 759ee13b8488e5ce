"""Tests of the port that need an NVIDIA GPU: the CUDA kernels
(csrc/lstm_fwd.cu in both forms, csrc/lstm_bwd.cu's BPTT and dwh,
csrc/ctc.cu's alpha/beta) against their plain PyTorch versions, including
ragged B/H edges, T = 1, empty labels and an infeasible CTC sample; their
launch counters; the autograd Functions' backward on the card; and the
model and service paths that launch them. Every test is marked
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


@pytest.mark.parametrize("shape", [(5, 7, 40), (33, 20, 64), (1, 1, 1),
                                   (70, 1, 100), (3, 9, 17)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_save_cell_matches_plain_and_inference(dev, shape, dtype):
    B, T, H = shape
    xw, mask, wh = _operands(dev, B, T, H, dtype, seed=B + T + H)
    xw2, _, wh2 = _operands(dev, B, T, H, dtype, seed=B + T + H + 1)
    before = (lstm_cuda.LAUNCHES, lstm_cuda.SAVE_CELL_LAUNCHES)
    with torch.no_grad():
        (ys_f, cs_f), (ys_b, cs_b) = lstm_cuda.lstm_forward_cells(
            [(xw, wh, False), (xw2, wh2, True)], mask, dtype)
        inf_f, inf_b = lstm_cuda.blstm_recurrence(xw, xw2, mask, wh, wh2)
        ref = [lstm_cuda.lstm_recurrence_ref(x, mask, w, reverse=r,
                                             save_cell=True)
               for x, w, r in ((xw, wh, False), (xw2, wh2, True))]
    torch.cuda.synchronize()
    assert lstm_cuda.SAVE_CELL_LAUNCHES == before[1] + 1
    assert lstm_cuda.LAUNCHES == before[0] + 2
    assert torch.equal(ys_f, inf_f) and torch.equal(ys_b, inf_b)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for (ys, cs), (rys, rcs) in zip(((ys_f, cs_f), (ys_b, cs_b)), ref):
        assert cs.dtype == dtype and cs.shape == (T, B, H)
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


def test_autograd_backward_on_cuda_matches_plain_bptt(dev):
    B, T, H = 6, 11, 24
    dirs, mask = _bptt_operands(dev, B, T, H, torch.float32, seed=4)
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
        torch.testing.assert_close(x.grad, rdx, atol=2e-4, rtol=1e-3)
        torch.testing.assert_close(w.grad, rdw, atol=2e-4, rtol=1e-3)


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


@pytest.mark.parametrize("shape", [(5, 20, 9, 6), (1, 1, 4, 1), (7, 33, 12, 15),
                                   (3, 64, 96, 255)])
def test_ctc_kernels_match_plain(dev, shape):
    from vistaocr_tpu_torch.ops import ctc_cuda

    B, T, K, L = shape
    lp, il, labels, ll = _ctc_case(dev, B, T, K, L, seed=T + L,
                                   infeasible=True)
    lp_ext, skip, active, islast = ctc_cuda._prepare(lp, il, labels, 0)
    svalid, terminal = ctc_cuda._state_masks(ll, lp_ext.shape[2])
    before = (ctc_cuda.ALPHA_LAUNCHES, ctc_cuda.BETA_LAUNCHES)
    alphas = ctc_cuda.ctc_alpha(lp_ext, active, skip, svalid)
    ref_a = ctc_cuda.ctc_alpha_ref(lp_ext, active, skip, svalid)
    logp = ctc_cuda._loss_from_alphas(ref_a, il, ll)
    skip2 = torch.cat([skip[:, 2:], torch.zeros_like(skip[:, :2])], 1)
    dlp = ctc_cuda.ctc_beta(lp_ext, active, islast, skip2.contiguous(),
                            svalid, terminal, ref_a, logp)
    ref_d = ctc_cuda.ctc_beta_ref(lp_ext, active, islast, skip2, svalid,
                                  terminal, ref_a, logp)
    torch.cuda.synchronize()
    assert ctc_cuda.ALPHA_LAUNCHES == before[0] + 1
    assert ctc_cuda.BETA_LAUNCHES == before[1] + 1
    valid = svalid[None].expand_as(alphas) > 0
    reach = ref_a > -1e29
    assert torch.equal(alphas > -1e29, reach)
    torch.testing.assert_close(alphas[reach & valid], ref_a[reach & valid],
                               atol=2e-5, rtol=1e-5)
    torch.testing.assert_close(dlp, ref_d, atol=2e-5, rtol=1e-5)


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
