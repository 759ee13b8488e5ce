"""The port's experiments (vistaocr_tpu_torch/experiments/) against the
JAX package's quarantined experiments in interpret mode, on the CPU:

- the fused stem (``stem_cuda``) against ``experiments/stem_pallas.py``:
  out and xn within atol/rtol 2e-5 (experiments/test_stem_pallas.py:47),
  dK within atol 2e-4, rtol 1e-4 (:58), the narrow-width masking case, bf16
  within 3e-2 of the f32 oracle;
- the direction-stacked BLSTM (``lstm_bi_stacked``) against
  ``experiments/lstm_bi_stacked.py``: ys and cs within 1e-5 of
  ``_bi_lstm_fwd(interpret=True)`` and of two ``lstm_layer`` scans, the
  plain BPTT against ``_bi_lstm_bwd(interpret=True)``, gradients of all
  seven layer inputs within atol 3e-4, rtol 1e-3
  (experiments/test_lstm_bi_stacked.py:79);
- the plain backward versions against torch autograd through the plain
  forwards, the kernel wrappers' refusal of CPU tensors, and the flagship
  forward with both experiments against the JAX model and the port's;
- the stacked layout as the layer's two directions (``bi.bi_planes``:
  plane views, a mask a plane, ``reverse=False``; what the card's entries
  run on the layer's kernels) through the layer's plain versions
  (``lstm_recurrence_ref``, ``lstm_bptt_ref``, ``lstm_dwh_ref``), against
  the stacked plain versions and the JAX K6 kernels in interpret mode;
- chip_smoke.py's device-beam tie check (``beam_tie``) on CPU-built
  posteriors: an exact tie of two one-character prefixes is accepted, a
  1e-3 gap refused.

``experiments/lstm_bi_stacked.py`` does not parse as it stands: its line
25 is a banner fragment without its comment sign. The loader below reads
the source, turns that one line into a comment in memory and compiles it
under the file's own name; the file itself is not changed. The CUDA
kernels' own tests are in tests/test_torch_port_cuda.py.
"""

import dataclasses
import pathlib
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vistaocr_tpu.models import CnnLstmOcr as JaxModel
from vistaocr_tpu.models import ModelConfig as JaxConfig
from vistaocr_tpu.models.blstm import lstm_layer
from vistaocr_tpu.models.cnn import ConvStageSpec as JaxStage
from vistaocr_tpu_torch.checkpoint import state_dict_to_variables
from vistaocr_tpu_torch.experiments import lstm_bi_stacked as bi
from vistaocr_tpu_torch.experiments import stem_cuda
from vistaocr_tpu_torch.experiments.flagship import forward_with_experiments
from vistaocr_tpu_torch.models import (CnnLstmOcr, ConvStageSpec, ModelConfig,
                                       init_parameters)
from vistaocr_tpu_torch.ops.preprocess import preprocess_images

torch.set_num_threads(2)

EXPERIMENTS = pathlib.Path(__file__).resolve().parents[1] / "experiments"
BROKEN_LINE = ": both directions of one layer\n"


def _load_reference(name: str) -> types.ModuleType:
    """Load experiments/<name>.py as a module, with the one broken line of
    lstm_bi_stacked.py turned into a comment in memory."""
    path = EXPERIMENTS / f"{name}.py"
    lines = path.read_text().splitlines(keepends=True)
    lines = [("# " + ln) if ln == BROKEN_LINE else ln for ln in lines]
    mod = types.ModuleType(f"_reference_{name}")
    mod.__file__ = str(path)
    exec(compile("".join(lines), str(path), "exec"), mod.__dict__)
    return mod


@pytest.fixture(scope="module")
def ref_stem():
    return _load_reference("stem_pallas")


@pytest.fixture(scope="module")
def ref_bi():
    return _load_reference("lstm_bi_stacked")


def test_reference_fault_is_neutralised_in_memory_only(ref_bi):
    src = (EXPERIMENTS / "lstm_bi_stacked.py").read_text()
    assert src.splitlines(keepends=True)[24] == BROKEN_LINE
    with pytest.raises(SyntaxError):
        compile(src, "lstm_bi_stacked.py", "exec")
    assert callable(ref_bi.bilstm_layer_pallas)
    assert ref_bi.__file__.endswith("experiments/lstm_bi_stacked.py")


# --- fused stem ---------------------------------------------------------------
def _stem_case(seed, B=4, H=32, W=128, CO=16):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B, H, W), np.uint8)
    widths = rng.integers(W // 3, W + 1, B).astype(np.int32)
    kernel = rng.normal(0, 0.3, (3, 3, 1, CO)).astype(np.float32)  # HWIO
    return images, widths, kernel


def _oihw(k_hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(k_hwio.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("standardize", [True, False])
def test_fused_stem_matches_pallas_interpret(ref_stem, standardize):
    images, widths, kernel = _stem_case(0)
    out_j, xn_j = ref_stem._stem_fwd(
        jnp.asarray(images), jnp.asarray(widths), jnp.asarray(kernel),
        standardize=standardize, dtype=jnp.float32, interpret=True)
    out, xn = stem_cuda.fused_stem_ref(
        torch.from_numpy(images), torch.from_numpy(widths), _oihw(kernel),
        standardize)
    via_fn = stem_cuda.fused_stem(torch.from_numpy(images),
                                  torch.from_numpy(widths), _oihw(kernel),
                                  standardize)
    assert out.shape == (4, 16, 32, 128) and xn.shape == (4, 32, 128)
    assert torch.equal(via_fn, out)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(out_j), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(xn.numpy(), np.asarray(xn_j), atol=2e-5,
                               rtol=2e-5)


def test_fused_stem_dk_matches_pallas_interpret(ref_stem):
    images, widths, kernel = _stem_case(1)
    proj = np.random.default_rng(9).normal(
        0, 1, (4, 32, 128, 16)).astype(np.float32)  # NHWC
    gj = jax.grad(lambda k: jnp.sum(ref_stem.fused_stem(
        jnp.asarray(images), jnp.asarray(widths), k, True, jnp.float32,
        True) * proj))(jnp.asarray(kernel))
    k = _oihw(kernel).requires_grad_(True)
    out = stem_cuda.fused_stem(torch.from_numpy(images),
                               torch.from_numpy(widths), k)
    (out * torch.from_numpy(proj).permute(0, 3, 1, 2)).sum().backward()
    assert k.grad.dtype == torch.float32 and k.grad.shape == (16, 1, 3, 3)
    np.testing.assert_allclose(k.grad.numpy().transpose(2, 3, 1, 0),
                               np.asarray(gj), atol=2e-4, rtol=1e-4)


def test_narrow_width_masking(ref_stem):
    """Content beyond the true width does not leak through the stencil."""
    rng = np.random.default_rng(2)
    img1 = rng.integers(0, 256, (1, 32, 128), np.uint8)
    img2 = img1.copy()
    img2[:, :, 60:] = 13  # differs only beyond the width
    widths = np.array([50], np.int32)
    k = rng.normal(0, 0.3, (3, 3, 1, 8)).astype(np.float32)
    outs = [stem_cuda.fused_stem(torch.from_numpy(im), torch.from_numpy(widths),
                                 _oihw(k)) for im in (img1, img2)]
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=1e-6)
    ref = ref_stem.fused_stem(jnp.asarray(img2), jnp.asarray(widths),
                              jnp.asarray(k), True, jnp.float32, True)
    np.testing.assert_allclose(outs[1].permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_bf16_stem_close_to_f32_oracle():
    images, widths, kernel = _stem_case(3, B=3, W=45, CO=8)
    proj = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (3, 8, 32, 45)).astype(np.float32))
    got = {}
    for dt in (torch.float32, torch.bfloat16):
        k = _oihw(kernel).requires_grad_(True)
        out = stem_cuda.fused_stem(torch.from_numpy(images),
                                   torch.from_numpy(widths), k, True, dt)
        assert out.dtype == dt
        (out.float() * proj).sum().backward()
        got[dt] = (out.float(), k.grad)
    for a, b in zip(got[torch.bfloat16], got[torch.float32]):
        scale = max(1.0, b.abs().max().item())
        assert (a - b).abs().max().item() <= 3e-2 * scale


def test_stem_dk_ref_matches_autograd_through_the_plain_forward():
    images, widths, kernel = _stem_case(5, B=2, W=37, CO=6)
    xn = preprocess_images(torch.from_numpy(images),
                           torch.from_numpy(widths))[..., 0]
    dout = torch.from_numpy(np.random.default_rng(6).normal(
        0, 1, (2, 6, 32, 37)).astype(np.float32))
    k = _oihw(kernel).requires_grad_(True)
    out = torch.nn.functional.conv2d(xn[:, None], k, padding=1)
    (out * dout).sum().backward()
    # sums of 2368 products in another order: the dK tolerance of
    # experiments/test_stem_pallas.py:58
    torch.testing.assert_close(stem_cuda.stem_dk_ref(xn, dout), k.grad,
                               atol=2e-4, rtol=1e-4)


def test_fused_stem_equals_production_stem_in_f32():
    images, widths, kernel = _stem_case(7, B=3, W=61, CO=8)
    widths[1] = 0  # an empty image: n = max(0, 1)
    im, wd, k = torch.from_numpy(images), torch.from_numpy(widths), _oihw(kernel)
    x = preprocess_images(im, wd).permute(0, 3, 1, 2)
    prod = torch.nn.functional.conv2d(x, k, padding=1)
    torch.testing.assert_close(stem_cuda.fused_stem(im, wd, k), prod,
                               atol=1e-5, rtol=1e-5)


# --- direction-stacked BLSTM -------------------------------------------------------
def _layer_case(seed, B=8, T=12, D=16, H=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, T, D)).astype(np.float32)
    wx = rng.normal(0, 0.3, (D, 4 * H)).astype(np.float32)
    wh = rng.normal(0, 0.3, (H, 4 * H)).astype(np.float32)
    b = rng.normal(0, 0.1, (4 * H,)).astype(np.float32)
    lengths = rng.integers(1, T + 1, B)
    lengths[0] = T
    mask = np.arange(T)[None, :] < lengths[:, None]
    return x, mask, wx, wh, b


def _stacked_case(seed, T=10, B=6, H=8):
    """xw [T,2,B,4H], a ragged mask [T,2,B] (plane 1 time-flipped) and
    wh [2,H,4H]."""
    rng = np.random.default_rng(seed)
    xw = rng.normal(0, 1, (T, 2, B, 4 * H)).astype(np.float32)
    wh = rng.normal(0, 0.3, (2, H, 4 * H)).astype(np.float32)
    lengths = rng.integers(1, T + 1, B)
    lengths[0] = T
    m = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    mask = np.ascontiguousarray(np.stack([m, m[::-1]], axis=1))
    dys = rng.normal(0, 1, (T, 2, B, H)).astype(np.float32)
    return xw, mask, wh, dys


@pytest.mark.parametrize("seed", [0, 1])
def test_bi_recurrence_matches_pallas_interpret(ref_bi, seed):
    xw, mask, wh, _ = _stacked_case(seed)
    ys_j, cs_j = ref_bi._bi_lstm_fwd(jnp.asarray(xw), jnp.asarray(mask),
                                     jnp.asarray(wh), dtype=jnp.float32,
                                     interpret=True)
    ys, cs = bi.bi_recurrence_ref(*map(torch.from_numpy, (xw, mask, wh)),
                                  save_cell=True)
    assert ys.dtype == cs.dtype == torch.float32
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), atol=1e-5)
    np.testing.assert_allclose(cs.numpy(), np.asarray(cs_j), atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_stacked_layer_matches_pallas_interpret_and_two_scans(ref_bi, seed):
    x, mask, wx_f, wh_f, b_f = _layer_case(seed)
    _, _, wx_b, wh_b, b_b = _layer_case(seed + 100)
    w = (wx_f, wh_f, b_f, wx_b, wh_b, b_b)
    ours = bi.bilstm_layer_stacked(torch.from_numpy(x), torch.from_numpy(mask),
                                   *map(torch.from_numpy, w))
    j = [jnp.asarray(a) for a in (x, mask) + w]
    pallas = ref_bi.bilstm_layer_pallas(*j, interpret=True)
    scans = jnp.concatenate([lstm_layer(*j[:5]),
                             lstm_layer(j[0], j[1], *j[5:], reverse=True)], -1)
    assert ours.shape == (8, 12, 32) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas), atol=1e-5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(scans), atol=1e-5)


def test_bi_bptt_matches_pallas_interpret(ref_bi):
    xw, mask, wh, dys = _stacked_case(2)
    args_j = [jnp.asarray(a) for a in (xw, mask, wh)]
    ys_j, cs_j = ref_bi._bi_lstm_fwd(*args_j, dtype=jnp.float32,
                                     interpret=True)
    dxw_j, dwh_j = ref_bi._bi_lstm_bwd(*args_j, ys_j, cs_j, jnp.asarray(dys),
                                       dtype=jnp.float32, interpret=True)
    t = [torch.from_numpy(a) for a in (xw, mask, wh)]
    ys, cs = bi.bi_recurrence_ref(*t, save_cell=True)
    dxw, dwh = bi.bi_bptt_ref(*t, ys, cs, torch.from_numpy(dys))
    assert dxw.shape == xw.shape and dwh.shape == wh.shape
    np.testing.assert_allclose(dxw.numpy(), np.asarray(dxw_j), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(dwh.numpy(), np.asarray(dwh_j), atol=2e-5,
                               rtol=1e-4)


def _jax_layer_loss(fn, mask, proj):
    m = jnp.asarray(mask, jnp.float32)[..., None]

    def loss(x_, wx_f, wh_f, b_f, wx_b, wh_b, b_b):
        return jnp.sum(fn(x_, jnp.asarray(mask), wx_f, wh_f, b_f, wx_b, wh_b,
                          b_b) * proj * m)
    return loss


@pytest.mark.parametrize("oracle", ["pallas_interpret", "scan"])
def test_layer_gradients_of_all_seven_inputs_match_jax(ref_bi, oracle):
    x, mask, wx_f, wh_f, b_f = _layer_case(3)
    _, _, wx_b, wh_b, b_b = _layer_case(103)
    args = (x, wx_f, wh_f, b_f, wx_b, wh_b, b_b)
    proj = np.random.default_rng(7).normal(0, 1, (8, 12, 32)).astype(np.float32)
    if oracle == "pallas_interpret":
        fn = lambda x_, m_, *w: ref_bi.bilstm_layer_pallas(  # noqa: E731
            x_, m_, *w, interpret=True)
    else:
        fn = lambda x_, m_, wxf, whf, bf, wxb, whb, bb: jnp.concatenate(  # noqa: E731
            [lstm_layer(x_, m_, wxf, whf, bf),
             lstm_layer(x_, m_, wxb, whb, bb, reverse=True)], -1)
    ref = jax.grad(_jax_layer_loss(fn, mask, proj), argnums=tuple(range(7)))(
        *map(jnp.asarray, args))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    ys = bi.bilstm_layer_stacked(ts[0], torch.from_numpy(mask), *ts[1:])
    m = torch.from_numpy(mask).to(torch.float32)[..., None]
    (ys * torch.from_numpy(proj) * m).sum().backward()
    names = ["x", "wx_f", "wh_f", "b_f", "wx_b", "wh_b", "b_b"]
    for t, r, n in zip(ts, ref, names):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=3e-4,
                                   rtol=1e-3, err_msg=f"grad mismatch: {n}")


def test_bi_bptt_ref_matches_autograd_through_the_plain_forward():
    xw, mask, wh, dys = _stacked_case(4, T=7, B=4, H=6)
    x = torch.tensor(xw, requires_grad=True)
    w = torch.tensor(wh, requires_grad=True)
    ys = bi.bi_recurrence_ref(x, torch.from_numpy(mask), w)
    (ys * torch.from_numpy(dys)).sum().backward()
    with torch.no_grad():
        ys, cs = bi.bi_recurrence_ref(x, torch.from_numpy(mask), w,
                                      save_cell=True)
        dxw, dwh = bi.bi_bptt_ref(x, torch.from_numpy(mask), w, ys, cs,
                                  torch.from_numpy(dys))
    torch.testing.assert_close(dxw, x.grad, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(dwh, w.grad, atol=1e-6, rtol=1e-5)


def test_bf16_stacked_layer_close_to_f32_oracle():
    x, mask, wx_f, wh_f, b_f = _layer_case(5)
    w = [wx_f, wh_f, b_f, *_layer_case(105)[2:]]
    proj = torch.from_numpy(np.random.default_rng(8).normal(
        0, 1, (8, 12, 32)).astype(np.float32))
    got = {}
    for dt in (torch.float32, torch.bfloat16):
        ts = [torch.tensor(a, requires_grad=True) for a in [x] + w]
        ys = bi.bilstm_layer_stacked(ts[0], torch.from_numpy(mask), *ts[1:],
                                     dtype=dt)
        assert ys.dtype == torch.float32
        (ys * proj).sum().backward()
        got[dt] = [ys] + [t.grad for t in ts]
    for a, b in zip(got[torch.bfloat16], got[torch.float32]):
        scale = max(1.0, b.abs().max().item())
        assert (a - b).abs().max().item() <= 3e-2 * scale


# --- kernel wrappers and dispatch -------------------------------------------------
def _wrapper_calls():
    img = torch.zeros((2, 4, 8), dtype=torch.uint8)
    k = torch.zeros((3, 1, 3, 3))
    xw, mask, wh = torch.zeros((3, 2, 2, 8)), torch.ones((3, 2, 2)), \
        torch.zeros((2, 2, 8))
    y = torch.zeros((3, 2, 2, 2))
    return {
        "stem_fwd": lambda: stem_cuda.stem_fwd_cuda(
            img, torch.full((2,), 8, dtype=torch.int32), k, True,
            torch.float32),
        "stem_dk": lambda: stem_cuda.stem_dk_cuda(
            torch.zeros((2, 4, 8)), torch.zeros((2, 3, 4, 8))),
        "bi_fwd": lambda: bi.bi_lstm_fwd_cuda(xw, mask, wh, torch.float32),
        "bi_bwd": lambda: bi.bi_lstm_bwd_cuda(xw, mask, wh, y, y, y,
                                              torch.float32),
    }


@pytest.mark.parametrize("name", ["stem_fwd", "stem_dk", "bi_fwd", "bi_bwd"])
def test_kernel_wrappers_refuse_cpu_tensors(name):
    """A kernel wrapper never runs the plain version in its place."""
    with pytest.raises(ValueError, match="CUDA tensors only"):
        _wrapper_calls()[name]()


def test_entry_points_on_cpu_run_the_plain_versions_without_launching():
    before = (stem_cuda.STEM_LAUNCHES, stem_cuda.STEM_DK_LAUNCHES,
              bi.BI_FWD_LAUNCHES, bi.BI_BWD_LAUNCHES)
    images, widths, kernel = _stem_case(8, B=2, W=20, CO=4)
    k = _oihw(kernel).requires_grad_(True)
    stem_cuda.fused_stem(torch.from_numpy(images), torch.from_numpy(widths),
                         k).sum().backward()
    xw, mask, wh, _ = _stacked_case(9, T=4, B=2, H=3)
    x = torch.tensor(xw, requires_grad=True)
    bi.bi_recurrence(x, torch.from_numpy(mask), torch.from_numpy(wh)).sum(
    ).backward()
    assert k.grad is not None and x.grad is not None
    assert before == (stem_cuda.STEM_LAUNCHES, stem_cuda.STEM_DK_LAUNCHES,
                      bi.BI_FWD_LAUNCHES, bi.BI_BWD_LAUNCHES)


@pytest.mark.parametrize("dtype,standardize,fwd,dk", [
    (torch.bfloat16, True, "stem_moments+stem_conv",
     "stem_dk_partial:mma+stem_dk_sum"),
    (torch.float32, True, "stem_moments+stem_conv",
     "stem_dk_partial:fma+stem_dk_sum"),
    (torch.bfloat16, False, "stem_conv", "stem_dk_partial:mma+stem_dk_sum"),
])
def test_stem_design_names_the_kernels_by_type(dtype, standardize, fwd, dk):
    """dK runs on the tensor cores in bf16 only; the moments run only when
    the forward standardises."""
    assert stem_cuda.stem_design(dtype, standardize) == {"fwd": fwd, "dk": dk}
    with pytest.raises(TypeError):
        stem_cuda.stem_design(torch.float16)


def test_stem_impl_message_names_the_port_experiment():
    cfg = ModelConfig(num_classes=5, stem_impl="fused")
    with pytest.raises(ValueError,
                       match="vistaocr_tpu_torch/experiments/stem_cuda.py"):
        CnnLstmOcr(cfg)
    path = pathlib.Path(stem_cuda.__file__)
    assert path.parts[-3:] == ("vistaocr_tpu_torch", "experiments",
                               "stem_cuda.py")


# --- the slice as a whole: the flagship forward with both experiments ------------
def _flagship_topology(cls_cfg, cls_stage):
    return cls_cfg(
        num_classes=11, line_height=32,
        stages=(cls_stage(8, 2, (2, 2)), cls_stage(16, 2, (2, 2)),
                cls_stage(16, 2, (2, 1))),
        bridge_dim=32, lstm_hidden=24, lstm_layers=2, dropout=0.0,
        compute_dtype="float32", lstm_impl="scan")


@pytest.mark.parametrize("train", [False, True])
def test_flagship_forward_with_experiments_matches_jax_and_port(train):
    cfg = _flagship_topology(ModelConfig, ConvStageSpec)
    base = CnnLstmOcr(cfg)
    init_parameters(base, torch.Generator().manual_seed(3))
    variables = state_dict_to_variables(base.state_dict())
    rng = np.random.default_rng(10)
    images = rng.integers(0, 256, (3, 32, 72), np.uint8)
    widths = np.array([72, 50, 9], np.int32)
    jmodel = JaxModel(_flagship_topology(JaxConfig, JaxStage))
    apply = jax.jit(lambda v, i, w: jmodel.apply(
        v, i, w, train=train, mutable=["batch_stats"] if train else False,
        rngs={"dropout": jax.random.PRNGKey(0)}))
    out = apply(variables, jnp.asarray(images), jnp.asarray(widths))
    lp_j, fm_j = out[0] if train else out

    models = []
    for _ in range(2):
        m = CnnLstmOcr(cfg)
        m.load_state_dict(base.state_dict())
        models.append(m)
    im, wd = torch.from_numpy(images), torch.from_numpy(widths)
    lp, fm = forward_with_experiments(models[0], im, wd, train=train)
    lp_p, fm_p = models[1](im, wd, train=train)
    assert torch.equal(fm, fm_p) and (fm.numpy() == np.asarray(fm_j)).all()
    valid = fm.numpy()
    np.testing.assert_allclose(lp.detach().numpy()[valid],
                               np.asarray(lp_j)[valid], atol=1e-4)
    proj = torch.from_numpy(rng.normal(0, 1, tuple(lp.shape)).astype(
        np.float32)) * fm[..., None]
    grads = []
    for m, out in zip(models, (lp, lp_p)):
        (out * proj).sum().backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    for name, g in grads[1].items():
        torch.testing.assert_close(grads[0][name], g, atol=2e-4, rtol=1e-3,
                                   msg=name)


def test_flagship_forward_refuses_dropout_in_train_mode():
    cfg = dataclasses.replace(_flagship_topology(ModelConfig, ConvStageSpec),
                              dropout=0.1)
    model = CnnLstmOcr(cfg)
    with pytest.raises(ValueError, match="dropout"):
        forward_with_experiments(model, torch.zeros((1, 32, 8), dtype=torch.uint8),
                                 torch.tensor([8], dtype=torch.int32),
                                 train=True)


# --- the stacked layout through the layer's plain versions ----------------
def _independent_case(seed, T=9, B=5, H=8):
    """_stacked_case's operands with masks whose planes are independent,
    holes included (not one plane flipped)."""
    xw, _, wh, dys = _stacked_case(seed, T=T, B=B, H=H)
    rng = np.random.default_rng(seed + 50)
    mask = (rng.random((T, 2, B)) < 0.7).astype(np.float32)
    return xw, mask, wh, dys


def _through_layer_plain(xw, mask, wh, dys, dtype):
    """ys, cs [T, 2, B, H] and dxw [T, 2, B, 4H], dwh [2, H, 4H] from the
    layer's plain versions, a plane at a time as ``bi_planes`` maps it."""
    from vistaocr_tpu_torch.ops import lstm_cuda as L

    planes = bi.bi_planes(xw, mask)
    fwd = [L.lstm_recurrence_ref(p["xw"], p["mask"], wh[k],
                                 reverse=p["reverse"], dtype=dtype,
                                 save_cell=True)
           for k, p in enumerate(planes)]
    ys = torch.stack([y for y, _ in fwd], dim=1)
    cs = torch.stack([c for _, c in fwd], dim=1)
    planes = bi.bi_planes(xw, mask, ys, cs, dys)
    bwd = [L.lstm_bptt_ref(p["xw"], p["mask"], wh[k], p["ys"], p["cs"],
                           p["dys"], reverse=p["reverse"], dtype=dtype)
           for k, p in enumerate(planes)]
    dxw = torch.stack([d for d, _ in bwd], dim=1)
    dwh = torch.stack([w for _, w in bwd])
    # lstm_bptt_ref's dwh is lstm_dwh_ref on the plane's ys and dxw
    for k, p in enumerate(planes):
        assert torch.equal(dwh[k], L.lstm_dwh_ref(
            p["ys"], dxw[:, k], reverse=p["reverse"], dtype=dtype))
    return ys, cs, dxw, dwh


@pytest.mark.parametrize("independent", [False, True])
def test_plane_mapping_through_layer_plain_versions_f32(ref_bi, independent):
    case = (_independent_case if independent else _stacked_case)(3)
    xw, mask, wh, dys = map(torch.from_numpy, case)
    ys, cs, dxw, dwh = _through_layer_plain(xw, mask, wh, dys, torch.float32)
    rys, rcs = bi.bi_recurrence_ref(xw, mask, wh, save_cell=True)
    rdxw, rdwh = bi.bi_bptt_ref(xw, mask, wh, rys, rcs, dys)
    for a, b in ((ys, rys), (cs, rcs), (dxw, rdxw), (dwh, rdwh)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    args_j = [jnp.asarray(a) for a in case[:3]]
    ys_j, cs_j = ref_bi._bi_lstm_fwd(*args_j, dtype=jnp.float32,
                                     interpret=True)
    dxw_j, dwh_j = ref_bi._bi_lstm_bwd(*args_j, ys_j, cs_j,
                                       jnp.asarray(case[3]),
                                       dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), atol=1e-5)
    np.testing.assert_allclose(cs.numpy(), np.asarray(cs_j), atol=1e-5)
    # the BPTT on the plain forward's ys and cs, as the bptt test above
    _, _, dxw2, dwh2 = _through_layer_plain(xw, mask, wh, dys, torch.float32)
    np.testing.assert_allclose(dxw2.numpy(), np.asarray(dxw_j), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(dwh2.numpy(), np.asarray(dwh_j), atol=2e-5,
                               rtol=1e-4)


def test_plane_mapping_through_layer_plain_versions_bf16():
    """bf16 weights: the layer's plain versions on the planes against the
    stacked plain versions (the same rounding points: h and dgates rounded
    to bf16 where the products read them)."""
    xw, mask, wh, dys = map(torch.from_numpy, _independent_case(4))
    ys, cs, dxw, dwh = _through_layer_plain(xw, mask, wh, dys,
                                            torch.bfloat16)
    rys, rcs = bi.bi_recurrence_ref(xw, mask, wh, torch.bfloat16,
                                    save_cell=True)
    rdxw, rdwh = bi.bi_bptt_ref(xw, mask, wh, rys, rcs, dys, torch.bfloat16)
    for a, b in ((ys, rys), (cs, rcs), (dxw, rdxw), (dwh, rdwh)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


# --- chip_smoke.py's device-beam tie check --------------------------------
def _two_prefix_posteriors(gap: float, T: int = 8):
    """[T, 4] log-probs over (blank, a, b, c): every frame is blank but
    frame 3, where a and b share the mass, b ``gap`` below a; the one-
    character prefixes a and b then score lp[3, a] and lp[3, b] plus the
    blanks, ``gap`` apart."""
    lp = np.full((T, 4), -30.0)
    lp[:, 0] = 0.0
    lp[3] = [-30.0, np.log(0.5), np.log(0.5) - gap, -30.0]
    return lp.astype(np.float32)


@pytest.mark.parametrize("gap,accepted", [(0.0, True), (1e-3, False)])
def test_device_beam_tie_check(gap, accepted):
    import chip_smoke
    from vistaocr_tpu_torch.decode import BeamConfig
    from vistaocr_tpu_torch.text import Alphabet, utf8_to_uxxxx

    alphabet = Alphabet.build([utf8_to_uxxxx("abc")])
    lp = _two_prefix_posteriors(gap)
    b = alphabet.decode([alphabet.index_of(utf8_to_uxxxx("b"))])
    a = alphabet.decode([alphabet.index_of(utf8_to_uxxxx("a"))])
    dev_score = float(lp[3, 2])  # the device's f32 score of b
    out = chip_smoke.beam_tie(lp, lp.shape[0], alphabet, BeamConfig(), b,
                              dev_score)
    scores = dict(out["host"])
    if gap:
        assert out["host"][0][0] == a
    assert scores[a] - scores[b] == pytest.approx(gap, abs=1e-6)
    assert out["margin"] == chip_smoke.beam_tie_margin(
        8, max(abs(out["host"][0][1]), abs(dev_score)))
    assert out["margin"] < 1e-4  # far below the refused gap
    assert out["tie"] is accepted

