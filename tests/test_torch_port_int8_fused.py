"""The fused int8 conv stack of the port (``ops/int8_conv.py``'s
``int8_conv_fused`` and its plain version, ``models/quant.conv_plan``) on
the CPU:

- the plain fused entry point bit-equal to the per-conv composite it
  replaces (``int8_conv_ref`` or the int8 conv, then ``_nhwc_pool``, then
  ``quantize_ref``) at odd H and W, both compute types, every pool the
  kernels fold (max and stride, 2 x 2 and 2 x 1) and both output forms;
- ``quantized_conv_features`` through the plan equal to the per-conv stack
  for every float prefix, with pools the kernels do not fold and stages
  without convs;
- ``quantized_conv_features`` against JAX's at prefixes 0, 1, 2, 3 and 6
  of a six-conv stack, f32 and bf16, ``conv_pool`` max and stride, and
  ``conv_norm="none"``, on XLA's preprocess and float prefix in both;
- the property that lets the kernels quantize before the pool:
  quantize-then-pool equals pool-then-quantize, ties at the half quantum,
  the +-127 clamp and negative pre-ReLU values included (hypothesis);
- the text anchors of ``profile_int8_conv.py``'s cut copies.

The design rule (``conv_design``) is the CUDA library's, so its test is
in ``test_torch_port_cuda.py``.
"""

import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
import torch

from vistaocr_tpu.models import CnnLstmOcr as JaxModel
from vistaocr_tpu.models import ModelConfig as JaxConfig
from vistaocr_tpu.models import quant as jq
from vistaocr_tpu.models.cnn import ConvStageSpec as JaxStage
from vistaocr_tpu.ops.preprocess import preprocess_images as jax_preprocess

from vistaocr_tpu_torch.models import ConvStageSpec, ModelConfig
from vistaocr_tpu_torch.models import quant as pq
from vistaocr_tpu_torch.ops import int8_conv as ic
from vistaocr_tpu_torch.ops.preprocess import preprocess_images

torch.set_num_threads(2)

DTYPES = [torch.float32, torch.bfloat16]
POOLS = [((1, 1), "max"), ((2, 2), "max"), ((2, 1), "max"),
         ((2, 2), "stride"), ((2, 1), "stride")]
SHAPES = [(2, 5, 9, 1, 8), (1, 7, 13, 5, 24), (2, 4, 1, 16, 8),
          (1, 9, 17, 32, 16)]  # (B, H, W, CI, CO): odd H and W, W = 1


def _operands(B, H, W, ci, co, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (B, H, W, ci)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-127, 128, (co, ci, 3, 3)).astype(
        np.int8))
    scale = torch.from_numpy(rng.uniform(1e-3, 1e-2, co).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.3, co).astype(np.float32))
    inv_s = float(np.float32(127.0 / 3.0))
    inv_next = float(np.float32(1.0 / (0.05 * np.sqrt(ci))))
    return x.to(dtype), ic.pack_weights(wq), scale, bias, inv_s, inv_next


@pytest.mark.parametrize("out_int8", [True, False])
@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_plain_equals_the_per_conv_composite(shape, dtype, pool,
                                                   out_int8):
    x, wp, scale, bias, inv_s, inv_next = _operands(*shape, dtype,
                                                    seed=sum(shape))
    window, impl = pool
    nxt = inv_next if out_int8 else None
    # the composite: a conv with its epilogue, the stage's pool pass, the
    # next conv's quantize
    want = pq._nhwc_pool(ic.int8_conv_ref(x, wp, scale, bias, inv_s), window,
                         impl)
    if out_int8:
        want = ic.quantize_ref(want, inv_next)
    xq = ic.quantize_ref(x, inv_s)
    for got in (
            ic.int8_conv_fused_ref(x, wp, scale, bias, inv_s=inv_s,
                                   window=window, pool_impl=impl,
                                   inv_s_next=nxt),
            ic.int8_conv_fused(x, wp, scale, bias, inv_s=inv_s,
                               window=window, pool_impl=impl,
                               inv_s_next=nxt),
            ic.int8_conv_fused(xq, wp, scale, bias, dtype=dtype,
                               window=window, pool_impl=impl,
                               inv_s_next=nxt)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)
    B, H, W, _, co = shape
    assert want.shape == (B, -(-H // window[0]), -(-W // window[1]), co)


def test_fused_refuses_what_it_does_not_take():
    x, wp, scale, bias, inv_s, _ = _operands(1, 5, 9, 5, 8, torch.float32, 1)
    xq = ic.quantize_ref(x, inv_s)
    for bad in (dict(dtype=torch.float32, window=(3, 3)),
                dict(dtype=torch.float32, pool_impl="avg"),
                dict(dtype=torch.float16), dict()):
        with pytest.raises(ValueError):
            ic.int8_conv_fused(xq, wp, scale, bias, **bad)
    with pytest.raises(ValueError):
        ic.int8_conv_fused(x, wp, scale, bias)  # no inv_s
    with pytest.raises(ValueError):
        ic.int8_conv(xq, wp, scale, bias, inv_s)


def _old_features(qs, images, widths, cfg, prefix):
    """The per-conv stack: each int8 conv quantizes its input, then the
    stage's pool pass."""
    x = preprocess_images(images, widths, standardize=cfg.standardize_input,
                          dtype=cfg.dtype)
    i = 0
    for st_ in cfg.stages:
        for _ in range(st_.num_convs):
            c = qs.convs[i]
            if i < prefix:
                x = pq._float_conv(x, qs.fkernels[i], c.bias, cfg.dtype)
            else:
                x = ic.int8_conv_ref(x, c.weight, c.scale, c.bias, c.inv_s)
            i += 1
        x = pq._nhwc_pool(x, st_.pool, cfg.conv_pool)
    return x


PLAN_STAGES = {
    "flagship": ((8, 2, (2, 2)), (16, 2, (2, 2)), (32, 2, (2, 1))),
    "unfused": ((8, 1, (3, 2)), (16, 0, (2, 2)), (16, 2, (1, 1)),
                (8, 1, (2, 1))),
}


@pytest.mark.parametrize("conv_pool", ["max", "stride"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stages", sorted(PLAN_STAGES))
def test_plan_equals_the_per_conv_stack(stages, dtype, conv_pool):
    cfg = ModelConfig(num_classes=5, compute_dtype=dtype, conv_pool=conv_pool,
                      stages=tuple(ConvStageSpec(*s)
                                   for s in PLAN_STAGES[stages]))
    rng = np.random.default_rng(1)
    chans = [1] + [s.channels for s in cfg.stages for _ in range(s.num_convs)]
    n = len(chans) - 1
    ks = [rng.normal(0, 0.3, (chans[i + 1], chans[i], 3, 3)).astype(
        np.float32) for i in range(n)]
    bs = [rng.normal(0, 0.1, chans[i + 1]).astype(np.float32)
          for i in range(n)]
    images = torch.from_numpy(rng.integers(0, 256, (3, 32, 37), np.uint8))
    widths = torch.tensor([37, 30, 5], dtype=torch.int32)
    scales = pq.calibrate_in_scales(ks, bs, cfg, [(images, widths)],
                                    device="cpu")
    qs = pq.QuantizedStack(pq.quantize_conv_stack(ks, bs, scales), "cpu",
                           cfg.dtype)
    for prefix in range(n + 1):
        plan = pq.conv_plan(cfg, prefix)
        assert sum(s[0] != "pool" for s in plan) == n
        want = _old_features(qs, images, widths, cfg, prefix)
        got = pq.quantized_conv_features(qs, images, widths, cfg,
                                         float_prefix=prefix)
        assert got.dtype == want.dtype and torch.equal(got, want), prefix
    if stages == "flagship":  # every pool in an epilogue, int8 between
        assert [s[2:] for s in pq.conv_plan(cfg, 0)] == [
            ((1, 1), True), ((2, 2), True), ((1, 1), True), ((2, 2), True),
            ((1, 1), True), ((2, 1), False)]


# --- against JAX ----------------------------------------------------------
JAX_STAGES = ((8, 2, (2, 2)), (16, 2, (2, 2)), (16, 2, (2, 1)))  # six convs


def _jax_variables(cfg, seed=3):
    """Seeded JAX parameters, BatchNorm statistics away from their
    initial values."""
    v = jax.device_get(JaxModel(cfg).init_params(
        jax.random.PRNGKey(seed), batch=2, width=64))
    if "batch_stats" not in v:
        return v
    rng = np.random.default_rng(seed)

    def rnd(path, x):
        key = jax.tree_util.keystr(path)
        if "var" in key:
            return np.abs(rng.normal(0, 0.5, x.shape)).astype(np.float32) + .5
        if "mean" in key:
            return rng.normal(0, 0.3, x.shape).astype(np.float32)
        if "scale" in key:
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if "'bn" in key and "bias" in key:
            return rng.normal(0.2, 0.2, x.shape).astype(np.float32)
        return np.asarray(x)

    return {"params": jax.tree_util.tree_map_with_path(rnd, v["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(
                rnd, v["batch_stats"])}


_JAX_CASES = {}


def _jax_case(dtype, conv_pool, conv_norm):
    """(JAX config, JAX qstack, port config, port QuantizedStack, images,
    widths), the qstack folded, calibrated and quantized by JAX."""
    key = (dtype, conv_pool, conv_norm)
    if key not in _JAX_CASES:
        kw = dict(line_height=32, compute_dtype=dtype, conv_pool=conv_pool,
                  conv_norm=conv_norm)
        jcfg = JaxConfig(num_classes=8, bridge_dim=16, lstm_hidden=16,
                         lstm_layers=1, dropout=0.0, lstm_impl="scan",
                         stages=tuple(JaxStage(*s) for s in JAX_STAGES), **kw)
        v = _jax_variables(jcfg)
        kernels, biases = jq.fold_conv_params(v["params"],
                                              v.get("batch_stats", {}), jcfg)
        rng = np.random.default_rng(7)
        images = rng.integers(0, 256, (3, 32, 37), np.uint8)
        widths = np.array([37, 30, 5], np.int32)
        scales = jq.calibrate_in_scales(
            kernels, biases, jcfg, [(jnp.asarray(images), jnp.asarray(widths))])
        jqs = jq.quantize_conv_stack(kernels, biases, scales)

        def oihw(k):
            return np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1))

        port = {"kernels": tuple(oihw(k) for k in jqs["kernels"]),
                "fkernels": tuple(oihw(k) for k in jqs["fkernels"]),
                "wscales": tuple(np.asarray(w) for w in jqs["wscales"]),
                "biases": tuple(np.asarray(b) for b in jqs["biases"]),
                "in_scales": tuple(np.float32(s) for s in jqs["in_scales"])}
        pcfg = ModelConfig(num_classes=8, stages=tuple(
            ConvStageSpec(*s) for s in JAX_STAGES), **kw)
        _JAX_CASES[key] = (jcfg, jqs, pcfg,
                           pq.QuantizedStack(port, "cpu", pcfg.dtype),
                           images, widths)
    return _JAX_CASES[key]


def _jdt(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


def _to_torch(y, dtype):
    return torch.from_numpy(np.array(y.astype(jnp.float32))).to(dtype)


def _jax_preprocess(images, widths, *, standardize, dtype):
    """JAX's preprocess on the port's tensors (see _jax_float_conv)."""
    return _to_torch(jax_preprocess(jnp.asarray(images.numpy()),
                                    jnp.asarray(widths.numpy()),
                                    standardize=standardize,
                                    dtype=_jdt(dtype)), dtype)


def _jax_float_conv(x, kernel, bias, dtype):
    """The float prefix's conv as JAX's ``quantized_conv_features`` runs it
    (XLA's conv in the compute type, + bias, round, ReLU), on the port's
    tensors. The two packages' preprocess and float convs round otherwise
    in a few elements (their f32 sums run in another order), and the int8
    convs after them magnify an ulp that crosses a quantization boundary;
    so the int8 convs, pools and plan are compared on XLA's float
    front."""
    jdt = _jdt(dtype)
    xj = jnp.asarray(x.to(torch.float32).numpy(), jdt)
    kj = jnp.asarray(kernel.to(torch.float32).numpy().transpose(2, 3, 1, 0),
                     jdt)
    y = jax.lax.conv_general_dilated(xj, kj, (1, 1), "SAME",
                                     dimension_numbers=jq._DN,
                                     preferred_element_type=jdt)
    y = jax.nn.relu((y.astype(jnp.float32) + bias.numpy()).astype(jdt))
    return _to_torch(y, dtype)


def _against_jax(dtype, conv_pool, conv_norm, prefix, monkeypatch):
    jcfg, jqs, pcfg, qs, images, widths = _jax_case(dtype, conv_pool,
                                                    conv_norm)
    ref = jq.quantized_conv_features(jqs, jnp.asarray(images),
                                     jnp.asarray(widths), jcfg,
                                     float_prefix=prefix)
    ref = np.asarray(ref.astype(jnp.float32))
    monkeypatch.setattr(pq, "_float_conv", _jax_float_conv)
    monkeypatch.setattr(pq, "preprocess_images", _jax_preprocess)
    ours = pq.quantized_conv_features(qs, torch.from_numpy(images),
                                      torch.from_numpy(widths), pcfg,
                                      float_prefix=prefix)
    assert ours.dtype == pcfg.dtype and tuple(ours.shape) == ref.shape
    # on one float front the int8 convs are exact: bit-equal features
    np.testing.assert_array_equal(ours.to(torch.float32).numpy(), ref)


@pytest.mark.parametrize("prefix", [0, 1, 2, 3, 6])
@pytest.mark.parametrize("conv_pool", ["max", "stride"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_features_match_jax(dtype, conv_pool, prefix, monkeypatch):
    _against_jax(dtype, conv_pool, "batch", prefix, monkeypatch)


@pytest.mark.parametrize("prefix", [0, 3])
@pytest.mark.parametrize("conv_pool", ["max", "stride"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_features_match_jax_without_norm(dtype, conv_pool, prefix,
                                                   monkeypatch):
    _against_jax(dtype, conv_pool, "none", prefix, monkeypatch)


# --- quantize before or after the pool ------------------------------------
def _value(kind, k, inv):
    if kind == "tie":  # on the half quantum: rint rounds to even
        return (k + 0.5) / inv
    if kind == "exact":
        return k / inv
    return k * 0.37 / inv


@settings(max_examples=200, deadline=None)
@given(
    cells=st.lists(st.tuples(st.sampled_from(["tie", "exact", "off"]),
                             st.integers(-300, 300)),
                   min_size=1, max_size=40),
    inv=st.sampled_from([0.25, 1.0, 4.0, 32.0, 42.333332061767578]),
    h=st.integers(1, 5), w=st.integers(1, 7),
    pool=st.sampled_from(POOLS),
    dtype=st.sampled_from(DTYPES))
def test_quantize_commutes_with_the_pool(cells, inv, h, w, pool, dtype):
    """The values the kernels pool are relu(round_T(...)) >= +0 (negative
    pre-ReLU values, ReLU'd, included); quantizing each with the next
    conv's scale and then pooling the int8 values gives the int8 tensor of
    pooling first, the clamp at 127 and the ties included."""
    vals = [_value(kind, k, inv) for kind, k in cells]
    vals = (vals * (h * w // len(vals) + 1))[:h * w]
    pre = torch.tensor(vals, dtype=torch.float32).reshape(1, h, w, 1)
    y = pre.to(dtype)
    y = torch.where(y > 0, y, torch.zeros_like(y))  # the epilogue's ReLU
    window, impl = pool
    first = ic.quantize_ref(ic.pool_ref(y, window, impl), inv)
    after = ic.pool_ref(ic.quantize_ref(y, inv).to(torch.float32), window,
                        impl).to(torch.int8)
    assert torch.equal(first, after)
    assert int(first.min()) >= 0 and int(first.max()) <= 127  # y >= +0


def test_profile_script_finds_its_anchors_in_the_kernel():
    """profile_int8_conv.py cuts work out of copies of csrc/int8_conv.cu by
    text anchors: each must be found exactly once in the kernel as it
    stands, and each copy must differ from it."""
    import profile_int8_conv

    path = os.path.join(os.path.dirname(ic.__file__), "..", "csrc",
                        "int8_conv.cu")
    with open(path) as f:
        src = f.read()
    assert profile_int8_conv.variant_source(src, "full") == src
    for variant in profile_int8_conv.VARIANTS:
        if variant != "full":
            assert profile_int8_conv.variant_source(src, variant) != src
