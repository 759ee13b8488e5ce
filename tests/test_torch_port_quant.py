"""The port's int8 path (``models/quant.py``, ``ops/int8_conv.py``'s plain
version, the service's and ``infer``'s ``quantize="int8"``) against the
JAX package's ``models/quant.py`` on the CPU, on a small model (stages
8/16/16, H=16; f32, and bf16 where the compute type matters) with
randomised BatchNorm statistics, written by the JAX package:

- ``fold_conv_params`` with ``conv_norm`` "batch" and "none": kernels
  within 1e-6 relative, biases within 1e-6 of their largest magnitude
  (``rsqrt`` may differ by an ulp between the frameworks);
- ``quantize_conv_stack`` on JAX's folded kernels: int8 weights
  identical, scales bit-equal; the port's own fold -> quantize: >= 99.99%
  of the int8 weights equal, every difference +-1;
- calibration ``in_scales`` within 1e-5 relative (each on its own fold);
- with the JAX-written ``qstack.msgpack``: the int32 sums of each conv
  equal on the same int8 input; ``quantized_conv_features`` for
  ``float_prefix`` 0, 2 and all within 1e-5 (f32; bf16 within one bf16
  ulp) apart from elements downstream of an input that sat within an ulp
  of a quantization boundary (counted, and bounded); the whole quantized
  forward's log-probs within 1e-4 (f32) of JAX ``make_quantized_eval_step``,
  frame masks equal;
- ``qstack.msgpack`` byte-equal to JAX ``save_qstack``'s for the same
  arrays, each package loading the other's file, and the port's CLI
  writing a file the JAX ``load_qstack`` reads;
- ``OcrService(quantize="int8")``: greedy and host-beam texts equal to the
  JAX service's, with and without a float prefix; ``infer --quantize
  int8``: the report and hypotheses equal to JAX's on the stored qstack,
  and the train-split calibration when there is none;
- the JAX errors: a missing qstack, ``float_prefix`` without
  ``fkernels``, an unknown mode.
"""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vistaocr_tpu import checkpoint as jax_ckpt
from vistaocr_tpu import infer as jax_infer
from vistaocr_tpu.data import build_synthetic_dataset
from vistaocr_tpu.data.buckets import ShapeContract as JaxContract
from vistaocr_tpu.data.synth import SynthConfig
from vistaocr_tpu.models import CnnLstmOcr as JaxModel
from vistaocr_tpu.models import ModelConfig as JaxConfig
from vistaocr_tpu.models import quant as jq
from vistaocr_tpu.models.cnn import ConvStageSpec as JaxStage
from vistaocr_tpu.serve import OcrService as JaxService
from vistaocr_tpu.serve import ServiceConfig as JaxServiceConfig
from vistaocr_tpu.text import Alphabet as JaxAlphabet

from vistaocr_tpu_torch import checkpoint, infer
from vistaocr_tpu_torch.models import quant as pq
from vistaocr_tpu_torch.ops import int8_conv
from vistaocr_tpu_torch.serve import OcrService, ServiceConfig

torch.set_num_threads(2)

CHARSET = "abcdeo "


def _config(dtype="float32", **kw):
    return JaxConfig(
        num_classes=len(CHARSET) + 1, line_height=32,
        stages=(JaxStage(8, 2, (2, 2)), JaxStage(16, 2, (2, 2)),
                JaxStage(16, 1, (2, 1))),
        bridge_dim=16, lstm_hidden=16, lstm_layers=1, dropout=0.0,
        compute_dtype=dtype, lstm_impl="scan", **kw)


N_CONVS = 5


def _variables(cfg, seed=3):
    """Seeded JAX parameters with BatchNorm statistics and affine
    parameters away from their initial values."""
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


def _save(path, cfg, variables):
    jax_ckpt.save_snapshot(
        path, variables=variables, model_config=cfg,
        alphabet=JaxAlphabet.from_charset(CHARSET),
        contract=JaxContract(bucket_widths=(128, 256)))
    return path


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """(data dir, {dtype: snapshot with the JAX-written qstack}, root)."""
    root = tmp_path_factory.mktemp("quant")
    data = build_synthetic_dataset(
        str(root / "data"), num_train=24, num_val=16, height=32,
        max_width=256, seed=5,
        config=SynthConfig(language="charset", charset=CHARSET,
                           min_words=1, max_words=3))
    snaps = {}
    for dtype in ("float32", "bfloat16"):
        cfg = _config(dtype)
        snap = _save(str(root / f"snap_{dtype}"), cfg, _variables(cfg))
        jq.quantize_snapshot(snap, data, calib_batches=2,
                             batch_pixels=2**16)
        snaps[dtype] = snap
    return data, snaps, root


def _batch(seed=0, B=4, W=99):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B, 32, W), np.uint8)
    widths = np.array([W, W - 6, W // 2, 5][:B], np.int32)
    return images, widths


def _port_model(snap):
    return checkpoint.load_model(snap, "cpu")[0]


def _oihw(k):
    return np.asarray(k).transpose(3, 2, 0, 1)


def _jax_fold(snap):
    model, v, _, _ = jax_ckpt.load_model(snap)
    return jq.fold_conv_params(v["params"], v.get("batch_stats", {}),
                               model.config)


@pytest.mark.parametrize("norm", ["batch", "none"])
def test_fold_matches_jax(norm, tmp_path):
    cfg = _config(conv_norm=norm)
    snap = _save(str(tmp_path), cfg, _variables(cfg, seed=7))
    jk, jb = _jax_fold(snap)
    pk, pb = pq.fold_conv_params(_port_model(snap))
    assert len(pk) == len(jk) == N_CONVS
    for a, b in zip(pk, jk):
        np.testing.assert_allclose(a.numpy(), _oihw(b), rtol=1e-6, atol=0)
    for a, b in zip(pb, jb):
        b = np.asarray(b)
        assert np.max(np.abs(a.numpy() - b)) <= 1e-6 * max(
            np.max(np.abs(b)), 1e-30)
        if norm == "none":
            assert not np.any(a.numpy())


def test_quantize_from_jax_folded_kernels(case):
    _, snaps, _ = case
    jk, jb = _jax_fold(snaps["float32"])
    scales = np.linspace(0.01, 0.05, N_CONVS).astype(np.float32)
    ref = jq.quantize_conv_stack(jk, jb, scales)
    ours = pq.quantize_conv_stack([_oihw(k) for k in jk], jb, scales)
    for a, b in zip(ours["kernels"], ref["kernels"]):
        assert a.dtype == np.int8
        np.testing.assert_array_equal(a, _oihw(b))
    for a, b in zip(ours["wscales"], ref["wscales"]):
        assert a.tobytes() == np.asarray(b, np.float32).tobytes()
    for a, b in zip(ours["in_scales"], ref["in_scales"]):
        assert np.float32(a).tobytes() == np.asarray(b, np.float32).tobytes()


def test_own_fold_and_quantize_agree_with_jax(case):
    _, snaps, _ = case
    jk, jb = _jax_fold(snaps["float32"])
    ones = np.ones(N_CONVS, np.float32)
    ref = jq.quantize_conv_stack(jk, jb, ones)
    ours = pq.quantize_conv_stack(
        *pq.fold_conv_params(_port_model(snaps["float32"])), ones)
    total = same = 0
    for a, b in zip(ours["kernels"], ref["kernels"]):
        d = a.astype(np.int32) - _oihw(b).astype(np.int32)
        assert np.abs(d).max() <= 1
        total += d.size
        same += int(np.sum(d == 0))
    assert same >= 0.9999 * total, (same, total)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_calibration_scales_match_jax(case, dtype):
    data, snaps, _ = case
    snap = snaps[dtype]
    batches = pq.calibration_batches(data, snap, calib_batches=2,
                                     batch_pixels=2**16)
    assert len(batches) == 2
    jmodel, jv, _, _ = jax_ckpt.load_model(snap)
    jk, jb = jq.fold_conv_params(jv["params"], jv["batch_stats"],
                                 jmodel.config)
    ref = jq.calibrate_in_scales(jk, jb, jmodel.config, batches)
    model = _port_model(snap)
    ours = pq.calibrate_in_scales(*pq.fold_conv_params(model), model.config,
                                  batches, device="cpu")
    assert ours.dtype == np.float32 and ours.shape == (N_CONVS,)
    rtol = 1e-5 if dtype == "float32" else 2.0 ** -7  # one bf16 ulp
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=0)


def test_int8_accumulators_equal(case):
    """The int32 sums of each stored conv on the same int8 input, against
    XLA's int8 conv."""
    _, snaps, _ = case
    qs = pq.load_qstack(snaps["float32"])
    rng = np.random.default_rng(1)
    for wq in qs["kernels"]:
        ci = wq.shape[1]
        xq = rng.integers(-127, 128, (2, 6, 37, ci)).astype(np.int8)
        ref = jax.lax.conv_general_dilated(
            jnp.asarray(xq), jnp.asarray(wq.transpose(2, 3, 1, 0)), (1, 1),
            "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
        ours = int8_conv.conv_acc_ref(
            torch.from_numpy(xq), int8_conv.pack_weights(torch.from_numpy(wq)))
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prefix", [0, 2, N_CONVS])
def test_quantized_features_match_jax(case, dtype, prefix):
    _, snaps, _ = case
    snap = snaps[dtype]
    cfg = _port_model(snap).config
    images, widths = _batch()
    ref = jq.quantized_conv_features(
        jq.load_qstack(snap), jnp.asarray(images), jnp.asarray(widths),
        jax_ckpt.load_model(snap)[0].config, float_prefix=prefix)
    ref = np.asarray(ref.astype(jnp.float32))
    ours = pq.quantized_conv_features(
        pq.QuantizedStack(pq.load_qstack(snap), "cpu", cfg.dtype),
        torch.from_numpy(images),
        torch.from_numpy(widths), cfg, float_prefix=prefix)
    assert ours.dtype == cfg.dtype and tuple(ours.shape) == ref.shape
    ours = ours.to(torch.float32).numpy()
    if dtype == "float32":
        off = np.abs(ours - ref) > 1e-5
    else:  # one bf16 ulp of the larger
        off = np.abs(ours - ref) > 2.0 ** -8 * np.maximum(np.abs(ref), 1e-3)
    # an input within an ulp of a quantization boundary rounds the other
    # way and moves what depends on it; such elements stay rare
    print(f"{dtype} prefix {prefix}: {int(off.sum())} of {off.size} "
          "elements beyond the bound")
    assert off.sum() <= 0.01 * off.size
    if dtype == "float32":
        assert off.sum() <= 0.001 * off.size


@pytest.mark.parametrize("prefix", [0, 2])
def test_quantized_forward_matches_jax(case, prefix):
    _, snaps, _ = case
    snap = snaps["float32"]
    jmodel, jv, _, _ = jax_ckpt.load_model(snap)
    images, widths = _batch(seed=2, W=130)
    jlp, jfm = jq.make_quantized_eval_step(
        jmodel, jq.load_qstack(snap), float_prefix=prefix)(
            jv["params"], jv["batch_stats"], images, widths)
    model = _port_model(snap)
    lp, fm = pq.make_quantized_eval_step(
        model, pq.load_qstack(snap), float_prefix=prefix)(
            torch.from_numpy(images), torch.from_numpy(widths))
    m = np.asarray(jfm)
    np.testing.assert_array_equal(fm.numpy(), m)
    assert lp.dtype == torch.float32
    np.testing.assert_allclose(lp.numpy()[m], np.asarray(jlp)[m], atol=1e-4,
                               rtol=0)


def test_qstack_bytes_equal_and_cross_load(case, tmp_path):
    _, snaps, _ = case
    ref = jq.load_qstack(snaps["float32"])
    jax_tree = {k: ref[k] for k in ("kernels", "fkernels", "wscales",
                                    "biases", "in_scales")}
    port_tree = {k: tuple(_oihw(a) if k in ("kernels", "fkernels")
                          else np.asarray(a) for a in v)
                 for k, v in jax_tree.items()}
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jq.save_qstack(str(tmp_path / "jax"), jax_tree)
    pq.save_qstack(str(tmp_path / "port"), port_tree)
    a = (tmp_path / "jax" / pq.QSTACK_FILE).read_bytes()
    b = (tmp_path / "port" / pq.QSTACK_FILE).read_bytes()
    assert a == b
    theirs = jq.load_qstack(str(tmp_path / "port"))
    ours = pq.load_qstack(str(tmp_path / "jax"))
    for key in jax_tree:
        assert len(theirs[key]) == len(ours[key]) == len(jax_tree[key])
        for x, ref_x, y, ref_y in zip(theirs[key], jax_tree[key], ours[key],
                                      port_tree[key]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(ref_x))
            np.testing.assert_array_equal(y, ref_y)
            assert np.asarray(y).dtype == np.asarray(ref_y).dtype


def test_cli_writes_a_qstack_jax_loads(case, tmp_path):
    data, snaps, _ = case
    snap = str(tmp_path / "snap")
    shutil.copytree(snaps["float32"], snap)
    os.remove(os.path.join(snap, pq.QSTACK_FILE))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        pq.main(["--snapshot", snap, "--data", data, "--calib-batches", "2",
                 "--batch-pixels", str(2**16), "--device", "cpu"])
    assert "qstack.msgpack" in buf.getvalue()
    theirs = jq.load_qstack(snap)
    ref = jq.load_qstack(snaps["float32"])  # JAX's own calibration
    for x, y in zip(theirs["kernels"], ref["kernels"]):
        assert np.asarray(x).shape == np.asarray(y).shape
        assert np.mean(np.asarray(x) == np.asarray(y)) >= 0.9999
    np.testing.assert_allclose(
        np.asarray(theirs["in_scales"], np.float32),
        np.asarray(ref["in_scales"], np.float32), rtol=1e-5)


def _lines():
    rng = np.random.default_rng(17)
    out = []
    for w in (20, 64, 100, 127, 128, 129, 200, 255):
        img = np.full((32, w), 255, np.uint8)
        for _ in range(max(3, w // 8)):
            y, x = int(rng.integers(2, 30)), int(rng.integers(0, w))
            img[y - 2: y + 2, x: x + int(rng.integers(1, 9))] = int(
                rng.integers(0, 90))
        out.append(img)
    out.append(rng.integers(0, 256, (48, 150), np.uint8))
    return out


@pytest.mark.parametrize("kw", [
    dict(),
    dict(quantize_float_prefix=2),
    dict(decoder="beam", beam_impl="host")], ids=["greedy", "prefix2", "host-beam"])
def test_service_matches_jax(case, kw):
    _, snaps, _ = case
    snap = snaps["float32"]
    cfg = dict(max_batch=8, warmup=False, quantize="int8", **kw)
    theirs = JaxService(snap, JaxServiceConfig(**cfg))
    ours = OcrService(snap, ServiceConfig(**cfg), device="cpu")
    try:
        lines = _lines()
        got, want = ours.ocr_lines(lines), theirs.ocr_lines(lines)
    finally:
        ours.close()
        theirs.close()
    assert [r.text for r in got] == [r.text for r in want]
    assert [r.bucket_width for r in got] == [r.bucket_width for r in want]
    assert any(r.text for r in got)
    for a, b in zip(got, want):
        assert (a.confidence is None) == (b.confidence is None)
        if b.confidence is not None:
            assert abs(a.confidence - b.confidence) <= 1e-3


def _infer_both(data, snap, root, tag, **kw):
    path_j, path_p = str(root / f"{tag}_j.jsonl"), str(root / f"{tag}_p.jsonl")
    rj = jax_infer.run_inference(snap, data, "val", out_path=path_j,
                                 log=lambda *a: None, quantize="int8", **kw)
    logs = []
    rp = infer.run_inference(snap, data, "val", out_path=path_p,
                             log=logs.append, quantize="int8", device="cpu",
                             **kw)
    recs = [[json.loads(x) for x in open(p)] for p in (path_p, path_j)]
    return rp, rj, recs, logs


def test_infer_report_matches_jax(case):
    data, snaps, root = case
    rp, rj, (recs_p, recs_j), logs = _infer_both(
        data, snaps["float32"], root, "stored")
    assert "int8 PTQ: loaded stored qstack from snapshot" in logs
    assert set(rp) == set(rj) and rp["quantize"] == "int8"
    for key in set(rj) - {"lines_per_sec"}:
        assert rp[key] == rj[key], key
    assert [r["hyp_uxxxx"] for r in recs_p] == [r["hyp_uxxxx"] for r in recs_j]
    for a, b in zip(recs_p, recs_j):
        assert abs(a["conf"] - b["conf"]) <= 1e-3


def test_infer_calibrates_on_the_train_split(case, tmp_path):
    data, snaps, _ = case
    snap = str(tmp_path / "snap")
    shutil.copytree(snaps["float32"], snap)
    os.remove(os.path.join(snap, pq.QSTACK_FILE))
    rp, rj, (recs_p, recs_j), logs = _infer_both(
        data, snap, tmp_path, "calib", calib_batches=2,
        batch_pixels=2**16)
    assert "int8 PTQ: conv stack quantized (calibrated over 2 train " \
           "batches)" in logs
    assert set(rp) == set(rj) and rp["quantize"] == "int8"
    assert rp["lines"] == rj["lines"] == 16
    # each package on its own calibration: the scales may differ by ulps
    same = np.mean([a["hyp_uxxxx"] == b["hyp_uxxxx"]
                    for a, b in zip(recs_p, recs_j)])
    assert same >= 0.9


def test_errors_match_jax(case, tmp_path):
    _, snaps, _ = case
    bare = str(tmp_path / "bare")
    shutil.copytree(snaps["float32"], bare)
    os.remove(os.path.join(bare, pq.QSTACK_FILE))
    for snap, kw, match in (
            (bare, dict(quantize="int8"), "qstack.msgpack"),
            (snaps["float32"], dict(quantize="int4"), "unknown quantize")):
        with pytest.raises(ValueError, match=match):
            JaxService(snap, JaxServiceConfig(warmup=False, **kw))
        with pytest.raises(ValueError, match=match):
            OcrService(snap, ServiceConfig(warmup=False, **kw), device="cpu")
    # an older artifact without the folded float kernels
    old = str(tmp_path / "old")
    shutil.copytree(snaps["float32"], old)
    qs = pq.load_qstack(old)
    del qs["fkernels"]
    pq.save_qstack(old, qs)
    kw = dict(warmup=False, quantize="int8", quantize_float_prefix=2)
    with pytest.raises(ValueError, match="fkernels"):
        JaxService(old, JaxServiceConfig(**kw))
    with pytest.raises(ValueError, match="fkernels"):
        OcrService(old, ServiceConfig(**kw), device="cpu")
    images, widths = _batch()
    cfg = _port_model(old).config
    with pytest.raises(ValueError, match="fkernels"):
        pq.quantized_conv_features(
            pq.QuantizedStack(qs, "cpu", cfg.dtype), torch.from_numpy(images),
            torch.from_numpy(widths), cfg, float_prefix=2)
    OcrService(old, ServiceConfig(warmup=False, quantize="int8"),
               device="cpu").close()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only "
                    "refusal; on a card the default runs there")
def test_calibration_defaults_to_the_card(case):
    """calibrate_in_scales runs on the card unless asked for the CPU: its
    default raises where torch sees no card."""
    data, snaps, _ = case
    snap = snaps["float32"]
    batches = pq.calibration_batches(data, snap, calib_batches=1,
                                     batch_pixels=2**16)
    model = _port_model(snap)
    with pytest.raises(RuntimeError, match="cuda"):
        pq.calibrate_in_scales(*pq.fold_conv_params(model), model.config,
                               batches)
