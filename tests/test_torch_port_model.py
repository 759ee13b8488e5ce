"""The port's model path against the JAX package on the CPU: masked
preprocess, conv frame arithmetic, the full CnnLstmOcr forward (tiny and
flagship-topology configs, randomised batch_stats, widths that are not
multiples of 4 and partial padding), ModelConfig JSON, and snapshots in
both directions (a JAX ``weights.msgpack`` snapshot loads into the port;
the port's ``weights.npz`` snapshot round-trips)."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vistaocr_tpu import checkpoint as jax_ckpt
from vistaocr_tpu.data.buckets import ShapeContract as JaxContract
from vistaocr_tpu.models import CnnLstmOcr as JaxModel
from vistaocr_tpu.models import ModelConfig as JaxConfig
from vistaocr_tpu.models.cnn import ConvStageSpec as JaxStage
from vistaocr_tpu.ops.preprocess import preprocess_images as jax_preprocess
from vistaocr_tpu.text import Alphabet as JaxAlphabet

from vistaocr_tpu_torch import checkpoint
from vistaocr_tpu_torch.data import ShapeContract
from vistaocr_tpu_torch.models import (CnnLstmOcr, ConvStack, ConvStageSpec,
                                       ModelConfig, init_parameters)
from vistaocr_tpu_torch.ops.preprocess import preprocess_images

torch.set_num_threads(2)


def _tiny(cls_cfg, cls_stage, **kw):
    return cls_cfg(
        num_classes=11, line_height=32,
        stages=(cls_stage(16, 1, (2, 2)), cls_stage(32, 1, (2, 2)),
                cls_stage(32, 1, (2, 1))),
        bridge_dim=48, lstm_hidden=40, lstm_layers=2, dropout=0.0,
        compute_dtype="float32", lstm_impl="scan", **kw)


def _flagship_topology(cls_cfg, cls_stage, **kw):
    """The flagship wiring (3 stages x 2 convs, (2,2)/(2,2)/(2,1) pools,
    2 BLSTM layers) at reduced widths."""
    return cls_cfg(
        num_classes=11, line_height=32,
        stages=(cls_stage(8, 2, (2, 2)), cls_stage(16, 2, (2, 2)),
                cls_stage(16, 2, (2, 1))),
        bridge_dim=32, lstm_hidden=24, lstm_layers=2, dropout=0.0,
        compute_dtype="float32", lstm_impl="scan", **kw)


CONFIGS = {"tiny": _tiny, "flagship-topology": _flagship_topology}


def _randomize_batch_stats(variables, seed=5):
    rng = np.random.default_rng(seed)

    def rnd(path, x):
        arr = rng.normal(0, 0.5, x.shape).astype(np.float32)
        if "var" in jax.tree_util.keystr(path):
            arr = np.abs(arr) + 0.5
        return jnp.asarray(arr)

    bs = jax.tree_util.tree_map_with_path(rnd, variables["batch_stats"])
    return {**variables, "batch_stats": bs}


def _jax_variables(cfg, seed=42):
    variables = JaxModel(cfg).init_params(jax.random.PRNGKey(seed), batch=2,
                                          width=64)
    variables = _randomize_batch_stats(variables)
    return jax.tree.map(lambda x: np.asarray(x, np.float32), variables)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (4, 32, 96), np.uint8)
    widths = np.array([96, 93, 61, 5], np.int32)
    return images, widths


def _port_forward(model, images, widths):
    with torch.no_grad():
        lp, fm = model(torch.from_numpy(images), torch.from_numpy(widths))
    return lp.numpy(), fm.numpy()


class TestPreprocess:
    @pytest.mark.parametrize("standardize", [True, False])
    def test_matches_jax(self, standardize):
        rng = np.random.default_rng(3)
        images = rng.integers(0, 256, (5, 32, 77), np.uint8)
        widths = np.array([77, 76, 40, 1, 0], np.int32)
        ref = jax_preprocess(jnp.asarray(images), jnp.asarray(widths),
                             standardize=standardize)
        ours = preprocess_images(torch.from_numpy(images),
                                 torch.from_numpy(widths),
                                 standardize=standardize)
        assert tuple(ours.shape) == tuple(ref.shape) == (5, 32, 77, 1)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6,
                                   rtol=1e-6)
        assert (ours.numpy()[1, :, 76:] == 0).all()

    def test_rejects_non_uint8(self):
        with pytest.raises(TypeError):
            preprocess_images(torch.zeros((1, 4, 4)), torch.tensor([4]))


class TestFrameArithmetic:
    """Frame counts for widths 1..128 equal ShapeContract.frames_for_width
    (mirrors tests/test_model.py::TestConvFrameArithmetic on the port's
    ceil-mode pooling)."""

    @pytest.mark.parametrize("lo", [1, 33, 65, 97])
    def test_true_width_frames(self, lo):
        stages = (ConvStageSpec(2, 2, (2, 2)), ConvStageSpec(2, 2, (2, 2)),
                  ConvStageSpec(2, 2, (2, 1)))
        stack = ConvStack(stages)
        contract, jax_contract = ShapeContract(), JaxContract()
        for w in range(lo, lo + 32):
            with torch.no_grad():
                y = stack(torch.zeros((1, 1, 32, w)))
            assert y.shape[3] == contract.frames_for_width(w), w
            assert y.shape[3] == jax_contract.frames_for_width(w), w
            assert y.shape[2] == 4

    def test_frame_mask_counts(self):
        cfg = _flagship_topology(ModelConfig, ConvStageSpec)
        model = CnnLstmOcr(cfg)
        init_parameters(model, torch.Generator().manual_seed(0))
        widths = np.arange(1, 129, dtype=np.int32)
        images = np.full((128, 32, 128), 255, np.uint8)
        _, fm = _port_forward(model, images, widths)
        assert fm.shape == (128, 32)
        np.testing.assert_array_equal(fm.sum(1),
                                      JaxContract().frames_for_width(widths))


class TestFullModel:
    @pytest.fixture(scope="class", params=list(CONFIGS))
    def pair(self, request):
        cfg_j = CONFIGS[request.param](JaxConfig, JaxStage)
        cfg_t = CONFIGS[request.param](ModelConfig, ConvStageSpec)
        variables = _jax_variables(cfg_j)
        model = CnnLstmOcr(cfg_t)
        model.load_state_dict(checkpoint.variables_to_state_dict(variables))
        return cfg_j, variables, model

    def test_log_probs_match_on_valid_frames(self, pair):
        cfg_j, variables, model = pair
        images, widths = _batch()
        lp_j, fm_j = JaxModel(cfg_j).apply(
            variables, jnp.asarray(images), jnp.asarray(widths), train=False)
        lp_t, fm_t = _port_forward(model, images, widths)
        assert lp_t.shape == lp_j.shape
        np.testing.assert_array_equal(fm_t, np.asarray(fm_j))
        diff = np.abs(lp_t - np.asarray(lp_j))[fm_t].max()
        assert diff <= 1e-4, f"log-prob drift {diff:.2e}"

    def test_padding_does_not_leak(self, pair):
        """Valid frames do not depend on what the pad region holds."""
        _, _, model = pair
        images, widths = _batch(1)
        other = images.copy()
        for b, w in enumerate(widths):
            other[b, :, w:] = 255 - other[b, :, w:]
        lp_a, fm = _port_forward(model, images, widths)
        lp_b, _ = _port_forward(model, other, widths)
        # preprocess forces every padded column to 0 before the stem conv
        np.testing.assert_array_equal(lp_a[fm], lp_b[fm])


class TestConfigAndSnapshots:
    @pytest.mark.parametrize("stem_impl", ["auto", "plain"])
    def test_config_json_round_trip_both_ways(self, stem_impl):
        cfg_t = _flagship_topology(ModelConfig, ConvStageSpec,
                                   stem_impl=stem_impl)
        cfg_j = _flagship_topology(JaxConfig, JaxStage, stem_impl=stem_impl)
        assert json.loads(cfg_t.to_json()) == json.loads(cfg_j.to_json())
        assert ModelConfig.from_json(cfg_j.to_json()) == cfg_t
        assert JaxConfig.from_json(cfg_t.to_json()) == cfg_j

    def test_rejected_stem_impl_raises(self):
        with pytest.raises(ValueError):
            CnnLstmOcr(_tiny(ModelConfig, ConvStageSpec, stem_impl="pallas"))

    def test_ablation_knobs_raise(self):
        with pytest.raises(NotImplementedError):
            CnnLstmOcr(_tiny(ModelConfig, ConvStageSpec, conv_norm="none"))

    def test_jax_snapshot_loads_with_equal_log_probs(self, tmp_path):
        cfg_j = _tiny(JaxConfig, JaxStage)
        variables = _jax_variables(cfg_j, seed=7)
        alphabet = JaxAlphabet.from_charset("abcdefghij")
        contract = JaxContract(bucket_widths=(128, 256))
        jax_ckpt.save_snapshot(str(tmp_path), variables=variables,
                               model_config=cfg_j, alphabet=alphabet,
                               contract=contract)
        model, al, ct = checkpoint.load_model(str(tmp_path), "cpu")
        assert al.to_json() == alphabet.to_json()
        assert ct.to_json() == contract.to_json()
        assert model.config.to_json() == cfg_j.to_json()
        images, widths = _batch(2)
        lp_j, _ = JaxModel(cfg_j).apply(
            variables, jnp.asarray(images), jnp.asarray(widths), train=False)
        lp_t, fm = _port_forward(model, images, widths)
        diff = np.abs(lp_t - np.asarray(lp_j))[fm].max()
        assert diff <= 1e-4, diff

    def test_msgpack_decoder_matches_flax(self, tmp_path):
        cfg_j = _flagship_topology(JaxConfig, JaxStage)
        variables = _jax_variables(cfg_j, seed=9)
        jax_ckpt.save_snapshot(
            str(tmp_path), variables=variables, model_config=cfg_j,
            alphabet=JaxAlphabet.from_charset("abcdefghij"),
            contract=JaxContract())
        ours = checkpoint.read_flax_msgpack(
            os.path.join(str(tmp_path), "weights.msgpack"))
        want = checkpoint.flatten(variables)
        got = checkpoint.flatten(ours)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])

    def test_state_dict_mapping_is_invertible(self):
        cfg_j = _flagship_topology(JaxConfig, JaxStage)
        variables = _jax_variables(cfg_j, seed=11)
        back = checkpoint.state_dict_to_variables(
            checkpoint.variables_to_state_dict(variables))
        want, got = checkpoint.flatten(variables), checkpoint.flatten(back)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])

    def test_port_npz_snapshot_round_trips(self, tmp_path):
        cfg = _flagship_topology(ModelConfig, ConvStageSpec)
        model = CnnLstmOcr(cfg)
        init_parameters(model, torch.Generator().manual_seed(3))
        from vistaocr_tpu_torch.text import Alphabet

        checkpoint.save_snapshot(
            str(tmp_path), state_dict=model.state_dict(), model_config=cfg,
            alphabet=Alphabet.from_charset("abcdefghij"),
            contract=ShapeContract(), step=5)
        assert not os.path.exists(os.path.join(str(tmp_path),
                                               "weights.msgpack"))
        loaded, _, _ = checkpoint.load_model(str(tmp_path), "cpu")
        sd_a, sd_b = model.state_dict(), loaded.state_dict()
        assert set(sd_a) == set(sd_b)
        for k in sd_a:
            assert torch.equal(sd_a[k], sd_b[k]), k
        # the npz holds flax paths in the JAX layout: JAX applies it as is
        variables, cfg_back, _, _, meta = checkpoint.load_snapshot(
            str(tmp_path))
        assert meta["step"] == 5 and cfg_back == cfg
        cfg_j = JaxConfig.from_json(cfg.to_json())
        images, widths = _batch(4)
        lp_j, _ = JaxModel(cfg_j).apply(
            jax.tree.map(jnp.asarray, variables), jnp.asarray(images),
            jnp.asarray(widths), train=False)
        lp_t, fm = _port_forward(model, images, widths)
        assert np.abs(lp_t - np.asarray(lp_j))[fm].max() <= 1e-4

    def test_init_parameters_is_seeded(self):
        cfg = _tiny(ModelConfig, ConvStageSpec)
        a, b = CnnLstmOcr(cfg), CnnLstmOcr(cfg)
        init_parameters(a, torch.Generator().manual_seed(1))
        init_parameters(b, torch.Generator().manual_seed(1))
        for (k, va), vb in zip(a.state_dict().items(),
                               b.state_dict().values()):
            assert torch.equal(va, vb), k
        wh = a.blstm.l0_fwd_wh.detach()
        np.testing.assert_allclose((wh @ wh.T).numpy(), np.eye(wh.shape[0]),
                                   atol=1e-5)
        H = cfg.lstm_hidden
        assert (a.blstm.l1_bwd_b.detach()[H:2 * H] == 1).all()
