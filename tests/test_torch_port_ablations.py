"""The conv ablation knobs of the port (``conv_norm="none"``: no
BatchNorm; ``conv_pool="stride"``: subsampling pools) against the JAX
model on the CPU: the forward with each knob and with both within 1e-4
(f32) on the same parameters; a ``conv_norm="none"`` snapshot (no ``bn*``
parameters, no ``batch_stats``) written by either package opens in both;
one port train step under ``conv_norm="none"`` matches JAX's
``make_train_step`` at the tolerances of ``test_torch_port_train.py``."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vistaocr_tpu import checkpoint as jax_ckpt
from vistaocr_tpu import train as jax_train
from vistaocr_tpu.data.buckets import ShapeContract as JaxContract
from vistaocr_tpu.models import CnnLstmOcr as JaxModel
from vistaocr_tpu.models import ModelConfig as JaxConfig
from vistaocr_tpu.models.cnn import ConvStageSpec as JaxStage
from vistaocr_tpu.text import Alphabet as JaxAlphabet

from vistaocr_tpu_torch import checkpoint
from vistaocr_tpu_torch import train as port_train
from vistaocr_tpu_torch.data import ShapeContract
from vistaocr_tpu_torch.models import CnnLstmOcr, ModelConfig, init_parameters
from vistaocr_tpu_torch.text import Alphabet

torch.set_num_threads(2)

KNOBS = {"norm-none": dict(conv_norm="none"),
         "pool-stride": dict(conv_pool="stride"),
         "both": dict(conv_norm="none", conv_pool="stride")}


def _config(**kw):
    return JaxConfig(
        num_classes=11, line_height=32,
        stages=(JaxStage(8, 2, (2, 2)), JaxStage(16, 2, (2, 2)),
                JaxStage(16, 1, (2, 1))),
        bridge_dim=16, lstm_hidden=16, lstm_layers=1, dropout=0.0,
        compute_dtype="float32", lstm_impl="scan", **kw)


def _batch():
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (4, 32, 99), np.uint8)
    widths = np.array([99, 93, 61, 5], np.int32)
    return images, widths


@pytest.mark.parametrize("knobs", list(KNOBS), ids=list(KNOBS))
def test_forward_matches_jax(knobs):
    cfg = _config(**KNOBS[knobs])
    variables = jax.device_get(
        JaxModel(cfg).init_params(jax.random.PRNGKey(1), batch=2, width=64))
    assert ("batch_stats" in variables) == (cfg.conv_norm == "batch")
    images, widths = _batch()
    ref_lp, ref_fm = JaxModel(cfg).apply(variables, images, widths,
                                         train=False)
    model = CnnLstmOcr(ModelConfig.from_json(cfg.to_json()))
    assert (len(model.cnn.bns) == 0) == (cfg.conv_norm == "none")
    model.load_state_dict(checkpoint.variables_to_state_dict(variables),
                          strict=True)
    with torch.no_grad():
        lp, fm = model(torch.from_numpy(images), torch.from_numpy(widths))
    fm_ref = np.asarray(ref_fm)
    assert lp.shape == ref_lp.shape
    np.testing.assert_array_equal(fm.numpy(), fm_ref)
    np.testing.assert_allclose(lp.numpy()[fm_ref], np.asarray(ref_lp)[fm_ref],
                               atol=1e-4, rtol=0)


def test_unknown_knob_values_raise():
    with pytest.raises(ValueError, match="conv_norm"):
        CnnLstmOcr(ModelConfig.from_json(_config(conv_norm="group").to_json()))
    with pytest.raises(ValueError, match="conv_pool"):
        CnnLstmOcr(ModelConfig.from_json(_config(conv_pool="avg").to_json()))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_norm_none_snapshot_opens_in_both(writer, tmp_path):
    cfg = _config(conv_norm="none")
    alphabet = JaxAlphabet.from_charset("abcdefghij")
    images, widths = _batch()
    path = str(tmp_path)
    if writer == "jax":
        variables = jax.device_get(JaxModel(cfg).init_params(
            jax.random.PRNGKey(2), batch=2, width=64))
        # the JAX trainer writes the (empty) batch_stats collection too
        jax_ckpt.save_snapshot(
            path, variables={**variables, "batch_stats": {}},
            model_config=cfg, alphabet=alphabet,
            contract=JaxContract(bucket_widths=(128, 256)))
    else:
        model = CnnLstmOcr(ModelConfig.from_json(cfg.to_json()))
        init_parameters(model, torch.Generator().manual_seed(2))
        checkpoint.save_snapshot(
            path, state_dict=model.state_dict(), model_config=model.config,
            alphabet=Alphabet.from_json(alphabet.to_json()),
            contract=ShapeContract(bucket_widths=(128, 256)))
        tree = checkpoint.read_flax_msgpack(f"{path}/weights.msgpack")
        assert set(tree) == {"params"}
        assert not any(k.startswith("bn") for k in tree["params"]["cnn"])
    ours, _, _ = checkpoint.load_model(path, "cpu")
    jmodel, jvars, _, _ = jax_ckpt.load_model(path)
    assert "batch_stats" not in jvars or not jvars["batch_stats"]
    with torch.no_grad():
        lp, fm = ours(torch.from_numpy(images), torch.from_numpy(widths))
    ref_lp, ref_fm = jmodel.apply(jvars, images, widths, train=False)
    m = np.asarray(ref_fm)
    np.testing.assert_allclose(lp.numpy()[m], np.asarray(ref_lp)[m],
                               atol=1e-4, rtol=0)


def test_norm_none_train_step_matches_jax():
    """One SGD step at lr 1 from the same parameters (dropout and augment
    off, CTC and LSTM kernels in interpret mode on the JAX side): the
    parameter change is each framework's clipped gradient."""
    over = dict(optimizer="sgd", dropout=0.0, augment=0.0,
                ctc_impl="pallas_interpret")
    jcfg = jax_train.TrainConfig(**{**jax_train.PRESETS["synth-tiny"], **over})
    alphabet = JaxAlphabet.from_charset("abcdeo ")
    mcfg = dataclasses.replace(jcfg.model_config(alphabet.num_classes),
                               lstm_impl="pallas_interpret", conv_norm="none")
    jmodel = JaxModel(mcfg)
    variables = jax.device_get(jmodel.init_params(jax.random.PRNGKey(0)))
    assert set(variables) == {"params"}
    rng = np.random.default_rng(9)
    B, W = 8, 128
    images = rng.integers(0, 256, (B, 32, W), np.uint8)
    widths = rng.integers(W // 2, W + 1, B).astype(np.int32)
    labels = np.zeros((B, 15), np.int32)
    lengths = rng.integers(1, 8, B).astype(np.int32)
    for i, n in enumerate(lengths):
        labels[i, :n] = rng.integers(1, alphabet.num_classes, n)
    weights = np.ones(B, np.float32)
    weights[-1] = 0.0

    tx = jax_train.make_optimizer(jcfg, include_clip=False)
    state = jax_train.TrainState(
        params=variables["params"], batch_stats={},
        opt_state=tx.init(variables["params"]),
        step=jnp.asarray(0, jnp.int32))
    jstep = jax_train.make_train_step(jmodel, tx, False, "pallas_interpret",
                                      grad_clip=5.0)
    new_state, jm = jstep(state, images, widths, labels, lengths,
                          jnp.asarray(weights), jnp.asarray(1.0, jnp.float32),
                          jax.random.PRNGKey(0))
    jgrads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                          variables["params"], jax.device_get(new_state.params))
    jgrads = checkpoint.variables_to_state_dict({"params": jgrads})

    pcfg = port_train.TrainConfig(**{**port_train.PRESETS["synth-tiny"],
                                     **over})
    model = CnnLstmOcr(ModelConfig.from_json(mcfg.to_json()))
    model.load_state_dict(checkpoint.variables_to_state_dict(variables),
                          strict=True)
    ptx = port_train.make_optimizer(pcfg)
    pstate = port_train.TrainState(
        model=model, opt_state=ptx.init(dict(model.named_parameters())))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = port_train.make_train_step(model, ptx, False, "pallas_interpret",
                                      grad_clip=5.0)
    pm = step(pstate, *(torch.from_numpy(a) for a in (
        images, widths, labels, lengths, weights)), 1.0)
    after = model.state_dict()
    assert set(after) == set(jgrads)
    np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(pm["gnorm"].item(), float(jm["gnorm"]),
                               rtol=1e-4)
    for name, g in jgrads.items():
        np.testing.assert_allclose((before[name] - after[name]).numpy(),
                                   g.numpy(), atol=2e-4, rtol=1e-3,
                                   err_msg=name)
