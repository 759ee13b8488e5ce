"""The port's training path (train.py, models in train mode, checkpoint)
against the JAX package on the CPU:

- train-mode BatchNorm output and updated ``batch_stats`` against flax
  (``mutable=["batch_stats"]``) within 1e-5;
- ``make_optimizer`` + the global-norm clip against optax on the same
  numpy gradients within 1e-6;
- one full train step of a tiny model (f32, dropout 0, augment 0) from
  identical parameters against JAX ``make_train_step`` with
  ``lstm_impl``/``ctc_impl="pallas_interpret"``: loss within 1e-5
  relative, every (clipped) gradient within atol 2e-4 / rtol 1e-3,
  ``batch_stats`` within 1e-5; the same step in bf16 on both sides: loss
  and global norm within 2**-8 relative, every gradient and statistic
  within twice JAX's own bf16-vs-f32 difference and within 2**-4 of its
  largest magnitude;
- the bf16 input projection keeps the product in f32 until the bias; the
  initialisers are flax's lecun-normal where flax uses it;
- a short ``fit`` on synthetic shards: the loss falls, snapshots are
  written, resume continues the step count, and the snapshot loads into
  the JAX model with log-probs within 1e-4.
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from vistaocr_tpu import train as jax_train
from vistaocr_tpu.data import BatchPipeline as JaxPipeline
from vistaocr_tpu.data import ShardedLineDataset as JaxDataset
from vistaocr_tpu.data import build_synthetic_dataset
from vistaocr_tpu.data.synth import SynthConfig
from vistaocr_tpu.models import CnnLstmOcr as JaxModel
from vistaocr_tpu.models import ModelConfig as JaxConfig
from vistaocr_tpu.models.cnn import ConvStack as JaxConvStack
from vistaocr_tpu.models.cnn import ConvStageSpec as JaxStage
from vistaocr_tpu.text import Alphabet as JaxAlphabet

from vistaocr_tpu_torch import train as port_train
from vistaocr_tpu_torch.checkpoint import (has_opt_state, load_model,
                                           load_snapshot,
                                           variables_to_state_dict)
from vistaocr_tpu_torch.models import (CnnLstmOcr, ConvStack, ConvStageSpec,
                                       ModelConfig, init_parameters)
from vistaocr_tpu_torch.ops.lstm_cuda import input_projection

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    cfg = SynthConfig(language="charset", charset="abcdeo ", min_words=1,
                      max_words=3)
    return build_synthetic_dataset(str(d), num_train=96, num_val=24,
                                   height=32, max_width=384, config=cfg,
                                   seed=11)


# --- BatchNorm in train mode ------------------------------------------------
def test_train_mode_batchnorm_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.normal(0.3, 1.5, (3, 8, 12, 2)).astype(np.float32)  # NHWC
    jstack = JaxConvStack(stages=(JaxStage(6, 2, (2, 2)),
                                  JaxStage(5, 1, (2, 1))))
    variables = jax.device_get(jstack.init(jax.random.PRNGKey(0),
                                           jnp.asarray(x), train=False))
    params = jax.tree.map(np.array, variables["params"])
    stats = jax.tree.map(np.array, variables["batch_stats"])
    for name in stats:
        c = stats[name]["mean"].shape[0]
        stats[name]["mean"] = rng.normal(0, 1, c).astype(np.float32)
        stats[name]["var"] = rng.uniform(0.5, 2, c).astype(np.float32)
        params[name]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        params[name]["bias"] = rng.normal(0, 0.5, c).astype(np.float32)
    y_j, upd = jstack.apply({"params": params, "batch_stats": stats},
                            jnp.asarray(x), train=True,
                            mutable=["batch_stats"])

    port = ConvStack((ConvStageSpec(6, 2, (2, 2)), ConvStageSpec(5, 1, (2, 1))),
                     in_channels=2)
    with torch.no_grad():
        for name, conv in port.convs.items():
            conv.weight.copy_(torch.from_numpy(
                params[name]["kernel"].transpose(3, 2, 0, 1).copy()))
        for name, bn in port.bns.items():
            bn.weight.copy_(torch.from_numpy(params[name]["scale"]))
            bn.bias.copy_(torch.from_numpy(params[name]["bias"]))
            bn.running_mean.copy_(torch.from_numpy(stats[name]["mean"]))
            bn.running_var.copy_(torch.from_numpy(stats[name]["var"]))
    y = port(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(y_j), atol=1e-5, rtol=1e-5)
    for name, bn in port.bns.items():
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   upd["batch_stats"][name]["mean"],
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   upd["batch_stats"][name]["var"],
                                   atol=1e-5, rtol=1e-5)


# --- optimizer and clip -------------------------------------------------------
@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_optimizer_and_clip_match_optax(kind):
    rng = np.random.default_rng(1)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 2, 3)}
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    jtx = jax_train.make_optimizer(jax_train.TrainConfig(optimizer=kind),
                                   include_clip=True)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jtx.init(jparams)
    tx = port_train.make_optimizer(port_train.TrainConfig(optimizer=kind))
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = tx.init(tparams)
    lr = 1e-2
    for step, scale in enumerate((0.3, 4.0, 0.05, 10.0)):  # clip on and off
        grads = {k: (rng.normal(0, 1, s) * scale).astype(np.float32)
                 for k, s in shapes.items()}
        upd, jstate = jtx.update(jax.tree.map(jnp.asarray, grads), jstate,
                                 jparams)
        jparams = jax.tree.map(lambda p, u: p - lr * u, jparams, upd)
        g = {k: torch.from_numpy(v) for k, v in grads.items()}
        gnorm = port_train.global_norm(g)
        np.testing.assert_allclose(gnorm.item(),
                                   float(optax.global_norm(grads)), rtol=1e-6)
        g = port_train._clip_by_known_norm(g, gnorm, 5.0)
        u = tx.update(g, tstate)
        for k in tparams:
            tparams[k] -= (lr * u[k])
            np.testing.assert_allclose(tparams[k].numpy(),
                                       np.asarray(jparams[k]), atol=1e-6,
                                       rtol=1e-6, err_msg=f"{kind} {step} {k}")
    arrays = port_train.Optimizer.state_numpy(tstate)
    fresh = tx.init(tparams)
    port_train.Optimizer.load_numpy(fresh, arrays)
    assert all(torch.equal(fresh[k], tstate[k]) for k in tstate)


# --- one full train step ------------------------------------------------------
_STEPS = {}


def _one_train_step(synth_dir, compute_dtype):
    """SGD (the update is the clipped gradient itself) at lr 1, so the
    parameter change after one step IS each framework's clipped gradient.
    Returns the port's and JAX's metrics, {name: (port, JAX)} of those
    gradients and of the updated ``batch_stats``; each dtype's step runs
    once per module."""
    key = (str(synth_dir), compute_dtype)
    if key not in _STEPS:
        _STEPS[key] = _run_one_train_step(synth_dir, compute_dtype)
    return _STEPS[key]


def _run_one_train_step(synth_dir, compute_dtype):
    over = dict(optimizer="sgd", dropout=0.0, augment=0.0,
                ctc_impl="pallas_interpret", compute_dtype=compute_dtype)
    jcfg = jax_train.TrainConfig(**{**jax_train.PRESETS["synth-tiny"], **over})
    jds = JaxDataset(synth_dir, "train")
    jalpha = JaxAlphabet.build(jds.transcripts())
    mcfg = dataclasses.replace(jcfg.model_config(jalpha.num_classes),
                               lstm_impl="pallas_interpret")
    jmodel = JaxModel(mcfg)
    variables = jax.device_get(jmodel.init_params(jax.random.PRNGKey(0)))
    pipe = JaxPipeline(jds, jalpha, jcfg.contract(), batch_pixels=2**15,
                       drop_remainder=True, shuffle=False)
    batch = next(iter(pipe.epoch(0)))
    batch.valid[-1] = False  # one padding duplicate: weights are used
    weights = batch.valid.astype(np.float32)

    tx = jax_train.make_optimizer(jcfg, include_clip=False)
    state = jax_train.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        step=jnp.asarray(0, jnp.int32))
    jstep = jax_train.make_train_step(jmodel, tx, False, "pallas_interpret",
                                      grad_clip=5.0)
    new_state, jm = jstep(state, batch.images, batch.widths, batch.labels,
                          batch.label_lengths, jnp.asarray(weights),
                          jnp.asarray(1.0, jnp.float32),
                          jax.random.PRNGKey(0))
    jgrads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                          variables["params"], jax.device_get(new_state.params))
    jgrads = variables_to_state_dict({"params": jgrads})
    jstats = variables_to_state_dict(
        {"batch_stats": jax.device_get(new_state.batch_stats)})

    pcfg = port_train.TrainConfig(**{**port_train.PRESETS["synth-tiny"],
                                     **over})
    model = CnnLstmOcr(ModelConfig.from_json(mcfg.to_json()))
    assert model.config.compute_dtype == compute_dtype
    model.load_state_dict(variables_to_state_dict(variables))
    ptx = port_train.make_optimizer(pcfg)
    pstate = port_train.TrainState(
        model=model, opt_state=ptx.init(dict(model.named_parameters())))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = port_train.make_train_step(model, ptx, False, "pallas_interpret",
                                      grad_clip=5.0)
    pm = step(pstate, *(torch.from_numpy(a) for a in (
        batch.images, batch.widths, batch.labels, batch.label_lengths,
        weights)), 1.0)
    assert pstate.step == 1
    after = model.state_dict()
    grads = {name: ((before[name] - after[name]).numpy(), g.numpy())
             for name, g in jgrads.items()
             if not name.endswith("num_batches_tracked")}
    stats = {name: (after[name].numpy(), v.numpy())
             for name, v in jstats.items()
             if not name.endswith("num_batches_tracked")}
    return pm, jm, grads, stats


def test_one_train_step_matches_jax(synth_dir):
    pm, jm, grads, stats = _one_train_step(synth_dir, "float32")
    np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(pm["gnorm"].item(), float(jm["gnorm"]),
                               rtol=1e-4)
    assert float(jm["gnorm"]) > 5.0  # the clip is exercised
    for name, (ours, ref) in grads.items():
        np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=1e-3,
                                   err_msg=name)
    for name, (ours, ref) in stats.items():
        np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5,
                                   err_msg=name)


# bf16 bounds of one train step against JAX. Both frameworks round the
# same operands to bf16 at the same points (8 significant bits: one
# rounding moves a value by up to 2**-9 of it), but their sums run in
# another order, so now and then a value lands one bf16 ulp away, and the
# backward compounds such flips layer by layer (BatchNorm's backward
# subtracts means, which magnifies them). How much rounding explains is
# read off JAX itself: its own bf16 step against its f32 step. So the
# loss and the global norm within 2**-8 relative, and every clipped
# gradient and updated BN statistic within twice JAX's own bf16-vs-f32
# difference on that tensor (2**-8 at least), and within 2**-4 of its
# largest f32 magnitude.
BF16_STEP_LOSS_REL = 2.0 ** -8
BF16_STEP_TENSOR_REL = 2.0 ** -4


def test_one_bf16_train_step_matches_jax(synth_dir):
    """The bf16 path (compute_dtype="bfloat16": bf16 convolutions, input
    projections and recurrences; f32 BN statistics, head and CTC) against
    JAX's own bf16 step, with JAX's kernels in interpret mode."""
    pm, jm, grads, stats = _one_train_step(synth_dir, "bfloat16")
    _, _, grads32, stats32 = _one_train_step(synth_dir, "float32")
    assert np.isfinite(pm["loss"].item())
    np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]),
                               rtol=BF16_STEP_LOSS_REL)
    np.testing.assert_allclose(pm["gnorm"].item(), float(jm["gnorm"]),
                               rtol=BF16_STEP_LOSS_REL)
    assert float(jm["gnorm"]) > 5.0  # the clip is exercised
    f32 = {**grads32, **stats32}
    for name, (ours, ref) in {**grads, **stats}.items():
        scale = max(float(np.abs(f32[name][1]).max()), 1e-30)
        gap = float(np.abs(ours - ref).max()) / scale
        rounding = float(np.abs(ref - f32[name][1]).max()) / scale
        assert gap <= BF16_STEP_TENSOR_REL, (name, gap)
        assert gap <= max(2.0 * rounding, 2.0 ** -8), (name, gap, rounding)


# --- the two repairs ------------------------------------------------------------
def test_bf16_input_projection_rounds_once_after_the_bias():
    """x = 1.5, wx = 171, b = 1 are exact in bf16: the f32 product 256.5
    plus 1 rounds to 258, while rounding the product first gives
    bf16(bf16(256.5) + 1) = bf16(257) = 256."""
    x = np.full((1, 1, 1), 1.5, np.float32)
    wx = np.full((1, 4), 171.0, np.float32)
    b = np.ones((4,), np.float32)
    ref = (jnp.dot(jnp.asarray(x).astype(jnp.bfloat16),
                   jnp.asarray(wx).astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)
           + jnp.asarray(b)).astype(jnp.bfloat16)
    ours = input_projection(torch.from_numpy(x), torch.from_numpy(wx),
                            torch.from_numpy(b), torch.bfloat16)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_array_equal(ours.float().numpy(),
                                  np.asarray(ref, np.float32))
    assert ours.float().flatten().tolist() == [258.0] * 4


def _lecun_tensors_port(model):
    out = {f"cnn.{n}": (c.weight.detach().numpy(),
                        c.weight.shape[1] * 9)
           for n, c in model.cnn.convs.items()}
    for n in ("bridge", "head"):
        w = getattr(model, n).weight.detach().numpy()
        out[n] = (w, w.shape[1])
    return out


def _lecun_tensors_jax(params):
    out = {f"cnn.{n}": (np.asarray(v["kernel"]),
                        int(np.prod(v["kernel"].shape[:3])))
           for n, v in params["cnn"].items() if "kernel" in v}
    for n in ("bridge", "head"):
        w = np.asarray(params[n]["kernel"])
        out[n] = (w, w.shape[0])
    return out


def test_initialisers_are_flax_lecun_normal():
    cfg_kw = dict(num_classes=40, line_height=32,
                  stages=((16, 2, (2, 2)), (32, 2, (2, 2)), (32, 2, (2, 1))),
                  bridge_dim=64, lstm_hidden=64, lstm_layers=1,
                  compute_dtype="float32")
    stages = cfg_kw.pop("stages")
    model = CnnLstmOcr(ModelConfig(
        stages=tuple(ConvStageSpec(*s) for s in stages), **cfg_kw))
    init_parameters(model, torch.Generator().manual_seed(0))
    jparams = JaxModel(JaxConfig(
        stages=tuple(JaxStage(*s) for s in stages), **cfg_kw)).init_params(
        jax.random.PRNGKey(0))["params"]
    for tensors in (_lecun_tensors_port(model), _lecun_tensors_jax(jparams)):
        assert len(tensors) == 7
        for name, (w, fan_in) in tensors.items():
            std = math.sqrt(1.0 / fan_in)
            sigma0 = std / 0.87962566103423978
            assert np.abs(w).max() <= 2 * sigma0 * (1 + 1e-6), name
            assert abs(w.std() / std - 1) < 0.05, (name, w.std(), std)
            assert abs(w.mean()) < 0.1 * std, name


# --- a short fit -------------------------------------------------------------------
def test_fit_learns_snapshots_resumes_and_loads_into_jax(synth_dir, tmp_path):
    run = str(tmp_path / "run")
    base = dict(port_train.PRESETS["synth-tiny"])
    base.update(data_dir=synth_dir, snapshot_dir=run, epochs=200,
                max_steps=60, val_interval_steps=30, log_interval=10,
                batch_pixels=2**17, seed=1)
    cfg = port_train.TrainConfig(**base)
    s1 = port_train.fit(cfg, device="cpu", log=lambda *a: None)
    assert s1["steps"] == 60 and s1["best_cer"] is not None
    recs = [json.loads(line) for line in
            open(os.path.join(run, "metrics.jsonl")).read().splitlines()]
    losses = [r["loss"] for r in recs if "loss" in r]
    assert len(losses) == 6 and losses[-1] < 0.5 * losses[0], losses
    assert any("val_cer" in r for r in recs)
    for tag in ("last", "best"):
        assert os.path.exists(os.path.join(run, tag, "meta.json"))
    assert has_opt_state(os.path.join(run, "last"))

    cfg2 = dataclasses.replace(cfg, max_steps=20, resume=True)
    s2 = port_train.fit(cfg2, device="cpu", log=lambda *a: None)
    assert s2["steps"] == 80
    variables, mcfg, _, _, meta = load_snapshot(os.path.join(run, "last"))
    assert meta["step"] == 80 and meta["extra"]["final"]
    assert meta["extra"]["train_config"]["seed"] == 1

    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (3, 32, 96), np.uint8)
    widths = np.array([96, 61, 5], np.int32)
    model, _, _ = load_model(os.path.join(run, "last"), "cpu")
    with torch.inference_mode():
        lp, fm = model(torch.from_numpy(images), torch.from_numpy(widths))
    jmodel = JaxModel(JaxConfig.from_json(mcfg.to_json()))
    lp_j, fm_j = jmodel.apply(jax.tree.map(jnp.asarray, variables),
                              jnp.asarray(images), jnp.asarray(widths))
    fm = fm.numpy()
    np.testing.assert_array_equal(fm, np.asarray(fm_j))
    np.testing.assert_allclose(lp.numpy()[fm], np.asarray(lp_j)[fm],
                               atol=1e-4, rtol=1e-4)


def test_device_time_summary_counts_busy_union_and_kernels():
    """The profiler window's summary: overlapping device intervals count
    once toward busy time, kernels are totalled by name, host events
    only widen the window."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import Interval

    from vistaocr_tpu_torch.train import device_time_summary

    def ev(name, start, end, dev=DeviceType.CUDA):
        return SimpleNamespace(name=name, device_type=dev,
                               time_range=Interval(start, end))

    events = [ev("host", 0, 1000, DeviceType.CPU), ev("k_a", 100, 300),
              ev("k_a", 200, 400), ev("k_b", 600, 700)]
    lines = device_time_summary(events).splitlines()
    assert lines[0] == ("window 1.0 ms, device busy 0.4 ms (40.0%), device "
                        "time 0.5 ms in 3 events")
    assert lines[1].split() == ["0.400", "ms", "80.0%", "2", "x", "200.00",
                                "us", "k_a"]
    assert lines[2].split() == ["0.100", "ms", "20.0%", "1", "x", "100.00",
                                "us", "k_b"]
    assert device_time_summary([]) == "no events\n"
