"""Snapshots between the port and the JAX package, on the CPU:

- the port's flax msgpack writer (``flax_msgpack_bytes``) against flax:
  ``serialization.from_bytes`` and the port's ``read_flax_msgpack`` give
  back the tree that was written;
- a snapshot written by the port's ``fit`` opens with the JAX package's
  ``vistaocr_tpu.checkpoint.load_model``, whose log-probs agree with the
  port's within 1e-4 on valid frames, with equal frame masks;
- a JAX snapshot written over a port run's ``last/`` is read as the JAX
  package wrote it (the stale ``weights.npz`` and ``opt_state.npz`` are
  not taken; its ``opt_state.msgpack`` is), and after the port resumes it,
  no file in ``last/`` disagrees with its ``meta.json``: the
  ``opt_state.msgpack`` is the port's new state, and the JAX package
  reads the port's new weights;
- the optimizer state crosses packages: the port's ``opt_state.msgpack``
  is byte-equal to flax's serialisation of the JAX trainer's optax state,
  and a JAX run resumed by the port, and a port run resumed by JAX, each
  end within 1e-4 of the same run resumed by its own package (f32,
  dropout and augment 0, Adam).
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import serialization

from vistaocr_tpu import checkpoint as jax_ckpt
from vistaocr_tpu import train as jax_train
from vistaocr_tpu.data import build_synthetic_dataset
from vistaocr_tpu.data.buckets import ShapeContract as JaxContract
from vistaocr_tpu.data.synth import SynthConfig
from vistaocr_tpu.models import CnnLstmOcr as JaxModel
from vistaocr_tpu.models import ModelConfig as JaxConfig
from vistaocr_tpu.models.cnn import ConvStageSpec as JaxStage
from vistaocr_tpu.text import Alphabet as JaxAlphabet

from vistaocr_tpu_torch import checkpoint
from vistaocr_tpu_torch import train as port_train
from vistaocr_tpu_torch.models import CnnLstmOcr, ModelConfig

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    cfg = SynthConfig(language="charset", charset="abcdeo ", min_words=1,
                      max_words=3)
    return build_synthetic_dataset(str(d), num_train=64, num_val=16,
                                   height=32, max_width=384, config=cfg,
                                   seed=5)


def _fit(data_dir, run, steps, **kw):
    base = dict(port_train.PRESETS["synth-tiny"])
    base.update(data_dir=data_dir, snapshot_dir=run, epochs=50,
                max_steps=steps, val_interval_steps=steps, log_interval=5,
                batch_pixels=2**17, seed=2, **kw)
    return port_train.fit(port_train.TrainConfig(**base), device="cpu",
                          log=lambda *a: None)


def _lines(seed=3):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (3, 32, 96), np.uint8)
    widths = np.array([96, 61, 5], np.int32)
    return images, widths


def _flat_equal(a, b):
    fa, fb = checkpoint.flatten(a), checkpoint.flatten(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k])


def _jax_tree(seed):
    cfg = JaxConfig(num_classes=11, line_height=32,
                    stages=(JaxStage(8, 2, (2, 2)), JaxStage(16, 2, (2, 2)),
                            JaxStage(16, 2, (2, 1))),
                    bridge_dim=32, lstm_hidden=24, lstm_layers=2,
                    compute_dtype="float32")
    variables = JaxModel(cfg).init_params(jax.random.PRNGKey(seed), batch=2,
                                          width=64)
    return jax.tree.map(lambda x: np.asarray(x, np.float32), variables)


def _odd_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"scalar": np.array(2.5, np.float32),
                  "ints": rng.integers(-9, 9, (3, 4)).astype(np.int32),
                  "empty": np.zeros((0, 5), np.float32)},
            "b": rng.normal(0, 1, (2, 3, 4)).astype(np.float64),
            "c": {"d": {"e": rng.normal(0, 1, (7,)).astype(np.float16)}}}


@pytest.mark.parametrize("make", [_jax_tree, _odd_tree],
                         ids=["model-variables", "dtypes-and-shapes"])
def test_flax_msgpack_writer_round_trips_through_flax_and_reader(tmp_path,
                                                                 make):
    tree = make(4)
    payload = checkpoint.flax_msgpack_bytes(tree)
    # flax, against a target of the same structure and without one
    _flat_equal(serialization.from_bytes(jax.tree.map(np.zeros_like, tree),
                                         payload), tree)
    _flat_equal(serialization.msgpack_restore(payload), tree)
    path = os.path.join(str(tmp_path), "weights.msgpack")
    with open(path, "wb") as f:
        f.write(payload)
    _flat_equal(checkpoint.read_flax_msgpack(path), tree)


def test_flax_msgpack_writer_matches_flax_bytes():
    tree = _jax_tree(6)
    assert checkpoint.flax_msgpack_bytes(tree) == serialization.to_bytes(tree)


def test_port_fit_snapshot_opens_in_jax(synth_dir, tmp_path):
    run = str(tmp_path / "run")
    _fit(synth_dir, run, steps=12)
    images, widths = _lines()
    for tag in ("last", "best"):
        snap = os.path.join(run, tag)
        model, _, _ = checkpoint.load_model(snap, "cpu")
        with torch.inference_mode():
            lp, fm = model(torch.from_numpy(images), torch.from_numpy(widths))
        jmodel, jvars, jalphabet, _ = jax_ckpt.load_model(snap)
        lp_j, fm_j = jmodel.apply(jvars, jnp.asarray(images),
                                  jnp.asarray(widths))
        fm = fm.numpy()
        np.testing.assert_array_equal(fm, np.asarray(fm_j))
        np.testing.assert_allclose(lp.numpy()[fm], np.asarray(lp_j)[fm],
                                   atol=1e-4, rtol=1e-4)
        assert jalphabet.num_classes == model.config.num_classes


def test_port_resume_of_jax_run_retires_stale_files(synth_dir, tmp_path):
    run = str(tmp_path / "run")
    _fit(synth_dir, run, steps=6)
    last = os.path.join(run, "last")
    # the JAX package writes its own snapshot over the port's last/: other
    # weights, its optax state, a meta.json that names no port state
    _, _, _, _, meta = checkpoint.load_snapshot(last)
    jcfg = JaxConfig.from_json(json.dumps(meta["model_config"]))
    jvars = JaxModel(jcfg).init_params(jax.random.PRNGKey(21))
    tx = jax_train.make_optimizer(jax_train.TrainConfig(),
                                  include_clip=False)
    jax_ckpt.save_snapshot(
        last, variables=jvars, model_config=jcfg,
        alphabet=JaxAlphabet.from_json(json.dumps(meta["alphabet"])),
        contract=JaxContract.from_json(json.dumps(meta["contract"])),
        step=40, opt_state=tx.init(jvars["params"]))
    for name in ("weights.npz", "opt_state.npz", "opt_state.msgpack"):
        assert os.path.exists(os.path.join(last, name)), name
    variables, _, _, _, _ = checkpoint.load_snapshot(last)
    _flat_equal(variables, jax.tree.map(np.asarray, jax.device_get(jvars)))
    # JAX's optimizer state, not the stale npz: a fresh state at count 0
    assert checkpoint.has_opt_state(last)
    jopt = checkpoint.load_opt_state(last)
    assert int(jopt["count"]) == 0
    assert not any(np.any(v) for k, v in jopt.items() if k != "count")

    summary = _fit(synth_dir, run, steps=4, resume=True)
    assert summary["steps"] == 44
    assert checkpoint.has_opt_state(last)
    # both optimizer files are the port's new state (4 Adam steps on
    # JAX's fresh one)
    port_opt = checkpoint.load_opt_state(last)
    assert int(port_opt["count"]) == 4
    jax_file = os.path.join(last, "opt_state.msgpack")
    _flat_equal(checkpoint.unflatten(checkpoint.opt_state_from_flax(
        checkpoint.read_flax_msgpack(jax_file))),
        checkpoint.unflatten(port_opt))
    port_vars, _, _, _, port_meta = checkpoint.load_snapshot(last)
    jax_vars, _, _, _, jax_meta = jax_ckpt.load_snapshot(last)
    assert port_meta["step"] == jax_meta["step"] == 44
    _flat_equal(jax.tree.map(np.asarray, jax.device_get(jax_vars)),
                port_vars)
    with np.load(os.path.join(last, "weights.npz")) as z:
        _flat_equal(checkpoint.unflatten({k: z[k] for k in z.files}),
                    port_vars)
    # the resumed run trained on from the JAX weights
    moved = [k for k, v in checkpoint.flatten(port_vars).items()
             if not np.array_equal(v, checkpoint.flatten(variables)[k])]
    assert moved


def test_has_opt_state_follows_meta(tmp_path):
    from vistaocr_tpu_torch.data import ShapeContract
    from vistaocr_tpu_torch.text import Alphabet

    cfg = dataclasses.replace(ModelConfig(num_classes=5), bridge_dim=16,
                              lstm_hidden=8, lstm_layers=1)
    model = CnnLstmOcr(cfg)
    kw = dict(state_dict=model.state_dict(), model_config=cfg,
              alphabet=Alphabet.from_charset("abcd"), contract=ShapeContract())
    opt = port_train.Optimizer("adam").init(dict(model.named_parameters()))
    checkpoint.save_snapshot(str(tmp_path), **kw,
                             opt_state=port_train.Optimizer.state_numpy(opt))
    assert checkpoint.has_opt_state(str(tmp_path))
    checkpoint.save_snapshot(str(tmp_path), **kw)  # no optimizer state now
    assert not checkpoint.has_opt_state(str(tmp_path))
    assert not os.path.exists(str(tmp_path / "opt_state.msgpack"))


# --- the optimizer state across packages ------------------------------------
@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_opt_state_msgpack_is_flax_bytes_of_the_jax_trainer_state(kind):
    """The port's optimizer state, written as ``opt_state.msgpack``, is
    byte for byte flax's serialisation of the JAX trainer's state holding
    the same moments (layouts mapped), and reads back to the same arrays."""
    jcfg = JaxConfig(num_classes=11, line_height=32,
                     stages=(JaxStage(8, 2, (2, 2)), JaxStage(16, 2, (2, 2)),
                             JaxStage(16, 2, (2, 1))),
                     bridge_dim=32, lstm_hidden=24, lstm_layers=2,
                     compute_dtype="float32")
    params = _jax_tree(6)["params"]
    tx = jax_train.make_optimizer(jax_train.TrainConfig(optimizer=kind),
                                  include_clip=False)
    rng = np.random.default_rng(9)
    state = jax.tree.map(
        lambda x: np.asarray(rng.normal(0, 1, np.shape(x)), np.float32)
        if np.asarray(x).dtype == np.float32
        else np.asarray(7, np.int32), tx.init(params))
    ref = serialization.to_bytes(state)
    port = checkpoint.opt_state_from_flax(serialization.msgpack_restore(ref))
    assert int(port["count"]) == (7 if kind == "adam" else 0)
    assert checkpoint.flax_msgpack_bytes(
        checkpoint.opt_state_to_flax(port)) == ref
    model = CnnLstmOcr(ModelConfig.from_json(jcfg.to_json()))
    want = port_train.Optimizer(kind).init(dict(model.named_parameters()))
    assert set(port) == set(want)


_SWITCH = dict(n=4, k=3)  # steps before and after the switch


@pytest.fixture(scope="module")
def one_bucket_data(tmp_path_factory):
    """Lines that all fall in one 384-px bucket (one train shape for each
    package to build), no validation split."""
    d = tmp_path_factory.mktemp("synth_one")
    cfg = SynthConfig(language="charset", charset="abcdeo ", min_words=1,
                      max_words=2)
    return build_synthetic_dataset(str(d), num_train=40, num_val=0,
                                   height=32, max_width=384, config=cfg,
                                   seed=8)


def _switch_cfg(pkg, data_dir, run, steps, resume):
    return pkg.TrainConfig(**{
        **pkg.PRESETS["synth-tiny"], "data_dir": data_dir,
        "snapshot_dir": run, "bucket_widths": (384,), "batch_pixels": 2**17,
        "dropout": 0.0, "augment": 0.0, "ctc_impl": "scan", "epochs": 1000,
        "max_steps": steps, "val_interval_steps": 10**6, "log_interval": 1,
        "seed": 4, "resume": resume})


def _run(pkg, data_dir, run, steps, resume=False):
    cfg = _switch_cfg(pkg, data_dir, run, steps, resume)
    if pkg is port_train:
        return pkg.fit(cfg, device="cpu", log=lambda *a: None)
    return pkg.fit(cfg, log=lambda *a: None)


def _params_after(run):
    variables, _, _, _, meta = checkpoint.load_snapshot(
        os.path.join(run, "last"))
    return checkpoint.flatten(variables["params"]), meta["step"]


@pytest.mark.parametrize("first,then", [(jax_train, port_train),
                                        (port_train, jax_train)],
                         ids=["jax-then-port", "port-then-jax"])
def test_resume_crosses_packages_with_the_moments(one_bucket_data, tmp_path,
                                                  monkeypatch, first, then):
    """n Adam steps in one package, then k more resumed by the other: the
    parameters end within 1e-4 of the same n steps resumed by their own
    package. Resuming without the moments would not (Adam's first steps
    from fresh moments move every parameter by about lr)."""
    monkeypatch.setenv("JAX_CACHE_DIR", str(tmp_path / "jax_cache"))
    n, k = _SWITCH["n"], _SWITCH["k"]
    base = str(tmp_path / "base")
    _run(first, one_bucket_data, base, n)
    runs = {}
    for name, pkg in (("same", first), ("switched", then)):
        runs[name] = str(tmp_path / name)
        shutil.copytree(base, runs[name])
        _run(pkg, one_bucket_data, runs[name], k, resume=True)
    same, step_a = _params_after(runs["same"])
    switched, step_b = _params_after(runs["switched"])
    assert step_a == step_b == n + k
    start, _ = _params_after(base)
    moved = max(np.abs(same[p] - start[p]).max() for p in same)
    assert moved > 1e-3  # the k steps moved the parameters
    for p in same:
        np.testing.assert_allclose(switched[p], same[p], atol=1e-4, rtol=0,
                                   err_msg=p)
