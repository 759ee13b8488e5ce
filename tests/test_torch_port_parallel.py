"""Data parallelism in the port (``parallel/mesh.py``, the sharded
pipeline, BatchNorm's and the CTC mean's global reductions, ``fit`` over
ranks, ``OcrService(mesh_data=...)``) on the CPU:

- two gloo ranks (``tests/torch_port_dp_child.py``) against one process
  on the same global batch of the tiny f32 model (dropout 0, augment 0,
  one padding row): loss within 1e-5 relative, parameters after one Adam
  step within JAX's DP tolerances (atol 3e-3, rtol 2e-2,
  ``tests/test_train.py``), the two ranks' state dicts bit-equal;
- the same two ranks' SGD step (lr 1: the parameter change is the clipped
  gradient) against JAX's step over a two-device ``('data',)`` mesh from
  the same numpy weights and batch, within the bounds of
  ``test_torch_port_train.py::test_one_train_step_matches_jax``;
- BatchNorm's all-reduce against flax BatchNorm over the global batch:
  output, input and parameter gradients and running statistics, which
  are bit-equal on both ranks;
- ``python -m vistaocr_tpu_torch.train`` as two processes: the same step
  count and validation CER on both, one ``last/``, no metrics record
  twice; a rank with another seed stops both with the fingerprint error;
- ``plan_fingerprint`` equal to the JAX pipeline's, and a sharded epoch's
  rows joined equal to the global batch;
- the service: ``mesh_data=-1`` on the CPU (one device) equal to 0; two
  shards (the device list patched to the CPU twice) give the texts of
  one for greedy, the device beam, the host beam and int8; the ladder
  holds multiples of 2; a mesh over more devices than there are raises.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vistaocr_tpu import checkpoint as jax_ckpt
from vistaocr_tpu import train as jax_train
from vistaocr_tpu.data import BatchPipeline as JaxPipeline
from vistaocr_tpu.data import ShardedLineDataset as JaxDataset
from vistaocr_tpu.data import build_synthetic_dataset
from vistaocr_tpu.data.buckets import ShapeContract as JaxContract
from vistaocr_tpu.data.synth import SynthConfig
from vistaocr_tpu.models import CnnLstmOcr as JaxModel
from vistaocr_tpu.models import ModelConfig as JaxConfig
from vistaocr_tpu.models.cnn import ConvStack as JaxConvStack
from vistaocr_tpu.models.cnn import ConvStageSpec as JaxStage
from vistaocr_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from vistaocr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vistaocr_tpu.parallel.mesh import replicated, shard_batch_arrays
from vistaocr_tpu.text import Alphabet as JaxAlphabet

from vistaocr_tpu_torch import train as port_train
from vistaocr_tpu_torch.checkpoint import variables_to_state_dict
from vistaocr_tpu_torch.data import BatchPipeline, open_dataset
from vistaocr_tpu_torch.models import ModelConfig
from vistaocr_tpu_torch.models.quant import quantize_snapshot
from vistaocr_tpu_torch.parallel import mesh as pmesh
from vistaocr_tpu_torch.serve import OcrService, ServiceConfig
from vistaocr_tpu_torch.text import Alphabet

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHARSET = "abcdeo "
RANK_TIMEOUT_S = 180  # a spawned rank's limit; every rank is killed after


def _child():
    spec = importlib.util.spec_from_file_location(
        "torch_port_dp_child", os.path.join(ROOT, "tests",
                                            "torch_port_dp_child.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


child = _child()


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    cfg = SynthConfig(language="charset", charset=CHARSET, min_words=1,
                      max_words=3)
    return build_synthetic_dataset(str(d), num_train=96, num_val=24,
                                   height=32, max_width=384, config=cfg,
                                   seed=11)


# --- two ranks of one train step ----------------------------------------------
BN_STAGES = ((6, 2, (2, 2)), (5, 1, (2, 1)))


def _bn_case(rng):
    """A small flax ConvStack with random statistics and affine
    parameters, an NCHW input of 4 rows and the output's cotangent."""
    x = rng.normal(0.3, 1.5, (4, 2, 12, 8)).astype(np.float32)
    jstack = JaxConvStack(stages=tuple(JaxStage(c, n, p)
                                       for c, n, p in BN_STAGES))
    variables = jax.device_get(jstack.init(
        jax.random.PRNGKey(0), jnp.asarray(x.transpose(0, 2, 3, 1)),
        train=False))
    params = jax.tree.map(np.array, variables["params"])
    stats = jax.tree.map(np.array, variables["batch_stats"])
    for name in stats:
        c = stats[name]["mean"].shape[0]
        stats[name]["mean"] = rng.normal(0, 1, c).astype(np.float32)
        stats[name]["var"] = rng.uniform(0.5, 2, c).astype(np.float32)
        params[name]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        params[name]["bias"] = rng.normal(0, 0.5, c).astype(np.float32)
    sd = {}
    for name, p in params.items():
        if "kernel" in p:
            sd[f"convs.{name}.weight"] = p["kernel"].transpose(3, 2, 0, 1)
        else:
            sd[f"bns.{name}.weight"] = p["scale"]
            sd[f"bns.{name}.bias"] = p["bias"]
    for name, s in stats.items():
        sd[f"bns.{name}.running_mean"] = s["mean"]
        sd[f"bns.{name}.running_var"] = s["var"]
        sd[f"bns.{name}.num_batches_tracked"] = np.zeros((), np.int64)
    y_shape = jstack.apply({"params": params, "batch_stats": stats},
                           jnp.asarray(x.transpose(0, 2, 3, 1)), train=True,
                           mutable=["batch_stats"])[0].shape
    g = rng.normal(0, 1, y_shape).astype(np.float32).transpose(0, 3, 1, 2)
    return jstack, params, stats, x, g, sd


@pytest.fixture(scope="module")
def dp_run(synth_dir, tmp_path_factory):
    """The job (tiny f32 model from JAX's init, one global batch of 8 with
    its last row padding; Adam lr 1e-3 and SGD lr 1, one step each; the
    BatchNorm case), the two ranks' outputs and the one-process run."""
    job = str(tmp_path_factory.mktemp("dp_job"))
    over = dict(dropout=0.0, augment=0.0)
    jcfg = jax_train.TrainConfig(**{**jax_train.PRESETS["synth-tiny"], **over})
    jds = JaxDataset(synth_dir, "train")
    jalpha = JaxAlphabet.build(jds.transcripts())
    mcfg = dataclasses.replace(jcfg.model_config(jalpha.num_classes),
                               lstm_impl="scan")
    variables = jax.device_get(JaxModel(mcfg).init_params(
        jax.random.PRNGKey(0)))
    pipe = JaxPipeline(jds, jalpha, jcfg.contract(), batch_pixels=2**15,
                       batch_multiple=2, drop_remainder=True, shuffle=False)
    batch = next(iter(pipe.epoch(0)))
    assert batch.size == 8
    batch.valid[-1] = False  # the ranks' weight sums differ: 4 and 3
    np.savez(os.path.join(job, "weights.npz"), **{
        f"sd/{k}": v.numpy()
        for k, v in variables_to_state_dict(variables).items()})
    np.savez(os.path.join(job, "batches.npz"), images_0=batch.images,
             widths_0=batch.widths, labels_0=batch.labels,
             label_lengths_0=batch.label_lengths, valid_0=batch.valid)
    port_cfg = dataclasses.replace(ModelConfig.from_json(mcfg.to_json()),
                                   lstm_impl="auto").to_json()
    jstack, bparams, bstats, x, g, bsd = _bn_case(np.random.default_rng(4))
    np.savez(os.path.join(job, "bn.npz"), x=x, g=g,
             **{f"sd/{k}": v for k, v in bsd.items()})
    with open(os.path.join(job, "job.json"), "w") as f:
        json.dump({"runs": [
            {"config": port_cfg, "optimizer": "adam", "lr": 1e-3, "steps": 1},
            {"config": port_cfg, "optimizer": "sgd", "lr": 1.0, "steps": 1}],
            "bn": {"stages": BN_STAGES, "in_channels": 2}}, f)
    ranks, _ = child.spawn_ranks(job, 2, "cpu", "gloo", RANK_TIMEOUT_S)
    one = child.run_job(job)
    return dict(ranks=ranks, one=one, variables=variables, batch=batch,
                mcfg=mcfg, jcfg=jcfg, bn=(jstack, bparams, bstats, x, g))


def test_two_ranks_equal_one_process(dp_run):
    r0, r1 = dp_run["ranks"]
    one = dp_run["one"]
    assert sorted(r0) == sorted(r1)
    for k in r0:  # the BatchNorm case's rows and partial sums differ
        if not k.startswith("bn/"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    for run in ("0", "1"):
        np.testing.assert_allclose(r0[f"{run}/loss"], one[f"{run}/loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(r0[f"{run}/gnorm"], one[f"{run}/gnorm"],
                                   rtol=1e-4)
    names = [k for k in one if k.startswith("0/sd/")
             and not k.endswith("num_batches_tracked")]
    assert len(names) > 10
    for k in names:  # the Adam step
        np.testing.assert_allclose(r0[k], one[k], atol=3e-3, rtol=2e-2,
                                   err_msg=k)


def test_two_ranks_match_jax_data_mesh(dp_run):
    """JAX's SGD step at lr 1 over a two-device ('data',) mesh, with the
    batch sharded and the state replicated."""
    variables, batch, jcfg = dp_run["variables"], dp_run["batch"], \
        dp_run["jcfg"]
    jcfg = dataclasses.replace(jcfg, optimizer="sgd")
    jmodel = JaxModel(dp_run["mcfg"])
    tx = jax_train.make_optimizer(jcfg, include_clip=False)
    mesh = jax_make_mesh(JaxMeshConfig(data=2), devices=jax.devices()[:2])
    state = jax.device_put(jax_train.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        step=jnp.asarray(0, jnp.int32)), replicated(mesh))
    sh = shard_batch_arrays(mesh)
    args = [jax.device_put(a, sh[f]) for a, f in (
        (batch.images, "images"), (batch.widths, "widths"),
        (batch.labels, "labels"), (batch.label_lengths, "label_lengths"))]
    w = jax.device_put(jnp.asarray(batch.valid, jnp.float32), sh["widths"])
    step = jax_train.make_train_step(jmodel, tx, False, "scan", grad_clip=5.0)
    new_state, jm = step(state, *args, w, jnp.asarray(1.0, jnp.float32),
                         jax.random.PRNGKey(0))
    jgrads = variables_to_state_dict({"params": jax.tree.map(
        lambda a, b: np.asarray(a) - np.asarray(b), variables["params"],
        jax.device_get(new_state.params))})
    jstats = variables_to_state_dict(
        {"batch_stats": jax.device_get(new_state.batch_stats)})
    r0 = dp_run["ranks"][0]
    np.testing.assert_allclose(r0["1/loss"][0], float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(r0["1/gnorm"][0], float(jm["gnorm"]),
                               rtol=1e-4)
    assert float(jm["gnorm"]) > 5.0  # the clip is exercised
    before = variables_to_state_dict(variables)
    for name, ref in jgrads.items():
        ours = before[name].numpy() - r0[f"1/sd/{name}"]
        np.testing.assert_allclose(ours, ref.numpy(), atol=2e-4, rtol=1e-3,
                                   err_msg=name)
    for name, ref in jstats.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(r0[f"1/sd/{name}"], ref.numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=name)


def test_batchnorm_all_reduce_matches_flax_over_the_global_batch(dp_run):
    jstack, params, stats, x, g = dp_run["bn"]
    r0, r1 = dp_run["ranks"]

    def loss(x_nhwc, params):
        y, upd = jstack.apply({"params": params, "batch_stats": stats},
                              x_nhwc, train=True, mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(g.transpose(0, 2, 3, 1))), (y, upd)

    (_, (y, upd)), (dx, dparams) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(x.transpose(0, 2, 3, 1)), params)
    y = np.asarray(y).transpose(0, 3, 1, 2)
    dx = np.asarray(dx).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(np.concatenate([r0["bn/y"], r1["bn/y"]]), y,
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np.concatenate([r0["bn/dx"], r1["bn/dx"]]),
                               dx, atol=1e-4, rtol=1e-4)
    for name, p in dparams.items():
        pairs = ((f"convs.{name}.weight", "kernel", (3, 2, 0, 1)),) \
            if "kernel" in p else ((f"bns.{name}.weight", "scale", None),
                                   (f"bns.{name}.bias", "bias", None))
        for key, leaf, perm in pairs:
            ref = np.asarray(p[leaf])
            ref = ref.transpose(perm) if perm else ref
            ours = r0[f"bn/d/{key}"] + r1[f"bn/d/{key}"]
            np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-4,
                                       err_msg=key)
    for name, s in upd["batch_stats"].items():
        for ours, theirs in (("running_mean", "mean"),
                             ("running_var", "var")):
            key = f"bn/sd/bns.{name}.{ours}"
            np.testing.assert_array_equal(r0[key], r1[key])
            np.testing.assert_allclose(r0[key], np.asarray(s[theirs]),
                                       atol=1e-5, rtol=1e-5)


# --- the trainer's CLI as two processes -----------------------------------------
def _cli_ranks(synth_dir, snap, seeds):
    """Two ``vistaocr_tpu_torch.train`` processes on the CPU, rank r with
    seed ``seeds[r]``; returns [(returncode, stdout, stderr)]."""
    port = child.free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vistaocr_tpu_torch.train", "--device", "cpu",
         "--preset", "synth-tiny", "--data-dir", synth_dir,
         "--snapshot-dir", snap, "--max-steps", "10",
         "--val-interval-steps", "5", "--log-interval", "5",
         "--batch-pixels", str(2**16), "--seed", str(seed),
         "--coordinator-address", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(r)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r, seed in enumerate(seeds)]
    out = []
    deadline = time.time() + RANK_TIMEOUT_S
    try:
        for p in procs:
            o, e = p.communicate(timeout=max(1.0, deadline - time.time()))
            out.append((p.returncode, o, e))
    except subprocess.TimeoutExpired:
        pytest.fail("a rank of the trainer's CLI outlived its time limit")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def test_cli_fit_two_ranks_one_writer(synth_dir, tmp_path):
    snap = tmp_path / "snap"
    outs = _cli_ranks(synth_dir, str(snap), (0, 0))
    summaries = []
    for rc, o, e in outs:
        assert rc == 0, e[-3000:]
        summaries.append(json.loads(o.strip().splitlines()[-1]))
    assert summaries[0]["steps"] == summaries[1]["steps"] == 10
    assert summaries[0]["last_val_cer"] == summaries[1]["last_val_cer"]
    assert summaries[0]["best_cer"] == summaries[1]["best_cer"]
    assert "mesh=data:2xmodel:1 (rank 1)" in outs[1][1]
    assert (snap / "last" / "meta.json").exists()
    recs = [json.loads(line)
            for line in (snap / "metrics.jsonl").read_text().splitlines()]
    keys = [(r["step"], "val_cer" in r) for r in recs]
    assert len(keys) == len(set(keys)) == 4, keys


def test_cli_fit_plan_mismatch_raises(synth_dir, tmp_path):
    outs = _cli_ranks(synth_dir, str(tmp_path / "snap"), (0, 1))
    for rc, _, e in outs:
        assert rc != 0
        assert "epoch-plan fingerprint differs across processes" in e, \
            e[-3000:]


# --- the pipeline -----------------------------------------------------------------
def test_plan_fingerprint_matches_jax(synth_dir):
    jds = JaxDataset(synth_dir, "train")
    ds = open_dataset(synth_dir, "train")
    alpha = Alphabet.build(ds.transcripts())
    jalpha = JaxAlphabet.build(jds.transcripts())
    contract = port_train.TrainConfig(
        **port_train.PRESETS["synth-tiny"]).contract()
    jcontract = jax_train.TrainConfig(
        **jax_train.PRESETS["synth-tiny"]).contract()
    kw = dict(batch_pixels=2**16, batch_multiple=2, drop_remainder=True,
              shuffle=True, seed=3)
    ours = BatchPipeline(ds, alpha, contract, **kw)
    theirs = JaxPipeline(jds, jalpha, jcontract, **kw)
    fps = [ours.plan_fingerprint(e) for e in (0, 1)]
    assert fps == [theirs.plan_fingerprint(e) for e in (0, 1)]
    assert fps[0] != fps[1]
    other = BatchPipeline(ds, alpha, contract, **{**kw, "seed": 4})
    assert other.plan_fingerprint(0) != fps[0]


def test_sharded_epoch_joins_to_the_global_batches(synth_dir):
    ds = open_dataset(synth_dir, "val")
    alpha = Alphabet.build(open_dataset(synth_dir, "train").transcripts())
    contract = port_train.TrainConfig(
        **port_train.PRESETS["synth-tiny"]).contract()
    pipe = BatchPipeline(ds, alpha, contract, batch_pixels=2**16,
                         batch_multiple=2, drop_remainder=False,
                         shuffle=False)
    whole = list(pipe.epoch(0))
    halves = [list(pipe.device_epoch(0, device="cpu", shard=(r, 2)))
              for r in range(2)]
    assert len(whole) == len(halves[0]) == len(halves[1]) > 1
    assert any(not b.valid.all() for b in whole)  # a padded tail batch
    for b, h0, h1 in zip(whole, *halves):
        for f in ("images", "widths", "labels", "label_lengths"):
            joined = np.concatenate([getattr(h0, f).numpy(),
                                     getattr(h1, f).numpy()])
            np.testing.assert_array_equal(joined, getattr(b, f), err_msg=f)
        for h in (h0, h1):
            assert h.size == b.size // 2
            np.testing.assert_array_equal(h.valid, b.valid)
            np.testing.assert_array_equal(h.indices, b.indices)


# --- the mesh ----------------------------------------------------------------------
def test_mesh_shapes_and_refusals():
    cpu = torch.device("cpu")
    one = pmesh.make_mesh(device="cpu")
    assert (one.data, one.model, one.rank, one.world_size) == (1, 1, 0, 1)
    assert one.group is None and one.device == cpu
    with pytest.raises(ValueError, match="mesh 2x1 != 1 ranks"):
        pmesh.make_mesh(pmesh.MeshConfig(data=2), device="cpu")
    two = pmesh.make_mesh(devices=[cpu, cpu])
    assert (two.data, two.model, two.devices) == (2, 1, (cpu, cpu))
    with pytest.raises(ValueError, match="mesh 3x1 != 2 devices"):
        pmesh.make_mesh(pmesh.MeshConfig(data=3), devices=[cpu, cpu])
    tp = pmesh.make_mesh(pmesh.MeshConfig(model=2), devices=[cpu, cpu])
    assert (tp.data, tp.model) == (1, 2)
    params = {"a": torch.zeros(2), "bridge.weight": torch.zeros(4, 3),
              "bridge.bias": torch.zeros(4), "head.weight": torch.zeros(5, 4),
              "blstm.l1_bwd_wx": torch.zeros(4, 8),
              "blstm.l1_bwd_wh": torch.zeros(2, 8),
              "blstm.l1_bwd_b": torch.zeros(8),
              "nu/blstm.l0_fwd_wh": torch.zeros(2, 8)}
    assert pmesh.param_shardings(params, two) == {
        k: "replicated" for k in params}
    assert pmesh.param_shardings(params, tp) == {
        "a": "replicated", "bridge.weight": ("model", None),
        "bridge.bias": ("model",), "head.weight": "replicated",
        "blstm.l1_bwd_wx": (None, "model"), "blstm.l1_bwd_wh": (None, "model"),
        "blstm.l1_bwd_b": ("model",), "nu/blstm.l0_fwd_wh": (None, "model")}
    with pytest.raises(ValueError, match="no model group"):
        pmesh.shard_model(torch.nn.Linear(2, 2), tp)
    assert pmesh.shard_rows(8, 1, 2) == slice(4, 8)
    with pytest.raises(ValueError):
        pmesh.shard_rows(9, 0, 2)
    assert pmesh.local_devices("cpu") == [cpu]


def test_trainer_refusals(synth_dir, tmp_path):
    # JAX's refusal: the fused trainer needs the device cache
    cfg = port_train.TrainConfig(
        **{**port_train.PRESETS["synth-tiny"], "data_dir": synth_dir,
           "snapshot_dir": str(tmp_path), "device_cache": "off",
           "fused_epochs": "on"})
    with pytest.raises(ValueError, match="requires the device cache"):
        port_train.fit(cfg, device="cpu")
    # a split over the cap streams, as JAX's does
    logs = []
    capped = dataclasses.replace(cfg, device_cache="on", fused_epochs="auto",
                                 device_cache_bytes=1024, max_steps=2,
                                 log_interval=1)
    assert port_train.fit(capped, device="cpu", log=logs.append)[
        "steps"] == 2
    assert any(m.startswith("device cache disabled (dataset needs ")
               and m.endswith("; streaming") for m in logs), logs
    assert not any(m.startswith("fused epochs") for m in logs)
    # the model axis needs its ranks: one process never runs it replicated
    cfg = dataclasses.replace(cfg, device_cache="auto", fused_epochs="auto",
                              mesh_model=2)
    with pytest.raises(ValueError, match="mesh 0x2 != 1 ranks"):
        port_train.fit(cfg, device="cpu")
    assert not port_train.maybe_init_distributed(None)
    with pytest.raises(ValueError, match="--num-processes"):
        port_train.maybe_init_distributed("127.0.0.1:1")


# --- the service ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def snapshot(tmp_path_factory, synth_dir):
    """A tiny seeded snapshot written by the JAX package, with an int8
    stack calibrated by the port on the synth train split."""
    cfg = JaxConfig(
        num_classes=len(CHARSET) + 1, line_height=32,
        stages=(JaxStage(8, 2, (2, 2)), JaxStage(16, 2, (2, 2)),
                JaxStage(16, 2, (2, 1))),
        bridge_dim=32, lstm_hidden=24, lstm_layers=2, dropout=0.0,
        compute_dtype="float32", lstm_impl="scan")
    variables = JaxModel(cfg).init_params(jax.random.PRNGKey(3), batch=2,
                                          width=64)
    path = str(tmp_path_factory.mktemp("dp_svc"))
    jax_ckpt.save_snapshot(
        path, variables=variables, model_config=cfg,
        alphabet=JaxAlphabet.from_charset(CHARSET),
        contract=JaxContract(bucket_widths=(128, 256, 384)))
    quantize_snapshot(path, synth_dir, calib_batches=2, batch_pixels=2**16,
                      device="cpu")
    return path


def _lines():
    rng = np.random.default_rng(17)
    out = []
    for w in (20, 64, 100, 127, 128, 129, 200, 255, 300, 333, 380, 384,
              90, 110, 120, 60, 70):
        img = np.full((32, w), 255, np.uint8)
        for _ in range(max(3, w // 8)):
            y, x = int(rng.integers(2, 30)), int(rng.integers(0, w))
            img[y - 2: y + 2, x: x + int(rng.integers(1, 9))] = int(
                rng.integers(0, 90))
        out.append(img)
    out.append(rng.integers(0, 256, (48, 150), np.uint8))
    out.append(rng.integers(0, 256, (77, 200), np.uint8))
    return out


@pytest.fixture
def two_cpus(monkeypatch):
    monkeypatch.setattr(pmesh, "local_devices",
                        lambda device_type="cuda": [torch.device("cpu")] * 2)


def _serve(snapshot, lines, submit=0, **kw):
    svc = OcrService(snapshot, ServiceConfig(max_batch=8, warmup=False, **kw),
                     device="cpu")
    try:
        got = svc.ocr_lines(lines)
        got += [f.result(timeout=60)
                for f in [svc.submit(img) for img in lines[:submit]]]
        return got, len(svc._shards), svc._batch_sizes
    finally:
        svc.close()


def _same(a, b):
    assert [r.text for r in a] == [r.text for r in b]
    assert [r.bucket_width for r in a] == [r.bucket_width for r in b]
    for x, y in zip(a, b):
        assert (x.confidence is None) == (y.confidence is None)
        if x.confidence is not None:
            assert abs(x.confidence - y.confidence) <= 1e-5


def test_mesh_minus_one_on_the_cpu_is_one_device(snapshot):
    lines = _lines()
    ref, n_ref, _ = _serve(snapshot, lines)
    got, n, _ = _serve(snapshot, lines, mesh_data=-1)
    assert n_ref == n == 1
    _same(got, ref)
    assert any(r.text for r in got)


@pytest.mark.parametrize("kw", [
    dict(), dict(decoder="beam"), dict(decoder="beam", beam_impl="host"),
    dict(quantize="int8")], ids=["greedy", "device-beam", "host-beam",
                                 "int8"])
def test_two_shards_give_the_texts_of_one(snapshot, two_cpus, kw):
    lines = _lines()
    ref, _, _ = _serve(snapshot, lines, submit=3, **kw)
    got, n, sizes = _serve(snapshot, lines, submit=3, mesh_data=2, **kw)
    assert n == 2 and all(s % 2 == 0 for s in sizes)
    _same(got, ref)
    assert any(r.text for r in got)


def test_sharded_ladder_and_all_devices(snapshot, two_cpus):
    svc = OcrService(snapshot, ServiceConfig(
        max_batch=9, batch_sizes=(3, 9), mesh_data=-1, warmup=False),
        device="cpu")
    try:
        assert len(svc._shards) == 2
        assert svc._batch_sizes == (4, 10)
    finally:
        svc.close()
    svc = OcrService(snapshot, ServiceConfig(max_batch=128, mesh_data=2),
                     device="cpu")
    try:
        assert svc._batch_sizes == (8, 32, 128)
        assert svc.init_timings["warmup_graphs"] == 3 * 3
    finally:
        svc.close()


def test_mesh_over_more_devices_than_there_are_raises(snapshot):
    with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
        OcrService(snapshot, ServiceConfig(mesh_data=2, warmup=False),
                   device="cpu")
