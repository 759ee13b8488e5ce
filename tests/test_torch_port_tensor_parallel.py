"""Tensor parallelism in the port (the mesh's ``model`` axis:
``parallel/mesh.py`` ``make_mesh``, ``param_shardings``,
``shard_state_dict`` / ``gather_state_dict``, ``shard_model``,
``gather_columns`` / ``copy_to_model``; the column-parallel bridge and
BLSTM gates; ``fit`` over ``data x model`` ranks) on the CPU:

- four gloo ranks (``tests/torch_port_dp_child.py``) at ``data=2,
  model=2`` against one process on the same global batch of the tiny f32
  model (dropout 0, one padding row): the Adam step's loss within 1e-5
  relative and its parameters within JAX's bounds (atol 3e-3, rtol 2e-2,
  ``tests/test_train.py::TestTensorParallel``); the SGD step (lr 1, the
  clip exercised) with its norm within 1e-4 relative; every rank's
  gathered state dict and losses bit-equal;
- the same ranks' SGD step against JAX's step over a ``('data',
  'model')`` mesh of four devices with the state placed by JAX's
  ``param_shardings``, within the bounds of
  ``test_torch_port_parallel.py::test_two_ranks_match_jax_data_mesh``;
- two ranks at ``data=1, model=2`` with dropout 0.1: both ranks'
  replicated tensors and gathered shards bit-equal (one mask, drawn from
  the data index), and the loss of one process;
- the shards equal to JAX's placement by ``_TP_RULES``, the shard and
  gather round trip exact, an indivisible width refused;
- ``python -m vistaocr_tpu_torch.train --mesh-model 2`` as two processes:
  one snapshot, which JAX's ``load_snapshot`` opens and a one-rank run
  resumes.
"""

import ast
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
from vistaocr_tpu.data.synth import SynthConfig
from vistaocr_tpu.models import CnnLstmOcr as JaxModel
from vistaocr_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from vistaocr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vistaocr_tpu.parallel.mesh import param_shardings as jax_param_shardings
from vistaocr_tpu.parallel.mesh import shard_batch_arrays
from vistaocr_tpu.text import Alphabet as JaxAlphabet

from vistaocr_tpu_torch import train as port_train
from vistaocr_tpu_torch.checkpoint import variables_to_state_dict
from vistaocr_tpu_torch.models import CnnLstmOcr, ModelConfig
from vistaocr_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHARSET = "abcdeo "
RANK_TIMEOUT_S = 180  # a spawned rank's limit; every rank is killed after
CPU = torch.device("cpu")
SHARDED = {"bridge.weight", "bridge.bias", "blstm.l0_fwd_wx",
           "blstm.l0_fwd_wh", "blstm.l0_fwd_b", "blstm.l0_bwd_wx",
           "blstm.l0_bwd_wh", "blstm.l0_bwd_b"}


def _child():
    spec = importlib.util.spec_from_file_location(
        "torch_port_dp_child", os.path.join(ROOT, "tests",
                                            "torch_port_dp_child.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


child = _child()


def _tp_mesh(model_index, model=2):
    """A mesh of ``model`` ranks on one data index, seen from one rank:
    enough for the host helpers, which run no collective."""
    return pmesh.Mesh(data=1, model=model, rank=model_index,
                      world_size=model, device=CPU, devices=(CPU,),
                      model_index=model_index)


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    cfg = SynthConfig(language="charset", charset=CHARSET, min_words=1,
                      max_words=3)
    return build_synthetic_dataset(str(d), num_train=96, num_val=24,
                                   height=32, max_width=384, config=cfg,
                                   seed=11)


def _write_job(job, variables, batches, runs, mesh):
    np.savez(os.path.join(job, "weights.npz"), **{
        f"sd/{k}": v.numpy()
        for k, v in variables_to_state_dict(variables).items()})
    np.savez(os.path.join(job, "batches.npz"), **{
        f"{f}_{k}": getattr(b, f) for k, b in enumerate(batches)
        for f in ("images", "widths", "labels", "label_lengths", "valid")})
    with open(os.path.join(job, "job.json"), "w") as f:
        json.dump({"runs": runs, "mesh": mesh}, f)


@pytest.fixture(scope="module")
def tp_run(synth_dir, tmp_path_factory):
    """Two jobs from JAX's init of the tiny f32 model on global batches of
    8 (the first with its last row padding): four ranks at data=2,
    model=2 (Adam lr 1e-3 and SGD lr 1, one step each) and two at data=1,
    model=2 (dropout 0.1, two Adam steps); both spawned at once, then
    each run in one process."""
    jcfg = jax_train.TrainConfig(**{**jax_train.PRESETS["synth-tiny"],
                                    "dropout": 0.0, "augment": 0.0})
    jds = JaxDataset(synth_dir, "train")
    jalpha = JaxAlphabet.build(jds.transcripts())
    mcfg = dataclasses.replace(jcfg.model_config(jalpha.num_classes),
                               lstm_impl="scan")
    variables = jax.device_get(JaxModel(mcfg).init_params(
        jax.random.PRNGKey(0)))
    pipe = JaxPipeline(jds, jalpha, jcfg.contract(), batch_pixels=2**15,
                       batch_multiple=2, drop_remainder=True, shuffle=False)
    it = iter(pipe.epoch(0))
    batches = [next(it), next(it)]
    assert batches[0].size == batches[1].size == 8
    batches[0].valid[-1] = False  # the data ranks' weight sums: 4 and 3
    port_cfg = ModelConfig.from_json(mcfg.to_json())
    cfg = dataclasses.replace(port_cfg, lstm_impl="auto").to_json()
    drop = dataclasses.replace(port_cfg, lstm_impl="auto",
                               dropout=0.1).to_json()
    jobs = {}
    for name, runs, mesh in (
            ("dp2tp2", [{"config": cfg, "optimizer": "adam", "lr": 1e-3,
                         "steps": 1},
                        {"config": cfg, "optimizer": "sgd", "lr": 1.0,
                         "steps": 1}], {"data": 2, "model": 2}),
            ("tp2_dropout", [{"config": drop, "optimizer": "adam",
                              "lr": 1e-3, "steps": 2}],
             {"data": 1, "model": 2})):
        jobs[name] = str(tmp_path_factory.mktemp(name))
        _write_job(jobs[name], variables, batches, runs, mesh)
    with ThreadPoolExecutor(2) as pool:
        spawned = {name: pool.submit(child.spawn_ranks, job,
                                     4 if name == "dp2tp2" else 2, "cpu",
                                     "gloo", RANK_TIMEOUT_S)
                   for name, job in jobs.items()}
        ranks = {name: f.result() for name, f in spawned.items()}
    return dict(ranks={k: v[0] for k, v in ranks.items()},
                outs={k: v[1] for k, v in ranks.items()},
                one={k: child.run_job(job) for k, job in jobs.items()},
                variables=variables, batch=batches[0], mcfg=mcfg, jcfg=jcfg)


def _params(one, run):
    return [k for k in one if k.startswith(f"{run}/sd/")
            and not k.endswith("num_batches_tracked")]


def test_four_ranks_adam_step_equals_one_process(tp_run):
    ranks, one = tp_run["ranks"]["dp2tp2"], tp_run["one"]["dp2tp2"]
    np.testing.assert_allclose(ranks[0]["0/loss"], one["0/loss"], rtol=1e-5)
    names = _params(one, "0")
    assert len(names) > 10
    for k in names:
        assert ranks[0][k].shape == one[k].shape, k  # gathered whole
        np.testing.assert_allclose(ranks[0][k], one[k], atol=3e-3, rtol=2e-2,
                                   err_msg=k)


def test_four_ranks_sgd_clip_norm_equals_one_process(tp_run):
    ranks, one = tp_run["ranks"]["dp2tp2"], tp_run["one"]["dp2tp2"]
    assert float(one["1/gnorm"][0]) > 5.0  # the clip is exercised
    np.testing.assert_allclose(ranks[0]["1/gnorm"], one["1/gnorm"],
                               rtol=1e-4)
    np.testing.assert_allclose(ranks[0]["1/loss"], one["1/loss"], rtol=1e-5)
    for k in _params(one, "1"):
        np.testing.assert_allclose(ranks[0][k], one[k], atol=3e-3, rtol=2e-2,
                                   err_msg=k)


def test_four_ranks_agree_bit_for_bit(tp_run):
    """Every rank's losses, norms and gathered state dicts are equal; each
    rank's own replicated tensors equal every other rank's, and its shards
    those of the rank of the other data index with its model index."""
    ranks = tp_run["ranks"]["dp2tp2"]
    r0 = ranks[0]
    for r in ranks[1:]:
        assert sorted(r) == sorted(r0)
        for k in r0:
            if "/sd/" in k or k.endswith(("/loss", "/gnorm")):
                np.testing.assert_array_equal(r[k], r0[k], err_msg=k)
    for run in ("0", "1"):
        for k in (k for k in r0 if k.startswith(f"{run}/local/")):
            name = k.split("/", 2)[2]
            if name in SHARDED:  # rank = data_index * 2 + model_index
                assert 2 * r0[k].size == r0[f"{run}/sd/{name}"].size, k
                np.testing.assert_array_equal(ranks[0][k], ranks[2][k])
                np.testing.assert_array_equal(ranks[1][k], ranks[3][k])
                assert not np.array_equal(ranks[0][k], ranks[1][k]), k
            else:
                for r in ranks[1:]:
                    np.testing.assert_array_equal(r[k], r0[k], err_msg=k)
        assert {k.split("/", 2)[2] for k in r0 if k.startswith(
            f"{run}/local/") and r0[k].shape != r0[
            k.replace("/local/", "/sd/")].shape} == SHARDED


@pytest.mark.parametrize("job", ["dp2tp2", "tp2_dropout"])
def test_rank_layout_is_jax_device_grid(tp_run, job):
    """Rank r sits at divmod(r, 2) of a model axis of 2, as JAX's
    ``np.array(devices).reshape(data, model)``; on the CPU no rank counts
    a kernel launch (the wrappers run their plain versions)."""
    for r, res in enumerate(tp_run["ranks"][job]):
        assert res["mesh/index"].tolist() == list(divmod(r, 2))
        assert all(int(v) == 0 for k, v in res.items() if "/count/" in k)


def test_four_ranks_match_jax_data_model_mesh(tp_run):
    """JAX's SGD step at lr 1 over a ('data', 'model') mesh of 2 x 2
    devices: the batch sharded on data, the state placed by JAX's
    param_shardings (_TP_RULES)."""
    variables, batch, jcfg = (tp_run["variables"], tp_run["batch"],
                              tp_run["jcfg"])
    jcfg = dataclasses.replace(jcfg, optimizer="sgd")
    jmodel = JaxModel(tp_run["mcfg"])
    tx = jax_train.make_optimizer(jcfg, include_clip=False)
    mesh = jax_make_mesh(JaxMeshConfig(data=2, model=2),
                         devices=jax.devices()[:4])
    state = jax_train.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        step=jnp.asarray(0, jnp.int32))
    state = jax.device_put(state, jax_param_shardings(state, mesh))
    assert not state.params["bridge"]["kernel"].sharding.is_fully_replicated
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
    r0 = tp_run["ranks"]["dp2tp2"][0]
    np.testing.assert_allclose(r0["1/loss"][0], float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(r0["1/gnorm"][0], float(jm["gnorm"]),
                               rtol=1e-4)
    before = variables_to_state_dict(variables)
    for name, ref in jgrads.items():
        ours = before[name].numpy() - r0[f"1/sd/{name}"]
        np.testing.assert_allclose(ours, ref.numpy(), atol=2e-4, rtol=1e-3,
                                   err_msg=name)
    for name, ref in jstats.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(r0[f"1/sd/{name}"], ref.numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=name)


def test_model_ranks_with_dropout_are_bit_equal(tp_run):
    """data=1, model=2 with dropout 0.1: both ranks draw the data index's
    mask, so their replicated tensors, gathered shards and losses are
    equal, and the run is the one-process run (the same mask)."""
    r0, r1 = tp_run["ranks"]["tp2_dropout"]
    one = tp_run["one"]["tp2_dropout"]
    assert sorted(r0) == sorted(r1)
    for k in r0:
        if "/sd/" in k or k.endswith(("/loss", "/gnorm")):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        elif "/local/" in k and k.split("/", 2)[2] not in SHARDED:
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    np.testing.assert_allclose(r0["0/loss"], one["0/loss"], rtol=1e-5)
    for k in _params(one, "0"):
        np.testing.assert_allclose(r0[k], one[k], atol=3e-3, rtol=2e-2,
                                   err_msg=k)


def test_shard_and_gather_round_trip_exactly(tp_run):
    before = variables_to_state_dict(tp_run["variables"])
    for name in ("dp2tp2", "tp2_dropout"):
        for r in tp_run["ranks"][name]:
            got = {k[len("roundtrip/"):]: v for k, v in r.items()
                   if k.startswith("roundtrip/")}
            assert sorted(got) == sorted(before)
            for k, v in before.items():
                np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


def test_shards_equal_jax_placement_by_tp_rules(tp_run):
    """JAX's param_shardings over a 2 x 2 mesh: the block of every leaf on
    the device at (0, m) is the port's shard of model index m, the
    bridge's kernel columns being its weight's rows; the optimizer slots
    follow their parameter."""
    variables = tp_run["variables"]
    mesh = jax_make_mesh(JaxMeshConfig(data=2, model=2),
                         devices=jax.devices()[:4])
    placed = jax.device_put(variables, jax_param_shardings(variables, mesh))
    whole = variables_to_state_dict(variables)
    for m in range(2):
        dev = mesh.devices[0, m]

        def block(a, dev=dev):
            return next(np.asarray(s.data) for s in a.addressable_shards
                        if s.device == dev)

        theirs = variables_to_state_dict(jax.tree.map(block, placed))
        ours = pmesh.shard_state_dict(whole, _tp_mesh(m))
        assert sorted(ours) == sorted(theirs)
        for k in ours:
            np.testing.assert_array_equal(ours[k].numpy(), theirs[k].numpy(),
                                          err_msg=k)
        assert {k for k in ours if ours[k].shape != whole[k].shape} == SHARDED
        slots = {f"mu/{k}": v.numpy() for k, v in whole.items()}
        slots["count"] = np.zeros((), np.int32)
        cut = pmesh.shard_state_dict(slots, _tp_mesh(m))
        for k in SHARDED:
            np.testing.assert_array_equal(cut[f"mu/{k}"], theirs[k].numpy())
        assert cut["count"] is slots["count"]
    specs = pmesh.param_shardings(whole, _tp_mesh(0))
    assert specs["bridge.weight"] == ("model", None)
    assert specs["blstm.l0_fwd_wh"] == (None, "model")
    assert specs["blstm.l0_bwd_b"] == ("model",)
    assert specs["head.weight"] == specs["head.bias"] == "replicated"
    assert {k for k, s in specs.items() if s != "replicated"} == SHARDED


@pytest.mark.parametrize("model,bridge,name", [
    (2, 63, "bridge.weight"), (3, 66, "blstm.l0_fwd_wx")],
    ids=["bridge", "gates"])
def test_indivisible_width_raises(model, bridge, name):
    """A bridge width, or a gate width 4H, that the model axis does not
    divide is refused by name, as JAX's device_put refuses it."""
    cfg = port_train.TrainConfig(**port_train.PRESETS["synth-tiny"])
    mcfg = dataclasses.replace(cfg.model_config(7), bridge_dim=bridge)
    sd = CnnLstmOcr(mcfg).state_dict()
    with pytest.raises(ValueError, match=name.replace(".", r"\.")):
        pmesh.param_shardings(sd, _tp_mesh(0, model))
    with pytest.raises(ValueError, match=f"model={model}"):
        pmesh.shard_state_dict(sd, _tp_mesh(0, model))


def test_cli_mesh_model_two_snapshot_opens_in_jax_and_resumes(synth_dir,
                                                             tmp_path):
    snap = tmp_path / "snap"
    port = child.free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vistaocr_tpu_torch.train", "--device", "cpu",
         "--preset", "synth-tiny", "--data-dir", synth_dir,
         "--snapshot-dir", str(snap), "--max-steps", "6",
         "--val-interval-steps", "3", "--log-interval", "3",
         "--batch-pixels", str(2**16), "--dropout", "0.1", "--mesh-model",
         "2", "--coordinator-address", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(r)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    outs = []
    deadline = time.time() + RANK_TIMEOUT_S
    try:
        for p in procs:
            o, e = p.communicate(timeout=max(1.0, deadline - time.time()))
            outs.append((p.returncode, o, e))
    except subprocess.TimeoutExpired:
        pytest.fail("a rank of the trainer's CLI outlived its time limit")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    summaries = []
    for rc, o, e in outs:
        assert rc == 0, e[-3000:]
        summaries.append(json.loads(o.strip().splitlines()[-1]))
    for s in summaries:  # the one field that is not the ranks' shared state
        s.pop("lines_per_sec")
    assert summaries[0] == summaries[1]
    assert summaries[0]["steps"] == 6
    assert ("mesh=data:1xmodel:2 (rank 1) data_index=0 model_index=1"
            in outs[1][1])
    logged = [[(r["step"], r["loss"], r["gnorm"]) for r in (
        ast.literal_eval(line.split(": ", 1)[1]) for line in o.splitlines()
        if line.startswith("step "))] for _, o, _ in outs]
    assert len(logged[0]) == 2 and logged[0] == logged[1]  # one run, twice
    last = str(snap / "last")
    variables, jcfg, _, _, meta = jax_ckpt.load_snapshot(last)
    assert meta["step"] == 6
    assert variables["params"]["bridge"]["kernel"].shape == (
        jcfg.stages[-1].channels * 4, jcfg.bridge_dim)
    assert variables["params"]["blstm"]["l0_fwd_wh"].shape == (
        jcfg.lstm_hidden, 4 * jcfg.lstm_hidden)
    assert jax_ckpt.has_opt_state(last)
    cfg = port_train.TrainConfig(**{
        **port_train.PRESETS["synth-tiny"], "data_dir": synth_dir,
        "snapshot_dir": str(snap), "resume": True, "max_steps": 2,
        "batch_pixels": 2**16, "val_interval_steps": 100,
        "log_interval": 1})
    losses = []
    summary = port_train.fit(
        cfg, device="cpu",
        log=lambda s: losses.append(s) if s.startswith("step") else None)
    assert summary["steps"] == 8
    assert len(losses) == 2
