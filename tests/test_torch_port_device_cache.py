"""The port's device-resident dataset cache (``data/device_cache.py``) and
epoch-fused trainer (``train.make_train_epoch``, ``fit`` with
``device_cache="on"`` / ``fused_epochs="on"``) against the JAX package on
the CPU, on the same synthetic shards and seeds:

- ``DeviceCache.epoch(e)`` for e = 0 and 1, with and without
  ``drop_remainder``, bit-equal to JAX's ``DeviceCache.epoch(e)`` and to
  the port's ``BatchPipeline.epoch(e)``: order, ``indices``, ``valid``,
  images, widths, labels and label lengths; a sharded ``device_epoch``'s
  rows joined are the whole batches;
- ``epoch_plan(e, stack)`` for stack 1 and 3 bit-equal to JAX's, bucket
  order and resident arrays included; ``batch_shapes()`` equal to JAX's
  pipeline's; the ``MemoryError`` at JAX's cap, with its text;
- one fused segment of the tiny f32 model (dropout 0) against JAX's
  ``make_train_epoch`` on the same numpy weights and plan (``scan`` LSTM
  and CTC): loss and norm within 1e-4 relative, parameters within
  ``tests/test_fused_epoch.py``'s atol 3e-4 / rtol 2e-2;
- the port's fused segment against its own per-step ``train_step`` over
  the same rows with dropout 0.1: bit-equal (``torch.equal``);
- ``fit`` with the cache and fused epochs: the exact step count with a
  segment cut by ``max_steps``, validation at each crossing of
  ``val_interval_steps``, the loss halved, ``stack_rows_done`` /
  ``stack_epochs`` in the snapshot meta, a resume, JAX's
  ``load_snapshot`` on the result; with fused epochs off, the per-step
  loop over the cache equal to streaming; the CLI's flags; the choice
  between graphs and eager steps;
- two gloo ranks (``tests/torch_port_dp_child.py``, a ``"fused"`` run)
  against one process's fused segment: loss within 1e-5, parameters
  within atol 3e-3 / rtol 2e-2, the ranks bit-equal.
"""

import copy
import dataclasses
import importlib.util
import json
import os

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
from vistaocr_tpu.data.device_cache import DeviceCache as JaxCache
from vistaocr_tpu.data.synth import SynthConfig
from vistaocr_tpu.models import CnnLstmOcr as JaxModel
from vistaocr_tpu.text import Alphabet as JaxAlphabet

from vistaocr_tpu_torch import train as port_train
from vistaocr_tpu_torch.checkpoint import variables_to_state_dict
from vistaocr_tpu_torch.data import BatchPipeline, open_dataset
from vistaocr_tpu_torch.data.device_cache import DeviceCache
from vistaocr_tpu_torch.models import (CnnLstmOcr, ModelConfig,
                                       init_parameters)
from vistaocr_tpu_torch.text import Alphabet

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 180  # a spawned rank's limit; every rank is killed after
FIELDS = ("images", "widths", "labels", "label_lengths")


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    cfg = SynthConfig(language="charset", charset="abcdeo ", min_words=1,
                      max_words=3)
    return build_synthetic_dataset(str(d), num_train=96, num_val=24,
                                   height=32, max_width=384, config=cfg,
                                   seed=11)


def _pipes(synth_dir, split="train", **kw):
    """The port's and JAX's pipelines over one split with the same
    alphabet, contract and options."""
    ds = open_dataset(synth_dir, split)
    jds = JaxDataset(synth_dir, split)
    alpha = Alphabet.build(open_dataset(synth_dir, "train").transcripts())
    jalpha = JaxAlphabet.build(JaxDataset(synth_dir, "train").transcripts())
    contract = port_train.TrainConfig(
        **port_train.PRESETS["synth-tiny"]).contract()
    jcontract = jax_train.TrainConfig(
        **jax_train.PRESETS["synth-tiny"]).contract()
    kw = {"batch_pixels": 2**16, "seed": 5, **kw}
    return (BatchPipeline(ds, alpha, contract, **kw),
            JaxPipeline(jds, jalpha, jcontract, **kw))


# --- the cache ---------------------------------------------------------------------
@pytest.mark.parametrize("drop_remainder", [True, False])
def test_epoch_equals_jax_and_the_pipeline(synth_dir, drop_remainder):
    pipe, jpipe = _pipes(synth_dir, drop_remainder=drop_remainder)
    ours = DeviceCache(pipe, device="cpu")
    theirs = JaxCache(jpipe)
    for e in (0, 1):
        a, b, c = list(ours.epoch(e)), list(theirs.epoch(e)), list(
            pipe.epoch(e))
        assert len(a) == len(b) == len(c) > 3
        if not drop_remainder:
            assert any(not x.valid.all() for x in a)  # a padded tail
        for x, y, z in zip(a, b, c):
            assert x.bucket == z.bucket
            assert x.bucket.width == y.bucket.width
            for ref in (y, z):
                np.testing.assert_array_equal(x.indices, ref.indices)
                np.testing.assert_array_equal(x.valid, ref.valid)
                for f in FIELDS:
                    assert isinstance(getattr(x, f), torch.Tensor)
                    np.testing.assert_array_equal(
                        getattr(x, f).numpy(), np.asarray(getattr(ref, f)),
                        err_msg=f)
    assert [x.indices.tolist() for x in ours.epoch(0)] != [
        x.indices.tolist() for x in ours.epoch(1)]


def test_sharded_device_epoch_joins_to_the_whole_batches(synth_dir):
    pipe, _ = _pipes(synth_dir, "val", batch_multiple=2,
                     drop_remainder=False, shuffle=False)
    cache = DeviceCache(pipe, device="cpu")
    whole = list(cache.epoch(0))
    halves = [list(cache.device_epoch(0, device="cpu", shard=(r, 2)))
              for r in range(2)]
    assert len(whole) == len(halves[0]) == len(halves[1]) > 1
    for b, h0, h1 in zip(whole, *halves):
        for f in FIELDS:
            joined = torch.cat([getattr(h0, f), getattr(h1, f)])
            assert torch.equal(joined, getattr(b, f)), f
        for h in (h0, h1):
            assert h.size == b.size // 2
            np.testing.assert_array_equal(h.valid, b.valid)
            np.testing.assert_array_equal(h.indices, b.indices)
    with pytest.raises(ValueError, match="cache on cpu"):
        cache.device_epoch(0, device="meta")


@pytest.mark.parametrize("stack", [1, 3])
def test_epoch_plan_equals_jax(synth_dir, stack):
    pipe, jpipe = _pipes(synth_dir, drop_remainder=True)
    ours = DeviceCache(pipe, device="cpu")
    theirs = JaxCache(jpipe)
    for e in (0, 2):
        a, b = ours.epoch_plan(e, stack), theirs.epoch_plan(e, stack)
        assert [p[0] for p in a] == [p[0] for p in b]
        assert len(a) > 1
        for (_, arrays, idx, w), (_, jarrays, jidx, jw) in zip(a, b):
            assert idx.dtype == torch.int32 and w.dtype == torch.float32
            np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
            np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
            for x, y in zip(arrays, jarrays):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert sum(p[2].shape[0] for p in ours.epoch_plan(0, stack)) == \
        stack * len(pipe)


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_batch_shapes_equal_jax(synth_dir, drop_remainder):
    pipe, jpipe = _pipes(synth_dir, "val", batch_pixels=2**17,
                         drop_remainder=drop_remainder)
    assert pipe.batch_shapes() == jpipe.batch_shapes()
    assert DeviceCache(pipe, device="cpu").batch_shapes() == \
        pipe.batch_shapes()
    if drop_remainder:  # a bucket with fewer members than a batch
        assert len(pipe.batch_shapes()) < len(
            _pipes(synth_dir, "val", batch_pixels=2**17,
                   drop_remainder=False)[0].batch_shapes())


def test_memory_cap_is_jaxs(synth_dir):
    pipe, jpipe = _pipes(synth_dir)
    total = sum(len(m) * (pipe.spec_for(b).height * pipe.spec_for(b).width
                          + 4 * pipe.spec_for(b).label_len)
                for b, m in enumerate(pipe.bucket_members))
    with pytest.raises(MemoryError) as ours:
        DeviceCache(pipe, device="cpu", max_bytes=total - 1)
    with pytest.raises(MemoryError) as theirs:
        JaxCache(jpipe, max_bytes=total - 1)
    assert str(ours.value) == str(theirs.value)
    assert "use streaming" in str(ours.value)
    DeviceCache(pipe, device="cpu", max_bytes=total)


# --- one fused segment -------------------------------------------------------------
def test_fused_segment_matches_jax_make_train_epoch(synth_dir):
    over = dict(dropout=0.0, augment=0.0, ctc_impl="scan")
    jcfg = jax_train.TrainConfig(**{**jax_train.PRESETS["synth-tiny"], **over})
    pipe, jpipe = _pipes(synth_dir, drop_remainder=True, seed=3)
    mcfg = dataclasses.replace(
        jcfg.model_config(pipe.alphabet.num_classes), lstm_impl="scan")
    jmodel = JaxModel(mcfg)
    variables = jax.device_get(jmodel.init_params(jax.random.PRNGKey(0)))
    b, arrays, idx, w = max(DeviceCache(pipe, device="cpu").epoch_plan(0),
                            key=lambda p: p[2].shape[0])
    _, jarrays, jidx, jw = {p[0]: p for p in JaxCache(jpipe).epoch_plan(0)}[b]
    assert idx.shape[0] >= 3
    idx, w, jidx, jw = idx[:3], w[:3], jidx[:3], jw[:3]

    tx = jax_train.make_optimizer(jcfg, include_clip=False)
    state = jax_train.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        step=jnp.asarray(0, jnp.int32))
    jepoch = jax_train.make_train_epoch(jmodel, tx, False, "scan",
                                        grad_clip=5.0)
    jstate, jm = jepoch(state, *jarrays, jidx, jw,
                        jnp.asarray(1e-3, jnp.float32), jax.random.PRNGKey(7))
    jsd = variables_to_state_dict({
        "params": jax.device_get(jstate.params),
        "batch_stats": jax.device_get(jstate.batch_stats)})

    model = CnnLstmOcr(dataclasses.replace(
        ModelConfig.from_json(mcfg.to_json()), lstm_impl="auto"))
    model.load_state_dict(variables_to_state_dict(variables))
    ptx = port_train.Optimizer("adam")
    pstate = port_train.TrainState(
        model=model, opt_state=ptx.init(dict(model.named_parameters())))
    epoch = port_train.make_train_epoch(model, ptx, False, "scan",
                                        grad_clip=5.0)
    assert not epoch.graphs
    m = epoch(pstate, arrays, idx, w, 1e-3)
    assert pstate.step == 3 == int(jstate.step)
    for k in ("loss", "last_loss", "gnorm"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    sd = model.state_dict()
    for name, ref in jsd.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(sd[name].numpy(), ref.numpy(),
                                       atol=3e-4, rtol=2e-2, err_msg=name)


def _tiny_model(num_classes, dropout):
    cfg = port_train.TrainConfig(**{**port_train.PRESETS["synth-tiny"],
                                    "dropout": dropout})
    model = CnnLstmOcr(cfg.model_config(num_classes))
    init_parameters(model, torch.Generator().manual_seed(2))
    return model


def _per_step(model, arrays, idx, w, seed):
    """``train_step`` over the rows of ``idx``: (losses, gnorms, state)."""
    tx = port_train.Optimizer("adam")
    state = port_train.TrainState(
        model=model, opt_state=tx.init(dict(model.named_parameters())))
    step = port_train.make_train_step(model, tx, False, "scan",
                                      grad_clip=5.0, seed=seed)
    losses, gnorms = [], []
    for k in range(idx.shape[0]):
        m = step(state, *(a.index_select(0, idx[k]) for a in arrays), w[k],
                 3e-3)
        losses.append(m["loss"])
        gnorms.append(m["gnorm"])
    return torch.stack(losses), torch.stack(gnorms), state


def test_fused_segment_bit_equal_to_per_step_with_dropout(synth_dir):
    pipe, _ = _pipes(synth_dir, drop_remainder=True)
    plan = DeviceCache(pipe, device="cpu").epoch_plan(0)
    _, arrays, idx, w = max(plan, key=lambda p: p[2].shape[0])
    idx, w = idx[:4], w[:4]
    assert idx.shape[0] == 4
    base = _tiny_model(pipe.alphabet.num_classes, dropout=0.1)
    fused, stepped = copy.deepcopy(base), copy.deepcopy(base)

    tx = port_train.Optimizer("adam")
    fstate = port_train.TrainState(
        model=fused, opt_state=tx.init(dict(fused.named_parameters())))
    before = port_train.FUSED_EAGER_STEPS
    m = port_train.make_train_epoch(fused, tx, False, "scan", grad_clip=5.0,
                                    seed=4)(fstate, arrays, idx, w, 3e-3)
    assert port_train.FUSED_EAGER_STEPS == before + 4
    losses, gnorms, sstate = _per_step(stepped, arrays, idx, w, seed=4)
    assert fstate.step == sstate.step == 4
    assert torch.equal(m["loss"], losses.mean())
    assert torch.equal(m["last_loss"], losses[-1])
    assert torch.equal(m["gnorm"], gnorms[-1])
    for (k, a), b in zip(fused.state_dict().items(),
                         stepped.state_dict().values()):
        assert torch.equal(a, b), k
    for k, v in fstate.opt_state.items():
        assert torch.equal(v, sstate.opt_state[k]), k
    # the masks matter: another seed's steps end elsewhere
    other = copy.deepcopy(base)
    _per_step(other, arrays, idx, w, seed=5)
    assert not torch.equal(other.head.weight, fused.head.weight)


# --- fit -----------------------------------------------------------------------------
def test_fit_fused_cut_segments_validation_resume_and_jax_load(
        synth_dir, tmp_path):
    run = str(tmp_path / "run")
    base = dict(port_train.PRESETS["synth-tiny"])
    base.update(data_dir=synth_dir, snapshot_dir=run, epochs=200,
                max_steps=60, val_interval_steps=25, batch_pixels=2**16,
                seed=1, device_cache="on", fused_epochs="on")
    cfg = port_train.TrainConfig(**base)
    logs = []
    s1 = port_train.fit(cfg, device="cpu", log=logs.append)
    assert s1["steps"] == 60
    assert "device cache: dataset resident on device" in logs
    assert any(m.startswith("fused epochs: ") and "eager" in m for m in logs)
    recs = [json.loads(line) for line in
            open(os.path.join(run, "metrics.jsonl")).read().splitlines()]
    segs = [r for r in recs if "loss" in r]
    assert sum(r["steps"] for r in segs) == 60
    assert max(r["steps"] for r in segs) <= 25
    assert [r["step"] for r in segs][-1] == 60
    crossings = [r["step"] for r in segs
                 if r["step"] // 25 > (r["step"] - r["steps"]) // 25]
    assert len(crossings) == 2  # the crossings of 25 and 50
    assert [r["step"] for r in recs if "val_cer" in r] == crossings
    assert segs[-1]["loss"] < 0.5 * segs[0]["loss"], segs
    best = json.load(open(os.path.join(run, "best", "meta.json")))
    extra = best["extra"]
    assert extra["stack_epochs"] == 4 and extra["stack_rows_done"] == sum(
        r["steps"] for r in segs if r["epoch"] == segs[-1]["epoch"]
        and r["step"] <= best["step"])

    cfg2 = dataclasses.replace(cfg, max_steps=20, resume=True)
    s2 = port_train.fit(cfg2, device="cpu", log=lambda *a: None)
    assert s2["steps"] == 80
    variables, mcfg, _, _, meta = jax_ckpt.load_snapshot(
        os.path.join(run, "last"))
    assert meta["step"] == 80 and meta["extra"]["final"]
    assert mcfg.num_classes == variables["params"]["head"]["kernel"].shape[1]


def test_fit_cached_per_step_equals_streaming(synth_dir, tmp_path):
    """With the cache and fused epochs off, the per-step loop iterates
    the cache's batches: the same losses and validation as streaming."""
    base = dict(port_train.PRESETS["synth-tiny"])
    base.update(data_dir=synth_dir, max_steps=6, val_interval_steps=6,
                log_interval=1, batch_pixels=2**16, seed=2)
    recs = {}
    for cache in ("on", "off"):
        run = str(tmp_path / cache)
        logs = []
        port_train.fit(port_train.TrainConfig(
            **base, snapshot_dir=run, device_cache=cache,
            fused_epochs="off"), device="cpu", log=logs.append)
        assert ("device cache: dataset resident on device" in logs) == (
            cache == "on")
        assert not any(m.startswith("fused epochs") for m in logs)
        recs[cache] = [
            {k: r[k] for k in ("step", "loss", "gnorm", "val_cer")
             if k in r}
            for r in map(json.loads, open(os.path.join(
                run, "metrics.jsonl")).read().splitlines())]
    assert len(recs["on"]) == 7 and recs["on"] == recs["off"]


def test_steps_are_graphs_on_cuda_without_gloo(monkeypatch):
    """The capture decision comes from the device and the groups'
    backends alone: CUDA with no group or NCCL groups captures; any gloo
    group, or the CPU, runs the steps eagerly."""
    backends = {"d": "nccl", "m": "nccl", "g": "gloo"}
    monkeypatch.setattr(port_train, "_cuda_backend", backends.__getitem__)

    def mesh(group, model_group):
        return dataclasses.replace(
            port_train.make_mesh(device="cpu"), group=group,
            model_group=model_group)

    assert port_train.steps_as_graphs("cuda", None)
    assert port_train.steps_as_graphs("cuda:0", mesh(None, None))
    assert port_train.steps_as_graphs("cuda", mesh("d", "m"))
    assert not port_train.steps_as_graphs("cuda", mesh("g", None))
    assert not port_train.steps_as_graphs("cuda", mesh("d", "g"))
    assert not port_train.steps_as_graphs("cpu", None)


def test_cli_takes_the_cache_flags():
    args = port_train.build_argparser().parse_args(
        ["--preset", "synth-tiny", "--device-cache", "on", "--fused-epochs",
         "on", "--epoch-stack", "2", "--device-cache-bytes", "1024"])
    cfg = port_train.config_from_args(args)
    assert (cfg.device_cache, cfg.fused_epochs, cfg.epoch_stack,
            cfg.device_cache_bytes) == ("on", "on", 2, 1024)


# --- two ranks ----------------------------------------------------------------------
def _child():
    spec = importlib.util.spec_from_file_location(
        "torch_port_dp_child", os.path.join(ROOT, "tests",
                                            "torch_port_dp_child.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_two_gloo_ranks_fused_equal_one_process(synth_dir, tmp_path):
    """Three global batches of 8 of one bucket, the last row of the first
    padding; the tiny f32 model (dropout 0), Adam lr 1e-3."""
    child = _child()
    job = str(tmp_path)
    pipe, _ = _pipes(synth_dir, drop_remainder=True, batch_multiple=2)
    _, arrays, idx, _ = max(DeviceCache(pipe, device="cpu").epoch_plan(0),
                            key=lambda p: p[2].shape[0])
    assert idx.shape == (idx.shape[0], 8) and idx.shape[0] >= 3
    batches = {}
    for k in range(3):
        for f, a in zip(FIELDS, arrays):
            batches[f"{f}_{k}"] = a.index_select(0, idx[k]).numpy()
        batches[f"valid_{k}"] = np.arange(8) < 8 - (k == 0)
    np.savez(os.path.join(job, "batches.npz"), **batches)
    model = _tiny_model(pipe.alphabet.num_classes, dropout=0.0)
    np.savez(os.path.join(job, "weights.npz"), **{
        f"sd/{k}": v.numpy() for k, v in model.state_dict().items()})
    with open(os.path.join(job, "job.json"), "w") as f:
        json.dump({"runs": [{"config": model.config.to_json(),
                             "optimizer": "adam", "lr": 1e-3, "steps": 3,
                             "fused": True}]}, f)
    ranks, _ = child.spawn_ranks(job, 2, "cpu", "gloo", RANK_TIMEOUT_S)
    one = child.run_job(job)
    r0, r1 = ranks
    assert sorted(r0) == sorted(r1) == sorted(one)
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    np.testing.assert_allclose(r0["0/loss"], one["0/loss"], rtol=1e-5)
    np.testing.assert_allclose(r0["0/gnorm"], one["0/gnorm"], rtol=1e-4)
    names = [k for k in one if k.startswith("0/sd/")
             and not k.endswith("num_batches_tracked")]
    assert len(names) > 10
    for k in names:
        np.testing.assert_allclose(r0[k], one[k], atol=3e-3, rtol=2e-2,
                                   err_msg=k)
