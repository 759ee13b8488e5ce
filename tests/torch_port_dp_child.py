"""One rank of a data- or tensor-parallel run of the port, and the
one-process run it is held against. Imports nothing of JAX, so the card
machine runs it too.

    python tests/torch_port_dp_child.py JOB_DIR RANK WORLD PORT DEVICE BACKEND

``JOB_DIR/job.json`` names the runs; ``weights.npz`` holds the initial
state dict (``sd/<name>``) and ``batches.npz`` the global batches
(``images_k``, ``widths_k``, ``labels_k``, ``label_lengths_k``,
``valid_k``). Each run ``{"config": ModelConfig JSON, "optimizer",
"lr", "steps"}`` starts from the initial weights and takes ``steps``
train steps (clip 5, ``ctc_impl="auto"``) on this rank's rows of batches
0..steps-1; with ``"fused": true`` the steps are one segment of the
epoch-fused trainer (``make_train_epoch``) over batches 0..steps-1 held
whole on every rank as resident arrays, each rank gathering its rows,
and ``loss`` holds the segment's mean and last loss, ``gnorm`` its last
norm. An optional ``"bn"`` entry runs a small ``ConvStack`` in
train mode on this rank's rows of ``bn.npz`` and takes the gradient of
``sum(y * g)``. An optional ``"mesh": {"data": D, "model": M}`` lays the
``D * M`` ranks out as ``parallel.make_mesh`` does (the default: every
rank on the data axis): a rank takes the rows of its data index, and
with ``M > 1`` trains its shard of the model (``shard_model``). The rank
writes ``JOB_DIR/rank<r>.npz``: per run ``<i>/loss`` and ``<i>/gnorm``
(one a step), ``<i>/sd/<name>`` (the state dict after the steps, gathered
over the model group) and ``<i>/count/<counter>`` (the kernels' launches
in the steps), with ``M > 1`` also ``<i>/local/<name>`` (this rank's own
state dict: its shards and its replicated tensors),
``roundtrip/<name>`` (the initial state dict sharded and gathered) and
``mesh/index`` (its data and model index); for
``bn`` ``bn/y``, ``bn/dx``, ``bn/d/<param>`` and ``bn/sd/<name>``.

``run_job(job_dir, mesh=None)`` is the same work in the calling process
on whole batches; ``spawn_ranks`` starts ``WORLD`` ranks with a free port
and a time limit and kills them all if one fails or hangs.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

COUNTERS = (("lstm_cuda", ("SAVE_CELL_LAUNCHES", "BWD_LAUNCHES",
                           "GATES_GEMM_LAUNCHES", "BWD_PERSISTENT_LAUNCHES",
                           "DWH_LAUNCHES", "FWD_GRID_LAUNCHES",
                           "STEP_LAUNCHES", "FRAME_LAUNCHES",
                           "CELL_LAUNCHES", "DH_LAUNCHES")),
            ("ctc_cuda", ("ALPHA_LAUNCHES", "BETA_LAUNCHES")))


def _counter_modules():
    from vistaocr_tpu_torch.ops import ctc_cuda, lstm_cuda

    return {"lstm_cuda": lstm_cuda, "ctc_cuda": ctc_cuda}


def _rows(n, mesh):
    from vistaocr_tpu_torch.parallel import shard_rows

    return slice(None) if mesh is None else shard_rows(n, mesh.data_index,
                                                       mesh.data)


def _load_model(config_json, sd, dev):
    from vistaocr_tpu_torch.models import CnnLstmOcr, ModelConfig

    model = CnnLstmOcr(ModelConfig.from_json(config_json))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model.to(dev)


def run_steps(run: dict, sd: dict, batches, mesh, dev) -> dict:
    """One run's train steps on this rank's rows (all rows without a
    mesh)."""
    from vistaocr_tpu_torch import train as T
    from vistaocr_tpu_torch.parallel import gather_state_dict, shard_model

    model = _load_model(run["config"], sd, dev)
    if mesh is not None:
        shard_model(model, mesh)
    tx = T.Optimizer(run["optimizer"])
    state = T.TrainState(model=model,
                         opt_state=tx.init(dict(model.named_parameters())))
    mods = _counter_modules()
    for mod, names in COUNTERS:
        for name in names:
            setattr(mods[mod], name, 0)
    losses, gnorms = [], []
    if run.get("fused"):
        epoch = T.make_train_epoch(model, tx, False, "auto", grad_clip=5.0,
                                   mesh=mesh)
        steps = range(run["steps"])
        arrays = [torch.from_numpy(np.concatenate(
            [batches[f"{f}_{k}"] for k in steps])).to(dev)
            for f in ("images", "widths", "labels", "label_lengths")]
        bsz = len(batches["valid_0"])
        idx = torch.arange(len(steps) * bsz, dtype=torch.int32).view(-1, bsz)
        w = torch.from_numpy(np.stack([batches[f"valid_{k}"] for k in steps])
                             .astype(np.float32))
        m = epoch(state, arrays, idx.to(dev), w.to(dev), run["lr"])
        losses += [float(m["loss"]), float(m["last_loss"])]
        gnorms.append(float(m["gnorm"]))
    step = T.make_train_step(model, tx, False, "auto", grad_clip=5.0,
                             mesh=mesh)
    for k in range(0 if run.get("fused") else run["steps"]):
        rows = _rows(len(batches[f"valid_{k}"]), mesh)
        args = [torch.from_numpy(batches[f"{f}_{k}"][rows]).to(dev)
                for f in ("images", "widths", "labels", "label_lengths")]
        w = torch.from_numpy(
            batches[f"valid_{k}"][rows].astype(np.float32)).to(dev)
        m = step(state, *args, w, run["lr"])
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    out = {"loss": np.asarray(losses), "gnorm": np.asarray(gnorms)}
    for mod, names in COUNTERS:
        for name in names:
            out[f"count/{name}"] = np.asarray(getattr(mods[mod], name))
    local = model.state_dict()
    whole = local if mesh is None else gather_state_dict(local, mesh)
    for k, v in whole.items():
        out[f"sd/{k}"] = v.detach().cpu().numpy()
    if mesh is not None and mesh.model > 1:
        for k, v in local.items():
            out[f"local/{k}"] = v.detach().cpu().numpy()
    return out


def run_roundtrip(sd: dict, mesh, dev) -> dict:
    """The initial state dict cut to this rank's shard and gathered."""
    from vistaocr_tpu_torch.parallel import gather_state_dict, shard_state_dict

    whole = {k: torch.from_numpy(v).to(dev) for k, v in sd.items()}
    back = gather_state_dict(shard_state_dict(whole, mesh), mesh)
    return {k: v.cpu().numpy() for k, v in back.items()}


def run_bn(spec: dict, arrays, mesh, dev) -> dict:
    """A ``ConvStack`` forward in train mode on this rank's rows and the
    gradient of ``sum(y * g)`` w.r.t. its input and parameters."""
    from vistaocr_tpu_torch.models import ConvStack, ConvStageSpec

    stack = ConvStack(tuple(ConvStageSpec(c, n, tuple(p))
                            for c, n, p in spec["stages"]),
                      in_channels=spec["in_channels"])
    stack.load_state_dict({k[3:]: torch.from_numpy(v)
                           for k, v in arrays.items() if k.startswith("sd/")})
    stack.to(dev)
    rows = _rows(arrays["x"].shape[0], mesh)
    x = torch.from_numpy(arrays["x"][rows]).to(dev).requires_grad_(True)
    y = stack(x, train=True, group=None if mesh is None else mesh.group)
    g = torch.from_numpy(arrays["g"][rows]).to(dev)
    params = dict(stack.named_parameters())
    grads = torch.autograd.grad((y * g).sum(), [x, *params.values()])
    out = {"y": y.detach().cpu().numpy(), "dx": grads[0].cpu().numpy()}
    for name, d in zip(params, grads[1:]):
        out[f"d/{name}"] = d.cpu().numpy()
    for k, v in stack.state_dict().items():
        out[f"sd/{k}"] = v.detach().cpu().numpy()
    return out


def run_job(job_dir: str, mesh=None, device="cpu") -> dict:
    """Every run of ``job.json`` (and ``bn``), flat ``{key: array}``."""
    with open(os.path.join(job_dir, "job.json")) as f:
        job = json.load(f)
    dev = mesh.device if mesh is not None else torch.device(device)
    out = {}
    if job.get("runs"):
        with np.load(os.path.join(job_dir, "weights.npz")) as z:
            sd = {k[3:]: z[k] for k in z.files}
        with np.load(os.path.join(job_dir, "batches.npz")) as z:
            batches = {k: z[k] for k in z.files}
        for i, run in enumerate(job["runs"]):
            for k, v in run_steps(run, sd, batches, mesh, dev).items():
                out[f"{i}/{k}"] = v
        if mesh is not None and mesh.model > 1:
            for k, v in run_roundtrip(sd, mesh, dev).items():
                out[f"roundtrip/{k}"] = v
            out["mesh/index"] = np.asarray([mesh.data_index,
                                            mesh.model_index])
    if job.get("bn"):
        with np.load(os.path.join(job_dir, "bn.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        for k, v in run_bn(job["bn"], arrays, mesh, dev).items():
            out[f"bn/{k}"] = v
    return out


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn_ranks(job_dir: str, world: int, device: str, backend: str,
                timeout: float):
    """Run ``world`` ranks of this script on ``job_dir``; returns each
    rank's output arrays and stdout. Raises with a rank's stderr as soon
    as one fails, and kills every rank if they outlive ``timeout``
    seconds."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    port = free_port()
    logs = [os.path.join(job_dir, f"rank{r}.{k}") for r in range(world)
            for k in ("out", "err")]
    procs = []
    try:
        for r in range(world):
            with open(logs[2 * r], "w") as out, open(logs[2 * r + 1],
                                                     "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), job_dir,
                     str(r), str(world), str(port), device, backend],
                    env=env, cwd=repo, stdout=out, stderr=err))
        deadline = time.time() + timeout
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed or time.time() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    # a rank that failed by itself first, then one that was killed
    for r in sorted(range(world), key=lambda r: procs[r].returncode < 0):
        if procs[r].returncode != 0:
            with open(logs[2 * r + 1]) as f:
                raise RuntimeError(
                    f"rank {r} of {world} exited {procs[r].returncode} (killed "
                    f"after {timeout} s if negative):\n{f.read()[-3000:]}")
    results, outs = [], []
    for r in range(world):
        with np.load(os.path.join(job_dir, f"rank{r}.npz")) as z:
            results.append({k: z[k] for k in z.files})
        with open(logs[2 * r]) as f:
            outs.append(f.read())
    return results, outs


def main(argv) -> int:
    job_dir, rank, world, port, device, backend = argv
    from vistaocr_tpu_torch.parallel import MeshConfig, make_mesh
    from vistaocr_tpu_torch.runtime import disable_tf32
    from vistaocr_tpu_torch.train import maybe_init_distributed

    torch.set_num_threads(2)
    disable_tf32()
    maybe_init_distributed(f"127.0.0.1:{port}", int(world), int(rank),
                           backend=backend)
    with open(os.path.join(job_dir, "job.json")) as f:
        shape = json.load(f).get("mesh", {})
    try:
        mesh = make_mesh(MeshConfig(**shape), device=device)
        out = run_job(job_dir, mesh)
        for k in sorted(out):
            if "/count/" in k and int(out[k]):
                print(f"rank {rank} {k} {int(out[k])}", flush=True)
        np.savez(os.path.join(job_dir, f"rank{rank}.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
