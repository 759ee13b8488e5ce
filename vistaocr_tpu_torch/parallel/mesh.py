"""The ``data`` axis of the JAX mesh, as a process group or a device list.

Counterpart of ``vistaocr_tpu/parallel/mesh.py``. JAX drives every local
chip from one process and lets GSPMD lay the collectives; PyTorch trains
on several GPUs with one process per GPU joined by ``torch.distributed``.
So the port's ``data`` axis is:

- in training, the ranks of the default process group (``make_mesh()``):
  each rank holds the whole model on its own device and takes a
  contiguous slice of every global batch (``shard_rows``); the gradients
  are summed over the group in one flat buffer (``all_reduce_grads``),
  BatchNorm sums its per-channel statistics over the group inside
  autograd (``all_reduce_sum``), and the host gathers small integer
  arrays (``all_gather_host``: the validation frames, the plan
  fingerprints);
- in serving, a list of this process's devices (``make_mesh(config,
  devices=...)``): the service splits each batch into one contiguous
  shard a device and joins the outputs in order.

With one rank there is no group (``Mesh.group is None``) and no
collective runs. The ``model`` axis (tensor parallelism) is not ported:
``param_shardings`` raises for ``model > 1``. ``partition.py`` has no
counterpart: its ``custom_partitioning`` only keeps GSPMD from gathering
the batch around the Pallas calls, and nothing here gathers.

Only the thread that drives the training loop issues collectives; the
pipeline's prefetch threads copy to the local device and never do.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..runtime import resolve_device

TP_ITEM = "ROADMAP Queue 1, item 7b"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1  # -1: all remaining ranks or devices
    model: int = 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data`` x ``model`` over ranks (training) or over this process's
    ``devices`` (serving). ``device`` is this rank's device (the first of
    ``devices``); ``group`` is the data axis's process group, None with
    one rank."""

    data: int
    model: int
    rank: int
    world_size: int
    device: torch.device
    devices: Tuple[torch.device, ...]
    group: Optional[object] = None


def local_devices(device_type: str = "cuda") -> List[torch.device]:
    """This process's devices of ``device_type``: every visible GPU, or
    the one CPU."""
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


def _shape(config: MeshConfig, n: int, what: str) -> Tuple[int, int]:
    model = max(1, config.model)
    data = config.data if config.data > 0 else n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} {what}")
    return data, model


def make_mesh(config: MeshConfig = MeshConfig(),
              devices: Optional[Sequence] = None, *,
              device="cuda") -> Mesh:
    """With ``devices``: a mesh over those devices of this process. Without:
    a mesh over the ranks of the default process group (one rank when it
    is not initialised), on ``device``; a CUDA device without an index
    is ``cuda:<rank % device_count>``, the rank's local GPU when each host
    runs one rank a GPU. Either way ``data * model`` must equal the count
    (JAX's check), else ``ValueError``."""
    if devices is not None:
        devices = tuple(torch.device(d) for d in devices)
        data, model = _shape(config, len(devices), "devices")
        return Mesh(data, model, 0, 1, devices[0], devices)
    multi = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if multi else 1
    rank = dist.get_rank() if multi else 0
    data, model = _shape(config, world, "ranks")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    group = dist.group.WORLD if world > 1 else None
    return Mesh(data, model, rank, world, dev, (dev,), group)


def param_shardings(params: Dict[str, torch.Tensor],
                    mesh: Mesh) -> Dict[str, str]:
    """Every parameter replicated over the data axis. The column-parallel
    rules of a ``model`` axis (``_TP_RULES`` of the JAX module) are not
    ported."""
    if mesh.model > 1:
        raise NotImplementedError(
            f"mesh model={mesh.model}: tensor parallelism is not ported "
            f"yet ({TP_ITEM})")
    return {name: "replicated" for name in params}


def shard_rows(n: int, index: int, count: int) -> slice:
    """Rows of shard ``index`` of ``count`` in a batch of ``n``: one
    contiguous slice each, in order."""
    if n % count:
        raise ValueError(f"batch of {n} does not divide over {count} shards")
    per = n // count
    return slice(index * per, (index + 1) * per)


class _AllReduceSum(torch.autograd.Function):
    """SUM over the group, and SUM of the gradients on the way back (the
    gradient of every rank's loss reaches every rank's input), as
    ``torch.distributed.nn.functional.all_reduce``, which newer PyTorch
    deprecates."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(tensor: torch.Tensor, group) -> torch.Tensor:
    """The SUM of ``tensor`` over ``group``, differentiable; no collective
    when ``group`` is None."""
    if group is None:
        return tensor
    return _AllReduceSum.apply(tensor, group)


@torch.no_grad()
def all_reduce_grads(grads: Dict[str, torch.Tensor],
                     group) -> Dict[str, torch.Tensor]:
    """The SUM of every gradient over ``group`` through one flat buffer
    (one collective a step)."""
    if group is None:
        return grads
    names = list(grads)
    flat = torch.cat([grads[k].reshape(-1).to(torch.float32) for k in names])
    dist.all_reduce(flat, group=group)
    out, at = {}, 0
    for k in names:
        g = grads[k]
        out[k] = flat[at:at + g.numel()].view(g.shape).to(g.dtype)
        at += g.numel()
    return out


def all_gather_host(arr: np.ndarray, group) -> np.ndarray:
    """Every rank's ``arr`` (equal shapes, a small integer array on the
    host) joined along axis 0 in rank order. Host tensors only: gloo
    cannot all-gather CUDA tensors."""
    if group is None:
        return arr
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int64))
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts).numpy().astype(arr.dtype)


def barrier(group) -> None:
    """Wait for every rank of ``group``: a host all-reduce, which takes the
    CPU backend whatever the device backend is."""
    if group is not None:
        dist.all_reduce(torch.zeros(1), group=group)
