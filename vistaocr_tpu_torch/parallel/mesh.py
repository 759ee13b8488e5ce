"""The JAX mesh's ``data`` and ``model`` axes, as process groups or a
device list.

Counterpart of ``vistaocr_tpu/parallel/mesh.py``. JAX drives every local
chip from one process and lets GSPMD lay the collectives; PyTorch trains
on several GPUs with one process per GPU joined by ``torch.distributed``.
So the port's mesh is:

- in training, the ranks of the default process group (``make_mesh()``)
  laid out as JAX's ``np.array(devices).reshape(data, model)``: rank ``r``
  is ``(data_index, model_index) = divmod(r, model)``. The ``data`` axis
  (``Mesh.group``: the ranks of one ``model_index``) takes a contiguous
  slice of every global batch (``shard_rows``) by its ``data_index``; the
  gradients are summed over it in one flat buffer (``all_reduce_grads``),
  BatchNorm sums its per-channel statistics over it inside autograd
  (``all_reduce_sum``), and the host gathers small integer arrays over it
  (``all_gather_host``: the validation frames). The ``model`` axis
  (``Mesh.model_group``: the ranks of one ``data_index``) is tensor
  parallelism by JAX's ``_TP_RULES``: each rank holds the column shard
  of the bridge and of every BLSTM ``wx``, ``wh`` and ``b``
  (``param_shardings``, ``shard_model``), computes its columns of those
  GEMMs and gathers them (``gather_columns``), and sums the input
  gradients of its partial products (``copy_to_model``). Every rank of a
  model group holds the same rows, so every gradient, sharded or
  replicated, is summed over the data axis only;
- in serving, a list of this process's devices (``make_mesh(config,
  devices=...)``): the service splits each batch into one contiguous
  shard a device and joins the outputs in order.

An axis of one rank has no group (None) and runs no collective: with
``model=1`` the data group is the default group, as before the model
axis existed. ``partition.py`` has no counterpart: its
``custom_partitioning`` only keeps GSPMD from gathering the batch around
the Pallas calls, and nothing here gathers the batch.

Only the thread that drives the training loop issues collectives; the
pipeline's prefetch threads copy to the local device and never do.
"""

from __future__ import annotations

import dataclasses
import datetime
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..runtime import resolve_device

# a collective (or the group's start) that waits longer raises: a rank that
# died must not leave its peers waiting for ever
DIST_TIMEOUT_S = 600

@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1  # -1: all remaining ranks or devices
    model: int = 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data`` x ``model`` over ranks (training) or over this process's
    ``devices`` (serving). ``device`` is this rank's device (the first of
    ``devices``); rank ``rank`` sits at ``(data_index, model_index)``;
    ``group`` is the data axis's process group and ``model_group`` the
    model axis's, each None where its axis has one rank."""

    data: int
    model: int
    rank: int
    world_size: int
    device: torch.device
    devices: Tuple[torch.device, ...]
    group: Optional[object] = None
    data_index: int = 0
    model_index: int = 0
    model_group: Optional[object] = None

    @property
    def world_group(self):
        """Every rank (barriers, the plan fingerprints); None with one."""
        return dist.group.WORLD if self.world_size > 1 else None


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


def _axis_groups(data: int, model: int, data_index: int, model_index: int):
    """This rank's data and model groups. Every rank creates every group of
    an axis with more than one rank, in the same order (``new_group`` is a
    collective of the default group)."""
    timeout = datetime.timedelta(seconds=DIST_TIMEOUT_S)
    group = model_group = None
    if data > 1:
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)],
                               timeout=timeout)
            if m == model_index:
                group = g
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)],
                           timeout=timeout)
        if d == data_index:
            model_group = g
    return group, model_group


def make_mesh(config: MeshConfig = MeshConfig(),
              devices: Optional[Sequence] = None, *,
              device="cuda") -> Mesh:
    """With ``devices``: a mesh over those devices of this process. Without:
    a mesh over the ranks of the default process group (one rank when it
    is not initialised), on ``device``; a CUDA device without an index
    is ``cuda:<rank % device_count>``, the rank's local GPU when each host
    runs one rank a GPU. Either way ``data * model`` must equal the count
    (JAX's check), else ``ValueError``. With ``model > 1`` every rank
    creates the axes' groups, so every rank must call this."""
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
    data_index, model_index = divmod(rank, model)
    if model == 1:
        group, model_group = (dist.group.WORLD if world > 1 else None), None
    else:
        group, model_group = _axis_groups(data, model, data_index,
                                          model_index)
    return Mesh(data, model, rank, world, dev, (dev,), group, data_index,
                model_index, model_group)


# --- the model axis: JAX's _TP_RULES over the port's parameter names ---------
# Matmul weights shard their OUTPUT axis on 'model' (column parallel). The
# BLSTM keeps JAX's layouts ([D, 4H], [H, 4H], [4H]); torch's Linear
# weight is [out, in], so the bridge's kernel columns are its rows. The
# head and every conv and BatchNorm parameter stay replicated.
_TP_RULES = (
    (re.compile(r"blstm\.l\d+_(fwd|bwd)_(wx|wh)$"), (None, "model")),
    (re.compile(r"blstm\.l\d+_(fwd|bwd)_b$"), ("model",)),
    (re.compile(r"bridge\.weight$"), ("model", None)),
    (re.compile(r"bridge\.bias$"), ("model",)),
)
# optimizer-state slots follow their parameter (``mu/<name>``)
_SLOT = re.compile(r"^(mu|nu|trace)/")


def _rule(name: str) -> Optional[Tuple]:
    name = _SLOT.sub("", name)
    for rx, spec in _TP_RULES:
        if rx.match(name):
            return spec
    return None


def sharded_dim(name: str, mesh: Mesh) -> Optional[int]:
    """The dimension of parameter (or optimizer slot) ``name`` sharded on
    the model axis, None where it is replicated (every name with
    ``model=1``)."""
    spec = _rule(name) if mesh.model > 1 else None
    return None if spec is None else spec.index("model")


def param_shardings(params: Dict[str, object],
                    mesh: Mesh) -> Dict[str, object]:
    """``name -> spec`` for a state dict or an optimizer state of the whole
    model: JAX's partition spec (a tuple, one axis name or None a
    dimension) of every tensor that the model axis shards, else
    ``"replicated"``; every name with ``model=1``. A sharded dimension
    that the model axis does not divide raises ``ValueError`` naming the
    parameter (JAX's ``device_put`` refuses the same)."""
    out = {}
    for name, p in params.items():
        dim = sharded_dim(name, mesh)
        if dim is None:
            out[name] = "replicated"
            continue
        if p.shape[dim] % mesh.model:
            raise ValueError(
                f"{name}: dimension {dim} of shape {tuple(p.shape)} does not "
                f"divide over model={mesh.model}")
        out[name] = _rule(name)
    return out


def _columns(mesh: Mesh, size: int) -> slice:
    per = size // mesh.model
    return slice(mesh.model_index * per, (mesh.model_index + 1) * per)


def _index(dim: int, cols: slice) -> tuple:
    return (slice(None),) * dim + (cols,)


def shard_state_dict(sd: Dict[str, object], mesh: Mesh) -> Dict[str, object]:
    """This rank's shard of a whole state dict or optimizer state (tensors
    or numpy arrays): each sharded entry cut to its ``model_index``-th
    block of columns (a copy), every other entry as it is."""
    param_shardings(sd, mesh)  # refuses a width the axis does not divide
    out = {}
    for name, v in sd.items():
        dim = sharded_dim(name, mesh)
        if dim is None:
            out[name] = v
            continue
        part = v[_index(dim, _columns(mesh, v.shape[dim]))]
        out[name] = (part.clone(memory_format=torch.contiguous_format)
                     if isinstance(part, torch.Tensor) else np.array(part))
    return out


@torch.no_grad()
def gather_state_dict(sd: Dict[str, torch.Tensor],
                      mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The whole state dict or optimizer state from every rank's shard
    (tensors): the inverse of ``shard_state_dict``, one collective over
    the model group (every rank of it must call this). Replicated entries
    are this rank's."""
    fulls = {}
    for k, v in sd.items():
        dim = sharded_dim(k, mesh)
        if dim is not None:  # this rank's columns in a zero-filled whole
            shape = list(v.shape)
            shape[dim] *= mesh.model
            fulls[k] = v.new_zeros(shape)
            fulls[k][_index(dim, _columns(mesh, shape[dim]))] = v
    if not fulls:
        return dict(sd)
    return {**sd, **_flat_collective(
        fulls, lambda flat: dist.all_reduce(flat, group=mesh.model_group))}


def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Tensor parallelism over ``mesh.model_group``: every parameter that
    the model axis shards is cut, in place and under its name, to this
    rank's columns, and every module with a ``model_group`` attribute
    (the model's bridge, the BLSTM stack) runs its column-parallel form
    over the group. Load or initialise the whole model first. With
    ``model=1`` nothing changes."""
    if mesh.model == 1:
        return model
    if mesh.model_group is None:
        raise ValueError(f"mesh model={mesh.model} has no model group: "
                         "tensor parallelism runs over ranks (make_mesh "
                         "without devices)")
    params = dict(model.named_parameters())
    shards = shard_state_dict(
        {k: p.detach() for k, p in params.items()}, mesh)
    for name, p in params.items():
        if sharded_dim(name, mesh) is None:
            continue
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner), leaf,
                nn.Parameter(shards[name], requires_grad=p.requires_grad))
    for m in model.modules():
        if hasattr(m, "model_group"):
            m.model_group = mesh.model_group
    return model


def _all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, group=group)
    return t


class _GatherColumns(torch.autograd.Function):
    """The model group's shards joined along the last dimension in
    ``model_index`` order. The all-gather is written as a SUM all-reduce of
    a zero-filled full-width buffer into which each rank writes its
    columns: exact (``x + 0 == x``), and gloo (which cannot all-gather
    CUDA tensors) and NCCL run it alike, so every check exercises the one
    path. Backward: this rank's columns of the incoming gradient, which
    is the same on every rank of the group because everything after the
    gather is replicated."""

    @staticmethod
    def forward(ctx, x, group):
        rank, count = dist.get_rank(group), dist.get_world_size(group)
        w = x.shape[-1]
        ctx.cols = slice(rank * w, (rank + 1) * w)
        out = x.new_zeros(*x.shape[:-1], count * w)
        out[..., ctx.cols] = x
        return _all_reduce_(out, group)

    @staticmethod
    def backward(ctx, grad):
        return grad[..., ctx.cols].contiguous(), None


class _CopyToModel(torch.autograd.Function):
    """Identity forward; SUM over the model group backward: the input
    gradient of a column-parallel GEMM, each rank's from its columns."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_(grad.clone(memory_format=torch.contiguous_format),
                            ctx.group), None


def gather_columns(x: torch.Tensor, group) -> torch.Tensor:
    """Every model rank's ``x`` joined along the last dimension,
    differentiable; ``x`` itself when ``group`` is None."""
    return x if group is None else _GatherColumns.apply(x, group)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` on the way in to a column-parallel GEMM: its gradient is
    summed over the model group; ``x`` itself when ``group`` is None."""
    return x if group is None else _CopyToModel.apply(x, group)


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
    return _flat_collective(
        grads, lambda flat: dist.all_reduce(flat, group=group))


@torch.no_grad()
def _flat_collective(tensors: Dict[str, torch.Tensor],
                     collective) -> Dict[str, torch.Tensor]:
    """``collective`` (in place) on every tensor at once, through one flat
    float32 buffer; each comes back in its shape and dtype."""
    names = list(tensors)
    flat = torch.cat([tensors[k].reshape(-1).to(torch.float32)
                      for k in names])
    collective(flat)
    out, at = {}, 0
    for k in names:
        t = tensors[k]
        out[k] = flat[at:at + t.numel()].view(t.shape).to(t.dtype)
        at += t.numel()
    return out


@torch.no_grad()
def broadcast_model(tensors: Dict[str, torch.Tensor],
                    mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Model index 0's ``tensors`` on every rank of its model group, through
    one flat buffer; ``tensors`` itself without a model group. The ranks
    of a model group compute the replicated gradients from the same rows
    and parameters, but CUDA's scatter-add (the CTC fold) and cuDNN's
    weight gradients are not bit-reproducible: this keeps the replicated
    parameters bit-equal across the group."""
    if mesh.model_group is None or not tensors:
        return tensors
    return _flat_collective(tensors, lambda flat: dist.broadcast(
        flat, src=mesh.data_index * mesh.model, group=mesh.model_group))


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
