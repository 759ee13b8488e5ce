"""Training entry point: one CUDA device, or one process a GPU.

Counterpart of ``vistaocr_tpu/train.py:66-967``: the same ``TrainConfig``
fields and ``PRESETS``, the same CLI flags (``--device`` in place of
``--platform``), and the per-step loop of ``fit`` (``train.py:837-861``):
batches from ``BatchPipeline.device_epoch``; ``train_step`` runs the
forward in train mode (BatchNorm batch statistics, dropout, augment), the
CTC loss (``ctc_impl``), the backward, the global-norm clip, Adam or SGD,
and the BatchNorm running-statistics update (none under the model's
``conv_norm="none"``, which holds no BatchNorm); every ``val_interval_steps``
a greedy validation with CER/WER and a snapshot (``last/``, promoted to
``best/`` on a new best CER, plateau LR decay); metrics as JSONL;
divergence checks; resume from ``last/`` with the optimizer state.

Data parallelism (the mesh's ``data`` axis, ``train.py:471-473``) is one
process a GPU joined by ``torch.distributed`` (``parallel/mesh.py``):
every rank derives the same global batches (``batch_multiple`` = the rank
count) and takes its contiguous rows of each; BatchNorm takes its
statistics over the global batch, the CTC mean divides by the global
weight sum, and the gradients are summed over the ranks in one flat
buffer before the norm, the clip and the update, so every rank holds the
same parameters. Before the first step the ranks compare their epoch-plan
fingerprints; validation gathers the greedy frames of every rank's rows on
the host, so every rank computes the same CER; only rank 0 writes
snapshots and ``metrics.jsonl``. ``--coordinator-address``,
``--num-processes`` and ``--process-id`` start the group
(``maybe_init_distributed``), and each process trains on
``cuda:<rank % device_count>`` unless ``--device`` names an index.

Tensor parallelism (the mesh's ``model`` axis, ``mesh_model``,
``train.py:532-537``) lays the ranks out as ``data x model``: the ranks
of one ``data_index`` form a model group and take the same rows. Each
holds its column shard of the bridge and of every BLSTM ``wx``, ``wh``
and ``b`` (JAX's ``_TP_RULES``), with Adam's moments of a shard sharded
alike, and gathers the columns of those GEMMs over the group
(``parallel/mesh.py``); the LSTM and CTC kernels run whole on its rows.
Every gradient is summed over the data axis only (the replicated ones
then taken from model index 0, so the group's copies stay bit-equal),
and the norm for the clip is that of the whole gradients. A fresh run initialises the whole
model from the seed and then shards it; a resume shards the whole
snapshot; a snapshot gathers the shards, so its files are those of one
rank and any mesh resumes them.

The device-resident dataset cache (``device_cache="on"``,
``data/device_cache.py``) keeps every bucket's lines on the device and
draws each epoch's batches by an on-device gather; ``"auto"`` leaves it
off on the card and the CPU, as the reference does on every backend but
a TPU, and a split over ``device_cache_bytes`` streams. With the cache, the
epoch-fused trainer (``fused_epochs`` ``"on"``, or ``"auto"``, which
follows the cache; ``make_train_epoch``, ``train.py:303-377``) runs the
reference's segments: each bucket's rows of ``epoch_stack`` epochs form
one index matrix, run as segments of at most ``val_interval_steps``
steps with no host synchronisation and no batch copied from the host
inside a segment. On the card each step of a segment is one replay of a
CUDA graph, captured once for each batch shape (the counterpart of
XLA's compiled ``lax.scan`` body); on the CPU, and under a gloo group
(whose collectives run on the host and cannot be captured), the steps
of a segment run eagerly. Every step draws the dropout masks of the
per-step path.

Usage:
    python -m vistaocr_tpu_torch.train --preset full --data-dir D \\
        --snapshot-dir S --device cuda
    # N ranks, one a GPU (run once for each r in 0..N-1):
    python -m vistaocr_tpu_torch.train ... --coordinator-address \\
        HOST:PORT --num-processes N --process-id r
    # data x model ranks, N = data * model: add --mesh-model M
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .checkpoint import (
    has_opt_state,
    load_opt_state,
    load_snapshot,
    promote,
    save_snapshot,
    variables_to_state_dict,
)
from .data.buckets import ShapeContract, make_ladder
from .data.device_cache import DeviceCache
from .data.pipeline import BatchPipeline
from .data.shards import open_dataset
from .decode.greedy import collapse_frames, greedy_frames
from .models import CnnLstmOcr, ConvStageSpec, ModelConfig, init_parameters
from .ops.ctc import mean_ctc_loss
from .parallel.mesh import (DIST_TIMEOUT_S, Mesh, MeshConfig,
                            all_gather_host, all_reduce_grads,
                            all_reduce_sum, barrier, broadcast_model,
                            gather_state_dict, make_mesh, shard_model,
                            shard_rows, shard_state_dict, sharded_dim)
from .runtime import disable_tf32
from .text import Alphabet, cer_wer


# --------------------------------------------------------------------------
# Config (field for field the JAX TrainConfig and PRESETS)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class TrainConfig:
    data_dir: str = ""
    snapshot_dir: str = ""
    # model
    line_height: int = 32
    lstm_hidden: int = 512
    lstm_layers: int = 2
    bridge_dim: int = 512
    dropout: float = 0.1
    augment: float = 0.0  # train-time on-device degradation strength
    compute_dtype: str = "bfloat16"
    tiny_model: bool = False  # config #1 scale
    # data
    bucket_widths: Tuple[int, ...] = (128, 256, 384, 512, 768, 1024, 1536, 2048)
    auto_ladder: bool = False  # corpus-tuned align=32 ladder (make_ladder)
    max_label_len: int = 256
    batch_pixels: int = 2**21
    # optimization
    optimizer: str = "adam"  # adam | sgd
    lr: float = 1e-3
    momentum: float = 0.9
    grad_clip: float = 5.0
    label_average: bool = False
    ctc_impl: str = "auto"  # auto | scan | pallas | pallas_interpret
    epochs: int = 50
    max_steps: int = 0  # 0 = unlimited
    # validation / snapshots
    val_interval_steps: int = 500
    plateau_patience: int = 3
    plateau_decay: float = 0.5
    min_lr: float = 1e-6
    # misc
    seed: int = 0
    mesh_model: int = 1
    resume: bool = False
    log_interval: int = 50
    # Device-resident dataset cache (data/device_cache.py): every epoch's
    # batches gathered on the device. "auto" is off here (the reference
    # turns it on only on a TPU); a split over device_cache_bytes streams.
    device_cache: str = "auto"  # auto | on | off
    device_cache_bytes: int = 4 * 2**30
    # Epoch-fused trainer (make_train_epoch): segments of steps over the
    # resident data, a CUDA graph replay a step on the card. Needs the
    # cache; "auto" follows it. A segment's batches share one bucket.
    fused_epochs: str = "auto"  # auto | on | off
    # Fused path: this many epochs' index rows per bucket in one plan
    # (DeviceCache.epoch_plan). A snapshot taken mid-stack records the
    # stack's start epoch, so a resume replays up to epoch_stack epochs of
    # data; "stack_rows_done"/"stack_epochs" in its meta say where it was.
    epoch_stack: int = 4
    # torch.profiler trace of steps [profile_start, profile_stop) into
    # <snapshot_dir>/profile (trace.json, ops.txt: time by op, device.txt:
    # device busy share and time by kernel)
    profile_start: int = 0
    profile_stop: int = 0

    def model_config(self, num_classes: int) -> ModelConfig:
        stages = (
            (
                ConvStageSpec(16, 1, (2, 2)),
                ConvStageSpec(32, 1, (2, 2)),
                ConvStageSpec(32, 1, (2, 1)),
            )
            if self.tiny_model
            else (
                ConvStageSpec(64, 2, (2, 2)),
                ConvStageSpec(128, 2, (2, 2)),
                ConvStageSpec(256, 2, (2, 1)),
            )
        )
        return ModelConfig(
            num_classes=num_classes,
            line_height=self.line_height,
            stages=stages,
            bridge_dim=self.bridge_dim if not self.tiny_model else 64,
            lstm_hidden=self.lstm_hidden if not self.tiny_model else 64,
            lstm_layers=self.lstm_layers if not self.tiny_model else 1,
            dropout=self.dropout,
            augment=self.augment,
            compute_dtype=self.compute_dtype,
        )

    def contract(self) -> ShapeContract:
        return ShapeContract(
            height=self.line_height,
            bucket_widths=tuple(self.bucket_widths),
            width_stride=4,
            max_label_len=self.max_label_len,
        )


PRESETS = {
    "synth-tiny": dict(
        tiny_model=True,
        compute_dtype="float32",
        bucket_widths=(128, 256, 384, 512),
        batch_pixels=2**18,
        lr=3e-3,
        dropout=0.0,
        val_interval_steps=100,
        epochs=30,
    ),
    "full": dict(auto_ladder=True),
    "handwriting": dict(
        bucket_widths=(256, 384, 512, 768, 1024, 1536, 2048),
        auto_ladder=True,
        max_label_len=256,
        dropout=0.2,
        epochs=120,
        plateau_patience=4,
    ),
    "printed": dict(
        bucket_widths=(128, 256, 384, 512, 768, 1024),
        auto_ladder=True,
        dropout=0.1,
        lr=2e-3,
        epochs=60,
    ),
}


# --------------------------------------------------------------------------
# Optimizer, clip, train state and steps
# --------------------------------------------------------------------------
class Optimizer:
    """``optax.scale_by_adam()`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0)
    or ``optax.trace(decay=momentum)`` over named parameters. The state is
    a flat dict of tensors (``count``, ``mu/<name>``, ``nu/<name>`` or
    ``trace/<name>``), updated in place by ``update``, which returns the
    updates (the step is ``p - lr * update``, as ``train.py:246-250``)."""

    def __init__(self, kind: str, momentum: float = 0.9, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        if kind not in ("adam", "sgd"):
            raise ValueError(f"unknown optimizer {kind!r}")
        self.kind = kind
        self.momentum = momentum
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        first = next(iter(params.values()))
        state = {"count": torch.zeros((), dtype=torch.int32,
                                      device=first.device)}
        slots = ("mu", "nu") if self.kind == "adam" else ("trace",)
        for name, p in params.items():
            for slot in slots:
                state[f"{slot}/{name}"] = torch.zeros_like(
                    p, dtype=torch.float32)
        return state

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor],
               state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.kind == "sgd":
            out = {}
            for name, g in grads.items():
                t = state[f"trace/{name}"]
                t.copy_(g + self.momentum * t)
                out[name] = t.clone()
            return out
        b1, b2 = self.b1, self.b2
        state["count"] += 1
        count = state["count"].to(torch.float32)
        bc1 = 1.0 - b1 ** count
        bc2 = 1.0 - b2 ** count
        out = {}
        for name, g in grads.items():
            mu, nu = state[f"mu/{name}"], state[f"nu/{name}"]
            mu.copy_((1.0 - b1) * g + b1 * mu)
            nu.copy_((1.0 - b2) * (g * g) + b2 * nu)
            out[name] = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
        return out

    @staticmethod
    def state_numpy(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        return {k: v.detach().cpu().numpy() for k, v in state.items()}

    @staticmethod
    def load_numpy(state: Dict[str, torch.Tensor],
                   arrays: Dict[str, np.ndarray]) -> None:
        if set(arrays) != set(state):
            raise KeyError("optimizer state does not match the model: "
                           f"{sorted(set(arrays) ^ set(state))[:5]}")
        for k, v in state.items():
            v.copy_(torch.from_numpy(np.asarray(arrays[k])))


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    """Adam (``optax.scale_by_adam``) or SGD with momentum
    (``optax.trace``); the clip runs in the step (``_clip_by_known_norm``),
    as the JAX trainer's ``include_clip=False``."""
    return Optimizer(cfg.optimizer, momentum=cfg.momentum)


def global_norm(grads: Dict[str, torch.Tensor], model_group=None,
                sharded=()) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of squares of every leaf.
    Under tensor parallelism, the norm of the whole gradients: the
    squares of the ``sharded`` leaves (this rank's columns) are summed
    over ``model_group`` and added to those of the replicated ones, so
    every rank clips alike."""
    def squares(names):
        zero = torch.zeros((), device=next(iter(grads.values())).device)
        return sum((torch.sum(grads[k].to(torch.float32) ** 2)
                    for k in names), zero)

    if model_group is None:
        return torch.sqrt(squares(grads))
    part = squares([k for k in grads if k in sharded])
    dist.all_reduce(part, group=model_group)
    return torch.sqrt(squares([k for k in grads if k not in sharded]) + part)


def _clip_by_known_norm(grads, gnorm, max_norm):
    """``optax.clip_by_global_norm`` with the norm precomputed:
    ``g * (max_norm / gnorm)`` iff ``gnorm >= max_norm``
    (``train.py:233-243``)."""
    keep = gnorm < max_norm
    return {k: torch.where(keep, g, (g / gnorm.to(g.dtype)) * max_norm)
            for k, g in grads.items()}


@dataclasses.dataclass
class TrainState:
    model: CnnLstmOcr
    opt_state: Dict[str, torch.Tensor]
    step: int = 0


def step_seed(seed: int, step: int, data_index: int = 0) -> int:
    """The seed of one step's dropout/augment draws, from (seed, step), so
    a resumed run draws the same masks; a data index above 0 adds itself,
    so the data ranks draw different masks for their rows and the model
    ranks of one data index draw the same."""
    entropy = [seed + 1, step] + ([data_index] if data_index else [])
    return int(np.random.SeedSequence(entropy).generate_state(1)[0])


def step_generator(seed: int, step: int, device: torch.device,
                   data_index: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded with ``step_seed``."""
    return torch.Generator(device=device).manual_seed(
        step_seed(seed, step, data_index))


def loss_and_grads(model: CnnLstmOcr, images, widths, labels, label_lengths,
                   weights, *, label_average: bool = False,
                   ctc_impl: str = "auto",
                   generator: Optional[torch.Generator] = None,
                   group=None):
    """The ``loss_fn`` of ``train.py:262-282`` and its gradients: the
    forward in train mode (which updates the BatchNorm running statistics
    in place), the mean CTC loss, and d loss / d parameter by name. Under
    data parallelism (``group``, this rank's rows) the loss is this rank's
    share of the global mean, and the gradients are its share of the
    global gradients."""
    log_probs, frame_mask = model(images, widths, train=True,
                                  generator=generator, group=group)
    frames = frame_mask.sum(dim=1).to(torch.int32)
    loss = mean_ctc_loss(log_probs, frames, labels, label_lengths,
                         sample_weights=weights, label_average=label_average,
                         impl=ctc_impl, group=group)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def _step_body(model: CnnLstmOcr, tx: Optimizer, label_average: bool,
               ctc_impl: str, grad_clip: Optional[float],
               mesh: Optional[Mesh]):
    """One train step on this rank's rows, shared by the per-step and the
    epoch-fused trainers: ``body(opt_state, images, widths, labels,
    label_lengths, weights, lr, generator) -> (loss, gnorm)``, device
    tensors, with the model and ``opt_state`` updated in place. ``lr`` is
    a float or a 0-dim f32 tensor (a graph's, filled between replays)."""
    group = mesh.group if mesh is not None else None
    model_group = mesh.model_group if mesh is not None else None
    sharded = ({k for k, _ in model.named_parameters()
                if sharded_dim(k, mesh) is not None}
               if model_group is not None else set())

    def body(opt_state, images, widths, labels, label_lengths, weights, lr,
             generator):
        loss, grads = loss_and_grads(
            model, images, widths, labels, label_lengths, weights,
            label_average=label_average, ctc_impl=ctc_impl,
            generator=generator, group=group)
        grads = all_reduce_grads(grads, group)
        if model_group is not None:  # replicated: model index 0's, bit-equal
            grads.update(broadcast_model(
                {k: g for k, g in grads.items() if k not in sharded}, mesh))
        loss = all_reduce_sum(loss, group)
        gnorm = global_norm(grads, model_group, sharded)
        if grad_clip is not None:
            grads = _clip_by_known_norm(grads, gnorm, grad_clip)
        updates = tx.update(grads, opt_state)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.sub_((lr * updates[name]).to(p.dtype))
        return loss, gnorm.detach()

    return body


def make_train_step(model: CnnLstmOcr, tx: Optimizer, label_average: bool,
                    ctc_impl: str = "auto", grad_clip: Optional[float] = None,
                    seed: int = 0, mesh: Optional[Mesh] = None):
    """``train_step(state, images, widths, labels, label_lengths, weights,
    lr) -> {"loss", "gnorm"}`` (device tensors; nothing synchronises):
    ``loss_and_grads``, the clip, the optimizer update and
    ``p -= lr * update``. ``state`` is updated in place. Under a ``mesh``
    with several ranks the batch is this rank's rows; the gradients and
    the loss are summed over the data axis before the norm, so every rank
    reports the global loss and applies the same update (to its shards
    under tensor parallelism: ``model`` is then ``shard_model``'s)."""
    cfg = model.config
    needs_rng = cfg.dropout > 0 or cfg.augment > 0
    data_index = mesh.data_index if mesh is not None else 0
    body = _step_body(model, tx, label_average, ctc_impl, grad_clip, mesh)

    def train_step(state: TrainState, images, widths, labels, label_lengths,
                   weights, lr: float):
        gen = (step_generator(seed, state.step, images.device, data_index)
               if needs_rng else None)
        loss, gnorm = body(state.opt_state, images, widths, labels,
                           label_lengths, weights, lr, gen)
        state.step += 1
        return {"loss": loss, "gnorm": gnorm}

    return train_step


# The epoch-fused trainer's CUDA graphs: a capture for each step shape, a
# replay for each step. FUSED_EAGER_STEPS counts the fused steps that ran
# eagerly (on the CPU, or under a gloo group); CAPTURE_SECONDS is the host
# time of the warm-ups and captures.
GRAPH_CAPTURES = 0
GRAPH_REPLAYS = 0
FUSED_EAGER_STEPS = 0
CAPTURE_SECONDS = 0.0


def _cuda_backend(group) -> str:
    """The backend of ``group``'s CUDA collectives (``nccl``, ``gloo``)."""
    config = dist.get_backend_config(group)  # e.g. "cpu:gloo,cuda:nccl"
    return dict(part.split(":") for part in config.split(",")).get("cuda", "")


def steps_as_graphs(device, mesh: Optional[Mesh]) -> bool:
    """Whether the fused trainer captures its steps: on a CUDA device with
    no group or with NCCL groups. gloo runs its collectives on the host,
    which a graph cannot hold, so a segment's steps then run eagerly."""
    groups = ([] if mesh is None else
              [g for g in (mesh.group, mesh.model_group) if g is not None])
    return (torch.device(device).type == "cuda"
            and all(_cuda_backend(g) == "nccl" for g in groups))


@dataclasses.dataclass
class _StepGraph:
    graph: "torch.cuda.CUDAGraph"
    idx: torch.Tensor  # [rows] int32, static input
    weights: torch.Tensor  # [rows] f32, static input
    loss: torch.Tensor  # static outputs, valid until the next replay of
    gnorm: torch.Tensor  # any graph of the trainer (one memory pool)


def make_train_epoch(model: CnnLstmOcr, tx: Optimizer, label_average: bool,
                     ctc_impl: str = "auto",
                     grad_clip: Optional[float] = None, seed: int = 0,
                     mesh: Optional[Mesh] = None):
    """The epoch-fused trainer (``train.py:303-377``): ``train_epoch(state,
    arrays, idx, weights, lr) -> {"loss": the mean of the steps' losses,
    "last_loss", "gnorm": the last step's}`` (device tensors). ``arrays``
    are one bucket's resident (images, widths, labels, label lengths);
    row k of ``idx`` / ``weights`` ([nb, B] on the device) is step k's
    global batch, of which each step gathers this rank's rows on the
    device and runs ``make_train_step``'s body on them. Nothing in a
    segment synchronises with the host or copies a batch from it.

    On the card (with no group or NCCL groups: ``steps_as_graphs``) each
    step is one replay of a CUDA graph, captured the first time its shape
    and arrays are met, after a warm-up step on a side stream whose
    writes to the model and optimizer state are undone. Between replays
    the host copies the row's indices and weights into the graph's static
    inputs and reseeds one generator, registered with every graph, with
    the step's ``step_seed``: replay s draws the masks of
    ``step_generator(seed, s, data_index)``, as the per-step path does.
    The graphs share one memory pool (a replay's temporaries are dead
    when it ends, and its two outputs are copied out at once), and
    ``lr`` is a device scalar filled once a call. A capture or replay
    that fails raises. Elsewhere the steps run eagerly, each the per-step
    path's ``train_step``."""
    cfg = model.config
    needs_rng = cfg.dropout > 0 or cfg.augment > 0
    data_index = mesh.data_index if mesh is not None else 0
    shard = (data_index, mesh.data) if mesh is not None else (0, 1)
    device = next(model.parameters()).device
    body = _step_body(model, tx, label_average, ctc_impl, grad_clip, mesh)
    graphs: Dict[tuple, _StepGraph] = {}
    shared = {}  # the pool, the generator and lr, made at the first capture

    def capture(state: TrainState, arrays, idx_row, w_row) -> _StepGraph:
        global GRAPH_CAPTURES, CAPTURE_SECONDS
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        if not shared:
            shared["pool"] = torch.cuda.graph_pool_handle()
            shared["gen"] = torch.Generator(device=device)
            shared["lr"] = torch.zeros((), dtype=torch.float32, device=device)
        gen = shared["gen"] if needs_rng else None
        sidx, sw = idx_row.clone(), w_row.clone()

        def step(generator):
            return body(state.opt_state,
                        *(a.index_select(0, sidx) for a in arrays), sw,
                        shared["lr"], generator)

        # Warm-up (library handles, workspaces, communicators) on a side
        # stream, then every tensor the step wrote is put back.
        written = ([p.data for p in model.parameters()] + list(
            model.buffers()) + list(state.opt_state.values()))
        saved = [t.clone() for t in written]
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device=device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            step(step_generator(seed, state.step, device, data_index)
                 if needs_rng else None)
            for t, s in zip(written, saved):
                t.copy_(s)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if needs_rng:
            graph.register_generator_state(gen)
        # thread_local: another thread's host copies (the validation
        # pipeline's) must not invalidate the capture
        with torch.cuda.graph(graph, pool=shared["pool"],
                              capture_error_mode="thread_local"):
            loss, gnorm = step(gen)
        torch.cuda.synchronize(device)
        del saved
        CAPTURE_SECONDS += time.perf_counter() - t0
        GRAPH_CAPTURES += 1
        return _StepGraph(graph, sidx, sw, loss, gnorm)

    def train_epoch(state: TrainState, arrays, idx: torch.Tensor,
                    weights: torch.Tensor, lr: float) -> dict:
        global GRAPH_REPLAYS, FUSED_EAGER_STEPS
        nb, bsz = idx.shape
        rows = shard_rows(bsz, *shard)
        losses = torch.empty(nb, dtype=torch.float32, device=device)
        gnorms = torch.empty(nb, dtype=torch.float32, device=device)
        g = None
        if train_epoch.graphs:
            key = (tuple((a.data_ptr(), tuple(a.shape), a.dtype)
                         for a in arrays), bsz, rows.start, rows.stop)
            g = graphs.get(key)
            if g is None:
                g = graphs[key] = capture(state, arrays, idx[0, rows],
                                          weights[0, rows])
            shared["lr"].fill_(lr)
        for k in range(nb):
            if g is not None:
                g.idx.copy_(idx[k, rows])
                g.weights.copy_(weights[k, rows])
                if needs_rng:
                    shared["gen"].manual_seed(
                        step_seed(seed, state.step, data_index))
                g.graph.replay()
                GRAPH_REPLAYS += 1
                loss, gnorm = g.loss, g.gnorm
            else:
                gen = (step_generator(seed, state.step, device, data_index)
                       if needs_rng else None)
                loss, gnorm = body(
                    state.opt_state,
                    *(a.index_select(0, idx[k, rows]) for a in arrays),
                    weights[k, rows], lr, gen)
                FUSED_EAGER_STEPS += 1
            losses[k] = loss
            gnorms[k] = gnorm
            state.step += 1
        return {"loss": losses.mean(), "last_loss": losses[-1],
                "gnorm": gnorms[-1]}

    train_epoch.graphs = steps_as_graphs(device, mesh)
    return train_epoch


def make_eval_step(model: CnnLstmOcr):
    def eval_step(images, widths):
        with torch.inference_mode():
            return model(images, widths, train=False)

    return eval_step


# --------------------------------------------------------------------------
# Validation
# --------------------------------------------------------------------------
def evaluate(eval_step, pipe: BatchPipeline, alphabet: Alphabet,
             device, mesh: Optional[Mesh] = None) -> Tuple[float, float, float]:
    """Greedy-decode the whole split; returns (CER, WER, lines/sec). Under
    a ``mesh`` with several ranks each data rank decodes its rows of every
    batch and the frames of all rows are gathered on the host
    (``train.py:413-418``), so every rank computes the same CER."""
    group = mesh.group if mesh is not None else None
    shard = (mesh.data_index, mesh.data) if mesh is not None else (0, 1)
    hyps: List[str] = []
    refs: List[str] = []
    t0 = time.time()
    n = 0
    for batch in pipe.device_epoch(0, device=device, shard=shard):
        log_probs, frame_mask = eval_step(batch.images, batch.widths)
        frames = all_gather_host(
            greedy_frames(log_probs, frame_mask).cpu().numpy(), group)
        hyps.extend(collapse_frames(frames[i], alphabet)
                    for i in range(len(batch.valid)) if batch.valid[i])
        refs.extend(pipe.dataset.transcript(int(i))
                    for i, v in zip(batch.indices, batch.valid) if v)
        n += int(batch.valid.sum())
    dt = max(time.time() - t0, 1e-9)
    c, w = cer_wer(hyps, refs)
    return c, w, n / dt


class PlateauController:
    """LR decay on dev-CER plateau (``train.py:438-459``)."""

    def __init__(self, lr: float, patience: int, decay: float, min_lr: float):
        self.lr = lr
        self.patience = patience
        self.decay = decay
        self.min_lr = min_lr
        self.best = float("inf")
        self.bad = 0

    def update(self, cer: float) -> bool:
        """Returns True if this is a new best CER."""
        if cer < self.best - 1e-6:
            self.best = cer
            self.bad = 0
            return True
        self.bad += 1
        if self.bad > self.patience:
            self.lr = max(self.min_lr, self.lr * self.decay)
            self.bad = 0
        return False


# --------------------------------------------------------------------------
# Fit
# --------------------------------------------------------------------------
def device_time_summary(events, top: int = 25) -> str:
    """Device time of a profiler window (``torch.profiler``'s events): the
    window's span, the time the device was busy (the union of its
    intervals) and its share of the span, then the ``top`` kernel names by
    total time, each with its share of the device time, its launches and
    its time per launch."""
    if not events:
        return "no events\n"
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events))
    busy, lo, hi = 0.0, None, None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if hi is None or s > hi:
            busy += 0.0 if hi is None else hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy += 0.0 if hi is None else hi - lo
    by_name: Dict[str, List[float]] = {}
    for e in dev:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    total = sum(sum(v) for v in by_name.values())
    lines = [f"window {span / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
             f"({100 * busy / max(span, 1e-9):.1f}%), device time "
             f"{total / 1e3:.1f} ms in {len(dev)} events"]
    for name, v in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:top]:
        lines.append(f"{sum(v) / 1e3:10.3f} ms {100 * sum(v) / total:5.1f}% "
                     f"{len(v):7d} x {sum(v) / len(v):9.2f} us  {name[:90]}")
    return "\n".join(lines) + "\n"


def fit(cfg: TrainConfig, *, mesh: Optional[Mesh] = None, device="cuda",
        log=print) -> dict:
    """Run training; returns a summary dict. ``mesh`` defaults to the
    ranks of the default process group (one rank when there is none) on
    ``device``."""
    if mesh is None:
        mesh = make_mesh(MeshConfig(model=cfg.mesh_model), device=device)
    dev = mesh.device
    every = mesh.world_group  # barriers and the plan fingerprints
    shard = (mesh.data_index, mesh.data)
    if every is not None and dev.type == "cuda":
        torch.cuda.set_device(dev)  # NCCL's device for this rank
    disable_tf32()
    t_setup = time.time()

    contract = cfg.contract()
    train_ds = open_dataset(cfg.data_dir, "train")
    val_ds = None
    try:
        val_ds = open_dataset(cfg.data_dir, "val")
    except KeyError:
        pass
    if cfg.auto_ladder:
        ladder = make_ladder(train_ds.widths, stride=contract.width_stride,
                             align=32, max_waste=0.03,
                             max_width=max(cfg.bucket_widths))
        contract = dataclasses.replace(contract, bucket_widths=ladder)
        log(f"auto ladder: {ladder}")

    resume_dir = os.path.join(cfg.snapshot_dir, "last")
    resuming = cfg.resume and os.path.exists(os.path.join(resume_dir,
                                                          "meta.json"))
    if resuming:
        variables, model_config, alphabet, contract, meta = load_snapshot(
            resume_dir)
        start_step = meta["step"]
        start_epoch = meta.get("extra", {}).get("epoch", 0)
        log(f"resuming from {resume_dir} at step {start_step}")
    else:
        alphabet = Alphabet.build(train_ds.transcripts())
        model_config = cfg.model_config(alphabet.num_classes)
        start_step, start_epoch = 0, 0

    model = CnnLstmOcr(model_config)
    if resuming:
        model.load_state_dict(variables_to_state_dict(variables), strict=True)
    else:
        init_parameters(model, torch.Generator().manual_seed(cfg.seed))
    # the whole model (the seed's or the snapshot's), then this rank's shard
    shard_model(model, mesh)
    model.to(dev)

    tx = make_optimizer(cfg)
    state = TrainState(model=model,
                       opt_state=tx.init(dict(model.named_parameters())),
                       step=start_step)
    if resuming and has_opt_state(resume_dir):
        tx.load_numpy(state.opt_state,
                      shard_state_dict(load_opt_state(resume_dir), mesh))
    train_step = make_train_step(model, tx, cfg.label_average, cfg.ctc_impl,
                                 grad_clip=cfg.grad_clip, seed=cfg.seed,
                                 mesh=mesh)
    eval_step = make_eval_step(model)

    train_pipe = BatchPipeline(train_ds, alphabet, contract,
                               batch_pixels=cfg.batch_pixels,
                               batch_multiple=mesh.data,
                               drop_remainder=True, shuffle=True,
                               seed=cfg.seed)
    if train_pipe.dropped:
        log(f"warning: {train_pipe.dropped} train lines fit no bucket; dropped")
    # every rank must derive the same epoch plan (same corpus, same seed),
    # or the ranks would sum gradients of different batches
    if every is not None:
        fps = all_gather_host(
            np.asarray([train_pipe.plan_fingerprint(start_epoch)], np.int64),
            every)
        if not (fps == fps[0]).all():
            raise RuntimeError(
                f"epoch-plan fingerprint differs across processes: "
                f"{fps.tolist()} — all processes must see the same dataset "
                "and seed")
    val_pipe = (
        BatchPipeline(val_ds, alphabet, contract,
                      batch_pixels=cfg.batch_pixels,
                      batch_multiple=mesh.data, drop_remainder=False,
                      shuffle=False)
        if val_ds is not None and len(val_ds) else None
    )
    # "auto" turns the cache on only on a TPU in the reference: off here
    if cfg.device_cache == "on" and cfg.device_cache_bytes:
        try:
            # every rank holds the whole split and gathers its own rows
            train_pipe = DeviceCache(train_pipe, device=dev,
                                     max_bytes=cfg.device_cache_bytes)
            if val_pipe is not None:
                val_pipe = DeviceCache(val_pipe, device=dev,
                                       max_bytes=cfg.device_cache_bytes)
            log("device cache: dataset resident on device")
        except MemoryError as e:
            log(f"device cache disabled ({e}); streaming")
    # the fused trainer needs the cache's epoch_plan; "auto" rides the cache
    use_fused = cfg.fused_epochs == "on" or (
        cfg.fused_epochs == "auto" and hasattr(train_pipe, "epoch_plan"))
    if cfg.fused_epochs == "on" and not hasattr(train_pipe, "epoch_plan"):
        raise ValueError(
            "fused_epochs='on' requires the device cache (device_cache='on' "
            "with a sufficient device_cache_bytes cap)")
    train_epoch = None
    if use_fused:
        train_epoch = make_train_epoch(model, tx, cfg.label_average,
                                       cfg.ctc_impl, grad_clip=cfg.grad_clip,
                                       seed=cfg.seed, mesh=mesh)
        log("fused epochs: training runs as per-bucket segments, "
            + ("each step one CUDA graph replay" if train_epoch.graphs else
               "each step eager (no CUDA device, or gloo collectives, "
               "which a CUDA graph cannot hold)"))
    plateau = PlateauController(cfg.lr, cfg.plateau_patience,
                                cfg.plateau_decay, cfg.min_lr)

    # Only rank 0 touches the (possibly shared) file system; every rank
    # computes the same validation and plateau, and waits after each write.
    is_primary = mesh.rank == 0
    if is_primary:
        os.makedirs(cfg.snapshot_dir or ".", exist_ok=True)
    metrics_f = (open(os.path.join(cfg.snapshot_dir, "metrics.jsonl"), "a")
                 if cfg.snapshot_dir and is_primary else None)

    def emit(rec: dict):
        if metrics_f:
            metrics_f.write(json.dumps(rec) + "\n")
            metrics_f.flush()
        barrier(every)

    def snapshot(tag: str, step: int, epoch: int, extra: dict):
        path = os.path.join(cfg.snapshot_dir, tag)
        # the whole model from the model group's shards, on every rank
        sd = gather_state_dict(model.state_dict(), mesh)
        opt = gather_state_dict(state.opt_state, mesh)
        if is_primary:
            save_snapshot(
                path, state_dict=sd,
                model_config=model_config, alphabet=alphabet,
                contract=contract, step=step,
                opt_state=Optimizer.state_numpy(opt),
                extra={"epoch": epoch,
                       "train_config": dataclasses.asdict(cfg), **extra},
            )
        barrier(every)
        return path

    log(f"training: {len(train_ds)} lines, alphabet={alphabet.num_classes}, "
        f"device={dev}, mesh=data:{mesh.data}xmodel:{mesh.model} "
        f"(rank {mesh.rank}) data_index={mesh.data_index} "
        f"model_index={mesh.model_index}, setup "
        f"{time.time() - t_setup:.1f}s")

    step = start_step
    best_cer = plateau.best
    window_lines, window_t0 = 0, time.time()
    last_val = (float("nan"), float("nan"))
    summary_lines_per_sec = 0.0
    profiler = None

    def profile_tick():
        nonlocal profiler
        if cfg.profile_stop <= 0 or not is_primary:
            return
        if cfg.profile_start <= step < cfg.profile_stop and profiler is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=acts)
            profiler.start()
        elif step >= cfg.profile_stop and profiler is not None:
            stop_profile()

    def stop_profile():
        nonlocal profiler
        profiler.stop()
        out = os.path.join(cfg.snapshot_dir, "profile")
        os.makedirs(out, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(out, "trace.json"))
        key = ("self_device_time_total" if dev.type == "cuda"
               else "self_cpu_time_total")
        with open(os.path.join(out, "ops.txt"), "w") as f:
            f.write(profiler.key_averages().table(sort_by=key, row_limit=40))
        with open(os.path.join(out, "device.txt"), "w") as f:
            f.write(device_time_summary(profiler.events()))
        profiler = None
        log(f"profile trace written to {out}")

    def check_divergence(m, epoch: int):
        # NaN'd parameters surface as a ~1e30 loss (the CTC's NEG_INF
        # clamps), so guard on magnitude as well as finiteness.
        loss_now = float(m["loss"])
        gnorm_now = float(m["gnorm"])
        if (not np.isfinite(loss_now) or abs(loss_now) > 1e20
                or not np.isfinite(gnorm_now)):
            snapshot("diverged", step, epoch, {"loss": loss_now})
            raise FloatingPointError(
                f"divergence at step {step}: loss={loss_now}, "
                f"gnorm={gnorm_now}; state saved to "
                f"{cfg.snapshot_dir}/diverged (resume from an earlier "
                f"snapshot with a lower lr)")
        return loss_now, gnorm_now

    def log_window(epoch: int, loss_now: float, gnorm_now: float,
                   **extra):
        nonlocal window_lines, window_t0, summary_lines_per_sec
        dt = max(time.time() - window_t0, 1e-9)
        lps = window_lines / dt
        summary_lines_per_sec = lps
        rec = {"step": step, "epoch": epoch, "loss": round(loss_now, 4),
               "gnorm": round(gnorm_now, 3), "lr": plateau.lr,
               "lines": window_lines, "seconds": round(dt, 6),
               "lines_per_sec": round(lps, 1), **extra}
        log(f"step {step}: {rec}")
        emit(rec)
        window_lines, window_t0 = 0, time.time()

    # where validation fell inside the current stacked plan, in the
    # snapshot's meta: a resume of a fused run replays the stack from its
    # start epoch (TrainConfig.epoch_stack)
    stack_progress = {"stack_rows_done": 0, "stack_epochs": 1}

    def run_validation(epoch: int):
        nonlocal best_cer, last_val
        c, w, v_lps = evaluate(eval_step, val_pipe, alphabet, dev, mesh)
        last_val = (c, w)
        is_best = plateau.update(c)
        rec = {"step": step, "val_cer": round(c, 5), "val_wer": round(w, 5),
               "val_lines_per_sec": round(v_lps, 1), "lr": plateau.lr,
               "best": is_best}
        log(f"val @ {step}: {rec}")
        emit(rec)
        snapshot("last", step, epoch,
                 {"val_cer": c, "val_wer": w, **stack_progress})
        if is_best:
            best_cer = c
            if is_primary:
                promote(os.path.join(cfg.snapshot_dir, "last"),
                        os.path.join(cfg.snapshot_dir, "best"))
            barrier(every)

    end_epoch = cfg.epochs if not cfg.max_steps else 10**9
    cur_epoch = start_epoch
    epoch = start_epoch
    stop = False
    while epoch < end_epoch and not stop:
        cur_epoch = epoch
        # the fused path stacks epoch_stack epochs' rows per bucket into one
        # plan; segments still end at val_interval_steps, so only the data
        # order coarsens (bucket-major over the stacked epochs)
        stride = (max(1, min(cfg.epoch_stack, end_epoch - epoch))
                  if use_fused else 1)
        stack_progress["stack_rows_done"] = 0
        stack_progress["stack_epochs"] = stride
        if use_fused:
            seg = max(1, cfg.val_interval_steps)
            for b, arrays, idx, w in train_pipe.epoch_plan(epoch,
                                                           stack=stride):
                if stop:
                    break
                for k0 in range(0, idx.shape[0], seg):
                    profile_tick()
                    idx_k, w_k = idx[k0:k0 + seg], w[k0:k0 + seg]
                    if cfg.max_steps:
                        remaining = start_step + cfg.max_steps - step
                        if remaining <= 0:
                            stop = True
                            break
                        idx_k, w_k = idx_k[:remaining], w_k[:remaining]
                    m = train_epoch(state, arrays, idx_k, w_k, plateau.lr)
                    n = idx_k.shape[0]
                    step += n
                    stack_progress["stack_rows_done"] += n
                    window_lines += n * idx_k.shape[1]
                    loss_now, gnorm_now = check_divergence(m, epoch)
                    spec = train_pipe.pipe.spec_for(b)
                    log_window(epoch, loss_now, gnorm_now, steps=n,
                               batch_shape=[idx_k.shape[1], spec.height,
                                            spec.width, spec.label_len])
                    if (val_pipe is not None
                            and step // cfg.val_interval_steps
                            > (step - n) // cfg.val_interval_steps):
                        run_validation(epoch)
                    if cfg.max_steps and step >= start_step + cfg.max_steps:
                        stop = True
                        break
        else:
            for batch in train_pipe.device_epoch(epoch, device=dev,
                                                 shard=shard):
                profile_tick()
                rows = shard_rows(len(batch.valid), *shard)
                weights = torch.from_numpy(
                    batch.valid[rows].astype(np.float32)).to(dev)
                m = train_step(state, batch.images, batch.widths,
                               batch.labels, batch.label_lengths, weights,
                               plateau.lr)
                step += 1
                window_lines += len(batch.valid)
                if step % cfg.log_interval == 0:
                    loss_now, gnorm_now = check_divergence(m, epoch)
                    log_window(epoch, loss_now, gnorm_now)
                if step % cfg.val_interval_steps == 0 and val_pipe is not None:
                    run_validation(epoch)
                if cfg.max_steps and step >= start_step + cfg.max_steps:
                    stop = True
                    break
        epoch += stride
        if not stop:
            cur_epoch = epoch
            snapshot("last", step, cur_epoch, {})

    if profiler is not None:
        stop_profile()
    # the final snapshot records the real epoch, so a resume re-enters the
    # loop where training stopped
    snapshot("last", step, cur_epoch, {"final": True})
    if metrics_f:
        metrics_f.close()
    return {
        "steps": step,
        "best_cer": best_cer if best_cer != float("inf") else None,
        "last_val_cer": last_val[0],
        "last_val_wer": last_val[1],
        "lines_per_sec": summary_lines_per_sec,
        "snapshot_dir": cfg.snapshot_dir,
    }


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------
def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", choices=sorted(PRESETS), default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda, the rank's local GPU; "
                        "raises without a card)")
    # one process a GPU: init_process_group over tcp:// before fit
    p.add_argument("--coordinator-address", default=None, metavar="HOST:PORT",
                   help="several ranks: rank 0's address (starts "
                        "torch.distributed)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="several ranks: the rank count (data x "
                        "--mesh-model)")
    p.add_argument("--process-id", type=int, default=None,
                   help="several ranks: this process's rank")
    for f in dataclasses.fields(TrainConfig):
        name = "--" + f.name.replace("_", "-")
        if f.type == "bool" or isinstance(f.default, bool):
            p.add_argument(name, action=argparse.BooleanOptionalAction,
                           default=None)
        elif f.name == "bucket_widths":
            p.add_argument(name, type=str, default=None,
                           help="comma-separated widths")
        else:
            typ = type(f.default) if f.default is not None else str
            p.add_argument(name, type=typ, default=None)
    return p


def config_from_args(args) -> TrainConfig:
    base = dict(PRESETS.get(args.preset or "", {}))
    for f in dataclasses.fields(TrainConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            if f.name == "bucket_widths" and isinstance(v, str):
                v = tuple(int(x) for x in v.split(","))
            base[f.name] = v
    return TrainConfig(**base)


def maybe_init_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, backend=None) -> bool:
    """``init_process_group`` over ``tcp://coordinator_address`` when one
    is given (``train.py:935-963``), with a timeout: gloo for host
    tensors and NCCL for CUDA ones where there is a card, gloo alone on
    the CPU. ``backend`` names another (gloo alone for two ranks that
    share one GPU, which NCCL refuses)."""
    if not coordinator_address:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("--coordinator-address needs --num-processes and "
                         "--process-id")
    if backend is None:
        backend = ("cpu:gloo,cuda:nccl" if torch.cuda.is_available()
                   else "gloo")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    return True


def main(argv=None):
    args = build_argparser().parse_args(argv)
    cfg = config_from_args(args)
    if not cfg.data_dir:
        raise SystemExit("--data-dir is required")
    if not cfg.snapshot_dir:
        raise SystemExit("--snapshot-dir is required")
    joined = maybe_init_distributed(args.coordinator_address,
                                    args.num_processes, args.process_id)
    try:
        summary = fit(cfg, device=args.device)
    finally:
        if joined:
            dist.destroy_process_group()
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
