"""Post-training int8 quantization of the conv feature extractor.

Counterpart of ``vistaocr_tpu/models/quant.py``, function for function:
BatchNorm (inference statistics) folded into per-output-channel symmetric
int8 weights, per-conv input scales frozen from a few calibration
batches, an int8 x int8 -> int32 conv with a dequantize + bias + ReLU
epilogue that also pools and quantizes for the next conv
(``ops/int8_conv.py``: the hand-written kernels on the card, their plain
versions on the CPU), and the bridge, BLSTM and head kept in the
model's compute type with f32 logits. ``float_prefix`` runs the first N
convs with the folded float kernels.

Layouts: conv kernels are OIHW here and HWIO in the JAX package, so the
per-channel maximum is over axes (1, 2, 3) and the BN factor broadcasts
on axis 0; ``qstack.msgpack`` holds the JAX layout (``save_qstack`` /
``load_qstack``), byte-equal to the JAX writer's for the same arrays, so
each package loads the other's file. The quantized stack runs NHWC; its
pools and the float prefix's convs read it through channels-last views.

A qstack is a dict of tuples of numpy arrays (``kernels`` int8 OIHW,
``fkernels`` f32 OIHW, ``wscales`` and ``biases`` f32 [co], ``in_scales``
float32 scalars), as the file holds it. ``QuantizedStack`` puts one on a
device once (packed weights, the epilogue's f32 ``s_in * wscale``, the
f32 ``1 / s_in``, the float kernels in the compute type), so a forward
reads no host value, casts nothing and does not synchronise, and a CUDA
graph can hold it.

Usage: python -m vistaocr_tpu_torch.models.quant --snapshot <dir>/best \\
           --data <dataset> [--split train] [--calib-batches 4] [--device cuda]
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.int8_conv import fusable_window, int8_conv_fused, pack_weights
from ..ops.int8_conv import pool_ref as _nhwc_pool
from ..ops.preprocess import preprocess_images
from ..runtime import resolve_device
from .cnnlstm import CnnLstmOcr, ModelConfig

_BN_EPS = 1e-5  # flax.linen.BatchNorm's default, as ConvStack uses
QSTACK_FILE = "qstack.msgpack"


def _host(a, dtype=np.float32) -> torch.Tensor:
    """A writable CPU tensor copy of a numpy array or a tensor."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return torch.from_numpy(np.array(a, dtype))


def _conv_names(config: ModelConfig):
    """(si, ci) pairs in application order."""
    for si, st in enumerate(config.stages):
        for ci in range(st.num_convs):
            yield si, ci


def fold_conv_params(
    model: CnnLstmOcr,
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Fold inference-mode BatchNorm into the conv weights, on the CPU:
    ``conv(x, w * a) + b`` with ``a = gamma * rsqrt(var + eps)`` per output
    channel and ``b = beta - mean * a``. Returns (kernels f32 OIHW [co, ci,
    3, 3], biases f32 [co]) in application order; conv0_0 is the model's
    ``stem_kernel``. Under ``conv_norm="none"`` the kernels as they are and
    zero biases."""
    cfg = model.config
    kernels, biases = [], []

    def cpu(t):
        return t.detach().to("cpu", torch.float32)

    for si, ci in _conv_names(cfg):
        if si == 0 and ci == 0:
            w = cpu(model.stem_kernel)
        else:
            w = cpu(model.cnn.convs[f"conv{si}_{ci}"].weight)
        if cfg.conv_norm == "batch":
            bn = model.cnn.bns[f"bn{si}_{ci}"]
            a = cpu(bn.weight) * torch.rsqrt(cpu(bn.running_var) + _BN_EPS)
            b = cpu(bn.bias) - cpu(bn.running_mean) * a
            kernels.append(w * a[:, None, None, None])
            biases.append(b)
        else:
            kernels.append(w)
            biases.append(torch.zeros((w.shape[0],), dtype=torch.float32))
    return tuple(kernels), tuple(biases)


def _float_conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """relu(round_to_dtype(conv(x, kernel) + bias)) on NHWC ``x``, the conv
    in the compute type (JAX: ``preferred_element_type=dtype``); ``kernel``
    in ``dtype`` and ``bias`` f32, both on ``x``'s device."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel, padding=1).permute(0, 2, 3, 1)
    y = (y.to(torch.float32) + bias).to(dtype)
    return F.relu(y).contiguous()


def folded_conv_features(kernels, biases, images, widths,
                         config: ModelConfig, *, collect_maxes: bool = False):
    """The float path over the FOLDED parameters, NHWC [B, H', T, C]: the
    model's eval-mode conv features, reassociated. With ``collect_maxes``
    also the max |input| of each conv (f32, [n_convs]): the calibration
    forward."""
    dtype = config.dtype
    x = preprocess_images(images, widths, standardize=config.standardize_input,
                          dtype=dtype)
    kernels = [k.to(x.device, dtype) for k in kernels]  # no copy if so
    biases = [b.to(x.device) for b in biases]
    maxes = []
    i = 0
    for st in config.stages:
        for _ in range(st.num_convs):
            if collect_maxes:
                maxes.append(x.to(torch.float32).abs().amax())
            x = _float_conv(x, kernels[i], biases[i], dtype)
            i += 1
        x = _nhwc_pool(x, st.pool, config.conv_pool)
    if collect_maxes:
        return x, torch.stack(maxes)
    return x


def calibrate_in_scales(kernels, biases, config: ModelConfig,
                        batches: Iterable, *, device="cuda") -> np.ndarray:
    """Freeze per-conv-input scales from calibration data: scale_i = max
    over batches of max|input_i| / 127. ``batches`` yields (images [B,H,W]
    uint8, widths [B] int32), numpy or tensors; each runs on ``device``
    (the card unless the CPU is asked for; raises without a card)."""
    dev = resolve_device(device)
    ks = [_host(k).to(dev, config.dtype) for k in kernels]
    bs = [_host(b).to(dev) for b in biases]
    m = None
    n = 0
    with torch.inference_mode():
        for images, widths in batches:
            _, mm = folded_conv_features(
                ks, bs, torch.as_tensor(images).to(dev),
                torch.as_tensor(widths).to(dev), config, collect_maxes=True)
            mm = mm.cpu().numpy()
            m = mm if m is None else np.maximum(m, mm)
            n += 1
    if n == 0:
        raise ValueError("calibration needs at least one batch")
    return (np.maximum(m, np.float32(1e-6)) / np.float32(127.0)).astype(
        np.float32)


def quantize_conv_stack(kernels, biases, in_scales) -> dict:
    """Per-output-channel symmetric int8 weights + frozen input scales, as
    numpy: kernels int8 OIHW, wscales f32 [co], biases f32 [co], in_scales
    float32 scalars; the folded float kernels ride along (``fkernels``)
    for a float prefix chosen at serve time."""
    qk, ws, fk = [], [], []
    for k in kernels:
        k = _host(k)
        s = k.abs().amax(dim=(1, 2, 3)) / 127.0 + 1e-12
        qk.append(torch.round(k / s[:, None, None, None]).clamp(
            -127, 127).to(torch.int8).numpy())
        ws.append(s.numpy())
        fk.append(k.numpy())
    return {
        "kernels": tuple(qk),
        "fkernels": tuple(fk),
        "wscales": tuple(ws),
        "biases": tuple(_host(b).numpy() for b in biases),
        "in_scales": tuple(
            np.float32(s) for s in np.asarray(in_scales).reshape(-1)),
    }


@dataclasses.dataclass
class _Int8Conv:
    weight: torch.Tensor  # packed int8 [co, KP]
    scale: torch.Tensor  # f32 [co]: s_in * wscale
    bias: torch.Tensor  # f32 [co]
    inv_s: float  # the f32 value of 1 / s_in


class QuantizedStack:
    """A qstack on ``device``, packed once for the forward, its float
    kernels (if the qstack has them) in the compute type ``dtype``."""

    def __init__(self, qstack: dict, device, dtype: torch.dtype):
        self.device = torch.device(device)
        self.convs = []
        for wq, ws, b, s in zip(qstack["kernels"], qstack["wscales"],
                                qstack["biases"], qstack["in_scales"]):
            s = np.float32(s)
            scale = s * np.asarray(ws, np.float32)  # one f32 product, as JAX
            self.convs.append(_Int8Conv(
                weight=pack_weights(_host(wq, np.int8)).to(self.device),
                scale=_host(scale).to(self.device),
                bias=_host(b).to(self.device),
                inv_s=float(np.float32(1.0) / s)))
        self.fkernels = (
            tuple(_host(k).to(self.device, dtype) for k in qstack["fkernels"])
            if "fkernels" in qstack else None)

    def check_float_prefix(self, float_prefix: int,
                           option: str = "float_prefix") -> None:
        """Raise ValueError when a float prefix is asked of a qstack
        without folded float kernels (``option`` names the setting)."""
        if float_prefix and self.fkernels is None:
            raise ValueError(
                f"{option} needs a qstack with folded float kernels "
                "(re-create qstack.msgpack; older artifacts lack 'fkernels')"
            )


def conv_plan(config: ModelConfig, float_prefix: int = 0):
    """The conv stack as steps in order: ``("float", i, window)``, ``("int8",
    i, window, next_inv)`` or ``("pool", window)``. A stage's pool rides in
    its last conv's epilogue (``window``) where the kernels take it (1 or 2
    each way), else it is a step of its own; an int8 conv that another
    int8 conv follows directly quantizes its output for it (``next_inv``:
    True), so that activation travels as int8."""
    steps = []
    i = 0
    for st in config.stages:
        fused = False
        for c in range(st.num_convs):
            last = c == st.num_convs - 1
            kind = "float" if i < float_prefix else "int8"
            fused = last and kind == "int8" and fusable_window(st.pool)
            steps.append((kind, i, tuple(st.pool) if fused else (1, 1)))
            i += 1
        if not fused and tuple(st.pool) != (1, 1):
            steps.append(("pool", tuple(st.pool)))
    return [s + (k + 1 < len(steps) and steps[k + 1][0] == "int8",)
            if s[0] == "int8" else s for k, s in enumerate(steps)]


def quantized_conv_features(qstack: QuantizedStack, images, widths,
                            config: ModelConfig, *,
                            float_prefix: int = 0) -> torch.Tensor:
    """The int8 conv feature extractor, NHWC [B, H', T, C]: each conv
    quantizes its input with its frozen scale, convolves int8 x int8 into
    int32 and dequantizes + adds the bias + ReLU in the compute type, then
    pools (one ``int8_conv_fused`` call, ``conv_plan``): an int8 conv
    that another follows writes its pooled output quantized with that
    conv's scale, which is the same int8 tensor as quantizing after the
    pool. ``float_prefix``: the first N convs run with the folded float
    kernels instead (needs ``fkernels``)."""
    qstack.check_float_prefix(float_prefix)
    dtype = config.dtype
    x = preprocess_images(images, widths, standardize=config.standardize_input,
                          dtype=dtype)
    for step in conv_plan(config, float_prefix):
        if step[0] == "pool":
            x = _nhwc_pool(x, step[1], config.conv_pool)
            continue
        c = qstack.convs[step[1]]
        if step[0] == "float":
            x = _float_conv(x, qstack.fkernels[step[1]], c.bias, dtype)
            continue
        nxt = qstack.convs[step[1] + 1].inv_s if step[3] else None
        x = int8_conv_fused(x, c.weight, c.scale, c.bias, inv_s=c.inv_s,
                            dtype=dtype, window=step[2],
                            pool_impl=config.conv_pool, inv_s_next=nxt)
    return x


def sequence_head_apply(model: CnnLstmOcr, feats: torch.Tensor,
                        widths: torch.Tensor):
    """Bridge + BLSTM + f32 head over NHWC conv features [B, H', T, C]:
    the model's forward after its conv stack (eval mode). Returns
    (log_probs, frame_mask)."""
    b, hp, t, c = feats.shape
    x = feats.permute(0, 2, 1, 3).reshape(b, t, hp * c)  # C fastest
    return model.sequence_head(x, widths)


def quantize_model(model: CnnLstmOcr, batches: Iterable) -> dict:
    """Fold + calibrate (on the model's device) + quantize in one call."""
    kernels, biases = fold_conv_params(model)
    device = next(model.parameters()).device
    in_scales = calibrate_in_scales(kernels, biases, model.config, batches,
                                    device=device)
    return quantize_conv_stack(kernels, biases, in_scales)


def _hwio(k: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(k).transpose(2, 3, 1, 0))


def _oihw(k: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1))


def save_qstack(snapshot_dir: str, qstack: dict) -> str:
    """Write ``qstack`` into a snapshot directory as ``qstack.msgpack``,
    flax's ``msgpack_serialize`` of ``{key: [arrays]}`` (keys sorted, as
    its tree copy leaves them) in the JAX layout (kernels HWIO),
    atomically."""
    from ..checkpoint import _atomic_write, flax_msgpack_bytes

    tree = {}
    for key, arrays in qstack.items():
        conv = _hwio if key in ("kernels", "fkernels") else np.asarray
        tree[key] = [conv(a) for a in arrays]
    payload = flax_msgpack_bytes(tree)
    dst = os.path.join(snapshot_dir, QSTACK_FILE)
    _atomic_write(dst, lambda f: f.write(payload))
    return dst


def load_qstack(snapshot_dir: str) -> Optional[dict]:
    """The snapshot's stored qstack (port layout), or None if it has no
    int8 artifact."""
    from ..checkpoint import read_flax_msgpack

    path = os.path.join(snapshot_dir, QSTACK_FILE)
    if not os.path.exists(path):
        return None
    raw = read_flax_msgpack(path)

    def tup(v):
        if isinstance(v, dict):  # {'0': ..., '1': ...} from a tuple
            return tuple(v[k] for k in sorted(v, key=int))
        return tuple(v)

    out = {
        "kernels": tuple(_oihw(k) for k in tup(raw["kernels"])),
        "wscales": tup(raw["wscales"]),
        "biases": tup(raw["biases"]),
        "in_scales": tuple(np.float32(np.asarray(s))
                           for s in tup(raw["in_scales"])),
    }
    if "fkernels" in raw:  # absent in older artifacts
        out["fkernels"] = tuple(_oihw(k) for k in tup(raw["fkernels"]))
    return out


def calibration_batches(data_dir: str, snapshot: str, *,
                        calib_batches: int = 4, batch_pixels: int = 2**19,
                        split: str = "train"):
    """Calibration (images, widths) numpy batches from a dataset split:
    the train split by default (quantized CER on an eval split stays
    leakage-free), else the test split."""
    from ..checkpoint import load_snapshot
    from ..data.pipeline import BatchPipeline
    from ..data.shards import open_dataset

    _, _, alphabet, contract, _ = load_snapshot(snapshot)
    try:
        ds = open_dataset(data_dir, split)
    except (FileNotFoundError, KeyError):
        ds = open_dataset(data_dir, "test")
    pipe = BatchPipeline(ds, alphabet, contract, batch_pixels=batch_pixels,
                         drop_remainder=False, shuffle=False)
    out = []
    for b in pipe.epoch(0):
        out.append((b.images, b.widths))
        if len(out) >= max(calib_batches, 1):
            break
    return out


def quantize_snapshot(snapshot: str, data_dir: str, *, split: str = "train",
                      calib_batches: int = 4, batch_pixels: int = 2**19,
                      device="cuda") -> str:
    """Fold + calibrate + quantize a snapshot's conv stack and store the
    result in the snapshot directory (``qstack.msgpack``)."""
    from ..checkpoint import load_model

    model, _, _ = load_model(snapshot, device)
    batches = calibration_batches(
        data_dir, snapshot, calib_batches=calib_batches,
        batch_pixels=batch_pixels, split=split)
    return save_qstack(snapshot, quantize_model(model, batches))


def quantized_forward(model: CnnLstmOcr, qstack: QuantizedStack, images,
                      widths, *, float_prefix: int = 0):
    """(log_probs, frame_mask) of the int8 conv stack + the model's float
    bridge, BLSTM and head."""
    feats = quantized_conv_features(qstack, images, widths, model.config,
                                    float_prefix=float_prefix)
    return sequence_head_apply(model, feats, widths)


def make_quantized_eval_step(model: CnnLstmOcr, qstack: dict, *,
                             float_prefix: int = 0):
    """Drop-in for ``train.make_eval_step``: ``(images, widths) ->
    (log_probs, frame_mask)`` over the qstack packed on the model's
    device."""
    qs = QuantizedStack(qstack, next(model.parameters()).device,
                        model.config.dtype)

    def eval_step(images, widths):
        with torch.inference_mode():
            return quantized_forward(model, qs, images, widths,
                                     float_prefix=float_prefix)

    return eval_step


def main(argv=None):
    """Calibrate + quantize a snapshot's conv stack and store the int8
    artifact inside the snapshot directory."""
    import argparse

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--snapshot", required=True)
    p.add_argument("--data", required=True)
    p.add_argument("--split", default="train",
                   help="calibration split (train by default: keeps "
                        "quantized eval CER leakage-free)")
    p.add_argument("--calib-batches", type=int, default=4)
    p.add_argument("--batch-pixels", type=int, default=2**19)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    args = p.parse_args(argv)
    from ..runtime import disable_tf32

    disable_tf32()
    out = quantize_snapshot(
        args.snapshot, args.data, split=args.split,
        calib_batches=args.calib_batches, batch_pixels=args.batch_pixels,
        device=args.device)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
