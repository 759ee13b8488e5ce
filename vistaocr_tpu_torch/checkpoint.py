"""Self-describing snapshots, readable from either package.

Counterpart of ``vistaocr_tpu/checkpoint.py:83-119``. A snapshot is a
directory with ``meta.json`` (ModelConfig, Alphabet, ShapeContract,
step; the JAX schema) and the weights as

- ``weights.msgpack``: the JAX package's flax serialisation of
  ``{params, batch_stats}`` (arrays as msgpack ext type 1 =
  ``(shape, dtype_name, bytes)``), read and written here without flax
  (``read_flax_msgpack`` / ``flax_msgpack_bytes``), so the JAX package's
  ``load_model``, service and ``train --resume`` open a port snapshot; and
- ``weights.npz``: the same variables as flattened flax paths
  (``params/cnn/conv0_1/kernel``) in the JAX layouts, readable with numpy
  alone.

``save_snapshot`` writes both; ``load_snapshot`` reads ``weights.msgpack``
(the file every writer of either package replaces) and takes
``weights.npz`` only where it is alone.

``variables_to_state_dict`` maps the flax tree onto the port's
parameters (conv HWIO -> OIHW, Dense ``[in,out]`` -> Linear
``[out,in]``, BatchNorm scale/bias/mean/var -> BatchNorm2d, LSTM weights
kept in the JAX layout); ``state_dict_to_variables`` is its inverse, so a
snapshot the port trained loads into the JAX model.

A trainer's snapshot also carries its optimizer state in both packages'
forms: ``opt_state.npz`` (the port's state as named numpy arrays), named
in ``meta.json`` (``"opt_state"``), and ``opt_state.msgpack``, flax's
serialisation of the JAX trainer's ``optax.chain(identity,
scale_by_adam | trace)`` state (``opt_state_to_flax``), which the JAX
``train --resume`` reads. ``load_opt_state`` reads the npz where the last
``meta.json`` names it, else the JAX package's ``opt_state.msgpack``
(``opt_state_from_flax``: ``count``, ``mu``/``nu`` or ``trace`` mapped
onto the port's parameter names and layouts), so a JAX save over a port
run (whose ``meta.json`` names no npz) resumes with JAX's moments, and a
port save retires a JAX file by overwriting it (or removing it when it
writes no optimizer state). ``meta.json`` records ``step`` and ``extra``
(epoch, train config, val CER); ``promote`` copies ``last/`` over
``best/`` (``checkpoint.py:122`` of the JAX package).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .data.buckets import ShapeContract
from .models import CnnLstmOcr, ModelConfig
from .runtime import resolve_device
from .text import Alphabet

_MSGPACK = "weights.msgpack"
_NPZ = "weights.npz"
_OPT = "opt_state.npz"
_JAX_OPT = "opt_state.msgpack"
_META = "meta.json"


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _hwio_to_oihw(k: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(k.transpose(3, 2, 0, 1))


def _oihw_to_hwio(k: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(k.transpose(2, 3, 1, 0))


_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}


def variables_to_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``{params, batch_stats}`` (numpy leaves) -> ``CnnLstmOcr``
    state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for path, arr in flatten(variables).items():
        arr = np.asarray(arr, np.float32)
        coll, *rest = path.split("/")
        if coll == "params" and rest == ["stem_kernel"]:
            name, arr = "stem_kernel", _hwio_to_oihw(arr)
        elif coll == "params" and rest[0] == "cnn" and rest[2] == "kernel":
            name, arr = f"cnn.convs.{rest[1]}.weight", _hwio_to_oihw(arr)
        elif coll in ("params", "batch_stats") and rest[0] == "cnn":
            name = f"cnn.bns.{rest[1]}.{_BN[rest[2]]}"
        elif coll == "params" and rest[0] in ("bridge", "head"):
            if rest[1] == "kernel":
                name, arr = f"{rest[0]}.weight", np.ascontiguousarray(arr.T)
            else:
                name = f"{rest[0]}.bias"
        elif coll == "params" and rest[0] == "blstm":
            name = f"blstm.{rest[1]}"
        else:
            raise KeyError(f"unexpected variable {path!r}")
        sd[name] = torch.from_numpy(np.array(arr, np.float32))
        if name.endswith(".running_mean"):
            sd[name[: -len("running_mean")] + "num_batches_tracked"] = (
                torch.tensor(0, dtype=torch.long))
    return sd


def state_dict_to_variables(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of ``variables_to_state_dict`` (numpy float32 leaves)."""
    inv_bn = {v: k for k, v in _BN.items()}
    flat: Dict[str, np.ndarray] = {}
    for name, t in sd.items():
        if name.endswith("num_batches_tracked"):
            continue
        arr = t.detach().to("cpu", torch.float32).numpy()
        parts = name.split(".")
        if name == "stem_kernel":
            flat["params/stem_kernel"] = _oihw_to_hwio(arr)
        elif parts[:2] == ["cnn", "convs"]:
            flat[f"params/cnn/{parts[2]}/kernel"] = _oihw_to_hwio(arr)
        elif parts[:2] == ["cnn", "bns"]:
            leaf = inv_bn[parts[3]]
            coll = "batch_stats" if leaf in ("mean", "var") else "params"
            flat[f"{coll}/cnn/{parts[2]}/{leaf}"] = arr
        elif parts[0] in ("bridge", "head"):
            if parts[1] == "weight":
                flat[f"params/{parts[0]}/kernel"] = np.ascontiguousarray(arr.T)
            else:
                flat[f"params/{parts[0]}/bias"] = arr
        elif parts[0] == "blstm":
            flat[f"params/blstm/{parts[1]}"] = arr
        else:
            raise KeyError(f"unexpected parameter {name!r}")
    return unflatten(flat)


def read_flax_msgpack(path: str) -> Dict[str, Any]:
    """Decode a flax ``serialization.to_bytes`` file without flax."""
    import msgpack

    def ext_hook(code, data):
        if code != 1:
            raise ValueError(f"unsupported msgpack ext type {code} in {path}")
        shape, dtype_name, buf = msgpack.unpackb(data, raw=False)
        return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)

    def check(node):
        if isinstance(node, dict):
            if "__msgpack_chunked_array__" in node:
                raise ValueError(f"chunked arrays are not supported ({path})")
            for v in node.values():
                check(v)
        elif isinstance(node, list):
            for v in node:
                check(v)

    check(tree)
    return tree


def flax_msgpack_bytes(tree: Dict[str, Any]) -> bytes:
    """flax ``serialization.to_bytes`` (and ``msgpack_serialize``) of a
    nested dict of numpy arrays, without flax, byte for byte: msgpack maps
    with their keys in sorted order (as flax's tree copy leaves them),
    lists as msgpack arrays, arrays as ext type 1 holding
    ``packb((shape, dtype_name, bytes))``. The inverse of
    ``read_flax_msgpack``."""
    import msgpack

    def ordered(node):
        if isinstance(node, dict):
            return {str(k): ordered(node[k]) for k in sorted(node, key=str)}
        if isinstance(node, list):
            return [ordered(v) for v in node]
        return node

    def ext(x):
        if not isinstance(x, np.ndarray):
            raise TypeError(f"unsupported leaf {type(x).__name__}")
        return msgpack.ExtType(1, msgpack.packb(
            (x.shape, x.dtype.name, x.tobytes("C")), use_bin_type=True))

    return msgpack.packb(ordered(tree), default=ext, strict_types=True)


def opt_state_to_flax(opt_state: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The port's optimizer state (``count``, ``mu/<name>`` and
    ``nu/<name>``, or ``trace/<name>``) as the state tree of the JAX
    trainer's ``optax.chain(identity, scale_by_adam | trace)``: ``{"0":
    {}, "1": {"count", "mu", "nu"} | {"trace"}}``, each moment a tree of
    the flax parameter paths in the JAX layouts."""
    slots = sorted({k.split("/", 1)[0] for k in opt_state if "/" in k})
    if slots not in (["mu", "nu"], ["trace"]):
        raise ValueError(f"unrecognised optimizer state slots {slots}")
    core: Dict[str, Any] = {}
    for slot in slots:
        sd = {k.split("/", 1)[1]: torch.from_numpy(np.asarray(v))
              for k, v in opt_state.items() if k.startswith(slot + "/")}
        core[slot] = state_dict_to_variables(sd)["params"]
    if slots == ["mu", "nu"]:
        core["count"] = np.asarray(opt_state["count"], np.int32)
    return {"0": {}, "1": core}


def opt_state_from_flax(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Inverse of ``opt_state_to_flax``: the JAX trainer's optimizer state
    tree (as ``read_flax_msgpack`` gives it) as the port's named arrays.
    SGD's state has no step count; the port's (unused by SGD) is 0."""
    core = tree.get("1") if set(tree) == {"0", "1"} else None
    if not isinstance(core, dict) or set(core) not in (
            {"count", "mu", "nu"}, {"trace"}):
        raise ValueError(
            "not the JAX trainer's optax.chain(identity, scale_by_adam | "
            f"trace) state: keys {sorted(tree)}")
    out = {"count": np.asarray(core.get("count", 0), np.int32)}
    for slot in sorted(set(core) - {"count"}):
        for name, t in variables_to_state_dict({"params": core[slot]}).items():
            out[f"{slot}/{name}"] = t.numpy()
    return out


def _atomic_write(dst: str, write) -> None:
    tmp = dst + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, dst)


def save_snapshot(
    path: str,
    *,
    state_dict: Dict[str, torch.Tensor],
    model_config: ModelConfig,
    alphabet: Alphabet,
    contract: ShapeContract,
    step: int = 0,
    opt_state: Optional[Dict[str, np.ndarray]] = None,
    extra: Optional[dict] = None,
) -> str:
    """Write ``weights.msgpack`` (flax's format) and ``weights.npz``
    (flattened flax paths, JAX layouts), the optimizer state when given
    (``opt_state.npz`` and the JAX trainer's ``opt_state.msgpack``), and
    then ``meta.json``; a snapshot is valid iff ``meta.json`` exists.
    Without an optimizer state, an ``opt_state.msgpack`` left in ``path``
    is removed first: it would describe other weights."""
    os.makedirs(path, exist_ok=True)
    jax_opt = os.path.join(path, _JAX_OPT)
    if opt_state is None and os.path.exists(jax_opt):
        os.remove(jax_opt)
    variables = state_dict_to_variables(state_dict)
    payload = flax_msgpack_bytes(variables)
    _atomic_write(os.path.join(path, _MSGPACK), lambda f: f.write(payload))
    flat = flatten(variables)
    _atomic_write(os.path.join(path, _NPZ), lambda f: np.savez(f, **flat))
    if opt_state is not None:
        _atomic_write(os.path.join(path, _OPT),
                      lambda f: np.savez(f, **opt_state))
        opt_payload = flax_msgpack_bytes(opt_state_to_flax(opt_state))
        _atomic_write(jax_opt, lambda f: f.write(opt_payload))
    meta = {
        "version": 1,
        "step": int(step),
        "model_config": json.loads(model_config.to_json()),
        "alphabet": json.loads(alphabet.to_json()),
        "contract": json.loads(contract.to_json()),
    }
    if opt_state is not None:
        meta["opt_state"] = _OPT
    if extra:
        meta["extra"] = extra
    tmp = os.path.join(path, _META + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=2, ensure_ascii=False)
    os.replace(tmp, os.path.join(path, _META))
    return path


def load_meta(path: str) -> dict:
    with open(os.path.join(path, _META)) as f:
        return json.load(f)


def load_snapshot(
    path: str,
) -> Tuple[Dict[str, Any], ModelConfig, Alphabet, ShapeContract, dict]:
    """Returns (variables, model_config, alphabet, contract, meta);
    ``variables`` is the flax tree with numpy leaves. Reads
    ``weights.msgpack``, or ``weights.npz`` where there is no msgpack."""
    meta = load_meta(path)
    model_config = ModelConfig.from_json(json.dumps(meta["model_config"]))
    alphabet = Alphabet.from_json(json.dumps(meta["alphabet"]))
    contract = ShapeContract.from_json(json.dumps(meta["contract"]))
    msg = os.path.join(path, _MSGPACK)
    if os.path.exists(msg):
        variables = read_flax_msgpack(msg)
    else:
        with np.load(os.path.join(path, _NPZ)) as z:
            variables = unflatten({k: z[k] for k in z.files})
    return variables, model_config, alphabet, contract, meta


def _port_opt_is_current(path: str) -> bool:
    """The port's npz belongs to this snapshot: the last ``meta.json``
    written names it (a JAX save does not)."""
    return (os.path.exists(os.path.join(path, _OPT))
            and load_meta(path).get("opt_state") == _OPT)


def has_opt_state(path: str) -> bool:
    """Whether this snapshot carries an optimizer state of either package
    (the port's npz named by ``meta.json``, or ``opt_state.msgpack``)."""
    return (_port_opt_is_current(path)
            or os.path.exists(os.path.join(path, _JAX_OPT)))


def load_opt_state(path: str) -> Dict[str, np.ndarray]:
    """The snapshot's optimizer state as the port's named arrays: the
    port's npz where ``meta.json`` names it, else the JAX trainer's
    ``opt_state.msgpack``."""
    if _port_opt_is_current(path):
        with np.load(os.path.join(path, _OPT)) as z:
            return {k: z[k] for k in z.files}
    return opt_state_from_flax(read_flax_msgpack(os.path.join(path, _JAX_OPT)))


def promote(src: str, dst: str) -> None:
    """Copy snapshot ``src`` over ``dst`` (used for ``best/``)."""
    tmp = dst + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    shutil.copytree(src, tmp)
    if os.path.exists(dst):
        shutil.rmtree(dst)
    os.replace(tmp, dst)


def load_model(
    path: str,
    device,
    **config_overrides,
) -> Tuple[CnnLstmOcr, Alphabet, ShapeContract]:
    """Snapshot dir -> (eval-mode model on ``device``, alphabet, contract).
    ``config_overrides`` replace ModelConfig fields (e.g.
    ``compute_dtype``, ``lstm_impl``) without touching the weights."""
    dev = resolve_device(device)
    variables, cfg, alphabet, contract, _ = load_snapshot(path)
    if config_overrides:
        cfg = dataclasses.replace(cfg, **config_overrides)
    model = CnnLstmOcr(cfg)
    model.load_state_dict(variables_to_state_dict(variables), strict=True)
    return model.to(dev).eval(), alphabet, contract
