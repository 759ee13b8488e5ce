"""Self-describing snapshots, readable from either package.

Counterpart of ``vistaocr_tpu/checkpoint.py:83-119``. A snapshot is a
directory with ``meta.json`` (ModelConfig, Alphabet, ShapeContract,
step; the JAX schema) and the weights, either

- ``weights.msgpack``: the JAX package's flax serialisation of
  ``{params, batch_stats}`` (arrays as msgpack ext type 1 =
  ``(shape, dtype_name, bytes)``), decoded here without flax; or
- ``weights.npz``: the port's own format, written by ``save_snapshot``:
  the same variables as flattened flax paths (``params/cnn/conv0_1/
  kernel``) in the JAX layouts, readable with numpy alone.

``variables_to_state_dict`` maps the flax tree onto the port's
parameters (conv HWIO -> OIHW, Dense ``[in,out]`` -> Linear
``[out,in]``, BatchNorm scale/bias/mean/var -> BatchNorm2d, LSTM weights
kept in the JAX layout); ``state_dict_to_variables`` is its inverse.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .data.buckets import ShapeContract
from .models import CnnLstmOcr, ModelConfig
from .runtime import resolve_device
from .text import Alphabet

_MSGPACK = "weights.msgpack"
_NPZ = "weights.npz"
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
    for key in flatten(tree):
        if "__msgpack_chunked_array__" in key:
            raise ValueError(f"chunked arrays are not supported ({path})")
    return tree


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
    extra: Optional[dict] = None,
) -> str:
    """Write ``weights.npz`` (flattened flax paths, JAX layouts) and then
    ``meta.json``; a snapshot is valid iff ``meta.json`` exists."""
    os.makedirs(path, exist_ok=True)
    flat = flatten(state_dict_to_variables(state_dict))
    _atomic_write(os.path.join(path, _NPZ), lambda f: np.savez(f, **flat))
    meta = {
        "version": 1,
        "step": int(step),
        "model_config": json.loads(model_config.to_json()),
        "alphabet": json.loads(alphabet.to_json()),
        "contract": json.loads(contract.to_json()),
    }
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
    ``weights.npz`` when present, else the JAX ``weights.msgpack``."""
    meta = load_meta(path)
    model_config = ModelConfig.from_json(json.dumps(meta["model_config"]))
    alphabet = Alphabet.from_json(json.dumps(meta["alphabet"]))
    contract = ShapeContract.from_json(json.dumps(meta["contract"]))
    npz = os.path.join(path, _NPZ)
    if os.path.exists(npz):
        with np.load(npz) as z:
            variables = unflatten({k: z[k] for k in z.files})
    else:
        variables = read_flax_msgpack(os.path.join(path, _MSGPACK))
    return variables, model_config, alphabet, contract, meta


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
