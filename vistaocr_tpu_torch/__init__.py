"""vistaocr_tpu_torch — the PyTorch/CUDA port of ``vistaocr_tpu``.

The JAX package stays the reference; this package mirrors its module
names and public layouts (images ``[B,H,W]`` uint8, widths ``[B]`` int32,
log-probs ``[B,T,K]``, LSTM weights ``wx [D,4H]``, ``wh [H,4H]``,
``b [4H]`` in i, f, g, o order) and runs on an NVIDIA H100. Ported so
far: the greedy serving path (``serve.OcrService``), with the LSTM
recurrence in a hand-written CUDA kernel (``csrc/lstm_fwd.cu``).

- ``text``     : uxxxx codec and alphabet (copies of the JAX package's)
- ``data``     : ``ShapeContract``/``BucketSpec``, numpy host transforms
- ``ops``      : preprocess, on-device resize, the LSTM kernel wrapper
- ``models``   : ConvStack, BLSTMStack, CnnLstmOcr
- ``decode``   : greedy CTC collapse
- ``serve``    : width-routed batched service
"""

__version__ = "0.1.0"

_LAZY = {
    "OcrService": ("vistaocr_tpu_torch.serve", "OcrService"),
    "ServiceConfig": ("vistaocr_tpu_torch.serve", "ServiceConfig"),
    "load_model": ("vistaocr_tpu_torch.checkpoint", "load_model"),
    "save_snapshot": ("vistaocr_tpu_torch.checkpoint", "save_snapshot"),
    "Alphabet": ("vistaocr_tpu_torch.text", "Alphabet"),
    "ModelConfig": ("vistaocr_tpu_torch.models", "ModelConfig"),
    "CnnLstmOcr": ("vistaocr_tpu_torch.models", "CnnLstmOcr"),
}


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        ) from None
    import importlib

    return getattr(importlib.import_module(mod_name), attr)


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
