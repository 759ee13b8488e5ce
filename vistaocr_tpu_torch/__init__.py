"""vistaocr_tpu_torch — the PyTorch/CUDA port of ``vistaocr_tpu``.

The JAX package stays the reference; this package mirrors its module
names and public layouts (images ``[B,H,W]`` uint8, widths ``[B]`` int32,
log-probs ``[B,T,K]``, LSTM weights ``wx [D,4H]``, ``wh [H,4H]``,
``b [4H]`` in i, f, g, o order) and runs on an NVIDIA H100. Ported so
far: the greedy and host-beam serving path (``serve.OcrService``), the
training path (``train.fit``) and offline inference (``infer``), with
the LSTM recurrence, its BPTT and the CTC alpha/beta recursions in
hand-written CUDA kernels (``csrc/*.cu``).

- ``text``     : uxxxx codec, alphabet, CER/WER (copies of the JAX
  package's)
- ``data``     : ``ShapeContract``/``BucketSpec``/``make_ladder``, the
  shard store, ``BatchPipeline``, numpy host transforms (PIL's
  grayscale and BILINEAR resize, byte-equal, without PIL)
- ``ops``      : preprocess/augment, on-device resize, the LSTM and CTC
  kernel wrappers, the plain CTC
- ``models``   : ConvStack, BLSTMStack, CnnLstmOcr (eval and train mode)
- ``decode``   : greedy CTC collapse; the host prefix beam search with a
  char LM, a lexicon and a word LM (the C++ engine or the Python
  expansion); offline decoding of posterior dumps
- ``parallel`` : the mesh's data axis (ranks of a process group in
  training, local devices in the service)
- ``serve``    : width-routed batched service (``mesh_data`` shards)
- ``infer``    : ``run_inference`` and the evaluation CLI
- ``train``    : ``TrainConfig``, ``fit`` (one device, or one process a
  GPU) and the trainer's CLI
- ``experiments``: the fused stem and the direction-stacked BLSTM with
  their own kernels, measured against the production path (the model
  does not import them)
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
