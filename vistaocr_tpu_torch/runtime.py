"""Process-level runtime knobs for the port.

Counterpart of ``vistaocr_tpu/runtime.py``. PyTorch runs eagerly, so
there is no compile cache to point anywhere; what the port needs instead
is an explicit device (never a global default, never a silent CPU
fallback), an explicit float32 matmul/conv precision, and device->host
copies that do not block the launching thread.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``"cuda"``/``"cpu"``/``torch.device`` -> ``torch.device``. Raises
    when CUDA is asked for and no card is visible: the port never carries
    on on the CPU in its place."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class HostCopy:
    """Device tensors copied to host memory without blocking: pinned
    buffers and an event on a CUDA device (the copy overlaps the work
    queued after it), plain references on the CPU. ``get()`` waits for
    the copies and returns numpy arrays."""

    def __init__(self, tensors):
        self._event = None
        if tensors and tensors[0].is_cuda:
            self._host = []
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self._host.append(h)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = [t.detach() for t in tensors]

    def get(self):
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


def disable_tf32() -> None:
    """Turn TF32 off for both cuBLAS matmuls and cuDNN convolutions.
    PyTorch defaults cuDNN convolutions to TF32 (about three decimal
    digits) while matmuls run in full float32; the port's float32 path
    is full float32 throughout, as the JAX reference's is."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
