"""Transcript codec and alphabet for the port.

These modules are plain-Python copies of ``vistaocr_tpu/text/{uxxxx,
alphabet,bidi}.py``, kept here so that the port (and ``chip_smoke.py``)
import nothing of the JAX package. ``tests/test_torch_port_imports.py``
holds them equal to the originals: same tokens, same alphabet JSON, same
display order.
"""

from .uxxxx import utf8_to_uxxxx, uxxxx_to_utf8
from .alphabet import Alphabet

__all__ = ["utf8_to_uxxxx", "uxxxx_to_utf8", "Alphabet"]
