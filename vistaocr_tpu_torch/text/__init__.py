"""Transcript codec and alphabet for the port.

These modules are plain-Python copies of ``vistaocr_tpu/text/{uxxxx,
alphabet,bidi,error_rates}.py``, kept here so that the port (and ``chip_smoke.py``)
import nothing of the JAX package. ``tests/test_torch_port_imports.py``
holds them equal to the originals: same tokens, same alphabet JSON, same
display order, same CER/WER.
"""

from .uxxxx import utf8_to_uxxxx, uxxxx_to_utf8
from .alphabet import Alphabet
from .error_rates import cer, cer_wer, levenshtein, wer

__all__ = ["utf8_to_uxxxx", "uxxxx_to_utf8", "Alphabet", "cer", "cer_wer",
           "levenshtein", "wer"]
