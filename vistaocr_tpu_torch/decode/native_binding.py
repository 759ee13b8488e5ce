"""ctypes binding for the native prefix-beam/ARPA/assembler library.

Counterpart of ``vistaocr_tpu/decode/native_binding.py``. The C++ engine
``decode/native/beam.cpp`` is a byte-identical copy of the JAX package's
(it depends on no framework; a test holds the two equal). It is built
with g++ on first use into ``vistaocr_tpu_torch/_build/`` by
``native_build`` (a name keyed by a hash of the source and the flags, a
per-process, per-thread temporary file renamed onto it, each failure
reported with its own cause); callers check ``available()`` and take the
Python implementations otherwise, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import native_build

_SRC = os.path.join(native_build.PKG_DIR, "decode", "native", "beam.cpp")
BUILD_DIR = native_build.BUILD_DIR
_FLAGS = native_build.FLAGS

_lock = threading.Lock()
_lib = None
_build_error: Optional[str] = None


def library_path() -> str:
    """Where the library built from this source and these flags lives."""
    return native_build.library_path(_SRC, BUILD_DIR, "_native", _FLAGS)


def _build(so: str) -> Optional[str]:
    """Compile beam.cpp to ``so``; None, or why it failed."""
    return native_build.build(_SRC, so, _FLAGS)


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            err = _build(so)
            if err:
                _build_error = err
                return None
        lib = ctypes.CDLL(so)
        lib.vo_lm_load.restype = ctypes.c_void_p
        lib.vo_lm_load.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ]
        lib.vo_lm_free.argtypes = [ctypes.c_void_p]
        lib.vo_lm_order.restype = ctypes.c_int
        lib.vo_lm_order.argtypes = [ctypes.c_void_p]
        lib.vo_lm_logp.restype = ctypes.c_double
        lib.vo_lm_logp.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_int,
        ]
        lib.vo_beam_decode_batch.restype = ctypes.c_int
        lib.vo_beam_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_double,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
        ]
        lib.vo_beam_decode_batch_lex.restype = ctypes.c_int
        lib.vo_beam_decode_batch_lex.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_double,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
        ]
        lib.vo_assemble.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


class NativeLM:
    """Handle to a C++-side ARPA model bound to an alphabet."""

    def __init__(self, arpa_path: str, alphabet_tokens: Sequence[str]):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native lib unavailable: {_build_error}")
        toks = [t.encode() for t in alphabet_tokens]
        arr = (ctypes.c_char_p * len(toks))(*toks)
        self._lib = lib
        self._ptr = lib.vo_lm_load(arpa_path.encode(), arr, len(toks))
        if not self._ptr:
            raise RuntimeError(f"failed to load ARPA LM from {arpa_path}")

    @property
    def order(self) -> int:
        return int(self._lib.vo_lm_order(self._ptr))

    def logp(self, hist_ids: Sequence[int], token_id: int) -> float:
        """log P(token | hist). ``hist_ids`` may be a full prefix (only the
        last order-1 entries matter); -1 is the native <s> sentinel."""
        h = np.asarray(hist_ids, dtype=np.int32)
        return self._lib.vo_lm_logp(
            self._ptr,
            h.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            len(h),
            token_id,
        )

    def __del__(self):
        try:
            if getattr(self, "_ptr", None):
                self._lib.vo_lm_free(self._ptr)
        except Exception:
            pass


def beam_decode_batch_native(
    logprobs: np.ndarray,  # [B, Tmax, K] f32
    frames: np.ndarray,  # [B] int32
    topk_ids: np.ndarray,  # [B, Tmax, k] int32
    topk_vals: np.ndarray,  # [B, Tmax, k] f32
    *,
    lm: Optional[NativeLM] = None,
    lm_alpha: float = 0.0,
    lm_beta: float = 0.0,
    beam_width: int = 16,
    prune_logp: float = -12.0,
    max_out: int = 512,
    lexicon=None,  # decode.lexicon.Lexicon
    word_lm=None,  # python ArpaLM (order <= 2), densified here
    word_lm_alpha: float = 0.0,
    word_lm_beta: float = 0.0,
    lex_unk_logp: float = 0.0,  # character-bypass penalty (0 = hard)
) -> Tuple[List[List[int]], np.ndarray]:
    """-> (list of best-prefix id lists, scores [B]). With ``lexicon``
    (and optionally a bigram ``word_lm``) the C++ engine applies the
    same dense-table constraint/fusion as the device search;
    ``lex_unk_logp`` enables the shared <unk> character-bypass rule."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native lib unavailable: {_build_error}")
    lp = np.ascontiguousarray(logprobs, dtype=np.float32)
    fr = np.ascontiguousarray(frames, dtype=np.int32)
    ti = np.ascontiguousarray(topk_ids, dtype=np.int32)
    tv = np.ascontiguousarray(topk_vals, dtype=np.float32)
    B, Tmax, K = lp.shape
    k = ti.shape[2]
    out_ids = np.zeros((B, max_out), np.int32)
    out_lens = np.zeros((B,), np.int32)
    out_scores = np.zeros((B,), np.float64)
    common = (
        lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        fr.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        B, Tmax, K,
        ti.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        tv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        k,
        ctypes.c_void_p(lm._ptr if lm else None),
        lm_alpha, lm_beta, beam_width, prune_logp,
    )
    outs = (
        out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        max_out,
        out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        out_scores.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if lexicon is None:
        rc = lib.vo_beam_decode_batch(*common, *outs)
    else:
        use_unk = lex_unk_logp != 0.0
        if lex_unk_logp > 0.0:  # would be an OOV *bonus*, not a penalty
            raise ValueError(
                f"lex_unk_logp must be <= 0; got {lex_unk_logp}")
        next_tbl, boundary = lexicon.dense_tables(unk=use_unk)
        next_tbl = np.ascontiguousarray(next_tbl, np.int32)
        boundary = np.ascontiguousarray(boundary, np.uint8)
        unk_node = next_tbl.shape[0] - 1 if use_unk else -1
        wt = wi = None
        n_words = 0
        space_id = lexicon.space_id if use_unk else -1
        wunk = 0.0
        if word_lm is not None and word_lm_alpha != 0.0:
            from .lm import dense_word_logp_table, word_unk_logp

            # cache the dense word table on the LM object — batch loops
            # call per batch, and the build is Vw^2 backoff queries
            cache = getattr(word_lm, "_dense_word_cache", None)
            if cache is None or cache[0] is not lexicon:
                wt = np.ascontiguousarray(
                    dense_word_logp_table(word_lm, lexicon.words),
                    np.float32)
                word_lm._dense_word_cache = (lexicon, wt)
            else:
                wt = cache[1]
            wi = np.ascontiguousarray(
                lexicon.word_id_table(unk=use_unk), np.int32)
            n_words = len(lexicon.words)
            space_id = lexicon.space_id
            wunk = word_unk_logp(word_lm)
        rc = lib.vo_beam_decode_batch_lex(
            *common,
            next_tbl.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            boundary.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            (wt.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
             if wt is not None else None),
            (wi.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
             if wi is not None else None),
            n_words, space_id, word_lm_alpha, word_lm_beta,
            float(lex_unk_logp), float(wunk), unk_node,
            *outs,
        )
    if rc != 0:
        raise RuntimeError(f"vo_beam_decode_batch failed with rc={rc}")
    return (
        [out_ids[b, : out_lens[b]].tolist() for b in range(B)],
        out_scores,
    )


def assemble_native(
    srcs: Sequence[np.ndarray],  # n contiguous [H, w_i] uint8 arrays
    out: np.ndarray,  # [n, H, Wb] uint8, pre-filled
):
    """Copy lines into the batch buffer with the GIL released."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native lib unavailable: {_build_error}")
    n = len(srcs)
    H, Wb = out.shape[1], out.shape[2]
    ptrs = (ctypes.c_void_p * n)()
    widths = np.zeros((n,), np.int32)
    for i, s in enumerate(srcs):
        assert s.dtype == np.uint8 and s.flags.c_contiguous and s.shape[0] == H
        ptrs[i] = s.ctypes.data_as(ctypes.c_void_p)
        widths[i] = s.shape[1]
    lib.vo_assemble(
        ptrs,
        widths.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        H, Wb,
    )
