"""CER/WER metrics over uxxxx transcripts.

A plain-Python copy of ``vistaocr_tpu/text/error_rates.py:19-88`` (the
port imports nothing of the JAX package); ``tests/test_torch_port_train.py``
holds the two equal.

CER: Levenshtein edit distance over the uxxxx character-token sequence,
normalized by reference length. WER: the same over "words", where words are
maximal runs of tokens split at the space token ``u0020``.

This is the parity gate (SURVEY.md §3.5): these functions must tokenize
exactly the way the reference's src/error_rates.py does [H-behavior] so
that CER/WER numbers are comparable. Pure Python, host-side.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from .uxxxx import SPACE_TOKEN


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Classic O(len(a)*len(b)) edit distance with two-row DP."""
    if len(a) < len(b):
        a, b = b, a
    # len(a) >= len(b); DP over the shorter axis.
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, start=1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, start=1):
            cur[j] = min(
                prev[j] + 1,        # deletion
                cur[j - 1] + 1,     # insertion
                prev[j - 1] + (ca != cb),  # substitution
            )
        prev = cur
    return prev[-1]


def _char_tokens(uxxxx: str) -> List[str]:
    return [t for t in uxxxx.split() if t]


def _word_tokens(uxxxx: str) -> List[Tuple[str, ...]]:
    words: List[Tuple[str, ...]] = []
    cur: List[str] = []
    for t in _char_tokens(uxxxx):
        if t == SPACE_TOKEN:
            if cur:
                words.append(tuple(cur))
                cur = []
        else:
            cur.append(t)
    if cur:
        words.append(tuple(cur))
    return words


def cer(hyp: str, ref: str) -> float:
    """Character error rate between two uxxxx transcript strings."""
    h, r = _char_tokens(hyp), _char_tokens(ref)
    if not r:
        return 0.0 if not h else 1.0
    return levenshtein(h, r) / len(r)


def wer(hyp: str, ref: str) -> float:
    """Word error rate between two uxxxx transcript strings (split at u0020)."""
    h, r = _word_tokens(hyp), _word_tokens(ref)
    if not r:
        return 0.0 if not h else 1.0
    return levenshtein(h, r) / len(r)


def cer_wer(hyps: Sequence[str], refs: Sequence[str]) -> Tuple[float, float]:
    """Corpus-level CER/WER: total edits / total reference length (the
    standard aggregation — NOT the mean of per-line rates)."""
    if len(hyps) != len(refs):
        raise ValueError(f"hyp/ref count mismatch: {len(hyps)} vs {len(refs)}")
    c_edits = c_len = w_edits = w_len = 0
    for h, r in zip(hyps, refs):
        hc, rc = _char_tokens(h), _char_tokens(r)
        hw, rw = _word_tokens(h), _word_tokens(r)
        c_edits += levenshtein(hc, rc)
        c_len += len(rc)
        w_edits += levenshtein(hw, rw)
        w_len += len(rw)
    return (
        c_edits / max(c_len, 1),
        w_edits / max(w_len, 1),
    )
