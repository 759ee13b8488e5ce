"""Display-order <-> logical-order conversion for RTL text lines.

Component C4's "RTL-aware transcript ordering matching reference
conventions" (SURVEY.md §2, hard-part #5). CTC alignment is MONOTONIC
along the width scan: training labels must be in SCAN order
(left-to-right = display order). Arabic/Farsi transcripts are stored and
exchanged in LOGICAL order (first-read char first), but a shaped
renderer (raqm) lays an RTL line out right-to-left, so logical-order
labels present to the network in reverse scan order. A BLSTM can brute-
force the line-global reversal on a closed small vocabulary — which is
exactly what the round 2-3 closed-vocab ar/fa rows silently did at a
~2-5x CER tax vs English — but it collapses in the open-vocabulary hard
regime: the round-5 Arabic run pinned FLAT at 76% CER (vs 5.8% for the
same-protocol English run) until prep switched to display-order labels.
Measured trajectories in docs/design.md "Round 5: RTL display order".

``display_order`` is an involution (applying it twice returns the
input), so the same function converts logical->display at prep time and
display->logical when presenting hypotheses to humans.

Scope (documented UBA subset, exact for OCR-line content): lines whose
strong direction is RTL, with embedded strong-LTR runs (digits, Latin)
that keep their internal left-to-right order, including common numeric
separators (``12.5``, ``1,000``, ``10:30``) between digits. Neutrals
(spaces, most punctuation) take the surrounding RTL direction, i.e.
they reverse with the line. Paired-bracket GLYPH mirroring (a ``(``
rendering as ``)`` in RTL context) is out of scope — keep paired
brackets out of RTL training corpora, or fold them at normalization.
"""

from __future__ import annotations

# Strong-RTL ranges: Hebrew, Arabic, Syriac, Thaana, Arabic Supplement/
# Extended-A, presentation forms.
_RTL_RANGES = (
    (0x0590, 0x05FF),
    (0x0600, 0x06FF),
    (0x0700, 0x074F),
    (0x0750, 0x077F),
    (0x0780, 0x07BF),
    (0x08A0, 0x08FF),
    (0xFB1D, 0xFDFF),
    (0xFE70, 0xFEFF),
)

# Separators UBA keeps inside a number when flanked by digits (CS class
# members that matter for OCR lines).
_NUM_SEPS = ".,:/"


def _is_rtl(ch: str) -> bool:
    cp = ord(ch)
    return any(lo <= cp <= hi for lo, hi in _RTL_RANGES)


def _is_ltr(ch: str) -> bool:
    # Strong-LTR for our corpora: ASCII letters and digits (plus Latin-1
    # letters). Everything else is treated as neutral.
    return ch.isascii() and ch.isalnum() or (ord(ch) >= 0xC0 and ch.isalpha()
                                             and not _is_rtl(ch))


def is_rtl_line(text: str) -> bool:
    """True when the line's strong direction is RTL (first strong char
    wins — the UBA paragraph-direction rule P2/P3)."""
    for ch in text:
        if _is_rtl(ch):
            return True
        if _is_ltr(ch):
            return False
    return False


def _ltr_run_spans(s: str):
    """Maximal spans of strong-LTR chars, absorbing numeric separators
    BETWEEN digits (``12.5`` is one run; ``abc.`` is not)."""
    spans = []
    i, n = 0, len(s)
    while i < n:
        if _is_ltr(s[i]):
            j = i + 1
            while j < n:
                if _is_ltr(s[j]):
                    j += 1
                elif (s[j] in _NUM_SEPS and j + 1 < n and s[j - 1].isdigit()
                      and s[j + 1].isdigit()):
                    j += 2
                else:
                    break
            spans.append((i, j))
            i = j
        else:
            i += 1
    return spans


def display_order(text: str) -> str:
    """Logical->display order for an RTL-dominant line (involution: the
    same call maps display->logical). Lines with no strong-RTL content
    are returned unchanged, so the function is safe to apply uniformly
    across a mixed corpus."""
    if not is_rtl_line(text):
        return text
    rev = text[::-1]
    out = list(rev)
    for i, j in _ltr_run_spans(rev):
        out[i:j] = rev[i:j][::-1]
    return "".join(out)


def display_order_uxxxx(transcript: str) -> str:
    """``display_order`` over a uxxxx token string (the stored transcript
    form): decode -> reorder -> re-encode, preserving token identity."""
    from . import utf8_to_uxxxx, uxxxx_to_utf8

    return utf8_to_uxxxx(display_order(uxxxx_to_utf8(transcript)))
