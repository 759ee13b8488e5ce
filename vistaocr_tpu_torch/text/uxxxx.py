"""uxxxx transcript codec (component C1, SURVEY.md §2).

Transcripts are represented as space-separated per-character tokens of the
form ``u0041`` (lowercase hex of the Unicode codepoint, zero-padded to at
least 4 digits; astral-plane codepoints use 5-6 digits, e.g. ``u1f600``).
This representation is unicode-robust — critical for Arabic/Farsi where
byte-level handling of combining marks and presentation forms is fragile —
and makes CER a simple token-level edit distance.

Parity contract: the reference's ``utf8_to_uxxxx`` / ``uxxxx_to_utf8``
(reconstructed from src/textutils.py, SURVEY.md C1 [H]) produce one token
per Unicode codepoint; a literal space character becomes ``u0020`` and acts
as the word separator for WER.
"""

from __future__ import annotations

import re
from typing import Iterable, List

_TOKEN_RE = re.compile(r"^u[0-9a-f]{4,6}$")


def char_to_uxxxx(ch: str) -> str:
    """Encode a single Unicode character as a uxxxx token."""
    cp = ord(ch)
    return f"u{cp:04x}"


def uxxxx_to_char(token: str) -> str:
    """Decode one uxxxx token back to its character. Raises on malformed input."""
    if not _TOKEN_RE.match(token):
        raise ValueError(f"malformed uxxxx token: {token!r}")
    return chr(int(token[1:], 16))


def utf8_to_uxxxx(text: str, sep: str = " ") -> str:
    """Encode a Unicode string as space-separated uxxxx tokens.

    >>> utf8_to_uxxxx("Ab c")
    'u0041 u0062 u0020 u0063'
    """
    return sep.join(char_to_uxxxx(ch) for ch in text)


def uxxxx_to_utf8(tokens: str | Iterable[str], sep: str = " ") -> str:
    """Decode space-separated uxxxx tokens (or an iterable of tokens) to text.

    >>> uxxxx_to_utf8('u0041 u0062 u0020 u0063')
    'Ab c'
    """
    if isinstance(tokens, str):
        tokens = tokens.split(sep) if tokens else []
    return "".join(uxxxx_to_char(t) for t in tokens if t)


def uxxxx_tokens(text: str) -> List[str]:
    """Encode to a list of tokens (one per codepoint)."""
    return [char_to_uxxxx(ch) for ch in text]


def is_uxxxx_token(token: str) -> bool:
    return bool(_TOKEN_RE.match(token))


SPACE_TOKEN = "u0020"
