"""Alphabet: char(uxxxx token) <-> index maps with index 0 = CTC blank.

Component C1 (SURVEY.md §2). The reference builds its alphabet over the
training transcripts and reserves index 0 for the CTC blank [H]; the
alphabet is serialized into the checkpoint so decode can reconstruct the
model from a single snapshot file (C16).

The alphabet is a frozen artifact: deterministic ordering (sorted by
codepoint) so that re-building over the same corpus yields the same
index assignment on every host.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Sequence

from .uxxxx import is_uxxxx_token, uxxxx_tokens


class Alphabet:
    """Immutable token<->index mapping; index 0 is reserved for the CTC blank."""

    BLANK = 0
    BLANK_TOKEN = "<ctc-blank>"

    def __init__(self, tokens: Sequence[str]):
        """`tokens` are the non-blank uxxxx tokens, in their final index order
        (index i+1 for position i)."""
        for t in tokens:
            if not is_uxxxx_token(t):
                raise ValueError(f"alphabet entry is not a uxxxx token: {t!r}")
        if len(set(tokens)) != len(tokens):
            raise ValueError("duplicate tokens in alphabet")
        self._tokens: List[str] = list(tokens)
        self._index: Dict[str, int] = {t: i + 1 for i, t in enumerate(self._tokens)}

    # ---- construction -----------------------------------------------------
    @classmethod
    def build(cls, transcripts: Iterable[str], from_text: bool = False) -> "Alphabet":
        """Build an alphabet over a corpus of transcripts.

        `transcripts` are uxxxx strings (space-separated tokens), or raw text
        if `from_text=True`. Tokens are sorted by codepoint for determinism.
        """
        seen = set()
        for tr in transcripts:
            toks = uxxxx_tokens(tr) if from_text else tr.split()
            seen.update(t for t in toks if t)
        ordered = sorted(seen, key=lambda t: int(t[1:], 16))
        return cls(ordered)

    @classmethod
    def from_charset(cls, chars: str) -> "Alphabet":
        return cls.build([chars], from_text=True)

    # ---- mapping ----------------------------------------------------------
    def __len__(self) -> int:
        """Number of classes INCLUDING the blank (model head output dim)."""
        return len(self._tokens) + 1

    @property
    def num_classes(self) -> int:
        return len(self)

    @property
    def tokens(self) -> List[str]:
        return list(self._tokens)

    def encode(self, uxxxx: str) -> List[int]:
        """uxxxx transcript string -> label indices (no blanks)."""
        return [self._index[t] for t in uxxxx.split() if t]

    def encode_text(self, text: str) -> List[int]:
        return [self._index[t] for t in uxxxx_tokens(text)]

    def decode(self, indices: Iterable[int]) -> str:
        """Label indices -> uxxxx transcript string. Blank (0) is skipped."""
        out = []
        for i in indices:
            i = int(i)
            if i == self.BLANK:
                continue
            out.append(self._tokens[i - 1])
        return " ".join(out)

    def token_of(self, index: int) -> str:
        if index == self.BLANK:
            return self.BLANK_TOKEN
        return self._tokens[index - 1]

    def __contains__(self, token: str) -> bool:
        return token in self._index

    def index_of(self, token: str) -> int:
        return self._index[token]

    # ---- serialization (checkpoint sidecar, C16) ---------------------------
    def to_json(self) -> str:
        return json.dumps({"version": 1, "blank_index": 0, "tokens": self._tokens})

    @classmethod
    def from_json(cls, payload: str) -> "Alphabet":
        obj = json.loads(payload)
        if obj.get("blank_index", 0) != 0:
            raise ValueError("alphabet blank_index must be 0")
        return cls(obj["tokens"])

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Alphabet) and other._tokens == self._tokens

    def __hash__(self) -> int:
        return hash(tuple(self._tokens))
