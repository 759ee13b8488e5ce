"""Lexicon-constrained decoding — the reference era's Kaldi/OpenFst
lexicon-FST workflow (SURVEY.md C14: frame posteriors were decoded
through WFSTs composed with a lexicon), rebuilt as a trie constraint on
the in-process prefix beam search.

A ``Lexicon`` is a character-token trie over an alphabet's class ids.
During search every beam carries its trie node for the word in
progress; symbol extensions must follow a trie edge, and the space
token is only allowed at a word boundary (node is word-final, or root —
leading/repeated spaces). The constraint is HARD: hypotheses are always
concatenations of lexicon words. Use with a word list distilled from
the training transcripts or any external vocabulary.

Two engines share the rule: the host Python expansion
(decode/beam.py, ``beam_impl="host"``) walks the trie directly, and the
device beam search gathers from ``dense_tables()`` inside its scan —
string-exact parity is pinned in tests. ``infer --lexicon words.txt``
and ``ServiceConfig.lexicon_path`` wire it up.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from ..text import Alphabet, utf8_to_uxxxx


class Lexicon:
    """Character-token trie over alphabet class ids. Node 0 is the root;
    ``advance`` returns -1 when the extension leaves the lexicon."""

    def __init__(self, alphabet: Alphabet, words_uxxxx: Iterable[str]):
        from ..text import uxxxx_to_utf8

        self.alphabet = alphabet
        space = alphabet.index_of("u0020") if "u0020" in alphabet else -1
        self.space_id = space
        self._children: List[Dict[int, int]] = [{}]
        self._word_final: List[bool] = [False]
        self._node_word: List[int] = [-1]  # word id at final nodes
        self.words: List[str] = []  # utf8, id-aligned (word-LM vocab)
        for w in words_uxxxx:
            toks = [t for t in w.split() if t]
            if not toks:
                continue
            try:
                ids = [alphabet.index_of(t) for t in toks]
            except KeyError:
                continue  # word uses symbols outside this model's alphabet
            if space in ids:
                raise ValueError(
                    f"lexicon word contains a space token: {w!r}"
                )
            node = 0
            for c in ids:
                node = self._children[node].setdefault(
                    c, len(self._children)
                )
                if node == len(self._children):  # new node allocated
                    self._children.append({})
                    self._word_final.append(False)
                    self._node_word.append(-1)
            if not self._word_final[node]:  # first occurrence wins
                self._word_final[node] = True
                self._node_word[node] = len(self.words)
                self.words.append(uxxxx_to_utf8(w))
        if not self.words:
            raise ValueError("lexicon is empty after alphabet filtering")
        self.num_words = len(self.words)

    @classmethod
    def from_words(cls, alphabet: Alphabet, words: Iterable[str]) -> "Lexicon":
        """Build from plain-text words (utf8)."""
        return cls(alphabet, (utf8_to_uxxxx(w) for w in words))

    @classmethod
    def read_words(cls, alphabet: Alphabet, path: str) -> "Lexicon":
        """One word per line, utf8; blank lines and '#' comments skipped."""
        with open(path, encoding="utf-8") as f:
            words = [
                line.strip() for line in f
                if line.strip() and not line.startswith("#")
            ]
        return cls.from_words(alphabet, words)

    # ---- search interface ---------------------------------------------------
    def start(self) -> int:
        return 0

    def advance(self, node: int, token_id: int) -> int:
        """Next trie node after emitting ``token_id`` mid-word, or -1 if
        no lexicon word continues this way. The space token is handled by
        ``allows`` / word-boundary logic, not here."""
        return self._children[node].get(token_id, -1)

    def is_word(self, node: int) -> bool:
        return self._word_final[node]

    def allows(self, node: int, token_id: int) -> bool:
        """May a beam at ``node`` emit ``token_id``? Space needs a word
        boundary; symbols need a trie edge."""
        if token_id == self.space_id:
            return node == 0 or self._word_final[node]
        return token_id in self._children[node]

    def next_node(self, node: int, token_id: int) -> int:
        """State transition paired with ``allows`` (call only when
        allowed): space resets to root, symbols follow the trie."""
        if token_id == self.space_id:
            return 0
        return self._children[node][token_id]

    def at_boundary(self, node: int) -> bool:
        """True when a hypothesis may END here (complete words only)."""
        return node == 0 or self._word_final[node]

    # The host UNK sentinel: a beam mid-way through an out-of-lexicon
    # word under the character-bypass escape (see docs/decoding.md
    # "Open vocabulary"). The device twin is the appended dense-table
    # row (index N).
    UNK_NODE = -2

    # ---- dense form for the ON-DEVICE beam search ---------------------------
    def dense_tables(self, unk: bool = False):
        """Densify the trie for decode/device_beam.beam_scan: returns
        ``(next_tbl [N, K] int32, boundary [N] bool)`` where
        ``next_tbl[node, c]`` is the node after emitting class ``c``
        (-1 = disallowed) with the space rule FOLDED IN (space column:
        0 at word boundaries, -1 mid-word), and ``boundary`` marks nodes
        where a hypothesis may end. The device search then needs one
        gather per candidate and zero branching — the lexicon-FST on
        the MXU's terms. Cached: the trie is immutable after
        construction and batch loops call this per batch.

        ``unk=True`` appends the character-bypass state as row ``N``
        (the union-FST <unk> loop): every symbol loops on ``N``, space
        exits to the root, and ``boundary[N]`` is True (a hypothesis may
        end mid-unk-word — unk words are arbitrary). The search reaches
        row ``N`` when a candidate falls off the trie and pays the
        per-char penalty there (beam_scan's ``lex_unk_logp``)."""
        import numpy as np

        cache = getattr(self, "_dense_cache", None)
        if not isinstance(cache, dict):  # legacy tuple-shaped cache
            cache = {}
        if unk in cache:
            return cache[unk]
        N = len(self._children)
        K = self.alphabet.num_classes
        rows = N + 1 if unk else N
        if rows * K >= 2**31:
            raise ValueError(
                f"lexicon too large for the dense device form: {N} trie "
                f"nodes x {K} classes overflows the int32 flat index "
                "(and the table itself would be multi-GB); use the host "
                "expansion (beam_impl='host') for this vocabulary"
            )
        next_tbl = np.full((rows, K), -1, np.int32)
        boundary = np.zeros((rows,), bool)
        for node in range(N):
            for c, nxt in self._children[node].items():
                next_tbl[node, c] = nxt
            boundary[node] = self.at_boundary(node)
            if self.space_id >= 0 and boundary[node]:
                next_tbl[node, self.space_id] = 0
        if unk:
            next_tbl[N, 1:] = N  # every symbol loops in the unk state
            if self.space_id >= 0:
                next_tbl[N, self.space_id] = 0  # space completes the word
            boundary[N] = True
        cache[unk] = (next_tbl, boundary)
        self._dense_cache = cache
        return cache[unk]

    def word_id_table(self, unk: bool = False):
        """[N] int32: the word id completed at each word-final node
        (-1 elsewhere) — pairs with ``dense_tables`` for on-device
        word-LM fusion (word ids index ``self.words``). ``unk=True``
        appends the -1 entry for the unk row (no lexicon word id)."""
        import numpy as np

        arr = np.asarray(self._node_word, np.int32)
        if unk:
            arr = np.concatenate([arr, np.asarray([-1], np.int32)])
        return arr
