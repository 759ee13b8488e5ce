"""ARPA n-gram language model with Katz backoff — half of component C14.

The reference era fused n-gram LMs via external Kaldi/OpenFst/KenLM
tooling (SURVEY.md C14 [M]); the rebuild scores in-process. The LM is
TOKEN-level over uxxxx character tokens (u0020 included), which is the
natural unit for CTC prefix fusion — an ARPA file whose "words" are uxxxx
tokens. ``score(state, token) -> (logp, state)`` is the stateful API the
beam search drives; states are n-1 token tuples, so scoring is O(1) dict
lookups with backoff.

Also provides ``train_char_lm`` to estimate a small add-k smoothed model
from transcripts and ``write/read`` for the ARPA text format (KenLM-
compatible subset: \\data\\ header, \\N-grams: sections, log10 probs,
optional backoff column).

The C++ twin (decode/native/beam.cpp::load_arpa) parses the same ARPA
text into hash-map tables; this Python version is its correctness oracle.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

LOG10 = math.log(10.0)

BOS = "<s>"
EOS = "</s>"
UNK = "<unk>"
# Floor for a token with no unigram entry and no <unk> row — shared by
# ArpaLM._logp_backoff and word_unk_logp so the <unk>-word completion
# score can never silently diverge from host LM scoring (advisor r4).
LOGP_FLOOR = -20.0


class ArpaLM:
    """n-gram LM: P(token | history) with Katz backoff, natural-log scores."""

    def __init__(self, order: int):
        self.order = order
        # ngram tables: tuple(tokens) -> (logprob_e, backoff_e)
        self.tables: List[Dict[Tuple[str, ...], Tuple[float, float]]] = [
            {} for _ in range(order)
        ]

    # ---- queries ------------------------------------------------------------
    def start_state(self) -> Tuple[str, ...]:
        return (BOS,)

    def _lookup(self, ngram: Tuple[str, ...]) -> Optional[Tuple[float, float]]:
        return self.tables[len(ngram) - 1].get(ngram)

    def logp(self, history: Tuple[str, ...], token: str) -> float:
        """log P(token | history) with standard backoff; history may be any
        length (only the last order-1 tokens are used)."""
        hist = tuple(history[-(self.order - 1):]) if self.order > 1 else ()
        return self._logp_backoff(hist, token)

    def _logp_backoff(self, hist: Tuple[str, ...], token: str) -> float:
        ent = self._lookup(hist + (token,))
        if ent is not None:
            return ent[0]
        if not hist:
            unk = self._lookup((UNK,))
            return unk[0] if unk else LOGP_FLOOR
        bo = self._lookup(hist)
        backoff = bo[1] if bo else 0.0
        return backoff + self._logp_backoff(hist[1:], token)

    def score(self, state: Tuple[str, ...], token: str) -> Tuple[float, Tuple[str, ...]]:
        lp = self.logp(state, token)
        new_state = (state + (token,))[-(self.order - 1):] if self.order > 1 else ()
        return lp, new_state

    def sentence_logp(self, tokens: Sequence[str]) -> float:
        state = self.start_state()
        total = 0.0
        for t in list(tokens) + [EOS]:
            lp, state = self.score(state, t)
            total += lp
        return total

    # ---- ARPA I/O -----------------------------------------------------------
    @classmethod
    def read_arpa(cls, path: str) -> "ArpaLM":
        with open(path, encoding="utf-8") as f:
            lines = iter(f)
            counts = []
            for line in lines:
                line = line.strip()
                if line == "\\data\\":
                    break
            for line in lines:
                line = line.strip()
                if not line:
                    break
                if line.startswith("ngram"):
                    counts.append(int(line.split("=")[1]))
            lm = cls(order=len(counts))
            cur_n = 0
            for line in lines:
                line = line.strip()
                if not line:
                    continue
                if line == "\\end\\":
                    break
                if line.endswith("-grams:"):
                    cur_n = int(line[1:].split("-")[0])
                    continue
                parts = line.split("\t")
                if len(parts) < 2:
                    parts = line.split()
                    if len(parts) < cur_n + 1:
                        continue
                    logp = float(parts[0])
                    toks = tuple(parts[1 : 1 + cur_n])
                    backoff = float(parts[1 + cur_n]) if len(parts) > 1 + cur_n else 0.0
                else:
                    logp = float(parts[0])
                    toks = tuple(parts[1].split())
                    backoff = float(parts[2]) if len(parts) > 2 else 0.0
                lm.tables[cur_n - 1][toks] = (logp * LOG10, backoff * LOG10)
            return lm

    def write_arpa(self, path: str):
        with open(path, "w", encoding="utf-8") as f:
            f.write("\\data\\\n")
            for n in range(self.order):
                f.write(f"ngram {n+1}={len(self.tables[n])}\n")
            for n in range(self.order):
                f.write(f"\n\\{n+1}-grams:\n")
                for toks, (lp, bo) in sorted(self.tables[n].items()):
                    lp10 = lp / LOG10
                    if n < self.order - 1 and bo != 0.0:
                        f.write(f"{lp10:.6f}\t{' '.join(toks)}\t{bo/LOG10:.6f}\n")
                    else:
                        f.write(f"{lp10:.6f}\t{' '.join(toks)}\n")
            f.write("\n\\end\\\n")


def dense_logp_table(lm: "ArpaLM", alphabet, order: Optional[int] = None):
    """Densify an ARPA LM (order <= 3) into a numpy log-prob table for the
    ON-DEVICE interleaved beam fusion (decode/device_beam.py).

    Context encoding along history axes (size ``K + 1`` where K =
    ``alphabet.num_classes``): index 0 = no token (short history), index
    ``K`` = ``<s>``, symbol class ids 1..K-1 at their own index. The last
    axis is the scored symbol's class id (entry 0 = blank, never queried).

    - order 2 -> ``[K+1, K]``: ``t[h, c] = log P(c | h)``
    - order 3 -> ``[K+1, K+1, K]``: ``t[h1, h2, c] = log P(c | h1 h2)``

    Every entry is produced by ``lm.logp`` itself (full Katz backoff), so
    the dense table is EXACT for its order — the device fusion scores
    identically to the host oracle. Build cost is ``(K+1)^(order-1) * K``
    queries: one-time at service/infer init (~seconds for 100+-class
    alphabets; amortized by the persistent service).
    """
    import numpy as np

    order = order or min(lm.order, 3)
    if order not in (2, 3):
        raise ValueError(f"dense_logp_table supports order 2 or 3, got {order}")
    K = alphabet.num_classes
    toks = [None] + alphabet.tokens  # class id -> uxxxx token
    BOS_ID = K

    def hist(*ids):
        return tuple(
            BOS if i == BOS_ID else toks[i] for i in ids if i != 0
        )

    if order == 2:
        t = np.zeros((K + 1, K), np.float32)
        for h in range(K + 1):
            hh = hist(h)
            for c in range(1, K):
                t[h, c] = lm.logp(hh, toks[c])
        return t
    t = np.zeros((K + 1, K + 1, K), np.float32)
    for h1 in range(K + 1):
        for h2 in range(K + 1):
            hh = hist(h1, h2)
            for c in range(1, K):
                t[h1, h2, c] = lm.logp(hh, toks[c])
    return t


def hashed_logp_table(lm: "ArpaLM", alphabet):
    """Hashed context table for ON-DEVICE order-4 fusion — the dense
    route stops at order 3 because a [K+1, K+1, K+1, K] table is
    multi-GB for real alphabets, but an ARPA 4-gram only *observes* a
    few tens of thousands of trigram contexts; everything else backs off
    to the trigram distribution (Katz: unseen context => backoff weight
    log 1 = 0). So the device needs just:

    - ``t3``: the EXACT order-3 dense table (``dense_logp_table``) as the
      universal fallback — correct for histories shorter than 3 tokens
      and for unobserved 3-token contexts;
    - ``rows [R, K]``: one fully-backoff-resolved row per OBSERVED
      3-token context (trigram entries + 4-gram context prefixes), each
      produced by ``lm.logp`` itself, so hits are exact too;
    - ``keys/vals [S]``: an open-addressed (linear-probe, power-of-two,
      load <= 0.5) int32 hash table mapping the packed context key
      ``(h1*(K+1)+h2)*(K+1)+h3`` to its row; ``probes`` is the measured
      max probe length, so the device probe loop is static.

    Context ids use the dense-table encoding (0 = none, K = <s>, class
    ids elsewhere). Keys with h1 = 0 (short history) are never stored,
    so they can never hit — the device needs no special-casing. Returns
    ``{"keys", "vals", "rows", "t3", "probes"}`` (numpy + int).
    """
    import numpy as np

    if lm.order != 4:
        raise ValueError(
            f"hashed_logp_table is the order-4 device path (got order "
            f"{lm.order}); use dense_logp_table for order <= 3"
        )
    K = alphabet.num_classes
    if (K + 1) ** 3 >= 2 ** 31:
        raise ValueError(
            f"alphabet too large for packed int32 context keys "
            f"({K + 1}^3 >= 2^31); use the host/two-pass path"
        )
    toks = [None] + alphabet.tokens
    tok_id = {t: i for i, t in enumerate(alphabet.tokens, start=1)}
    tok_id[BOS] = K

    contexts = set()
    for ng in lm.tables[2]:
        contexts.add(ng)
    for ng in lm.tables[3]:
        contexts.add(ng[:3])
    ctx_ids = []
    for ctx in contexts:
        ids = tuple(tok_id.get(t) for t in ctx)
        if None in ids:
            continue  # context uses tokens outside this alphabet (</s>, unk)
        ctx_ids.append(ids)
    ctx_ids.sort()

    R = len(ctx_ids)
    rows = np.zeros((max(R, 1), K), np.float32)
    keys_list = np.zeros((R,), np.int64)
    for r, (h1, h2, h3) in enumerate(ctx_ids):
        hist = tuple(
            BOS if i == K else toks[i] for i in (h1, h2, h3)
        )
        keys_list[r] = ((h1 * (K + 1)) + h2) * (K + 1) + h3
        for c in range(1, K):
            rows[r, c] = lm.logp(hist, toks[c])

    S = 1
    while S < max(2 * R, 8):
        S *= 2
    shift = 32 - S.bit_length() + 1  # S = 2**(bit_length-1)
    keys = np.full((S,), -1, np.int32)
    vals = np.zeros((S,), np.int32)
    probes = 1
    for r in range(R):
        key = int(keys_list[r])
        idx = ((key * 2654435761) & 0xFFFFFFFF) >> shift
        d = 0
        while keys[(idx + d) & (S - 1)] != -1:
            d += 1
        keys[(idx + d) & (S - 1)] = np.int32(key)
        vals[(idx + d) & (S - 1)] = r
        probes = max(probes, d + 1)

    return {
        "keys": keys,
        "vals": vals,
        "rows": rows,
        "t3": dense_logp_table(lm, alphabet, order=3),
        "probes": probes,
    }


def dense_word_logp_table(word_lm: "ArpaLM", words):
    """Densify a word-level ARPA LM (order <= 2, utf8 word tokens) for
    on-device fusion: ``t[h, w] = log P(words[w] | context h)`` with
    context axis size ``len(words) + 1`` — index ``len(words)`` is
    ``<s>``, word ids at their own index. Built by ``lm.logp`` itself
    (full backoff), so it is exact for bigram LMs; higher orders cannot
    be represented by (prev word) alone and are rejected."""
    import numpy as np

    if word_lm.order > 2:
        raise ValueError(
            f"on-device word fusion supports order <= 2 (got "
            f"{word_lm.order}); use the host expansion for higher orders"
        )
    V = len(words)
    if V > 8192:
        raise ValueError(
            f"dense word table would be {V}x{V} f32 "
            f"(~{4 * V * V / 2**20:.0f} MiB) — beyond the practical HBM "
            "budget; use the host expansion for vocabularies this large"
        )
    t = np.zeros((V + 1, V), np.float32)
    for h in range(V + 1):
        hist = (BOS,) if h == V else (words[h],)
        for w in range(V):
            t[h, w] = word_lm.logp(hist, words[w])
    return t


# Above this vocabulary size the dense [V+1, V] f32 word table (V^2
# memory: 256 MiB at 8k, 10 GiB at 50k) loses to the hashed Katz form.
DENSE_WORD_CAP = 8192
# uint32-packed (prev, word) keys need V * (V + 1) <= 2^32; the sentinel
# 0xFFFFFFFF must also stay unreachable.
HASHED_WORD_CAP = 65535


def hashed_word_logp_table(word_lm: "ArpaLM", words):
    """Hashed word-bigram tables for ON-DEVICE fusion at vocabulary
    scales the dense table cannot reach (VERDICT r4 missing #1: the
    reference-era Kaldi/OpenFst G.fst composed tens of thousands of
    words; the dense [V+1, V] form is V^2 memory — 10 GiB at 50k).

    Katz structure makes the sparse form exact: an ARPA bigram only
    OBSERVES a corpus-bounded set of (prev, word) pairs; every other
    query is backoff(prev) + unigram(word). So the device needs:

    - ``uni [V] f32``: unigram log P(word) with the LM's own unk floor
      for out-of-LM lexicon words (lm.logp with empty history);
    - ``bo [V+1] f32``: backoff weight per context (index V = <s>;
      unobserved contexts back off with weight log 1 = 0);
    - ``keys/vals [S]``: an open-addressed (linear-probe, power-of-two,
      load <= 0.5) table mapping the uint32-packed key
      ``prev * V + word`` to the EXACT observed-bigram log-prob
      (produced by ``lm.logp`` itself); ``probes`` is the measured max
      probe length so the device loop is static.

    Device lookup (decode/device_beam._word_logp_gather):
    ``hash hit ? vals[slot] : bo[prev] + uni[word]`` — exactly
    ``lm.logp((prev,), word)`` for order <= 2, so host/device parity is
    bit-level, same as the dense path. Memory is O(V + observed
    bigrams) instead of O(V^2): ~0.6 MiB for a 50k-word lexicon with a
    50k-bigram LM vs 10 GiB dense.

    Vocabulary cap: ``V <= 65535`` (uint32 key packing); beyond that use
    the host expansion. Returns {"uni", "bo", "keys", "vals", "probes"}.
    """
    import numpy as np

    if word_lm.order > 2:
        raise ValueError(
            f"on-device word fusion supports order <= 2 (got "
            f"{word_lm.order}); use the host expansion for higher orders"
        )
    V = len(words)
    if V > HASHED_WORD_CAP:
        raise ValueError(
            f"hashed word tables cap at V <= {HASHED_WORD_CAP} "
            f"(uint32-packed keys); got {V} — use the host expansion"
        )
    word_id = {w: i for i, w in enumerate(words)}

    uni = np.zeros((V,), np.float32)
    for w in range(V):
        uni[w] = word_lm.logp((), words[w])
    bo = np.zeros((V + 1,), np.float32)
    for h in range(V + 1):
        ent = word_lm._lookup((BOS,) if h == V else (words[h],))
        bo[h] = ent[1] if ent else 0.0

    # observed bigrams restricted to this lexicon's vocabulary
    pairs = []
    for (h_tok, w_tok) in word_lm.tables[1] if word_lm.order >= 2 else ():
        w = word_id.get(w_tok)
        if w is None:
            continue
        h = V if h_tok == BOS else word_id.get(h_tok)
        if h is None:
            continue
        pairs.append((h, w))
    pairs.sort()

    R = len(pairs)
    S = 1
    while S < max(2 * R, 8):
        S *= 2
    shift = 32 - (S.bit_length() - 1)
    keys = np.full((S,), 0xFFFFFFFF, np.uint32)
    vals = np.zeros((S,), np.float32)
    probes = 1
    for h, w in pairs:
        key = h * V + w
        idx = ((key * 2654435761) & 0xFFFFFFFF) >> shift
        d = 0
        while keys[(idx + d) & (S - 1)] != 0xFFFFFFFF:
            d += 1
        keys[(idx + d) & (S - 1)] = np.uint32(key)
        # exact Katz score (matches the dense table entry bit-for-bit)
        vals[(idx + d) & (S - 1)] = word_lm.logp(
            (BOS,) if h == V else (words[h],), words[w])
        probes = max(probes, d + 1)

    return {"uni": uni, "bo": bo, "keys": keys, "vals": vals,
            "probes": probes}


# Trigram context keys pack (prev2, prev1) as prev2*(V+1)+prev1 with
# prev2, prev1 in [0..V] (V = <s>); the max stored key (V+1)^2 - 1 must
# stay below the 0xFFFFFFFF empty sentinel.
TRIGRAM_WORD_CAP = 65534


def _open_hash_u32(entries):
    """Open-addressed uint32 hash table (linear probe, power-of-two size,
    load <= 0.5, empty sentinel 0xFFFFFFFF) shared by the hashed word
    tables. ``entries`` is a sorted list of (key, (val0, val1, ...));
    returns (keys [S] uint32, [vals0 [S], vals1 [S], ...] float32/int32
    by value type, probes). The device probe loop replays the same
    ``key * 2654435761 >> shift`` placement, so probes is exact."""
    import numpy as np

    R = len(entries)
    S = 1
    while S < max(2 * R, 8):
        S *= 2
    shift = 32 - (S.bit_length() - 1)
    keys = np.full((S,), 0xFFFFFFFF, np.uint32)
    n_vals = len(entries[0][1]) if R else 1
    vals = [np.zeros((S,), np.float32) for _ in range(n_vals)]
    probes = 1
    slots = []
    for key, vs in entries:
        idx = ((key * 2654435761) & 0xFFFFFFFF) >> shift
        d = 0
        while keys[(idx + d) & (S - 1)] != 0xFFFFFFFF:
            d += 1
        slot = (idx + d) & (S - 1)
        keys[slot] = np.uint32(key)
        for a, v in zip(vals, vs):
            a[slot] = v
        slots.append(slot)
        probes = max(probes, d + 1)
    return keys, vals, probes, slots


def hashed_word_trigram_tables(word_lm: "ArpaLM", words):
    """Hashed word-TRIGRAM tables for on-device fusion of an order-3 G
    (the Kaldi-era G.fst was routinely a pruned trigram; the device path
    previously stopped at bigrams and routed order 3 to the host
    expansion). Katz structure keeps the sparse form exact at one more
    level: ``log P(w | p2, p1)`` is the observed-trigram score when
    (p2, p1, w) is in the ARPA, else ``bo(p2, p1) + log P(w | p1)`` —
    and the bigram term is exactly what the round-5 hashed bigram tables
    already compute. So the trigram form adds two tables on top of the
    bigram trio:

    - ``ctx_keys/ctx_ids/ctx_bo [Sc]``: open-addressed table over packed
      ``p2 * (V+1) + p1`` context keys (p2, p1 in [0..V], V = <s>) for
      every context that has observed trigrams in this vocabulary and/or
      a nonzero Katz backoff weight on its bigram entry. ``ctx_ids`` is
      a dense trigram-context id (or -1 when the context only carries a
      backoff weight); ``ctx_bo`` is bo(p2, p1) (unstored contexts back
      off with weight log 1 = 0, so a probe miss is exact);
    - ``tri_keys/tri_vals [St]``: observed trigrams keyed by
      ``ctx_id * V + w`` with the EXACT ``lm.logp((p2, p1), w)`` score.

    Device lookup (decode/device_beam._word_logp_gather with wprev2):
    bigram score s2 first, then ``ctx hit ? (tri hit ? tri_val
    : ctx_bo + s2) : s2`` — bit-level host parity for any length-2
    history, while a length-1 history (sentence start: wprev2 = the NONE
    sentinel V+1) can never hit the context table and falls through to
    the exact bigram machinery, matching ``ArpaLM.logp`` on the short
    history. Caps: V <= TRIGRAM_WORD_CAP (context-key packing) and
    observed-context count C <= (2^32 - 1) // V (trigram-key packing);
    beyond either, use the host expansion."""
    import numpy as np

    if word_lm.order != 3:
        raise ValueError(
            f"hashed_word_trigram_tables is the order-3 device path "
            f"(got order {word_lm.order})"
        )
    V = len(words)
    if V > TRIGRAM_WORD_CAP:
        raise ValueError(
            f"hashed word-trigram tables cap at V <= {TRIGRAM_WORD_CAP} "
            f"(packed (prev2, prev1) context keys); got {V} — use the "
            "host expansion"
        )
    word_id = {w: i for i, w in enumerate(words)}

    def ctx_id_of(tok):
        if tok == BOS:
            return V
        return word_id.get(tok)

    big = hashed_word_logp_table(
        _order2_view(word_lm), words)

    # contexts: observed-trigram (p2, p1) pairs in-vocab, plus bigram
    # entries carrying a nonzero backoff weight (needed for exactness
    # even when all their trigrams fall outside this lexicon)
    tri_by_ctx: dict = {}
    for ng in word_lm.tables[2]:
        p2, p1 = ctx_id_of(ng[0]), ctx_id_of(ng[1])
        w = word_id.get(ng[2])
        if p2 is None or p1 is None or w is None:
            continue
        tri_by_ctx.setdefault((p2, p1), []).append(w)
    ctx_bo_map: dict = {}
    for ng, (_, bo) in word_lm.tables[1].items():
        if bo == 0.0:
            continue
        p2, p1 = ctx_id_of(ng[0]), ctx_id_of(ng[1])
        if p2 is None or p1 is None:
            continue
        ctx_bo_map[(p2, p1)] = bo

    ctx_list = sorted(set(tri_by_ctx) | set(ctx_bo_map))
    C = len(tri_by_ctx)
    if C > 0 and C * V - 1 >= 0xFFFFFFFF:
        raise ValueError(
            f"too many observed trigram contexts for packed trigram "
            f"keys ({C} contexts x {V} words); use the host expansion"
        )

    cid_of = {}
    ctx_entries = []
    next_cid = 0
    for (p2, p1) in ctx_list:
        if (p2, p1) in tri_by_ctx:
            cid = next_cid
            next_cid += 1
        else:
            cid = -1
        cid_of[(p2, p1)] = cid
        ctx_entries.append(
            (p2 * (V + 1) + p1, (ctx_bo_map.get((p2, p1), 0.0),))
        )
    ctx_keys, (ctx_bo,), ctx_probes, ctx_slots = _open_hash_u32(
        ctx_entries)
    # cid per slot, int32-exact (unoccupied slots read "no trigram rows")
    ctx_ids = np.full(ctx_keys.shape, -1, np.int32)
    for (p2, p1), slot in zip(ctx_list, ctx_slots):
        ctx_ids[slot] = cid_of[(p2, p1)]

    def hist_toks(p2, p1):
        return (BOS if p2 == V else words[p2],
                BOS if p1 == V else words[p1])

    tri_entries = []
    for (p2, p1), ws in tri_by_ctx.items():
        cid = cid_of[(p2, p1)]
        hist = hist_toks(p2, p1)
        for w in ws:
            # exact Katz score (matches ArpaLM.logp bit-for-bit)
            tri_entries.append(
                (cid * V + w, (word_lm.logp(hist, words[w]),)))
    tri_entries.sort()
    tri_keys, (tri_vals,), tri_probes, _ = _open_hash_u32(tri_entries)

    return {
        "uni": big["uni"], "bo": big["bo"], "keys": big["keys"],
        "vals": big["vals"], "probes": big["probes"],
        "ctx_keys": ctx_keys, "ctx_ids": ctx_ids, "ctx_bo": ctx_bo,
        "ctx_probes": ctx_probes,
        "tri_keys": tri_keys, "tri_vals": tri_vals,
        "tri_probes": max(tri_probes, 1),
    }


class _order2_view:
    """Order-2 facade over a higher-order ArpaLM so the bigram table
    builder can reuse its exact machinery: ``logp`` truncates history to
    one token (= the trigram form's bigram fallback term), ``tables``
    and ``_lookup`` pass through."""

    def __init__(self, lm: "ArpaLM"):
        self._lm = lm
        self.order = 2
        self.tables = lm.tables

    def logp(self, history, token):
        hist = tuple(history[-1:])
        return self._lm._logp_backoff(hist, token)

    def _lookup(self, ngram):
        return self._lm._lookup(ngram)


def device_word_tables(word_lm: "ArpaLM", words) -> dict:
    """Pick the on-device word-LM representation for a vocabulary:
    dense ``{"word_table"}`` up to DENSE_WORD_CAP (one gather per
    lookup), hashed bigram ``{"word_uni", "word_bo", "word_hash_keys",
    "word_hash_vals", "word_probes"}`` beyond it (probe loop + Katz
    fallback), and for an ORDER-3 LM the hashed trigram form (bigram
    trio + ``word_ctx_*``/``word_tri_*`` refinement tables) at any
    vocabulary size — exact in every shape. All three feed
    decode/device_beam.beam_scan directly."""
    import numpy as np

    if word_lm.order == 3:
        t = hashed_word_trigram_tables(word_lm, words)
        return {
            "word_uni": t["uni"],
            "word_bo": t["bo"],
            "word_hash_keys": t["keys"],
            "word_hash_vals": t["vals"],
            "word_probes": int(t["probes"]),
            "word_ctx_keys": t["ctx_keys"],
            "word_ctx_ids": t["ctx_ids"],
            "word_ctx_bo": t["ctx_bo"],
            "word_ctx_probes": int(t["ctx_probes"]),
            "word_tri_keys": t["tri_keys"],
            "word_tri_vals": t["tri_vals"],
            "word_tri_probes": int(t["tri_probes"]),
        }
    if word_lm.order > 3:
        raise ValueError(
            f"on-device word fusion supports order <= 3 (got "
            f"{word_lm.order}); use the host expansion for higher orders"
        )
    if len(words) <= DENSE_WORD_CAP:
        return {"word_table": np.asarray(dense_word_logp_table(
            word_lm, words))}
    t = hashed_word_logp_table(word_lm, words)
    return {
        "word_uni": t["uni"],
        "word_bo": t["bo"],
        "word_hash_keys": t["keys"],
        "word_hash_vals": t["vals"],
        "word_probes": int(t["probes"]),
    }


def word_unk_logp(word_lm: Optional["ArpaLM"]) -> float:
    """The <unk>-word completion score all three engines share when the
    lexicon character-bypass completes an out-of-lexicon word under a
    word LM: the LM's <unk> unigram when present, else the same
    LOGP_FLOOR ArpaLM's backoff lookup bottoms out at."""
    if word_lm is None:
        return 0.0
    ent = word_lm._lookup((UNK,))
    return ent[0] if ent else LOGP_FLOOR


def train_char_lm(
    transcripts: Iterable[str],
    order: int = 3,
    add_k: float = 0.1,
) -> ArpaLM:
    """Estimate a token-level n-gram LM (add-k smoothing, interpolated
    backoff weights) from uxxxx transcripts. Small and simple — for
    experiments and tests; production models come from KenLM-style
    pipelines via read_arpa."""
    sents = [[BOS] + tr.split() + [EOS] for tr in transcripts if tr is not None]
    vocab = set()
    counts: List[Dict[Tuple[str, ...], int]] = [defaultdict(int) for _ in range(order)]
    for s in sents:
        vocab.update(s)
        for n in range(1, order + 1):
            for i in range(len(s) - n + 1):
                if n == 1 and s[i] == BOS:
                    continue  # BOS has no unigram prob
                counts[n - 1][tuple(s[i : i + n])] += 1
            # history-only contexts for backoff mass (prefix counts)
    vocab.discard(BOS)
    V = len(vocab) + 1  # +unk

    lm = ArpaLM(order)
    # unigrams
    total = sum(counts[0].values())
    for tok in sorted(vocab):
        c = counts[0].get((tok,), 0)
        p = (c + add_k) / (total + add_k * V)
        lm.tables[0][(tok,)] = (math.log(p), 0.0)
    lm.tables[0][(UNK,)] = (math.log(add_k / (total + add_k * V)), 0.0)
    lm.tables[0][(BOS,)] = (-99.0 * LOG10, 0.0)

    # higher orders: conditional add-k; uniform backoff weight 0 (add-k
    # already leaves mass on unseen events at lower order via our lookup
    # fallback)
    for n in range(2, order + 1):
        hist_counts: Dict[Tuple[str, ...], int] = defaultdict(int)
        for ng, c in counts[n - 1].items():
            hist_counts[ng[:-1]] += c
        for ng, c in counts[n - 1].items():
            p = (c + add_k) / (hist_counts[ng[:-1]] + add_k * V)
            lm.tables[n - 1][ng] = (math.log(p), 0.0)
    return lm
