"""CTC prefix beam search with n-gram LM fusion — component C14.

Counterpart of ``vistaocr_tpu/decode/beam.py``: the host expansion
(``prefix_beam_search``) and the engine choice of ``beam_decode`` are the
reference's, line for line; ``beam_topk`` runs on the log-probs' own
device in PyTorch (the candidate rule of ``jax.lax.top_k``, ties to the
lower class id), and ``beam_decode`` takes torch tensors or numpy arrays.

Standard algorithm (Hannun et al. 2014; PAPERS.md 1905.03175, 2508.07315):
beams are PREFIXES (not paths); each carries two log-probabilities,
ending-in-blank and ending-in-non-blank, so repeat-collapse is exact.
Scoring for pruning and final ranking:

    log P_ctc(prefix) + lm_alpha * log P_lm(prefix) + lm_beta * |prefix|

(lm_beta is the insertion bonus countering the LM's length penalty).

Pipeline shape (the TPU division of labor):
- the device computes log-probs and a per-frame TOP-K (beam_topk below) —
  hardware-oriented CTC decoding is memory-bound, and top-k pruning before
  beam expansion is the standard fix (PAPERS.md 1905.03175);
- the host expands beams over only those K candidates per frame.

This Python implementation is the correctness oracle for the C++ twin
(decode/native/, bound via ctypes) which the batched service uses.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..text import Alphabet
from .lm import ArpaLM

NEG_INF = -math.inf


def _logaddexp(a: float, b: float) -> float:
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    m = a if a > b else b
    return m + math.log(math.exp(a - m) + math.exp(b - m))


@dataclass
class BeamConfig:
    beam_width: int = 16
    topk: int = 8  # per-frame candidate classes fed to expansion
    lm_alpha: float = 0.0  # char-LM weight (0 = pure CTC)
    lm_beta: float = 0.0  # per-token insertion bonus
    prune_logp: float = -12.0  # drop frame candidates below best-this-frame + this
    word_lm_alpha: float = 0.0  # word-LM weight (host expansion only)
    word_lm_beta: float = 0.0  # per-WORD insertion bonus
    # Lexicon character-bypass (<unk> escape): per-character log penalty
    # for out-of-lexicon words. 0.0 keeps the HARD constraint; a negative
    # value (e.g. -4) lets the search spell words the lexicon lacks,
    # paying this per char — the union-FST "(lexicon words) ∪ (penalized
    # char loop)" semantics, max-parse determinized: a word follows the
    # trie for free while it can, and retroactively becomes an unk parse
    # (penalty x chars-so-far) the moment it falls off. See
    # docs/decoding.md "Open vocabulary".
    lex_unk_logp: float = 0.0

    def __post_init__(self):
        # A positive penalty would turn the per-char OOV cost into a
        # BONUS — and in unk mode the engines stop masking dead trie
        # transitions, so the search would actively prefer leaving the
        # lexicon (advisor r4). Fail loudly at construction.
        if self.lex_unk_logp > 0.0:
            raise ValueError(
                f"lex_unk_logp must be <= 0 (a per-character log "
                f"penalty); got {self.lex_unk_logp}")


def beam_topk(log_probs: torch.Tensor,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device-side per-frame top-k over SYMBOL classes (ids >= 1):
    [B, T, K] -> ([B, T, k] logp, int32 ids), on the log-probs' device.
    The blank row is always handled separately by the expansion, so k
    bounds symbol candidates only — the same candidate rule as
    prefix_beam_search's self-computed top-k.

    ``jax.lax.top_k`` orders equal values by the lower index first;
    ``torch.topk`` promises no order among them, and at the k-th place may
    take any of the classes equal to the k-th value, which would change
    the candidate set and so the hypotheses. So ``torch.topk`` gives the
    k-th value only: the candidates are every class above it and, of the
    classes equal to it, the lowest ids; they are ordered by value, the
    lower id first among equals."""
    x = log_probs[..., 1:]
    k = min(k, x.shape[-1])
    kth = torch.topk(x, k, dim=-1).values[..., -1:]
    above = x > kth
    tied = x == kth
    take = above | (tied & (torch.cumsum(tied, -1)
                            <= k - above.sum(-1, keepdim=True)))
    # the k taken classes in ascending id order, then by value (stable)
    ids = torch.argsort((~take).to(torch.uint8), dim=-1, stable=True)[..., :k]
    vals = torch.gather(x, -1, ids)
    order = torch.argsort(vals, dim=-1, descending=True, stable=True)
    return (torch.gather(vals, -1, order),
            (torch.gather(ids, -1, order) + 1).to(torch.int32))


def _host(a) -> np.ndarray:
    """A torch tensor (any device) or array-like as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class _Beam:
    __slots__ = ("p_b", "p_nb", "lm_state", "lm_logp", "lex_node",
                 "wlm_state", "wlm_logp", "wlm_words", "lex_bonus",
                 "lex_wlen")

    def __init__(self, p_b=NEG_INF, p_nb=NEG_INF, lm_state=(), lm_logp=0.0,
                 lex_node=0, wlm_state=(), wlm_logp=0.0, wlm_words=0,
                 lex_bonus=0.0, lex_wlen=0):
        self.p_b = p_b  # log P(prefix, ends in blank)
        self.p_nb = p_nb  # log P(prefix, ends in non-blank)
        self.lm_state = lm_state
        self.lm_logp = lm_logp  # cumulative LM log-prob of the prefix
        self.lex_node = lex_node  # trie state under a lexicon constraint
        self.wlm_state = wlm_state  # word-LM history (completed words)
        self.wlm_logp = wlm_logp  # cumulative word-LM log-prob
        self.wlm_words = wlm_words  # completed-word count
        self.lex_bonus = lex_bonus  # accumulated unk-bypass penalties
        self.lex_wlen = lex_wlen  # chars since word start (unk bypass)

    def total(self) -> float:
        return _logaddexp(self.p_b, self.p_nb)


def prefix_beam_search(
    log_probs: np.ndarray,  # [T, K] one sample's valid frames (f32)
    alphabet: Alphabet,
    config: BeamConfig = BeamConfig(),
    lm: Optional[ArpaLM] = None,
    topk_vals: Optional[np.ndarray] = None,  # [T, k] optional precomputed
    topk_ids: Optional[np.ndarray] = None,
    lexicon=None,  # decode.lexicon.Lexicon: hard vocabulary constraint
    word_lm: Optional[ArpaLM] = None,  # ARPA over utf8 WORD tokens
) -> List[Tuple[str, float]]:
    """Decode one line. Returns up to beam_width (uxxxx, score) hypotheses,
    best first. ``log_probs`` must contain only valid frames (t < frame
    count); the caller slices by the model's frame mask. With ``lexicon``
    every hypothesis is a concatenation of lexicon words (the Kaldi-era
    lexicon-FST constraint); finals ending mid-word are dropped unless
    nothing else survives.

    ``word_lm`` fuses a WORD-level n-gram (the Kaldi-era G.fst): each
    completed word (at a space emission, and the trailing word at
    finalization) is scored as one LM token, weighted by
    ``config.word_lm_alpha`` with a per-word ``word_lm_beta`` bonus.
    Composes with the char LM and the lexicon; words are utf8 strings,
    matching standard word-ARPA files. No </s> term is applied (line
    fragments are not sentences)."""
    from ..text import uxxxx_to_utf8

    from .lm import word_unk_logp as _word_unk_logp

    T = log_probs.shape[0]
    use_lm = lm is not None and config.lm_alpha != 0.0
    use_wlm = word_lm is not None and config.word_lm_alpha != 0.0
    use_unk = lexicon is not None and config.lex_unk_logp != 0.0
    unk_pen = float(config.lex_unk_logp)
    UNK = lexicon.UNK_NODE if lexicon is not None else -2
    w_unk = _word_unk_logp(word_lm) if use_wlm else 0.0
    lm_start = lm.start_state() if use_lm else ()
    wlm_start = word_lm.start_state() if use_wlm else ()
    try:
        space_id = alphabet.index_of("u0020")
    except KeyError:
        space_id = -1
    if use_wlm and space_id < 0:
        raise ValueError(
            "word_lm fusion needs the space token u0020 in the alphabet"
        )

    def _trailing_word(prefix: Tuple[int, ...]) -> str:
        """utf8 of the tokens after the last space (may be '')."""
        j = len(prefix)
        while j > 0 and prefix[j - 1] != space_id:
            j -= 1
        return uxxxx_to_utf8(
            " ".join(alphabet.token_of(i) for i in prefix[j:])
        )

    beams: Dict[Tuple[int, ...], _Beam] = {
        (): _Beam(p_b=0.0, p_nb=NEG_INF, lm_state=lm_start, lm_logp=0.0,
                  wlm_state=wlm_start)
    }

    if topk_vals is None or topk_ids is None:
        k = min(config.topk, log_probs.shape[1] - 1)
        ids_sorted = np.argsort(-log_probs[:, 1:], axis=1)[:, :k] + 1
        topk_ids = ids_sorted.astype(np.int32)
        topk_vals = np.take_along_axis(log_probs, topk_ids, axis=1)

    # Frame-invariant helpers, hoisted out of the per-frame loop (the
    # host oracle's hot path — advisor r4): ``get`` takes the current
    # frame's accumulator map explicitly.
    def get(prefix, src: _Beam, next_beams) -> _Beam:
        b = next_beams.get(prefix)
        if b is None:
            b = _Beam(lm_state=src.lm_state, lm_logp=src.lm_logp,
                      lex_node=src.lex_node, wlm_state=src.wlm_state,
                      wlm_logp=src.wlm_logp, wlm_words=src.wlm_words,
                      lex_bonus=src.lex_bonus, lex_wlen=src.lex_wlen)
            next_beams[prefix] = b
        return b

    def lex_step(node, wlen, c):
        """(allowed, new_node, penalty, completes_unk) for emitting
        class ``c`` from trie state ``node`` with ``wlen`` chars in
        the word so far — the unk-bypass transition rule shared
        (string-exactly) with the dense device tables and the C++
        engine. Max-parse determinization of the union FST: stay on
        the trie for free while possible; falling off retroactively
        charges the whole fragment at ``unk_pen``/char."""
        if c == space_id:
            if node == UNK:
                return True, 0, 0.0, True  # unk word completes
            if lexicon.allows(node, c):
                return True, 0, 0.0, False  # in-lexicon boundary
            if use_unk:  # mid-word: reparse the fragment as unk
                return True, 0, unk_pen * wlen, True
            return False, 0, 0.0, False
        if node == UNK:
            return (use_unk, UNK, unk_pen, False)
        if lexicon.allows(node, c):
            return True, lexicon.next_node(node, c), 0.0, False
        if use_unk:
            return True, UNK, unk_pen * (wlen + 1), False
        return False, 0, 0.0, False

    for t in range(T):
        p_blank = float(log_probs[t, 0])
        frame_best = max(float(topk_vals[t, 0]), p_blank)
        next_beams: Dict[Tuple[int, ...], _Beam] = {}

        for prefix, beam in beams.items():
            p_total = beam.total()

            # blank extends the same prefix (never pruned: dropping it
            # forfeits the beam's continuation mass for no real savings)
            nb = get(prefix, beam, next_beams)
            nb.p_b = _logaddexp(nb.p_b, p_total + p_blank)

            for j in range(topk_ids.shape[1]):
                c = int(topk_ids[t, j])
                p_c = float(topk_vals[t, j])
                if c == 0 or p_c < frame_best + config.prune_logp:
                    continue
                last = prefix[-1] if prefix else -1
                if c == last:
                    # repeated symbol, no blank between: same prefix —
                    # NEVER lexicon-gated (the prefix does not grow)
                    nb = get(prefix, beam, next_beams)
                    nb.p_nb = _logaddexp(nb.p_nb, beam.p_nb + p_c)
                    # blank-separated repeat: extended prefix from p_b only
                    ext = prefix + (c,)
                    src_p = beam.p_b
                else:
                    ext = prefix + (c,)
                    src_p = p_total
                if src_p == NEG_INF:
                    continue
                unk_complete = False
                lex_node, lex_pen = 0, 0.0
                if lexicon is not None:
                    allowed, lex_node, lex_pen, unk_complete = lex_step(
                        beam.lex_node, beam.lex_wlen, c)
                    if not allowed:
                        continue  # extension would leave the lexicon
                eb = next_beams.get(ext)
                if eb is None:
                    lm_state, lm_logp = beam.lm_state, beam.lm_logp
                    if use_lm:
                        tok = alphabet.token_of(c)
                        lp, lm_state = lm.score(beam.lm_state, tok)
                        lm_logp = beam.lm_logp + lp
                    wlm_state = beam.wlm_state
                    wlm_logp, wlm_words = beam.wlm_logp, beam.wlm_words
                    if use_wlm and c == space_id:
                        if unk_complete:
                            # unk words are transparent to the word LM:
                            # the shared <unk> constant, context unmoved
                            wlm_logp = beam.wlm_logp + w_unk
                            wlm_words = beam.wlm_words + 1
                        else:
                            word = _trailing_word(prefix)
                            if word:  # consecutive spaces score nothing
                                wlp, wlm_state = word_lm.score(
                                    beam.wlm_state, word)
                                wlm_logp = beam.wlm_logp + wlp
                                wlm_words = beam.wlm_words + 1
                    eb = _Beam(lm_state=lm_state, lm_logp=lm_logp,
                               lex_node=lex_node, wlm_state=wlm_state,
                               wlm_logp=wlm_logp, wlm_words=wlm_words,
                               lex_bonus=beam.lex_bonus + lex_pen,
                               lex_wlen=(0 if c == space_id
                                         else beam.lex_wlen + 1))
                    next_beams[ext] = eb
                eb.p_nb = _logaddexp(eb.p_nb, src_p + p_c)

        # prune to beam width by fused score (the trailing incomplete
        # word is unscored until it completes — standard word-LM fusion)
        def fused(item):
            prefix, b = item
            s = b.total() + b.lex_bonus
            if use_lm:
                s += config.lm_alpha * b.lm_logp + config.lm_beta * len(prefix)
            if use_wlm:
                s += (config.word_lm_alpha * b.wlm_logp
                      + config.word_lm_beta * b.wlm_words)
            return s

        ranked = sorted(next_beams.items(), key=fused, reverse=True)
        beams = dict(ranked[: config.beam_width])

    def final_score(prefix, b: _Beam) -> float:
        s = b.total() + b.lex_bonus
        if use_lm:
            s += config.lm_alpha * b.lm_logp + config.lm_beta * len(prefix)
        trailing_unk = b.lex_node == UNK
        if use_unk and b.lex_node != UNK and not lexicon.at_boundary(
                b.lex_node):
            # mid-word trie final: reparse the fragment as an unk word
            s += unk_pen * b.lex_wlen
            trailing_unk = True
        if use_wlm:
            wlm_logp, wlm_words = b.wlm_logp, b.wlm_words
            word = _trailing_word(prefix)
            if word:  # score the final (uncompleted-by-space) word
                wlp = (w_unk if trailing_unk
                       else word_lm.score(b.wlm_state, word)[0])
                wlm_logp += wlp
                wlm_words += 1
            s += (config.word_lm_alpha * wlm_logp
                  + config.word_lm_beta * wlm_words)
        return s

    items = beams.items()
    if lexicon is not None and not use_unk:
        # (with the unk bypass every final is representable — mid-word
        # fragments reparse as penalized unk words in final_score)
        complete = [
            (p, b) for p, b in items if lexicon.at_boundary(b.lex_node)
        ]
        if complete:  # drop mid-word finals unless nothing survives
            items = complete
    out = sorted(
        ((alphabet.decode(prefix), final_score(prefix, b)) for prefix, b in items),
        key=lambda x: x[1],
        reverse=True,
    )
    return out


def beam_decode(
    log_probs,  # [B, T, K] torch tensor or numpy array
    frame_mask,  # [B, T]
    alphabet: Alphabet,
    config: BeamConfig = BeamConfig(),
    lm=None,  # ArpaLM (python path) | NativeLM (C++ path) | None
    valid: Optional[np.ndarray] = None,
    precomputed_topk=None,  # (vals, ids) from beam_topk, for two-phase callers
    lexicon=None,  # Lexicon: hard vocabulary constraint
    word_lm=None,  # ArpaLM over utf8 words
    nbest: int = 1,  # > 1: return ranked (uxxxx, score) lists per line
) -> List:
    """Batch beam decode -> best uxxxx hypothesis per valid sample.
    Device does log-probs + top-k; host expands — through the C++ engine
    when it is built and the LM (if any) is a NativeLM, else pure Python.

    ``precomputed_topk`` lets a caller dispatch beam_topk for MANY batches
    up front (device work pipelines asynchronously) and run the host
    expansion afterwards — see infer.run_inference / serve.ocr_lines."""
    if precomputed_topk is not None:
        vals, ids = precomputed_topk
    else:
        if not isinstance(log_probs, torch.Tensor):
            log_probs = torch.from_numpy(np.asarray(log_probs))
        vals, ids = beam_topk(log_probs, min(config.topk, log_probs.shape[-1]))
    lp = _host(log_probs)
    vals = _host(vals)
    ids = _host(ids)
    frames = _host(frame_mask).sum(axis=1).astype(np.int32)

    from . import native_binding as nb

    # The C++ engine now shares the dense-table lexicon/word-LM
    # semantics; it handles every combination except a PYTHON char LM
    # (use NativeLM), a word LM beyond bigram (dense table bound), or a
    # word LM WITHOUT a lexicon (the dense word table is keyed by lexicon
    # word ids — the C ABI has no open-vocabulary word path, so that
    # combination must run the Python expansion or it would be silently
    # dropped; ADVICE r3 high).
    from .lm import DENSE_WORD_CAP

    use_native = (
        nb.available()
        and nbest <= 1  # the C ABI returns the best prefix only
        and (lm is None or isinstance(lm, nb.NativeLM))
        and (word_lm is None or getattr(word_lm, "order", 99) <= 2)
        and (word_lm is None or config.word_lm_alpha == 0.0
             or lexicon is not None)
        # the C ABI takes the DENSE [V+1, V] word table; past the cap
        # (V^2 host RAM: 2.5 GiB at 25k) the Python expansion's dict
        # lookups are the host engine (round 5; the device hashed path
        # is the production route at this scale)
        and (word_lm is None or config.word_lm_alpha == 0.0
             or lexicon is None
             or len(lexicon.words) <= DENSE_WORD_CAP)
    )
    if not use_native and lm is not None and not hasattr(lm, "score"):
        raise TypeError(
            "this decode configuration runs the Python expansion (native "
            "engine unavailable or combination unsupported); pass an "
            "ArpaLM (decode.lm.ArpaLM.read_arpa), not the native C++ LM "
            "handle"
        )
    if use_native:
        all_ids, _ = nb.beam_decode_batch_native(
            lp, frames, ids, vals,
            lm=lm,
            lm_alpha=config.lm_alpha if lm is not None else 0.0,
            lm_beta=config.lm_beta,
            beam_width=config.beam_width,
            prune_logp=config.prune_logp,
            max_out=lp.shape[1],
            lexicon=lexicon,
            word_lm=word_lm,
            word_lm_alpha=config.word_lm_alpha,
            word_lm_beta=config.word_lm_beta,
            lex_unk_logp=config.lex_unk_logp,
        )
        return [
            alphabet.decode(all_ids[b])
            for b in range(lp.shape[0])
            if valid is None or valid[b]
        ]

    out = []
    for b in range(lp.shape[0]):
        if valid is not None and not valid[b]:
            continue
        Tb = int(frames[b])
        hyps = prefix_beam_search(
            lp[b, :Tb], alphabet, config, lm=lm,
            topk_vals=vals[b, :Tb], topk_ids=ids[b, :Tb],
            lexicon=lexicon, word_lm=word_lm,
        )
        if nbest > 1:
            out.append(hyps[:nbest])
        else:
            out.append(hyps[0][0] if hyps else "")
    return out


def load_lm(path: str, alphabet: Alphabet):
    """ARPA LM handle for beam_decode: the C++ scorer when the native lib
    is built, else the Python ArpaLM."""
    from . import native_binding as nb

    if nb.available():
        return nb.NativeLM(path, alphabet.tokens)
    return ArpaLM.read_arpa(path)
