"""CTC prefix beam search on the device, vectorized over the batch.

Counterpart of ``vistaocr_tpu/decode/device_beam.py:1-959``, function for
function and in the same order of float operations: every line of a batch
decodes in parallel, beam state is ``[B, W]`` tensors on the log-probs'
device, and only the packed ``[B, T+1]`` winner row (or the ``[B, W, T]``
rows of every beam, for two-pass LM rescoring and n-best) leaves it.

The algorithm (the host ``prefix_beam_search``'s, vectorized): each slot
holds a prefix as two 32-bit rolling hashes, its last token and its
blank / non-blank log masses; a frame offers each slot one "stay"
candidate and ``k`` "extend" candidates (the frame's top-k symbols,
pruned against the frame's best), merges an extension into the slot that
already holds the same prefix (a hash-pair comparison), keeps the ``W``
best of the ``W * (k+1)`` pool and records (parent slot, token) so a
backtrace rebuilds the prefixes. The fused variants carry more state per
slot: the char LM's context (dense order 2/3, hashed order 4), the trie
node of a lexicon (hard, or with the ``<unk>`` bypass), and the word LM's
context (dense bigram, hashed bigram or trigram). The module docstring of
the JAX file gives the reasons for each choice.

What differs from JAX, and why:

- ``jax.lax.top_k`` puts the lower index first among equal values;
  ``torch.topk`` promises no order. The candidate pool holds ``W * k``
  ``-inf`` entries in most frames, so the order among ties decides
  ``parents``, ``tokens`` and the dead slots' hashes. Both top-k's here
  are ``torch.sort(descending=True, stable=True)``, which keeps JAX's
  order.
- The hashes are uint32 arithmetic in JAX. Here they are int64 tensors
  holding values below 2**32, with every product taken modulo 2**32 in
  16-bit halves (``_mul32``) where it could pass 2**63, and every sum
  masked. The open-addressed probes (word bigram, word context, word
  trigram, order-4 char LM) replay ``decode/lm.py``'s placement
  ``(key * 2654435761 mod 2**32) >> shift`` bit for bit; their keys are
  held as int64 too.
- ``jax.lax.scan`` is a Python loop over frames. Eager on a card that is
  ``T`` times a frame's hundred-odd small launches, so on a CUDA tensor
  ``BeamProgram`` runs the whole search and backtrace as one
  ``torch.cuda.CUDAGraph`` per (log-prob shape, table shapes), captured
  on first use and replayed after; a failed capture or replay raises,
  and nothing falls back to eager. On a CPU tensor it runs eagerly.
- Every gather index lies in range by construction (the JAX clamps are
  kept), so no gather depends on an out-of-bounds mode.

Host side (numpy, as in JAX): ``backtrace`` (the oracle of
``device_backtrace``), ``lm_prefix_logp``, ``device_beam_nbest`` and
``device_beam_decode`` (two-pass rescoring of the ``W`` finals).

Counters: ``GRAPH_CAPTURES`` (one per captured graph) and
``GRAPH_REPLAYS`` (one per replay: one per batch on the card).
"""

from __future__ import annotations

import functools
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..text import Alphabet
from .beam import BeamConfig

# Independent odd multipliers for the two rolling prefix hashes.
_M1 = 1000003
_M2 = 2654435761
_SEED1 = 0x9E3779B9
_SEED2 = 0x85EBCA6B
_M3 = 0x27D4EB2F  # the second hash's token multiplier
_PROBE_MUL = 2654435761  # open-addressing placement (decode/lm.py)
_U32 = 0xFFFFFFFF

GRAPH_CAPTURES = 0
GRAPH_REPLAYS = 0


def _mul32(a: torch.Tensor, m: int, reduce: bool = True) -> torch.Tensor:
    """``(a * m) mod 2**32`` for int64 ``a`` in [0, 2**32) and ``m`` below
    2**32, from ``m``'s two 16-bit halves, so no partial product reaches
    2**49; ``reduce=False`` leaves out the final mask (a value below 2**49
    congruent to it)."""
    x = a * (m & 0xFFFF) + (((a * (m >> 16)) & 0xFFFF) << 16)
    return x & _U32 if reduce else x


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float (JAX's jnp.float32
    constants)."""
    return float(np.float32(x))


def _probe(key, keys, probes: int):
    """Linear-probe slots of ``key`` (int64, below 2**32) in an
    open-addressed table of size ``len(keys)`` (a power of two): yields
    (slot, hit-before-masking) for j < probes."""
    S = keys.shape[0]
    shift = 32 - (S.bit_length() - 1)
    idx = _mul32(key, _PROBE_MUL) >> shift
    for j in range(probes):
        slot = (idx + j) & (S - 1)
        yield slot, torch.take(keys, slot) == key


def _word_logp_gather(
    wprev, wid, *,
    word_table=None,      # dense [Vw+1, Vw] f32 (V <= DENSE_WORD_CAP)
    word_uni=None,        # hashed form: [Vw] f32 unigram logp
    word_bo=None,         # [Vw+1] f32 Katz backoff weight per context
    word_hash_keys=None,  # [S] int64 packed (prev * Vw + word) keys
    word_hash_vals=None,  # [S] f32 exact observed-bigram logp
    word_probes=0,        # max probe length
    wprev2=None,          # prev-prev word (Vw+1 = none)
    word_ctx_keys=None,   # [Sc] int64 packed (prev2*(Vw+1)+prev1) keys
    word_ctx_ids=None,    # [Sc] int64 trigram context id (-1 = bo only)
    word_ctx_bo=None,     # [Sc] f32 Katz bo(prev2, prev1)
    word_ctx_probes=0,
    word_tri_keys=None,   # [St] int64 packed (ctx_id * Vw + word) keys
    word_tri_vals=None,   # [St] f32 exact observed-trigram logp
    word_tri_probes=0,
):
    """log P(word wid | word context) for equal-shaped int64 tensors, from
    any device representation (``decode/lm.device_word_tables``): one
    gather from the dense bigram table, an open-addressed bigram probe
    with the Katz fallback ``bo[prev] + uni[word]``, or, with the
    ``word_ctx_*``/``word_tri_*`` tables and ``wprev2``, the order-3
    refinement ``ctx hit ? (tri hit ? tri_val : ctx_bo + s2) : s2``.
    ``wid`` must already be clamped to >= 0."""
    if word_table is not None:
        Vw = word_table.shape[1]
        return torch.take(word_table, wprev * Vw + wid)
    Vw = word_uni.shape[0]
    key = (wprev * Vw + wid) & _U32
    val = torch.take(word_bo, wprev) + torch.take(word_uni, wid)
    found = torch.zeros_like(key, dtype=torch.bool)
    for slot, eq in _probe(key, word_hash_keys, word_probes):
        hit = eq & ~found
        val = torch.where(hit, torch.take(word_hash_vals, slot), val)
        found = found | hit
    if word_ctx_keys is None or wprev2 is None:
        return val
    # trigram refinement: a valid 2-word history probes the context
    # table; the NONE sentinel (Vw + 1) is clamped for the key but gates
    # every hit, so short histories stay on the bigram score.
    valid2 = wprev2 <= Vw
    ckey = (torch.clamp(wprev2, max=Vw) * (Vw + 1) + wprev) & _U32
    cid = torch.full_like(ckey, -1)
    cbo = torch.zeros_like(val)
    cfound = torch.zeros_like(found)
    for slot, eq in _probe(ckey, word_ctx_keys, word_ctx_probes):
        hit = eq & ~cfound & valid2
        cid = torch.where(hit, torch.take(word_ctx_ids, slot), cid)
        cbo = torch.where(hit, torch.take(word_ctx_bo, slot), cbo)
        cfound = cfound | hit
    tkey = (torch.clamp(cid, min=0) * Vw + wid) & _U32
    tval = torch.zeros_like(val)
    tfound = torch.zeros_like(found)
    for slot, eq in _probe(tkey, word_tri_keys, word_tri_probes):
        hit = eq & ~tfound & (cid >= 0)
        tval = torch.where(hit, torch.take(word_tri_vals, slot), tval)
        tfound = tfound | hit
    # miss everywhere: cbo = 0, tfound = False -> exactly s2
    return torch.where(tfound, tval, cbo + val)


def _topk_stable(x: torch.Tensor, k: int):
    """The k largest along the last axis, the lower index first among
    equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_scan(
    log_probs: torch.Tensor,  # [B, T, K] f32
    frame_mask: torch.Tensor,  # [B, T] bool
    *,
    beam_width: int,
    topk: int,
    prune_logp: float,
    **kw,
):
    """The search (the JAX ``beam_scan``, with its keywords: the char LM's
    ``lm_table`` [K+1, K] or [K+1, K+1, K] with ``lm_alpha``/``lm_beta``
    and, for order 4, ``lm_hash_keys``/``lm_hash_vals``/``lm_rows``/
    ``lm_probes``; the lexicon's ``lex_next`` with ``lex_unk_logp``; the
    word LM's ``word_table`` or hashed ``word_uni``/``word_bo``/
    ``word_hash_*``/``word_ctx_*``/``word_tri_*`` tables with their probe
    lengths, ``word_ids``, ``space_id``, ``word_alpha``, ``word_beta`` and
    ``word_unk_logp``). Returns (totals [B, W] f32, parents [T, B, W]
    int32, tokens [T, B, W] int32; token 0 = none), or, when a char LM,
    lexicon or word LM is fused, (totals, extras, parents, tokens) with
    extras holding the slots' final "bonus" (LM, unk and word-LM terms),
    "lex" (trie node), "wlen", "wprev", "wprev2" as the variant has
    them. Table tensors must lie on the log-probs' device; integer tables
    may be any integer type."""
    totals, extras, parents, tokens = _search(
        log_probs, frame_mask, beam_width=beam_width, topk=topk,
        prune_logp=prune_logp, **kw)
    parents, tokens = parents.to(torch.int32), tokens.to(torch.int32)
    if extras is None:
        return totals, parents, tokens
    return totals, extras, parents, tokens


def _search(
    log_probs, frame_mask, *, beam_width, topk, prune_logp,
    lm_table=None, lm_alpha=0.0, lm_beta=0.0, lm_hash_keys=None,
    lm_hash_vals=None, lm_rows=None, lm_probes=0,
    lex_next=None, lex_unk_logp=0.0, word_unk_logp=0.0,
    word_table=None, word_uni=None, word_bo=None, word_hash_keys=None,
    word_hash_vals=None, word_probes=0, word_ctx_keys=None,
    word_ctx_ids=None, word_ctx_bo=None, word_ctx_probes=0,
    word_tri_keys=None, word_tri_vals=None, word_tri_probes=0,
    word_ids=None, space_id=-1, word_alpha=0.0, word_beta=0.0,
):
    """``beam_scan`` with int64 ``parents``/``tokens`` and ``extras`` None
    when nothing is fused.

    Layout, chosen to keep a frame's launches few (each is a small kernel
    on [B, W * (k+1)] values, so their count sets the time): the pool of a
    frame is two buffers, ``ipool`` [B, rows, W + W*k] int64 and ``fpool``
    [B, NF, W + W*k] f32, whose first W columns are the stay candidates
    and the rest the extensions, one row per state (hashes, last token,
    the LM / trie / word context, then the parent slot and the emitted
    token). The integer state lives in ``ipool``'s stay columns (a stay
    candidate keeps its slot's integers), the masses and bonus in
    ``fstate``. A frame computes each extension row straight into its
    place, ranks the pool, gathers every row with one ``gather`` a buffer
    and keeps the old state of lines whose frame is masked with one
    ``where`` a buffer. The float operations are JAX's, in its order."""
    B, T, K = log_probs.shape
    W = beam_width
    k = min(topk, K - 1)
    Wk = W * k
    dev = log_probs.device
    neg = float("-inf")
    use_lm = lm_table is not None
    use_lex = lex_next is not None
    use_wlm = word_table is not None or word_uni is not None
    use_lm4 = lm_hash_keys is not None
    if use_lm4:
        if not use_lm or lm_table.dim() != 3:
            raise ValueError(
                "order-4 hashed fusion needs the order-3 dense table as "
                "lm_table (the fallback); pass hashed_logp_table()['t3']"
            )
        if lm_hash_vals is None or lm_rows is None or lm_probes < 1:
            raise ValueError(
                "order-4 fusion needs lm_hash_keys + lm_hash_vals + "
                "lm_rows + lm_probes >= 1"
            )
    if use_wlm:
        if not use_lex or word_ids is None or space_id < 0:
            raise ValueError(
                "device word fusion needs lex_next + word_ids + space_id"
            )
        Vw = (word_table.shape[1] if word_table is not None
              else word_uni.shape[0])
        word_kw = dict(
            word_table=word_table, word_uni=word_uni, word_bo=word_bo,
            word_hash_keys=word_hash_keys, word_hash_vals=word_hash_vals,
            word_probes=word_probes,
            word_ctx_keys=word_ctx_keys, word_ctx_ids=word_ctx_ids,
            word_ctx_bo=word_ctx_bo, word_ctx_probes=word_ctx_probes,
            word_tri_keys=word_tri_keys, word_tri_vals=word_tri_vals,
            word_tri_probes=word_tri_probes,
        )
    use_wlm3 = use_wlm and word_ctx_keys is not None
    use_unk = use_lex and lex_unk_logp != 0.0
    if lex_unk_logp > 0.0:  # a positive value would be an OOV *bonus*
        raise ValueError(
            f"lex_unk_logp must be <= 0; got {lex_unk_logp}")
    fused = use_lm or use_wlm or use_unk
    if use_unk:
        U_NODE = lex_next.shape[0] - 1
        UNKP = _f32(lex_unk_logp)
        # the <unk> completion's word score, f32 as in JAX
        WUNK_ADD = _f32(np.float32(word_alpha) * np.float32(word_unk_logp)
                        + np.float32(word_beta))
    trigram = use_lm and lm_table.dim() == 3
    if use_lm:
        alpha, beta = _f32(lm_alpha), _f32(lm_beta)
    if use_wlm:
        walpha, wbeta = _f32(word_alpha), _f32(word_beta)

    # Per-frame symbol candidates: top-k over non-blank classes (ids >= 1),
    # and every frame's pruning rule and hash increments, all frames at
    # once.
    lp = log_probs.float()
    vals, ids = _topk_stable(lp[..., 1:], k)
    vals_t = vals.transpose(0, 1)  # [T, B, k]
    ids_t = (ids + 1).transpose(0, 1)
    pblank_t = lp[..., 0].transpose(0, 1)  # [T, B]
    mask_t = frame_mask.transpose(0, 1)  # [T, B]
    frame_best = torch.maximum(vals_t[..., 0], pblank_t)
    allowed_t = vals_t >= frame_best[..., None] + prune_logp  # [T, B, k]
    cu1_t = ids_t + 1
    cu2_t = _mul32(cu1_t, _M3)

    # the integer rows of the pool
    rows = ["h1", "h2", "last"]
    if use_lm:
        rows += ["lmp", "lml"] + (["lmp2"] if use_lm4 else [])
    if use_lex:
        rows.append("lex")
    if use_unk:
        rows.append("wlen")
    if use_wlm:
        rows += ["wprev"] + (["wprev2"] if use_wlm3 else [])
    NI = len(rows)
    r = {name: j for j, name in enumerate(rows + ["parent", "token"])}
    iota_w = torch.arange(W, dtype=torch.int64, device=dev)
    ipool = torch.empty((B, NI + 2, W + Wk), dtype=torch.int64, device=dev)
    ist = ipool[:, :NI, :W]  # the integer state: the stay candidates
    # Slot 0 = empty prefix (P(blank-ending) = 1); slots 1.. inactive with
    # distinct hash pairs so they can never merge with live prefixes.
    ipool[:, r["h1"], :W] = torch.where(iota_w == 0, _SEED1, iota_w)
    ipool[:, r["h2"], :W] = torch.where(iota_w == 0, _SEED2, iota_w + 7777)
    ipool[:, r["last"], :W] = -1
    if use_lm:
        # LM context (lmp2, lmp, lml): the three most recent emitted class
        # ids (0 = none, K = <s>); start state is the oracle's (<s>,).
        ipool[:, r["lmp"], :W] = 0
        ipool[:, r["lml"], :W] = K
        if use_lm4:
            ipool[:, r["lmp2"], :W] = 0
    if use_lex:
        ipool[:, r["lex"], :W] = 0  # trie root
    if use_unk:
        ipool[:, r["wlen"], :W] = 0
    if use_wlm:
        ipool[:, r["wprev"], :W] = Vw  # <s>
        if use_wlm3:
            ipool[:, r["wprev2"], :W] = Vw + 1  # none
    ipool[:, r["parent"], :W] = iota_w
    ipool[:, r["parent"], W:] = iota_w.repeat_interleave(k)
    ipool[:, r["token"], :W] = 0

    def ext(name):
        """The extension columns of an integer row, as [B, W, k]."""
        return ipool[:, r[name], W:].unflatten(1, (W, k))

    NF = 3 if fused else 2
    fstate = torch.empty((B, NF, W), device=dev)  # p_b, p_nb, bonus
    fstate[:, 0] = torch.where(iota_w == 0, 0.0, neg)
    fstate[:, 1] = neg
    if fused:
        fstate[:, 2] = 0.0
    fpool = torch.empty((B, NF, W + Wk), device=dev)
    fpool[:, 0, W:] = neg  # an extension ends in a non-blank
    parents = torch.empty((T, B, W), dtype=torch.int64, device=dev)
    tokens = torch.empty((T, B, W), dtype=torch.int64, device=dev)
    # the scalars of the where's that write into place (out= takes tensors)
    neg_t = torch.full((), neg, device=dev)
    zero_t = torch.zeros((), dtype=torch.int64, device=dev)

    for t in range(T):
        v, i, pb, al = vals_t[t], ids_t[t], pblank_t[t], allowed_t[t]
        h1, h2, last = (ist[:, r[n]] for n in ("h1", "h2", "last"))
        p_b, p_nb = fstate[:, 0], fstate[:, 1]
        p_tot = torch.logaddexp(p_b, p_nb)
        # stay candidates: blank extension + same-symbol repeat mass.
        torch.add(p_tot, pb[:, None], out=fpool[:, 0, :W])
        c = i[:, None, :].expand(B, W, k)
        is_rep = c == last[:, :, None]
        rep = torch.where(is_rep & al[:, None, :], v[:, None, :],
                          neg).amax(dim=-1)
        stay_pnb = p_nb + rep
        # extend candidates [B, W, k]: prefix + c. A repeat symbol extends
        # from the blank-ending mass only (blank-separated repeat).
        src = torch.where(is_rep, p_b[:, :, None], p_tot[:, :, None])
        ext_pnb = torch.where(al[:, None, :], src + v[:, None, :], neg)
        # h1 * M1 stays below 2**52: no reduction needed before the add
        torch.bitwise_and((h1 * _M1)[:, :, None] + cu1_t[t][:, None, :],
                          _U32, out=ext("h1"))
        torch.bitwise_and(_mul32(h2, _M2, reduce=False)[:, :, None]
                          + cu2_t[t][:, None, :], _U32, out=ext("h2"))
        ext("last").copy_(c)
        ext("token").copy_(c)
        if use_lm:
            lmp, lml = ist[:, r["lmp"]], ist[:, r["lml"]]
            # log P(c | slot context), gathered straight from the table
            ctx = lmp * (K + 1) + lml if trigram else lml  # [B, W]
            q = torch.take(lm_table, (ctx * K)[:, :, None] + c)  # [B, W, k]
            if use_lm4:
                # one probe sequence per slot; misses (incl. short
                # histories, whose keys are never stored) keep the exact
                # trigram fallback row
                lmp2 = ist[:, r["lmp2"]]
                key = (lmp2 * (K + 1) + lmp) * (K + 1) + lml
                row = torch.full_like(key, -1)
                for slot, eq in _probe(key, lm_hash_keys, lm_probes):
                    row = torch.where(eq & (row < 0),
                                      torch.take(lm_hash_vals, slot), row)
                q4 = torch.take(
                    lm_rows, (torch.clamp(row, min=0) * K)[:, :, None] + c)
                q = torch.where((row >= 0)[:, :, None], q4, q)
                # extend shifts (lmp2, lmp, lml) <- (lmp, lml, c)
                ext("lmp2").copy_(lmp[:, :, None].expand(B, W, k))
            ext("lmp").copy_(lml[:, :, None].expand(B, W, k))
            ext("lml").copy_(c)
            ext_bonus = fstate[:, 2, :, None] + alpha * q + beta
        if use_lex:
            # trie transition per candidate: -1 kills the extension
            # (hard mode) or reroutes through the unk row (bypass mode)
            lex = ist[:, r["lex"]]
            nxt = torch.take(lex_next, (lex * lex_next.shape[1])[:, :, None]
                             + c)
            if use_unk:
                is_space = c == space_id
                dead = nxt < 0
                from_unk = (lex == U_NODE)[:, :, None]
                wlen = ist[:, r["wlen"]]
                wl = wlen[:, :, None].float()
                pen_char = torch.where(
                    from_unk, UNKP,
                    torch.where(dead, UNKP * (wl + 1.0), 0.0))
                lex_pen = torch.where(
                    is_space, torch.where(dead, UNKP * wl, 0.0), pen_char)
                completes_unk = is_space & (from_unk | dead)
                torch.where(dead, torch.where(is_space, 0, U_NODE), nxt,
                            out=ext("lex"))
                torch.where(is_space, zero_t, wlen[:, :, None] + 1,
                            out=ext("wlen"))
                # unk penalties rank beams even without a char LM
                ext_bonus = (ext_bonus + lex_pen if use_lm
                             else fstate[:, 2, :, None] + lex_pen)
            else:
                ext_pnb = torch.where(nxt >= 0, ext_pnb, neg)
                torch.clamp(nxt, min=0, out=ext("lex"))
        if use_wlm:
            # a space from a word-final node completes word_ids[node]
            wprev = ist[:, r["wprev"]]
            wid = torch.take(word_ids, ist[:, r["lex"]])  # [B, W]
            wid0 = torch.clamp(wid, min=0)
            completes = (c == space_id) & (wid[:, :, None] >= 0)
            wlp = _word_logp_gather(
                wprev, wid0,
                wprev2=ist[:, r["wprev2"]] if use_wlm3 else None,
                **word_kw)  # [B, W]
            w_add = torch.where(
                completes, walpha * wlp[:, :, None] + wbeta, 0.0)
            if use_unk:
                # unk completions score the shared <unk> constant; the
                # word context stays unmoved (unk words transparent)
                w_add = w_add + torch.where(completes_unk, WUNK_ADD, 0.0)
            ext_bonus = (ext_bonus + w_add if use_lm or use_unk
                         else fstate[:, 2, :, None] + w_add)
            torch.where(completes, wid0[:, :, None], wprev[:, :, None],
                        out=ext("wprev"))
            if use_wlm3:
                # completion shifts (prev2, prev1) <- (prev1, word)
                torch.where(completes, wprev[:, :, None],
                            ist[:, r["wprev2"], :, None], out=ext("wprev2"))
        if fused:
            fpool[:, 2, :W].copy_(fstate[:, 2])
            fpool[:, 2, W:].unflatten(1, (W, k)).copy_(ext_bonus)

        # merge: an extend candidate ext(p, c) coincides with a slot
        # already holding p+c (and with nothing else): at most one match
        # per side, so the merge is a masked max + one log-add-exp.
        eh1, eh2 = ipool[:, r["h1"], W:], ipool[:, r["h2"], W:]
        epnb = ext_pnb.reshape(B, Wk)
        m_ext = ((eh1[:, :, None] == h1[:, None, :])
                 & (eh2[:, :, None] == h2[:, None, :]))  # [B, W*k, W]
        into_stay = torch.where(m_ext, epnb[:, :, None], neg).amax(dim=1)
        torch.logaddexp(stay_pnb, into_stay, out=fpool[:, 1, :W])
        torch.where(m_ext.any(dim=2), neg_t, epnb, out=fpool[:, 1, W:])
        total = torch.logaddexp(fpool[:, 0], fpool[:, 1])
        if fused:
            # rank/prune by the fused score; CTC masses stay pure
            total = total + fpool[:, 2]
        _, sel = _topk_stable(total, W)  # [B, W] pool positions

        gi = torch.gather(ipool, 2, sel[:, None, :].expand(B, NI + 2, W))
        gf = torch.gather(fpool, 2, sel[:, None, :].expand(B, NF, W))
        # invalid frames are identity: state passes through, nothing emits
        m = mask_t[t]
        torch.where(m[:, None, None], gi[:, :NI], ist, out=ist)
        torch.where(m[:, None, None], gf, fstate, out=fstate)
        torch.where(m[:, None], gi[:, NI], iota_w, out=parents[t])
        torch.where(m[:, None], gi[:, NI + 1], zero_t, out=tokens[t])

    totals = torch.logaddexp(fstate[:, 0], fstate[:, 1])
    if not (use_lm or use_lex or use_wlm):
        return totals, None, parents, tokens
    extras = {}
    if fused:
        extras["bonus"] = fstate[:, 2].contiguous()
    for name in ("lex", "wlen", "wprev", "wprev2"):
        if name in r and r[name] < NI:
            extras[name] = ist[:, r[name]].contiguous()
    return totals, extras, parents, tokens


def backtrace(
    parents: np.ndarray,  # [T, B, W]
    tokens: np.ndarray,  # [T, B, W]
) -> np.ndarray:
    """Every slot's emitted-token sequence: [T, B, W] int32 where entry t
    is the token slot w's prefix gained at frame t (0 = none); the numpy
    oracle of ``device_backtrace``."""
    T, B, W = parents.shape
    emitted = np.zeros((T, B, W), np.int32)
    cur = np.broadcast_to(np.arange(W, dtype=np.int64), (B, W)).copy()
    rows = np.arange(B)[:, None]
    for t in range(T - 1, -1, -1):
        emitted[t] = tokens[t][rows, cur]
        cur = parents[t][rows, cur]
    return emitted


def device_backtrace(parents: torch.Tensor,
                     tokens: torch.Tensor) -> torch.Tensor:
    """[T, B, W] parents/tokens -> emitted [T, B, W] int32 on their
    device: a reverse loop carrying each slot's current ancestor."""
    return _backtrace(parents.long(), tokens.long()).to(torch.int32)


def _backtrace(parents: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``device_backtrace`` on int64 parents/tokens, int64 out: two
    gathers a frame."""
    T, B, W = parents.shape
    cur = torch.arange(W, device=parents.device).expand(B, W)
    emitted = torch.empty_like(tokens)
    for t in range(T - 1, -1, -1):
        torch.gather(tokens[t], 1, cur, out=emitted[t])
        cur = torch.gather(parents[t], 1, cur)
    return emitted


def beam_scan_collapsed(
    log_probs: torch.Tensor,  # [B, T, K]
    frame_mask: torch.Tensor,  # [B, T]
    *,
    beam_width: int,
    topk: int,
    prune_logp: float,
    all_beams: bool = False,
    lm_table: Optional[torch.Tensor] = None,
    lm_alpha: float = 0.0,
    lm_beta: float = 0.0,
    lm_hash_keys: Optional[torch.Tensor] = None,
    lm_hash_vals: Optional[torch.Tensor] = None,
    lm_rows: Optional[torch.Tensor] = None,
    lm_probes: int = 0,
    lex_next: Optional[torch.Tensor] = None,
    lex_boundary: Optional[torch.Tensor] = None,  # [N] bool, with lex_next
    lex_unk_logp: float = 0.0,
    word_unk_logp: float = 0.0,
    word_table: Optional[torch.Tensor] = None,
    word_uni: Optional[torch.Tensor] = None,
    word_bo: Optional[torch.Tensor] = None,
    word_hash_keys: Optional[torch.Tensor] = None,
    word_hash_vals: Optional[torch.Tensor] = None,
    word_probes: int = 0,
    word_ctx_keys: Optional[torch.Tensor] = None,
    word_ctx_ids: Optional[torch.Tensor] = None,
    word_ctx_bo: Optional[torch.Tensor] = None,
    word_ctx_probes: int = 0,
    word_tri_keys: Optional[torch.Tensor] = None,
    word_tri_vals: Optional[torch.Tensor] = None,
    word_tri_probes: int = 0,
    word_ids: Optional[torch.Tensor] = None,
    space_id: int = -1,
    word_alpha: float = 0.0,
    word_beta: float = 0.0,
) -> Tuple[torch.Tensor, ...]:
    """``beam_scan`` + ``device_backtrace`` (the JAX function). Returns
    (totals [B, W], emitted): emitted is the best beam's [B, T] int32 row
    (the greedy wire format), or [B, W, T] with ``all_beams``. With a
    char LM or lexicon the winner is chosen by the fused score and comes
    back packed as [B, T+1] (the row plus round(winner's CTC total *
    1000)); with ``all_beams`` there the return is (totals, fused [B, W],
    emitted [B, W, T]). Selection prefers beams that end at a word
    boundary and falls back to all beams where none does; in that
    fallback the host oracle still word-scores the partial trailing word
    and this search does not (``word_ids`` is -1 mid-word), as in JAX."""
    use_wlm = word_table is not None or word_uni is not None
    if lm_table is not None or lex_next is not None:
        word_kw = dict(
            word_table=word_table, word_uni=word_uni, word_bo=word_bo,
            word_hash_keys=word_hash_keys, word_hash_vals=word_hash_vals,
            word_probes=word_probes,
            word_ctx_keys=word_ctx_keys, word_ctx_ids=word_ctx_ids,
            word_ctx_bo=word_ctx_bo, word_ctx_probes=word_ctx_probes,
            word_tri_keys=word_tri_keys, word_tri_vals=word_tri_vals,
            word_tri_probes=word_tri_probes,
        )
        totals, extras, parents, tokens = _search(
            log_probs, frame_mask, beam_width=beam_width, topk=topk,
            prune_logp=prune_logp, lm_table=lm_table, lm_alpha=lm_alpha,
            lm_beta=lm_beta, lm_hash_keys=lm_hash_keys,
            lm_hash_vals=lm_hash_vals, lm_rows=lm_rows,
            lm_probes=lm_probes, lex_next=lex_next,
            lex_unk_logp=lex_unk_logp, word_unk_logp=word_unk_logp,
            word_ids=word_ids, space_id=space_id, word_alpha=word_alpha,
            word_beta=word_beta, **word_kw,
        )
        emitted = _backtrace(parents, tokens).to(torch.int32)  # [T, B, W]
        fused = totals + extras["bonus"] if "bonus" in extras else totals
        if use_wlm:
            # the trailing (un-spaced) word, scored at selection as the
            # host oracle's final_score does: only word-final nodes carry
            # one (root = the line ended on a space)
            wid = torch.take(word_ids, extras["lex"])  # [B, W]
            wlp = _word_logp_gather(
                extras["wprev"], torch.clamp(wid, min=0),
                wprev2=extras.get("wprev2"), **word_kw)
            fused = fused + torch.where(
                wid >= 0, _f32(word_alpha) * wlp + _f32(word_beta), 0.0)
        if lex_next is not None:
            ok = torch.take(lex_boundary, extras["lex"])  # [B, W]
            if lex_unk_logp != 0.0:
                # unk bypass: no hard gating; a mid-word final reparses
                # its fragment as a penalized unk word
                wlen_f = extras["wlen"].float()
                fused = fused + torch.where(
                    ok, 0.0, _f32(lex_unk_logp) * wlen_f)
                if use_wlm:
                    at_unk = extras["lex"] == lex_next.shape[0] - 1
                    trailing_unk = at_unk | ~ok
                    fused = fused + torch.where(
                        trailing_unk,
                        _f32(np.float32(word_alpha)
                             * np.float32(word_unk_logp)
                             + np.float32(word_beta)),
                        0.0)
            else:
                gated = torch.where(ok, fused, float("-inf"))
                # a line with no boundary-ending beam falls back ungated
                fused = torch.where(ok.any(dim=1, keepdim=True), gated,
                                    fused)
        if all_beams:
            # constrained n-best: every slot's fused final score and its
            # emitted row
            return totals, fused, emitted.permute(1, 2, 0).contiguous()
        best = torch.argmax(fused, dim=1)  # [B]
        picked = _pick(emitted, best)
        sel_ctc = torch.gather(totals, 1, best[:, None])[:, 0]
        col = torch.round(
            torch.clamp(sel_ctc * 1000.0, -2.0e9, 0.0)).to(torch.int32)
        return totals, torch.cat([picked.transpose(0, 1), col[:, None]],
                                 dim=1)
    totals, _, parents, tokens = _search(
        log_probs, frame_mask, beam_width=beam_width, topk=topk,
        prune_logp=prune_logp,
    )
    emitted = _backtrace(parents, tokens).to(torch.int32)  # [T, B, W]
    if all_beams:
        return totals, emitted.permute(1, 2, 0).contiguous()
    picked = _pick(emitted, torch.argmax(totals, dim=1))
    return totals, picked.transpose(0, 1).contiguous()  # [B, T]


def _pick(emitted: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """[T, B, W] emitted rows -> [T, B]: each line's ``best`` slot."""
    index = best[None, :, None].expand(emitted.shape[0], -1, 1)
    return torch.gather(emitted, 2, index)[..., 0]


def _table(x, device) -> torch.Tensor:
    """A host table as a tensor on ``device``: integer arrays as int64
    (uint32 hash keys keep their values), floats as float32, bools as
    bool."""
    a = np.asarray(x)
    if a.dtype == np.bool_:
        t = torch.from_numpy(a.copy())
    elif np.issubdtype(a.dtype, np.integer):
        t = torch.from_numpy(a.astype(np.int64))
    else:
        t = torch.from_numpy(a.astype(np.float32))
    return t.to(device)


def device_tables(tables: dict, device) -> dict:
    """``beam_scan`` keyword tables from host arrays (the tables of
    ``decode/lm.py`` and ``decode/lexicon.py``) onto ``device``; ints and
    floats (probe lengths, weights, ids) pass through as Python
    numbers."""
    return {k: (v.item() if isinstance(v, np.generic)
                else v if isinstance(v, (int, float)) else _table(v, device))
            for k, v in tables.items()}


class _Graph:
    """One captured search: its static inputs, the graph and its static
    outputs."""

    def __init__(self, lp, fm, graph, outputs):
        self.lp, self.fm, self.graph, self.outputs = lp, fm, graph, outputs


class _Tables:
    """The program's own copy of one set of tables (the graphs read them
    at fixed addresses), and the caller's tensors it was last copied
    from, with their version counters."""

    def __init__(self, tensors: dict):
        self.static = {k: t.clone() for k, t in tensors.items()}
        self.source = dict(tensors)
        self.versions = {k: t._version for k, t in tensors.items()}

    def update(self, tensors: dict) -> None:
        """Copy the caller's tables in where they are other tensors than
        the last ones, or were written since."""
        if any(self.source[k] is not t or self.versions[k] != t._version
               for k, t in tensors.items()):
            for k, t in tensors.items():
                self.static[k].copy_(t)
            self.source = dict(tensors)
            self.versions = {k: t._version for k, t in tensors.items()}


class BeamProgram:
    """``beam_scan_collapsed`` for one configuration (the JAX
    ``_beam_scan_jit``): called as ``prog(log_probs, frame_mask,
    **tables)``. On a CPU tensor it runs eagerly. On a CUDA tensor it runs
    the whole search and backtrace as one CUDA graph per (log-prob shape,
    table shapes and static arguments), captured on first use after a
    short eager run on a side stream and then replayed: the log-probs and
    mask are copied into the graph's static inputs, the tables into the
    program's copy of them when the caller passes others than last time
    (so a graph serves every set of tables of its shapes), and the
    outputs come back as fresh tensors. ``graph=False`` names the eager
    form on a card (for tests and timing). A failed capture or replay
    raises."""

    def __init__(self, fn):
        self._fn = fn
        self._graphs: dict = {}
        self._tables: dict = {}
        self._lock = threading.Lock()

    @torch.inference_mode()
    def __call__(self, log_probs, frame_mask, *, graph: bool = True, **kw):
        if not log_probs.is_cuda or not graph:
            return self._fn(log_probs, frame_mask, **kw)
        global GRAPH_REPLAYS
        tensors = {k: v for k, v in kw.items()
                   if isinstance(v, torch.Tensor)}
        for name, t in tensors.items():
            if t.device != log_probs.device:
                raise ValueError(
                    f"table {name} on {t.device}, log-probs on "
                    f"{log_probs.device}")
        static = {k: v for k, v in kw.items() if k not in tensors}
        sig = (log_probs.device, tuple(sorted(static.items())),
               tuple(sorted((k, tuple(t.shape), t.dtype)
                            for k, t in tensors.items())))
        with self._lock:
            tables = self._tables.get(sig)
            if tables is None:
                tables = self._tables[sig] = _Tables(tensors)
            else:
                tables.update(tensors)
            key = (tuple(log_probs.shape), sig)
            g = self._graphs.get(key)
            if g is None:
                g = self._capture(log_probs, frame_mask,
                                  {**static, **tables.static})
                self._graphs[key] = g
            g.lp.copy_(log_probs)
            g.fm.copy_(frame_mask)
            g.graph.replay()
            GRAPH_REPLAYS += 1
            return tuple(o.clone() for o in g.outputs)

    def _capture(self, log_probs, frame_mask, kw) -> _Graph:
        global GRAPH_CAPTURES
        lp = torch.empty(log_probs.shape, dtype=torch.float32,
                         device=log_probs.device)
        fm = torch.empty(frame_mask.shape, dtype=torch.bool,
                         device=log_probs.device)
        lp.copy_(log_probs)
        fm.copy_(frame_mask)
        # library state (sort's scratch, handles) set up outside capture
        side = torch.cuda.Stream(device=log_probs.device)
        side.wait_stream(torch.cuda.current_stream(log_probs.device))
        with torch.cuda.stream(side):
            self._fn(lp[:, :2], fm[:, :2], **kw)
        torch.cuda.current_stream(log_probs.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: a batch producer or a host copy in another thread
        # (pinned allocations, copies, event waits) may run during the
        # capture; under the default "global" mode its calls would
        # invalidate the capture
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outputs = self._fn(lp, fm, **kw)
        GRAPH_CAPTURES += 1
        return _Graph(lp, fm, graph, outputs)


@functools.lru_cache(maxsize=None)
def _beam_scan_jit(beam_width: int, topk: int, prune_logp: float,
                   all_beams: bool, fused_lm: bool, lm_alpha: float,
                   lm_beta: float) -> BeamProgram:
    if fused_lm:
        # takes lm_table and/or lex_next + lex_boundary (+ word tables)
        # as call-time keywords
        return BeamProgram(functools.partial(
            beam_scan_collapsed, beam_width=beam_width, topk=topk,
            prune_logp=prune_logp, lm_alpha=lm_alpha, lm_beta=lm_beta,
            all_beams=all_beams))
    return BeamProgram(functools.partial(
        beam_scan_collapsed, beam_width=beam_width, topk=topk,
        prune_logp=prune_logp, all_beams=all_beams))


def beam_scan_program(config: BeamConfig, all_beams: bool = False,
                      fused_lm: bool = False) -> BeamProgram:
    """The ``BeamProgram`` of a config, one per process and config (its
    graphs are kept for the process's life). ``all_beams`` must be True
    when the finals will be two-pass LM-rescored; ``fused_lm`` returns a
    program taking ``(log_probs, frame_mask, lm_table=..., lex_next=...,
    ...)`` for fusion inside the search."""
    return _beam_scan_jit(config.beam_width, config.topk,
                          float(config.prune_logp), bool(all_beams),
                          bool(fused_lm), float(config.lm_alpha),
                          float(config.lm_beta))


def lm_prefix_logp(lm, alphabet: Alphabet, ids: Sequence[int]) -> float:
    """Cumulative LM log-prob of a decoded prefix, with the same
    <s>-rooted history as the interleaved oracle scoring."""
    if hasattr(lm, "score"):  # python ArpaLM
        state = lm.start_state()
        total = 0.0
        for i in ids:
            lp, state = lm.score(state, alphabet.token_of(int(i)))
            total += lp
        return total
    # NativeLM: stateless queries; -1 is the native <s> sentinel and the
    # C side truncates history to order-1.
    total = 0.0
    hist = [-1]
    for i in ids:
        total += lm.logp(hist, int(i))
        hist.append(int(i))
    return total


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def device_beam_nbest(
    alphabet: Alphabet,
    config: BeamConfig,
    precomputed,  # (totals, emitted [B,W,T]) or (totals, fused, emitted)
    lm=None,
    valid: Optional[np.ndarray] = None,
    nbest: int = 8,
) -> List[List[Tuple[str, float]]]:
    """N-best lists from an all-beams device search: per valid line, up to
    ``nbest`` (uxxxx, score) ranked by the fused score. A 2-tuple
    ``(totals, emitted)`` holds pure-CTC finals (with ``lm`` the W finals
    are rescored on the host); a 3-tuple ``(totals, fused, emitted)``
    from a fused all-beams search holds final scores already."""
    if len(precomputed) == 3:
        totals, fused, emitted = precomputed
        rank_scores = _host(fused)
        use_lm = False  # scores already fused on the device
    else:
        totals, emitted = precomputed
        rank_scores = _host(totals)
        use_lm = lm is not None and config.lm_alpha != 0.0
    totals = _host(totals)
    emitted = _host(emitted)
    if emitted.ndim != 3:
        raise ValueError("n-best needs all_beams=True beam_scan output")
    out: List[List[Tuple[str, float]]] = []
    for b in range(totals.shape[0]):
        if valid is not None and not valid[b]:
            continue
        ranked = []
        seen = set()
        for w in np.argsort(-rank_scores[b]):
            score = float(rank_scores[b, int(w)])
            if score == -np.inf or float(totals[b, int(w)]) == -np.inf:
                break
            row = emitted[b, int(w)]
            ids = row[row != 0].tolist()
            key = tuple(ids)
            if key in seen:  # distinct-prefix invariant, but be safe
                continue
            seen.add(key)
            if use_lm:
                score += (config.lm_alpha * lm_prefix_logp(lm, alphabet, ids)
                          + config.lm_beta * len(ids))
            ranked.append((alphabet.decode(ids), score))
        ranked.sort(key=lambda x: -x[1])
        out.append(ranked[:nbest])
    return out


def device_beam_decode(
    log_probs: Optional[torch.Tensor],  # [B, T, K]; None with precomputed
    frame_mask: Optional[torch.Tensor],  # [B, T]; None with precomputed
    alphabet: Alphabet,
    config: BeamConfig = BeamConfig(),
    lm=None,
    valid: Optional[np.ndarray] = None,
    precomputed=None,  # (totals, emitted) from beam_scan_collapsed
    return_scores: bool = False,
) -> List:
    """Batch beam decode through the device search -> best uxxxx per
    valid sample. With an LM the device returns the top-W finals and the
    host rescores them (two-pass). ``precomputed`` takes a caller's
    ``beam_scan_collapsed`` output (tensors or host arrays), whose
    ``emitted`` arity (best-only [B, T] or all-beams [B, W, T]) must match
    whether an LM is in play. With ``return_scores`` each element is
    ``(uxxxx, ctc_total)``: the winner's pure CTC log-prob."""
    use_lm = lm is not None and config.lm_alpha != 0.0
    if precomputed is not None:
        totals, emitted = precomputed
    else:
        fn = _beam_scan_jit(config.beam_width, config.topk,
                            float(config.prune_logp), use_lm,
                            False, 0.0, 0.0)
        totals, emitted = fn(log_probs, frame_mask)
    totals = _host(totals)  # [B, W]
    emitted = _host(emitted)  # [B, T] or [B, W, T]

    B, W = totals.shape
    out: List = []
    for b in range(B):
        if valid is not None and not valid[b]:
            continue
        if not use_lm:
            w_best = int(np.argmax(totals[b]))
            if emitted.ndim == 3:  # all-beams layout works for both modes
                col = emitted[b, w_best]
            else:
                col = emitted[b]
            hyp = alphabet.decode(col[col != 0].tolist())
            out.append((hyp, float(totals[b, w_best]))
                       if return_scores else hyp)
            continue
        if emitted.ndim != 3:
            raise ValueError(
                "LM rescoring needs all_beams=True beam_scan output"
            )
        best, best_score, best_ctc = "", -np.inf, -np.inf
        order = np.argsort(-totals[b])
        for w in order:
            ctc = float(totals[b, w])
            if ctc == -np.inf:
                break
            row = emitted[b, int(w)]
            ids = row[row != 0].tolist()
            score = (ctc + config.lm_alpha * lm_prefix_logp(lm, alphabet, ids)
                     + config.lm_beta * len(ids))
            if score > best_score:
                best_score, best, best_ctc = score, alphabet.decode(ids), ctc
        out.append((best, best_ctc) if return_scores else best)
    return out
