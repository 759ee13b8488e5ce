"""The port's device beam search (``decode/device_beam.py``) against the
JAX package's on the CPU, one case or two for each class of
``tests/test_device_beam.py``, on the same seeded numpy inputs and the
same numpy tables:

- ``beam_scan``: totals and the extras' float state within 1e-5 (equal
  ``-inf`` positions), ``parents``, ``tokens`` and the integer state
  equal;
- ``beam_scan_collapsed``: the best-only rows, packed rows and all-beams
  rows equal, fused scores within 1e-5;
- the decoded strings equal to the port's host engine
  (``prefix_beam_search``, the Python expansion) wherever the JAX tests
  hold the JAX search to its host oracle, and the golden
  ``tests/golden/lg_bundle`` decode string-exact;
- the open-addressed probes (order-4 char LM, hashed word bigram and
  trigram) at the JAX package's slots for keys up to 2**32 - 1, and every
  (context, word) score bit-equal to JAX's.

Sizes stay small (B <= 6, T <= 48, K <= 14, W <= 8): the file runs in
well under 30 s.
"""

import functools
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vistaocr_tpu.decode import device_beam as jdb

from vistaocr_tpu_torch.decode import device_beam as db
from vistaocr_tpu_torch.decode import lm as plm
from vistaocr_tpu_torch.decode.beam import BeamConfig, prefix_beam_search
from vistaocr_tpu_torch.decode.lexicon import Lexicon
from vistaocr_tpu_torch.text import Alphabet, utf8_to_uxxxx

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SEARCH = dict(beam_width=8, topk=4, prune_logp=-12.0)


def _alphabet(n_symbols, space=False):
    chars = "abcdefghijklmnopqrstuvwxyz"[:n_symbols]
    return Alphabet.build([utf8_to_uxxxx(chars + (" " if space else ""))])


def _random_case(seed, B=6, T=18, K=9, peaky=False):
    """tests/test_device_beam.py's ``_random_case``."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 3.0 if peaky else 1.0, (B, T, K)).astype(np.float32)
    if peaky:
        logits[..., 0] += 2.0
        sym = rng.integers(1, K, (B,))
        for b in range(B):
            logits[b, :, sym[b]] += rng.normal(1.5, 1.0, (T,))
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    frames = rng.integers(3, T + 1, B).astype(np.int32)
    frames[0] = T
    mask = np.arange(T)[None, :] < frames[:, None]
    return lp.astype(np.float32), mask, frames


def _wide_case(seed, K, B=4, T=40):
    """Blank-heavy posteriors of the JAX full-stack cases."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2.5, (B, T, K)).astype(np.float32)
    logits[..., 0] += 1.5
    lp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))
          ).astype(np.float32)
    frames = rng.integers(10, T + 1, B).astype(np.int32)
    mask = np.arange(T)[None, :] < frames[:, None]
    return lp, mask, frames, rng


def _jax(tables):
    return {k: (v if isinstance(v, (int, float)) else jnp.asarray(v))
            for k, v in tables.items()}


def _close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    if np.issubdtype(want.dtype, np.floating):
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=name)
        np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=name)
        np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-5,
                                   err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


def _split(tables, static):
    """Arrays (traced) and everything else (static) of a call's keywords."""
    arrays = {k: v for k, v in tables.items()
              if not isinstance(v, (int, float))}
    return arrays, {**SEARCH, **static, **{k: v for k, v in tables.items()
                                           if k not in arrays}}


@functools.lru_cache(maxsize=None)
def _jax_program(static_items):
    """One jitted JAX program running ``beam_scan`` and
    ``beam_scan_collapsed`` on the same inputs (one compile a variant)."""
    static = dict(static_items)
    all_beams = static.pop("all_beams", False)

    def run(lp, mask, arrays):
        scan_arrays = {k: v for k, v in arrays.items() if k != "lex_boundary"}
        scan_static = {k: v for k, v in static.items()}
        return (jdb.beam_scan(lp, mask, **scan_static, **scan_arrays),
                jdb.beam_scan_collapsed(lp, mask, all_beams=all_beams,
                                        **static, **arrays))

    return jax.jit(run)


def _both(lp, mask, tables=None, **static):
    """``beam_scan`` and ``beam_scan_collapsed`` of both packages on the
    same inputs, held equal; returns the port's outputs as numpy:
    (scan outputs, collapsed outputs)."""
    arrays, static = _split(tables or {}, static)
    want_scan, want = _jax_program(tuple(sorted(static.items())))(
        jnp.asarray(lp), jnp.asarray(mask),
        {k: jnp.asarray(v) for k, v in arrays.items()})
    all_beams = static.pop("all_beams", False)
    kw = db.device_tables(arrays, "cpu")
    scan_kw = {k: v for k, v in kw.items() if k != "lex_boundary"}
    lp_t, mask_t = torch.from_numpy(lp), torch.from_numpy(mask)
    got_scan = db.beam_scan(lp_t, mask_t, **static, **scan_kw)
    got = db.beam_scan_collapsed(lp_t, mask_t, all_beams=all_beams,
                                 **static, **kw)
    assert len(got_scan) == len(want_scan)
    if len(want_scan) == 4:
        assert set(got_scan[1]) == set(want_scan[1])
        for name in want_scan[1]:
            _close(got_scan[1][name].numpy(), want_scan[1][name], name)
    _close(got_scan[0].numpy(), want_scan[0], "totals")
    for name, g, w in (("parents", got_scan[-2], want_scan[-2]),
                       ("tokens", got_scan[-1], want_scan[-1])):
        assert g.dtype == torch.int32
        _close(g.numpy(), w, name)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.numpy(), w, f"collapsed output {i}")
    return ([o if isinstance(o, dict) else o.numpy() for o in got_scan],
            [g.numpy() for g in got])


def _rows(alphabet, packed):
    return [alphabet.decode(r[r != 0].tolist()) for r in packed[:, :-1]]


def _oracle(lp, frames, alphabet, cfg, **kw):
    return [prefix_beam_search(lp[b, : frames[b]], alphabet, cfg, **kw)[0][0]
            for b in range(lp.shape[0])]


# --- TestOracleParity / TestMerging / TestBacktrace --------------------------
@pytest.mark.parametrize("seed,peaky", [(0, False), (1, True)])
def test_plain_search_matches_jax_and_host(seed, peaky):
    lp, mask, frames = _random_case(seed, peaky=peaky)
    al = _alphabet(lp.shape[-1] - 1)
    (totals, parents, tokens), (_, best) = _both(lp, mask)
    emitted = db.backtrace(parents, tokens)
    _, em_all = db.beam_scan_collapsed(
        torch.from_numpy(lp), torch.from_numpy(mask), **SEARCH,
        all_beams=True)
    em_all = em_all.numpy()
    np.testing.assert_array_equal(em_all, emitted.transpose(1, 2, 0))
    cfg = BeamConfig(**SEARCH)
    got = db.device_beam_decode(torch.from_numpy(lp), torch.from_numpy(mask),
                                al, cfg)
    assert got == [al.decode(r[r != 0].tolist()) for r in best]
    assert got == _oracle(lp, frames, al, cfg)
    for b in range(lp.shape[0]):
        host = prefix_beam_search(lp[b, : frames[b]], al, cfg)
        assert abs(float(totals[b].max()) - host[0][1]) <= 1e-4


def test_merging_and_masks():
    lp = np.log(np.array([[[0.1, 0.8, 0.1], [0.4, 0.5, 0.1],
                           [0.1, 0.8, 0.1]]], np.float32))
    mask = np.ones((1, 3), bool)
    al = _alphabet(2)
    _both(lp, mask, beam_width=8, topk=2, prune_logp=-30.0)
    cfg = BeamConfig(beam_width=8, topk=2, prune_logp=-30.0)
    got = db.device_beam_decode(torch.from_numpy(lp), torch.from_numpy(mask),
                                al, cfg)
    assert got == [prefix_beam_search(lp[0], al, cfg)[0][0]]
    # every frame masked: empty strings; valid filters the lines
    lp2, _, _ = _random_case(11, B=4, T=6)
    none = np.zeros(lp2.shape[:2], bool)
    _both(lp2, none)
    al2 = _alphabet(lp2.shape[-1] - 1)
    assert db.device_beam_decode(torch.from_numpy(lp2), torch.from_numpy(none),
                                 al2) == [""] * 4
    valid = np.array([True, False, True, False])
    assert len(db.device_beam_decode(
        torch.from_numpy(lp2), torch.ones(lp2.shape[:2], dtype=torch.bool),
        al2, valid=valid)) == 2


def test_device_backtrace_matches_numpy_and_jax():
    lp, mask, _ = _random_case(6)
    (_, parents, tokens), _ = _both(lp, mask)
    dev = db.device_backtrace(torch.from_numpy(parents),
                              torch.from_numpy(tokens))
    np.testing.assert_array_equal(dev.numpy(), db.backtrace(parents, tokens))
    np.testing.assert_array_equal(
        dev.numpy(), np.asarray(jdb.device_backtrace(jnp.asarray(parents),
                                                     jnp.asarray(tokens))))


def test_topk_keeps_lax_order_among_ties():
    import jax

    ninf = -np.inf
    x = np.array([[1.0, 2.0, 2.0, 2.0, 0.0, ninf, ninf],
                  [ninf, ninf, ninf, ninf, ninf, ninf, 0.0]], np.float32)
    for k in (2, 3, 5):
        vals, idx = db._topk_stable(torch.from_numpy(x), k)
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))


# --- TestTwoPassLM / TestNBest -----------------------------------------------
def test_two_pass_rescoring_and_nbest_match_jax():
    from vistaocr_tpu.decode import BeamConfig as JaxBeamConfig
    from vistaocr_tpu.decode.lm import train_char_lm as jax_train
    from vistaocr_tpu.text import Alphabet as JaxAlphabet

    al = _alphabet(2)
    jal = JaxAlphabet.from_json(al.to_json())
    a, b = utf8_to_uxxxx("a"), utf8_to_uxxxx("b")
    corpus = [f"{a} {b}"] * 50
    lm, jlm = plm.train_char_lm(corpus, order=2), jax_train(corpus, order=2)
    lp = np.log(np.array([[[0.05, 0.9, 0.05], [0.55, 0.35, 0.10],
                           [0.05, 0.65, 0.30]]], np.float32))
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    mask = np.ones((1, 3), bool)
    cfg = dict(beam_width=8, topk=2, prune_logp=-30.0, lm_alpha=2.0)
    _, pre = _both(lp, mask, beam_width=8, topk=2, prune_logp=-30.0,
                   all_beams=True)
    got = db.device_beam_decode(None, None, al, BeamConfig(**cfg), lm=lm,
                                precomputed=pre, return_scores=True)
    want = jdb.device_beam_decode(None, None, jal, JaxBeamConfig(**cfg),
                                  lm=jlm, precomputed=pre,
                                  return_scores=True)
    assert got == want and got[0][0] == f"{a} {b}"
    # n-best over the all-beams finals, pure CTC and rescored
    lp, mask, frames = _random_case(9, peaky=True)
    al = _alphabet(lp.shape[-1] - 1)
    jal = JaxAlphabet.from_json(al.to_json())
    _, pre = _both(lp, mask, all_beams=True)
    prog = db.beam_scan_program(BeamConfig(**SEARCH), all_beams=True)
    for g, w in zip(prog(torch.from_numpy(lp), torch.from_numpy(mask)), pre):
        np.testing.assert_array_equal(g.numpy(), w)
    lists = db.device_beam_nbest(al, BeamConfig(**SEARCH), pre, nbest=3)
    assert lists == jdb.device_beam_nbest(jal, JaxBeamConfig(**SEARCH), pre,
                                          nbest=3)
    for b, ranked in enumerate(lists):
        host = prefix_beam_search(lp[b, : frames[b]], al, BeamConfig(**SEARCH))
        assert [h for h, _ in ranked] == [h for h, _ in host[:3]]


# --- TestFusedDeviceLM / TestDeviceLexicon ------------------------------------
def _char_lm(al, order, seed=17):
    rng = np.random.default_rng(seed)
    chars = [al.token_of(i) for i in range(1, al.num_classes)]
    corpus = [" ".join(rng.choice(chars, rng.integers(2, 9)))
              for _ in range(200)]
    return plm.train_char_lm(corpus, order=order)


@pytest.mark.parametrize("order", [2, 3])
def test_fused_char_lm_matches_jax_and_host(order):
    lp, mask, frames = _random_case(order, K=6, peaky=True)
    al = _alphabet(lp.shape[-1] - 1)
    lm = _char_lm(al, order)
    tables = {"lm_table": plm.dense_logp_table(lm, al, order=order)}
    fuse = dict(lm_alpha=0.7, lm_beta=0.3)
    _, (_, packed) = _both(lp, mask, tables, **fuse)
    assert packed.shape == (lp.shape[0], lp.shape[1] + 1)
    assert (packed[:, -1] <= 0).all()
    cfg = BeamConfig(**SEARCH, **fuse)
    assert _rows(al, packed) == _oracle(lp, frames, al, cfg, lm=lm)


def _lexicon_case(seed, with_lm):
    lp, mask, frames = _random_case(seed, K=7, peaky=True)
    al = _alphabet(5, space=True)
    rng = np.random.default_rng(seed + 100)
    words = sorted({"".join(rng.choice(list("abcde"), rng.integers(1, 4)))
                    for _ in range(12)})
    lex = Lexicon.from_words(al, words)
    nt, bd = lex.dense_tables()
    tables = {"lex_next": nt, "lex_boundary": bd}
    lm, fuse = None, {}
    if with_lm:
        corpus = [" ".join(rng.choice(words, rng.integers(1, 4)))
                  for _ in range(100)]
        lm = plm.train_char_lm([utf8_to_uxxxx(t) for t in corpus], order=2)
        tables["lm_table"] = plm.dense_logp_table(lm, al, order=2)
        fuse = dict(lm_alpha=0.6, lm_beta=0.2)
    return lp, mask, frames, al, lex, lm, tables, fuse


@pytest.mark.parametrize("seed,with_lm", [(0, False), (1, True)])
def test_lexicon_matches_jax_and_host(seed, with_lm):
    lp, mask, frames, al, lex, lm, tables, fuse = _lexicon_case(seed, with_lm)
    _, (_, packed) = _both(lp, mask, tables, **fuse)
    cfg = BeamConfig(**SEARCH, **fuse)
    assert _rows(al, packed) == _oracle(lp, frames, al, cfg, lm=lm,
                                        lexicon=lex)


# --- TestDeviceWordLM / TestNoBoundaryFallback / TestFullStackParity ---------
def test_dense_word_lm_matches_jax_and_host():
    lp, mask, frames = _random_case(2, K=7, peaky=True)
    al = _alphabet(5, space=True)
    rng = np.random.default_rng(33)
    words = sorted({"".join(rng.choice(list("abcde"), rng.integers(1, 4)))
                    for _ in range(10)})
    lex = Lexicon.from_words(al, words)
    wlm = plm.train_char_lm([" ".join(rng.choice(words, rng.integers(1, 4)))
                             for _ in range(120)], order=2)
    nt, bd = lex.dense_tables()
    tables = {"lex_next": nt, "lex_boundary": bd,
              "word_table": plm.dense_word_logp_table(wlm, lex.words),
              "word_ids": lex.word_id_table()}
    fuse = dict(space_id=lex.space_id, word_alpha=0.8, word_beta=0.3)
    _, (_, packed) = _both(lp, mask, tables, **fuse)
    cfg = BeamConfig(**SEARCH, word_lm_alpha=0.8, word_lm_beta=0.3)
    assert _rows(al, packed) == _oracle(lp, frames, al, cfg, lexicon=lex,
                                        word_lm=wlm)
    with pytest.raises(ValueError, match="lex_next"):
        db.beam_scan(torch.zeros(1, 4, 4), torch.ones(1, 4, dtype=torch.bool),
                     **SEARCH, word_table=torch.zeros(3, 2))


def test_no_boundary_fallback_is_jax_s():
    """The documented divergence from the host oracle (every beam ends
    mid-word): the port's device search picks what JAX's picks, and the
    host engine differs as the JAX test pins."""
    al = Alphabet.build([utf8_to_uxxxx("abc ")])
    a = al.index_of(utf8_to_uxxxx("a"))
    c = al.index_of(utf8_to_uxxxx("c"))
    lex = Lexicon.from_words(al, ["ab", "cb"])
    wlm = plm.train_char_lm(["a"] * 60 + ["ab", "cb"], order=2)
    lp = np.full((1, 1, al.num_classes), -7.0, np.float32)
    lp[0, 0, c], lp[0, 0, a] = -0.3, -0.5
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    mask = np.ones((1, 1), bool)
    nt, bd = lex.dense_tables()
    tables = {"lex_next": nt, "lex_boundary": bd,
              "word_table": plm.dense_word_logp_table(wlm, lex.words),
              "word_ids": lex.word_id_table()}
    static = dict(beam_width=2, topk=2, prune_logp=-12.0,
                  space_id=lex.space_id, word_alpha=3.0, word_beta=0.0)
    _, (_, packed) = _both(lp, mask, tables, **static)
    assert _rows(al, packed) == [utf8_to_uxxxx("c")]
    cfg = BeamConfig(beam_width=2, topk=2, prune_logp=-12.0,
                     word_lm_alpha=3.0)
    assert prefix_beam_search(lp[0], al, cfg, lexicon=lex,
                              word_lm=wlm)[0][0] == utf8_to_uxxxx("a")


def _full_stack(seed, T, char_order):
    al = Alphabet.build([utf8_to_uxxxx("abcdef ")])
    lp, mask, frames, rng = _wide_case(seed, al.num_classes, T=T)
    words = sorted({"".join(rng.choice(list("abcdef"), rng.integers(1, 5)))
                    for _ in range(15)})
    lex = Lexicon.from_words(al, words)
    corpus = [" ".join(rng.choice(words, 3)) for _ in range(100)]
    wlm = plm.train_char_lm(corpus, order=2)
    clm = plm.train_char_lm([utf8_to_uxxxx(s) for s in corpus],
                            order=char_order)
    nt, bd = lex.dense_tables()
    tables = {"lex_next": nt, "lex_boundary": bd,
              "word_table": plm.dense_word_logp_table(wlm, lex.words),
              "word_ids": lex.word_id_table()}
    if char_order == 4:
        t = plm.hashed_logp_table(clm, al)
        tables.update(lm_table=t["t3"], lm_hash_keys=t["keys"],
                      lm_hash_vals=t["vals"], lm_rows=t["rows"],
                      lm_probes=int(t["probes"]))
    else:
        tables["lm_table"] = plm.dense_logp_table(clm, al, order=3)
    fuse = dict(lm_alpha=0.5, lm_beta=0.2, space_id=lex.space_id,
                word_alpha=0.7, word_beta=0.3)
    cfg = BeamConfig(**SEARCH, lm_alpha=0.5, lm_beta=0.2, word_lm_alpha=0.7,
                     word_lm_beta=0.3)
    return lp, mask, frames, al, lex, wlm, clm, tables, fuse, cfg


@pytest.mark.parametrize("char_order", [3, 4])
def test_full_stack_matches_jax_and_host(char_order):
    """Char LM (dense trigram or hashed 4-gram) + lexicon + word bigram in
    one search (JAX's TestFullStackParity and quadruple fusion)."""
    lp, mask, frames, al, lex, wlm, clm, tables, fuse, cfg = _full_stack(
        5 if char_order == 3 else 9, 48, char_order)
    _, (_, packed) = _both(lp, mask, tables, **fuse)
    assert _rows(al, packed) == _oracle(lp, frames, al, cfg, lm=clm,
                                        lexicon=lex, word_lm=wlm)


# --- TestUnkBypass / TestConstrainedNBest -------------------------------------
@pytest.mark.parametrize("seed,with_wlm", [(0, False), (1, True)])
def test_unk_bypass_matches_jax_and_host(seed, with_wlm):
    al = Alphabet.build([utf8_to_uxxxx("abcdef ")])
    lp, mask, frames, _ = _wide_case(seed + 400, al.num_classes, B=5, T=30)
    rng = np.random.default_rng(seed + 400)
    words = sorted({"".join(rng.choice(list("abcdef"), rng.integers(1, 4)))
                    for _ in range(8)})
    lex = Lexicon.from_words(al, words)
    nt, bd = lex.dense_tables(unk=True)
    tables = {"lex_next": nt, "lex_boundary": bd}
    fuse = dict(space_id=lex.space_id, lex_unk_logp=-2.5)
    cfg = BeamConfig(**SEARCH, lex_unk_logp=-2.5)
    wlm = None
    if with_wlm:
        wlm = plm.train_char_lm(
            [" ".join(rng.choice(words, 3)) for _ in range(60)], order=2)
        tables.update(word_table=plm.dense_word_logp_table(wlm, lex.words),
                      word_ids=lex.word_id_table(unk=True))
        fuse.update(word_alpha=0.7, word_beta=0.3,
                    word_unk_logp=plm.word_unk_logp(wlm))
        cfg.word_lm_alpha, cfg.word_lm_beta = 0.7, 0.3
    _, (_, packed) = _both(lp, mask, tables, **fuse)
    assert _rows(al, packed) == _oracle(lp, frames, al, cfg, lexicon=lex,
                                        word_lm=wlm)


def test_constrained_nbest_matches_jax_and_host():
    from vistaocr_tpu.decode import BeamConfig as JaxBeamConfig
    from vistaocr_tpu.text import Alphabet as JaxAlphabet

    lp, mask, frames, al, lex, wlm, clm, tables, fuse, cfg = _full_stack(
        3, 40, 3)
    _, pre = _both(lp, mask, tables, all_beams=True, **fuse)
    assert len(pre) == 3  # (totals, fused, emitted)
    lists = db.device_beam_nbest(al, cfg, pre, nbest=5)
    jal = JaxAlphabet.from_json(al.to_json())
    assert lists == jdb.device_beam_nbest(
        jal, JaxBeamConfig(**SEARCH), pre, nbest=5)
    for b in range(lp.shape[0]):
        host = prefix_beam_search(lp[b, : frames[b]], al, cfg, lm=clm,
                                  lexicon=lex, word_lm=wlm)[:5]
        assert [h for h, _ in lists[b]] == [h for h, _ in host]
        for (_, sg), (_, sh) in zip(lists[b], host):
            assert abs(sg - sh) < 1e-3
    # the packed winner is the n-best's first
    _, packed = db.beam_scan_collapsed(
        torch.from_numpy(lp), torch.from_numpy(mask), **SEARCH,
        **db.device_tables(tables, "cpu"), **fuse)
    assert [ranked[0][0] for ranked in lists] == _rows(al, packed.numpy())


# --- TestHashedOrder4LM / TestHashedWordLM / TestDeviceWordTrigram -----------
def test_probe_slots_match_jax_uint32():
    """The probe placement ``(key * 2654435761 mod 2**32) >> shift`` of
    int64 keys below 2**32 against JAX's uint32 arithmetic, and the
    prefix hashes' products modulo 2**32 against numpy's uint32."""
    rng = np.random.default_rng(0)
    keys = np.concatenate([rng.integers(0, 2**32, 4000, dtype=np.uint64),
                           [0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]])
    for S in (8, 64, 1 << 14, 1 << 20):
        shift = 32 - (S.bit_length() - 1)
        want = np.asarray((jnp.asarray(keys.astype(np.uint32))
                           * jnp.uint32(2654435761)) >> shift)
        table = torch.zeros(S, dtype=torch.int64)
        (slot, _), = db._probe(torch.from_numpy(keys.astype(np.int64)),
                               table, 1)
        np.testing.assert_array_equal(slot.numpy(), want.astype(np.int64))
    for m in (db._M1, db._M2, db._M3):
        got = db._mul32(torch.from_numpy(keys.astype(np.int64)), m)
        want = keys.astype(np.uint32) * np.uint32(m)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _order4(seed):
    al = Alphabet.build([utf8_to_uxxxx("abcdef")])
    rng = np.random.default_rng(seed + 77)
    texts = ["".join(rng.choice(list("abcdef"), rng.integers(3, 12)))
             for _ in range(60)]
    lm = plm.train_char_lm([utf8_to_uxxxx(t) for t in texts], order=4)
    return al, lm, rng


def test_order4_lookup_matches_lm_logp():
    al, lm, rng = _order4(0)
    K = al.num_classes
    t = plm.hashed_logp_table(lm, al)
    tab = db.device_tables({"keys": t["keys"], "vals": t["vals"],
                            "rows": t["rows"], "t3": t["t3"]}, "cpu")
    cases = [(0, 0, K), (0, K, 1), (K, 1, 2)]
    cases += [tuple(int(x) for x in rng.integers(1, K, 3)) for _ in range(40)]
    h = torch.tensor(cases, dtype=torch.int64)
    key = (h[:, 0] * (K + 1) + h[:, 1]) * (K + 1) + h[:, 2]
    row = torch.full_like(key, -1)
    for slot, eq in db._probe(key, tab["keys"], int(t["probes"])):
        row = torch.where(eq & (row < 0), tab["vals"][slot], row)
    toks = [None] + al.tokens
    for n, (h1, h2, h3) in enumerate(cases):
        hist = tuple(("<s>" if i == K else toks[i]) for i in (h1, h2, h3)
                     if i != 0)
        for c in range(1, K):
            got = (float(tab["rows"][row[n], c]) if row[n] >= 0
                   else float(tab["t3"][h2, h3, c]))
            assert abs(got - lm.logp(hist, toks[c])) < 1e-5


def test_order4_char_lm_matches_jax_and_host():
    lp, mask, frames = _random_case(1, K=7, peaky=True)
    al, lm, _ = _order4(1)
    t = plm.hashed_logp_table(lm, al)
    tables = dict(lm_table=t["t3"], lm_hash_keys=t["keys"],
                  lm_hash_vals=t["vals"], lm_rows=t["rows"],
                  lm_probes=int(t["probes"]))
    fuse = dict(lm_alpha=0.7, lm_beta=0.25)
    _, (_, packed) = _both(lp, mask, tables, **fuse)
    cfg = BeamConfig(**SEARCH, **fuse)
    assert _rows(al, packed) == _oracle(lp, frames, al, cfg, lm=lm)


def _word_case(seed, order, n_words=12, n_sents=120):
    al = _alphabet(5, space=True)
    rng = np.random.default_rng(seed + 77)
    words = sorted({"".join(rng.choice(list("abcde"), rng.integers(1, 4)))
                    for _ in range(n_words)})
    lex = Lexicon.from_words(al, words)
    wlm = plm.train_char_lm(
        [" ".join(rng.choice(words, rng.integers(1, 5 if order == 3 else 4)))
         for _ in range(n_sents)], order=order)
    if order == 3:
        # nonzero Katz weights on a third of the bigram contexts, as the
        # JAX test injects them, so the context backoff path runs
        for i, (ng, (lp_, _)) in enumerate(sorted(wlm.tables[1].items())):
            if i % 3 == 0:
                wlm.tables[1][ng] = (lp_, -0.31 * (1 + i % 5))
    return al, lex, wlm


def _word_tables(wlm, words):
    if wlm.order == 2:
        t = plm.hashed_word_logp_table(wlm, words)
        return {"word_uni": t["uni"], "word_bo": t["bo"],
                "word_hash_keys": t["keys"], "word_hash_vals": t["vals"],
                "word_probes": int(t["probes"])}
    return plm.device_word_tables(wlm, words)


@pytest.mark.parametrize("order", [2, 3])
def test_hashed_word_gather_bit_equal_to_jax(order):
    """Every (prev2, prev1, word) score of the hashed bigram / trigram
    lookup bit-equal to JAX's (out-of-LM words included for the bigram),
    and equal to ArpaLM.logp."""
    _, lex, wlm = _word_case(3, order)
    words = lex.words + (["zzz", "qq"] if order == 2 else [])
    V = len(words)
    tables = _word_tables(wlm, words)
    jt, pt = _jax(tables), db.device_tables(tables, "cpu")
    p2, p1, w = np.meshgrid(np.arange(V + 2), np.arange(V + 1),
                            np.arange(V), indexing="ij")
    args = [x.reshape(-1).astype(np.int32) for x in (p2, p1, w)]
    extra_j = {"wprev2": jnp.asarray(args[0])} if order == 3 else {}
    extra_p = ({"wprev2": torch.from_numpy(args[0]).long()}
               if order == 3 else {})
    want = np.asarray(jdb._word_logp_gather(
        jnp.asarray(args[1]), jnp.asarray(args[2]), **extra_j, **jt))
    got = db._word_logp_gather(torch.from_numpy(args[1]).long(),
                               torch.from_numpy(args[2]).long(), **extra_p,
                               **pt).numpy()
    np.testing.assert_array_equal(got, want)
    got = got.reshape(V + 2, V + 1, V)
    for a in range(V + 2):
        for b in range(V + 1):
            for c in range(V):
                tb = "<s>" if b == V else words[b]
                hist = ((tb,) if order == 2 or a == V + 1
                        else ("<s>" if a == V else words[a], tb))
                assert np.isclose(got[a, b, c], wlm.logp(hist, words[c]),
                                  atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("order,unk", [(2, False), (3, False), (3, True)])
def test_hashed_word_lm_matches_jax_and_host(order, unk):
    lp, mask, frames = _random_case(order + unk, K=7, peaky=True)
    al, lex, wlm = _word_case(order + unk, order, n_words=8 if unk else 12,
                              n_sents=150 if order == 3 else 120)
    nt, bd = lex.dense_tables(unk=unk)
    tables = {"lex_next": nt, "lex_boundary": bd,
              "word_ids": lex.word_id_table(unk=unk),
              **_word_tables(wlm, lex.words)}
    fuse = dict(space_id=lex.space_id, word_alpha=0.8, word_beta=0.3)
    cfg = BeamConfig(**SEARCH, word_lm_alpha=0.8, word_lm_beta=0.3)
    if unk:
        fuse.update(lex_unk_logp=-1.5,
                    word_unk_logp=float(plm.word_unk_logp(wlm)))
        cfg.lex_unk_logp = -1.5
    _, (_, packed) = _both(lp, mask, tables, **fuse)
    assert _rows(al, packed) == _oracle(lp, frames, al, cfg, lexicon=lex,
                                        word_lm=wlm)


# --- the golden L∘G bundle ----------------------------------------------------
def test_golden_lg_bundle_string_exact():
    data = np.load(os.path.join(GOLDEN, "lg_bundle.npz"))
    with open(os.path.join(GOLDEN, "lg_bundle.json")) as f:
        meta = json.load(f)
    al = Alphabet.from_json(json.dumps(meta["alphabet"]))
    lex = Lexicon.from_words(al, meta["words"])
    char_lm = plm.ArpaLM.read_arpa(os.path.join(GOLDEN, "lg_char_lm.arpa"))
    word_lm = plm.ArpaLM.read_arpa(os.path.join(GOLDEN, "lg_word_lm.arpa"))
    cfg = meta["config"]
    lp = data["log_probs"].astype(np.float32)
    mask = np.arange(lp.shape[1])[None, :] < data["frames"][:, None]
    nt, bd = lex.dense_tables()
    tables = db.device_tables({
        "lm_table": plm.dense_logp_table(char_lm, al, order=3),
        "lex_next": nt, "lex_boundary": bd,
        "word_table": plm.dense_word_logp_table(word_lm, lex.words),
        "word_ids": lex.word_id_table()}, "cpu")
    prog = db.beam_scan_program(
        BeamConfig(beam_width=cfg["beam_width"], topk=cfg["topk"],
                   prune_logp=cfg["prune_logp"], lm_alpha=cfg["lm_alpha"],
                   lm_beta=cfg["lm_beta"]), fused_lm=True)
    _, packed = prog(torch.from_numpy(lp), torch.from_numpy(mask),
                     space_id=lex.space_id, word_alpha=cfg["word_alpha"],
                     word_beta=cfg["word_beta"], **tables)
    assert _rows(al, packed.numpy()) == meta["device_lg"]
