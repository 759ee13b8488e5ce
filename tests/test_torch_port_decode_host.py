"""The port's host decoding against the JAX package on the CPU:

- ``beam_topk`` (torch) against ``jax.lax.top_k`` over the symbol
  classes, on random rows and on rows with ties at and across the k-th
  place (the lower class id first among equal values);
- ``beam_decode`` on the frozen golden bundles, string-exact, through the
  C++ engine and through the Python expansion: ``decode_bundle`` with
  ``BeamConfig(beam_width=8, topk=6)`` reproduces ``meta["beam"]``;
  ``lg_bundle`` with its char LM, lexicon and word LM gives the JAX
  package's hypotheses (its Python expansion, which needs no build);
  ``nbest=3`` lists equal, scores within 1e-9;
- the copies ``decode/lm.py``, ``decode/lexicon.py`` and
  ``decode/native/beam.cpp`` are byte-equal to the JAX package's files,
  and give the same ARPA text, dense LM tables and trie tables;
- the C++ engine builds when six processes build it at once into an
  empty build directory.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from vistaocr_tpu.decode import beam as jax_beam
from vistaocr_tpu.decode import lexicon as jax_lexicon
from vistaocr_tpu.decode import lm as jax_lm
from vistaocr_tpu.text import Alphabet as JaxAlphabet

from vistaocr_tpu_torch.decode import beam, lexicon, lm, native_binding
from vistaocr_tpu_torch.text import Alphabet

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")


def _bundle(name):
    data = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    with open(os.path.join(GOLDEN, f"{name}.json")) as f:
        meta = json.load(f)
    lp = data["log_probs"].astype(np.float32)
    mask = np.arange(lp.shape[1])[None, :] < data["frames"][:, None]
    return lp, mask, meta


@pytest.fixture
def python_expansion(monkeypatch):
    """beam_decode's choice falls on the Python expansion."""
    monkeypatch.setattr(native_binding, "available", lambda: False)


# --- beam_topk ---------------------------------------------------------------
def _tied_rows():
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (3, 5, 12)).astype(np.float32)
    x[0, 0, 1:] = -1.0  # every symbol class equal
    x[0, 1, [3, 5, 7, 9, 11]] = 2.0  # five tied at the top, k = 4
    x[0, 2, [2, 10]] = 1.5  # a tie across the k-th place
    x[0, 2, [4, 6, 8]] = 3.0
    x[1, :, 6:] = x[1, :, 1:7]  # repeated values across the row
    return x


@pytest.mark.parametrize("k", [1, 4, 6, 11, 20])
def test_beam_topk_matches_lax_top_k_with_ties(k):
    for x in (_tied_rows(),
              np.random.default_rng(k).normal(0, 2, (4, 9, 12))
              .astype(np.float32)):
        v_j, i_j = jax_beam.beam_topk(jnp.asarray(x), k)
        v, i = beam.beam_topk(torch.from_numpy(x), k)
        assert i.dtype == torch.int32 and v.dtype == torch.float32
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
        np.testing.assert_array_equal(v.numpy(), np.asarray(v_j))


# --- the golden bundles -----------------------------------------------------
def test_decode_bundle_native_engine():
    assert native_binding.available(), native_binding.build_error()
    lp, mask, meta = _bundle("decode_bundle")
    alphabet = Alphabet.from_json(json.dumps(meta["alphabet"]))
    hyps = beam.beam_decode(torch.from_numpy(lp), torch.from_numpy(mask),
                            alphabet, beam.BeamConfig(beam_width=8, topk=6))
    assert hyps == meta["beam"]


def test_decode_bundle_python_expansion(python_expansion):
    lp, mask, meta = _bundle("decode_bundle")
    alphabet = Alphabet.from_json(json.dumps(meta["alphabet"]))
    hyps = beam.beam_decode(lp, mask, alphabet,
                            beam.BeamConfig(beam_width=8, topk=6))
    assert hyps == meta["beam"]


@pytest.fixture(scope="module")
def lg():
    """The lg bundle's posteriors, config and the JAX package's host
    hypotheses (its Python expansion: a Python char LM) for it."""
    lp, mask, meta = _bundle("lg_bundle")
    cfg = meta["config"]
    config = dict(beam_width=cfg["beam_width"], topk=cfg["topk"],
                  prune_logp=cfg["prune_logp"], lm_alpha=cfg["lm_alpha"],
                  lm_beta=cfg["lm_beta"], word_lm_alpha=cfg["word_alpha"],
                  word_lm_beta=cfg["word_beta"])
    jalpha = JaxAlphabet.from_json(json.dumps(meta["alphabet"]))
    ref = jax_beam.beam_decode(
        jnp.asarray(lp), jnp.asarray(mask), jalpha,
        jax_beam.BeamConfig(**config),
        lm=jax_lm.ArpaLM.read_arpa(os.path.join(GOLDEN, "lg_char_lm.arpa")),
        lexicon=jax_lexicon.Lexicon.from_words(jalpha, meta["words"]),
        word_lm=jax_lm.ArpaLM.read_arpa(
            os.path.join(GOLDEN, "lg_word_lm.arpa")))
    return lp, mask, meta, config, ref


def _port_lg(lp, mask, meta, config, native_lm, nbest=1):
    alphabet = Alphabet.from_json(json.dumps(meta["alphabet"]))
    path = os.path.join(GOLDEN, "lg_char_lm.arpa")
    char_lm = (native_binding.NativeLM(path, alphabet.tokens) if native_lm
               else lm.ArpaLM.read_arpa(path))
    return beam.beam_decode(
        torch.from_numpy(lp), torch.from_numpy(mask), alphabet,
        beam.BeamConfig(**config), lm=char_lm,
        lexicon=lexicon.Lexicon.from_words(alphabet, meta["words"]),
        word_lm=lm.ArpaLM.read_arpa(os.path.join(GOLDEN, "lg_word_lm.arpa")),
        nbest=nbest)


def test_lg_bundle_native_engine(lg):
    lp, mask, meta, config, ref = lg
    assert native_binding.available(), native_binding.build_error()
    assert any(ref) and _port_lg(lp, mask, meta, config, True) == ref


def test_lg_bundle_python_expansion(lg):
    lp, mask, meta, config, ref = lg
    assert _port_lg(lp, mask, meta, config, False) == ref


def test_lg_bundle_nbest_lists(lg):
    lp, mask, meta, config, _ = lg
    jalpha = JaxAlphabet.from_json(json.dumps(meta["alphabet"]))
    ref = jax_beam.beam_decode(
        jnp.asarray(lp), jnp.asarray(mask), jalpha,
        jax_beam.BeamConfig(**config),
        lm=jax_lm.ArpaLM.read_arpa(os.path.join(GOLDEN, "lg_char_lm.arpa")),
        lexicon=jax_lexicon.Lexicon.from_words(jalpha, meta["words"]),
        word_lm=jax_lm.ArpaLM.read_arpa(
            os.path.join(GOLDEN, "lg_word_lm.arpa")), nbest=3)
    got = _port_lg(lp, mask, meta, config, False, nbest=3)
    assert len(got) == len(ref) and any(len(r) > 1 for r in ref)
    for ours, theirs in zip(got, ref):
        assert [h for h, _ in ours] == [h for h, _ in theirs]
        np.testing.assert_allclose([s for _, s in ours],
                                   [s for _, s in theirs], rtol=0, atol=1e-9)


# --- the copied modules -----------------------------------------------------
@pytest.mark.parametrize("name", ["lm.py", "lexicon.py", "native/beam.cpp"])
def test_copies_are_byte_equal(name):
    with open(os.path.join(ROOT, "vistaocr_tpu", "decode", name), "rb") as f:
        theirs = f.read()
    with open(os.path.join(ROOT, "vistaocr_tpu_torch", "decode", name),
              "rb") as f:
        assert f.read() == theirs


def test_copied_lm_and_lexicon_give_the_same_tables(tmp_path):
    texts = ["the cat sat", "a cat ate the rat", "the rat sat on a mat",
             "tea at ten"]
    from vistaocr_tpu.text import utf8_to_uxxxx as jax_u

    from vistaocr_tpu_torch.text import utf8_to_uxxxx

    chars = "".join(sorted(set("".join(texts))))
    a_j, a_p = JaxAlphabet.from_charset(chars), Alphabet.from_charset(chars)
    docs_j = [jax_u(t) for t in texts]
    docs_p = [utf8_to_uxxxx(t) for t in texts]
    assert docs_j == docs_p
    files = {}
    for tag, mod, docs in (("jax", jax_lm, docs_j), ("port", lm, docs_p)):
        model = mod.train_char_lm(docs, order=3)
        files[tag] = str(tmp_path / f"{tag}.arpa")
        model.write_arpa(files[tag])
    with open(files["jax"]) as fj, open(files["port"]) as fp:
        assert fj.read() == fp.read()
    lm_j = jax_lm.ArpaLM.read_arpa(files["port"])
    lm_p = lm.ArpaLM.read_arpa(files["jax"])
    np.testing.assert_array_equal(lm.dense_logp_table(lm_p, a_p),
                                  jax_lm.dense_logp_table(lm_j, a_j))
    words = sorted({w for t in texts for w in t.split()})
    lex_j = jax_lexicon.Lexicon.from_words(a_j, words)
    lex_p = lexicon.Lexicon.from_words(a_p, words)
    for unk in (False, True):
        for x, y in zip(lex_p.dense_tables(unk=unk),
                        lex_j.dense_tables(unk=unk)):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(lex_p.word_id_table(unk=unk),
                                      lex_j.word_id_table(unk=unk))


# --- the native build -------------------------------------------------------
_BUILD_ONE = r"""
import sys
from vistaocr_tpu_torch.decode import native_binding as nb
nb.BUILD_DIR = sys.argv[1]
ok = nb.available()
print(ok, nb.build_error())
sys.exit(0 if ok else 1)
"""


def test_native_build_is_safe_under_six_builders(tmp_path):
    """Six processes build the engine at once into one empty directory
    (as six test workers do on a fresh checkout): all load it."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    build = str(tmp_path / "build")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE, build],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=ROOT)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert [f for f in os.listdir(build) if f.endswith(".tmp")] == []
    assert len([f for f in os.listdir(build) if f.endswith(".so")]) == 1


def test_failed_build_reports_its_own_error(tmp_path, monkeypatch):
    monkeypatch.setattr(native_binding, "_SRC", str(tmp_path / "bad.cpp"))
    (tmp_path / "bad.cpp").write_text("this is not C++\n")
    err = native_binding._build(str(tmp_path / "bad.so"))
    assert err.startswith("g++ failed:") and "g++ not found" not in err
    assert os.listdir(tmp_path) == ["bad.cpp"]
