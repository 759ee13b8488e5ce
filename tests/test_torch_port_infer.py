"""The port's offline inference (``vistaocr_tpu_torch.infer``) and offline
decoding (``decode/offline.py``) against the JAX package's on the CPU, on
one snapshot (a short port ``fit`` on synth-tiny shards, which the JAX
``load_model`` opens) and its 32-line validation split:

- ``run_inference`` greedy (the port through its CLI, ``--device cpu``)
  and host beam (``--decoder beam --beam-impl host`` with a char LM
  trained on the split's transcripts and a lexicon of its words): the
  same hypotheses and the same CER/WER as the JAX ``run_inference``,
  confidences within 1e-3;
- the beam search on the device (``--decoder beam``, the default
  ``--beam-impl device``): plain, with the char LM and lexicon fused in
  the search, and ``--nbest 4`` with and without them: the same
  hypotheses, n-best lists, confidences and report keys as the JAX
  ``run_inference``;
- ``--dump-posteriors``: each package's ``decode_posteriors`` decodes
  either package's dump to the same strings (greedy and beam), and the
  port's greedy decode of its own dump gives its ``run_inference``
  hypotheses;
- an unknown ``--quantize`` mode raises ``ValueError`` (int8 itself:
  ``tests/test_torch_port_quant.py``).
"""

import contextlib
import io
import json
import os

import pytest

import torch

from vistaocr_tpu import infer as jax_infer
from vistaocr_tpu.data import build_synthetic_dataset
from vistaocr_tpu.data.synth import SynthConfig
from vistaocr_tpu.decode import offline as jax_offline

from vistaocr_tpu_torch import infer, train
from vistaocr_tpu_torch.data import open_dataset
from vistaocr_tpu_torch.decode import offline
from vistaocr_tpu_torch.decode.lm import train_char_lm
from vistaocr_tpu_torch.text import uxxxx_to_utf8

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """(data dir, snapshot, char LM path, lexicon path, work dir)."""
    root = tmp_path_factory.mktemp("infer")
    cfg = SynthConfig(language="charset", charset="abcdeo ", min_words=1,
                      max_words=3)
    data = build_synthetic_dataset(str(root / "data"), num_train=96,
                                   num_val=32, height=32, max_width=384,
                                   config=cfg, seed=3)
    run = str(root / "run")
    train.fit(train.TrainConfig(**{
        **train.PRESETS["synth-tiny"], "data_dir": data, "snapshot_dir": run,
        "max_steps": 40, "val_interval_steps": 10**6, "log_interval": 20,
        "batch_pixels": 2**17, "seed": 1}), device="cpu",
        log=lambda *a: None)
    texts = list(open_dataset(data, "val").transcripts())
    lm_path = str(root / "char.arpa")
    train_char_lm(texts, order=3).write_arpa(lm_path)
    lex_path = str(root / "words.txt")
    words = sorted({w for t in texts for w in uxxxx_to_utf8(t).split()})
    with open(lex_path, "w") as f:
        f.write("\n".join(words) + "\n")
    return data, os.path.join(run, "last"), lm_path, lex_path, root


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


_FLAGS = {"decoder": "--decoder", "beam_impl": "--beam-impl",
          "lm_path": "--lm", "lexicon_path": "--lexicon", "nbest": "--nbest"}


def _both(case, tag, **kw):
    """The JAX run_inference and the port's CLI on the val split, with
    their --out records and posterior dumps."""
    data, snap, _, _, root = case
    out = {}
    for pkg in ("jax", "port"):
        path = str(root / f"{tag}_{pkg}.jsonl")
        dump = str(root / f"{tag}_{pkg}_dump")
        if pkg == "jax":
            report = jax_infer.run_inference(
                snap, data, "val", out_path=path, dump_posteriors=dump,
                log=lambda *a: None, **kw)
        else:
            argv = ["--snapshot", snap, "--data", data, "--split", "val",
                    "--out", path, "--dump-posteriors", dump,
                    "--device", "cpu"]
            for k, v in kw.items():
                argv += [_FLAGS[k], str(v)]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                infer.main(argv)
            report = json.loads(buf.getvalue().strip().splitlines()[-1])
        out[pkg] = (report, _records(path), dump)
    return out


def _check_same(runs, scored):
    (rj, recs_j, _), (rp, recs_p, _) = runs["jax"], runs["port"]
    assert set(rp) == set(rj)
    for key in ("lines", "cer", "wer", "decoder", "split", "snapshot"):
        assert rp[key] == rj[key], key
    assert rp["lines"] == 32
    assert [r["id"] for r in recs_p] == [r["id"] for r in recs_j]
    assert [r["hyp_uxxxx"] for r in recs_p] == [r["hyp_uxxxx"] for r in recs_j]
    assert [r["ref_uxxxx"] for r in recs_p] == [r["ref_uxxxx"] for r in recs_j]
    assert any(r["hyp_uxxxx"] for r in recs_p)
    for a, b in zip(recs_p, recs_j):
        assert ("nbest" in a) == ("nbest" in b)
        if "nbest" in b:
            assert [h["hyp_uxxxx"] for h in a["nbest"]] == [
                h["hyp_uxxxx"] for h in b["nbest"]]
            for ha, hb in zip(a["nbest"], b["nbest"]):
                assert abs(ha["score"] - hb["score"]) <= 1e-3
    for a, b in zip(recs_p, recs_j):
        if scored:
            assert abs(a["conf"] - b["conf"]) <= 1e-3
        else:
            assert a["conf"] is b["conf"] is None
    if scored:
        assert abs(rp["mean_confidence"] - rj["mean_confidence"]) <= 1e-3


@pytest.fixture(scope="module")
def greedy_runs(case):
    return _both(case, "greedy")


def test_greedy_matches_jax(greedy_runs):
    _check_same(greedy_runs, scored=True)
    assert greedy_runs["port"][0]["cer"] < 0.9  # the snapshot learned


def test_host_beam_matches_jax(case):
    _, _, lm_path, lex_path, _ = case
    runs = _both(case, "beam", decoder="beam", beam_impl="host",
                 lm_path=lm_path, lexicon_path=lex_path)
    _check_same(runs, scored=False)
    assert runs["port"][0]["decoder"] == "beam:host"
    words = set(open(lex_path).read().split())
    for r in runs["port"][1]:
        assert set(r["hyp_text"].split()) <= words


@pytest.mark.parametrize("decoder", ["greedy", "beam"])
def test_offline_decoders_read_each_others_dumps(case, greedy_runs, decoder):
    _, _, lm_path, lex_path, root = case
    kw = {} if decoder == "greedy" else dict(lm_path=lm_path,
                                             lexicon_path=lex_path)
    hyps = {}
    for dump_pkg in ("jax", "port"):
        dump = greedy_runs[dump_pkg][2]
        for mod, tag in ((jax_offline, "jax"), (offline, "port")):
            out = str(root / f"off_{decoder}_{dump_pkg}_{tag}.jsonl")
            report = mod.decode_posteriors(dump, decoder=decoder,
                                           out_path=out,
                                           log=lambda *a: None, **kw)
            assert report["lines"] == 32
            hyps[dump_pkg, tag] = [(r["id"], r["hyp_uxxxx"])
                                   for r in _records(out)]
    for dump_pkg in ("jax", "port"):
        assert hyps[dump_pkg, "port"] == hyps[dump_pkg, "jax"]
    if decoder == "greedy":  # the dump holds what run_inference decoded
        recs = greedy_runs["port"][1]
        assert sorted(hyps["port", "port"]) == sorted(
            (r["id"], r["hyp_uxxxx"]) for r in recs)


# (options, scored): the device beam plain, with the char LM and lexicon
# fused, and n-best lists (fused: scores final on the device; plain: the
# CTC finals)
DEVICE_BEAM = {
    "plain": (dict(decoder="beam"), True),
    "lm_lexicon": (dict(decoder="beam", lm_path="lm", lexicon_path="lex"),
                   True),
    "nbest_lm_lexicon": (dict(decoder="beam", beam_impl="device",
                              lm_path="lm", lexicon_path="lex", nbest=4),
                         False),
    "nbest_plain": (dict(decoder="beam", nbest=4), False),
}


@pytest.mark.parametrize("name", list(DEVICE_BEAM))
def test_device_beam_matches_jax(case, name):
    _, _, lm_path, lex_path, _ = case
    kw, scored = DEVICE_BEAM[name]
    kw = {k: {"lm": lm_path, "lex": lex_path}.get(v, v) for k, v in kw.items()}
    runs = _both(case, f"dev_{name}", **kw)
    _check_same(runs, scored=scored)
    report = runs["port"][0]
    assert report["decoder"] == "beam:device"
    if "lm_path" in kw:
        assert report["lm_fusion"] == "device-interleaved"
    if kw.get("nbest"):
        assert all(1 <= len(r["nbest"]) <= 4 for r in runs["port"][1])


# the id as it was while the device beam's cases shared the list; int8
# is ported (tests/test_torch_port_quant.py), a mode neither package has
# raises as in JAX
@pytest.mark.parametrize("kw", [pytest.param(dict(quantize="int4"),
                                             id="kw2")])
def test_unported_options_raise(case, kw):
    data, snap, _, _, _ = case
    with pytest.raises(ValueError, match="unknown --quantize mode"):
        infer.run_inference(snap, data, "val", device="cpu",
                            log=lambda *a: None, **kw)
