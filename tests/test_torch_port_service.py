"""The port's OcrService against the JAX OcrService on one seeded,
untrained tiny snapshot written by the JAX package: the same numpy lines
(mixed widths at the contract height, plus lines at odd heights that take
the on-device resize) through ``ocr_lines`` and ``submit`` give equal
texts, equal bucket widths and confidences within 1e-3; the host routes
(``decoder="beam"`` with ``beam_impl="host"``, a char LM, a lexicon and a
word LM; ``device_resize=False``, the host resize) give the JAX service's
texts on colour lines, PIL images and lines off the contract height; the
device beam (``beam_impl="device"``, the default: plain, the char LM
fused at order 3 and 4 or rescored in two passes, the lexicon with and
without the ``<unk>`` bypass, the word LM) and ``device_deskew`` give
the JAX service's texts and confidences on lines at and off the contract
height. Options the port does not have yet raise instead of being
ignored."""

import numpy as np
import pytest

import jax
import torch

from vistaocr_tpu import checkpoint as jax_ckpt
from vistaocr_tpu.decode import BeamConfig as JaxBeamConfig
from vistaocr_tpu.data.buckets import ShapeContract as JaxContract
from vistaocr_tpu.models import CnnLstmOcr as JaxModel
from vistaocr_tpu.models import ModelConfig as JaxConfig
from vistaocr_tpu.models.cnn import ConvStageSpec as JaxStage
from vistaocr_tpu.serve import OcrService as JaxService
from vistaocr_tpu.serve import ServiceConfig as JaxServiceConfig
from vistaocr_tpu.text import Alphabet as JaxAlphabet

from vistaocr_tpu_torch.data import ShapeContract
from vistaocr_tpu_torch.decode import BeamConfig
from vistaocr_tpu_torch.serve import OcrService, ServiceConfig

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    cfg = JaxConfig(
        num_classes=8, line_height=32,
        stages=(JaxStage(8, 2, (2, 2)), JaxStage(16, 2, (2, 2)),
                JaxStage(16, 2, (2, 1))),
        bridge_dim=32, lstm_hidden=24, lstm_layers=2, dropout=0.0,
        compute_dtype="float32", lstm_impl="scan")
    variables = JaxModel(cfg).init_params(jax.random.PRNGKey(3), batch=2,
                                          width=64)
    path = str(tmp_path_factory.mktemp("port_svc"))
    jax_ckpt.save_snapshot(
        path, variables=variables, model_config=cfg,
        alphabet=JaxAlphabet.from_charset("abcdeo "),
        contract=JaxContract(bucket_widths=(128, 256, 384)))
    return path


def _lines():
    rng = np.random.default_rng(17)
    out = []
    for w in (20, 64, 100, 127, 128, 129, 200, 255, 300, 333, 380, 384):
        img = np.full((32, w), 255, np.uint8)
        for _ in range(max(3, w // 8)):
            y, x = int(rng.integers(2, 30)), int(rng.integers(0, w))
            img[y - 2: y + 2, x: x + int(rng.integers(1, 9))] = int(
                rng.integers(0, 90))
        out.append(img)
    out.append(rng.integers(0, 256, (48, 150), np.uint8))
    out.append(rng.integers(0, 256, (77, 200), np.uint8))
    return out


def _compare(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.text == b.text
        assert a.uxxxx == b.uxxxx
        assert a.bucket_width == b.bucket_width
        assert abs(a.confidence - b.confidence) <= 1e-3
        assert 0 < a.confidence <= 1 and a.latency_ms > 0


@pytest.fixture(scope="module")
def services(snapshot):
    cfg = dict(max_batch=8, max_wait_ms=5.0, warmup=False)
    theirs = JaxService(snapshot, JaxServiceConfig(**cfg))
    ours = OcrService(snapshot, ServiceConfig(**cfg), device="cpu")
    yield ours, theirs
    ours.close()
    theirs.close()


class TestAgainstJaxService:
    def test_ocr_lines(self, services):
        ours, theirs = services
        lines = _lines()
        got, want = ours.ocr_lines(lines), theirs.ocr_lines(lines)
        _compare(got, want)
        assert {r.bucket_width for r in got} == {128, 256, 384}
        assert any(r.text for r in got)

    def test_submit(self, services):
        ours, theirs = services
        lines = _lines()
        got = [f.result(timeout=120) for f in map(ours.submit, lines)]
        want = [f.result(timeout=120) for f in map(theirs.submit, lines)]
        _compare(got, want)

    def test_stats_and_ladders(self, services):
        ours, theirs = services
        assert ours.contract == ShapeContract.from_json(
            theirs.contract.to_json())
        assert ours._batch_sizes == theirs._batch_sizes
        assert set(ours.init_timings) == set(theirs.init_timings)
        n = ours.stats["lines"]
        ours.ocr_lines(_lines()[:3])
        assert ours.stats["lines"] == n + 3


def _colour_lines():
    """Colour (RGB, RGBA) and grayscale lines at and off the contract
    height, as arrays and as PIL images."""
    from PIL import Image

    rng = np.random.default_rng(23)
    gray = _lines()
    out = []
    for i, g in enumerate(gray[:8] + gray[-2:]):
        rgb = np.stack([g, np.roll(g, i, axis=1), 255 - g // 3], axis=-1)
        rgb = rgb.astype(np.uint8)
        if i % 3 == 1:  # RGBA with a random alpha
            rgb = np.concatenate(
                [rgb, rng.integers(0, 256, g.shape + (1,), np.uint8)], -1)
        out.append(Image.fromarray(rgb) if i % 4 == 3 else rgb)
    out.append(np.repeat(gray[3], 2, axis=0))  # twice the contract height
    out.append(gray[5][::2])  # half of it
    return out


@pytest.fixture(scope="module")
def host_beam_files(tmp_path_factory):
    """A char LM and a lexicon over the snapshot's alphabet."""
    from vistaocr_tpu_torch.decode.lm import train_char_lm
    from vistaocr_tpu_torch.text import utf8_to_uxxxx

    words = ["a", "ab", "bad", "bead", "cab", "code", "dec", "deco",
             "ebb", "odd", "ode"]
    d = tmp_path_factory.mktemp("host_beam")
    texts = [" ".join(words[i:i + 3]) for i in range(len(words))]
    lm_path = str(d / "char.arpa")
    train_char_lm([utf8_to_uxxxx(t) for t in texts], order=3).write_arpa(
        lm_path)
    lex_path = str(d / "words.txt")
    with open(lex_path, "w") as f:
        f.write("\n".join(words) + "\n")
    return lm_path, lex_path


class TestHostRoutes:
    @pytest.mark.parametrize("decoder", ["greedy", "beam"])
    def test_host_resize_and_host_beam_match_jax(self, snapshot,
                                                 host_beam_files, decoder):
        lm_path, lex_path = host_beam_files
        kw = dict(max_batch=8, warmup=False, device_resize=False)
        jkw, pkw = dict(kw), dict(kw)
        if decoder == "beam":
            beam = dict(decoder="beam", beam_impl="host", lm_path=lm_path,
                        lexicon_path=lex_path)
            jkw.update(beam, beam=JaxBeamConfig(lm_alpha=0.5, beam_width=8))
            pkw.update(beam, beam=BeamConfig(lm_alpha=0.5, beam_width=8))
        theirs = JaxService(snapshot, JaxServiceConfig(**jkw))
        ours = OcrService(snapshot, ServiceConfig(**pkw), device="cpu")
        try:
            lines = _colour_lines()
            got, want = ours.ocr_lines(lines), theirs.ocr_lines(lines)
            got.append(ours.submit(lines[2]).result(timeout=120))
            want.append(theirs.submit(lines[2]).result(timeout=120))
        finally:
            ours.close()
            theirs.close()
        assert [r.text for r in got] == [r.text for r in want]
        assert [r.uxxxx for r in got] == [r.uxxxx for r in want]
        assert [r.bucket_width for r in got] == [r.bucket_width for r in want]
        if decoder == "beam":
            assert all(r.confidence is None for r in got)
            words = set(open(lex_path).read().split())
            assert any(r.text for r in got)
            assert all(set(r.text.split()) <= words for r in got)
        else:
            for a, b in zip(got, want):
                assert abs(a.confidence - b.confidence) <= 1e-3


@pytest.fixture(scope="module")
def device_beam_files(tmp_path_factory, host_beam_files):
    """An order-4 char LM and a word-bigram LM over the lexicon's words,
    beside ``host_beam_files``' order-3 char LM and lexicon."""
    from vistaocr_tpu_torch.decode.lm import train_char_lm
    from vistaocr_tpu_torch.text import utf8_to_uxxxx

    lm_path, lex_path = host_beam_files
    words = open(lex_path).read().split()
    d = tmp_path_factory.mktemp("device_beam")
    texts = [" ".join(words[i:i + 3]) for i in range(len(words))]
    lm4_path = str(d / "char4.arpa")
    train_char_lm([utf8_to_uxxxx(t) for t in texts], order=4).write_arpa(
        lm4_path)
    wlm_path = str(d / "words.arpa")
    train_char_lm(texts * 3, order=2).write_arpa(wlm_path)
    return {"lm": lm_path, "lm4": lm4_path, "lex": lex_path,
            "wlm": wlm_path}


def _beam_lines():
    """Lines of one bucket at the contract height, and two off it (the
    device resize): one compiled JAX program a route."""
    rng = np.random.default_rng(31)
    out = []
    for w in (24, 60, 96, 110, 128):
        img = np.full((32, w), 255, np.uint8)
        for _ in range(max(3, w // 6)):
            y, x = int(rng.integers(3, 29)), int(rng.integers(0, w))
            img[y - 3: y + 3, x: x + int(rng.integers(1, 6))] = int(
                rng.integers(0, 70))
        out.append(img)
    out.append(np.repeat(out[2], 2, axis=0)[:, :120])  # height 64
    out.append(rng.integers(0, 256, (48, 150), np.uint8))
    return out


# the device beam (the default beam_impl) with each of its tables, and
# device deskew: (name, options, BeamConfig fields) with the file names of
# device_beam_files
DEVICE_ROUTES = [
    ("plain", dict(decoder="beam"), {}),
    ("char_lm3", dict(decoder="beam", lm_path="lm"), dict(lm_alpha=0.6)),
    ("lexicon", dict(decoder="beam", lexicon_path="lex"), {}),
    ("word_lm", dict(decoder="beam", lexicon_path="lex", word_lm_path="wlm"),
     dict(word_lm_alpha=0.8, word_lm_beta=0.3)),
    ("full_stack_unk", dict(decoder="beam", lm_path="lm", lexicon_path="lex",
                            word_lm_path="wlm"),
     dict(lm_alpha=0.5, lm_beta=0.2, word_lm_alpha=0.7, lex_unk_logp=-2.0)),
    ("char_lm4_deskew", dict(decoder="beam", lm_path="lm4",
                             device_deskew=True), dict(lm_alpha=0.6)),
    ("two_pass_host_resize", dict(decoder="beam", lm_path="lm",
                                  device_lm=False, device_resize=False),
     dict(lm_alpha=0.6)),
    ("greedy_deskew", dict(device_deskew=True), {}),
]


class TestDeviceRoutes:
    @pytest.mark.parametrize("name,opts,beam", DEVICE_ROUTES,
                             ids=[r[0] for r in DEVICE_ROUTES])
    def test_matches_jax(self, snapshot, device_beam_files, name, opts,
                         beam):
        opts = {k: (device_beam_files[v] if k.endswith("_path") else v)
                for k, v in opts.items()}
        kw = dict(max_batch=8, warmup=False, **opts)
        bc = dict(beam_width=8, topk=4, **beam)
        theirs = JaxService(snapshot, JaxServiceConfig(
            **kw, beam=JaxBeamConfig(**bc)))
        ours = OcrService(snapshot, ServiceConfig(**kw, beam=BeamConfig(**bc)),
                          device="cpu")
        try:
            lines = _beam_lines()
            got, want = ours.ocr_lines(lines), theirs.ocr_lines(lines)
            got.append(ours.submit(lines[3]).result(timeout=120))
            want.append(theirs.submit(lines[3]).result(timeout=120))
        finally:
            ours.close()
            theirs.close()
        _compare(got, want)
        if "lexicon_path" in opts and not beam.get("lex_unk_logp"):
            # lexicon words; the last may be a word's prefix where no beam
            # ends at a word boundary (the fallback to every beam)
            words = open(opts["lexicon_path"]).read().split()
            for r in got:
                *head, last = r.text.split() or [""]
                assert set(head) <= set(words)
                assert any(w.startswith(last) for w in words)


class TestOptions:
    # int8 without the snapshot's qstack (int8 is ported: the JAX error)
    # and a data mesh over more devices than there are (the mesh is
    # ported: the JAX make_mesh error); the ids as they were while the
    # device beam's and deskew's cases shared the list
    @pytest.mark.parametrize("kw,error", [
        pytest.param({"quantize": "int8"}, ValueError, id="kw5"),
        pytest.param({"mesh_data": 4}, ValueError, id="kw6")])
    def test_unported_options_raise(self, snapshot, kw, error):
        with pytest.raises(error):
            OcrService(snapshot, ServiceConfig(warmup=False, **kw),
                       device="cpu")

    def test_device_word_lm_needs_a_lexicon(self, snapshot,
                                            device_beam_files):
        with pytest.raises(ValueError, match="lexicon_path"):
            OcrService(snapshot, ServiceConfig(
                decoder="beam", word_lm_path=device_beam_files["wlm"],
                warmup=False), device="cpu")

    def test_cuda_without_a_card_raises(self, snapshot):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError):
            OcrService(snapshot, ServiceConfig(warmup=False), device="cuda")

    def test_batch_ladder_and_warmup(self, snapshot):
        svc = OcrService(snapshot, ServiceConfig(max_batch=128),
                         device="cpu")
        try:
            assert svc._batch_sizes == (8, 32, 128)
            assert svc.init_timings["warmup_graphs"] == 3 * 3
            assert svc.stats["lines"] == 0
        finally:
            svc.close()
