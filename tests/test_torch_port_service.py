"""The port's OcrService against the JAX OcrService on one seeded,
untrained tiny snapshot written by the JAX package: the same numpy lines
(mixed widths at the contract height, plus lines at odd heights that take
the on-device resize) through ``ocr_lines`` and ``submit`` give equal
texts, equal bucket widths and confidences within 1e-3. Options the port
does not have yet raise instead of being ignored."""

import numpy as np
import pytest

import jax
import torch

from vistaocr_tpu import checkpoint as jax_ckpt
from vistaocr_tpu.data.buckets import ShapeContract as JaxContract
from vistaocr_tpu.models import CnnLstmOcr as JaxModel
from vistaocr_tpu.models import ModelConfig as JaxConfig
from vistaocr_tpu.models.cnn import ConvStageSpec as JaxStage
from vistaocr_tpu.serve import OcrService as JaxService
from vistaocr_tpu.serve import ServiceConfig as JaxServiceConfig
from vistaocr_tpu.text import Alphabet as JaxAlphabet

from vistaocr_tpu_torch.data import ShapeContract
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


class TestOptions:
    @pytest.mark.parametrize("kw", [
        {"decoder": "beam"}, {"lm_path": "lm.arpa"},
        {"lexicon_path": "words.txt"}, {"word_lm_path": "w.arpa"},
        {"device_deskew": True}, {"quantize": "int8"}, {"mesh_data": 4},
        {"device_resize": False},
    ])
    def test_unported_options_raise(self, snapshot, kw):
        with pytest.raises(NotImplementedError):
            OcrService(snapshot, ServiceConfig(warmup=False, **kw),
                       device="cpu")

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
