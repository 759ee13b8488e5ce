"""The port's HTTP server (``vistaocr_tpu_torch.serve.http_server``)
against the JAX package's, each over its own package's ``OcrService`` on
the same seeded, untrained tiny snapshot written by the JAX package (the
port's on the CPU): the same bodies (PNG and JPEG, grey and colour, raw
and as JSON base64, ``/ocr_batch``, ``/healthz``, ``/stats`` and the
error cases) give the same status codes and the same JSON, apart from
``latency_ms`` and ``wall_ms`` (timings), ``confidence`` within 1e-3 (the
service tests' bound) and the text of an error after its prefix (the
decoders word their exceptions differently). The bodies include a 4-bit
palette PNG and a 16-bit grey PNG (both services take the indices and
the low bytes, as ``to_grayscale`` does in each) and an LA PNG (refused
by ``to_grayscale``: a 500 from both). Also: ``/ocr_batch`` keeps
the order of single requests, an RTL alphabet's ``text_logical``,
``main --device cuda`` raising without a card, and a decoder that cannot
be built (g++ hidden from ``PATH``) making ``serve`` raise before it
binds its port. ``serve.soak`` runs 2 s with no error and the JAX
script's report keys."""

import base64
import io
import json
import os
import socket
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
from PIL import Image

import jax
import torch

from vistaocr_tpu import checkpoint as jax_ckpt
from vistaocr_tpu.data.buckets import ShapeContract as JaxContract
from vistaocr_tpu.models import CnnLstmOcr as JaxModel
from vistaocr_tpu.models import ModelConfig as JaxConfig
from vistaocr_tpu.models.cnn import ConvStageSpec as JaxStage
from vistaocr_tpu.serve import OcrService as JaxService
from vistaocr_tpu.serve import ServiceConfig as JaxServiceConfig
from vistaocr_tpu.serve.http_server import make_handler as jax_make_handler
from vistaocr_tpu.text import Alphabet as JaxAlphabet

from vistaocr_tpu_torch.serve import OcrService, ServiceConfig, http_server
from vistaocr_tpu_torch.serve import imagecodec, soak

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "tests", "torch_port_images")


def _snapshot(path: str, charset: str, seed: int) -> str:
    """The tiny JAX snapshot of tests/test_torch_port_service.py."""
    cfg = JaxConfig(
        num_classes=len(charset) + 1, line_height=32,
        stages=(JaxStage(8, 2, (2, 2)), JaxStage(16, 2, (2, 2)),
                JaxStage(16, 2, (2, 1))),
        bridge_dim=32, lstm_hidden=24, lstm_layers=2, dropout=0.0,
        compute_dtype="float32", lstm_impl="scan")
    variables = JaxModel(cfg).init_params(jax.random.PRNGKey(seed), batch=2,
                                          width=64)
    jax_ckpt.save_snapshot(
        path, variables=variables, model_config=cfg,
        alphabet=JaxAlphabet.from_charset(charset),
        contract=JaxContract(bucket_widths=(128, 256, 384)))
    return path


def _start(handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_port}"


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """(JAX base URL, port base URL) for each alphabet."""
    out, stops = {}, []
    for name, charset, seed in (("latin", "abcdeo ", 3),
                                ("rtl", "אבגד ", 5)):
        snap = _snapshot(str(tmp_path_factory.mktemp(name)), charset, seed)
        jsvc = JaxService(snap, JaxServiceConfig(max_batch=4, warmup=False))
        psvc = OcrService(snap, ServiceConfig(max_batch=4, warmup=False),
                          device="cpu")
        jhttpd, jurl = _start(jax_make_handler(jsvc))
        phttpd, purl = _start(http_server.make_handler(psvc))
        out[name] = (jurl, purl, snap)
        stops += [(jhttpd, jsvc), (phttpd, psvc)]
    yield out
    for httpd, svc in stops:
        httpd.shutdown()
        httpd.server_close()
        svc.close()


def _request(url, data=None, content_type=None):
    req = urllib.request.Request(
        url, data=data, method="POST" if data is not None else "GET",
        headers={"Content-Type": content_type} if content_type else {})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _lines():
    rng = np.random.default_rng(17)
    out = []
    for w in (20, 64, 127, 129, 200, 300, 384):
        img = np.full((32, w), 255, np.uint8)
        for _ in range(max(3, w // 8)):
            y, x = int(rng.integers(2, 30)), int(rng.integers(0, w))
            img[y - 2: y + 2, x: x + int(rng.integers(1, 9))] = int(
                rng.integers(0, 90))
        out.append(img)
    out.append(rng.integers(0, 256, (48, 150), np.uint8))
    return out


def _encode(img, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    if isinstance(img, np.ndarray):
        img = Image.fromarray(img)
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def _bodies():
    """(path, body, content type) of every request both servers get."""
    lines = _lines()
    colour = np.stack([lines[4], np.roll(lines[4], 2, 1), 255 - lines[4]],
                      -1)
    pngs = [_encode(img, "PNG") for img in lines]
    jpegs = [_encode(lines[i], "JPEG", quality=q) for i, q in
             ((1, 90), (3, 50), (5, 95))]
    jpegs.append(_encode(colour, "JPEG", quality=85, subsampling=2))
    pngs.append(_encode(colour, "PNG"))
    with open(os.path.join(CORPUS, "rgb420_prog_opt_64x1024_q75.jpg"),
              "rb") as f:
        jpegs.append(f.read())
    # Pillow's other PNG modes: palette indices and 16-bit grey (which
    # both services' to_grayscale cut to the low byte) go through; LA is
    # refused by to_grayscale, a service error (500) in both
    pngs.append(_encode(Image.fromarray(colour).quantize(16), "PNG",
                        bits=4))
    pngs.append(_encode(lines[2].astype(np.uint16) * 257 + 5, "PNG"))
    la = _encode(Image.fromarray(np.dstack([lines[1], lines[1]]), "LA"),
                 "PNG")
    b64 = lambda raw: base64.b64encode(raw).decode()  # noqa: E731
    out = [("/ocr", raw, "image/png") for raw in pngs]
    out += [("/ocr", raw, "image/jpeg") for raw in jpegs]
    out += [("/ocr", json.dumps({"image_b64": b64(raw)}).encode(),
             "application/json") for raw in (pngs[2], jpegs[0])]
    out.append(("/ocr_batch", json.dumps({"images_b64": [
        b64(raw) for raw in pngs[:4] + jpegs[:2] + pngs[-2:]]}).encode(),
        "application/json"))
    tiff = b"II*\x00" + bytes(60)
    out += [
        ("/ocr", la, "image/png"),
        ("/ocr", b"not an image", "image/png"),
        ("/ocr", tiff, "image/tiff"),
        ("/ocr", pngs[0][:40], "image/png"),
        ("/ocr", b"{broken", "application/json"),
        ("/ocr", json.dumps({"image": "x"}).encode(), "application/json"),
        ("/ocr_batch", json.dumps({"images_b64": []}).encode(),
         "application/json"),
        ("/ocr_batch", b"{broken", "application/json"),
        ("/ocr_batch", json.dumps({"images_b64": [b64(tiff)]}).encode(),
         "application/json"),
        ("/nowhere", b"x", "image/png"),
    ]
    return out


def _strip(obj):
    """Drop the timings."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if k not in ("latency_ms", "wall_ms")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _same_answer(a, b, what):
    (sa, ja), (sb, jb) = a, b
    assert sa == sb, (what, a, b)
    if "error" in ja:
        assert set(ja) == set(jb) == {"error"}, (what, ja, jb)
        assert ja["error"].split(":")[0] == jb["error"].split(":")[0], what
        return
    ja, jb = _strip(ja), _strip(jb)
    results_a = ja.get("results", [ja] if "text" in ja else [])
    results_b = jb.get("results", [jb] if "text" in jb else [])
    assert len(results_a) == len(results_b), what
    for ra, rb in zip(results_a, results_b):
        assert abs(ra.pop("confidence") - rb.pop("confidence")) <= 1e-3, what
    assert ja == jb, what


def test_every_route_answers_as_the_jax_server(servers):
    jurl, purl, _ = servers["latin"]
    for path in ("/healthz", "/stats", "/nowhere"):
        _same_answer(_request(jurl + path), _request(purl + path), path)
    for i, (path, body, ctype) in enumerate(_bodies()):
        ours = _request(purl + path, body, ctype)
        theirs = _request(jurl + path, body, ctype)
        _same_answer(theirs, ours, (i, path, ctype))
    sj, stats_j = _request(jurl + "/stats")
    sp, stats_p = _request(purl + "/stats")
    assert sj == sp == 200 and stats_j["lines"] == stats_p["lines"] > 10


def test_batch_keeps_the_order_of_single_requests(servers):
    _, purl, _ = servers["latin"]
    b64s = [base64.b64encode(_encode(img, "PNG")).decode()
            for img in _lines()]
    status, body = _request(purl + "/ocr_batch", json.dumps(
        {"images_b64": b64s}).encode(), "application/json")
    assert status == 200 and body["lines"] == len(b64s)
    singles = [_request(purl + "/ocr", json.dumps({"image_b64": b}).encode(),
                        "application/json")[1]["text"] for b in b64s]
    assert [r["text"] for r in body["results"]] == singles


def test_rtl_text_logical(servers):
    jurl, purl, _ = servers["rtl"]
    seen = 0
    for img in _lines():
        raw = _encode(img, "PNG")
        ours = _request(purl + "/ocr", raw, "image/png")
        _same_answer(_request(jurl + "/ocr", raw, "image/png"), ours, "rtl")
        seen += "text_logical" in ours[1]
    assert seen > 0  # the check above covered the key


def test_main_on_cuda_raises_without_a_card(servers, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    _, _, snap = servers["latin"]
    with pytest.raises(RuntimeError, match="cuda"):
        http_server.main(["--snapshot", snap, "--port", "0",
                          "--device", "cuda"])


def test_failed_decoder_build_raises_before_binding(servers, tmp_path,
                                                    monkeypatch):
    _, _, snap = servers["latin"]
    monkeypatch.setattr(imagecodec, "_lib", None)
    monkeypatch.setattr(imagecodec, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    with pytest.raises(RuntimeError, match="g.. not found"):
        http_server.serve(snap, port=port, device="cpu", log=lambda *a: None)
    probe = socket.socket()
    try:  # nothing was bound: the port is still free
        probe.bind(("127.0.0.1", port))
    finally:
        probe.close()


def test_soak_runs_without_errors(servers):
    _, _, snap = servers["latin"]
    report = soak.main(["--snapshot", snap, "--seconds", "2", "--clients",
                        "4", "--max-batch", "4", "--device", "cpu"])
    assert set(report) == {"seconds", "clients", "lines", "lines_per_sec",
                           "errors", "p50_ms", "p99_ms", "stats",
                           "first_errors"}
    assert report["errors"] == 0 and report["lines"] > 0, report
