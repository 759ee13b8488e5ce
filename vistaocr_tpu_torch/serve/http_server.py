"""HTTP front for the batched OCR service.

Counterpart of ``vistaocr_tpu/serve/http_server.py``, route for route:
a standard-library ``ThreadingHTTPServer`` whose handler threads block on
``OcrService`` futures, so concurrent requests coalesce into device
batches through the width-routed queues. Bodies are decoded without PIL
by ``imagecodec.decode_image``, whose arrays equal Pillow's, so the
service sees what the JAX server hands its own.

API:
    GET  /healthz          -> {"ok": true}
    GET  /stats            -> service counters
    POST /ocr              -> body: PNG/JPEG bytes, or JSON
                              {"image_b64": "..."}; response:
                              {"text", "uxxxx", "latency_ms", "bucket_width",
                              "confidence"} (+ "text_logical" when the
                              scan-order text differs)
    POST /ocr_batch        -> JSON {"images_b64": ["...", ...]}; response
                              {"results": [per-image /ocr payloads, input
                              order], "lines", "wall_ms"}, answered through
                              ``ocr_lines`` (dispatch all, then finalize),
                              not the per-request queues

400 for a bad payload, an empty batch or an image the decoder refuses
(other formats than PNG and JPEG among them), 404 for an unknown path,
500 for a service error.

Usage (the card by default; ``--device cpu`` runs on the CPU):
    python -m vistaocr_tpu_torch.serve.http_server --snapshot <dir>/best \\
        --port 8400 [--decoder beam --lm <arpa>] [--quantize int8]
"""

from __future__ import annotations

import argparse
import base64
import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..decode import BeamConfig
from ..runtime import resolve_device
from . import imagecodec
from .service import OcrService, ServiceConfig


def make_handler(service: OcrService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload, ensure_ascii=False).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True})
            elif self.path == "/stats":
                self._send(200, dict(service.stats))
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path == "/ocr_batch":
                self._do_batch()
                return
            if self.path != "/ocr":
                self._send(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
                ctype = self.headers.get("Content-Type", "")
                if ctype.startswith("application/json"):
                    obj = json.loads(raw)
                    raw = base64.b64decode(obj["image_b64"])
                img = imagecodec.decode_image(raw)
            except Exception as e:
                self._send(400, {"error": f"bad image payload: {e}"})
                return
            try:
                result = service.submit(img).result(timeout=60)
            except Exception as e:
                self._send(500, {"error": str(e)})
                return
            self._send(200, self._result_payload(result))

        @staticmethod
        def _result_payload(result):
            payload = {
                "text": result.text,
                "uxxxx": result.uxxxx,
                "latency_ms": round(result.latency_ms, 2),
                "bucket_width": result.bucket_width,
                "confidence": (round(result.confidence, 5)
                               if result.confidence is not None else None),
            }
            logical = result.logical_text
            if logical != result.text:  # RTL model: scan-order output
                payload["text_logical"] = logical
            return payload

        def _do_batch(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                obj = json.loads(self.rfile.read(length))
                imgs = [imagecodec.decode_image(base64.b64decode(b))
                        for b in obj["images_b64"]]
            except Exception as e:
                self._send(400, {"error": f"bad batch payload: {e}"})
                return
            if not imgs:
                self._send(400, {"error": "images_b64 is empty"})
                return
            try:
                t0 = time.time()
                results = service.ocr_lines(imgs)
                wall_ms = (time.time() - t0) * 1000.0
            except Exception as e:
                self._send(500, {"error": str(e)})
                return
            self._send(200, {
                "results": [self._result_payload(r) for r in results],
                "lines": len(results),
                "wall_ms": round(wall_ms, 2),
            })

    return Handler


def serve(snapshot: str, port: int = 8400, host: str = "127.0.0.1",
          config: ServiceConfig = None, log=print, device="cuda"):
    """Build (or load) the image decoder, start the service, then bind the
    port and serve until interrupted. A device that is not there, or a
    decoder that cannot be built, raises here, before the port is bound."""
    resolve_device(device)
    imagecodec.load()
    service = OcrService(snapshot, config or ServiceConfig(), device=device)
    try:
        httpd = ThreadingHTTPServer((host, port), make_handler(service))
        log(f"serving OCR on http://{host}:{httpd.server_port} "
            f"(snapshot: {snapshot}, device: {service.device})")
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
    finally:
        service.close()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--snapshot", required=True)
    p.add_argument("--port", type=int, default=8400)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--decoder", choices=("greedy", "beam"), default="greedy")
    p.add_argument("--beam-impl", choices=("device", "host"), default="device",
                   help="beam engine: the search on the device (one CUDA "
                        "graph per batch shape on a card) or the host "
                        "C++/Python expansion")
    p.add_argument("--lm", default=None)
    p.add_argument("--lm-alpha", type=float, default=0.5)
    p.add_argument("--lexicon", default=None, metavar="WORDS",
                   help="word list: constrain beam hypotheses to lexicon "
                        "words (device trie with --decoder beam)")
    p.add_argument("--word-lm", default=None, metavar="ARPA",
                   help="word-level ARPA LM fused at word boundaries "
                        "(bigram on device with --lexicon)")
    p.add_argument("--word-lm-alpha", type=float, default=0.5)
    p.add_argument("--word-lm-beta", type=float, default=0.0)
    p.add_argument("--lex-unk-logp", type=float, default=0.0,
                   metavar="NEGLOGP",
                   help="open-vocabulary serving: per-character log "
                        "penalty for words outside --lexicon (e.g. -2.5; "
                        "0 keeps the hard constraint; see docs/decoding.md "
                        "'Open vocabulary in the service')")
    p.add_argument("--quantize", choices=("none", "int8"), default="none",
                   help="int8: serve the snapshot's shipped quantized "
                        "conv stack (qstack.msgpack; write it once with "
                        "python -m vistaocr_tpu_torch.models.quant)")
    p.add_argument("--quantize-float-prefix", type=int, default=0,
                   help="with --quantize int8: keep the first N convs in "
                        "float (mixed precision, see docs/decoding.md)")
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--no-device-resize", action="store_true",
                   help="height-normalize on the host (PIL's BILINEAR in "
                        "numpy) instead of on the device")
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    cfg = ServiceConfig(
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        decoder=args.decoder,
        beam_impl=args.beam_impl,
        beam=BeamConfig(
            lm_alpha=args.lm_alpha if args.lm else 0.0,
            word_lm_alpha=args.word_lm_alpha if args.word_lm else 0.0,
            word_lm_beta=args.word_lm_beta,
            lex_unk_logp=args.lex_unk_logp if args.lexicon else 0.0,
        ),
        lm_path=args.lm,
        lexicon_path=args.lexicon,
        word_lm_path=args.word_lm,
        device_resize=not args.no_device_resize,
        warmup=not args.no_warmup,
        quantize=args.quantize,
        quantize_float_prefix=args.quantize_float_prefix,
    )
    serve(args.snapshot, args.port, args.host, cfg, device=args.device)


if __name__ == "__main__":
    main()
