"""Service soak: N client threads flood ``submit()`` with mixed widths,
heights (the contract's and others) and arrival jitter for a wall-clock
budget; report totals, failures and latency percentiles.

Counterpart of ``scripts/soak_service.py`` (same flags, plus
``--device``; the same JSON report):

    python -m vistaocr_tpu_torch.serve.soak --snapshot /tmp/run/best \\
        --seconds 300 [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np

from ..decode import BeamConfig
from .service import OcrService, ServiceConfig


def soak(svc: OcrService, seconds: float, clients: int, seed: int) -> dict:
    """Run the clients against ``svc`` for ``seconds``; the report."""
    H = svc.contract.height
    wmax = svc.contract.bucket_widths[-1]
    stop = time.time() + seconds
    lock = threading.Lock()
    latencies: list = []
    errors: list = []
    done = [0]

    def client(cid: int):
        rng = np.random.default_rng(seed * 100 + cid)
        while time.time() < stop:
            w = int(rng.integers(32, wmax))
            h = int(rng.choice([H, H, H, rng.integers(H // 2, 2 * H)]))
            img = rng.integers(0, 255, (h, w)).astype(np.uint8)
            t0 = time.time()
            try:
                r = svc.submit(img).result(timeout=120)
                lat = (time.time() - t0) * 1000.0
                with lock:
                    latencies.append(lat)
                    done[0] += 1
                assert isinstance(r.uxxxx, str)
            except Exception as e:  # noqa: BLE001 — soak records everything
                with lock:
                    errors.append(repr(e))
            if rng.random() < 0.1:
                time.sleep(float(rng.uniform(0, 0.05)))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(clients)]
    t_start = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.time() - t_start
    lat = np.sort(np.asarray(latencies)) if latencies else np.zeros(1)
    return {
        "seconds": round(wall, 1),
        "clients": clients,
        "lines": done[0],
        "lines_per_sec": round(done[0] / wall, 1),
        "errors": len(errors),
        "p50_ms": round(float(lat[len(lat) // 2]), 1),
        "p99_ms": round(float(lat[min(len(lat) - 1, int(len(lat) * 0.99))]),
                        1),
        "stats": dict(svc.stats),
        "first_errors": errors[:3],
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--snapshot", required=True)
    p.add_argument("--seconds", type=float, default=300.0)
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--max-wait-ms", type=float, default=3.0)
    p.add_argument("--decoder", choices=("greedy", "beam"), default="greedy")
    p.add_argument("--lexicon", default=None)
    p.add_argument("--word-lm", default=None)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    svc = OcrService(args.snapshot, ServiceConfig(
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        decoder=args.decoder,
        lexicon_path=args.lexicon,
        word_lm_path=args.word_lm,
        beam=BeamConfig(word_lm_alpha=0.6 if args.word_lm else 0.0,
                        word_lm_beta=0.3 if args.word_lm else 0.0),
    ), device=args.device)
    try:
        report = soak(svc, args.seconds, args.clients, args.seed)
    finally:
        svc.close()
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
