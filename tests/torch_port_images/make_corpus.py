"""Write the image corpus of ``tests/torch_port_images`` with Pillow, and
its ``manifest.json``: for each file, the sha256 of the bytes of
``np.asarray(PIL.Image.open(file))``, its dtype and its shape.

The port's decoder (``vistaocr_tpu_torch.serve.imagecodec``) is held to
the manifest without PIL on the card machine (``chip_smoke.py``), and to
Pillow itself here (``tests/test_torch_port_imagecodec.py``). Text-like
lines at real widths (up to 2048), seeded; every JPEG form the decoder
takes (grey and RGB, 4:4:4, 4:2:2, 4:2:0, baseline and progressive,
optimized tables, restart intervals, an Adobe RGB file, EXIF orientation,
1x1) and the PNG modes Pillow writes.

    python tests/torch_port_images/make_corpus.py
    python tests/torch_port_images/make_corpus.py --time  # writes nothing

``--time`` prints the median ms an image of Pillow and of the port's
decoder on the timed trio of ``chip_smoke.py`` (``DECODE_TIMED``), on
this machine's CPU.
"""

import hashlib
import io
import json
import os
import sys
import time

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))


def text_line(rng, h: int, w: int, rgb: bool = False) -> np.ndarray:
    """Paper with dark strokes and a little scanner noise."""
    img = np.full((h, w), 246, np.int32)
    x = int(rng.integers(2, 12))
    while x < w - 4:
        cw = int(rng.integers(3, 10))
        for _ in range(int(rng.integers(1, 4))):
            y0 = int(rng.integers(h // 5, h // 2))
            y1 = int(rng.integers(h // 2, h - h // 5))
            x0 = x + int(rng.integers(0, cw))
            img[y0:y1, x0:x0 + int(rng.integers(1, 3))] = int(
                rng.integers(10, 80))
        x += cw + int(rng.integers(1, 4)) + (8 if rng.random() < 0.15 else 0)
    img += rng.integers(-4, 5, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    if rgb:
        img = np.stack([img, np.clip(img.astype(int) + 12, 0, 255),
                        np.clip(img.astype(int) - 25, 0, 255)],
                       -1).astype(np.uint8)
    return img


def _exif_orientation(value: int) -> bytes:
    exif = Image.Exif()
    exif[0x0112] = value
    return exif.tobytes()


def files():
    rng = np.random.default_rng(20261017)
    g64 = text_line(rng, 64, 2048)
    L = lambda h, w: Image.fromarray(text_line(rng, h, w))  # noqa: E731
    C = lambda h, w: Image.fromarray(text_line(rng, h, w, True))  # noqa: E731
    out = {
        # the smoke's timed trio: a 64x2048 grey line as PNG and as JPEG,
        # and a 32x2048 RGB 4:2:0 JPEG
        "grey_64x2048.png": (Image.fromarray(g64), "PNG", {}),
        "grey_64x2048_q90.jpg": (Image.fromarray(g64), "JPEG",
                                 dict(quality=90)),
        "rgb420_32x2048_q90.jpg": (C(32, 2048), "JPEG",
                                   dict(quality=90, subsampling=2)),
        "grey_32x1000.png": (L(32, 1000), "PNG", {}),
        "rgb_32x777.png": (C(32, 777), "PNG", {}),
        "rgba_32x513.png": (Image.fromarray(np.dstack(
            [text_line(rng, 32, 513, True),
             np.full((32, 513), 200, np.uint8)])), "PNG", {}),
        "la_32x300.png": (Image.fromarray(np.dstack(
            [text_line(rng, 32, 300), np.full((32, 300), 255, np.uint8)]),
            "LA"), "PNG", {}),
        "bilevel_32x640.png": (Image.fromarray(text_line(rng, 32, 640) < 128),
                               "PNG", {}),
        "palette_32x900.png": (C(32, 900).quantize(64), "PNG", {}),
        "palette4_trns_32x257.png": (C(32, 257).quantize(16), "PNG",
                                     dict(bits=4, transparency=3)),
        "grey16_32x400.png": (Image.fromarray(
            text_line(rng, 32, 400).astype(np.uint16) * 257 + 7), "PNG", {}),
        "rgb444_32x1200_q95.jpg": (C(32, 1200), "JPEG",
                                   dict(quality=95, subsampling=0)),
        "rgb422_48x999_q50.jpg": (C(48, 999), "JPEG",
                                  dict(quality=50, subsampling=1)),
        "grey_prog_32x1500_q75.jpg": (L(32, 1500), "JPEG",
                                      dict(quality=75, progressive=True)),
        "rgb420_prog_opt_64x1024_q75.jpg": (C(64, 1024), "JPEG", dict(
            quality=75, progressive=True, optimize=True, subsampling=2)),
        "grey_rst_blocks_32x700_q80.jpg": (L(32, 700), "JPEG", dict(
            quality=80, restart_marker_blocks=5)),
        "rgb420_rst_rows_32x640_q60.jpg": (C(32, 640), "JPEG", dict(
            quality=60, subsampling=2, restart_marker_rows=1)),
        "grey_opt_32x333_q5.jpg": (L(32, 333), "JPEG",
                                   dict(quality=5, optimize=True)),
        "rgb_adobe_32x410_q85.jpg": (C(32, 410), "JPEG",
                                     dict(quality=85, keep_rgb=True)),
        "grey_exif6_48x520_q85.jpg": (L(48, 520), "JPEG", dict(
            quality=85, exif=_exif_orientation(6))),
        "rgb420_1x1.jpg": (C(1, 1), "JPEG", dict(subsampling=2)),
        "rgb420_7x13_q95.jpg": (C(7, 13), "JPEG",
                                dict(quality=95, subsampling=2)),
        "grey_40x48_q70.jpg": (L(48, 40), "JPEG", dict(quality=70)),
        "rgb422_prog_32x2048_q70.jpg": (C(32, 2048), "JPEG", dict(
            quality=70, subsampling=1, progressive=True)),
    }
    return out


def array_record(raw: bytes) -> dict:
    arr = np.asarray(Image.open(io.BytesIO(raw)))
    return {"sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
            "dtype": str(arr.dtype), "shape": list(arr.shape)}


def main():
    manifest = {}
    for name, (im, fmt, kw) in files().items():
        buf = io.BytesIO()
        im.save(buf, fmt, **kw)
        raw = buf.getvalue()
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(raw)
        manifest[name] = array_record(raw)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


def time_decoders(reps: int = 200):
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from vistaocr_tpu_torch.serve.imagecodec import decode_image

    for name in ("grey_64x2048.png", "grey_64x2048_q90.jpg",
                 "rgb420_32x2048_q90.jpg"):
        with open(os.path.join(HERE, name), "rb") as f:
            raw = f.read()
        row = {}
        for who, fn in (("pillow", lambda r: np.asarray(
                Image.open(io.BytesIO(r)))), ("port", decode_image)):
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn(raw)
                times.append((time.perf_counter() - t0) * 1e3)
            row[who] = float(np.median(times[reps // 10:]))
        print(name, json.dumps(row))


if __name__ == "__main__":
    time_decoders() if sys.argv[1:] == ["--time"] else main()
