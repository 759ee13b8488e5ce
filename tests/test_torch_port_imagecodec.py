"""The port's PNG/JPEG decoder (``vistaocr_tpu_torch.serve.imagecodec``)
against ``np.asarray(PIL.Image.open(...))``: dtype, shape and bytes.

- the committed corpus ``tests/torch_port_images``: its manifest equals
  Pillow's arrays today, and each file decodes to Pillow's array;
- PNG from a small writer here (Pillow writes neither Adam7 nor split
  IDAT chunks nor every bit depth): every colour type and bit depth,
  the five filters in turn, Adam7, IDAT split every 7 bytes, palettes
  with and without tRNS, widths 1, 7, 8, 9 and 2049; and PNG as Pillow
  writes each mode;
- JPEG from Pillow: L and RGB, subsampling 0/1/2, quality 5/50/95,
  progressive on and off, optimized tables, restart intervals in blocks
  and rows, sizes 1x1, 7x13, 17x33 and 64x2048;
- damaged files: every (or, for the large files, a seeded sample of)
  truncation point, and seeded single-bit flips: where Pillow raises the
  port raises; where Pillow decodes the port's bytes are equal, or the
  port refuses with ``UnsupportedImage`` a form it does not take (a flip
  can turn a file into one: other sampling factors, or a progressive file
  whose last scan is lost, which libjpeg block-smooths);
- refusals name what they refuse: BMP, TIFF, GIF, WebP, PNM, CMYK JPEG,
  12-bit, arithmetic, lossless and hierarchical JPEG, 4:1:1 sampling,
  and a PNG over Pillow's decompression-bomb limit;
- the decoder library builds when six processes build it at once.
"""

import hashlib
import io
import json
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from vistaocr_tpu_torch.serve import imagecodec
from vistaocr_tpu_torch.serve.imagecodec import UnsupportedImage, decode_image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "tests", "torch_port_images")
with open(os.path.join(CORPUS, "manifest.json")) as _f:
    MANIFEST = json.load(_f)


def _pil(raw: bytes):
    return np.asarray(Image.open(io.BytesIO(raw)))


def _same_as_pillow(raw: bytes, what) -> None:
    ref = _pil(raw)
    ours = decode_image(raw)
    assert (ours.dtype, ours.shape) == (ref.dtype, ref.shape), what
    assert ours.tobytes() == ref.tobytes(), what


def _agrees_on_damage(raw: bytes, what) -> None:
    """Pillow raises -> the port raises; Pillow decodes -> equal bytes, or
    a named refusal of a form the port does not take."""
    try:
        ref = _pil(raw)
    except Exception:  # noqa: BLE001 — any failure of Pillow's
        with pytest.raises(ValueError):
            decode_image(raw)
        return
    try:
        ours = decode_image(raw)
    except UnsupportedImage:
        return
    assert (ours.dtype, ours.shape) == (ref.dtype, ref.shape), what
    assert ours.tobytes() == ref.tobytes(), what


def _line(rng, h, w, channels=0):
    img = np.full((h, w), 240, np.int32)
    for _ in range(max(3, w // 8)):
        y, x = int(rng.integers(0, h)), int(rng.integers(0, w))
        img[max(0, y - 3):y + 3, x:x + int(rng.integers(1, 12))] = int(
            rng.integers(0, 90))
    img = np.clip(img + rng.integers(-20, 21, img.shape), 0, 255)
    img = img.astype(np.uint8)
    if channels == 3:
        img = np.stack([img, np.roll(img, 3, 1), 255 - img // 2], -1)
    return img


# --- the committed corpus -----------------------------------------------------
@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_corpus_file(name):
    with open(os.path.join(CORPUS, name), "rb") as f:
        raw = f.read()
    ref = _pil(raw)
    assert MANIFEST[name] == {
        "sha256": hashlib.sha256(ref.tobytes()).hexdigest(),
        "dtype": str(ref.dtype), "shape": list(ref.shape)}
    _same_as_pillow(raw, name)


# --- PNG --------------------------------------------------------------------
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(cid: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + cid + data
            + struct.pack(">I", zlib.crc32(data, zlib.crc32(cid))))


def _filter_rows(rows: np.ndarray, bpp: int, filters) -> bytes:
    """Filter each packed row with the next type of ``filters``."""
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        ft = filters[y % len(filters)]
        a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])[:len(row)]
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])[:len(row)]
        if ft == 4:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, prev, c))
        else:
            pred = (0, a, prev, (a + prev) // 2)[ft]
        out.append(ft)
        out += ((row - pred) % 256).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """[h, n] samples -> [h, rowbytes] packed big-endian rows."""
    if depth == 8:
        return samples.astype(np.uint8)
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(
            samples.shape[0], -1)
    per = 8 // depth
    h, n = samples.shape
    nb = -(-n // per)
    pad = np.zeros((h, nb * per), np.int64)
    pad[:, :n] = samples
    shifts = 8 - depth * (np.arange(per) + 1)
    return (pad.reshape(h, nb, per) << shifts).sum(-1).astype(np.uint8)


def write_png(samples, depth, ctype, *, interlace=False,
              filters=(0, 1, 2, 3, 4), idat_split=None, plte=None,
              trns=None) -> bytes:
    """A PNG of ``samples`` [H, W, channels]: each row filtered with the
    next of ``filters``, Adam7 when ``interlace``, the zlib stream split
    into IDAT chunks of ``idat_split`` bytes."""
    H, W, ch = samples.shape
    bpp = max(1, depth * ch // 8)
    if interlace:
        raw = b""
        for x0, y0, dx, dy in ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.shape[0] and sub.shape[1]:
                raw += _filter_rows(_pack(sub.reshape(sub.shape[0], -1),
                                          depth), bpp, filters)
    else:
        raw = _filter_rows(_pack(samples.reshape(H, -1), depth), bpp,
                           filters)
    z = zlib.compress(raw, 6)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", W, H, depth, ctype, 0, 0, int(interlace)))
    if plte is not None:
        out += _chunk(b"PLTE", plte)
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    step = idat_split or len(z)
    for i in range(0, len(z), step):
        out += _chunk(b"IDAT", z[i:i + step])
    return out + _chunk(b"IEND", b"")


_TRNS = {0: b"\x00\x05", 2: b"\x00\x01\x00\x02\x00\x03",
         3: bytes(range(0, 250, 25))}


@pytest.mark.parametrize("ctype,depth", [
    (0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1),
    (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)])
def test_png_forms(ctype, depth):
    rng = np.random.default_rng(100 * ctype + depth)
    top = min((1 << depth) - 1, 20) if ctype == 3 else (1 << depth) - 1
    plte = (bytes(rng.integers(0, 256, 63).astype(np.uint8))
            if ctype == 3 else None)
    for H, W in ((1, 1), (3, 7), (9, 8), (5, 9), (2, 2049), (11, 13)):
        s = rng.integers(0, top + 1, (H, W, CHANNELS[ctype]))
        for interlace in (False, True):
            for split in (None, 7):
                for trns in (None, _TRNS.get(ctype)):
                    raw = write_png(s, depth, ctype, interlace=interlace,
                                    idat_split=split, plte=plte, trns=trns)
                    _same_as_pillow(raw, (H, W, interlace, split, trns))


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
def test_png_each_filter_alone(filt):
    rng = np.random.default_rng(filt)
    s = rng.integers(0, 256, (6, 33, 3))
    _same_as_pillow(write_png(s, 8, 2, filters=(filt,)), filt)
    _same_as_pillow(write_png(s, 8, 2, filters=(filt,), interlace=True),
                    filt)


@pytest.mark.parametrize("mode", ["L", "1", "RGB", "RGBA", "LA", "I;16",
                                  "P", "P4", "P2", "P1"])
def test_png_as_pillow_writes(mode):
    rng = np.random.default_rng(7)
    for H, W in ((1, 1), (7, 13), (3, 1), (5, 8), (4, 9), (6, 2049)):
        g = _line(rng, H, W)
        if mode == "1":
            im = Image.fromarray(g > 128)
        elif mode == "RGB":
            im = Image.fromarray(_line(rng, H, W, 3))
        elif mode == "RGBA":
            im = Image.fromarray(np.dstack([_line(rng, H, W, 3), g]))
        elif mode == "LA":
            im = Image.fromarray(np.dstack([g, 255 - g]), "LA")
        elif mode == "I;16":
            im = Image.fromarray(g.astype(np.uint16) * 257 + 3)
        elif mode.startswith("P"):
            colours = {"P": 200, "P4": 16, "P2": 4, "P1": 2}[mode]
            im = Image.fromarray(_line(rng, H, W, 3)).quantize(colours)
        else:
            im = Image.fromarray(g)
        kw = {"P4": {"bits": 4}, "P2": {"bits": 2},
              "P1": {"bits": 1}}.get(mode, {})
        for extra in ({}, {"transparency": 0}) if mode.startswith("P") \
                else ({},):
            buf = io.BytesIO()
            im.save(buf, "PNG", **kw, **extra)
            _same_as_pillow(buf.getvalue(), (mode, H, W, extra))


# --- JPEG -------------------------------------------------------------------
@pytest.mark.parametrize("colour,subsampling,progressive", [
    ("L", 0, False), ("L", 0, True), ("RGB", 0, False), ("RGB", 1, False),
    ("RGB", 2, False), ("RGB", 0, True), ("RGB", 1, True), ("RGB", 2, True)])
def test_jpeg_forms(colour, subsampling, progressive):
    rng = np.random.default_rng(subsampling * 2 + progressive)
    for H, W in ((1, 1), (7, 13), (17, 33), (64, 2048)):
        img = Image.fromarray(_line(rng, H, W, 3 if colour == "RGB" else 0))
        for quality in (5, 50, 95):
            for optimize in (False, True):
                buf = io.BytesIO()
                img.save(buf, "JPEG", quality=quality, optimize=optimize,
                         subsampling=subsampling, progressive=progressive)
                _same_as_pillow(buf.getvalue(), (H, W, quality, optimize))
        for restart in ({"restart_marker_blocks": 3},
                        {"restart_marker_rows": 1}):
            buf = io.BytesIO()
            img.save(buf, "JPEG", quality=75, subsampling=subsampling,
                     progressive=progressive, **restart)
            _same_as_pillow(buf.getvalue(), (H, W, restart))


# --- damaged files ------------------------------------------------------------
def _damage_files():
    rng = np.random.default_rng(5)
    out = {}
    for name, kw, channels, (H, W) in (
            ("baseline", {}, 0, (17, 33)),
            ("rgb420", {"subsampling": 2}, 3, (17, 33)),
            ("progressive", {"progressive": True}, 3, (17, 33)),
            ("restarts", {"restart_marker_blocks": 2}, 3, (17, 33)),
            ("grey_progressive", {"progressive": True}, 0, (24, 70)),
            ("grey_64x2048", {"quality": 95}, 0, (64, 2048)),
            ("grey_prog_64x2048", {"quality": 95, "progressive": True}, 0,
             (64, 2048))):
        buf = io.BytesIO()
        Image.fromarray(_line(rng, H, W, channels)).save(
            buf, "JPEG", **{"quality": 75, **kw})
        out[name + ".jpg"] = buf.getvalue()
    out["rgb_split.png"] = write_png(rng.integers(0, 256, (9, 30, 3)), 8, 2,
                                     idat_split=50)
    out["grey16_adam7.png"] = write_png(
        rng.integers(0, 65536, (9, 30, 1)), 16, 0, interlace=True)
    buf = io.BytesIO()
    Image.fromarray(_line(rng, 64, 2048)).save(buf, "PNG")
    out["grey_64x2048.png"] = buf.getvalue()
    return out


DAMAGE = _damage_files()


@pytest.mark.parametrize("name", sorted(DAMAGE))
def test_truncated(name):
    raw = DAMAGE[name]
    rng = np.random.default_rng(len(raw))
    if len(raw) < 3000:
        cuts = range(len(raw))
    else:  # the headers, the tail and a sample between
        cuts = sorted({*range(200), *range(len(raw) - 300, len(raw)),
                       *rng.integers(0, len(raw), 200).tolist()})
    for cut in cuts:
        _agrees_on_damage(raw[:cut], (name, cut))


@pytest.mark.parametrize("name", sorted(DAMAGE))
def test_bit_flips(name):
    raw = DAMAGE[name]
    rng = np.random.default_rng(len(raw) + 1)
    for _ in range(150):
        pos, bit = int(rng.integers(0, len(raw))), int(rng.integers(0, 8))
        flipped = bytearray(raw)
        flipped[pos] ^= 1 << bit
        _agrees_on_damage(bytes(flipped), (name, pos, bit))


# --- refusals ---------------------------------------------------------------
def _pillow_bytes(fmt: str, mode: str = "RGB", **kw) -> bytes:
    buf = io.BytesIO()
    img = Image.fromarray(_line(np.random.default_rng(3), 16, 24, 3))
    img.convert(mode).save(buf, fmt, **kw)
    return buf.getvalue()


def _patch_sof(raw: bytes, marker=None, offset=None, value=None) -> bytes:
    """Rewrite the SOF marker code, or one byte of its segment."""
    i = 2
    while raw[i + 1] not in (0xC0, 0xC1, 0xC2):
        i += 2 + struct.unpack(">H", raw[i + 2:i + 4])[0]
    out = bytearray(raw)
    if marker is not None:
        out[i + 1] = marker
    if offset is not None:
        out[i + 4 + offset] = value
    return bytes(out)


@pytest.mark.parametrize("fmt,match", [("BMP", "BMP"), ("TIFF", "TIFF"),
                                       ("GIF", "GIF"), ("WEBP", "WebP"),
                                       ("PPM", "PNM")])
def test_refuses_other_formats(fmt, match):
    raw = _pillow_bytes(fmt)
    _pil(raw)  # Pillow opens it
    with pytest.raises(UnsupportedImage, match=match):
        decode_image(raw)


def test_refuses_jpeg_forms_it_does_not_take():
    base = _pillow_bytes("JPEG", quality=80)
    cases = {
        "CMYK": _pillow_bytes("JPEG", "CMYK"),
        "12-bit": _patch_sof(base, offset=0, value=12),
        "arithmetic": _patch_sof(base, marker=0xC9),
        "lossless": _patch_sof(base, marker=0xC3),
        "hierarchical": _patch_sof(base, marker=0xC5),
        "sampling": _patch_sof(base, offset=7, value=0x41),
    }
    for match, raw in cases.items():
        with pytest.raises(UnsupportedImage, match=match):
            decode_image(raw)
    with pytest.raises(UnsupportedImage, match="unrecognised"):
        decode_image(b"not an image")


def test_refuses_a_decompression_bomb():
    raw = write_png(np.zeros((1, 1, 1), np.int64), 8, 0)
    ihdr = struct.pack(">IIBBBBB", 20000, 10000, 8, 0, 0, 0, 0)
    bomb = raw[:8] + _chunk(b"IHDR", ihdr) + raw[33:]
    with pytest.raises(Image.DecompressionBombError):
        _pil(bomb)
    with pytest.raises(ValueError, match="decompression bomb"):
        decode_image(bomb)


# --- the native build -------------------------------------------------------
_BUILD_ONE = r"""
import sys
from vistaocr_tpu_torch.serve import imagecodec
imagecodec.BUILD_DIR = sys.argv[1]
import numpy as np
print(imagecodec.decode_image(open(sys.argv[2], "rb").read()).shape)
"""


def test_decoder_build_is_safe_under_six_builders(tmp_path):
    """Six processes build the decoder at once into one empty directory
    (as six test workers do on a fresh checkout): all decode."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    build = str(tmp_path / "build")
    png = os.path.join(CORPUS, "grey_32x1000.png")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE, build, png],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=ROOT)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert all(o.strip() == "(32, 1000)" for o, _ in outs), outs
    assert [f for f in os.listdir(build) if f.endswith(".tmp")] == []
    assert len([f for f in os.listdir(build) if f.endswith(".so")]) == 1


def test_failed_decoder_build_names_its_cause(tmp_path, monkeypatch):
    monkeypatch.setattr(imagecodec, "_lib", None)
    monkeypatch.setattr(imagecodec, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g.. not found"):
        imagecodec.decode_image(open(os.path.join(
            CORPUS, "grey_32x1000.png"), "rb").read())
    assert os.listdir(tmp_path) == []
