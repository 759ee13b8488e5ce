"""PNG and JPEG bytes to numpy arrays, without PIL.

``decode_image(raw)`` returns what ``np.asarray(PIL.Image.open(
io.BytesIO(raw)))`` returns (Pillow 12 over libjpeg-turbo 3), dtype,
shape and bytes, so that the port's HTTP server hands ``OcrService`` the
arrays the JAX server hands its own:

==============  ==========================  ===========================
PNG             Pillow mode                 array
==============  ==========================  ===========================
grey 1 bit      ``1``                       ``bool [H, W]`` (0/255)
grey 2/4 bits   ``L`` (x85 / x17)           ``uint8 [H, W]``
grey 8 bits     ``L``                       ``uint8 [H, W]``
grey 16 bits    ``I;16``                    ``uint16 [H, W]`` (native)
RGB 8/16        ``RGB`` (16: high bytes)    ``uint8 [H, W, 3]``
palette 1-8     ``P``                       ``uint8 [H, W]`` indices
grey+alpha 8    ``LA``                      ``uint8 [H, W, 2]``
grey+alpha 16   ``RGBA`` (g, g, g, a)       ``uint8 [H, W, 4]``
RGBA 8/16       ``RGBA`` (16: high bytes)   ``uint8 [H, W, 4]``
==============  ==========================  ===========================

JPEG: one component gives ``L`` ``[H, W]``, three give ``RGB``
``[H, W, 3]``; EXIF orientation is not applied (``Image.open`` does not).

Python reads the headers as Pillow's plugins do (PNG chunks with their
CRCs, JPEG markers up to the first SOS), raising where they raise, and
inflates the PNG stream with ``zlib`` fed in Pillow's 64 KiB pieces. One
C++ call an image (``native/imagecodec.cpp``, through ``ctypes``, which
releases the GIL) then unfilters, deinterlaces and unpacks the PNG rows,
or decodes the whole JPEG. The library is built with g++ at first use
(``native_build``); a failed build raises ``RuntimeError`` naming the
cause, and nothing falls back to a Python decoder.

Refused with ``UnsupportedImage`` (a ``ValueError``) naming what was
found: other formats (TIFF, BMP, GIF, WebP, PNM and unknown bytes),
arithmetic-coded, lossless and hierarchical JPEG, samples other than 8
bits, 2- or 4-component JPEG (CMYK, YCCK), sampling other than 1x1, 2x1
or 2x2 luma over 1x1 chroma, and progressive JPEG whose scans stop short
(which libjpeg would block-smooth). Refused with ``ValueError``: damaged or
truncated files wherever Pillow raises on the same bytes, and images over
Pillow's decompression-bomb limit.
"""

from __future__ import annotations

import ctypes
import os
import re
import struct
import threading
import zlib
from typing import Optional, Tuple

import numpy as np

from .. import native_build

_SRC = os.path.join(native_build.PKG_DIR, "serve", "native", "imagecodec.cpp")
BUILD_DIR = native_build.BUILD_DIR

# Pillow's Image.MAX_IMAGE_PIXELS; above twice it Image.open raises
MAX_IMAGE_PIXELS = int(1024 * 1024 * 1024 // 4 // 3)
_CHUNK = 65536  # Pillow's read size (ImageFile.MAXBLOCK)
_ERR_LEN = 512

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    return native_build.library_path(_SRC, BUILD_DIR, "_imagecodec")


def load():
    """The decoder library, built on first use; raises ``RuntimeError``
    naming the cause when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            err = native_build.build(_SRC, so)
            if err:
                raise RuntimeError(f"the image decoder did not build: {err}")
        lib = ctypes.CDLL(so)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.vo_png_decode.restype = ctypes.c_int
        lib.vo_png_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            u8p, ctypes.c_char_p, ctypes.c_int32]
        lib.vo_jpeg_decode.restype = ctypes.c_int
        lib.vo_jpeg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, u8p, ctypes.c_char_p, ctypes.c_int32]
        _lib = lib
        return _lib


class UnsupportedImage(ValueError):
    """A valid image in a form this decoder refuses (another format, a
    JPEG coding or sampling it does not take), as against damaged data."""


def _raise(rc: int, err) -> None:
    msg = err.value.decode(errors="replace")
    raise (UnsupportedImage if rc == 2 else ValueError)(msg)


def _bomb_check(width: int, height: int) -> None:
    pixels = max(1, width) * max(1, height)
    if pixels > 2 * MAX_IMAGE_PIXELS:
        raise ValueError(
            f"image size ({pixels} pixels) exceeds the limit of "
            f"{2 * MAX_IMAGE_PIXELS} pixels (decompression bomb)")


def _other_format(raw: bytes) -> Optional[str]:
    if raw[:4] in (b"II*\x00", b"MM\x00*"):
        return "TIFF"
    if raw[:2] == b"BM":
        return "BMP"
    if raw[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if raw[:4] == b"RIFF" and raw[8:12] == b"WEBP":
        return "WebP"
    if len(raw) > 2 and raw[0:1] == b"P" and raw[1:2] in b"1234567" \
            and raw[2:3].isspace():
        return "PNM"
    return None


def decode_image(raw: bytes) -> np.ndarray:
    """PNG or JPEG bytes -> ``np.asarray(PIL.Image.open(...))``'s array."""
    raw = bytes(raw)
    if raw.startswith(_PNG_MAGIC):
        return _decode_png(raw)
    if raw.startswith(b"\xff\xd8\xff"):
        return _decode_jpeg(raw)
    fmt = _other_format(raw)
    if fmt is not None:
        raise UnsupportedImage(f"{fmt} images are not supported (PNG and "
                               "JPEG only)")
    raise UnsupportedImage("unrecognised image format (PNG and JPEG only)")


def _err_buf():
    return ctypes.create_string_buffer(_ERR_LEN)


# --- PNG ---------------------------------------------------------------------
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_is_cid = re.compile(rb"\w\w\w\w").match
# (bit depth, colour type) -> (Pillow mode, dtype, trailing shape)
_PNG_MODES = {
    (1, 0): ("1", np.bool_, ()), (2, 0): ("L", np.uint8, ()),
    (4, 0): ("L", np.uint8, ()), (8, 0): ("L", np.uint8, ()),
    (16, 0): ("I;16", np.uint16, ()),
    (8, 2): ("RGB", np.uint8, (3,)), (16, 2): ("RGB", np.uint8, (3,)),
    (1, 3): ("P", np.uint8, ()), (2, 3): ("P", np.uint8, ()),
    (4, 3): ("P", np.uint8, ()), (8, 3): ("P", np.uint8, ()),
    (8, 4): ("LA", np.uint8, (2,)), (16, 4): ("RGBA", np.uint8, (4,)),
    (8, 6): ("RGBA", np.uint8, (4,)), (16, 6): ("RGBA", np.uint8, (4,)),
}
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class _Png:
    """Pillow's PngStream/PngImageFile reading of one file's bytes."""

    def __init__(self, raw: bytes):
        self.raw = raw
        self.pos = len(_PNG_MAGIC)

    def read(self, n: int) -> bytes:  # fp.read: short at the end
        s = self.raw[self.pos:self.pos + n]
        self.pos += len(s)
        return s

    def safe_read(self, n: int) -> bytes:  # ImageFile._safe_read
        if n <= 0:
            return b""
        s = self.read(n)
        if len(s) < n:
            raise ValueError("PNG file is truncated (Truncated File Read)")
        return s

    def chunk(self) -> Tuple[bytes, int]:  # ChunkStream.read
        s = self.read(8)
        if len(s) < 4:
            raise struct.error("unpack requires a buffer of 4 bytes")
        cid = s[4:]
        if not _is_cid(cid):
            raise ValueError(f"broken PNG file (chunk {cid!r})")
        return cid, struct.unpack(">I", s[:4])[0]


def _decode_png(raw: bytes) -> np.ndarray:
    png = _Png(raw)
    mode = size = None
    depth = ctype = interlace = 0
    idat = None
    while True:  # PngImageFile._open: the chunks up to the first IDAT
        try:
            cid, length = png.chunk()
        except struct.error:
            raise ValueError("PNG file is truncated (chunk header)") from None
        if cid == b"IDAT":
            idat = length
            break
        if cid == b"IEND":
            break
        s = png.safe_read(length)
        if cid == b"IHDR":
            if length < 13:
                raise ValueError("Truncated IHDR chunk")
            size = struct.unpack(">II", s[:8])
            depth, ctype, interlace = s[8], s[9], s[12]
            mode = _PNG_MODES.get((depth, ctype))
            if s[11]:
                raise ValueError("unknown PNG filter category")
        elif cid == b"tRNS" and mode is not None:
            need = {"1": 2, "L": 2, "I;16": 2, "RGB": 6}.get(mode[0], 0)
            if len(s) < need:
                raise ValueError("PNG tRNS chunk is too short")
        crc = png.read(4)
        if len(crc) < 4:
            raise ValueError(f"broken PNG file (incomplete checksum in "
                             f"{cid!r})")
        if zlib.crc32(s, zlib.crc32(cid)) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"broken PNG file (bad header checksum in "
                             f"{cid!r})")
    if mode is None or size is None or size[0] <= 0 or size[1] <= 0:
        raise ValueError("PNG image has no supported mode and size "
                         f"(bit depth {depth}, colour type {ctype})")
    W, H = size
    _bomb_check(W, H)
    if idat is None:
        raise ValueError("PNG image has no image data")
    bits = depth * _CHANNELS[ctype]
    if interlace:
        need = 0
        for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8),
                               (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                               (0, 1, 1, 2)):
            pw = (W - x0 + dx - 1) // dx if W > x0 else 0
            ph = (H - y0 + dy - 1) // dy if H > y0 else 0
            if pw and ph:
                need += ph * ((pw * bits + 7) // 8 + 1)
    else:
        need = H * ((W * bits + 7) // 8 + 1)
    data = _inflate_idat(png, idat, need)
    _png_tail(png, mode[0])
    name, dtype, trail = mode
    out = np.empty((H, W) + trail, dtype)
    elem = out.itemsize * int(np.prod(trail, dtype=np.int64))
    err = _err_buf()
    rc = load().vo_png_decode(
        data, len(data), W, H, depth, ctype, int(bool(interlace)), elem,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), err, _ERR_LEN)
    if rc:
        _raise(rc, err)
    return out


def _inflate_idat(png: _Png, length: int, need: int) -> bytes:
    """The zlib stream of the IDAT chunks, inflated to ``need`` bytes as
    Pillow's zip decoder sees it: in 64 KiB pieces of each chunk, stopping
    at the last row (so a damaged checksum after it passes or fails as in
    Pillow)."""
    d = zlib.decompressobj()
    out = bytearray()
    left = length
    while True:
        while left == 0:  # PngImageFile.load_read: the next IDAT chunk
            png.read(4)
            try:
                cid, left = png.chunk()
            except struct.error:
                raise ValueError("PNG image file is truncated") from None
            if cid != b"IDAT":
                raise ValueError("PNG image file is truncated (the image "
                                 "data ends early)")
        n = min(_CHUNK, left)
        left -= n
        piece = png.read(n)
        if not piece:
            raise ValueError("PNG image file is truncated")
        try:
            out += d.decompress(d.unconsumed_tail + piece, need - len(out))
        except zlib.error as e:
            raise ValueError(f"PNG image data is damaged: {e}") from None
        if len(out) >= need:
            png.pos += left  # load_end skips the rest of this chunk
            return bytes(out)


def _png_tail(png: _Png, mode: str) -> None:
    """PngImageFile.load_end: the chunks after the image data, up to IEND,
    read (without CRCs) as Pillow reads them."""
    while True:
        png.read(4)
        try:
            cid, length = png.chunk()
        except (struct.error, ValueError):
            return
        if cid == b"IEND":
            return
        s = png.safe_read(length)
        if cid == b"IHDR" and length < 13:
            raise ValueError("Truncated IHDR chunk")
        if cid == b"tRNS":
            need = {"1": 2, "L": 2, "I;16": 2, "RGB": 6}.get(mode, 0)
            if len(s) < need:
                raise ValueError("PNG tRNS chunk is too short")


# --- JPEG --------------------------------------------------------------------
# Pillow's JpegImagePlugin.MARKER: which markers it knows, and which carry a
# length it reads
_SOF = set(range(0xFFC0, 0xFFD0)) - {0xFFC4, 0xFFC8, 0xFFCC} | {0xFFDE}
_LENGTH = {0xFFC4, 0xFFCC, 0xFFDA, 0xFFDB, 0xFFDC, 0xFFDD, 0xFFDF, 0xFFFE} \
    | set(range(0xFFE0, 0xFFF0)) | _SOF
_NO_LENGTH = set(range(0xFFD0, 0xFFDA)) | {0xFFC8} | set(range(0xFFF0, 0xFFFE))


def _jpeg_header(raw: bytes) -> Tuple[int, int, int]:
    """JpegImageFile._open: the markers up to the first SOS, raising where
    it raises; (width, height, components) of the last SOF."""
    pos = 3
    size = None
    layers = 0

    def read(n):
        nonlocal pos
        s = raw[pos:pos + n]
        pos += len(s)
        return s

    def segment():
        n = read(2)
        if len(n) < 2:
            raise ValueError("JPEG file is truncated (marker length)")
        n = struct.unpack(">H", n)[0] - 2
        if n <= 0:
            return b""
        s = read(n)
        if len(s) < n:
            raise ValueError("JPEG file is truncated (Truncated File Read)")
        return s

    s = b"\xff"
    while True:
        if not s:
            raise ValueError("JPEG file is truncated (no SOS marker)")
        if s[0] != 0xFF:
            s = read(1)
            continue
        s = s + read(1)
        if len(s) < 2:
            raise ValueError("JPEG file is truncated (no SOS marker)")
        i = (s[0] << 8) | s[1]
        if i in _LENGTH or i in _NO_LENGTH:
            if i in _LENGTH:
                seg = segment()
                if i in _SOF:
                    if len(seg) < 6:
                        raise ValueError("JPEG SOF segment is too short")
                    size = (seg[3] << 8 | seg[4], seg[1] << 8 | seg[2])
                    if seg[0] != 8:
                        raise UnsupportedImage(f"{seg[0]}-bit JPEG samples "
                                               "are not supported")
                    layers = seg[5]
                    if layers not in (1, 3, 4):
                        raise UnsupportedImage(f"{layers}-component JPEG is "
                                               "not supported")
                    if (len(seg) - 6) % 3:
                        raise ValueError("JPEG SOF segment has a partial "
                                         "component")
                elif i == 0xFFDB:
                    _check_dqt(seg)
                elif i in (0xFFE0, 0xFFEE):
                    tag = b"JFIF" if i == 0xFFE0 else b"Adobe"
                    if seg.startswith(tag) and len(seg) < 7:
                        raise ValueError(f"JPEG {tag.decode()} segment is too "
                                         "short")
            if i == 0xFFDA:
                break
            s = read(1)
        elif i == 0xFFFF:
            s = b"\xff"
        elif i == 0xFF00:
            s = read(1)
        else:
            raise ValueError("no JPEG marker found")
    if size is None or size[0] <= 0 or size[1] <= 0:
        raise ValueError("JPEG file has no frame (SOF) before its scan")
    return size[0], size[1], layers


def _check_dqt(seg: bytes) -> None:
    while seg:
        qt_length = 1 + (1 if seg[0] // 16 == 0 else 2) * 64
        if len(seg) < qt_length:
            raise ValueError("bad JPEG quantization table marker")
        seg = seg[qt_length:]


def _decode_jpeg(raw: bytes) -> np.ndarray:
    W, H, nc = _jpeg_header(raw)
    _bomb_check(W, H)
    out = np.empty((H, W) if nc == 1 else (H, W, 3), np.uint8)
    err = _err_buf()
    rc = load().vo_jpeg_decode(
        raw, len(raw), W, H, nc,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), err, _ERR_LEN)
    if rc:
        _raise(rc, err)
    return out
