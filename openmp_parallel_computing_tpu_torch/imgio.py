"""PNG decoding and encoding with the standard library's zlib and numpy.

The port reads its fixtures without Pillow or a native codec: 8-bit,
non-interlaced grey, grey+alpha, RGB and RGBA (colour types 0, 4, 2, 6),
all five row filters (PNG spec §9), decoded to ``(H, W, 1|2|3|4)`` as the
JAX package's loader returns them. The filters Average and Paeth are a
non-linear recurrence along the row, so they run as a plain Python loop
over the row's bytes; Sub is a running sum and Up an elementwise add, both
done in numpy. A 1080p frame decodes in a few seconds.

``save_png`` writes every row with filter 0 (None), so the port's own
outputs decode at the speed of zlib.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}          # colour type -> samples per pixel
_COLOUR = {c: t for t, c in _CHANNELS.items()}


def _unfilter_row(ftype: int, line: bytes, prev: bytes, bpp: int) -> bytes:
    """Undo one row's filter; ``line`` and ``prev`` are rows of ``stride``
    bytes (``prev`` is all zeros above the first row)."""
    if ftype == 0:
        return line
    if ftype == 1:
        # Sub: a running sum along each channel, modulo 256.
        px = np.frombuffer(line, np.uint8).reshape(-1, bpp).astype(np.int64)
        return (np.cumsum(px, axis=0) & 0xFF).astype(np.uint8).tobytes()
    if ftype == 2:
        return ((np.frombuffer(line, np.uint8).astype(np.int32)
                 + np.frombuffer(prev, np.uint8)) & 0xFF
                ).astype(np.uint8).tobytes()
    out = bytearray(line)
    n = len(out)
    if ftype == 3:
        for i in range(n):
            left = out[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + ((left + prev[i]) >> 1)) & 0xFF
        return bytes(out)
    if ftype == 4:
        for i in range(n):
            if i >= bpp:
                a, c = out[i - bpp], prev[i - bpp]
            else:
                a = c = 0
            b = prev[i]
            pa = abs(b - c)          # |p - a| with p = a + b - c
            pb = abs(a - c)          # |p - b|
            pc = abs(a + b - 2 * c)  # |p - c|
            if pa <= pb and pa <= pc:
                pred = a
            elif pb <= pc:
                pred = b
            else:
                pred = c
            out[i] = (out[i] + pred) & 0xFF
        return bytes(out)
    raise ValueError(f"PNG: unknown row filter {ftype}")


def load(path: str | os.PathLike) -> np.ndarray:
    """Decode an 8-bit grey, grey+alpha, RGB or RGBA PNG to an interleaved
    (H, W, C) u8 array, C = 1, 2, 3 or 4. Raises ``ValueError`` naming the
    file on any other kind of PNG (palette, 16-bit, interlaced), on other
    files and on a malformed PNG (a cut chunk, a short IHDR, a bad zlib
    stream, too little image data)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    try:
        return _decode(raw, path)
    except (struct.error, zlib.error) as exc:
        raise ValueError(f"{path}: malformed PNG ({exc})") from exc


def _decode(raw: bytes, path) -> np.ndarray:
    pos = 8
    idat = []
    header = None
    while pos < len(raw):
        (length,) = struct.unpack(">I", raw[pos:pos + 4])
        ctype = raw[pos + 4:pos + 8]
        body = raw[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, colour, _comp, _filt, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced grey/grey+alpha/RGB/RGBA "
            f"PNGs are supported (depth={depth}, colour type={colour}, "
            f"interlace={interlace})")
    c = _CHANNELS[colour]
    stride = width * c
    data = zlib.decompress(b"".join(idat))
    if len(data) != height * (stride + 1):
        raise ValueError(f"{path}: truncated image data")
    rows = []
    prev = bytes(stride)
    for y in range(height):
        off = y * (stride + 1)
        prev = _unfilter_row(data[off], data[off + 1:off + 1 + stride],
                             prev, c)
        rows.append(prev)
    return np.frombuffer(b"".join(rows), np.uint8).reshape(height, width, c)


def save_png(path: str | os.PathLike, img: np.ndarray) -> None:
    """Encode an interleaved (H, W) or (H, W, C) u8 array, C in {1, 2, 3,
    4}, as an 8-bit PNG of colour type 0, 4, 2 or 6."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in _COLOUR:
        raise ValueError(f"expected an (H, W) or (H, W, 1|2|3|4) uint8 "
                         f"array, got {img.dtype} {img.shape}")
    h, w, c = img.shape
    rows = np.zeros((h, 1 + w * c), np.uint8)       # filter byte 0 per row
    rows[:, 1:] = img.reshape(h, w * c)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    png = (_SIGNATURE
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _COLOUR[c],
                                        0, 0, 0))
           + chunk(b"IDAT", zlib.compress(rows.tobytes()))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
