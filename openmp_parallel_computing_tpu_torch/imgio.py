"""Host-side image I/O (port of ``openmp_parallel_computing_tpu.imgio``).

``load(path) -> (H, W, C) u8 ndarray`` tries three decoders, in the JAX
package's order, and takes the first one that is there:

1. ``"native"``: the repo's own codec, ``native/imgio/imgio.cpp``
   (libjpeg, libpng), compiled with g++ at first use into
   ``build/torch_imgio/`` with ``native/Makefile``'s flags and loaded
   through ctypes. It is there when the compiler and both libraries are.
2. ``"pil"``: Pillow, normalised to the native codec's pixels.
3. ``"png"``: this module's own zlib + numpy decoder, for PNG only.

A decoder that is there decodes or raises: a file it cannot read is an
error, not a reason to try the next one. One kind of file skips Pillow: a
16-bit RGB PNG with a tRNS colour key, which Pillow reads as 8-bit samples
that cannot be compared with the 16-bit key, goes to the PNG decoder,
which reads it as the native codec does. When a JPEG comes and neither the
native codec nor Pillow is there, ``load`` raises an ``OSError`` naming
the file and both codecs. ``decoder_used()`` names the decoder of the last
``load``.

Every decoder gives the native codec's pixels (the JAX package's, whose
``load`` takes the native codec first): palette PNGs expanded to RGB, or
RGBA when a tRNS chunk is present; grey and RGB PNGs with a tRNS colour
key get an alpha channel (0 on the key, 255 elsewhere); 16-bit samples
keep their high byte; grey samples of 1, 2 or 4 bits are scaled to 8;
interlaced (Adam7) PNGs are read; CMYK JPEGs become RGB.

The PNG decoder undoes the five row filters (PNG spec §9). Average and
Paeth are a non-linear recurrence along the row, so they run as a plain
Python loop over the row's bytes; Sub is a running sum and Up an
elementwise add, both in numpy. A 1080p frame decodes in a few seconds.

``save_png`` writes every row with filter 0 (None) at a zlib level, so the
pixels are the same at every level and on every install;
``save_jpeg`` needs the native codec or Pillow.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import struct
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
_NATIVE_SRC = _ROOT / "native" / "imgio" / "imgio.cpp"
_MAKEFILE = _ROOT / "native" / "Makefile"
BUILD_DIR = _ROOT / "build" / "torch_imgio"

DECODERS = ("native", "pil", "png")

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_SIGNATURE = b"\xff\xd8"
# colour type -> samples per pixel, and the bit depths the spec allows
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
_COLOUR = {1: 0, 2: 4, 3: 2, 4: 6}           # channels -> colour type
# Adam7 passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))

_lock = threading.Lock()
_native: dict = {}          # "lib" -> CDLL or None, "why" -> reason
_last = {"decoder": None}


# -- the native codec --------------------------------------------------------

def _make_flags() -> tuple[list[str], list[str]]:
    """``CXXFLAGS`` and ``LDLIBS`` as ``native/Makefile`` sets them."""
    text = _MAKEFILE.read_text()

    def var(name):
        m = re.search(rf"^{name}\s*\??=\s*(.*)$", text, re.M)
        if m is None:
            raise RuntimeError(f"{_MAKEFILE}: no {name}")
        return m.group(1).split()

    return var("CXXFLAGS"), var("LDLIBS")


def _build_native() -> Path:
    """Compile the native codec into ``BUILD_DIR`` (named by a hash of the
    source and flags, so an edited source rebuilds); returns the library.
    Raises ``OSError`` or ``subprocess.CalledProcessError`` when it cannot
    be built."""
    cxxflags, ldlibs = _make_flags()
    cxx = os.environ.get("CXX", "g++")
    h = hashlib.sha256(" ".join([cxx, *cxxflags, *ldlibs]).encode())
    h.update(_NATIVE_SRC.read_bytes())
    so = BUILD_DIR / f"libimgio-{h.hexdigest()[:12]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".so.tmp{os.getpid()}")
    try:
        subprocess.run([cxx, *cxxflags, "-shared", "-o", str(tmp),
                        str(_NATIVE_SRC), *ldlibs], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, so)
    finally:
        if tmp.exists():
            tmp.unlink()
    return so


def _load_lib():
    """The native codec's library, built at first use; None (and the
    reason in ``native_status()``) when it cannot be built or loaded."""
    with _lock:
        if "lib" in _native:
            return _native["lib"]
        try:
            lib = ctypes.CDLL(str(_build_native()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
            errors = [ln for ln in (getattr(exc, "stderr", b"") or b"")
                      .decode(errors="replace").splitlines() if "error" in ln]
            _native.update(lib=None, why=errors[0] if errors else str(exc))
            return None
        u8p = ctypes.POINTER(ctypes.c_ubyte)
        lib.imgio_load.restype = u8p
        lib.imgio_load.argtypes = [ctypes.c_char_p] + [
            ctypes.POINTER(ctypes.c_int)] * 3
        lib.imgio_save_png.restype = ctypes.c_int
        lib.imgio_save_png.argtypes = [ctypes.c_char_p, u8p] + [
            ctypes.c_int] * 5
        lib.imgio_save_jpeg.restype = ctypes.c_int
        lib.imgio_save_jpeg.argtypes = [ctypes.c_char_p, u8p] + [
            ctypes.c_int] * 4
        lib.imgio_free.argtypes = [u8p]
        lib.imgio_free.restype = None
        lib.imgio_last_error.restype = ctypes.c_char_p
        lib.imgio_last_error.argtypes = []
        _native.update(lib=lib, why="built")
        return lib


def native_status() -> str:
    """"built", or why the native codec is not there."""
    _load_lib()
    return _native["why"]


def _have_pil() -> bool:
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return False
    return True


def available_decoders() -> tuple[str, ...]:
    """The decoders that are there, in the order ``load`` tries them."""
    have = {"native": _load_lib() is not None, "pil": _have_pil(),
            "png": True}
    return tuple(d for d in DECODERS if have[d])


def decoder_used() -> str | None:
    """The decoder of the last ``load`` in this process (None before
    any)."""
    return _last["decoder"]


# -- load ----------------------------------------------------------------------

def load(path: str | os.PathLike) -> np.ndarray:
    """Decode a JPEG or PNG file to an interleaved (H, W, C) u8 array,
    C = 1-4, with the first decoder that is there (``DECODERS``). Raises
    ``OSError`` or ``ValueError`` naming the file when it cannot be
    decoded."""
    name = available_decoders()[0]
    if name == "pil" and _pil_misreads(path):
        name = "png"
    elif name == "png" and _sniff(path) == _JPEG_SIGNATURE:
        raise OSError(
            f"{path}: a JPEG file needs the native codec (native/imgio, "
            f"not built: {native_status()}) or Pillow (not installed)")
    out = {"native": _load_native, "pil": _load_pil, "png": _load_png}[name](
        path)
    _last["decoder"] = name
    return out


def _sniff(path) -> bytes:
    with open(path, "rb") as f:
        return f.read(2)


def _load_native(path) -> np.ndarray:
    lib = _load_lib()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    ptr = lib.imgio_load(os.fsencode(path), ctypes.byref(w), ctypes.byref(h),
                         ctypes.byref(c))
    if not ptr:
        raise OSError(f"imgio: {lib.imgio_last_error().decode()} ({path})")
    try:
        n = h.value * w.value * c.value
        arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
    finally:
        lib.imgio_free(ptr)
    return arr.reshape(h.value, w.value, c.value)


def _load_pil(path) -> np.ndarray:
    """Pillow, normalised to the native codec's pixels as the JAX
    package's ``_load_pil`` normalises it (palette to RGB or RGBA, CMYK to
    RGB, 16-bit samples to their high byte), and further where the JAX
    function parts from the native codec: 1-bit grey scaled to 0/255, and
    a grey or RGB colour key (tRNS) read as an alpha channel. ``load``
    sends the files of ``_pil_misreads`` to the PNG decoder instead."""
    from PIL import Image

    colour = _png_header(path)[1]
    try:
        with Image.open(path) as img:
            img.load()
            if img.mode == "RGBA" and colour == 4:
                # 16-bit grey + alpha, which Pillow opens as RGBA.
                img = img.convert("LA")
            if img.mode == "P":
                # a tRNS longer than the palette is ignored, as libpng does
                trns = img.info.get("transparency")
                keyed = trns is not None and not (
                    isinstance(trns, bytes)
                    and len(trns) > len(img.palette.palette) // 3)
                img = img.convert("RGBA" if keyed else "RGB")
            elif img.mode == "CMYK":
                img = img.convert("RGB")
            elif img.mode == "1":
                img = img.convert("L")
            key = img.info.get("transparency") if img.mode != "RGBA" else None
            arr = np.asarray(img)
    except (OSError, SyntaxError, ValueError) as exc:
        raise OSError(f"{path}: Pillow cannot decode it ({exc})") from exc
    if arr.ndim == 2:
        arr = arr[..., None]
    alpha = None
    if key is not None and arr.shape[-1] in (1, 3):
        hit = (arr == np.asarray(key).reshape(-1)).all(axis=-1)
        alpha = np.where(hit, 0, 255).astype(np.uint8)[..., None]
    if arr.dtype != np.uint8:
        # 16-bit samples (modes I;16, I): the high byte, as strip_16.
        arr = np.clip(np.right_shift(arr.astype(np.int64), 8),
                      0, 255).astype(np.uint8)
    if alpha is not None:
        arr = np.concatenate([arr, alpha], axis=-1)
    return np.ascontiguousarray(arr, dtype=np.uint8)


def _pil_misreads(path) -> bool:
    """Whether Pillow would give other pixels than the native codec: a
    palette PNG without PLTE, which the native codec refuses, and a 16-bit
    RGB PNG with a tRNS colour key, whose 8-bit samples Pillow cannot
    compare with the key. The PNG decoder refuses the first and reads the
    second as the native codec does."""
    depth, colour, tags = _png_header(path)
    return ((colour == 3 and b"PLTE" not in tags)
            or (depth == 16 and colour == 2 and b"tRNS" in tags))


def _png_header(path) -> tuple[int | None, int | None, set]:
    """(bit depth, colour type, the chunk tags before the first IDAT) of
    a PNG file, read from its first 64 KB; (None, None, set()) for any
    other file."""
    with open(path, "rb") as f:
        raw = f.read(1 << 16)
    if raw[:8] != _SIGNATURE or len(raw) < 26:
        return None, None, set()
    tags, pos = set(), 8
    while pos + 8 <= len(raw) and raw[pos + 4:pos + 8] != b"IDAT":
        tags.add(bytes(raw[pos + 4:pos + 8]))
        pos += 12 + struct.unpack(">I", raw[pos:pos + 4])[0]
    return raw[24], raw[25], tags


def _load_png(path) -> np.ndarray:
    """This module's decoder: any PNG of the spec's colour types and bit
    depths, interlaced or not. Raises ``ValueError`` naming the file on
    other files and on a malformed PNG (a cut chunk, a short IHDR, a bad
    zlib stream, too little image data)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    try:
        return _decode(raw, path)
    except (struct.error, zlib.error) as exc:
        raise ValueError(f"{path}: malformed PNG ({exc})") from exc


# -- the PNG decoder -------------------------------------------------------------

def _unfilter_row(ftype: int, line: bytes, prev: bytes, bpp: int) -> bytes:
    """Undo one row's filter; ``line`` and ``prev`` are rows of ``stride``
    bytes (``prev`` is all zeros above the first row); ``bpp`` is the
    bytes a pixel (at least 1)."""
    if ftype == 0:
        return line
    if ftype == 1:
        # Sub: a running sum along each byte of the pixel, modulo 256.
        n = len(line)
        buf = np.zeros(-(-n // bpp) * bpp, np.int64)
        buf[:n] = np.frombuffer(line, np.uint8)
        sums = np.cumsum(buf.reshape(-1, bpp), axis=0).reshape(-1)[:n]
        return (sums & 0xFF).astype(np.uint8).tobytes()
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


def _samples(data: bytes, off: int, w: int, h: int, depth: int, spp: int,
             path) -> tuple[np.ndarray, int]:
    """Unfilter the (w, h) image at ``data[off:]`` and unpack its samples
    -> ((h, w, spp) uint16 samples at their own depth, bytes used)."""
    stride = -(-w * spp * depth // 8)
    bpp = max(1, spp * depth // 8)
    end = off + h * (stride + 1)
    if end > len(data):
        raise ValueError(f"{path}: truncated image data")
    rows = []
    prev = bytes(stride)
    for y in range(h):
        at = off + y * (stride + 1)
        prev = _unfilter_row(data[at], data[at + 1:at + 1 + stride], prev,
                             bpp)
        rows.append(prev)
    flat = np.frombuffer(b"".join(rows), np.uint8).reshape(h, stride)
    if depth == 8:
        out = flat.reshape(h, w, spp).astype(np.uint16)
    elif depth == 16:
        out = flat.view(">u2").reshape(h, w, spp).astype(np.uint16)
    else:                                   # 1, 2 or 4 bits, one sample
        bits = np.unpackbits(flat, axis=1).reshape(h, -1, depth)
        weights = 1 << np.arange(depth - 1, -1, -1, dtype=np.uint16)
        out = (bits * weights).sum(axis=-1, dtype=np.uint16)[:, :w, None]
    return out, end


def _decode(raw: bytes, path) -> np.ndarray:
    pos = 8
    idat = []
    header = plte = trns = None
    while pos < len(raw):
        (length,) = struct.unpack(">I", raw[pos:pos + 4])
        ctype = raw[pos + 4:pos + 8]
        body = raw[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            plte = np.frombuffer(body[:len(body) // 3 * 3],
                                 np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = body
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, colour, comp, filt, interlace = header
    if (colour not in _DEPTHS or depth not in _DEPTHS[colour] or comp
            or filt or interlace not in (0, 1)):
        raise ValueError(
            f"{path}: not a valid PNG header (depth={depth}, colour "
            f"type={colour}, compression={comp}, filter={filt}, "
            f"interlace={interlace})")
    if colour == 3 and plte is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    spp = _SAMPLES[colour]
    data = zlib.decompress(b"".join(idat))
    if interlace == 0:
        img, used = _samples(data, 0, width, height, depth, spp, path)
    else:
        img = np.zeros((height, width, spp), np.uint16)
        used = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
            if pw > 0 and ph > 0:
                img[y0::dy, x0::dx], used = _samples(data, used, pw, ph,
                                                     depth, spp, path)
    if used != len(data):
        raise ValueError(f"{path}: truncated image data")
    return _to_u8(img, colour, depth, plte, trns, path)


def _to_u8(img: np.ndarray, colour: int, depth: int, plte, trns,
           path) -> np.ndarray:
    """Samples at their own depth -> (H, W, C) u8 as the native codec
    gives them."""
    # A tRNS chunk of the wrong length is ignored, as libpng ignores it.
    n_key = {0: 2, 2: 6}.get(colour)
    if trns is not None and not (len(trns) == n_key if n_key else
                                 0 < len(trns) <= len(plte)):
        trns = None
    if colour == 3:
        # An index past the palette reads as black, as in libpng.
        table = np.zeros((256, 3), np.uint8)
        table[:len(plte)] = plte[:256]
        idx = img[..., 0]
        out = table[idx]
        if trns is not None:
            alpha = np.full(256, 255, np.uint8)
            alpha[:len(trns)] = np.frombuffer(trns, np.uint8)
            out = np.concatenate([out, alpha[idx][..., None]], axis=-1)
        return np.ascontiguousarray(out)
    alpha = None
    if trns is not None:
        key = np.array(struct.unpack(f">{_SAMPLES[colour]}H",
                                     trns[:2 * _SAMPLES[colour]]), np.uint16)
        alpha = np.where((img == key).all(axis=-1), 0, 255).astype(np.uint8)
    if depth == 16:
        out = (img >> 8).astype(np.uint8)
    elif depth < 8:
        out = (img * (255 // ((1 << depth) - 1))).astype(np.uint8)
    else:
        out = img.astype(np.uint8)
    if alpha is not None:
        out = np.concatenate([out, alpha[..., None]], axis=-1)
    return np.ascontiguousarray(out)


# -- writers ---------------------------------------------------------------------

def _u8_hwc(img, channels) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in channels:
        raise ValueError(f"expected an (H, W) or (H, W, C) uint8 array, C in "
                         f"{channels}; got {img.dtype} {img.shape}")
    return np.ascontiguousarray(img)


def save_png(path: str | os.PathLike, img: np.ndarray,
             compression: int = -1) -> None:
    """Encode an interleaved (H, W) or (H, W, C) u8 array, C in {1, 2, 3,
    4}, as an 8-bit PNG of colour type 0, 4, 2 or 6. ``compression`` is
    the zlib level 0-9 (-1 = zlib's default); the pixels are the same at
    every level."""
    img = _u8_hwc(img, tuple(_COLOUR))
    if not -1 <= compression <= 9:
        raise ValueError(f"compression must be -1..9, got {compression}")
    h, w, c = img.shape
    rows = np.zeros((h, 1 + w * c), np.uint8)       # filter byte 0 per row
    rows[:, 1:] = img.reshape(h, w * c)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    png = (_SIGNATURE
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _COLOUR[c],
                                        0, 0, 0))
           + chunk(b"IDAT", zlib.compress(rows.tobytes(), compression))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def save_jpeg(path: str | os.PathLike, img: np.ndarray,
              quality: int = 90) -> None:
    """Encode an interleaved (H, W) or (H, W, C) u8 array, C in {1, 3}, as
    a JPEG at ``quality``, with the native codec or else Pillow; raises
    ``OSError`` when neither is there."""
    img = _u8_hwc(img, (1, 3))
    h, w, c = img.shape
    lib = _load_lib()
    if lib is not None:
        ok = lib.imgio_save_jpeg(
            os.fsencode(path),
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), w, h, c,
            quality)
        if not ok:
            raise OSError(f"imgio: {lib.imgio_last_error().decode()} ({path})")
        return
    if not _have_pil():
        raise OSError(f"{path}: writing a JPEG needs the native codec "
                      f"(not built: {native_status()}) or Pillow (not "
                      f"installed)")
    from PIL import Image

    Image.fromarray(img[..., 0] if c == 1 else img).save(path,
                                                         quality=quality)
