"""The PyTorch port's PNG decoder against the JAX package's image I/O."""

import inspect
import struct
import zlib

import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu import imgio as jax_imgio
from openmp_parallel_computing_tpu_torch import data, imgio

torch.set_num_threads(2)


def _load_with(decoder, path):
    """``imgio.load`` with the decoders before ``decoder`` in its order
    hidden, so that ``decoder`` is the one it takes."""
    with pytest.MonkeyPatch.context() as mp:
        if decoder != "native":
            mp.setattr(imgio, "_load_lib", lambda: None)
        if decoder == "png":
            mp.setattr(imgio, "_have_pil", lambda: False)
        return imgio.load(path)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_row(ftype, row, prev, bpp):
    """PNG-encode one row (int arrays) with filter ``ftype``."""
    left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
    pred = {0: 0, 1: left, 2: prev, 3: (left + prev) >> 1,
            4: _paeth(left, prev, upleft)}[ftype]
    return (row - pred) & 0xFF


def _write_png(path, img, filters):
    """Minimal 8-bit RGB/RGBA PNG encoder; row y uses filters[y % len]."""
    h, w, c = img.shape
    bpp = c
    raw = bytearray()
    prev = np.zeros(w * c, np.int64)
    for y in range(h):
        row = img[y].reshape(-1).astype(np.int64)
        ftype = filters[y % len(filters)]
        raw.append(ftype)
        raw += _filter_row(ftype, row, prev, bpp).astype(np.uint8).tobytes()
        prev = row

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    colour = {3: 2, 4: 6}[c]
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(bytes(raw)))
           + chunk(b"IEND", b""))
    path.write_bytes(png)


def test_decoder_matches_jax_package_on_1080p_fixture():
    ours = imgio.load(data.frame_path())
    ref = jax_imgio.load(data.frame_path())
    assert ours.shape == (1080, 1920, 3) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("channels", [3, 4])
def test_all_five_filters_round_trip(tmp_path, channels):
    rng = np.random.default_rng(11 + channels)
    img = rng.integers(0, 256, (23, 17, channels), dtype=np.uint8)
    path = tmp_path / "f.png"
    _write_png(path, img, filters=(0, 1, 2, 3, 4))
    ours = imgio.load(path)
    np.testing.assert_array_equal(ours, img)
    np.testing.assert_array_equal(ours, jax_imgio.load(path))


def test_rejects_unsupported_png(tmp_path):
    """A header the PNG spec does not allow (a 16-bit palette image), and
    a file that is not a PNG: every decoder that is there refuses both,
    naming the file."""
    path = tmp_path / "g.png"
    _write_png(path, np.zeros((4, 4, 3), np.uint8), filters=(0,))
    raw = bytearray(path.read_bytes())
    raw[24:26] = bytes([16, 3])                     # depth 16, palette
    raw[29:33] = struct.pack(">I", zlib.crc32(bytes(raw[12:29])))
    path.write_bytes(bytes(raw))
    for decoder in imgio.available_decoders():
        with pytest.raises((OSError, ValueError), match=str(path.name)):
            _load_with(decoder, path)
    with pytest.raises(ValueError, match="depth=16, colour type=3"):
        imgio._load_png(path)
    other = tmp_path / "h.png"
    other.write_bytes(b"not a png")
    for decoder in imgio.available_decoders():
        with pytest.raises((OSError, ValueError), match="h.png"):
            _load_with(decoder, other)
    with pytest.raises(ValueError, match="not a PNG"):
        imgio._load_png(other)


def test_planar_fixture_tensor():
    f = data.load_frame_planar("cpu")
    assert f.dtype == torch.uint8 and tuple(f.shape) == (3, 1080, 1920)
    assert f.is_contiguous() and f.device.type == "cpu"


def test_planar_fixture_defaults_to_the_card():
    # JAX's load_frame_planar returns the frame on its default device;
    # the port's default is the card (no card here: read the signature).
    default = inspect.signature(data.load_frame_planar).parameters["device"]
    assert default.default == "cuda"


# -- every kind of file, every decoder ------------------------------------------
#
# Files are written here by Pillow, by the JAX package's imgio, or, for
# the kinds neither writes (16-bit colour, sub-byte grey, Adam7, a palette
# index past the palette), by _write_raw_png. Each decoder of the port
# that is there must give the JAX package's pixels (``jax_imgio.load``,
# which takes the native codec first) exactly.

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_SPP = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _pack_rows(samples, depth):
    """(h, w, spp) samples at ``depth`` -> (h, rowbytes) packed bytes."""
    h = samples.shape[0]
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    shifts = np.arange(depth - 1, -1, -1)
    bits = ((samples[..., 0][..., None] >> shifts) & 1).reshape(h, -1)
    return np.packbits(bits.astype(np.uint8), axis=1)


def _filtered(samples, depth, filters):
    packed = _pack_rows(samples, depth).astype(np.int64)
    bpp = max(1, samples.shape[2] * depth // 8)
    out = bytearray()
    prev = np.zeros(packed.shape[1], np.int64)
    for y, row in enumerate(packed):
        ftype = filters[y % len(filters)]
        out.append(ftype)
        out += _filter_row(ftype, row, prev, bpp).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def _write_raw_png(path, samples, depth, colour, interlace=0, plte=None,
                   trns=None, filters=(0, 1, 2, 3, 4)):
    """A PNG of any colour type and depth from (h, w, spp) samples."""
    h, w, _ = samples.shape
    if interlace:
        raw = b"".join(_filtered(samples[y0::dy, x0::dx], depth, filters)
                       for x0, y0, dx, dy in _ADAM7
                       if samples[y0::dy, x0::dx].size)
    else:
        raw = _filtered(samples, depth, filters)

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    png = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, colour, 0, 0, interlace))
    if plte is not None:
        png += chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        png += chunk(b"tRNS", trns)
    path.write_bytes(png + chunk(b"IDAT", zlib.compress(raw))
                     + chunk(b"IEND", b""))


def _raw(depth, colour, interlace=0, n_plte=None, trns=None):
    def make(path, rng):
        hi = n_plte if colour == 3 else 1 << depth
        samples = rng.integers(0, hi, (19, 29, _SPP[colour]))
        plte = (None if colour != 3 else
                rng.integers(0, 256, (min(hi, 256), 3)))
        if colour == 3 and trns == "past":
            plte = plte[:max(1, len(plte) // 2)]     # indices past it: black
        key = trns
        if trns == "key":                            # a colour key in use
            key = struct.pack(f">{_SPP[colour]}H",
                              *(int(v) for v in samples[2, 3]))
        elif trns == "long":                         # longer than PLTE
            key = bytes(range(len(plte) + 3))
        elif trns == "past":
            key = None
        elif trns == "alpha":
            key = bytes(rng.integers(0, 256, max(1, len(plte) // 2))
                        .astype(np.uint8))
        _write_raw_png(path, samples, depth, colour, interlace, plte, key)
    return make


def _pil(mode, save=None, convert=None, bits=None, **kw):
    def make(path, rng):
        from PIL import Image

        if mode == "I;16":
            img = Image.fromarray(rng.integers(0, 65536, (19, 29))
                                  .astype(np.uint16))
        elif mode == "P":
            img = Image.fromarray(rng.integers(0, bits, (19, 29))
                                  .astype(np.uint8), "P")
            img.putpalette(rng.integers(0, 256, 3 * bits).astype(
                np.uint8).tobytes())
        else:
            c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
            arr = rng.integers(0, 256, (19, 29, c), dtype=np.uint8)
            if "transparency" in kw:               # a key that occurs
                arr = arr // 128 * 255
            img = Image.fromarray(arr[..., 0] if c == 1 else arr, mode)
        if convert:
            img = img.convert(convert)
        args = dict(kw)
        if args.get("transparency") == "bytes":
            args["transparency"] = bytes(rng.integers(0, 256, bits).astype(
                np.uint8))
        img.save(path, **args)
    return make


KINDS = {
    "jpeg_rgb": ("jpg", _pil("RGB", quality=90)),
    "jpeg_grey": ("jpg", _pil("L", quality=75)),
    "jpeg_cmyk": ("jpg", _pil("RGB", convert="CMYK")),
    "rgb8": ("png", _pil("RGB")),
    "rgba8": ("png", _pil("RGBA")),
    "grey8": ("png", _pil("L")),
    "grey_alpha8": ("png", _pil("LA")),
    "palette2": ("png", _pil("P", bits=2)),
    "palette16": ("png", _pil("P", bits=16)),
    "palette200": ("png", _pil("P", bits=200)),
    "palette_trns": ("png", _pil("P", bits=16, transparency="bytes")),
    "grey16": ("png", _pil("I;16")),
    "bilevel": ("png", _pil("L", convert="1")),
    "grey_key": ("png", _pil("L", transparency=255)),
    "rgb_key": ("png", _pil("RGB", transparency=(255, 0, 255))),
    "grey1": ("png", _raw(1, 0)),
    "grey2": ("png", _raw(2, 0)),
    "grey4": ("png", _raw(4, 0)),
    "palette1": ("png", _raw(1, 3, n_plte=2)),
    "palette4_alpha": ("png", _raw(4, 3, n_plte=16, trns="alpha")),
    "rgb16": ("png", _raw(16, 2)),
    "rgba16": ("png", _raw(16, 6)),
    "grey_alpha16": ("png", _raw(16, 4)),
    "grey16_key": ("png", _raw(16, 0, trns="key")),
    "interlaced_rgb8": ("png", _raw(8, 2, interlace=1)),
    "interlaced_rgba16": ("png", _raw(16, 6, interlace=1)),
    "interlaced_grey2": ("png", _raw(2, 0, interlace=1)),
    "interlaced_palette4_alpha": ("png", _raw(4, 3, interlace=1, n_plte=16,
                                              trns="alpha")),
    "palette_index_past_plte": ("png", _raw(8, 3, n_plte=40, trns="past")),
    "palette_trns_too_long": ("png", _raw(8, 3, n_plte=8, trns="long")),
}


@pytest.mark.parametrize("decoder", imgio.DECODERS)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_every_decoder_gives_the_jax_packages_pixels(tmp_path, kind,
                                                     decoder):
    ext, make = KINDS[kind]
    path = tmp_path / f"{kind}.{ext}"
    make(path, np.random.default_rng(sorted(KINDS).index(kind)))
    want = jax_imgio.load(path)
    assert want.dtype == np.uint8 and want.ndim == 3
    if decoder not in imgio.available_decoders():
        pytest.skip(f"decoder {decoder!r} is not installed here")
    if decoder == "png" and ext == "jpg":
        with pytest.raises(ValueError, match="not a PNG file"):
            imgio._load_png(path)
        return
    got = _load_with(decoder, path)
    assert imgio.decoder_used() == decoder
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_a_16_bit_colour_key_goes_past_pil_to_the_png_decoder(tmp_path):
    """A 16-bit RGB PNG with a tRNS key: Pillow reads 8-bit samples and
    cannot compare them with the key as libpng does, so where the native
    codec is missing ``load`` reads the file with the PNG decoder, to the
    JAX package's pixels; the native codec reads it too."""
    path = tmp_path / "k.png"
    _raw(16, 2, trns="key")(path, np.random.default_rng(3))
    want = jax_imgio.load(path)
    assert want.shape[-1] == 4
    for decoder, used in (("native", "native"), ("pil", "png"),
                          ("png", "png")):
        np.testing.assert_array_equal(_load_with(decoder, path), want)
        assert imgio.decoder_used() == used


def test_load_takes_the_first_decoder_that_is_there(tmp_path, monkeypatch):
    path = tmp_path / "a.png"
    jax_imgio.save_png(path, np.random.default_rng(4).integers(
        0, 256, (9, 7, 3), dtype=np.uint8))
    want = jax_imgio.load(path)
    assert imgio.available_decoders() == imgio.DECODERS
    assert imgio.native_status() == "built"
    order = []
    for drop in ("native", "pil"):
        if drop == "native":
            monkeypatch.setattr(imgio, "_load_lib", lambda: None)
        else:
            monkeypatch.setattr(imgio, "_have_pil", lambda: False)
        np.testing.assert_array_equal(imgio.load(path), want)
        order.append(imgio.decoder_used())
    assert order == ["pil", "png"]


def test_jpeg_without_a_codec_names_the_file_and_the_codecs(tmp_path,
                                                           monkeypatch):
    path = tmp_path / "x.jpg"
    _pil("RGB")(path, np.random.default_rng(5))
    monkeypatch.setattr(imgio, "_load_lib", lambda: None)
    monkeypatch.setattr(imgio, "_have_pil", lambda: False)
    monkeypatch.setitem(imgio._native, "why", "no jpeglib.h")
    with pytest.raises(OSError) as exc:
        imgio.load(path)
    msg = str(exc.value)
    assert str(path) in msg and "native" in msg and "Pillow" in msg
    assert "no jpeglib.h" in msg


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_save_png_gives_the_same_pixels_at_every_level(tmp_path, channels):
    img = np.random.default_rng(channels).integers(
        0, 64, (31, 45, channels), dtype=np.uint8)
    sizes = {}
    for level in (0, 1, 9, -1):
        path = tmp_path / f"l{level}.png"
        imgio.save_png(path, img, compression=level)
        sizes[level] = path.stat().st_size
        np.testing.assert_array_equal(jax_imgio.load(path), img)
        np.testing.assert_array_equal(imgio._load_png(path), img)
    assert sizes[0] > sizes[1] >= sizes[9]
    with pytest.raises(ValueError, match="compression"):
        imgio.save_png(tmp_path / "bad.png", img, compression=10)


def test_save_jpeg_matches_the_jax_packages(tmp_path, monkeypatch):
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)
    for quality in (90, 50):
        ours, theirs = tmp_path / f"o{quality}.jpg", tmp_path / f"t{quality}.jpg"
        imgio.save_jpeg(ours, img, quality=quality)
        jax_imgio.save_jpeg(theirs, img, quality=quality)
        np.testing.assert_array_equal(jax_imgio.load(ours),
                                      jax_imgio.load(theirs))
    grey = img[..., :1]
    imgio.save_jpeg(tmp_path / "g.jpg", grey)
    assert imgio.load(tmp_path / "g.jpg").shape == (24, 40, 1)
    with pytest.raises(ValueError):
        imgio.save_jpeg(tmp_path / "rgba.jpg", np.zeros((4, 4, 4), np.uint8))
    # through Pillow where the native codec is missing: a JPEG still
    monkeypatch.setattr(imgio, "_load_lib", lambda: None)
    imgio.save_jpeg(tmp_path / "pil.jpg", img, quality=90)
    assert jax_imgio.load(tmp_path / "pil.jpg").shape == img.shape


@pytest.mark.parametrize("kind", ["jpeg_rgb", "palette16", "grey16"])
def test_both_clis_read_jpeg_palette_and_16_bit(tmp_path, capsys, kind):
    from openmp_parallel_computing_tpu import cli as jax_cli
    from openmp_parallel_computing_tpu_torch import cli

    ext, make = KINDS[kind]
    src = tmp_path / f"in.{ext}"
    make(src, np.random.default_rng(7))
    ours, theirs = tmp_path / "ours.png", tmp_path / "theirs.png"
    assert cli.main([str(src), str(ours), "2", "--kernel", "edge"],
                    device="cpu") == 0
    assert jax_cli.main([str(src), str(theirs), "2", "--kernel", "edge"]) == 0
    capsys.readouterr()
    np.testing.assert_array_equal(imgio.load(ours), jax_imgio.load(theirs))
