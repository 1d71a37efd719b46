"""The PyTorch port's PNG decoder against the JAX package's image I/O."""

import struct
import zlib

import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu import imgio as jax_imgio
from openmp_parallel_computing_tpu_torch import data, imgio

torch.set_num_threads(2)


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
    path = tmp_path / "g.png"
    body = struct.pack(">IIBBBBB", 4, 4, 16, 2, 0, 0, 0)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + struct.pack(">I", 13) + b"IHDR"
                     + body + b"\0\0\0\0")
    with pytest.raises(ValueError, match="8-bit"):
        imgio.load(path)
    (tmp_path / "h.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        imgio.load(tmp_path / "h.png")


def test_planar_fixture_tensor():
    f = data.load_frame_planar()
    assert f.dtype == torch.uint8 and tuple(f.shape) == (3, 1080, 1920)
    assert f.is_contiguous()
