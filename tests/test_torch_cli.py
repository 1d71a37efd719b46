"""The port's image entry point against the JAX package: the kernel
registry, the CLI, the batch runner and the PNG codec."""

import re
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from openmp_parallel_computing_tpu import cli as jax_cli
from openmp_parallel_computing_tpu import imgio as jax_imgio
from openmp_parallel_computing_tpu.ops import runner as jax_runner
from openmp_parallel_computing_tpu.models.vision import (
    EdgeBatchRunner as JaxEdgeBatchRunner,
)
from openmp_parallel_computing_tpu_torch import cli, imgio, ops, parallel
from openmp_parallel_computing_tpu_torch.ops import runner
from openmp_parallel_computing_tpu_torch.parallel import introspect, spatial
from openmp_parallel_computing_tpu_torch.models.vision import EdgeBatchRunner

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

BUILTINS = ("grayscale", "edge", "blur")
REPORT = re.compile(r"^(.*) ×(\d+): (\d+\.\d{4}) s$")


@pytest.fixture()
def png(tmp_path):
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, size=(40, 136, 3), dtype=np.uint8)
    p = tmp_path / "in.png"
    imgio.save_png(p, img)
    return p, img


# -- registry -----------------------------------------------------------

def test_builtin_kernels_registered():
    assert ops.kernel_names()[:3] == BUILTINS


def test_register_duplicate_and_unregister():
    with pytest.raises(ValueError, match="already registered"):
        ops.register_kernel("edge", lambda img, passes: img)
    spec = ops.register_kernel("invert", lambda img, passes: 255 - img)
    try:
        assert isinstance(spec, ops.KernelSpec) and spec.name == "invert"
        assert "invert" in ops.kernel_names()
        img = torch.arange(12, dtype=torch.uint8).reshape(3, 2, 2)
        assert torch.equal(ops.make_runner("invert")(img), 255 - img)
        ops.register_kernel("invert", lambda img, passes: img + passes,
                            overwrite=True)
        assert torch.equal(ops.make_runner("invert", passes=2)(img), img + 2)
    finally:
        ops.unregister_kernel("invert")
    assert "invert" not in ops.kernel_names()
    with pytest.raises(KeyError):
        ops.make_runner("invert")


def test_make_runner_repeats_passes():
    img = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (3, 20, 30), dtype=np.uint8))
    assert torch.equal(ops.make_runner("blur", passes=3)(img),
                       ops.gaussian_blur(img, passes=3))


def test_make_runner_clamps_devices_to_the_attached_cards():
    # No card here: devices=2 is clamped to 1, as the JAX runner clamps to
    # len(jax.devices()).
    img = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (3, 20, 30), dtype=np.uint8))
    assert torch.equal(ops.make_runner("edge", passes=2, devices=2)(img),
                       ops.make_runner("edge", passes=2, devices=1)(img))


def _two_cpu_cards(monkeypatch):
    """Two attached cards as the runner sees them, the mesh's default
    devices two CPU shards."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(parallel.mesh, "default_devices",
                        lambda: [torch.device("cpu")] * 2)


@pytest.mark.parametrize("kernel", BUILTINS)
def test_make_runner_shards_over_two_devices_like_jax(monkeypatch, kernel):
    _two_cpu_cards(monkeypatch)
    img = np.random.default_rng(3).integers(0, 256, (3, 31, 40),
                                            dtype=np.uint8)
    padded, orig_h = runner.pad_rows(torch.from_numpy(img), 2)
    jpadded, jorig_h = jax_runner.pad_rows(img, 2)
    assert orig_h == jorig_h == 31 and padded.shape[1] == 32
    run = ops.make_runner(kernel, passes=2, devices=2, orig_h=orig_h)
    cols = introspect.collective_footprint(run, padded)
    if kernel != "grayscale":    # the halo exchange: the sharded path ran
        assert {c.primitive for c in cols} == {"ppermute"}, cols
    want = np.asarray(jax_runner.make_runner(kernel, 2, 2, orig_h=31)(
        jpadded))
    np.testing.assert_array_equal(run(padded).numpy(), want)
    np.testing.assert_array_equal(
        run(padded).numpy()[:, :31],
        ops.make_runner(kernel, passes=2)(torch.from_numpy(img)).numpy())


# -- CLI ----------------------------------------------------------------

@pytest.mark.parametrize("kernel", BUILTINS)
def test_cli_matches_jax_cli(png, tmp_path, capsys, kernel):
    src, _ = png
    ours, theirs = tmp_path / "ours.png", tmp_path / "theirs.png"
    assert cli.main([str(src), str(ours), "2", "--kernel", kernel],
                    device="cpu") == 0
    our_line = capsys.readouterr().out.strip()
    assert jax_cli.main([str(src), str(theirs), "2", "--kernel", kernel]) == 0
    their_line = capsys.readouterr().out.strip()
    mo, mt = REPORT.match(our_line), REPORT.match(their_line)
    assert mo and mt, (our_line, their_line)
    assert mo.group(1, 2) == mt.group(1, 2)
    np.testing.assert_array_equal(imgio.load(ours), imgio.load(theirs))


def test_cli_missing_input_returns_1(tmp_path, capsys):
    rc = cli.main([str(tmp_path / "nope.png"), str(tmp_path / "o.png")],
                  device="cpu")
    assert rc == 1
    assert "error loading" in capsys.readouterr().err


def _malformed_png(tmp_path, how: str):
    """An 8x9 RGB PNG from ``imgio.save_png``, broken as ``how`` says:
    "idat" zeroes the 4 bytes after the IDAT tag, "cut<k>" keeps the
    first k bytes."""
    p = tmp_path / f"{how}.png"
    imgio.save_png(p, np.random.default_rng(8).integers(
        0, 256, (8, 9, 3), dtype=np.uint8))
    raw = bytearray(p.read_bytes())
    if how == "idat":
        at = raw.index(b"IDAT") + 4
        raw[at:at + 4] = bytes(4)
    else:
        raw = raw[:int(how[3:])]
    p.write_bytes(bytes(raw))
    return p


@pytest.mark.parametrize("how", ["idat", "cut10", "cut20", "cut35", "cut40"])
def test_cli_malformed_png_returns_1_like_jax(tmp_path, capsys, how):
    bad = _malformed_png(tmp_path, how)
    for decoder in imgio.available_decoders():
        with pytest.raises((OSError, ValueError), match=re.escape(str(bad))):
            _load_with(decoder, bad)
    assert cli.main([str(bad), str(tmp_path / "o.png")], device="cpu") == 1
    ours = capsys.readouterr().err
    assert jax_cli.main([str(bad), str(tmp_path / "t.png")]) == 1
    theirs = capsys.readouterr().err
    assert ours.startswith("error loading image:"), ours
    assert theirs.startswith("error loading image:"), theirs
    assert not (tmp_path / "o.png").exists()


def test_cli_several_devices_on_one_runs_like_jax(png, tmp_path, capsys):
    src, _ = png
    ours, theirs = tmp_path / "ours.png", tmp_path / "theirs.png"
    assert cli.main([str(src), str(ours), "--kernel", "edge", "--devices",
                     "2"], device="cpu") == 0
    assert REPORT.match(capsys.readouterr().out.strip())
    assert jax_cli.main([str(src), str(theirs), "--kernel", "edge",
                         "--devices", "2"]) == 0
    np.testing.assert_array_equal(imgio.load(ours), imgio.load(theirs))


@pytest.mark.parametrize("kernel", BUILTINS)
def test_cli_shards_over_two_devices_like_jax(tmp_path, capsys, monkeypatch,
                                              kernel):
    # With two cards attached the clamp leaves 2: the rows (41, padded to
    # 42) are split over the mesh's two shards.
    _two_cpu_cards(monkeypatch)
    calls = []
    name = {"grayscale": "sharded_grayscale", "edge": "sharded_edge_pipeline",
            "blur": "sharded_gaussian_blur"}[kernel]
    sharded = getattr(spatial, name)
    monkeypatch.setattr(spatial, name,
                        lambda *a, **k: calls.append(1) or sharded(*a, **k))
    src = tmp_path / "odd.png"
    imgio.save_png(src, np.random.default_rng(10).integers(
        0, 256, (41, 136, 3), dtype=np.uint8))
    ours, theirs = tmp_path / "ours.png", tmp_path / "theirs.png"
    assert cli.main([str(src), str(ours), "3", "--kernel", kernel,
                     "--devices", "2"], device="cpu") == 0
    assert REPORT.match(capsys.readouterr().out.strip())
    assert len(calls) == 2 * 3      # warm-up and timed run, 3 passes each
    assert jax_cli.main([str(src), str(theirs), "3", "--kernel", kernel,
                         "--devices", "2"]) == 0
    np.testing.assert_array_equal(imgio.load(ours), imgio.load(theirs))
    assert imgio.load(ours).shape == (41, 136, 3)


def test_cli_without_a_card_raises(png, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is attached: the command line would run")
    src, _ = png
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([str(src), str(tmp_path / "o.png")])
    assert not (tmp_path / "o.png").exists()


# -- batch runner ---------------------------------------------------------

@pytest.mark.parametrize("kernel", BUILTINS)
def test_edge_batch_runner_equals_per_frame(kernel):
    rng = np.random.default_rng(4)
    frames = torch.from_numpy(rng.integers(0, 256, (3, 4, 18, 26),
                                           dtype=np.uint8))
    fn = {"edge": ops.edge_pipeline, "grayscale": ops.grayscale,
          "blur": ops.gaussian_blur}[kernel]
    runner = EdgeBatchRunner(kernel=kernel)
    got = runner(frames)
    assert torch.equal(got, torch.stack([fn(f) for f in frames]))
    got2 = runner.throughput_fn(2)(frames)
    assert torch.equal(got2, torch.stack([fn(f, passes=2) for f in frames]))


def test_edge_batch_runner_equals_jax():
    frames = np.random.default_rng(6).integers(0, 256, (2, 3, 17, 33),
                                               dtype=np.uint8)
    got = EdgeBatchRunner()(torch.from_numpy(frames))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JaxEdgeBatchRunner()(frames)))


# -- PNG codec ------------------------------------------------------------

@pytest.mark.parametrize("channels", [None, 1, 2, 3, 4])
def test_save_png_round_trip(tmp_path, channels):
    rng = np.random.default_rng(channels or 0)
    shape = (13, 21) if channels is None else (13, 21, channels)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    p = tmp_path / "rt.png"
    imgio.save_png(p, img)
    back = imgio.load(p)
    np.testing.assert_array_equal(back, img.reshape(13, 21, -1))
    np.testing.assert_array_equal(jax_imgio.load(p), back)
    colour = p.read_bytes()[25]
    assert colour == {None: 0, 1: 0, 2: 4, 3: 2, 4: 6}[channels]


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_load_matches_jax_loader_on_pillow_files(tmp_path, mode):
    rng = np.random.default_rng(len(mode))
    c = len(mode)
    arr = rng.integers(0, 256, (31, 45, c), dtype=np.uint8)
    # Smooth rows so that Pillow's adaptive filters pick Sub/Up/Avg/Paeth.
    arr = np.cumsum(arr // 16, axis=1, dtype=np.uint8)
    p = tmp_path / f"{mode}.png"
    Image.fromarray(arr[:, :, 0] if c == 1 else arr, mode).save(p)
    ours = imgio.load(p)
    assert ours.shape == (31, 45, c)
    np.testing.assert_array_equal(ours, arr)
    np.testing.assert_array_equal(ours, jax_imgio.load(p))


def _with_header(src, dst, depth=None, colour=None, interlace=None,
                 drop=()):
    """``src``'s PNG bytes with IHDR fields replaced (its CRC redone) and
    the chunks named in ``drop`` taken out, written to ``dst``."""
    raw = bytearray(src.read_bytes())
    for at, v in ((24, depth), (25, colour), (28, interlace)):
        if v is not None:
            raw[at] = v
    raw[29:33] = struct.pack(">I", zlib.crc32(bytes(raw[12:29])))
    out, pos = bytes(raw[:8]), 8
    while pos < len(raw):
        n = struct.unpack(">I", raw[pos:pos + 4])[0]
        if bytes(raw[pos + 4:pos + 8]) not in drop:
            out += bytes(raw[pos:pos + 12 + n])
        pos += 12 + n
    dst.write_bytes(out)
    return dst


def test_load_rejects_16_bit_and_palette(tmp_path):
    """16-bit and palette PNGs decode (test_torch_imgio.py); what the
    spec refuses does not: a 16-bit palette image, and a palette image
    without its PLTE chunk. Every decoder that is there refuses both,
    naming the file, as the JAX package's loader does."""
    pal = tmp_path / "pal.png"
    Image.fromarray(np.arange(60, dtype=np.uint8).reshape(6, 10), "L"
                    ).convert("P").save(pal)
    assert pal.read_bytes()[25] == 3
    bad = [_with_header(pal, tmp_path / "p16.png", depth=16),
           _with_header(pal, tmp_path / "noplte.png", drop=(b"PLTE",))]
    for p in bad:
        with pytest.raises(OSError, match=p.name):
            jax_imgio.load(p)
        for decoder in imgio.available_decoders():
            with pytest.raises((OSError, ValueError), match=p.name):
                _load_with(decoder, p)
    with pytest.raises(ValueError, match="depth=16, colour type=3"):
        imgio._load_png(bad[0])
    with pytest.raises(ValueError, match="without PLTE"):
        imgio._load_png(bad[1])


def test_load_rejects_interlaced(tmp_path):
    """Adam7 (interlace method 1) decodes (test_torch_imgio.py); any
    other interlace method is refused by every decoder, naming the
    file."""
    src = tmp_path / "g.png"
    imgio.save_png(src, np.zeros((4, 4, 3), np.uint8))
    p = _with_header(src, tmp_path / "i2.png", interlace=2)
    for decoder in imgio.available_decoders():
        with pytest.raises((OSError, ValueError), match=p.name):
            _load_with(decoder, p)
    with pytest.raises(ValueError, match="interlace=2"):
        imgio._load_png(p)


def test_save_png_rejects_bad_arrays(tmp_path):
    with pytest.raises(ValueError):
        imgio.save_png(tmp_path / "a.png", np.zeros((4, 4, 5), np.uint8))
    with pytest.raises(ValueError):
        imgio.save_png(tmp_path / "b.png", np.zeros((4, 4, 3), np.int32))
