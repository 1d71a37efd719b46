"""Grey frames (C = 1) through the port against the JAX package: the frame
ops, the CLI and the MPC loop; a grey + alpha frame (C = 2) refused.

The JAX kernels read a grey frame as R = G = B (their clamped block reads
of planes 1 and 2), and the fixed-point luma of (p, p, p) is p, so each op
works on the plane itself. The JAX side runs its Pallas kernels in
interpret mode (``conftest.py``); the port runs the plain version each
wrapper takes for a CPU tensor. Tolerances: the image ops, the perception
kernel's block means and the CLI's pixels bit for bit (integer arithmetic,
and block sums of integers below 2^24); the MPC loop rtol = atol = 1e-4 on
every step, the solver tolerance of ``tests/test_torch_solver.py``.
"""

import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmp_parallel_computing_tpu import cli as jax_cli
from openmp_parallel_computing_tpu import ops as jops
from openmp_parallel_computing_tpu.models.mpc import VisualServoMPC as JaxMPC
from openmp_parallel_computing_tpu.models.mpc import Scenario as JaxScenario
from openmp_parallel_computing_tpu.utils.config import MPCConfig as JaxConfig
from openmp_parallel_computing_tpu_torch import cli, convert, imgio, ops
from openmp_parallel_computing_tpu_torch.models.mpc import VisualServoMPC

torch.set_num_threads(2)

GREY_SHAPES = [(1, 29, 41), (1, 2, 7), (1, 40, 136)]
LOOP_TOL = 1e-4
REPORT = re.compile(r"^(.*) ×(\d+): (\d+\.\d{4}) s$")


def _grey(shape, seed=None):
    rng = np.random.default_rng(sum(shape) if seed is None else seed)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    return torch.from_numpy(img.copy()), jnp.asarray(img)


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("shape", GREY_SHAPES)
def test_grayscale_of_a_grey_frame_is_the_frame(shape, passes):
    t, j = _grey(shape)
    got = ops.grayscale(t, passes=passes)
    want = np.asarray(jops.grayscale(j, passes=passes))
    assert want.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, t)


@pytest.mark.parametrize("border,passes", [("zero", 1), ("zero", 3),
                                           ("none", 1)])
@pytest.mark.parametrize("shape", GREY_SHAPES)
def test_edge_pipeline_of_a_grey_frame_equals_pallas(shape, border, passes):
    """The edge pass at C = 1: (1, H, W) out, the Sobel of the plane."""
    t, j = _grey(shape)
    got = ops.edge_pipeline(t, border=border, passes=passes)
    want = np.asarray(jops.edge_pipeline(j, border=border, passes=passes))
    assert want.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)
    if passes == 1:
        np.testing.assert_array_equal(
            got[0].numpy(), np.asarray(jops.sobel(j[0], border=border)))
        assert torch.equal(got[0], ops.sobel(t[0], border))


@pytest.mark.parametrize("shape", [(1, 37, 50), (1, 3, 6)])
def test_edge_border_none_passes_chain_on_a_grey_frame(shape):
    """border="none", passes=3 equals three chained JAX calls (JAX's own
    passes=3 reads its padding: ROADMAP quirk 1)."""
    t, j = _grey(shape)
    want = j
    for _ in range(3):
        want = jops.edge_pipeline(want, border="none")
    np.testing.assert_array_equal(
        ops.edge_pipeline(t, border="none", passes=3).numpy(),
        np.asarray(want))


@pytest.mark.parametrize("s", [1, 4, 16, 10])
def test_edge_pyramid_base_of_a_grey_frame_equals_pallas(s):
    """Block means of the plane's Sobel; at s = 10 within one float32 ulp
    of JAX's fused kernel (ROADMAP quirk 4) and equal to its staged path."""
    t, j = _grey((1, 37, 45), seed=s)
    got = ops.edge_pyramid_base(t, s).numpy()
    fused = np.asarray(jops.edge_pyramid_base(j, s=s))
    if s & (s - 1):
        np.testing.assert_array_max_ulp(got, fused, maxulp=1)
    else:
        np.testing.assert_array_equal(got, fused)
    rgb = torch.cat([t] * 3)
    np.testing.assert_array_equal(got, ops.edge_pyramid_base(rgb, s).numpy())


def test_grayscale_mean_minmax_of_a_grey_frame_equals_pallas():
    t, j = _grey((1, 33, 50))
    gray, mn, mx = ops.grayscale_mean_minmax(t)
    jgray, jmn, jmx = jops.grayscale_mean_minmax(j)
    assert gray.shape == (3, 33, 50) and np.asarray(jgray).shape == (3, 33, 50)
    np.testing.assert_array_equal(gray.numpy(), np.asarray(jgray))
    assert (int(mn), int(mx)) == (int(jmn), int(jmx))
    assert torch.equal(gray, t.to(torch.int32).expand(3, -1, -1))


@pytest.mark.parametrize("call", [
    lambda x: ops.grayscale(x), lambda x: ops.edge_pipeline(x),
    lambda x: ops.edge_pyramid_base(x), lambda x: ops.grayscale_mean_minmax(x),
], ids=["grayscale", "edge_pipeline", "edge_pyramid_base",
        "grayscale_mean_minmax"])
def test_grey_alpha_frames_are_refused(call):
    """C = 2 is not a contract in JAX (ROADMAP quirk 3): every frame op of
    the port raises a ValueError that names the channel counts it takes."""
    with pytest.raises(ValueError, match=r"C in \(1, 3, 4\)"):
        call(torch.zeros((2, 8, 9), dtype=torch.uint8))


@pytest.fixture()
def grey_png(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (37, 50), dtype=np.uint8)
    p = tmp_path / "grey.png"
    imgio.save_png(p, img)
    return p


@pytest.mark.parametrize("kernel", ["grayscale", "edge", "blur"])
def test_cli_on_a_grey_png_matches_jax_cli(grey_png, tmp_path, capsys,
                                          kernel):
    """rc 0, the same report and the same pixels as the JAX CLI, and no
    warning (the decoded array is copied before it becomes a tensor)."""
    ours, theirs = tmp_path / "ours.png", tmp_path / "theirs.png"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert cli.main([str(grey_png), str(ours), "2", "--kernel", kernel],
                        device="cpu") == 0
    our_line = capsys.readouterr().out.strip()
    assert jax_cli.main([str(grey_png), str(theirs), "2", "--kernel",
                         kernel]) == 0
    mo = REPORT.match(our_line)
    mt = REPORT.match(capsys.readouterr().out.strip())
    assert mo and mt and mo.group(1, 2) == mt.group(1, 2)
    got = imgio.load(ours)
    assert got.shape == (37, 50, 1)
    np.testing.assert_array_equal(got, imgio.load(theirs))


@pytest.mark.parametrize("kernel", ["grayscale", "edge"])
def test_cli_on_a_grey_alpha_png_returns_1(tmp_path, capsys, kernel):
    src = tmp_path / "ga.png"
    imgio.save_png(src, np.random.default_rng(1).integers(
        0, 256, (9, 11, 2), dtype=np.uint8))
    out = tmp_path / "o.png"
    assert cli.main([str(src), str(out), "--kernel", kernel],
                    device="cpu") == 1
    err = capsys.readouterr().err
    assert err.startswith("error"), err
    assert "Traceback" not in err and "C in (1, 3, 4)" in err
    assert not out.exists()


def _grey_frames(n, h, w, seed):
    """Smooth synthetic grey frames with edges of every strength."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for k in range(n):
        a, b = rng.uniform(4, 12, 2)
        base = 128 + 90 * np.sin(xx / a + k) * np.cos(yy / b)
        out.append(np.clip(base + rng.normal(0, 8, (h, w)), 0, 255)
                   .astype(np.uint8)[None])
    return np.stack(out)


def test_receding_horizon_on_grey_frames_matches_jax():
    """The main path (edge_refresh="solve") on a ring of grey frames,
    step by step against JAX."""
    H, m, B, steps = 6, 2, 8, 4
    frames = _grey_frames(2, 72, 120, seed=6)
    assert frames.shape == (2, 1, 72, 120)
    rng = np.random.default_rng(10)
    arrs = dict(p0=rng.uniform(-0.6, 0.6, (B, 2 * m)),
                target=rng.uniform(-0.5, 0.5, (B, 2 * m)),
                depth=rng.uniform(1.0, 5.0, (B, m)),
                us0=np.zeros((B, H, 6)))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    jcfg = JaxConfig(horizon=H, num_features=m, edge_refresh="solve")
    jax.clear_caches()
    ju0s, jcosts, _ = JaxMPC(jcfg).receding_horizon_frames(
        jnp.asarray(frames), JaxScenario(**{k: jnp.asarray(v)
                                            for k, v in arrs.items()}), steps)
    u0s, costs, _ = VisualServoMPC(convert.config(jcfg), "cpu").\
        receding_horizon_frames(torch.from_numpy(frames),
                                convert.scenario(JaxScenario(**arrs)), steps)
    assert u0s.shape == (steps, B, 6)
    for k in range(steps):
        np.testing.assert_allclose(u0s[k].numpy(), np.asarray(ju0s[k]),
                                   rtol=LOOP_TOL, atol=LOOP_TOL)
        np.testing.assert_allclose(costs[k].numpy(), np.asarray(jcosts[k]),
                                   rtol=LOOP_TOL, atol=LOOP_TOL)
