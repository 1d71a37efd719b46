"""The warm-start-chain measurement shared by the MPC benches.

Port of ``openmp_parallel_computing_tpu.bench._chain``: reps form a
warm-start dependency chain (each rep's ``us0`` is the previous rep's
plan rolled by one step), so the card runs them strictly in order; the
window ends in ``torch.cuda.synchronize()`` and a fetch of the last
controls, which depend on every rep before them.
"""

from __future__ import annotations

import time

import torch


def load_headline_frame(device="cuda") -> torch.Tensor:
    """The canonical 1080p benchmark input as a planar (C, H, W) u8
    tensor on ``device``."""
    from openmp_parallel_computing_tpu_torch import data

    return data.load_frame_planar(device)


def fetch(t: torch.Tensor) -> torch.Tensor:
    """Wait for the card (when ``t`` is on one), then copy ``t`` to the
    host: the end of a timed window."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return t.cpu()


def check_finite(u0: torch.Tensor) -> None:
    """Raise when a window's last controls are not finite: a kernel that
    made NaNs must fail the bench, not report a plausible number."""
    if not torch.isfinite(u0).all():
        raise RuntimeError("the final controls are not finite")


def require_card(what: str) -> None:
    """Raise unless a CUDA card is attached: the timing studies' command
    lines measure the card and never fall back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device: {what} runs on a GPU")


def window_rates(window, scen, batch: int, steps: int,
                 trials: int) -> list[float]:
    """Solves/s of ``trials`` windows of ``steps`` closed-loop steps at
    ``batch``, after two warm windows: the first adds the dual carry to
    the scenario. ``window(scen)`` runs one window and returns
    ``(u0s, costs, scen')``; each window ends in ``fetch`` of its last
    controls, which depend on every step before them, and the final
    controls go through ``check_finite``."""
    for _ in range(2):
        u0s, _, scen = window(scen)
        fetch(u0s[-1])
    vals = []
    for _ in range(trials):
        t0 = time.perf_counter()
        u0s, _, scen = window(scen)
        last = fetch(u0s[-1])
        vals.append(batch * steps / (time.perf_counter() - t0))
    check_finite(last)
    return vals


def chain_throughput(mpc, frame, batch: int, reps: int,
                     trials: int = 1, seed: int = 0) -> list[float]:
    """Measure ``trials`` back-to-back warm-start chains of ``reps`` full
    control steps (perception, pyramid, batched solve) on ``frame``;
    returns solves/s per trial. One untimed step warms up first; the final
    controls go through ``check_finite``."""
    scen = mpc.random_scenarios(batch,
                                generator=torch.Generator().manual_seed(seed))

    def step(s):
        u0, sol = mpc.control_step(frame, s)
        return u0, s._replace(us0=torch.roll(sol.us, -1, dims=1))

    u0, s = step(scen)
    last = fetch(u0)

    vals = []
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(reps):
            u0, s = step(s)
        last = fetch(u0)
        vals.append(batch * reps / (time.perf_counter() - t0))
    check_finite(last)
    return vals
