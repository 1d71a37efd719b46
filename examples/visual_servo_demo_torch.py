"""Visual-servo MPC demo on the PyTorch port: drive feature points across a
real frame.

Runs the port's receding-horizon runtime (``MPCRuntime``) for a few camera
frames of a static scene, then renders the predicted feature trajectories
over the Sobel edge map. It runs on the card unless ``--device cpu`` is
given; without matplotlib it prints a line and skips the plot.

    python examples/visual_servo_demo_torch.py [--frames 8] [--out demo.png]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", default=None,
                    help="input photo (default: the in-package 1080p "
                         "benchmark frame)")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--scenarios", type=int, default=4)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--out", default="results/visual_servo_demo_torch.png")
    args = ap.parse_args(argv)

    import torch

    from openmp_parallel_computing_tpu_torch import data, imgio, ops
    from openmp_parallel_computing_tpu_torch.models.mpc import MPCRuntime
    from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig

    frame_hwc = imgio.load(args.image or data.frame_path())
    frame = torch.from_numpy(np.ascontiguousarray(
        np.transpose(frame_hwc, (2, 0, 1)))).to(args.device)
    h, w = frame.shape[1:]

    cfg = MPCConfig(horizon=args.horizon, num_features=4, ilqr_iters=3,
                    admm_iters=5)
    rt = MPCRuntime(cfg, device=args.device)
    rng = np.random.default_rng(0)
    n, m = args.scenarios, cfg.num_features
    p0 = rng.uniform(-0.7, 0.7, (n, 2 * m)).astype(np.float32)
    target = rng.uniform(-0.4, 0.4, (n, 2 * m)).astype(np.float32)
    depth = rng.uniform(1.5, 4.0, (n, m)).astype(np.float32)
    rt.reset(p0, target, depth)

    states = [p0]
    t0 = time.perf_counter()
    for _ in range(args.frames):
        u0 = rt.step(frame)
        states.append(rt.scen.p0.cpu().numpy())
    wall = time.perf_counter() - t0
    print(f"{args.frames} frames x {n} scenarios on {rt.mpc.device} in "
          f"{wall:.2f}s ({1e3 * wall / args.frames:.1f} ms/frame); final "
          f"|u0| max = {u0.abs().max().item():.3f}")

    try:
        import matplotlib
    except ImportError:
        print("visual_servo_demo_torch: matplotlib is not installed; the "
              "plot is skipped")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # Render: edge map + trajectories + targets.
    edge = ops.edge_pipeline(frame)[0].cpu().numpy()
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.imshow(edge, cmap="gray")
    traj = np.stack(states)  # (F+1, n, 2m)
    to_px = lambda v, size: (v + 1.0) * 0.5 * (size - 1)
    colors = plt.cm.tab10(np.linspace(0, 1, n))
    for s in range(n):
        for f_idx in range(m):
            xs = to_px(traj[:, s, 2 * f_idx], w)
            ys = to_px(traj[:, s, 2 * f_idx + 1], h)
            ax.plot(xs, ys, "-o", color=colors[s], markersize=2.5,
                    linewidth=1.0)
            ax.plot(to_px(target[s, 2 * f_idx], w),
                    to_px(target[s, 2 * f_idx + 1], h), "x",
                    color=colors[s], markersize=8)
    ax.set_title("visual-servo MPC: feature trajectories (o) toward "
                 "targets (x) over the Sobel edge map")
    ax.set_axis_off()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(args.out, dpi=110, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
