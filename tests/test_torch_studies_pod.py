"""The port's pod studies against the JAX package's on the CPU.

``pod_anchor.run`` at 1 and 2 shards (the port's logical CPU shards, JAX's
virtual CPU devices of ``conftest.py``) with each module's clock replaced
by one fake clock, so both time the same durations: the outputs (rows,
the fit, its residuals) are equal but for the methodology texts, while
every step really runs. ``pod_model``: ``test_torch_studies_card``.
"""

import torch

from openmp_parallel_computing_tpu.bench import pod_anchor as jax_anchor
from openmp_parallel_computing_tpu_torch.bench import pod_anchor

torch.set_num_threads(2)

TEXTS = ("methodology", "first_disagreement_watch", "mapping", "source",
         "how_to_falsify")


class FakeClock:
    """``perf_counter`` advancing by a growing step on every read."""

    def __init__(self):
        self.t = 0.0
        self.k = 0

    def perf_counter(self):
        self.k += 1
        self.t += 0.001 * (self.k % 7 + 1) ** 2
        return self.t


def _without_texts(tree):
    if isinstance(tree, dict):
        return {k: _without_texts(v) for k, v in tree.items()
                if k not in TEXTS}
    if isinstance(tree, list):
        return [_without_texts(v) for v in tree]
    return tree


def test_pod_anchor_matches_jax(monkeypatch):
    args = ([1, 2], 2, 8, 2)
    monkeypatch.setattr(jax_anchor, "time", FakeClock())
    want = jax_anchor.run(*args, frame_hw=(48, 96))
    monkeypatch.setattr(pod_anchor, "time", FakeClock())
    got = pod_anchor.run(*args, frame_hw=(48, 96), device="cpu")
    assert set(got) == set(want)
    assert _without_texts(got) == _without_texts(want)
    assert [r["total_batch"] for r in got["rows"]] == [2, 4]
    assert got["model_fit"]["alpha_fit_us_per_hop"] != 0
