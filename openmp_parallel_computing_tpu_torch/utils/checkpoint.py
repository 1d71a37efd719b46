"""Checkpoint / resume (port of
``openmp_parallel_computing_tpu.utils.checkpoint``, in its file format).

One ``.npz`` a checkpoint: a ``__treedef__`` entry (the tree's JSON spec,
as uint8 bytes) and the leaves as ``leaf_0``, ``leaf_1``, ... in the
spec's order. Writes are atomic (a temporary file in the same directory,
then ``os.replace``). The spec is the JAX package's: dict keys sorted; a
NamedTuple stored as a dict in ``_fields`` order; lists and tuples kept
apart; ``None`` a node that takes no leaf slot. So a checkpoint that
either package writes restores in the other.

Leaves are torch tensors (saved as ``.cpu().numpy()``), numpy arrays or
numbers. ``restore`` returns numpy leaves, as the JAX package does. This
module writes no ``"key"`` node (torch has no typed PRNG key); where it
reads one that the JAX package wrote, it returns the key's raw uint32
data as a plain leaf.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path

import numpy as np
import torch


def _array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str | os.PathLike, tree) -> None:
    """Atomically write a tree of tensors, arrays and numbers (nested in
    dicts, lists, tuples and NamedTuples; ``None`` allowed) to ``path``
    (.npz)."""
    leaves: list = []
    spec = _treedef_to_spec(tree, leaves)
    arrays = {f"leaf_{i}": _array(l) for i, l in enumerate(leaves)}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __treedef__=np.frombuffer(
                json.dumps(spec).encode(), dtype=np.uint8), **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def restore(path: str | os.PathLike):
    """Read a tree written by ``save`` (of either package); numpy
    leaves."""
    with np.load(path) as data:
        spec = json.loads(bytes(data["__treedef__"]).decode())
        leaves = [data[f"leaf_{i}"] for i in range(_count_leaves(spec))]
    return _rebuild(spec, iter(leaves))


def latest(directory: str | os.PathLike, prefix: str = "ckpt_"):
    """The newest checkpoint path in ``directory`` by name (or None)."""
    d = Path(directory)
    if not d.is_dir():
        return None
    paths = sorted(d.glob(f"{prefix}*.npz"))
    return paths[-1] if paths else None


# -- the JSON spec (dict/list/tuple/leaf/none; "key" read only) ----------------

def _treedef_to_spec(tree, leaves: list):
    """The JSON spec of ``tree``, its leaves appended to ``leaves``."""
    if tree is None:
        return {"t": "none"}
    if isinstance(tree, dict):
        keys = sorted(tree.keys())
        return {"t": "dict", "k": keys,
                "c": [_treedef_to_spec(tree[k], leaves) for k in keys]}
    if isinstance(tree, (list, tuple)):
        if hasattr(tree, "_fields"):  # NamedTuple
            return {"t": "dict", "k": list(tree._fields),
                    "c": [_treedef_to_spec(v, leaves) for v in tree]}
        return {"t": "list" if isinstance(tree, list) else "tuple",
                "c": [_treedef_to_spec(v, leaves) for v in tree]}
    leaves.append(tree)
    return {"t": "leaf"}


def _count_leaves(spec) -> int:
    if spec["t"] in ("leaf", "key"):
        return 1
    if spec["t"] == "none":
        return 0
    return sum(_count_leaves(c) for c in spec["c"])


def _rebuild(spec, leaves):
    if spec["t"] in ("leaf", "key"):
        return next(leaves)
    if spec["t"] == "none":
        return None
    children = [_rebuild(c, leaves) for c in spec["c"]]
    if spec["t"] == "dict":
        return dict(zip(spec["k"], children))
    if spec["t"] == "tuple":
        return tuple(children)
    return children
