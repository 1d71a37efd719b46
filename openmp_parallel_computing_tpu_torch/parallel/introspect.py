"""Collective-traffic introspection: what crosses the mesh (port of
``openmp_parallel_computing_tpu.parallel.introspect``).

``collective_footprint(fn, *args)`` inventories every collective that
``fn`` issues, with the payload bytes and the mesh axes it spans. The JAX
package finds them by walking the traced jaxpr; the port runs ``fn`` once
while a recorder listens, and ``parallel.collectives`` reports each call
to it. The rows are the JAX package's: ``primitive`` with JAX's names
(``psum``, ``pmax``, ``pmin``, ``ppermute``, ``all_gather``; ``pmean``
records as ``psum``, as its JAX lowering shows), the mesh ``axes``, the
per-shard payload ``shape``, ``dtype`` and ``bytes``, and ``count``, how
many times each shard takes part: calls from one place in the program
(one call stack) fold into one row, as a scan's length folds in JAX, and
the calls of the several groups of an axis (one halo exchange per data
row of a (data, model) mesh) count once a shard. Bytes staged through the
host (a CUDA payload on a gloo process group) are summed apart.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import sys
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective op found in the recorded program."""

    primitive: str          # e.g. "psum", "ppermute"
    axes: tuple[str, ...]   # mesh axis names it communicates over
    shape: tuple[int, ...]  # per-device payload shape
    dtype: str
    bytes: int              # per-device payload bytes
    count: int = 1          # times each device takes part


class Recorder:
    """The collectives of one run: per (call stack, primitive, axes,
    shape, dtype), the shards that took part and the mesh's shard count;
    and the bytes staged through the host."""

    def __init__(self):
        self._rows: dict[tuple, list[int]] = {}
        self.staged_bytes = 0

    def add(self, primitive: str, axes: tuple[str, ...], payload: torch.Tensor,
            shards: int, mesh_size: int, site: tuple) -> None:
        key = (site, primitive, axes, tuple(payload.shape),
               str(payload.dtype).removeprefix("torch."),
               payload.element_size() * payload.numel())
        row = self._rows.setdefault(key, [0, mesh_size])
        row[0] += shards

    def collectives(self) -> list[Collective]:
        return [Collective(primitive=prim, axes=axes, shape=shape,
                           dtype=dtype, bytes=nbytes,
                           count=-(-shards // mesh_size))
                for (_, prim, axes, shape, dtype, nbytes), (shards, mesh_size)
                in self._rows.items()]


_active: contextvars.ContextVar[Recorder | None] = contextvars.ContextVar(
    "collective_recorder", default=None)


def record(primitive: str, axes: tuple[str, ...], payload: torch.Tensor,
           shards: int, mesh_size: int) -> None:
    """Report one collective call to the active recorder (none: a no-op).
    ``payload`` is one shard's tensor, ``shards`` the shards that took
    part and ``mesh_size`` the shards of this process's mesh. The call
    site is the stack of the frames that called the collective."""
    rec = _active.get()
    if rec is None:
        return
    frame, site = sys._getframe(1), []
    while frame is not None:
        site.append((frame.f_code.co_filename, frame.f_lineno))
        frame = frame.f_back
    rec.add(primitive, axes, payload, shards, mesh_size, tuple(site))


def record_staged(nbytes: int) -> None:
    """Bytes a collective staged through the host."""
    rec = _active.get()
    if rec is not None:
        rec.staged_bytes += nbytes


@contextlib.contextmanager
def recording():
    """Record the collectives issued inside the block; yields the
    ``Recorder``."""
    rec = Recorder()
    token = _active.set(rec)
    try:
        yield rec
    finally:
        _active.reset(token)


def collective_footprint(fn: Callable, *args, **kwargs) -> list[Collective]:
    """Run ``fn(*args, **kwargs)`` once and inventory its collectives: one
    :class:`Collective` per (call site, op, operand shape)."""
    with recording() as rec:
        fn(*args, **kwargs)
    return rec.collectives()


def footprint_summary(cols: list[Collective]) -> dict[str, Any]:
    """Aggregate a footprint into per-axis byte totals.

    Returns ``{"per_axis": {axis: bytes}, "ops": [row...], "total_bytes":
    N}`` where bytes are per-device per-call (count folded in)."""
    per_axis: dict[str, int] = {}
    rows = []
    total = 0
    for c in cols:
        b = c.bytes * c.count
        total += b
        for ax in (c.axes or ("<unnamed>",)):
            per_axis[ax] = per_axis.get(ax, 0) + b
        rows.append({"op": c.primitive, "axes": list(c.axes),
                     "shape": list(c.shape), "dtype": c.dtype,
                     "bytes": c.bytes, "count": c.count})
    return {"per_axis": per_axis, "ops": rows, "total_bytes": total}
