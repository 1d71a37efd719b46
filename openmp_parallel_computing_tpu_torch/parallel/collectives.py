"""Collective helpers over the device mesh (port of
``openmp_parallel_computing_tpu.parallel.collectives``).

The reference's cross-worker aggregation becomes collectives over mesh
axes: OpenMP reduction clauses (``old/parallel_avg_pixel.c:16``,
``old/parallel_to_grayscale.c:12``) become ``psum``/``pmin``/``pmax``; the
stencil's row-neighbour access across a shard boundary becomes a neighbour
shift (the halo exchange).

In the JAX package each device runs the function inside ``shard_map`` and
names the axis. The port's mesh is a single controller, so a collective
takes the per-shard tensors of one group along the axis, in axis order
(each on its shard's device), and returns the per-shard results, each on
its shard's device:

- ``psum``, ``pmean``, ``pmin``, ``pmax`` reduce in shard order (a fixed
  order: the same bits on every run) and put a copy of the result on each
  shard's device;
- ``shift_up``, ``shift_down`` hand each shard its neighbour's tensor,
  zeros at the mesh edge (``ppermute`` with a partial permutation);
- ``halo_exchange_rows`` builds the (top, bottom) halos of row shards.

A copy between cards is a peer copy, on one card a device copy. Over a
data axis that spans processes (``mesh.initialize_multihost``), a
reduction finishes with ``torch.distributed.all_reduce`` (SUM, then a
division for ``pmean``; MIN; MAX). A gloo process group takes no CUDA
tensor on some torch builds, so on gloo a CUDA payload is staged through
the host (decided by the backend, and counted by the recorder). Every
call reports to ``parallel.introspect``'s recorder.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from openmp_parallel_computing_tpu_torch.parallel import introspect
from openmp_parallel_computing_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    to_device,
)


def _axes(axis_name) -> tuple[str, ...]:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def _spans_processes(axes: tuple[str, ...], mesh: Mesh) -> bool:
    return DATA_AXIS in axes and mesh.processes > 1


def _all_reduce(x: torch.Tensor, op) -> torch.Tensor:
    """``dist.all_reduce`` of a copy of ``x``; on gloo a CUDA payload goes
    through the host."""
    staged = x.is_cuda and dist.get_backend() == "gloo"
    buf = x.cpu() if staged else x.clone()
    if staged:
        introspect.record_staged(buf.element_size() * buf.numel())
    dist.all_reduce(buf, op=op)
    return buf.to(x.device)


def _reduce(xs: list[torch.Tensor], axis_name, mesh: Mesh, prim: str,
            combine, op) -> list[torch.Tensor]:
    axes = _axes(axis_name)
    introspect.record(prim, axes, xs[0], len(xs), mesh.size)
    acc = xs[0]
    for x in xs[1:]:
        acc = combine(acc, x.to(acc.device))
    if _spans_processes(axes, mesh):
        acc = _all_reduce(acc, op)
    return [to_device(acc, x.device) for x in xs]


def psum(xs: list[torch.Tensor], axis_name, mesh: Mesh) -> list[torch.Tensor]:
    return _reduce(xs, axis_name, mesh, "psum", torch.add, dist.ReduceOp.SUM)


def pmean(xs: list[torch.Tensor], axis_name, mesh: Mesh) -> list[torch.Tensor]:
    """The sum over the group (``psum``, as JAX lowers ``pmean``) divided
    by the group's shard count across every process."""
    n = len(xs) * (mesh.processes if _spans_processes(_axes(axis_name), mesh)
                   else 1)
    return [s / n for s in psum(xs, axis_name, mesh)]


def pmin(xs: list[torch.Tensor], axis_name, mesh: Mesh) -> list[torch.Tensor]:
    return _reduce(xs, axis_name, mesh, "pmin", torch.minimum,
                   dist.ReduceOp.MIN)


def pmax(xs: list[torch.Tensor], axis_name, mesh: Mesh) -> list[torch.Tensor]:
    return _reduce(xs, axis_name, mesh, "pmax", torch.maximum,
                   dist.ReduceOp.MAX)


def _shift(xs: list[torch.Tensor], axis_name, mesh: Mesh,
           step: int) -> list[torch.Tensor]:
    """Shard i receives shard i - step's tensor; zeros where there is none."""
    axes = _axes(axis_name)
    if _spans_processes(axes, mesh):
        raise NotImplementedError("a shift over the data axis across "
                                  "processes is not ported")
    introspect.record("ppermute", axes, xs[0], len(xs), mesh.size)
    out = []
    for i, x in enumerate(xs):
        j = i - step
        out.append(to_device(xs[j], x.device) if 0 <= j < len(xs)
                   else torch.zeros_like(x))
    return out


def shift_up(xs: list[torch.Tensor], axis_name, mesh: Mesh
             ) -> list[torch.Tensor]:
    """Shard i receives shard i+1's tensor; the last shard receives zeros.
    (Used to fetch the *first* rows of the next shard as a bottom halo.)"""
    return _shift(xs, axis_name, mesh, -1)


def shift_down(xs: list[torch.Tensor], axis_name, mesh: Mesh
               ) -> list[torch.Tensor]:
    """Shard i receives shard i-1's tensor; the first shard receives
    zeros. (Used to fetch the *last* rows of the previous shard as a top
    halo.)"""
    return _shift(xs, axis_name, mesh, 1)


def halo_exchange_rows(xs: list[torch.Tensor], axis_name, mesh: Mesh,
                       halo: int = 1):
    """Exchange ``halo`` boundary rows with mesh neighbours.

    ``xs`` are the row shards ``(..., H_local, W)`` of one group along the
    axis. Returns ``(tops, bottoms)``, each shard's ``halo`` rows from the
    previous shard and from the next (zeros at the mesh edges, matching
    the zero-padded stencil boundary)."""
    tops = shift_down([x[..., -halo:, :] for x in xs], axis_name, mesh)
    bottoms = shift_up([x[..., :halo, :] for x in xs], axis_name, mesh)
    return tops, bottoms


def all_gather_processes(x: torch.Tensor) -> torch.Tensor:
    """This process's ``x`` and every other process's, concatenated along
    dim 0 in rank order (the multi-process data axis; ``x`` itself outside
    a process group). Recorded as ``all_gather`` over the data axis."""
    if not (dist.is_available() and dist.is_initialized()):
        return x
    world = dist.get_world_size()
    staged = x.is_cuda and dist.get_backend() == "gloo"
    src = x.cpu() if staged else x.contiguous()
    introspect.record("all_gather", (DATA_AXIS,), src, 1, 1)
    if staged:
        introspect.record_staged(src.element_size() * src.numel())
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(x.device)
