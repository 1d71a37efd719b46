"""Spatially sharded stencils: one image split row-wise across the mesh
(port of ``openmp_parallel_computing_tpu.parallel.spatial``).

The device analogue of the reference's intra-kernel OpenMP parallelism:
where ``collapse(2) schedule(static)`` splits the row loop over threads
sharing one address space (``monolithic/src/sobel.c:10``), the row range
is split over the devices of one mesh axis, each shard runs the image op
on its rows, and the one-row overlap a neighbouring thread would have read
from shared memory comes from a halo exchange
(``parallel.collectives.halo_exchange_rows``).

Each function takes the whole image, splits its rows over the devices of
``mesh``'s ``axis`` (those of the first data row: JAX's other data rows
compute the same rows again), runs the port's op on each shard's device
(on a CUDA shard its kernel launches) on the halo-extended block with
``border="none"``, crops the halos, re-imposes the image border, and
returns the image on the input's device. H must divide by the axis size;
pad upstream (``ops.runner.pad_rows``) and pass the unpadded height as
``orig_h`` so the border lands on the true image border.
"""

from __future__ import annotations

import torch

from openmp_parallel_computing_tpu_torch.ops.conv import gaussian_blur
from openmp_parallel_computing_tpu_torch.ops.grayscale import grayscale
from openmp_parallel_computing_tpu_torch.ops.pipeline import edge_pipeline
from openmp_parallel_computing_tpu_torch.ops.sobel import sobel
from openmp_parallel_computing_tpu_torch.parallel import collectives
from openmp_parallel_computing_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    to_device,
)


def _border_mask_rows(out: torch.Tensor, h: int, w: int, idx: int,
                      h_local: int) -> torch.Tensor:
    """Re-impose the image-border-zero contract on row shard ``idx``.

    ``h`` is the ORIGINAL image height: when the frame was zero-padded to
    a device multiple (``ops.runner.pad_rows``), the true last image row
    is ``h - 1``; masking with the padded height would leave it computed
    against the pad rows instead of zeroed."""
    rows = torch.arange(out.shape[-2], device=out.device) + idx * h_local
    cols = torch.arange(out.shape[-1], device=out.device)
    interior = (((rows >= 1) & (rows < h - 1))[:, None]
                & ((cols >= 1) & (cols < w - 1))[None, :])
    return torch.where(interior, out, torch.zeros_like(out))


def _axis_devices(mesh: Mesh, axis: str) -> list[torch.device]:
    if axis == MODEL_AXIS:
        return list(mesh.devices[0])
    if axis == DATA_AXIS:
        return [row[0] for row in mesh.devices]
    raise ValueError(f"unknown mesh axis {axis!r}")


def split_rows(img: torch.Tensor, devices, axis: str = MODEL_AXIS
               ) -> list[torch.Tensor]:
    """``img``'s rows (dim -2) in equal blocks, one on each of ``devices``
    (the devices of one mesh ``axis``). Raises ``ValueError`` unless H
    divides."""
    h, n = img.shape[-2], len(devices)
    if h % n:
        raise ValueError(f"H={h} not divisible by mesh axis {axis}={n}")
    return [to_device(block, d)
            for block, d in zip(img.split(h // n, dim=-2), devices)]


def _gather_rows(blocks: list[torch.Tensor], device) -> torch.Tensor:
    return torch.cat([b.to(device) for b in blocks], dim=-2)


def _with_halos(blocks, axis, mesh) -> list[torch.Tensor]:
    tops, bottoms = collectives.halo_exchange_rows(blocks, axis, mesh)
    return [torch.cat([t, b, u], dim=-2)
            for t, b, u in zip(tops, blocks, bottoms)]


def sharded_sobel(gray: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS,
                  orig_h: int | None = None) -> torch.Tensor:
    """(H, W) u8 -> (H, W) u8 Sobel with rows sharded over ``mesh[axis]``."""
    h, w = gray.shape
    blocks = split_rows(gray, _axis_devices(mesh, axis), axis)
    h_local, img_h = h // len(blocks), orig_h if orig_h is not None else h
    out = [_border_mask_rows(sobel(ext, border="none")[1:-1], img_h, w, i,
                             h_local)
           for i, ext in enumerate(_with_halos(blocks, axis, mesh))]
    return _gather_rows(out, gray.device)


def sharded_grayscale(img: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS,
                      orig_h: int | None = None) -> torch.Tensor:
    """(C, H, W) u8 grayscale with rows sharded over ``mesh[axis]``.

    Elementwise per pixel: no halo; each shard converts its rows
    (``orig_h`` is accepted for the shared signature: zero pad rows map to
    zero luma, so nothing needs masking)."""
    blocks = split_rows(img, _axis_devices(mesh, axis), axis)
    return _gather_rows([grayscale(b) for b in blocks], img.device)


def sharded_gaussian_blur(img: torch.Tensor, mesh: Mesh,
                          axis: str = MODEL_AXIS,
                          orig_h: int | None = None) -> torch.Tensor:
    """(C, H, W) u8 Gaussian blur (reference GBLUR semantics) with rows
    sharded over ``mesh[axis]``; 1-row halos.

    Each shard blurs its halo-extended block and crops the halo rows: the
    zero halos at the mesh edges reproduce the global zero padding. When
    the frame was zero-padded to H > ``orig_h``, output rows past the true
    image are zeroed again, so repeated passes never feed the pad rows
    back into the last real row."""
    c, h, w = img.shape
    blocks = split_rows(img, _axis_devices(mesh, axis), axis)
    h_local, img_h = h // len(blocks), orig_h if orig_h is not None else h
    out = []
    for i, ext in enumerate(_with_halos(blocks, axis, mesh)):
        o = gaussian_blur(ext)[:, 1:-1]
        if img_h < h:
            rows = torch.arange(h_local, device=o.device) + i * h_local
            o = torch.where((rows < img_h)[:, None], o, torch.zeros_like(o))
        out.append(o)
    return _gather_rows(out, img.device)


def sharded_edge_pipeline(img: torch.Tensor, mesh: Mesh,
                          axis: str = MODEL_AXIS,
                          orig_h: int | None = None) -> torch.Tensor:
    """(C, H, W) u8 -> (C, H, W) u8 fused edge pipeline, rows sharded; for
    C = 4 the alpha plane is the block's own."""
    c, h, w = img.shape
    blocks = split_rows(img, _axis_devices(mesh, axis), axis)
    h_local, img_h = h // len(blocks), orig_h if orig_h is not None else h
    out = []
    for i, (block, ext) in enumerate(zip(blocks,
                                         _with_halos(blocks, axis, mesh))):
        o = edge_pipeline(ext, border="none")[:, 1:-1]
        masked = _border_mask_rows(o[:3], img_h, w, i, h_local)
        if c > 3:
            masked = torch.cat([masked, block[3:]], dim=0)
        out.append(masked)
    return _gather_rows(out, img.device)
