"""What the image-kernel wrappers share: input checks, the choice between
the kernel and its plain version, and the ping-pong of repeated passes."""

from __future__ import annotations

from typing import Callable

import torch

from openmp_parallel_computing_tpu_torch import _build

# The channel counts of the frame ops (grayscale, the edge pass, the
# perception kernel, the channel-mean grayscale): a grey frame (C = 1,
# read as R = G = B, as the JAX kernels read it), RGB and RGBA. A grey +
# alpha frame (C = 2) is refused: what the JAX kernels give there rests on
# their clamped reads of planes 1 and 2 and is no contract.
FRAME_CHANNELS = (1, 3, 4)


class FrameChannelsError(ValueError):
    """A frame op's refusal of a frame's channel count (a grey + alpha
    frame): deterministic, so the dispatch worker answers it with an error
    completion, as the server answers it with a 400."""


def use_kernel(t: torch.Tensor, what: str) -> bool:
    """``_build.on_card``: True for a CUDA tensor (the kernel ``what``
    runs), False for a CPU tensor (the plain version runs); and for a CUDA
    tensor, raise unless it is contiguous, as the kernels read it."""
    if not _build.on_card(t, what):
        return False
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
    return True


def check_image(img: torch.Tensor, dims: int, channels=None,
                dtypes=(torch.uint8,)) -> None:
    """Raise unless ``img`` has ``dims`` dims (planar (C, H, W) for 3,
    an (H, W) plane for 2), C in ``channels`` when given, a dtype in
    ``dtypes`` and no empty plane."""
    if img.dim() != dims or (channels and img.shape[0] not in channels):
        error = (ValueError if img.dim() != dims else FrameChannelsError)
        raise error(f"expected {dims} dims"
                    + (f", C in {channels}" if channels else "")
                    + f"; got shape {tuple(img.shape)}")
    if img.dtype not in dtypes:
        raise TypeError(f"expected one of {dtypes}, got {img.dtype}")
    if img.shape[-1] < 1 or img.shape[-2] < 1:
        raise ValueError(f"empty image {tuple(img.shape)}")


def check_passes(passes: int) -> None:
    if passes < 1:
        raise ValueError(f"passes must be >= 1, got {passes}")


def ping_pong(x: torch.Tensor, passes: int,
              one: Callable[[torch.Tensor, torch.Tensor], None],
              new: Callable[[], torch.Tensor]) -> torch.Tensor:
    """Run a one-pass kernel ``one(src, dst)`` ``passes`` times, each pass
    reading the previous one's output, between two buffers made by
    ``new``. A stencil pass cannot run in place, and ``x`` is never
    written."""
    bufs = [new(), new() if passes > 1 else None]
    src = x
    for i in range(passes):
        dst = bufs[i % 2]
        one(src, dst)
        src = dst
    return src
