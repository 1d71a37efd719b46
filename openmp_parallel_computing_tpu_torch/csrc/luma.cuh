// The fixed-point BT.601 luma of the port's frame kernels: grayscale
// (csrc/grayscale.cu) and the luma rows of the Sobel kernels
// (csrc/edge_rows.cuh).

#pragma once

#include <cuda_runtime.h>

namespace luma {

// (19595 r + 38470 g + 7471 b) >> 16: the weights sum to 2^16, so the
// result is an exact integer in [0, 255], and the luma of a grey pixel
// (p, p, p) is p.
__device__ __forceinline__ int luma_fix(int r, int g, int b) {
  return (19595 * r + 38470 * g + 7471 * b) >> 16;
}

}  // namespace luma
