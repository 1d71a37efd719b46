// Grayscale: fixed-point BT.601 luma written to R, G and B, alpha kept.
//
// Replaces the TPU kernel `_grayscale_kernel` of
// openmp_parallel_computing_tpu/ops/grayscale.py. Same result, bit for
// bit: l = (19595 r + 38470 g + 7471 b) >> 16 on a planar (1|3|4, H, W)
// u8 frame; a grey frame (C = 1) is read as R = G = B, so its one plane
// is the luma of (p, p, p), which is p.
//
// What bounds it on Hopper: bytes (3 read and 3 written a pixel, 12.4 MB
// for a 1080p frame, ~3.7 us at 3.35 TB/s); the arithmetic is three
// multiply-adds. Design: one thread per pixel, neighbouring threads on
// neighbouring bytes of each plane, so every warp access is one 32-byte
// sector. Each thread reads only the pixel it writes, so a pass may run in
// place (in == out): the wrapper does that for every pass after the
// first, and then skips the alpha copy. Byte loads, not wider vectors: a
// plane of odd size (2037-wide rows) starts planes 1-3 off any 4-byte
// boundary.

#include "luma.cuh"

#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// C = 1 (one plane in and out) or 3 (R, G, B; the alpha plane of an RGBA
// frame copied when copy_alpha).
template <int C>
__global__ void grayscale_kernel(const uint8_t* in, uint8_t* out,
                                 size_t plane, int copy_alpha) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= plane) return;
  if constexpr (C == 1) {
    const int p = in[i];
    out[i] = (uint8_t)luma::luma_fix(p, p, p);
  } else {
    const uint8_t l = (uint8_t)luma::luma_fix(in[i], in[plane + i],
                                              in[2 * plane + i]);
    out[i] = l;
    out[plane + i] = l;
    out[2 * plane + i] = l;
    if (copy_alpha) out[3 * plane + i] = in[3 * plane + i];
  }
}

}  // namespace

extern "C" int grayscale_launch(const void* in, void* out, int C, int H,
                                int W, void* stream) {
  if (H < 1 || W < 1 || (C != 1 && C != 3 && C != 4))
    return (int)cudaErrorInvalidValue;
  const size_t plane = (size_t)H * W;
  const unsigned blocks = (unsigned)((plane + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 1) {
    grayscale_kernel<1><<<blocks, kThreads, 0, s>>>(
        (const uint8_t*)in, (uint8_t*)out, plane, 0);
  } else {
    grayscale_kernel<3><<<blocks, kThreads, 0, s>>>(
        (const uint8_t*)in, (uint8_t*)out, plane, C == 4 && in != out);
  }
  return (int)cudaGetLastError();
}
