// Fused perception front-end: planar u8 RGB(A) frame -> fixed-point luma
// -> 3x3 Sobel magnitude -> s x s block means, in one pass.
//
// Replaces the TPU kernel `_edge_poolrows_kernel` of
// openmp_parallel_computing_tpu/ops/pipeline.py (called through
// `edge_pyramid_base`). Same result, bit for bit:
//   luma  = (19595 r + 38470 g + 7471 b) >> 16            (int)
//   mag   = min(floor(sqrt(gx^2 + gy^2)), 255), 0 on the 1-px image border
//   out   = (sum of mag over the s x s block) / (s*s)     (f32)
// Blocks are anchored at (0, 0); a partial block at the high edge sums
// only the pixels inside the image (the rest count as zero) and still
// divides by s*s. Block sums are integers below 2^24, so the order in
// which they are added cannot change them.
//
// What bounds it on Hopper: reading the frame (3 bytes a pixel, ~6 MB
// for 1080p) and writing 1/256 of that as floats; the arithmetic is a
// few dozen integer operations a pixel. Design: one CUDA block per
// (s-row band x 128-column tile). The block stages the luma of its band
// plus a one-row/one-column halo in shared memory (each input byte is
// read by ~1.1 blocks), every thread then walks one column of the band,
// sums its magnitudes in a register, and one shared-memory atomic per
// thread folds the column sums into the tile's 128/s block sums.
// sqrt is __fsqrt_rn, the IEEE correctly rounded square root: gx^2+gy^2
// <= 2,080,800 is exact in f32, so its floor is the integer square root
// whatever the compiler flags (an approximate sqrt can return k - eps for
// a perfect square k^2 and floor one below).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 128;
constexpr int kThreads = 256;

__global__ void edge_pyramid_kernel(const uint8_t* __restrict__ img,
                                    float* __restrict__ out,
                                    int H, int W, int s, int out_w) {
  extern __shared__ int smem[];
  const int halo_w = kTileW + 2;
  int* lum = smem;                                   // (s + 2) x (kTileW + 2)
  int* bsum = smem + (s + 2) * halo_w;               // kTileW / s
  const int band = blockIdx.y;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = band * s;
  const size_t plane = (size_t)H * W;
  const int tid = threadIdx.x;

  if (tid < kTileW / s) bsum[tid] = 0;
  for (int idx = tid; idx < (s + 2) * halo_w; idx += blockDim.x) {
    const int ry = idx / halo_w;
    const int rx = idx - ry * halo_w;
    const int gy = y0 - 1 + ry;
    const int gx = x0 - 1 + rx;
    int v = 0;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const size_t o = (size_t)gy * W + gx;
      v = (19595 * (int)img[o] + 38470 * (int)img[plane + o] +
           7471 * (int)img[2 * plane + o]) >> 16;
    }
    lum[idx] = v;
  }
  __syncthreads();

  // kThreads is a multiple of kTileW: each thread owns one column.
  const int col = tid % kTileW;
  const int gx = x0 + col;
  int acc = 0;
  if (gx >= 1 && gx < W - 1) {
    for (int row = tid / kTileW; row < s; row += kThreads / kTileW) {
      const int gy = y0 + row;
      if (gy < 1 || gy >= H - 1) continue;
      const int* up = lum + row * halo_w + col;      // halo row above
      const int* mid = up + halo_w;
      const int* dn = mid + halo_w;
      const int gxv = -up[0] - 2 * mid[0] - dn[0] + up[2] + 2 * mid[2] + dn[2];
      const int gyv = up[0] + 2 * up[1] + up[2] - dn[0] - 2 * dn[1] - dn[2];
      const float m = floorf(__fsqrt_rn((float)(gxv * gxv + gyv * gyv)));
      acc += min((int)m, 255);
    }
  }
  if (acc) atomicAdd(&bsum[col / s], acc);
  __syncthreads();

  const int ox = blockIdx.x * (kTileW / s) + tid;
  if (tid < kTileW / s && ox < out_w)
    out[(size_t)band * out_w + ox] = (float)bsum[tid] / (float)(s * s);
}

}  // namespace

extern "C" int edge_pyramid_launch(const void* img, void* out, int H, int W,
                                   int s, void* stream) {
  if (s < 1 || s > 64 || kTileW % s != 0) return (int)cudaErrorInvalidValue;
  const int out_h = (H + s - 1) / s;
  const int out_w = (W + s - 1) / s;
  dim3 grid((W + kTileW - 1) / kTileW, out_h);
  const size_t shmem = ((size_t)(s + 2) * (kTileW + 2) + kTileW / s) * sizeof(int);
  edge_pyramid_kernel<<<grid, kThreads, shmem, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (float*)out, H, W, s, out_w);
  return (int)cudaGetLastError();
}
