// The 3x3 Sobel stencil on a u8 plane, and the fused edge pipeline that
// forms that plane from an RGB(A) frame.
//
// Replaces two TPU kernels, both built on `stencil_mag` of
// openmp_parallel_computing_tpu/ops/sobel.py:
//   sobel_kernel <- `_sobel_kernel` (ops/sobel.py): (H, W) u8 -> (H, W) u8
//   edge_kernel  <- `_edge_kernel` (ops/pipeline.py): planar (3|4, H, W)
//                   u8 -> luma -> Sobel -> the magnitude in R, G and B,
//                   alpha copied.
// Same result, bit for bit:
//   mag = min(floor(sqrt(gx^2 + gy^2)), 255), neighbours outside the plane
//   are 0; zero_border != 0 also sets the 1-px image border to 0
//   (border="zero"), else the border is computed like the rest
//   (border="none").
//
// What bounds them on Hopper: bytes. One edge pass on a 1080p RGB frame
// reads 6.2 MB and writes 6.2 MB (~3.7 us at 3.35 TB/s); the arithmetic
// is a few dozen integer operations a pixel. sobel_kernel stages a halo
// tile in shared memory (stencil3x3.cuh). edge_kernel runs on the
// row-streaming body of stencil_rows.cuh: a warp walks a strip of rows,
// a lane loading 4 bytes of each of R, G and B a row; it forms the luma
// once per staged pixel, keeps three luma rows in registers, and writes
// R, G, B (and A) with 4-byte stores. Its loads, luma and square root are
// edge_rows.cuh's, which csrc/edge_pyramid.cu shares: the approximate
// rsqrtf with a margin that makes the floor exact (isqrt_255), not the
// several instructions of a correctly rounded sqrt. A pass never runs in
// place (its neighbours' inputs would be overwritten): the wrapper
// ping-pongs two buffers.

#include "edge_rows.cuh"
#include "stencil3x3.cuh"
#include "stencil_rows.cuh"

namespace {

using namespace edge_rows;
using namespace stencil3x3;
using namespace stencil_rows;

__device__ __forceinline__ bool on_border(int y, int x, int H, int W) {
  return y == 0 || x == 0 || y == H - 1 || x == W - 1;
}

__global__ void sobel_kernel(const uint8_t* __restrict__ in,
                             uint8_t* __restrict__ out, int H, int W,
                             int zero_border) {
  __shared__ int tile[kHaloH * kHaloW];
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  load_halo_tile(tile, y0, x0, H, W, [in](size_t o) { return (int)in[o]; });
  __syncthreads();

  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  for (int ty = threadIdx.y; ty < kTileH && y0 + ty < H; ty += blockDim.y) {
    const int y = y0 + ty;
    const int m = (zero_border && on_border(y, x, H, W))
                      ? 0
                      : sobel_mag(tile, (ty + 1) * kHaloW + threadIdx.x + 1);
    out[(size_t)y * W + x] = (uint8_t)m;
  }
}

// The walk's sizes, chosen by timing the pass at 1080p and 6 MP on an
// H100 (PERF.md §6): runs of 4, 8 and 16 bytes, strips of 2-16 rows,
// rings of 2-8 rows.
constexpr int kEdgeStripRows = 4;  // S: output rows a warp walks
constexpr int kEdgeRingRows = 4;   // D: rows loaded ahead
constexpr int kEdgeRun = 4;        // V: bytes a lane and plane row

// The fused edge pass of one strip: C planes in (3 or 4), the luma's
// Sobel magnitude out to R, G and B, alpha copied.
template <int C>
struct Edge : LumaRows<C, kEdgeRun> {
  static constexpr int V = kEdgeRun;
  using Row = typename LumaRows<C, V>::Row;

  uint8_t* __restrict__ dst;
  int zero_border;

  __device__ __forceinline__ void emit(const Row& up, const Row& mid,
                                       const Row& dn, int y) const {
    const int H = this->H, W = this->W, x = this->s.x;
    int o[V];
    if (zero_border && (y == 0 || y == H - 1)) {
#pragma unroll
      for (int v = 0; v < V; ++v) o[v] = 0;
    } else {
      sobel_run(up, mid, dn, o);
      // The border columns 0 and W - 1, in the lanes that hold them.
      if (zero_border && (x == 0 || (unsigned)(W - 1 - x) < (unsigned)V)) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (x + v == 0 || x + v == W - 1) o[v] = 0;
      }
    }
    uint8_t* row = dst + (size_t)y * W;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      store_run<uint8_t>(row + c * this->plane, x, W, o);
    if constexpr (C == 4) {
      int a[V];
#pragma unroll
      for (int v = 0; v < V; ++v) a[v] = elem(mid.a, v);
      store_run<uint8_t>(row + 3 * this->plane, x, W, a);
    }
  }
};

template <int C>
__global__ void __launch_bounds__(kThreads)
    edge_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                int H, int W, int zero_border) {
  Strip s;
  if (!strip_of<Edge<C>::V, kEdgeStripRows>(1, H, W, s)) return;
  Edge<C> k{{in, H, W, (size_t)H * W, s}, out, zero_border};
  walk<kEdgeStripRows, kEdgeRingRows>(k, s.y0, H);
}

}  // namespace

extern "C" int sobel_launch(const void* in, void* out, int H, int W,
                            int zero_border, void* stream) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  sobel_kernel<<<grid_for(H, W), block_dims(), 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, H, W, zero_border);
  return (int)cudaGetLastError();
}

extern "C" int edge_launch(const void* in, void* out, int C, int H, int W,
                           int zero_border, void* stream) {
  if (H < 1 || W < 1 || (C != 3 && C != 4)) return (int)cudaErrorInvalidValue;
  const long long blocks =
      blocks_for(1, H, W, kEdgeRun, kEdgeStripRows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 4) {
    edge_kernel<4><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const uint8_t*)in, (uint8_t*)out, H, W, zero_border);
  } else {
    edge_kernel<3><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const uint8_t*)in, (uint8_t*)out, H, W, zero_border);
  }
  return (int)cudaGetLastError();
}
