// The 3x3 Sobel stencil on a u8 plane, and the fused edge pipeline that
// forms that plane from an RGB(A) frame: one kernel, edge_kernel<C>.
//
// Replaces two TPU kernels, both built on `stencil_mag` of
// openmp_parallel_computing_tpu/ops/sobel.py:
//   edge_kernel<1>    <- `_sobel_kernel` (ops/sobel.py): (H, W) u8 ->
//                        (H, W) u8 (sobel_launch), and the edge pass of a
//                        grey frame (1, H, W), whose luma is its plane
//   edge_kernel<3|4>  <- `_edge_kernel` (ops/pipeline.py): planar (3|4, H,
//                        W) u8 -> luma -> Sobel -> the magnitude in R, G
//                        and B, alpha copied.
// Same result, bit for bit:
//   mag = min(floor(sqrt(gx^2 + gy^2)), 255), neighbours outside the plane
//   are 0; zero_border != 0 also sets the 1-px image border to 0
//   (border="zero"), else the border is computed like the rest
//   (border="none").
//
// What bounds it on Hopper: bytes. One edge pass on a 1080p RGB frame
// reads 6.2 MB and writes 6.2 MB (~3.7 us at 3.35 TB/s), the Sobel of a
// plane a third of that; the arithmetic is a few dozen integer operations
// a pixel. Design: the row-streaming body of stencil_rows.cuh. A warp
// walks a strip of rows, a lane loading a run of each plane a row; it
// forms the luma once per staged pixel (one plane is its own luma), keeps
// three luma rows in registers, and writes each output plane with one
// vector store a row. Its loads, luma and square root are edge_rows.cuh's,
// which csrc/edge_pyramid.cu shares: the approximate rsqrtf with a margin
// that makes the floor exact (isqrt_255), not the several instructions of
// a correctly rounded sqrt. A pass never runs in place (its neighbours'
// inputs would be overwritten): the wrapper ping-pongs two buffers.

#include "edge_rows.cuh"
#include "stencil_rows.cuh"

namespace {

using namespace edge_rows;
using namespace stencil_rows;

// The walk's sizes, chosen by timing the pass at 1080p and 6 MP on an
// H100 (PERF.md §6): runs of 4, 8 and 16 bytes, strips of 2-16 rows,
// rings of 2-8 rows. Three or four planes (the edge pass) and one plane
// (Sobel) hold different state a lane, so each has its sizes; for one
// plane 8- and 16-byte runs fit (56 and 80 registers) and win at 6 MP,
// but 4-byte runs win at 1080p (bench/kernel_variants.py).
constexpr int kEdgeStripRows = 4;   // S: output rows a warp walks
constexpr int kEdgeRingRows = 4;    // D: rows loaded ahead
constexpr int kEdgeRun = 4;         // V: bytes a lane and plane row
constexpr int kSobelStripRows = 4;  // S of one plane
constexpr int kSobelRingRows = 4;   // D of one plane
constexpr int kSobelRun = 4;        // V of one plane

constexpr int run_of(int C) { return C == 1 ? kSobelRun : kEdgeRun; }
constexpr int strip_rows_of(int C) {
  return C == 1 ? kSobelStripRows : kEdgeStripRows;
}
constexpr int ring_rows_of(int C) {
  return C == 1 ? kSobelRingRows : kEdgeRingRows;
}

// The edge pass of one strip: C planes in (1, 3 or 4), the luma's Sobel
// magnitude out to each of the C planes but alpha, alpha copied.
template <int C>
struct Edge : LumaRows<C, run_of(C)> {
  static constexpr int V = run_of(C);
  static constexpr int S = strip_rows_of(C);
  static constexpr int D = ring_rows_of(C);
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
    if constexpr (C == 1) {
      store_run<uint8_t>(row, x, W, o);
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        store_run<uint8_t>(row + c * this->plane, x, W, o);
    }
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
  using K = Edge<C>;
  Strip s;
  if (!strip_of<K::V, K::S>(1, H, W, s)) return;
  K k{{in, H, W, (size_t)H * W, s}, out, zero_border};
  // The run-time-count walk: with it Sobel took 4.69-4.72 us at 1080p on
  // an H100 against 4.92-4.93 with walk<S, D>, and the edge pass the same.
  walk_rows<K::D>(k, s.y0, K::S, H);
}

template <int C>
int launch_edge(const void* in, void* out, int H, int W, int zero_border,
                cudaStream_t stream) {
  const long long blocks = blocks_for(1, H, W, Edge<C>::V, Edge<C>::S);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  edge_kernel<C><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const uint8_t*)in, (uint8_t*)out, H, W, zero_border);
  return (int)cudaGetLastError();
}

}  // namespace

// (H, W) u8 plane -> (H, W) u8 Sobel magnitude: edge_kernel<1>.
extern "C" int sobel_launch(const void* in, void* out, int H, int W,
                            int zero_border, void* stream) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  return launch_edge<1>(in, out, H, W, zero_border, (cudaStream_t)stream);
}

// (C, H, W) u8, C in {1, 3, 4} -> the edge pass, the same shape.
extern "C" int edge_launch(const void* in, void* out, int C, int H, int W,
                           int zero_border, void* stream) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 1: return launch_edge<1>(in, out, H, W, zero_border, s);
    case 3: return launch_edge<3>(in, out, H, W, zero_border, s);
    case 4: return launch_edge<4>(in, out, H, W, zero_border, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
