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
// What bounds it on Hopper: reading the frame (3 bytes a pixel, ~6.2 MB
// for 1080p, ~1.9 us at 3.35 TB/s) and writing 1/256 of that as floats;
// the arithmetic is a few dozen integer operations a pixel. Design: the
// edge pass's row-streaming body (stencil_rows.cuh) with its loads, luma
// and Sobel (edge_rows.cuh), and an emit that sums instead of storing. A
// warp walks a strip of rows of a band of 32 * V columns (a run of V
// bytes a lane and plane, one vector load), the luma formed once per
// pixel and the neighbours taken by shuffles. Each lane sums its
// magnitudes by block column in registers down the strip; at the end of a
// block row the lanes of one block column fold their sums with
// __shfl_xor_sync (s = 16 at V = 4: four lanes) and one lane writes the
// mean. For s < V a lane holds V / s block columns. Where a block row is
// taller than a warp's strip, the kGroup warps of a thread block that walk
// its rows in turn add their folded sums through shared memory, and the
// first of them writes. No atomics: every output is written once.

#include "edge_rows.cuh"

namespace {

using namespace edge_rows;

// The walk's sizes, chosen by timing variants of the pyramid at 1080p
// (s = 16, the main path) on an H100 (bench/kernel_variants.py, PERF.md
// §6).
constexpr int kPyrRun = 4;         // V: bytes a lane and plane row
constexpr int kPyrStripRows = 4;   // least rows a warp walks
constexpr int kPyrRingRows = 4;    // D: rows loaded ahead (at most a strip)

// The rows a warp walks at scale s: kPyrStripRows, or s / kWarpsPerBlock
// where that is more, so the kWarpsPerBlock warps of a block cover a whole
// block row. Both are powers of two.
constexpr int strip_rows(int s) {
  return s / kWarpsPerBlock > kPyrStripRows ? s / kWarpsPerBlock
                                            : kPyrStripRows;
}

template <int kS, int V>
struct Pyramid : LumaRows<3, V> {
  using Row = typename LumaRows<3, V>::Row;
  static constexpr int S = strip_rows(kS);
  static constexpr int kGroup = kS > S ? kS / S : 1;  // warps of a block row
  static constexpr int kLanes = kS > V ? kS / V : 1;  // lanes a block column
  static constexpr int kCols = kS < V ? V / kS : 1;   // block columns a lane
  static_assert(kGroup <= kWarpsPerBlock && kLanes <= kWarpSize, "geometry");

  float* __restrict__ out;
  int out_w;
  mutable int acc[kCols];

  // Add row y's magnitudes; at the last row of a block row (or of the
  // image), write the block row where one warp walks all of it.
  __device__ __forceinline__ void emit(const Row& up, const Row& mid,
                                       const Row& dn, int y) const {
    const int H = this->H, W = this->W, x = this->s.x;
    if (y > 0 && y < H - 1) {
      int o[V];
      sobel_run(up, mid, dn, o);
      // Columns 0 and W - 1 are border, columns past W are not there.
      if (x == 0 || x + V >= W) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (x + v == 0 || x + v >= W - 1) o[v] = 0;
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        constexpr int n = V / kCols;
#pragma unroll
        for (int v = 0; v < n; ++v) acc[j] += o[j * n + v];
      }
    }
    if constexpr (kGroup == 1) {
      if ((y + 1) % kS == 0 || y == H - 1) {
        fold();
        if (this->s.lane % kLanes == 0) {
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            if (x + j * kS < W)
              out[(size_t)(y / kS) * out_w + x / kS + j] =
                  (float)acc[j] / (float)(kS * kS);
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[j] = 0;
      }
    }
  }

  // The sum of each block column in every lane of it.
  __device__ __forceinline__ void fold() const {
#pragma unroll
    for (int d = 1; d < kLanes; d <<= 1) {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        acc[j] += __shfl_xor_sync(kFullMask, acc[j], d);
    }
  }
};

// One thread block: a band of 32 * V columns and kWarpsPerBlock strips of
// S rows below each other; neighbouring blocks take neighbouring bands.
template <int kS>
__global__ void __launch_bounds__(kThreads)
    edge_pyramid_kernel(const uint8_t* __restrict__ img,
                        float* __restrict__ out, int H, int W, int out_w) {
  using P = Pyramid<kS, kPyrRun>;
  constexpr int V = kPyrRun, S = P::S;
  constexpr int kBandCols = kWarpSize * V / kS;    // block columns of a band
  const int bands = (W + kWarpSize * V - 1) / (kWarpSize * V);
  const int band = (int)(blockIdx.x % (unsigned)bands);
  const int warp = (int)(threadIdx.x / kWarpSize);
  Strip st;
  st.lane = (int)(threadIdx.x % kWarpSize);
  st.xb = band * kWarpSize * V;
  st.x = st.xb + st.lane * V;
  st.y0 = (int)(blockIdx.x / (unsigned)bands) * kWarpsPerBlock * S + warp * S;
  st.z = 0;
  P k{{img, H, W, (size_t)H * W, st}, out, out_w, {}};
  walk<S, (kPyrRingRows < S ? kPyrRingRows : S)>(k, st.y0, H);
  if constexpr (P::kGroup > 1) {
    __shared__ int part[kWarpsPerBlock][kBandCols];
    k.fold();
    if (st.lane % P::kLanes == 0) {
#pragma unroll
      for (int j = 0; j < P::kCols; ++j)
        part[warp][st.lane * V / kS + j] = k.acc[j];
    }
    __syncthreads();
    const int y0 = st.y0;                 // first row of the block row
    if (warp % P::kGroup == 0 && y0 < H) {
      for (int c = st.lane; c < kBandCols; c += kWarpSize) {
        const int bx = band * kBandCols + c;
        int sum = 0;
#pragma unroll
        for (int w = 0; w < P::kGroup; ++w) sum += part[warp + w][c];
        if (bx < out_w)
          out[(size_t)(y0 / kS) * out_w + bx] = (float)sum / (float)(kS * kS);
      }
    }
  }
}

template <int kS>
int launch(const uint8_t* img, float* out, int H, int W, cudaStream_t st) {
  constexpr int rows = kWarpsPerBlock * strip_rows(kS);   // rows a block
  constexpr int band_w = kWarpSize * kPyrRun;
  const long long bands = (W + band_w - 1) / band_w;
  const long long blocks = bands * ((H + rows - 1) / rows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  edge_pyramid_kernel<kS><<<(unsigned)blocks, kThreads, 0, st>>>(
      img, out, H, W, (W + kS - 1) / kS);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int edge_pyramid_launch(const void* img, void* out, int H, int W,
                                   int s, void* stream) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const uint8_t* in = (const uint8_t*)img;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (s) {
    case 1: return launch<1>(in, o, H, W, st);
    case 2: return launch<2>(in, o, H, W, st);
    case 4: return launch<4>(in, o, H, W, st);
    case 8: return launch<8>(in, o, H, W, st);
    case 16: return launch<16>(in, o, H, W, st);
    case 32: return launch<32>(in, o, H, W, st);
    case 64: return launch<64>(in, o, H, W, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
