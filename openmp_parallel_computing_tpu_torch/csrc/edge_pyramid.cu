// Fused perception front-end: planar u8 RGB(A) or grey frame ->
// fixed-point luma -> 3x3 Sobel magnitude -> s x s block means, in one
// pass.
//
// Replaces the TPU kernel `_edge_poolrows_kernel` of
// openmp_parallel_computing_tpu/ops/pipeline.py (called through
// `edge_pyramid_base`). Same result, bit for bit:
//   luma  = (19595 r + 38470 g + 7471 b) >> 16            (int)
//   mag   = min(floor(sqrt(gx^2 + gy^2)), 255), 0 on the 1-px image border
//   out   = (sum of mag over the s x s block) / (s*s)     (f32)
// Blocks are anchored at (0, 0); a partial block at the high edge sums
// only the pixels inside the image (the rest count as zero) and still
// divides by s*s. Block sums are integers below 2^24 (for s <= 256), so
// the order in which they are added cannot change them; the kernels sum
// them as integers, exact at any s, and round once.
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
// first of them writes. No atomics: every output is written once. These
// are compiled instances, one for each s = 1, 2, 4, ..., 64.
//
// Any other s (the JAX package also takes every s >= 8 that its strip
// rule admits, ops/pipeline.py check_pool_scale) runs
// edge_pyramid_s_kernel, with s a run-time argument: a warp walks one
// whole block row of a band of whole block columns, floor(32 V / s) of
// them (for s > 32 V one block column, walked in runs of 32 V columns in
// turn). A lane's run of V < s columns meets at most two block columns, so
// it keeps two sums; at the end the lanes add them into the warp's block
// column sums in shared memory (integer atomics: exact in any order), and
// one lane a block column writes its mean. Every output is written once,
// by one warp.
//
// A grey frame (C = 1) is its own luma (edge_rows.cuh): the instances
// read one plane; C = 3 and 4 read R, G and B.

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

template <int P, int kS, int V>
struct Pyramid : LumaRows<P, V> {
  using Row = typename LumaRows<P, V>::Row;
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
template <int kP, int kS>
__global__ void __launch_bounds__(kThreads)
    edge_pyramid_kernel(const uint8_t* __restrict__ img,
                        float* __restrict__ out, int H, int W, int out_w) {
  using P = Pyramid<kP, kS, kPyrRun>;
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

// Any pool scale s >= 3 (s a run-time argument): the block row of one
// warp, in band runs of 32 V columns; two block-column sums a lane.
template <int P>
struct PyramidAny : LumaRows<P, kPyrRun> {
  static constexpr int V = kPyrRun;
  using Row = typename LumaRows<P, V>::Row;

  int hi;      // columns below hi count: W - 1 (the border) or the band's end
  int split;   // counted columns below split add to acc0, the others to acc1
  mutable int acc0, acc1;

  __device__ __forceinline__ void emit(const Row& up, const Row& mid,
                                       const Row& dn, int y) const {
    if (y == 0 || y == this->H - 1) return;      // the border rows
    int o[V];
    sobel_run(up, mid, dn, o);
    const int x = this->s.x;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int m = x + v >= 1 && x + v < hi ? o[v] : 0;
      const bool first = x + v < split;
      acc0 += first ? m : 0;
      acc1 += first ? 0 : m;
    }
  }
};

// Block columns of a band at scale s (at least one).
__host__ __device__ constexpr int band_blocks(int s) {
  return kWarpSize * kPyrRun / s > 1 ? kWarpSize * kPyrRun / s : 1;
}
constexpr int kMaxBandBlocks = band_blocks(3);

// One warp a (band, block row); `bands` bands of band_blocks(s) block
// columns a block row. Four blocks an SM: without that bound ptxas keeps
// the C = 3 instance at 80 registers and spills 8 bytes.
template <int P>
__global__ void __launch_bounds__(kThreads, 4)
    edge_pyramid_s_kernel(const uint8_t* __restrict__ img,
                          float* __restrict__ out, int H, int W, int s,
                          int out_h, int out_w, int bands) {
  constexpr int V = kPyrRun;
  const int gw = (int)((blockIdx.x * (unsigned)blockDim.x + threadIdx.x) /
                       kWarpSize);
  const int band = gw % bands, by = gw / bands;
  if (by >= out_h) return;                 // the whole warp
  const int warp = (int)(threadIdx.x / kWarpSize);
  const int nb = band_blocks(s), x0 = band * nb * s;
  const int xe = min(W, x0 + nb * s);       // the band's columns: [x0, xe)
  Strip st;
  st.lane = (int)(threadIdx.x % kWarpSize);
  st.y0 = by * s;
  st.z = 0;
  PyramidAny<P> k{{img, H, W, (size_t)H * W, st}, min(W - 1, xe), 0, 0, 0};
  int first = 0;                  // the block column (in the band) of acc0
#pragma unroll 1
  for (int xb = x0; xb < xe; xb += kWarpSize * V) {
    k.s.xb = xb;
    k.s.x = xb + st.lane * V;
    // One block column a band (nb == 1): every counted column is in it.
    first = nb == 1 ? 0 : (k.s.x - x0) / s;
    k.split = nb == 1 ? xe : x0 + (first + 1) * s;
    walk_rows<kPyrRingRows>(k, st.y0, s, H);
  }
  __shared__ int part[kWarpsPerBlock][kMaxBandBlocks];
  for (int b = st.lane; b < nb; b += kWarpSize) part[warp][b] = 0;
  __syncwarp();
  if (first < nb) atomicAdd(&part[warp][first], k.acc0);
  if (first + 1 < nb) atomicAdd(&part[warp][first + 1], k.acc1);
  __syncwarp();
  for (int b = st.lane; b < nb; b += kWarpSize) {
    const int bx = band * nb + b;
    if (bx < out_w)
      out[(size_t)by * out_w + bx] =
          (float)part[warp][b] / __ll2float_rn((long long)s * s);
  }
}

template <int P, int kS>
int launch(const uint8_t* img, float* out, int H, int W, cudaStream_t st) {
  constexpr int rows = kWarpsPerBlock * strip_rows(kS);   // rows a block
  constexpr int band_w = kWarpSize * kPyrRun;
  const long long bands = (W + band_w - 1) / band_w;
  const long long blocks = bands * ((H + rows - 1) / rows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  edge_pyramid_kernel<P, kS><<<(unsigned)blocks, kThreads, 0, st>>>(
      img, out, H, W, (W + kS - 1) / kS);
  return (int)cudaGetLastError();
}

template <int P>
int launch_any(const uint8_t* img, float* out, int H, int W, int s,
               cudaStream_t st) {
  const int out_h = (H + s - 1) / s, out_w = (W + s - 1) / s;
  const long long band_w = (long long)band_blocks(s) * s;
  const long long bands = (W + band_w - 1) / band_w;
  const long long blocks =
      (bands * out_h + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (bands * out_h > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  edge_pyramid_s_kernel<P><<<(unsigned)blocks, kThreads, 0, st>>>(
      img, out, H, W, s, out_h, out_w, (int)bands);
  return (int)cudaGetLastError();
}

template <int P>
int launch_scale(const uint8_t* img, float* out, int H, int W, int s,
                 cudaStream_t st) {
  switch (s) {
    case 1: return launch<P, 1>(img, out, H, W, st);
    case 2: return launch<P, 2>(img, out, H, W, st);
    case 4: return launch<P, 4>(img, out, H, W, st);
    case 8: return launch<P, 8>(img, out, H, W, st);
    case 16: return launch<P, 16>(img, out, H, W, st);
    case 32: return launch<P, 32>(img, out, H, W, st);
    case 64: return launch<P, 64>(img, out, H, W, st);
    default:
      if (s < 3) return (int)cudaErrorInvalidValue;
      return launch_any<P>(img, out, H, W, s, st);
  }
}

}  // namespace

// img (C, H, W) u8, C in {1, 3, 4} (alpha not read) -> out (ceil(H/s),
// ceil(W/s)) float32, s >= 1.
extern "C" int edge_pyramid_launch(const void* img, void* out, int C, int H,
                                   int W, int s, void* stream) {
  if (H < 1 || W < 1 || s < 1) return (int)cudaErrorInvalidValue;
  const uint8_t* in = (const uint8_t*)img;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 1: return launch_scale<1>(in, o, H, W, s, st);
    case 3:
    case 4: return launch_scale<3>(in, o, H, W, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
