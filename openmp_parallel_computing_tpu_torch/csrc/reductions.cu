// Reductions: the per-channel sum (and mean) of a planar image, and the
// channel-mean grayscale with its global min and max.
//
// Replace the TPU kernels `_channel_sum_kernel` and `_gray_minmax_kernel`
// of openmp_parallel_computing_tpu/ops/reductions.py. On the TPU the grid
// runs in order and carries the partial sum (or the per-lane min/max) in
// an output block that every grid step revisits; XLA then reduces the
// lanes outside the kernel. Here blocks run in no order and nothing
// carries over between them, so the whole reduction, across blocks too,
// is done by these kernels.
//
// What bounds them on Hopper: bytes. channel_sum reads the image once
// (6.2 MB for a 1080p u8 frame, ~1.9 us at 3.35 TB/s); gray_minmax reads
// 3 B and writes 12 B a pixel (31.1 MB at 1080p, ~9.3 us). The arithmetic
// is an add, or three adds and a division by 3, an element.
//
// channel_sum: a grid of (chunk, channel); each block sums a contiguous
// range of one plane, neighbouring threads on neighbouring elements, into
// a per-block partial: u8 per thread in 32 bits (exact below 2^24
// elements a thread: with the wrapper's 512 blocks a channel that is a
// plane of 2.2e12 pixels), int32 in 64 bits, float32 in double; the block then
// reduces in 64 bits (or double) with warp shuffles in a fixed order. A
// second launch, one block per channel, sums the partials in a fixed
// order and rounds once to float32 (divided by H*W in float32 for the
// mean). Integer sums are exact, so the result is the correctly rounded
// float32 of the exact sum; every sum order is fixed, so a float32 input
// gives the same bits on every run too.
//
// gray_minmax: a grid-stride loop over pixels; each thread writes the
// gray value to three int32 planes and keeps its min and max; warps
// reduce with __reduce_min_sync/__reduce_max_sync, blocks through shared
// memory, and one thread a block combines into the result pair with
// atomicMin/atomicMax, which are order-independent, so the pair is exact
// and the same on every run. The pair starts as all-ones bytes: the min
// slot is combined as unsigned (UINT_MAX, above any gray value), the max
// slot as signed (-1, below any).
//
// Byte loads and scalar int32 stores: a plane of odd size starts planes
// 1-2 off any 4-byte boundary, and an int32 plane is 16-byte aligned only
// when H*W is a multiple of 4.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// channel_sum: about 2048 elements a block (at most the wrapper's
// capacity of blocks a channel).
constexpr long long kChunkItems = 2048;
// gray_minmax: at most this many blocks, so at most 2 x 1024 atomics.
constexpr size_t kMaxBlocks = 1024;

enum Dtype { kU8 = 0, kI32 = 1, kF32 = 2 };

// The block's sum of v, in a fixed order; valid in thread 0.
template <typename T>
__device__ T block_sum(T v) {
  __shared__ T warp_sums[kWarps];
  for (int off = 16; off; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? warp_sums[lane] : T(0);
    for (int off = 16; off; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  }
  return v;
}

// In: (C, plane) elements of T. Out: partials[c * chunks + chunk].
template <typename T, typename ThreadAcc, typename BlockAcc>
__global__ void channel_sum_partials(const T* __restrict__ img, size_t plane,
                                     size_t per_block,
                                     BlockAcc* __restrict__ partials) {
  const size_t chunk = blockIdx.x, c = blockIdx.y;
  const size_t begin = chunk * per_block;
  const size_t end = begin + per_block < plane ? begin + per_block : plane;
  const T* p = img + c * plane;
  ThreadAcc acc = 0;
  for (size_t i = begin + threadIdx.x; i < end; i += kThreads)
    acc += (ThreadAcc)p[i];
  const BlockAcc s = block_sum((BlockAcc)acc);
  if (threadIdx.x == 0) partials[c * gridDim.x + chunk] = s;
}

__device__ float to_float(long long v) { return __ll2float_rn(v); }
__device__ float to_float(double v) { return __double2float_rn(v); }

// One block a channel: out[c] = float32(sum of its partials), divided by
// float32(divide_by) when divide_by > 0.
template <typename BlockAcc>
__global__ void channel_sum_finish(const BlockAcc* __restrict__ partials,
                                   int chunks, long long divide_by,
                                   float* __restrict__ out) {
  const size_t c = blockIdx.x;
  BlockAcc acc = 0;
  for (int i = threadIdx.x; i < chunks; i += kThreads)
    acc += partials[c * chunks + i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    const float s = to_float(acc);
    out[c] = divide_by > 0 ? __fdiv_rn(s, __ll2float_rn(divide_by)) : s;
  }
}

__global__ void gray_minmax_kernel(const uint8_t* __restrict__ in,
                                   int* __restrict__ gray, size_t plane,
                                   int* __restrict__ minmax) {
  int lo = 256, hi = -1;
  const size_t stride = (size_t)gridDim.x * kThreads;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < plane;
       i += stride) {
    const int g = ((int)in[i] + (int)in[plane + i] + (int)in[2 * plane + i]) / 3;
    gray[i] = g;
    gray[plane + i] = g;
    gray[2 * plane + i] = g;
    lo = min(lo, g);
    hi = max(hi, g);
  }
  __shared__ int s_lo[kWarps], s_hi[kWarps];
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    lo = __reduce_min_sync(kFull, lane < kWarps ? s_lo[lane] : 256);
    hi = __reduce_max_sync(kFull, lane < kWarps ? s_hi[lane] : -1);
    if (lane == 0) {        // every block holds a pixel: 256 b < H W
      atomicMin(reinterpret_cast<unsigned*>(minmax), (unsigned)lo);
      atomicMax(minmax + 1, hi);
    }
  }
}

template <typename T, typename ThreadAcc, typename BlockAcc>
cudaError_t launch_partials(const void* img, int C, size_t plane, int chunks,
                            void* partials, cudaStream_t stream) {
  const size_t per_block = (plane + chunks - 1) / chunks;
  channel_sum_partials<T, ThreadAcc, BlockAcc>
      <<<dim3((unsigned)chunks, (unsigned)C), kThreads, 0, stream>>>(
          (const T*)img, plane, per_block, (BlockAcc*)partials);
  return cudaGetLastError();
}

}  // namespace

// img (C, H, W) of dtype (0 u8, 1 int32, 2 float32) -> out (C,) float32,
// divided by float32(divide_by) when divide_by > 0 (the mean). Two
// launches: the block partials, then the fixed-order sum a channel.
// partials: scratch for C * capacity 8-byte values (int64 for the
// integer dtypes, double for float32); a channel uses at most capacity
// blocks.
extern "C" int channel_sum_launch(const void* img, int C, int H, int W,
                                  int dtype, void* partials, int capacity,
                                  long long divide_by, void* out,
                                  void* stream) {
  if (C < 1 || C > 65535 || H < 1 || W < 1 || capacity < 1)
    return (int)cudaErrorInvalidValue;
  const size_t plane = (size_t)H * W;
  const long long want = ((long long)plane + kChunkItems - 1) / kChunkItems;
  const int chunks = (int)(want < capacity ? want : capacity);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (dtype) {
    case kU8:
      err = launch_partials<uint8_t, unsigned, long long>(img, C, plane,
                                                          chunks, partials, s);
      break;
    case kI32:
      err = launch_partials<int32_t, long long, long long>(img, C, plane,
                                                           chunks, partials, s);
      break;
    case kF32:
      err = launch_partials<float, double, double>(img, C, plane, chunks,
                                                   partials, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  if (dtype == kF32)
    channel_sum_finish<double><<<C, kThreads, 0, s>>>(
        (const double*)partials, chunks, divide_by, (float*)out);
  else
    channel_sum_finish<long long><<<C, kThreads, 0, s>>>(
        (const long long*)partials, chunks, divide_by, (float*)out);
  return (int)cudaGetLastError();
}

// in (C, H, W) u8, C in {3, 4} (alpha not read) -> gray (3, H, W) int32,
// minmax (2,) int32 = (min, max).
extern "C" int gray_minmax_launch(const void* in, int C, int H, int W,
                                  void* gray, void* minmax, void* stream) {
  if ((C != 3 && C != 4) || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(minmax, 0xff, 2 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const size_t plane = (size_t)H * W;
  size_t blocks = (plane + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  gray_minmax_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      (const uint8_t*)in, (int*)gray, plane, (int*)minmax);
  return (int)cudaGetLastError();
}
