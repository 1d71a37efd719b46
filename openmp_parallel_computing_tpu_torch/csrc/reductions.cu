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
// channel_sum, one launch a call: a grid sized to the card (about
// kBlocksPerSM blocks an SM in all), cut into (chunk, channel); each block
// walks its channel's plane grid-stride in 16-byte words (kLoads uint4
// loads a thread and iteration, issued together), with a scalar head up to the
// first 16-byte boundary and a scalar tail: planes 1 and up of an
// odd-sized u8 frame start off any 4-byte boundary. A word's elements are
// summed at once: four bytes by __dp4a, two 16-bit lanes by __dp2a_lo,
// 32-bit integers widened to 64 bits, floats converted and added in
// double. Integers accumulate exactly in 64 bits, floats in double. The
// block reduces with warp shuffles in a fixed order and writes its
// partial to the scratch; after
// __threadfence() it takes a ticket of its channel, and the block that
// takes the last ticket sums the channel's partials in chunk order, rounds
// once to float32 (divided by float32(H*W) for the mean, as the plain
// version divides), and resets the ticket to zero. The grid depends only
// on the card and the shape, and every sum order is fixed, so a float
// input gives the same bits on every run; an integer sum is exact, so its
// result is the correctly rounded float32 of the exact sum.
//
// gray_minmax: a grid-stride loop over pixels; each thread writes the
// gray value to three int32 planes and keeps its min and max; warps
// reduce with __reduce_min_sync/__reduce_max_sync, blocks through shared
// memory, and one thread a block combines into the result pair with
// atomicMin/atomicMax, which are order-independent, so the pair is exact
// and the same on every run. The pair starts as all-ones bytes: the min
// slot is combined as unsigned (UINT_MAX, above any gray value), the max
// slot as signed (-1, below any). A grey frame (C = 1) is read as
// R = G = B, so its gray is its plane. Byte loads and scalar int32
// stores: an int32 plane is 16-byte aligned only when H*W is a multiple
// of 4.

#include <cstddef>
#include <cstdint>

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// channel_sum: blocks an SM in the whole grid, chosen by timing variants
// at 1080p and 6 MP on an H100 (bench/kernel_variants.py, PERF.md §6).
constexpr int kBlocksPerSM = 4;
constexpr int kLoads = 4;          // 16-byte loads in flight a thread
constexpr int kMaxDevices = 64;
// gray_minmax: at most this many blocks, so at most 2 x 1024 atomics.
constexpr size_t kMaxBlocks = 1024;

// channel_sum's input dtypes, with the codes the wrapper passes.
enum Dtype { kU8, kI8, kI16, kU16, kI32, kF16, kBF16, kF32, kU32 };

// Each dtype's element (16-bit floats as their bits) and accumulator.
template <int D> struct Elem;
template <> struct Elem<kU8> { using T = uint8_t; using Acc = long long; };
template <> struct Elem<kI8> { using T = int8_t; using Acc = long long; };
template <> struct Elem<kI16> { using T = int16_t; using Acc = long long; };
template <> struct Elem<kU16> { using T = uint16_t; using Acc = long long; };
template <> struct Elem<kI32> { using T = int32_t; using Acc = long long; };
template <> struct Elem<kF16> { using T = uint16_t; using Acc = double; };
template <> struct Elem<kBF16> { using T = uint16_t; using Acc = double; };
template <> struct Elem<kF32> { using T = float; using Acc = double; };
template <> struct Elem<kU32> { using T = uint32_t; using Acc = long long; };

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float2 f16_pair(unsigned w) {
  __half2 h;
  *reinterpret_cast<unsigned*>(&h) = w;
  return __half22float2(h);
}

// The sum of one 32-bit word of floats (two 16-bit ones or one float),
// in double.
template <int D>
__device__ __forceinline__ double word_sum(unsigned w) {
  if constexpr (D == kF16) {
    const float2 f = f16_pair(w);
    return (double)f.x + (double)f.y;
  } else if constexpr (D == kBF16) {
    return (double)bf16_lo(w) + (double)bf16_hi(w);
  } else {
    return (double)__uint_as_float(w);
  }
}

// The sum of a 16-byte word's elements: the 8- and 16-bit integers in 32
// bits (at most 16 x 255 or 8 x 65535 in magnitude), int32 and uint32 in
// 64 bits, floats in double (in a fixed order).
template <int D>
__device__ __forceinline__ typename Elem<D>::Acc vec_sum(uint4 q) {
  if constexpr (D == kI32) {
    return (long long)(int)q.x + (int)q.y + (long long)(int)q.z + (int)q.w;
  } else if constexpr (D == kU32) {
    return ((long long)q.x + (long long)q.y) + ((long long)q.z + (long long)q.w);
  } else if constexpr (D == kU8) {
    return __dp4a(q.w, 0x01010101u, __dp4a(q.z, 0x01010101u,
                  __dp4a(q.y, 0x01010101u, __dp4a(q.x, 0x01010101u, 0u))));
  } else if constexpr (D == kI8) {
    return __dp4a((int)q.w, 0x01010101, __dp4a((int)q.z, 0x01010101,
                  __dp4a((int)q.y, 0x01010101,
                         __dp4a((int)q.x, 0x01010101, 0))));
  } else if constexpr (D == kI16) {
    return __dp2a_lo((int)q.w, 0x0101, __dp2a_lo((int)q.z, 0x0101,
                     __dp2a_lo((int)q.y, 0x0101,
                               __dp2a_lo((int)q.x, 0x0101, 0))));
  } else if constexpr (D == kU16) {
    return __dp2a_lo(q.w, 0x0101u, __dp2a_lo(q.z, 0x0101u,
                     __dp2a_lo(q.y, 0x0101u, __dp2a_lo(q.x, 0x0101u, 0u))));
  } else {
    return ((word_sum<D>(q.x) + word_sum<D>(q.y)) + word_sum<D>(q.z)) +
           word_sum<D>(q.w);
  }
}

// One element, for the head and the tail.
template <int D>
__device__ __forceinline__ typename Elem<D>::Acc one(typename Elem<D>::T v) {
  if constexpr (D == kF16) {
    return (double)__half2float(__ushort_as_half(v));
  } else if constexpr (D == kBF16) {
    return (double)bf16_lo(v);
  } else {
    return (typename Elem<D>::Acc)v;
  }
}

// The block's sum of v, in a fixed order; valid in thread 0. A block
// that calls it twice passes a __syncthreads() between the calls.
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

__device__ float to_float(long long v) { return __ll2float_rn(v); }
__device__ float to_float(double v) { return __double2float_rn(v); }

// In: (C, plane) elements. Block (chunk, c) of a (chunks, C) grid sums a
// grid-stride share of plane c into slots[c * capacity + chunk]; the last
// block of channel c writes out[c] = float32(sum of the chunks), divided
// by float32(divide_by) when divide_by > 0. slots[c * capacity +
// capacity - 1] is channel c's ticket (its low 4 bytes): zero before the
// launch, and zero again after it.
template <int D>
__global__ void __launch_bounds__(kThreads)
    channel_sum_kernel(const typename Elem<D>::T* __restrict__ img,
                       size_t plane, int capacity, long long divide_by,
                       long long* __restrict__ slots,
                       float* __restrict__ out) {
  using T = typename Elem<D>::T;
  using Acc = typename Elem<D>::Acc;
  constexpr size_t kPer = 16 / sizeof(T);    // elements of a 16-byte word
  const int c = blockIdx.y, chunks = gridDim.x;
  const T* p = img + (size_t)c * plane;
  // Elements before the plane's first 16-byte boundary, whole words, and
  // the tail after them: each at most kPer - 1 scalars.
  const size_t mis = (reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T);
  const size_t head = mis ? (kPer - mis < plane ? kPer - mis : plane) : 0;
  const size_t words = (plane - head) / kPer;
  const size_t tail = head + words * kPer;
  const size_t t = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t stride = (size_t)chunks * kThreads;
  const uint4* w = reinterpret_cast<const uint4*>(p + head);
  Acc acc = 0;
  // kLoads words a thread and iteration, their loads issued together
  // (a word past the end reads as zeros, which add nothing).
  for (size_t i = t; i < words; i += kLoads * stride) {
    uint4 q[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k)
      q[k] = i + k * stride < words ? w[i + k * stride] : make_uint4(0, 0, 0, 0);
    Acc part = 0;
#pragma unroll
    for (int k = 0; k < kLoads; ++k) part += vec_sum<D>(q[k]);
    acc += part;
  }
  if (t < head) acc += one<D>(p[t]);
  if (t < plane - tail) acc += one<D>(p[tail + t]);
  acc = block_sum(acc);

  Acc* part = reinterpret_cast<Acc*>(slots + (size_t)c * capacity);
  unsigned* ticket = reinterpret_cast<unsigned*>(part + capacity - 1);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    part[blockIdx.x] = acc;
    __threadfence();       // the partial is visible before the ticket
    last = atomicAdd(ticket, 1u) == (unsigned)chunks - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  Acc s = 0;
  for (int k = threadIdx.x; k < chunks; k += kThreads) s += __ldcg(part + k);
  s = block_sum(s);
  if (threadIdx.x == 0) {
    const float f = to_float(s);
    out[c] = divide_by > 0 ? __fdiv_rn(f, __ll2float_rn(divide_by)) : f;
    *ticket = 0u;          // ready for the next call on this stream
  }
}

template <int C>
__global__ void gray_minmax_kernel(const uint8_t* __restrict__ in,
                                   int* __restrict__ gray, size_t plane,
                                   int* __restrict__ minmax) {
  int lo = 256, hi = -1;
  const size_t stride = (size_t)gridDim.x * kThreads;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < plane;
       i += stride) {
    const int g = C == 1 ? (int)in[i]
                         : ((int)in[i] + (int)in[plane + i] +
                            (int)in[2 * plane + i]) / 3;
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

// The card's SM count, asked once a device.
int sm_count() {
  static int counts[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  if (!counts[dev] &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 0;
  return counts[dev];
}

template <int D>
cudaError_t launch_sum(const void* img, int C, size_t plane, int capacity,
                       long long divide_by, void* slots, void* out,
                       cudaStream_t stream) {
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  // Blocks a channel: about kBlocksPerSM an SM over all channels, no more
  // than leave each thread a word, and at most capacity - 1 (the last
  // slot of a channel is its ticket).
  const long long words =
      (long long)(plane * sizeof(typename Elem<D>::T) / 16);
  long long chunks = ((long long)sms * kBlocksPerSM + C - 1) / C;
  const long long need = (words + kThreads - 1) / kThreads;
  if (chunks > need) chunks = need;
  if (chunks > capacity - 1) chunks = capacity - 1;
  if (chunks < 1) chunks = 1;
  channel_sum_kernel<D>
      <<<dim3((unsigned)chunks, (unsigned)C), kThreads, 0, stream>>>(
          (const typename Elem<D>::T*)img, plane, capacity, divide_by,
          (long long*)slots, (float*)out);
  return cudaGetLastError();
}

}  // namespace

// img (C, H, W) of dtype (Dtype above) -> out (C,) float32, divided by
// float32(divide_by) when divide_by > 0 (the mean). One launch.
// partials: scratch of C * capacity 8-byte slots: channel c's first
// capacity - 1 take its blocks' partials, its last one is its ticket. The
// tickets must be zero before the first call; each call leaves them zero,
// so the caller zeroes the scratch once and reuses it for every later call
// on the same stream (the stream orders the calls, so no call starts
// before the one before it has reset its tickets).
extern "C" int channel_sum_launch(const void* img, int C, int H, int W,
                                  int dtype, void* partials, int capacity,
                                  long long divide_by, void* out,
                                  void* stream) {
  if (C < 1 || C > 65535 || H < 1 || W < 1 || capacity < 2)
    return (int)cudaErrorInvalidValue;
  const size_t plane = (size_t)H * W;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
#define SUM_CASE(D) \
    case D: \
      return (int)launch_sum<D>(img, C, plane, capacity, divide_by, \
                                partials, out, s);
    SUM_CASE(kU8) SUM_CASE(kI8) SUM_CASE(kI16) SUM_CASE(kU16)
    SUM_CASE(kI32) SUM_CASE(kF16) SUM_CASE(kBF16) SUM_CASE(kF32)
    SUM_CASE(kU32)
#undef SUM_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// in (C, H, W) u8, C in {1, 3, 4} (alpha not read; C = 1 read as
// R = G = B) -> gray (3, H, W) int32, minmax (2,) int32 = (min, max).
extern "C" int gray_minmax_launch(const void* in, int C, int H, int W,
                                  void* gray, void* minmax, void* stream) {
  if ((C != 1 && C != 3 && C != 4) || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(minmax, 0xff, 2 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const size_t plane = (size_t)H * W;
  size_t blocks = (plane + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (C == 1) {
    gray_minmax_kernel<1><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const uint8_t*)in, (int*)gray, plane, (int*)minmax);
  } else {
    gray_minmax_kernel<3><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const uint8_t*)in, (int*)gray, plane, (int*)minmax);
  }
  return (int)cudaGetLastError();
}
