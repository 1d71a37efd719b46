// The row-streaming body of the port's 3x3 stencils on planar images:
// the weighted convolution of csrc/conv3x3.cu and the fused edge pass of
// csrc/stencil.cu (edge_kernel).
//
// Geometry. A warp owns a band of 32 * V columns of one plane, V values a
// lane (a run of 4, 8 or 16 bytes: one vector load or store a plane row),
// and a strip of S output rows. It walks down the strip with the three
// rows of the 3x3 window in registers. Each new row costs one vector load
// a lane and plane; a lane's left and right neighbours come from the
// neighbouring lanes by shuffles, and only the band's two outer columns
// are separate loads (by lanes 0 and 31). The loads of the next D rows
// are issued before a row is used (a ring of D raw rows in registers),
// with no shared memory and no barrier.
//
// Neighbours outside the plane are 0, the padding of every stencil here:
// a row outside [0, H) is all zeros, a column outside [0, W) reads as 0.
// Any shape runs in the same kernel. A run that is not aligned to its
// size (a width that is not a multiple of V, a plane offset c * H * W
// that is not) or that crosses the end of its row is loaded and stored
// element by element (the scalar head/tail path); lanes of a band past
// the end of a row compute on zeros, store nothing and still take part in
// the shuffles, so every lane of a warp runs the same rows.
//
// A stencil plugs in as a policy K with
//   struct Raw;                         the raw loads of one row
//   struct Row;                         what the window keeps of a row
//   Raw fetch(int y);                   issue row y's loads (0 outside)
//   Row stage(const Raw&);              convert, link the neighbours
//   void emit(up, mid, dn, int y);      output row y (< H) from its window

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace stencil_rows {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpSize = 32;
constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = kWarpSize * kWarpsPerBlock;

// V values of T, 4, 8 or 16 bytes, as 32-bit words.
template <typename T, int V>
struct Run {
  static constexpr int kBytes = V * (int)sizeof(T);
  static_assert(kBytes == 4 || kBytes == 8 || kBytes == 16, "run size");
  uint32_t w[kBytes / 4];
};

// The part of the image one warp covers: band, strip and plane.
struct Strip {
  int lane;  // lane in the warp
  int xb;    // first column of the band
  int x;     // first column of this lane's run
  int y0;    // first output row of the strip
  int z;     // plane
};

// Warps (and blocks of kWarpsPerBlock warps) for a planes x H x W job.
inline long long warps_for(int planes, int H, int W, int V, int S) {
  return (long long)planes * ((H + S - 1) / S) *
         ((W + kWarpSize * V - 1) / (kWarpSize * V));
}

inline long long blocks_for(int planes, int H, int W, int V, int S) {
  return (warps_for(planes, H, W, V, S) + kWarpsPerBlock - 1) /
         kWarpsPerBlock;
}

// This warp's strip; false (for the whole warp) past the last one.
// Neighbouring warps take neighbouring bands of the same rows.
template <int V, int S>
__device__ __forceinline__ bool strip_of(int planes, int H, int W, Strip& s) {
  const int warp = (int)((blockIdx.x * (unsigned)blockDim.x + threadIdx.x) /
                         kWarpSize);
  const int bands = (W + kWarpSize * V - 1) / (kWarpSize * V);
  const int strips = (H + S - 1) / S;
  if (warp >= bands * strips * planes) return false;
  const int rest = warp / bands;
  s.lane = (int)(threadIdx.x % kWarpSize);
  s.xb = (warp - rest * bands) * kWarpSize * V;
  s.x = s.xb + s.lane * V;
  s.y0 = (rest % strips) * S;
  s.z = rest / strips;
  return true;
}

__device__ __forceinline__ uint32_t bits(uint8_t v) { return v; }
__device__ __forceinline__ uint32_t bits(int v) { return (uint32_t)v; }
__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }

// Element i (a constant after unrolling) of a run.
template <typename T, int V>
__device__ __forceinline__ T elem(const Run<T, V>& r, int i) {
  if constexpr (sizeof(T) == 1) {
    return (T)__byte_perm(r.w[i >> 2], 0, 0x4440 | (i & 3));
  } else if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(r.w[i]);
  } else {
    return (T)r.w[i];
  }
}

template <typename T, int V>
__device__ __forceinline__ Run<T, V> zero_run() {
  Run<T, V> r;
#pragma unroll
  for (int i = 0; i < Run<T, V>::kBytes / 4; ++i) r.w[i] = 0;
  return r;
}

// The run of row `row` (a pointer to its column 0) that starts at column
// x, 0 at and past column W: one vector load where the run is whole and
// aligned, else element by element.
template <int V, typename T>
__device__ __forceinline__ Run<T, V> fetch_run(const T* __restrict__ row,
                                               int x, int W) {
  constexpr int kBytes = Run<T, V>::kBytes;
  const T* p = row + x;
  Run<T, V> r;
  if (x + V <= W && (reinterpret_cast<uintptr_t>(p) & (kBytes - 1)) == 0) {
    if constexpr (kBytes == 16) {
      const uint4 q = *reinterpret_cast<const uint4*>(p);
      r.w[0] = q.x, r.w[1] = q.y, r.w[2] = q.z, r.w[3] = q.w;
    } else if constexpr (kBytes == 8) {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      r.w[0] = q.x, r.w[1] = q.y;
    } else {
      r.w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
    return r;
  }
  r = zero_run<T, V>();
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (x + v < W) {
      if constexpr (sizeof(T) == 1) {
        r.w[v >> 2] |= bits(p[v]) << (8 * (v & 3));
      } else {
        r.w[v] = bits(p[v]);
      }
    }
  }
  return r;
}

// The value left of the band (lane 0) or right of it (lane 31), 0 outside
// the row and for the other lanes.
template <int V, typename T>
__device__ __forceinline__ T fetch_edge(const T* __restrict__ row,
                                        const Strip& s, int W) {
  const int xe = s.lane == 0 ? s.xb - 1 : s.xb + kWarpSize * V;
  return ((s.lane == 0 || s.lane == kWarpSize - 1) && xe >= 0 && xe < W)
             ? row[xe]
             : T(0);
}

// Fill r[0] (the column left of this lane's run) and r[V + 1] (the
// column right of it) from the neighbouring lanes, or from `edge` at the
// band's ends. r[1..V] hold the run. Every lane of the warp calls it.
template <int V, typename A>
__device__ __forceinline__ void link(A (&r)[V + 2], A edge, int lane) {
  const A left = __shfl_up_sync(kFullMask, r[V], 1);
  const A right = __shfl_down_sync(kFullMask, r[1], 1);
  r[0] = lane == 0 ? edge : left;
  r[V + 1] = lane == kWarpSize - 1 ? edge : right;
}

// Four values in [0, 255] as the bytes of one word, a first.
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// Store N values at columns [x, x + N) of `row`, none at or past W: whole
// vector stores of up to 16 bytes where the run is whole and aligned,
// else element by element. For u8 the values are ints in [0, 255].
template <typename Out, int N, typename Val>
__device__ __forceinline__ void store_run(Out* __restrict__ row, int x, int W,
                                          const Val (&v)[N]) {
  constexpr int kBytes = N * (int)sizeof(Out);
  constexpr int kChunk = kBytes >= 16 ? 16 : kBytes;  // bytes a store
  Out* p = row + x;
  if constexpr (kBytes % 4 == 0) {
    if (x + N <= W && (reinterpret_cast<uintptr_t>(p) & (kChunk - 1)) == 0) {
      uint32_t w[kBytes / 4];
#pragma unroll
      for (int i = 0; i < kBytes / 4; ++i) {
        if constexpr (sizeof(Out) == 1) {
          w[i] = pack4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
        } else {
          w[i] = bits((Out)v[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kBytes / kChunk; ++i) {
        const uint32_t* c = w + i * kChunk / 4;
        if constexpr (kChunk == 16) {
          reinterpret_cast<uint4*>(p)[i] = make_uint4(c[0], c[1], c[2], c[3]);
        } else if constexpr (kChunk == 8) {
          reinterpret_cast<uint2*>(p)[i] = make_uint2(c[0], c[1]);
        } else {
          reinterpret_cast<uint32_t*>(p)[i] = c[0];
        }
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (x + i < W) p[i] = (Out)v[i];
}

// Walk output rows [y0, y0 + S) with the window (up, mid, dn) = rows
// (y - 1, y, y + 1), the loads D rows ahead of their use. The ring slot of
// a row is a constant in the unrolled inner loop, so the ring stays in
// registers; the code holds D rows, whatever S is. emit runs for rows
// below H only; fetch returns zeros outside [0, H).
template <int S, int D, class K>
__device__ __forceinline__ void walk(const K& k, int y0, int H) {
  static_assert(D >= 2 && S % D == 0, "ring depth");
  typename K::Raw ring[D];
#pragma unroll
  for (int i = 0; i < D; ++i) ring[i] = k.fetch(y0 - 1 + i);
  typename K::Row up = k.stage(ring[0]);
  ring[0] = k.fetch(y0 - 1 + D);
  typename K::Row mid = k.stage(ring[1]);
  ring[1] = k.fetch(y0 + D);
#pragma unroll 1
  for (int i0 = 0; i0 < S; i0 += D) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const int y = y0 + i0 + j;   // output row; the same for the warp
      if (y >= H) return;
      const int slot = (j + 2) % D;
      const typename K::Row dn = k.stage(ring[slot]);
      if (i0 + j + 1 + D <= S) ring[slot] = k.fetch(y + 1 + D);
      k.emit(up, mid, dn, y);
      up = mid;
      mid = dn;
    }
  }
}

}  // namespace stencil_rows
