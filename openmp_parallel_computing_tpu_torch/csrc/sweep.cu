// One iLQR sweep: the per-sweep path of the sweep backend
// (edge_refresh="ilqr", where the edge term is linearized again before
// every sweep, so the sweeps of an ADMM iteration cannot share one launch
// as in csrc/multi_sweep.cu); and the nominal rollout (rollout_launch, at
// the end of this file).
//
// Replaces three TPU kernels of
// openmp_parallel_computing_tpu/models/mpc/sweep_pallas.py:
//   unified_sweep_launch  <- `_unified_sweep_kernel` (via `unified_sweep`):
//       the Riccati backward over tau = H-1 .. 0, then the line-searched
//       forward of the candidates alpha = (0, 1, 0.5, 0.25), in one launch;
//   backward_sweep_launch <- `_backward_sweep_kernel` (via `backward_sweep`):
//       the backward alone, the gains K, k as outputs;
//   forward_sweep_launch  <- `_forward_sweep_kernel` (via `forward_sweep`):
//       the forward alone, the gains as inputs (with zero gains candidate 0
//       is the rollout of the controls: the nominal rollout of a CPU batch
//       above ROLLOUT_SCAN_MAX_BP scenarios).
// The forward writes every candidate's states ps_c (H+1, A, n, B), row 0 =
// p0 for every candidate, its controls us_c (H, A, c, B) and its cost
// J (A, B) with the terminal terms, non-finite costs as they come; the
// first-wins pick stays outside, as in the JAX solver.
//
// All three run the thread-group body of csrc/sweep_group.cuh, the
// recursion multi_sweep.cu and full_solve.cu run: a group of n = 2m threads
// a scenario, one-warp blocks (two scenarios at m = 8), every operand in
// registers or a few hundred bytes of shared scratch, no spills. The
// backward writes the gains straight to its (H, c, n, B) and (H, c, B)
// outputs; lane k stores column k of K. The unified kernel keeps them in
// the scenario's shared memory where a block's
// `unified_sweep_smem_bytes(m, H)` fits the card (the wrapper decides, by
// `sweep.group_sweep_fits`), and otherwise in global scratch the wrapper
// allocates (any horizon: H = 400 at m = 8 needs 335,232 B a block in
// shared memory, above the H100's opt-in 232,448 B). Its forward reads them
// back after the backward's last __syncwarp, which orders the group's
// global stores before its loads. With the gains in global memory a
// scenario's shared memory is ~1.2 KB, so registers, not shared memory,
// set how many groups an SM holds. The forward kernel is the unified
// kernel's forward on read-only gains (GlobalGains<M, const float>): the
// group splits into the four candidates' runs of m / 2 lanes, each run
// writing its candidate's trajectory, controls and cost; it needs no
// shared memory.
//
// What bounds them on Hopper, at B = 4096, H = 20, m = 8: the work is
// ~1 GFLOP of FP32 for the unified sweep (~15 us at 67 TFLOP/s); its inputs
// and outputs are ~2,900 floats a scenario (~47 MB, ~14 us at 3.35 TB/s).
// The recursion is serial along the horizon, so a scenario's sweep is a
// chain of dependent steps (shuffles, shared-memory broadcasts, the 6 x 6
// Cholesky): latency, as in multi_sweep.cu. The sums of Quu, Qu,
// K (p - p_nom) and the costs are taken in a butterfly order, and nvcc
// contracts a*b+c into FMA, so the kernels are held to their plain versions
// within a tolerance.

#include "sweep_group.cuh"

namespace {

using sweep_group::Arrays;
using sweep_group::Geom;
using sweep_group::GlobalGains;
using sweep_group::Layout;
using sweep_group::Place;

// The group sweep's arrays: the nominal (ps, us) is only read.
Arrays group_arrays(const void* p0, const void* ps, const void* us,
                    const void* z, const void* y, const void* g,
                    const void* target, const void* inv_depth, int H, int B,
                    sweep::Weights W) {
  return Arrays{(const float*)p0, (const float*)g, (const float*)target,
                (const float*)inv_depth, (const float*)z, (const float*)y,
                (float*)ps, (float*)us, H, (size_t)B, W};
}

// The unified sweep: the backward into the gains, in the scenario's shared
// memory (kSmem) or in the global scratch K (H, c, n, B), k (H, c, B); then
// every candidate's forward with its outputs written.
template <int M, bool kSmem>
__global__ void __launch_bounds__(32)
unified_sweep_kernel(Arrays X, float* K, float* k) {
  extern __shared__ float4 smem4[];
  const Layout Lo = sweep_group::layout(M, kSmem ? X.H : 0, false);
  const Place me = sweep_group::place<M>(reinterpret_cast<float*>(smem4),
                                         Lo, (int)X.B);
  const GlobalGains<M> Kg{K + me.b, k + me.b, X.B, me.live};
  const GlobalGains<M>* gains = kSmem ? nullptr : &Kg;
  sweep_group::backward<M>(X, me, Lo, gains);
  sweep_group::forward<M>(X, me, Lo, sweep::alpha_of(me.g / Geom<M>::L),
                          false, false, gains);
}

template <int M>
__global__ void __launch_bounds__(32)
backward_sweep_kernel(Arrays X, float* K, float* k) {
  extern __shared__ float4 smem4[];
  const Layout Lo = sweep_group::layout(M, 0, false);
  const Place me = sweep_group::place<M>(reinterpret_cast<float*>(smem4),
                                         Lo, (int)X.B);
  const GlobalGains<M> Kg{K + me.b, k + me.b, X.B, me.live};
  sweep_group::backward<M>(X, me, Lo, &Kg);
}

// One-warp blocks of Geom<M>::S scenarios with `smem_h` steps of gains in
// shared memory (0: the step's scratch alone).
template <int M, class Kernel>
int launch_group(Kernel kernel, int smem_h, const Arrays& X, float* K,
                 float* k, cudaStream_t stream) {
  const Layout Lo = sweep_group::layout(M, smem_h, false);
  const size_t bytes = sizeof(float) * Geom<M>::S * Lo.stride;
  int err = sweep_group::allow_smem(kernel, bytes);
  if (err) return err;
  const dim3 grid((unsigned)((X.B + Geom<M>::S - 1) / Geom<M>::S));
  kernel<<<grid, 32, bytes, stream>>>(X, K, k);
  return (int)cudaGetLastError();
}

template <int M>
int launch_unified(const Arrays& X, float* K, float* k, cudaStream_t s) {
  if (K == nullptr)
    return launch_group<M>(unified_sweep_kernel<M, true>, X.H, X, K, k, s);
  return launch_group<M>(unified_sweep_kernel<M, false>, 0, X, K, k, s);
}

template <int M>
int launch_backward(const Arrays& X, float* K, float* k, cudaStream_t s) {
  return launch_group<M>(backward_sweep_kernel<M>, 0, X, K, k, s);
}

// The forward alone, on the gains (H, c, n, B) and (H, c, B) the caller
// gives; every candidate's outputs written.
template <int M>
__global__ void __launch_bounds__(32)
forward_sweep_kernel(Arrays X, const float* K, const float* k) {
  extern __shared__ float4 smem4[];            // none: the gains are global
  const Layout Lo = sweep_group::layout(M, 0, false);
  const Place me = sweep_group::place<M>(reinterpret_cast<float*>(smem4),
                                         Lo, (int)X.B);
  const GlobalGains<M, const float> Kg{K + me.b, k + me.b, X.B, me.live};
  sweep_group::forward<M>(X, me, Lo, sweep::alpha_of(me.g / Geom<M>::L),
                          false, false, &Kg);
}

template <int M>
int launch_forward(const Arrays& X, const float* K, const float* k,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)((X.B + Geom<M>::S - 1) / Geom<M>::S));
  forward_sweep_kernel<M><<<grid, 32, 0, stream>>>(X, K, k);
  return (int)cudaGetLastError();
}

}  // namespace

// Arrays (float32, scenario last): p0, target (n, B); inv_depth (m, B);
// ps, g (H+1, n, B); us, z, y, k (H, c, B); K (H, c, n, B); ps_c
// (H+1, A, n, B); us_c (H, A, c, B); J (A, B).

// Dynamic shared memory of one block of the unified kernel with its gains
// in shared memory (bytes), for the wrapper's choice of form
// (sweep.group_sweep_fits).
extern "C" int unified_sweep_smem_bytes(int m, int H) {
  return (int)(sizeof(float) * (32 / (2 * m)) *
               sweep_group::layout(m, H, false).stride);
}

// K_scratch and k_scratch null: the gains in shared memory; else in them.
extern "C" int unified_sweep_launch(
    int m, const void* p0, const void* ps, const void* us, const void* z,
    const void* y, const void* g, const void* target, const void* inv_depth,
    void* ps_c, void* us_c, void* J, void* K_scratch, void* k_scratch, int H,
    int B, float q, float r, float rho, float qe, float dt, float reg,
    void* stream) {
  if (H < 1 || B < 1 || (K_scratch == nullptr) != (k_scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  Arrays X = group_arrays(p0, ps, us, z, y, g, target, inv_depth, H, B,
                          {q, r, rho, qe, dt, reg});
  X.ps_c = (float*)ps_c;
  X.us_c = (float*)us_c;
  X.J = (float*)J;
  float *K = (float*)K_scratch, *k = (float*)k_scratch;
  cudaStream_t s = (cudaStream_t)stream;
  switch (m) {
    case 2: return launch_unified<2>(X, K, k, s);
    case 4: return launch_unified<4>(X, K, k, s);
    case 8: return launch_unified<8>(X, K, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int backward_sweep_launch(
    int m, const void* ps, const void* us, const void* z, const void* y,
    const void* g, const void* target, const void* inv_depth, void* K,
    void* k, int H, int B, float q, float r, float rho, float qe, float dt,
    float reg, void* stream) {
  if (H < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const Arrays X = group_arrays(nullptr, ps, us, z, y, g, target, inv_depth,
                                H, B, {q, r, rho, qe, dt, reg});
  cudaStream_t s = (cudaStream_t)stream;
  switch (m) {
    case 2: return launch_backward<2>(X, (float*)K, (float*)k, s);
    case 4: return launch_backward<4>(X, (float*)K, (float*)k, s);
    case 8: return launch_backward<8>(X, (float*)K, (float*)k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int forward_sweep_launch(
    int m, const void* p0, const void* ps, const void* us, const void* K,
    const void* k, const void* z, const void* y, const void* g,
    const void* target, const void* inv_depth, void* ps_c, void* us_c,
    void* J, int H, int B, float q, float r, float rho, float qe, float dt,
    void* stream) {
  if (H < 1 || B < 1) return (int)cudaErrorInvalidValue;
  Arrays X = group_arrays(p0, ps, us, z, y, g, target, inv_depth, H, B,
                          {q, r, rho, qe, dt, 0.0f});
  X.ps_c = (float*)ps_c;
  X.us_c = (float*)us_c;
  X.J = (float*)J;
  const float *Kf = (const float*)K, *kf = (const float*)k;
  cudaStream_t s = (cudaStream_t)stream;
  switch (m) {
    case 2: return launch_forward<2>(X, Kf, kf, s);
    case 4: return launch_forward<4>(X, Kf, kf, s);
    case 8: return launch_forward<8>(X, Kf, kf, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The nominal rollout: ps[0] = p0, ps[t+1] = clip(ps[t] + dt L(ps[t]) us[t])
// for t < H, each feature's step by sweep::dyn_feature, so the dynamics
// keep one source and the rows are those of candidate 0 of a zero-gain
// forward sweep, bit for bit. Replaces no TPU kernel: the JAX package's
// rollout is an XLA scan of `_dyn_step`, which the port ran as a host loop
// of ~35 elementwise launches a step (~1,400 a solve at H = 20).
//
// Arrays (float32, scenario last): p0 (n, B), us (H, 6, B), inv_depth
// (m, B), ps (H+1, n, B), n = 2m, m any positive count (a run-time
// argument: no instance to refuse a feature count).
//
// What bounds it on Hopper: bytes. p0, iz and us read once and ps written
// once are (n + m + 6H + n(H+1)) B floats: 7.9 MB at m = 8, H = 20,
// B = 4096 (2.35 us at 3.35 TB/s), 18.7 MB at H = 50 (5.6 us), 31.5 MB at
// B = 16384 (9.4 us); at B = 256 the launch itself. A feature's step reads
// only its own (x, y), its own iz and the scenario's six controls, so the
// design is one thread a (feature j, scenario b), b the fast index of a
// warp, j a row of blocks of the one-dimensional grid: m B threads (32,768
// at B = 4096) with no exchange between them, every load and the two
// stores a step coalesced along b; the m threads of a scenario read its
// controls through L1. The control loads do not depend on the state chain,
// so the thread loads the next kRolloutStage steps' controls into
// registers before it runs the current ones: the H-step chain waits on
// arithmetic, not on memory.

namespace {

constexpr int kRolloutThreads = 128;
constexpr int kRolloutStage = 4;

// Controls of steps t0 .. t0 + kRolloutStage - 1 of scenario b (0 past H).
__device__ __forceinline__ void load_controls(const float* __restrict__ us,
                                              int t0, int H, size_t B,
                                              int b,
                                              float (&u)[kRolloutStage]
                                                        [sweep::C]) {
#pragma unroll
  for (int s = 0; s < kRolloutStage; ++s)
#pragma unroll
    for (int c = 0; c < sweep::C; ++c)
      u[s][c] = t0 + s < H
                    ? __ldg(us + ((size_t)(t0 + s) * sweep::C + c) * B + b)
                    : 0.0f;
}

__global__ void __launch_bounds__(kRolloutThreads)
rollout_kernel(const float* __restrict__ p0, const float* __restrict__ us,
               const float* __restrict__ iz, float* __restrict__ ps, int m,
               int H, int B, float dt) {
  const unsigned row_blocks = (B + kRolloutThreads - 1) / kRolloutThreads;
  const int b = blockIdx.x % row_blocks * kRolloutThreads + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = B, n = 2 * (size_t)m, j = blockIdx.x / row_blocks;
  const size_t rx = j * Bs + b, ry = (m + j) * Bs + b;   // row offsets
  float x = __ldg(p0 + rx), y = __ldg(p0 + ry);
  const float izj = __ldg(iz + rx);
  ps[rx] = x;
  ps[ry] = y;
  float u[kRolloutStage][sweep::C], next[kRolloutStage][sweep::C];
  load_controls(us, 0, H, Bs, b, u);
  for (int t0 = 0; t0 < H; t0 += kRolloutStage) {
    load_controls(us, t0 + kRolloutStage, H, Bs, b, next);
#pragma unroll
    for (int s = 0; s < kRolloutStage; ++s) {
      const int t = t0 + s;
      if (t < H) {
        sweep::dyn_feature(x, y, u[s], izj, dt, x, y);
        float* row = ps + (size_t)(t + 1) * n * Bs;
        row[rx] = x;
        row[ry] = y;
      }
    }
#pragma unroll
    for (int s = 0; s < kRolloutStage; ++s)
#pragma unroll
      for (int c = 0; c < sweep::C; ++c) u[s][c] = next[s][c];
  }
}

}  // namespace

extern "C" int rollout_launch(int m, const void* p0, const void* us,
                              const void* inv_depth, void* ps, int H, int B,
                              float dt, void* stream) {
  if (m < 0 || H < 0 || B < 0) return (int)cudaErrorInvalidValue;
  if (m == 0 || B == 0) return 0;                  // nothing to write
  const long long blocks =
      (long long)m * ((B + kRolloutThreads - 1) / kRolloutThreads);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  rollout_kernel<<<grid, kRolloutThreads, 0, (cudaStream_t)stream>>>(
      (const float*)p0, (const float*)us, (const float*)inv_depth, (float*)ps,
      m, H, B, dt);
  return (int)cudaGetLastError();
}
