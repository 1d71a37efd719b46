// The whole ADMM solve in one launch, a thread group per scenario.
//
// Replaces the TPU kernel `_full_solve_kernel` of
// openmp_parallel_computing_tpu/models/mpc/sweep_pallas.py (called through
// `full_solve`), for the edge schedule that linearizes the edge term once a
// solve (g fixed for the whole solve). Per scenario:
//   1. z = clip(us0, +-u_limit), y = 0; the nominal is the streamed input
//      (ps, the rollout of us0 done outside, and us0).
//   2. For each of `admm_iters` iterations: `sweeps` iLQR sweeps with a
//      winner select (`sweep_group::ilqr_sweep` of csrc/sweep_group.cuh, the
//      body multi_sweep.cu runs: one source of the recursion), each about
//      the current nominal, its terminal expansion at the nominal's row H;
//      then u^ = relax us + (1 - relax) z (u^ = us when relax is 1),
//      z = clip(u^ + y), y = y + u^ - z over the whole horizon.
//   3. The feasible rollout of z from p0 (the clipped Euler step).
// Outputs: ps_out (H+1, n, B), the rollout of z with row 0 = p0; z_out
// (H, c, B); us_out (H, c, B), the last unprojected controls.
//
// Layout and memory as multi_sweep.cu: the scenario index b is the fastest
// axis of every array; the nominal lives in ps_out / us_out during the
// solve (ps_out is overwritten by the final rollout), z in z_out; y and the
// gains K (H, c, n), k (H, c) in the scenario's shared memory. No global
// scratch.
//
// What bounds it on Hopper: as multi_sweep, the latency of the serial
// recursion, now admm_iters x sweeps sweeps long, on a group of n threads a
// scenario; shared memory (~10 KB a scenario at m = 8, H = 20) sets how many
// groups an SM holds. The ADMM update and the final rollout are spread over
// the group's lanes. The update rounds each product and sum on its own
// (`__fmul_rn`, `__fadd_rn`), as the eager update between multi_sweep
// launches does, so the two agree bit for bit: the sweeps are the same
// code.

#include "sweep_group.cuh"

namespace {

using sweep::C;
using sweep_group::at;
using sweep_group::Geom;
using sweep_group::Layout;

struct Params {
  int H, B, sweeps, admm_iters, over_relax;
  float u_limit, relax, one_minus_relax;
  sweep::Weights W;
};

// clamp(x, -lim, lim) keeping a NaN, as torch.clamp does.
__device__ __forceinline__ float clip(float x, float lim) {
  return x != x ? x : fminf(fmaxf(x, -lim), lim);
}

template <int M>
__global__ void __launch_bounds__(32)
full_solve_kernel(const float* __restrict__ p0, const float* __restrict__ ps,
                  const float* __restrict__ us, const float* __restrict__ g,
                  const float* __restrict__ tgt, const float* __restrict__ iz,
                  float* ps_out, float* z_out, float* us_out, Params P) {
  constexpr int N = 2 * M, G = Geom<M>::G, L = Geom<M>::L;
  extern __shared__ float4 smem4[];
  const Layout Lo = sweep_group::layout(M, P.H, true);
  const sweep_group::Place me = sweep_group::place<M>(
      reinterpret_cast<float*>(smem4), Lo, P.B);
  const size_t B = (size_t)P.B;
  const int H = P.H, b = me.b;
  float* ys = me.sm + Lo.y;

  for (int e = me.g; e < H * C; e += G) {
    ys[e] = 0.0f;
    if (me.live) {
      us_out[e * B + b] = us[e * B + b];
      z_out[e * B + b] = clip(us[e * B + b], P.u_limit);
    }
  }
  if (me.live)
    for (int e = me.g; e < (H + 1) * N; e += G)
      ps_out[e * B + b] = ps[e * B + b];
  __syncwarp();

  const sweep_group::Arrays X{p0, g, tgt, iz, z_out, nullptr, ps_out, us_out,
                              H, B, P.W};
  for (int it = 0; it < P.admm_iters; ++it) {
    for (int sw = 0; sw < P.sweeps; ++sw)
      sweep_group::ilqr_sweep<M>(X, me, Lo);
    for (int e = me.g; e < H * C; e += G) {
      const float u = us_out[e * B + b], zt = z_out[e * B + b], yt = ys[e];
      const float uh = P.over_relax
          ? __fadd_rn(__fmul_rn(P.relax, u), __fmul_rn(P.one_minus_relax, zt))
          : u;
      const float zn = clip(__fadd_rn(uh, yt), P.u_limit);
      ys[e] = __fsub_rn(__fadd_rn(yt, uh), zn);
      if (me.live) z_out[e * B + b] = zn;
    }
    __syncwarp();
  }

  // The feasible rollout of z: lane l < L steps features l and l + L.
  if (me.live && me.g < L) {
    const int l = me.g;
    const int idx[4] = {l, l + L, M + l, M + l + L};
    float p[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      p[q] = p0[at(0, idx[q], N, B, b)];
      ps_out[at(0, idx[q], N, B, b)] = p[q];
    }
    const float iz0 = iz[at(0, l, M, B, b)], iz1 = iz[at(0, l + L, M, B, b)];
    for (int t = 0; t < H; ++t) {
      float u[C];
#pragma unroll
      for (int c = 0; c < C; ++c) u[c] = z_out[at(t, c, C, B, b)];
      sweep::dyn_feature(p[0], p[2], u, iz0, P.W.dt, p[0], p[2]);
      sweep::dyn_feature(p[1], p[3], u, iz1, P.W.dt, p[1], p[3]);
#pragma unroll
      for (int q = 0; q < 4; ++q) ps_out[at(t + 1, idx[q], N, B, b)] = p[q];
    }
  }
}

template <int M>
int launch(const float* const* in, float* const* out, const Params& P,
           cudaStream_t stream) {
  const Layout Lo = sweep_group::layout(M, P.H, true);
  const size_t bytes = sizeof(float) * Geom<M>::S * Lo.stride;
  int err = sweep_group::allow_smem(full_solve_kernel<M>, bytes);
  if (err) return err;
  const dim3 grid((P.B + Geom<M>::S - 1) / Geom<M>::S);
  full_solve_kernel<M><<<grid, 32, bytes, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], out[0], out[1], out[2], P);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block (bytes), for the solver's choice of
// path (sweep.group_sweep_fits).
extern "C" int full_solve_smem_bytes(int m, int H) {
  return (int)(sizeof(float) * (32 / (2 * m)) *
               sweep_group::layout(m, H, true).stride);
}

extern "C" int full_solve_launch(
    int m, const void* p0, const void* ps, const void* us, const void* g,
    const void* target, const void* inv_depth, void* ps_out, void* z_out,
    void* us_out, int H, int B, int sweeps, int admm_iters, int over_relax,
    float q, float r, float rho, float qe, float dt, float reg, float u_limit,
    float relax, float one_minus_relax, void* stream) {
  if (H < 1 || B < 1 || sweeps < 0 || admm_iters < 0)
    return (int)cudaErrorInvalidValue;
  const float* in[6] = {(const float*)p0, (const float*)ps, (const float*)us,
                        (const float*)g, (const float*)target,
                        (const float*)inv_depth};
  float* out[3] = {(float*)ps_out, (float*)z_out, (float*)us_out};
  const Params P{H, B, sweeps, admm_iters, over_relax, u_limit, relax,
                 one_minus_relax, {q, r, rho, qe, dt, reg}};
  cudaStream_t s = (cudaStream_t)stream;
  switch (m) {
    case 2: return launch<2>(in, out, P, s);
    case 4: return launch<4>(in, out, P, s);
    case 8: return launch<8>(in, out, P, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
