// What the CUDA Riccati recursions share: the control and candidate
// counts, the cost weights, the line-search step sizes, the clipped Euler
// step of the IBVS dynamics and the 6 x 6 Cholesky solve of Quu.
// csrc/sweep_group.cuh (a thread group per scenario: csrc/multi_sweep.cu,
// csrc/full_solve.cu and csrc/sweep.cu) and csrc/riccati.cu include it, so
// the dynamics and the solve have one source.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace sweep {

constexpr int C = 6;          // control dimension
constexpr int A = 4;          // line-search candidates

struct Weights {
  float q, r, rho, qe, dt, reg;
};

// Line-search step sizes, ALPHAS = (0, 1, 0.5, 0.25).
__device__ __forceinline__ float alpha_of(int a) {
  return a == 0 ? 0.0f : a == 1 ? 1.0f : a == 2 ? 0.5f : 0.25f;
}

// clamp(v, -4, 4) keeping a NaN, as torch.clamp and jnp.clip do (fmaxf
// would turn it into the bound).
__device__ __forceinline__ float clip_state(float v) {
  return v < -4.0f ? -4.0f : (v > 4.0f ? 4.0f : v);
}

// One feature (x, y) of the clipped Euler step p' = clip(p + dt L(p) u, +-4)
// with inverse depth iz.
__device__ __forceinline__ void dyn_feature(float x, float y, const float* u,
                                            float iz, float dt, float& nx,
                                            float& ny) {
  const float vx = u[0], vy = u[1], vz = u[2];
  const float wx = u[3], wy = u[4], wz = u[5];
  const float xdot = -vx * iz + x * vz * iz + x * y * wx -
                     (1.0f + x * x) * wy + y * wz;
  const float ydot = -vy * iz + y * vz * iz + (1.0f + y * y) * wx -
                     x * y * wy - x * wz;
  nx = clip_state(x + dt * xdot);
  ny = clip_state(y + dt * ydot);
}

// The whole split-layout step: p (n = 2M) -> out.
template <int M>
__device__ __forceinline__ void dyn_step(const float* p, const float* u,
                                         const float* iz, float dt,
                                         float* out) {
#pragma unroll
  for (int j = 0; j < M; ++j)
    dyn_feature(p[j], p[M + j], u, iz[j], dt, out[j], out[M + j]);
}

// Column Cholesky of the lower triangle of Q (Q[i][j], i >= j, read): column
// j of the factor in L[j][i], i >= j, and 1 / d_j in inv_d[j]. Q is never
// symmetrized and the upper triangle never read. 1 / d_j is 1 / sqrtf, two
// correctly rounded operations as in the plain versions, or with kRsqrt the
// hardware's rsqrtf (within 2 ulp; one instruction where the exact pair is
// a dozen on the step's serial chain).
template <bool kRsqrt = false>
__device__ __forceinline__ void chol_factor(const float (&Q)[C][C],
                                            float (&L)[C][C],
                                            float (&inv_d)[C]) {
#pragma unroll
  for (int jj = 0; jj < C; ++jj) {
#pragma unroll
    for (int i = jj; i < C; ++i) {
      float s = Q[i][jj];
#pragma unroll
      for (int p = 0; p < jj; ++p) s -= L[p][i] * L[p][jj];
      L[jj][i] = s;
    }
    const float rr = kRsqrt ? rsqrtf(L[jj][jj]) : 1.0f / sqrtf(L[jj][jj]);
#pragma unroll
    for (int i = jj; i < C; ++i) L[jj][i] *= rr;
    inv_d[jj] = rr;
  }
}

// x = L^-1 applied twice: the solve of Q x = rhs with chol_factor's factor,
// forward then back substitution, multiplying by the cached 1 / d.
__device__ __forceinline__ void chol_solve(const float (&L)[C][C],
                                           const float (&inv_d)[C],
                                           const float* rhs, float* X) {
  float Y[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    float s = rhs[i];
#pragma unroll
    for (int pp = 0; pp < i; ++pp) s -= L[pp][i] * Y[pp];
    Y[i] = s * inv_d[i];
  }
#pragma unroll
  for (int i = C - 1; i >= 0; --i) {
    float s = Y[i];
#pragma unroll
    for (int pp = i + 1; pp < C; ++pp) s -= L[i][pp] * X[pp];
    X[i] = s * inv_d[i];
  }
}

}  // namespace sweep
