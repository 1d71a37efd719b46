// The forward sweep's steps with one thread per scenario, for the forward
// kernel of csrc/sweep.cu, as `_forward_step` and `_dyn_step` of
// openmp_parallel_computing_tpu/models/mpc/sweep_pallas.py are for the TPU
// kernel. Each function works on one scenario held by the calling thread.
// The other sweep kernels run on a thread group per scenario
// (csrc/sweep_group.cuh); the two designs share csrc/sweep_common.cuh
// (weights, step sizes, dynamics).
//
// Layout of every array: the scenario index b is the fastest axis, so a
// warp's 32 threads touch 32 consecutive floats. Element [t][i] of a
// (T, R, B) array for scenario b is at ((t * R) + i) * B + b (`lane`).
// The state axis is in split order [x_0..x_{m-1}, y_0..y_{m-1}], so the
// IBVS state Jacobian is four diagonal m x m blocks (A, Bc, C, D).
#pragma once

#include "sweep_common.cuh"

namespace sweep {

constexpr int kThreads = 32;  // small blocks: a batch of 4096 spans all SMs

__device__ __forceinline__ size_t lane(int t, int i, int R, size_t B, int b) {
  return ((size_t)t * R + i) * B + b;
}

// Row t of a (T, R, B) array into registers.
template <int R>
__device__ __forceinline__ void load_row(const float* arr, int t, size_t B,
                                         int b, float* out) {
#pragma unroll
  for (int i = 0; i < R; ++i) out[i] = arr[lane(t, i, R, B, b)];
}

template <int R>
__device__ __forceinline__ void store_row(float* arr, int t, size_t B, int b,
                                          const float* in) {
#pragma unroll
  for (int i = 0; i < R; ++i) arr[lane(t, i, R, B, b)] = in[i];
}

// One candidate's forward step: u = u_nom + alpha k + K (p - p_nom) with K
// row c at Kt[c * N * ks + j * ks], the stage cost (tracking, effort, ADMM
// augmentation, linearized edge term), and the next state. Writes ua and
// nxt; returns the stage cost.
template <int M>
__device__ __forceinline__ float cand_step(
    float alpha, const float* pa, const float* pn, const float* un,
    const float* kt, const float* Kt, size_t ks, const float* zt,
    const float* yt, const float* gt, const float* tgt, const float* iz,
    const Weights& W, float* ua, float* nxt) {
  constexpr int N = 2 * M;
  float dp[N];
#pragma unroll
  for (int i = 0; i < N; ++i) dp[i] = pa[i] - pn[i];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float* Kc = Kt + (size_t)c * N * ks;
    float s = Kc[0] * dp[0];
#pragma unroll
    for (int j = 1; j < N; ++j) s += Kc[(size_t)j * ks] * dp[j];
    ua[c] = (un[c] + alpha * kt[c]) + s;
  }
  float tr = 0.0f, ed = 0.0f, ef = 0.0f, ad = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float e = pa[i] - tgt[i];
    tr += e * e;
    ed += gt[i] * dp[i];
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float w = ua[c] - zt[c] + yt[c];
    ef += ua[c] * ua[c];
    ad += w * w;
  }
  dyn_step<M>(pa, ua, iz, W.dt, nxt);
  return W.q * tr + W.r * ef + 0.5f * W.rho * ad + W.qe * ed;
}

// The terminal tracking + linearized edge terms added to a candidate's
// cost: (J + q |p_H - target|^2) + qe g_H . (p_H - pterm).
template <int M>
__device__ __forceinline__ float add_terminal(float J, const float* pa,
                                              const float* pterm,
                                              const float* gterm,
                                              const float* tgt,
                                              const Weights& W) {
  float tr = 0.0f, ed = 0.0f;
#pragma unroll
  for (int i = 0; i < 2 * M; ++i) {
    const float e = pa[i] - tgt[i];
    tr += e * e;
    ed += gterm[i] * (pa[i] - pterm[i]);
  }
  return J + W.q * tr + W.qe * ed;
}

}  // namespace sweep
