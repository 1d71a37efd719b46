// The iLQR sweep on a thread group per scenario, for csrc/multi_sweep.cu,
// csrc/full_solve.cu and the unified, backward and forward kernels of
// csrc/sweep.cu: one source of the recursion for all five, as
// `_backward_step`, `_forward_cand_step`, `_terminal_cost_accum` and
// `_select_winner` of openmp_parallel_computing_tpu/models/mpc/
// sweep_pallas.py are for the TPU kernels.
//
// A scenario with m features (state n = 2m, split order [x_0..x_{m-1},
// y_0..y_{m-1}]) gets a group of G = n threads inside one warp (16 at m = 8,
// so two scenarios a warp); a block is one warp. The group synchronises
// with __syncwarp and exchanges values by shuffles; it never waits at a
// block barrier.
//
// Backward (Riccati), thread k owns column k of every n x n or c x n
// product: Vxx, T = Vxx fx and the new Vxx, U = fu^T Vxx, Qux = U fx and the
// gains K. fx is four diagonal blocks, so column k of T, Qux and of fx^T T
// needs only column k ^ m of its operand, one shuffle away. Quu = U fu and
// Qu = lu + fu^T Vx are sums over the group (butterfly shuffles: every lane
// gets the same bits). The 6 x 6 Cholesky runs on every lane alike; lane k
// solves right-hand column k of Qux, and every lane the column Qu. fu, the
// diagonal blocks of fx and Qux pass through a few hundred bytes of shared
// scratch. The gains of the whole horizon stay in the scenario's shared
// memory, or, given a GlobalGains, go to the (H, c, n, B) and (H, c, B)
// arrays of global memory; the recursion is the same code for both.
//
// Forward (line search), the group splits into A = 4 runs of L = m / 2
// lanes, one run a candidate alpha = (0, 1, 0.5, 0.25); lane l of a run owns
// features l and l + L (four state entries). K (p - p_nom) and the costs are
// sums over the run. In a sweep with a select the candidates are not
// stored: after the first-wins select (a non-finite cost counts as +inf; a
// choice, never a one-hot product) the group runs the winner's forward
// again (the replay), the same arithmetic in the same order, so it
// reproduces the winner's bits and writes them over the nominal (alpha = 0
// winning keeps the nominal as it is). Given arrays for them (Arrays.ps_c),
// the forward instead writes every candidate's trajectory, controls and raw
// cost, and leaves the pick to the caller.
//
// Layout of the global arrays: the scenario index b is the fastest axis;
// element [t][i] of a (T, R, B) array is at (t R + i) B + b (`at`).
#pragma once

#include "sweep_common.cuh"

namespace sweep_group {

using sweep::A;
using sweep::C;
using sweep::Weights;

constexpr unsigned kWarp = 0xffffffffu;

template <int M>
struct Geom {
  static constexpr int N = 2 * M;    // state size
  static constexpr int G = N;        // threads a scenario
  static constexpr int S = 32 / G;   // scenarios a block (one warp)
  static constexpr int L = M / 2;    // lanes a line-search candidate
  static_assert(M == 2 || M == 4 || M == 8, "m must be 2, 4 or 8");
};

// Float offsets into one scenario's shared memory: the gains K (H, c, n) and
// k (H, 8), the step's scratch fu (n, 8), Qux (n, 8) and the fx blocks
// (m, 4: A, Bc, C, D), and y (H, c) when the dual lives there. H = 0 gives
// the step's scratch alone, for gains in global memory. The stride is G
// more than a multiple of 32 floats, so the groups of a warp fall on
// different banks.
struct Layout {
  int K, kf, fu, qux, coef, y, stride;
};

__host__ __device__ inline Layout layout(int M, int H, bool with_y) {
  const int N = 2 * M;
  Layout s;
  s.K = 0;
  s.kf = H * C * N;
  s.fu = s.kf + 8 * H;
  s.qux = s.fu + 8 * N;
  s.coef = s.qux + 8 * N;
  s.y = s.coef + 4 * M;
  const int used = s.y + (with_y ? C * H : 0);
  s.stride = (used + 31) / 32 * 32 + N;
  return s;
}

// Let `kernel` take `bytes` of dynamic shared memory (above 48 KB only on
// request); returns a cudaError_t. A refusal (more than the card's opt-in
// limit) is also taken off the thread's last-error state, so that it fails
// this launch alone and not the next caller's error check.
template <typename Kernel>
inline int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

__device__ __forceinline__ size_t at(int t, int i, int R, size_t B, int b) {
  return ((size_t)t * R + i) * B + b;
}

// Sum over aligned runs of W lanes, a butterfly: every lane of the run gets
// the same bits, since a + b == b + a in IEEE arithmetic.
template <int W>
__device__ __forceinline__ float run_sum(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kWarp, v, o);
  return v;
}

__device__ __forceinline__ void store6(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float2*>(dst + 4) = make_float2(v[4], v[5]);
}

__device__ __forceinline__ void load6(const float* src, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float2 b = *reinterpret_cast<const float2*>(src + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; v[4] = b.x; v[5] = b.y;
}

// The arrays of one launch; the nominal (ps, us) is updated in place by the
// replay, and only read otherwise.
struct Arrays {
  const float* p0;    // (n, B)
  const float* g;     // (H+1, n, B) edge linearization
  const float* tgt;   // (n, B)
  const float* iz;    // (m, B)
  const float* z;     // (H, c, B)
  const float* y;     // (H, c, B), or null: y in shared memory
  float* ps;          // (H+1, n, B)
  float* us;          // (H, c, B)
  int H;
  size_t B;
  Weights W;
  // The candidates' outputs, or null: the forward writes none.
  float* ps_c = nullptr;   // (H+1, A, n, B)
  float* us_c = nullptr;   // (H, A, c, B)
  float* J = nullptr;      // (A, B)
};

// One thread's place: its lane in the group, its scenario (clamped into
// the batch: a group past the end computes on the last scenario, so that
// every lane of the warp takes part in the shuffles, and writes nothing)
// and the scenario's shared memory.
struct Place {
  int g;
  int b;
  bool live;
  float* sm;
};

// The gains K (H, c, n) and k (H, c) of a scenario in the (H, c, n, B) and
// (H, c, B) arrays of global memory, from the scenario's column on. The
// backward stores a step's gains through `put` (thread i gives column i of
// K, lane c mod n gives k[c]: a group of n = 4 lanes at m = 2 has fewer
// lanes than k; a group past the end of the batch stores nothing); the
// forward reads them through `K_at` and `k_row`. With T = const float the
// gains are read-only (the forward kernel's inputs): `put` is never
// instantiated for them.
template <int M, typename T = float>
struct GlobalGains {
  static constexpr int N = 2 * M;
  T* K;               // &K[0][0][0][b]
  T* k;               // &k[0][0][b]
  size_t B;
  bool live;

  __device__ __forceinline__ void put(int t, int i, const float* Kc,
                                      const float* kff) const {
    if (!live) return;
#pragma unroll
    for (int c = 0; c < C; ++c) K[((size_t)(t * C + c) * N + i) * B] = Kc[c];
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (c % N == i) k[(size_t)(t * C + c) * B] = kff[c];
  }
  __device__ __forceinline__ float K_at(int t, int c, int i) const {
    return K[((size_t)(t * C + c) * N + i) * B];
  }
  __device__ __forceinline__ void k_row(int t, float* v) const {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = k[(size_t)(t * C + c) * B];
  }
};

__device__ __forceinline__ float y_at(const Arrays& X, const Place& me,
                                      const Layout& Lo, int t, int c) {
  return X.y ? X.y[at(t, c, C, X.B, me.b)] : me.sm[Lo.y + t * C + c];
}

// The Riccati backward over tau = H-1 .. 0 about the nominal, with the ADMM
// pair (z, y) and g fixed: gains K, k into shared memory, or into `Kg`
// where it is given. Vxx is not symmetrized. Thread k owns column k;
// j = k mod m is its feature.
template <int M>
__device__ __forceinline__ void backward(const Arrays& X, const Place& me,
                                         const Layout& Lo,
                                         const GlobalGains<M>* Kg = nullptr) {
  constexpr int N = 2 * M;
  const int k = me.g, j = k & (M - 1), b = me.b, H = X.H;
  const bool top = k < M;
  const size_t B = X.B;
  const Weights& W = X.W;
  const float q = W.q, r = W.r, rho = W.rho, qe = W.qe, dt = W.dt;
  float* Ks = me.sm + Lo.K;
  float* kfs = me.sm + Lo.kf;
  float* fus = me.sm + Lo.fu;
  float* quxs = me.sm + Lo.qux;
  float* coefs = me.sm + Lo.coef;
  const float tgt_k = X.tgt[at(0, k, N, B, b)];
  const float iz = X.iz[at(0, j, M, B, b)];

  // Terminal expansion: Vx = 2q (p_H - target) + qe g_H, Vxx = 2q I.
  float Vx = 2.0f * q * (X.ps[at(H, k, N, B, b)] - tgt_k) +
             qe * X.g[at(H, k, N, B, b)];
  float V[N];                                   // column k of Vxx
#pragma unroll
  for (int i = 0; i < N; ++i) V[i] = (i == k) ? 2.0f * q : 0.0f;

  for (int tau = H - 1; tau >= 0; --tau) {
    const float pk = X.ps[at(tau, k, N, B, b)];
    const float gk = X.g[at(tau, k, N, B, b)];
    float u[C], lu[C];
#pragma unroll
    for (int c = 0; c < C; ++c) u[c] = X.us[at(tau, c, C, B, b)];
#pragma unroll
    for (int c = 0; c < C; ++c)
      lu[c] = 2.0f * r * u[c] +
              rho * (u[c] - X.z[at(tau, c, C, B, b)] + y_at(X, me, Lo, tau, c));
    // The IBVS Jacobians at feature j: fx's diagonal blocks and fu's row k.
    const float pp = __shfl_xor_sync(kWarp, pk, M);
    const float x = top ? pk : pp, y = top ? pp : pk;
    const float vz = u[2], wx = u[3], wy = u[4], wz = u[5];
    const float Af = 1.0f + dt * (vz * iz + y * wx - 2.0f * x * wy);
    const float Bf = dt * (x * wx + wz);
    const float Cf = dt * (-y * wy - wz);
    const float Df = 1.0f + dt * (vz * iz + 2.0f * y * wx - x * wy);
    const float c1 = top ? Af : Bf, c2 = top ? Cf : Df;  // fx column k
    float fu[C];
    fu[0] = top ? dt * -iz : 0.0f;
    fu[1] = top ? 0.0f : dt * -iz;
    fu[2] = top ? dt * (x * iz) : dt * (y * iz);
    fu[3] = top ? dt * (x * y) : dt * (1.0f + y * y);
    fu[4] = top ? dt * -(1.0f + x * x) : dt * -(x * y);
    fu[5] = top ? dt * y : dt * -x;
    __syncwarp();                     // the last step's readers are done
    store6(fus + k * 8, fu);
    if (top)
      *reinterpret_cast<float4*>(coefs + j * 4) = make_float4(Af, Bf, Cf, Df);
    __syncwarp();

    // Qx = lx + fx^T Vx (row k), Qu = lu + fu^T Vx.
    const float Vp = __shfl_xor_sync(kWarp, Vx, M);
    const float lx = 2.0f * q * (pk - tgt_k) + qe * gk;
    const float Qx = lx + (c1 * (top ? Vx : Vp) + c2 * (top ? Vp : Vx));
    float Qu[C];
#pragma unroll
    for (int c = 0; c < C; ++c) Qu[c] = lu[c] + run_sum<N>(fu[c] * Vx);

    // U[:, k] = fu^T Vxx[:, k]; Quu = (2r + rho + reg) I + U fu (lower).
    float U[C];
    load6(fus, U);
#pragma unroll
    for (int c = 0; c < C; ++c) U[c] *= V[0];
#pragma unroll
    for (int i = 1; i < N; ++i) {
      float f[C];
      load6(fus + i * 8, f);
#pragma unroll
      for (int c = 0; c < C; ++c) U[c] += f[c] * V[i];
    }
    float Quu[C][C];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int d = 0; d <= c; ++d)
        Quu[c][d] = (c == d ? 2.0f * r + rho + W.reg : 0.0f) +
                    run_sum<N>(U[c] * fu[d]);

    // Column Cholesky of Quu, alike on every lane: L[i][j] = Lc[j][i].
    float Lc[C][C], inv_d[C];
    sweep::chol_factor(Quu, Lc, inv_d);

    // Qux[:, k] = U fx[:, k]; the gains k = -Quu^-1 Qu, K[:, k] =
    // -Quu^-1 Qux[:, k].
    float Qux[C], kff[C], Kc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float up = __shfl_xor_sync(kWarp, U[c], M);
      Qux[c] = (top ? U[c] : up) * c1 + (top ? up : U[c]) * c2;
    }
    sweep::chol_solve(Lc, inv_d, Qu, kff);
    sweep::chol_solve(Lc, inv_d, Qux, Kc);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      kff[c] = -kff[c];
      Kc[c] = -Kc[c];
      if (!Kg) Ks[(tau * C + c) * N + k] = Kc[c];
    }
    if (Kg)
      Kg->put(tau, k, Kc, kff);
    else if (k == 0)
      store6(kfs + tau * 8, kff);

    // Vx' = Qx + Qux^T k.
    {
      float s = Qux[0] * kff[0];
#pragma unroll
      for (int c = 1; c < C; ++c) s += Qux[c] * kff[c];
      Vx = Qx + s;
    }
    // T[:, k] = Vxx fx[:, k]; then Vxx'[:, k] = 2q I + fx^T T + Qux^T K.
    float T[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float vp = __shfl_xor_sync(kWarp, V[i], M);
      T[i] = (top ? V[i] : vp) * c1 + (top ? vp : V[i]) * c2;
    }
    store6(quxs + k * 8, Qux);
    __syncwarp();
#pragma unroll
    for (int jj = 0; jj < M; ++jj) {
      const float4 co = *reinterpret_cast<const float4*>(coefs + jj * 4);
      const float tt = T[jj], tb = T[M + jj];
      float vt = co.x * tt + co.z * tb;
      float vb = co.y * tt + co.w * tb;
      if (k == jj) vt += 2.0f * q;
      if (k == M + jj) vb += 2.0f * q;
      float qa[C], qb[C];
      load6(quxs + jj * 8, qa);
      load6(quxs + (M + jj) * 8, qb);
      float st = qa[0] * Kc[0], sb = qb[0] * Kc[0];
#pragma unroll
      for (int c = 1; c < C; ++c) {
        st += qa[c] * Kc[c];
        sb += qb[c] * Kc[c];
      }
      V[jj] = vt + st;
      V[M + jj] = vb + sb;
    }
  }
  __syncwarp();                       // the gains, for every lane
}

// One step's nominal and linearization at a forward lane's four state
// entries, and the step's controls.
template <int M>
struct Row {
  float pn[4], gt[4], un[C], zt[C], yt[C];
};

template <int M>
__device__ __forceinline__ Row<M> load_row(const Arrays& X, const Place& me,
                                           const Layout& Lo, const int* idx,
                                           int t) {
  constexpr int N = 2 * M;
  Row<M> w;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    w.pn[q] = X.ps[at(t, idx[q], N, X.B, me.b)];
    w.gt[q] = X.g[at(t, idx[q], N, X.B, me.b)];
  }
  if (t < X.H) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      w.un[c] = X.us[at(t, c, C, X.B, me.b)];
      w.zt[c] = X.z[at(t, c, C, X.B, me.b)];
      w.yt[c] = y_at(X, me, Lo, t, c);
    }
  }
  return w;
}

// The forward of the candidate `alpha` on this lane's run: u = u_nom +
// alpha k + K (p - p_nom), the stage costs (tracking, effort, ADMM
// augmentation, linearized edge term), the clipped Euler step; then the
// terminal tracking and edge terms. Returns the candidate's cost, alike on
// the run's lanes. The gains are read from shared memory, or from `Kg`
// (a GlobalGains, writable or read-only) where it is given.
// - With `replay` every step ends at a __syncwarp, after which run 0 of a
//   live group with `write` puts the trajectory over the nominal (each step
//   has read its nominal rows before any lane writes).
// - With X.ps_c set, lane l of run a writes its four state entries of
//   candidate a into X.ps_c (row 0 = p0) and its controls c = l mod L into
//   X.us_c, and the run's lane 0 the cost into X.J[a], non-finite or not; a
//   group past the end of the batch writes nothing.
template <int M, class Gains = GlobalGains<M>>
__device__ __forceinline__ float forward(const Arrays& X, const Place& me,
                                         const Layout& Lo, float alpha,
                                         bool replay, bool write,
                                         const Gains* Kg = nullptr) {
  constexpr int N = 2 * M, L = Geom<M>::L;
  const int l = me.g % L, b = me.b, H = X.H;
  const size_t B = X.B;
  const Weights& W = X.W;
  const int idx[4] = {l, l + L, M + l, M + l + L};
  const float* Ks = me.sm + Lo.K;
  const float* kfs = me.sm + Lo.kf;
  const int a = me.g / L;                       // this run's candidate
  const bool cands = X.ps_c != nullptr && me.live;
  write = write && me.live && me.g < L;
  float pa[4], tg[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    pa[q] = X.p0[at(0, idx[q], N, B, b)];
    tg[q] = X.tgt[at(0, idx[q], N, B, b)];
    if (cands) X.ps_c[at(0, a * N + idx[q], A * N, B, b)] = pa[q];
  }
  const float iz0 = X.iz[at(0, l, M, B, b)];
  const float iz1 = X.iz[at(0, l + L, M, B, b)];
  float jx = 0.0f, ju = 0.0f;        // state terms (this lane's), controls
  Row<M> cur = load_row<M>(X, me, Lo, idx, 0);
  for (int t = 0; t < H; ++t) {
    const Row<M> nxt = load_row<M>(X, me, Lo, idx, t + 1);
    float dp[4], kt[C], ua[C];
#pragma unroll
    for (int q = 0; q < 4; ++q) dp[q] = pa[q] - cur.pn[q];
    if (Kg)
      Kg->k_row(t, kt);
    else
      load6(kfs + t * 8, kt);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float* Kc = Ks + (t * C + c) * N;
      const auto K_at = [&](int i) { return Kg ? Kg->K_at(t, c, i) : Kc[i]; };
      float s = K_at(idx[0]) * dp[0];
#pragma unroll
      for (int q = 1; q < 4; ++q) s += K_at(idx[q]) * dp[q];
      ua[c] = (cur.un[c] + alpha * kt[c]) + run_sum<L>(s);
    }
    float tr = 0.0f, ed = 0.0f, ef = 0.0f, ad = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float e = pa[q] - tg[q];
      tr += e * e;
      ed += cur.gt[q] * dp[q];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float w = ua[c] - cur.zt[c] + cur.yt[c];
      ef += ua[c] * ua[c];
      ad += w * w;
    }
    jx = jx + (W.q * tr + W.qe * ed);
    ju = ju + (W.r * ef + 0.5f * W.rho * ad);
    sweep::dyn_feature(pa[0], pa[2], ua, iz0, W.dt, pa[0], pa[2]);
    sweep::dyn_feature(pa[1], pa[3], ua, iz1, W.dt, pa[1], pa[3]);
    if (replay) {
      __syncwarp();
      if (write) {
#pragma unroll
        for (int q = 0; q < 4; ++q) X.ps[at(t + 1, idx[q], N, B, b)] = pa[q];
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (c % L == l) X.us[at(t, c, C, B, b)] = ua[c];
      }
    }
    if (cands) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        X.ps_c[at(t + 1, a * N + idx[q], A * N, B, b)] = pa[q];
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (c % L == l) X.us_c[at(t, a * C + c, A * C, B, b)] = ua[c];
    }
    cur = nxt;
  }
  // cur is row H: the terminal nominal and edge linearization.
  float tr = 0.0f, ed = 0.0f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float e = pa[q] - tg[q];
    tr += e * e;
    ed += cur.gt[q] * (pa[q] - cur.pn[q]);
  }
  jx = jx + (W.q * tr + W.qe * ed);
  const float cost = ju + run_sum<L>(jx);
  if (cands && l == 0) X.J[at(0, a, A, B, b)] = cost;
  return cost;
}

// One iLQR sweep with a winner select about the nominal (X.ps, X.us): the
// backward into the gains in shared memory, the A candidates' forward, a
// first-wins argmin with a non-finite cost counted as +inf, the winner's
// replay over the nominal; row 0 of ps is set to p0.
template <int M>
__device__ __forceinline__ void ilqr_sweep(const Arrays& X, const Place& me,
                                           const Layout& Lo) {
  constexpr int G = Geom<M>::G, L = Geom<M>::L;
  backward<M>(X, me, Lo);
  const float mine = forward<M>(X, me, Lo, sweep::alpha_of(me.g / L), false,
                                false);
  const int base = (threadIdx.x & 31) & ~(G - 1);
  float J[A];
#pragma unroll
  for (int a = 0; a < A; ++a) {
    J[a] = __shfl_sync(kWarp, mine, base + a * L);
    if (!isfinite(J[a])) J[a] = INFINITY;
  }
  float jmin = J[0];
#pragma unroll
  for (int a = 1; a < A; ++a) jmin = fminf(jmin, J[a]);
  int win = 0;
#pragma unroll
  for (int a = A - 1; a >= 0; --a)
    if (J[a] == jmin) win = a;                    // first wins
  if (__any_sync(kWarp, win > 0))
    forward<M>(X, me, Lo, sweep::alpha_of(win), true, win > 0);
  __syncwarp();
  if (me.live && me.g < L) {
    constexpr int N = 2 * M;
    const int l = me.g;
    const int idx[4] = {l, l + L, M + l, M + l + L};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      X.ps[at(0, idx[q], N, X.B, me.b)] = X.p0[at(0, idx[q], N, X.B, me.b)];
  }
  __syncwarp();
}

// This thread's place in a one-warp block of Geom<M>::S scenarios.
template <int M>
__device__ __forceinline__ Place place(float* smem, const Layout& Lo, int B) {
  constexpr int G = Geom<M>::G, S = Geom<M>::S;
  const int s = threadIdx.x / G;
  const int b = blockIdx.x * S + s;
  return Place{(int)threadIdx.x % G, b < B ? b : B - 1, b < B,
               smem + s * Lo.stride};
}

}  // namespace sweep_group
