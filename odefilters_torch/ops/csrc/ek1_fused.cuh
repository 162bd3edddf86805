// Per-member bodies of the fused EK1 kernels (ek1_fused.cu): the square-root
// EK1 filter step with the field's Jacobian evaluated in the kernel, the
// backward RTS step and the backward conditioning step over the filter's
// D x D factor stream, and the loops over one member's time steps that the
// kernels run. Their plain PyTorch versions, in the same order of
// operations, are in odefilters_torch/ops/ek1_fused.py (ek1_step,
// ek1_filter_states_plain, ekd_smoother_plain, ekd_sampler_plain).
//
// The state is flat and derivative-major, N = DIM * NQ entries: entry i is
// derivative i / DIM of dimension i % DIM. The transition A = kron(At, I)
// and the noise factor QLf = kron(QLt, I) are read from the NQ x NQ blocks;
// their structural zeros (At upper and QLt lower triangular, the identity's
// off-diagonal) are known at compile time once the loops are unrolled.
#pragma once

#include "ek0_common.cuh"
#include "ek0_sample.cuh"

namespace ek1 {

using ek0::cho_solve;
using ek0::floor_at;
using ek0::mgs_tril;
using ek0::sqrt_;

// the filter's mode argument: dynamic, fixed or fixedMAP (ek0_common.cuh)
using ek0::DYNAMIC;
using ek0::FIXED;
using ek0::FIXED_MAP;

// Constants of the three kernels: the preconditioned IBM transition At
// (upper triangular) and noise factor QLt (lower triangular), the
// preconditioner entries of blocks 0 and 1, the grid, and qsq[j] =
// QLf[j][j]^2 taken in double and rounded once (the static models' stack
// holds the noise factor as constants, whose squares the plain version's
// Python floats take in double).
template <typename S, int NQ, int DIM>
struct Consts {
  static constexpr int N = NQ * DIM;
  S At[NQ][NQ];
  S QLt[NQ][NQ];
  S pinv0, pinv1, t0, dt;
  S qsq[N];
};

// The nonzero pattern of A = kron(At, I): r and c of one dimension, c's
// derivative block at or after r's.
template <int DIM>
__device__ __forceinline__ constexpr bool a_live(int r, int c) {
  return r % DIM == c % DIM && c / DIM >= r / DIM;
}

// The nonzero pattern of QLf = kron(QLt, I).
template <int DIM>
__device__ __forceinline__ constexpr bool q_live(int r, int c) {
  return r % DIM == c % DIM && r / DIM >= c / DIM;
}

// Row of the filter's stream: mean (N) | L (N*N, row-major) | s2 | the
// lower triangle of Lp, row by row (N(N+1)/2; only when a backward pass
// follows).
template <int N>
struct Layout {
  static constexpr int L = N;
  static constexpr int S2 = N + N * N;
  static constexpr int LP = S2 + 1;
  static constexpr int V_FILTER = S2 + 1;
  static constexpr int V = V_FILTER + N * (N + 1) / 2;
};

// Cholesky factor of the symmetric K x K matrix C: pivots
// sqrt(max(s, 1e-30)), the entries below divided by them.
template <typename S, int K>
__device__ __forceinline__ void chol(const S (&C)[K][K], S (&L)[K][K]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j > i) {
        L[i][j] = S(0);
        continue;
      }
      S s = C[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = i == j ? sqrt_(floor_at(s, S(1e-30))) : s / L[j][j];
    }
}

// X Y^T for two DIM x N blocks.
template <typename S, int DIM, int N>
__device__ __forceinline__ void gram(const S (&Z)[DIM][N],
                                     S (&G)[DIM][DIM]) {
#pragma unroll
  for (int a = 0; a < DIM; ++a)
#pragma unroll
    for (int b = 0; b < DIM; ++b) {
      S acc = S(0);
#pragma unroll
      for (int c = 0; c < N; ++c) acc += Z[a][c] * Z[b][c];
      G[a][b] = acc;
    }
}

// y = A x over A's nonzero entries.
template <typename S, int NQ, int DIM>
__device__ __forceinline__ void a_times_vec(const Consts<S, NQ, DIM>& c,
                                            const S (&x)[NQ * DIM],
                                            S (&y)[NQ * DIM]) {
  constexpr int N = NQ * DIM;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    S acc = S(0);
#pragma unroll
    for (int cc = 0; cc < N; ++cc)
      if (a_live<DIM>(r, cc)) acc += c.At[r / DIM][cc / DIM] * x[cc];
    y[r] = acc;
  }
}

// Y = A X over A's nonzero entries.
template <typename S, int NQ, int DIM>
__device__ __forceinline__ void a_times_mat(
    const Consts<S, NQ, DIM>& c, const S (&X)[NQ * DIM][NQ * DIM],
    S (&Y)[NQ * DIM][NQ * DIM]) {
  constexpr int N = NQ * DIM;
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int k = 0; k < N; ++k) {
      S acc = S(0);
#pragma unroll
      for (int cc = 0; cc < N; ++cc)
        if (a_live<DIM>(r, cc)) acc += c.At[r / DIM][cc / DIM] * X[cc][k];
      Y[r][k] = acc;
    }
}

// H M for H = (E1 - J E0) P^-1 and an N x N block M given entry by entry:
// out[a][k] = pinv1 M[DIM + a][k] - sum_b J[a][b] (pinv0 M[b][k]).
template <typename S, int NQ, int DIM, class Get>
__device__ __forceinline__ void h_times(const Consts<S, NQ, DIM>& c,
                                        const S (&J)[DIM * DIM], Get M,
                                        S (&out)[DIM][NQ * DIM]) {
  constexpr int N = NQ * DIM;
#pragma unroll
  for (int a = 0; a < DIM; ++a)
#pragma unroll
    for (int k = 0; k < N; ++k) {
      S v = c.pinv1 * M(DIM + a, k);
#pragma unroll
      for (int b = 0; b < DIM; ++b) v = v - J[a * DIM + b] * (c.pinv0 * M(b, k));
      out[a][k] = v;
    }
}

// One square-root EK1 step from (m, L), updated in place: predict the
// mean, evaluate the field and its Jacobian (at u_lin when given, the IEKS
// hook; the field itself at the predicted mean), calibrate the dynamic
// diffusion s2 = z^T (H Q H^T)^-1 z / DIM (STATIC: the unscaled prior),
// factor the predicted covariance by MGS of [(A L)^T; (sqrt(s2) QLf)^T]
// into Lp, and apply the update L = Lp - K H Lp. Returns s2, or under
// STATIC the step's statistic z^T S^-1 z / DIM.
template <typename S, int NQ, class F, bool STATIC>
__device__ __forceinline__ S filter_step(const Consts<S, NQ, F::D>& c,
                                         const S* p, S t, const S* u_lin,
                                         S (&m)[NQ * F::D],
                                         S (&L)[NQ * F::D][NQ * F::D],
                                         S (&Lp)[NQ * F::D][NQ * F::D]) {
  constexpr int DIM = F::D;
  constexpr int N = NQ * DIM;
  S mp[N];
  a_times_vec<S, NQ, DIM>(c, m, mp);
  S u[DIM], du[DIM], J[DIM * DIM], z[DIM];
#pragma unroll
  for (int j = 0; j < DIM; ++j) u[j] = c.pinv0 * mp[j];
  F()(u, p, t, du);
  F().jac(u_lin ? u_lin : u, p, t, J);
#pragma unroll
  for (int a = 0; a < DIM; ++a) z[a] = ek0::innovation(c.pinv1, mp[DIM + a], du[a]);

  S sq = S(1), s2 = S(1);
  if (!STATIC) {
    S HQ[DIM][N], Sq[DIM][DIM], Lq[DIM][DIM], w[DIM];
    h_times<S, NQ, DIM>(c, J, [&](int r, int k) {
      return q_live<DIM>(r, k) ? c.QLt[r / DIM][k / DIM] : S(0);
    }, HQ);
    gram<S, DIM, N>(HQ, Sq);
    chol<S, DIM>(Sq, Lq);
    cho_solve<S, DIM>(Lq, z, w);
    S zw = S(0);
#pragma unroll
    for (int a = 0; a < DIM; ++a) zw += z[a] * w[a];
    s2 = zw * (S(1) / S(DIM));
    sq = sqrt_(floor_at(s2, S(0)));
  }

  {
    S AL[N][N], v[2 * N][N];
    a_times_mat<S, NQ, DIM>(c, L, AL);
#pragma unroll
    for (int k = 0; k < N; ++k)
#pragma unroll
      for (int i = 0; i < N; ++i) {
        v[k][i] = AL[i][k];
        v[N + k][i] = q_live<DIM>(i, k) ? sq * c.QLt[i / DIM][k / DIM] : S(0);
      }
    mgs_tril<S, N, 2 * N, true>(v, Lp, STATIC ? c.qsq : nullptr);
  }

  S Z[DIM][N], Sm[DIM][DIM], Ls[DIM][DIM];
  h_times<S, NQ, DIM>(c, J, [&](int r, int k) { return Lp[r][k]; }, Z);
  gram<S, DIM, N>(Z, Sm);
  chol<S, DIM>(Sm, Ls);
#pragma unroll
  for (int r = 0; r < N; ++r) {
    S lz[DIM], kg[DIM];
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      S acc = S(0);
#pragma unroll
      for (int k = 0; k < N; ++k) acc += Lp[r][k] * Z[a][k];
      lz[a] = acc;
    }
    cho_solve<S, DIM>(Ls, lz, kg);
    S km = S(0);
#pragma unroll
    for (int a = 0; a < DIM; ++a) km += kg[a] * z[a];
    m[r] = mp[r] - km;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      S kz = S(0);
#pragma unroll
      for (int a = 0; a < DIM; ++a) kz += kg[a] * Z[a][k];
      L[r][k] = Lp[r][k] - kz;
    }
  }
  if (!STATIC) return s2;
  S ws[DIM];
  cho_solve<S, DIM>(Ls, z, ws);
  S zs = S(0);
#pragma unroll
  for (int a = 0; a < DIM; ++a) zs += z[a] * ws[a];
  return zs * (S(1) / S(DIM));
}

template <typename S, int N>
__device__ __forceinline__ void store_row(S* __restrict__ st, size_t row0,
                                          size_t sB, const S (&m)[N],
                                          const S (&L)[N][N], S s2,
                                          const S (&Lp)[N][N], bool smooth) {
#pragma unroll
  for (int r = 0; r < N; ++r) st[row0 + r * sB] = m[r];
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int k = 0; k < N; ++k) st[row0 + (Layout<N>::L + r * N + k) * sB] = L[r][k];
  st[row0 + Layout<N>::S2 * sB] = s2;
  if (!smooth) return;
  int v = Layout<N>::LP;
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int k = 0; k <= r; ++k) st[row0 + (v++) * sB] = Lp[r][k];
}

// The filter over one member's T steps: row 0 is the exact initial state
// (L = 0, s2 = 1, Lp = 0), row k+1 the state after step k, its s2 and its
// Lp. lin (T+1, DIM, B), when given, linearizes step k at row k+1. Under
// STATIC, mode (FIXED or FIXED_MAP) picks the running estimate written to
// sig_out[b].
template <typename S, int NQ, class F, bool STATIC>
__device__ __forceinline__ void filter_member(
    const Consts<S, NQ, F::D>& c, const S* __restrict__ m0,
    const S* __restrict__ ps, const S* __restrict__ lin, S* __restrict__ st,
    S* __restrict__ sig_out, int b, int B, int T, int mode, bool smooth) {
  constexpr int DIM = F::D;
  constexpr int N = NQ * DIM;
  const size_t sB = (size_t)B;
  const size_t V = smooth ? Layout<N>::V : Layout<N>::V_FILTER;
  S p[F::NP], m[N], L[N][N], Lp[N][N];
#pragma unroll
  for (int k = 0; k < F::NP; ++k) p[k] = ps[k * sB + b];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    m[i] = m0[i * sB + b];
#pragma unroll
    for (int k = 0; k < N; ++k) L[i][k] = Lp[i][k] = S(0);
  }
  store_row<S, N>(st, b, sB, m, L, S(1), Lp, smooth);
  S sig = S(0), kf = S(0);
  for (int k = 0; k < T; ++k) {
    // t_{k+1} in the working dtype, never accumulated
    const S t = c.t0 + c.dt * S(k + 1);
    S u_lin[DIM];
    if (lin) {
#pragma unroll
      for (int j = 0; j < DIM; ++j)
        u_lin[j] = lin[((size_t)(k + 1) * DIM + j) * sB + b];
    }
    S s2 = filter_step<S, NQ, F, STATIC>(c, p, t, lin ? u_lin : nullptr, m,
                                         L, Lp);
    if (STATIC) {
      if (mode == FIXED)
        ek0::static_scalar_update<FIXED, S, DIM>(sig, kf, s2);
      else
        ek0::static_scalar_update<FIXED_MAP, S, DIM>(sig, kf, s2);
      kf = kf + S(1);
      s2 = S(1);
    }
    store_row<S, N>(st, (size_t)(k + 1) * V * sB + b, sB, m, L, s2, Lp,
                    smooth);
  }
  if (STATIC) sig_out[b] = sig;
}

// Row k's mean and full factor.
template <typename S, int N>
__device__ __forceinline__ void load_state(const S* __restrict__ st,
                                           size_t row0, size_t sB,
                                           S (&m)[N], S (&L)[N][N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) m[r] = st[row0 + r * sB];
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int k = 0; k < N; ++k) L[r][k] = st[row0 + (Layout<N>::L + r * N + k) * sB];
}

// Row k's diffusion and predicted factor (those of interval k-1 -> k);
// Lp's upper entries are zero.
template <typename S, int N>
__device__ __forceinline__ S load_predicted(const S* __restrict__ st,
                                            size_t row0, size_t sB,
                                            S (&Lp)[N][N]) {
  int v = Layout<N>::LP;
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int k = 0; k < N; ++k) Lp[r][k] = k <= r ? st[row0 + (v++) * sB] : S(0);
  return st[row0 + Layout<N>::S2 * sB];
}

// The work of a backward step from the filtered state (m_f, L_f) at t_k
// that does not depend on what is carried from t_{k+1}: the gain
// G = L_f (A L_f)^T (Lp Lp^T)^-1 (one Cholesky solve per row), the
// predicted mean mp, and the first 2N rows of the stack: row l holds
// column l of (I - G A) L_f, row N + l column l of sq G QLf.
template <typename S, int NQ, int DIM, int K>
__device__ __forceinline__ void backward_shared(
    const Consts<S, NQ, DIM>& c, const S (&m_f)[NQ * DIM],
    const S (&L_f)[NQ * DIM][NQ * DIM], const S (&Lp)[NQ * DIM][NQ * DIM],
    S sq, S (&G)[NQ * DIM][NQ * DIM], S (&mp)[NQ * DIM],
    S (&v)[K][NQ * DIM]) {
  constexpr int N = NQ * DIM;
  {
    S AL[N][N];
    a_times_mat<S, NQ, DIM>(c, L_f, AL);
#pragma unroll
    for (int r = 0; r < N; ++r) {
      S M[N];
#pragma unroll
      for (int l = 0; l < N; ++l) {
        S acc = S(0);
#pragma unroll
        for (int k = 0; k < N; ++k) acc += L_f[r][k] * AL[l][k];
        M[l] = acc;
      }
      cho_solve<S, N>(Lp, M, G[r]);
    }
  }
  a_times_vec<S, NQ, DIM>(c, m_f, mp);
#pragma unroll
  for (int r = 0; r < N; ++r) {
    S IGA[N];
#pragma unroll
    for (int l = 0; l < N; ++l) {
      S ga = S(0);
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (a_live<DIM>(k, l)) ga += G[r][k] * c.At[k / DIM][l / DIM];
      IGA[l] = (r == l ? S(1) : S(0)) - ga;
    }
#pragma unroll
    for (int l = 0; l < N; ++l) {
      S b1 = S(0), gq = S(0);
#pragma unroll
      for (int k = 0; k < N; ++k) b1 += IGA[k] * L_f[k][l];
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (q_live<DIM>(k, l)) gq += G[r][k] * c.QLt[k / DIM][l / DIM];
      v[l][r] = b1;
      v[N + l][r] = sq * gq;
    }
  }
}

template <typename S, int N, int DIM>
__device__ __forceinline__ void emit_smoothed(S* __restrict__ us,
                                              S* __restrict__ stds,
                                              size_t o, size_t sB, S pinv0,
                                              const S (&m)[N],
                                              const S (&L)[N][N]) {
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    S ss = S(0);
#pragma unroll
    for (int k = 0; k < N; ++k) ss += L[j][k] * L[j][k];
    us[o + j * sB] = pinv0 * m[j];
    stds[o + j * sB] = pinv0 * sqrt_(ss);
  }
}

// The backward square-root RTS pass over one member's stream st
// (T+1, V, B) into us and stds (T+1, DIM, B). The step from t_k uses the
// diffusion and predicted factor of interval k -> k+1, read from row k+1;
// the stds at T come from the filter's full factor.
template <typename S, int NQ, int DIM>
__device__ __forceinline__ void smoother_member(const Consts<S, NQ, DIM>& c,
                                                const S* __restrict__ st,
                                                S* __restrict__ us,
                                                S* __restrict__ stds, int b,
                                                int B, int T) {
  constexpr int N = NQ * DIM;
  constexpr size_t V = Layout<N>::V;
  const size_t sB = (size_t)B;
  S m_s[N], L_s[N][N];
  load_state<S, N>(st, (size_t)T * V * sB + b, sB, m_s, L_s);
  emit_smoothed<S, N, DIM>(us, stds, (size_t)T * DIM * sB + b, sB, c.pinv0,
                           m_s, L_s);
  for (int k = T - 1; k >= 0; --k) {
    S m_f[N], L_f[N][N], Lp[N][N], G[N][N], mp[N], v[3 * N][N];
    load_state<S, N>(st, (size_t)k * V * sB + b, sB, m_f, L_f);
    const S s2 = load_predicted<S, N>(st, (size_t)(k + 1) * V * sB + b, sB,
                                      Lp);
    backward_shared<S, NQ, DIM, 3 * N>(c, m_f, L_f, Lp,
                                       sqrt_(floor_at(s2, S(0))), G, mp, v);
    S dm[N];
#pragma unroll
    for (int r = 0; r < N; ++r) dm[r] = m_s[r] - mp[r];
#pragma unroll
    for (int r = 0; r < N; ++r) {
      S g = S(0);
#pragma unroll
      for (int l = 0; l < N; ++l) g += G[r][l] * dm[l];
      m_s[r] = m_f[r] + g;
    }
    // rows 2N + l: column l of G L_s
#pragma unroll
    for (int r = 0; r < N; ++r)
#pragma unroll
      for (int l = 0; l < N; ++l) {
        S acc = S(0);
#pragma unroll
        for (int k = 0; k < N; ++k) acc += G[r][k] * L_s[k][l];
        v[2 * N + l][r] = acc;
      }
    mgs_tril<S, N, 3 * N, false>(v, L_s);
    emit_smoothed<S, N, DIM>(us, stds, (size_t)k * DIM * sB + b, sB, c.pinv0,
                             m_s, L_s);
  }
}

// The backward sampler over one member's stream: samples s0 .. s0+ns-1 of
// NS (ns <= SC kept in registers), normals zn (T+1, NS, N, B), into out
// (T+1, NS, DIM, B) as pinv0 x[0 .. DIM-1].
template <typename S, int NQ, int DIM, int SC>
__device__ __forceinline__ void sampler_member(const Consts<S, NQ, DIM>& c,
                                               const S* __restrict__ st,
                                               const S* __restrict__ zn,
                                               S* __restrict__ out, int b,
                                               int B, int T, int NS, int s0) {
  constexpr int N = NQ * DIM;
  constexpr size_t V = Layout<N>::V;
  const size_t sB = (size_t)B;
  const int ns = NS - s0 < SC ? NS - s0 : SC;
  auto zrow = [&](int k, int s) {
    return ((size_t)k * NS + s0 + s) * N * sB + b;
  };
  auto emit = [&](int k, const S (&x)[SC][N]) {
#pragma unroll
    for (int s = 0; s < SC; ++s) {
      if (s >= ns) continue;
      const size_t o = ((size_t)k * NS + s0 + s) * DIM * sB + b;
#pragma unroll
      for (int j = 0; j < DIM; ++j) out[o + j * sB] = c.pinv0 * x[s][j];
    }
  };

  // x_T = m_T + L_T z_T, L_T the filter's full factor
  S x[SC][N];
  {
    S m[N], L[N][N];
    load_state<S, N>(st, (size_t)T * V * sB + b, sB, m, L);
#pragma unroll
    for (int s = 0; s < SC; ++s) {
      if (s >= ns) continue;
      const size_t zo = zrow(T, s);
#pragma unroll
      for (int r = 0; r < N; ++r) {
        S acc = S(0);
#pragma unroll
        for (int k = 0; k < N; ++k) acc += L[r][k] * zn[zo + k * sB];
        x[s][r] = m[r] + acc;
      }
    }
  }
  emit(T, x);

  for (int k = T - 1; k >= 0; --k) {
    S m_f[N], L_f[N][N], Lp[N][N], G[N][N], mp[N], Lc[N][N];
    load_state<S, N>(st, (size_t)k * V * sB + b, sB, m_f, L_f);
    const S s2 = load_predicted<S, N>(st, (size_t)(k + 1) * V * sB + b, sB,
                                      Lp);
    {
      S v[2 * N][N];
      backward_shared<S, NQ, DIM, 2 * N>(c, m_f, L_f, Lp,
                                         sqrt_(floor_at(s2, S(0))), G, mp, v);
      // the conditional factor: the smoothing stack without its G L_s
      // block (the conditioning target has zero covariance)
      mgs_tril<S, N, 2 * N, false>(v, Lc);
    }
#pragma unroll
    for (int s = 0; s < SC; ++s) {
      if (s >= ns) continue;
      const size_t zo = zrow(k, s);
      S dm[N];
#pragma unroll
      for (int r = 0; r < N; ++r) dm[r] = x[s][r] - mp[r];
#pragma unroll
      for (int r = 0; r < N; ++r) {
        S g = S(0), lz = S(0);
#pragma unroll
        for (int l = 0; l < N; ++l) g += G[r][l] * dm[l];
#pragma unroll
        for (int l = 0; l <= r; ++l) lz += Lc[r][l] * zn[zo + l * sB];
        x[s][r] = m_f[r] + g + lz;
      }
    }
    emit(k, x);
  }
}

}  // namespace ek1
