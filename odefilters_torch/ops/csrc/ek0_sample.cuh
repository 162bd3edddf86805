// Per-member bodies of the joint-posterior sampler's kernels
// (ek0_sample.cu): the square-root EK0 filter step that streams
// (mean | factor | s2) rows, and the backward conditioning step. Their
// plain PyTorch versions, in the same order of operations, are in
// odefilters_torch/ops/ek0_sample.py (filter_states_step, sampler_step,
// list_mgs_tril, list_cho_solve).
#pragma once

#include "ek0_common.cuh"

namespace ek0 {

// Constants of both kernels: the preconditioned IBM transition (upper
// triangular) and its noise factor QLt (lower triangular), the
// preconditioner entries of blocks 0 and 1, the grid, pb2 = pinv1^2 folded
// in double, and inv_dhq = 1 / (D hq) taken in the working type from the
// rounded divisor, as PyTorch's CUDA division by a Python number does.
template <typename S, int NQ>
struct SampleConsts {
  S At[NQ][NQ];
  S QLt[NQ][NQ];
  S pinv0, pinv1, t0, dt, pb2, inv_dhq;
};

// Row of the filter-states stream: mean (NQ*D) | factor (NQ*NQ) | s2.
template <int NQ, int D>
struct StatesLayout {
  static constexpr int V = NQ * D + NQ * NQ + 1;
};

template <typename S, int NQ, int D>
__device__ __forceinline__ void store_states(S* __restrict__ st, size_t row0,
                                             size_t sB, const S (&m)[NQ][D],
                                             const S (&L)[NQ][NQ], S s2) {
  int v = 0;
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) st[row0 + (v++) * sB] = m[i][j];
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int l = 0; l < NQ; ++l) st[row0 + (v++) * sB] = L[i][l];
  st[row0 + v * sB] = s2;
}

template <typename S, int NQ, int D>
__device__ __forceinline__ void load_states(const S* __restrict__ st,
                                            size_t row0, size_t sB,
                                            S (&m)[NQ][D], S (&L)[NQ][NQ],
                                            S& s2) {
  int v = 0;
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) m[i][j] = st[row0 + (v++) * sB];
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int l = 0; l < NQ; ++l) L[i][l] = st[row0 + (v++) * sB];
  s2 = st[row0 + v * sB];
}

// Structural zeros of a K x N stack [X^T; (sqrt(s2) QL)^T; ...] (TRI): row
// N + a is zero in the columns i < a, since the noise factor QL is lower
// triangular. The modified Gram-Schmidt below never fills them in: a row's
// first live column comes before any column it is updated in. (For EK1's
// QL = kron(QLt, I_d), the other zeros of row N + a are filled in when
// column a is reduced, before their own columns come: they are stored as
// zeros and updated as any entry.)
template <int N, bool TRI>
__device__ __forceinline__ constexpr bool stack_zero(int k, int j) {
  return TRI && k >= N && j < k - N;
}

// Lower factor L (L L^T = M^T M) of the K x N stack M = v by modified
// Gram-Schmidt: pivots sqrt(max(ss, 1e-30)) and their reciprocals 1 / R;
// the terms through structural zeros are skipped at compile time. With
// diag_sq (TRI stacks only), the square of row N + j's entry in column j,
// the only one still untouched when column j is reduced, is taken from
// diag_sq[j] instead (a constant squared in double: the static diffusion
// models' stack holds the noise factor as constants). v is overwritten.
template <typename S, int N, int K, bool TRI>
__device__ __forceinline__ void mgs_tril(S (&v)[K][N], S (&L)[N][N],
                                         const S* diag_sq = nullptr) {
  S R[N][N];
  S qcol[K];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    S ss = S(0);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (!stack_zero<N, TRI>(k, j))
        ss += (TRI && k == N + j && diag_sq) ? diag_sq[j] : v[k][j] * v[k][j];
    R[j][j] = sqrt_(floor_at(ss, S(1e-30)));
    const S inv = S(1) / R[j][j];
#pragma unroll
    for (int k = 0; k < K; ++k)
      qcol[k] = stack_zero<N, TRI>(k, j) ? S(0) : v[k][j] * inv;
#pragma unroll
    for (int l = j + 1; l < N; ++l) {
      S r = S(0);
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (!stack_zero<N, TRI>(k, j)) r += qcol[k] * v[k][l];
      R[j][l] = r;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (!stack_zero<N, TRI>(k, j)) v[k][l] = v[k][l] - r * qcol[k];
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int l = 0; l < N; ++l) L[i][l] = l <= i ? R[l][i] : S(0);
}

// Solve L L^T x = b: forward and back substitution dividing by the pivots.
template <typename S, int NQ>
__device__ __forceinline__ void cho_solve(const S (&L)[NQ][NQ],
                                          const S (&b)[NQ], S (&x)[NQ]) {
  S y[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    S s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = NQ - 1; i >= 0; --i) {
    S s = y[i];
#pragma unroll
    for (int k = i + 1; k < NQ; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// X' = At X over At's upper triangle, for X of NC columns.
template <typename S, int NQ, int NC>
__device__ __forceinline__ void at_times(const S (&At)[NQ][NQ],
                                         const S (&X)[NQ][NC],
                                         S (&Y)[NQ][NC]) {
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      S acc = S(0);
#pragma unroll
      for (int a = i; a < NQ; ++a) acc += At[i][a] * X[a][c];
      Y[i][c] = acc;
    }
}

// The predicted factor Lp of [(At L)^T; (sq QLt)^T], with AtL = At L.
template <typename S, int NQ>
__device__ __forceinline__ void predicted_factor(const SampleConsts<S, NQ>& c,
                                                 const S (&AtL)[NQ][NQ], S sq,
                                                 S (&Lp)[NQ][NQ]) {
  S v[2 * NQ][NQ];
#pragma unroll
  for (int k = 0; k < NQ; ++k)
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      v[k][i] = AtL[i][k];
      v[NQ + k][i] = i >= k ? sq * c.QLt[i][k] : S(0);
    }
  mgs_tril<S, NQ, 2 * NQ, true>(v, Lp);
}

// One square-root EK0 step with the dynamic diffusion from (m, L): predict
// the mean, evaluate the field at the predicted state, calibrate
// s2 = |z|^2 / (D hq), factor the predicted covariance, update the mean and
// the full factor L_new = Lp - kg (pb Lp[BX])^T in place. Returns s2.
template <typename S, int NQ, class F>
__device__ __forceinline__ S filter_states_step(const SampleConsts<S, NQ>& c,
                                                const S* p, S t,
                                                S (&m)[NQ][F::D],
                                                S (&L)[NQ][NQ]) {
  constexpr int D = F::D;
  const S pb = c.pinv1;
  S mp[NQ][D];
  at_times<S, NQ, D>(c.At, m, mp);
  S u[D], du[D], z[D];
#pragma unroll
  for (int j = 0; j < D; ++j) u[j] = c.pinv0 * mp[0][j];
  F()(u, p, t, du);
#pragma unroll
  for (int j = 0; j < D; ++j) z[j] = innovation(pb, mp[BX][j], du[j]);
  S zz = S(0);
#pragma unroll
  for (int j = 0; j < D; ++j) zz += z[j] * z[j];
  const S s2 = zz * c.inv_dhq;

  S AtL[NQ][NQ], Lp[NQ][NQ];
  at_times<S, NQ, NQ>(c.At, L, AtL);
  predicted_factor<S, NQ>(c, AtL, sqrt_(s2), Lp);
  S s = S(0);
#pragma unroll
  for (int l = 0; l < NQ; ++l) s += Lp[BX][l] * Lp[BX][l];
  s = c.pb2 * s;
  const S inv_s = S(1) / s;
  S kg[NQ], Zrow[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    S cc = S(0);
#pragma unroll
    for (int l = 0; l < NQ; ++l) cc += Lp[i][l] * Lp[BX][l];
    kg[i] = pb * cc * inv_s;
    Zrow[i] = pb * Lp[BX][i];
  }
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) m[i][j] = mp[i][j] - kg[i] * z[j];
#pragma unroll
    for (int l = 0; l < NQ; ++l) L[i][l] = Lp[i][l] - kg[i] * Zrow[l];
  }
  return s2;
}

// The sample-independent work of one backward step from the filtered state
// (m_f, L_f) at t_k, with sq = sqrt of the diffusion of interval k -> k+1:
// the gain G = C_f At^T (Lp Lp^T)^-1 (one Cholesky solve per row), the
// predicted mean mp, and the conditional factor Lc of
// [((I - G At) L_f)^T; (sq G QLt)^T].
template <typename S, int NQ, int D>
__device__ __forceinline__ void sampler_shared(const SampleConsts<S, NQ>& c,
                                               const S (&m_f)[NQ][D],
                                               const S (&L_f)[NQ][NQ], S sq,
                                               S (&G)[NQ][NQ],
                                               S (&mp)[NQ][D],
                                               S (&Lc)[NQ][NQ]) {
  S AtL[NQ][NQ], Lp[NQ][NQ];
  at_times<S, NQ, NQ>(c.At, L_f, AtL);
  predicted_factor<S, NQ>(c, AtL, sq, Lp);
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    S M[NQ];
#pragma unroll
    for (int l = 0; l < NQ; ++l) {
      S acc = S(0);
#pragma unroll
      for (int b = 0; b < NQ; ++b) acc += L_f[i][b] * AtL[l][b];
      M[l] = acc;
    }
    cho_solve<S, NQ>(Lp, M, G[i]);
  }
  at_times<S, NQ, D>(c.At, m_f, mp);

  // the stack's rows: row k holds column k of (I - G At) L_f, row NQ + k
  // column k of sq G QLt
  S v[2 * NQ][NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    S IGA[NQ];
#pragma unroll
    for (int l = 0; l < NQ; ++l) {
      S ga = S(0);
#pragma unroll
      for (int k = 0; k < NQ; ++k) ga += G[i][k] * c.At[k][l];
      IGA[l] = (i == l ? S(1) : S(0)) - ga;
    }
#pragma unroll
    for (int l = 0; l < NQ; ++l) {
      S b1 = S(0), gq = S(0);
#pragma unroll
      for (int k = 0; k < NQ; ++k) b1 += IGA[k] * L_f[k][l];
#pragma unroll
      for (int a = l; a < NQ; ++a) gq += G[i][a] * c.QLt[a][l];
      v[l][i] = b1;
      v[NQ + l][i] = sq * gq;
    }
  }
  mgs_tril<S, NQ, 2 * NQ, false>(v, Lc);
}

}  // namespace ek0
