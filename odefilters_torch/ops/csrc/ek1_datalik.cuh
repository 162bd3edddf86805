// Per-member bodies of the dense EK1 data-likelihood kernels
// (ek1_datalik.cu): the joint noisy data update in Joseph square-root form,
// and the reverses of the small factorizations (Cholesky factors, Cholesky
// solves, Gram products) that the adjoint (ek1dl_group.cuh) runs. Their
// plain PyTorch versions, in the same order of operations, are in
// odefilters_torch/ops/ek1_datalik.py (ek1_data_update, mgs_tril_vjp) and
// ek1_fused.py (ek1_step).
//
// The state is flat and derivative-major, N = DIM * NQ entries, with its
// N x N factor L. The observation model is padded to DOBS_MAX rows: rows
// a >= n have C = 0, R = 0 and R R^T = I, so that every loop has a
// compile-time length. The padded rows add exact zeros after the live
// terms of every sum (and a Cholesky block [S 0; 0 I]), so the live
// values are those of the plain version, which has no padded rows.
#pragma once

#include "ek0_datalik_pd.cuh"
#include "ek1_fused.cuh"

namespace ek1dl {

using ek0::cho_solve;
using ek0::floor_at;
using ek0::log_;
using ek0::mgs_tril;
using ek0pd::DOBS_MAX;
constexpr int DM = DOBS_MAX;

// Constants of the three kernels: the preconditioned IBM transition At
// (upper triangular) and noise factor QLt (lower triangular), the
// preconditioner entries of blocks 0 and 1, and the observation model: n
// observed rows of C (DM x DIM), the lower noise factor R and R R^T (formed
// in the working type on the host, as the plain version forms it), and
// l2pi = n log(2 pi), folded in double.
template <typename S, int NQ, int DIM>
struct DlConsts {
  S At[NQ][NQ];
  S QLt[NQ][NQ];
  S pinv0, pinv1;
  int n;
  S C[DM][DIM];
  S R[DM][DM];
  S RRT[DM][DM];
  S l2pi;
};

// Row of the stream: the mean (N), then L row by row (N * N).
template <int N>
struct Layout {
  static constexpr int V = N + N * N;
};

template <typename S, int N>
__device__ __forceinline__ void store_state(S* __restrict__ st, size_t row0,
                                            size_t sB, const S (&m)[N],
                                            const S (&L)[N][N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) st[row0 + r * sB] = m[r];
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int c = 0; c < N; ++c) st[row0 + (N + r * N + c) * sB] = L[r][c];
}

template <typename S, int N>
__device__ __forceinline__ void load_state(const S* __restrict__ st,
                                           size_t row0, size_t sB,
                                           S (&m)[N], S (&L)[N][N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) m[r] = st[row0 + r * sB];
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int c = 0; c < N; ++c) L[r][c] = st[row0 + (N + r * N + c) * sB];
}

// ---------------------------------------------------------------------------
// The data update
// ---------------------------------------------------------------------------

// What the data update's reverse reads of its forward.
template <typename S, int N>
struct UpdRec {
  S z[DM];        // residual y - C P0 m
  S Z[DM][N];     // C P0 L
  S Ls[DM][DM];   // Cholesky factor of Z Z^T + R R^T
  S w[DM];        // S^-1 z
  S Kg[N][DM];    // gain rows (L Z^T)[r] S^-1
  S LZt[N][DM];   // L Z^T
};

// Z Z^T + R R^T (both triangles).
template <typename S, int N>
__device__ __forceinline__ void innov_cov(const S (&Z)[DM][N],
                                          const S (&RRT)[DM][DM],
                                          S (&Sm)[DM][DM]) {
#pragma unroll
  for (int a = 0; a < DM; ++a)
#pragma unroll
    for (int b = 0; b < DM; ++b) {
      S acc = S(0);
#pragma unroll
      for (int c = 0; c < N; ++c) acc += Z[a][c] * Z[b][c];
      Sm[a][b] = acc + RRT[a][b];
    }
}

// The stack [L - K Z | K R]^T, (N + DM) x N: row k < N is column k of
// L - K Z, row N + a column a of K R (zero for a >= n).
template <typename S, int NQ, int DIM>
__device__ __forceinline__ void update_stack(
    const DlConsts<S, NQ, DIM>& c, const S (&L)[NQ * DIM][NQ * DIM],
    const UpdRec<S, NQ * DIM>& u, S (&v)[NQ * DIM + DM][NQ * DIM]) {
  constexpr int N = NQ * DIM;
#pragma unroll
  for (int r = 0; r < N; ++r) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      S kz = u.Kg[r][0] * u.Z[0][k];
#pragma unroll
      for (int a = 1; a < DM; ++a) kz += u.Kg[r][a] * u.Z[a][k];
      v[k][r] = L[r][k] - kz;
    }
#pragma unroll
    for (int a = 0; a < DM; ++a) {
      S acc = S(0);
#pragma unroll
      for (int b = 0; b < DM; ++b)
        if (c.R[b][a] != S(0)) acc += u.Kg[r][b] * c.R[b][a];
      v[N + a][r] = acc;
    }
  }
}

// The joint noisy update of (m, L) in place on the observations y (DM
// entries, zero past n), recording what the reverse reads in u: residual,
// C P0 L, the innovation covariance's Cholesky factor, the gain, and the new
// factor by MGS of update_stack. Returns the data log-likelihood increment
// log N(y; C P0 m, Z Z^T + R R^T) (ek1_datalik.py: ek1_data_update).
template <typename S, int NQ, int DIM>
__device__ __forceinline__ S data_update(const DlConsts<S, NQ, DIM>& c,
                                         const S (&y)[DM],
                                         S (&m)[NQ * DIM],
                                         S (&L)[NQ * DIM][NQ * DIM],
                                         UpdRec<S, NQ * DIM>& u) {
  constexpr int N = NQ * DIM;
#pragma unroll
  for (int a = 0; a < DM; ++a) {
    S yhat = S(0);
#pragma unroll
    for (int j = 0; j < DIM; ++j)
      if (c.C[a][j] != S(0)) yhat += c.C[a][j] * (c.pinv0 * m[j]);
    u.z[a] = y[a] - yhat;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      S acc = S(0);
#pragma unroll
      for (int j = 0; j < DIM; ++j)
        if (c.C[a][j] != S(0)) acc += c.C[a][j] * (c.pinv0 * L[j][k]);
      u.Z[a][k] = acc;
    }
  }
  S Sm[DM][DM];
  innov_cov<S, N>(u.Z, c.RRT, Sm);
  ek1::chol<S, DM>(Sm, u.Ls);
  cho_solve<S, DM>(u.Ls, u.z, u.w);
  S zSz = S(0), logdet = S(0);
#pragma unroll
  for (int a = 0; a < DM; ++a) {
    zSz += u.z[a] * u.w[a];
    if (a < c.n) logdet += S(2) * log_(floor_at(u.Ls[a][a], S(1e-30)));
  }
#pragma unroll
  for (int r = 0; r < N; ++r) {
#pragma unroll
    for (int a = 0; a < DM; ++a) {
      S acc = S(0);
#pragma unroll
      for (int k = 0; k < N; ++k) acc += L[r][k] * u.Z[a][k];
      u.LZt[r][a] = acc;
    }
    cho_solve<S, DM>(u.Ls, u.LZt[r], u.Kg[r]);
    S km = u.Kg[r][0] * u.z[0];
#pragma unroll
    for (int a = 1; a < DM; ++a) km += u.Kg[r][a] * u.z[a];
    m[r] = m[r] + km;
  }
  S v[N + DM][N];
  update_stack<S, NQ, DIM>(c, L, u, v);
  mgs_tril<S, N, N + DM, false>(v, L);
  return S(-0.5) * (zSz + logdet + c.l2pi);
}

// ---------------------------------------------------------------------------
// Reverses of the small factorizations
// ---------------------------------------------------------------------------

// Reverse of ek1::chol on C (its lower triangle read): gL (cotangent of the
// factor L, consumed) adds the cotangent of C's lower triangle to gC. Each
// entry's s is recomputed from C in the forward's order (the pivot's clamp
// at 1e-30 passes no cotangent below it, as torch.clamp's).
template <typename S, int K>
__device__ __forceinline__ void chol_vjp(const S (&C)[K][K],
                                         const S (&L)[K][K], S (&gL)[K][K],
                                         S (&gC)[K][K]) {
#pragma unroll
  for (int i = K - 1; i >= 0; --i)
#pragma unroll
    for (int j = i; j >= 0; --j) {
      S gs;
      if (i == j) {
        S s = C[i][i];
#pragma unroll
        for (int k = 0; k < i; ++k) s = s - L[i][k] * L[i][k];
        gs = s >= S(1e-30) ? gL[i][i] / (S(2) * L[i][i]) : S(0);
      } else {
        gs = gL[i][j] / L[j][j];
        gL[j][j] -= gL[i][j] * L[i][j] / L[j][j];
      }
      gC[i][j] += gs;
#pragma unroll
      for (int k = 0; k < j; ++k) {
        gL[i][k] -= gs * L[j][k];
        gL[j][k] -= gs * L[i][k];
      }
    }
}

// Reverse of ek0::cho_solve(L, b) -> x: from gx (consumed), adds the
// cotangents of b to gb and of L to gL; the forward substitution's y is
// recomputed.
template <typename S, int K>
__device__ __forceinline__ void cho_solve_vjp(const S (&L)[K][K],
                                              const S (&b)[K],
                                              const S (&x)[K], S (&gx)[K],
                                              S (&gb)[K], S (&gL)[K][K]) {
  S y[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    S s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  S gy[K];
#pragma unroll
  for (int i = 0; i < K; ++i) gy[i] = S(0);
  // x[i] = (y[i] - sum_{k > i} L[k][i] x[k]) / L[i][i], i from K-1 down
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const S gs = gx[i] / L[i][i];
    gL[i][i] -= gx[i] * x[i] / L[i][i];
    gy[i] += gs;
#pragma unroll
    for (int k = i + 1; k < K; ++k) {
      gL[k][i] -= gs * x[k];
      gx[k] -= gs * L[k][i];
    }
  }
  // y[i] = (b[i] - sum_{k < i} L[i][k] y[k]) / L[i][i]
#pragma unroll
  for (int i = K - 1; i >= 0; --i) {
    const S gs = gy[i] / L[i][i];
    gL[i][i] -= gy[i] * y[i] / L[i][i];
    gb[i] += gs;
#pragma unroll
    for (int k = 0; k < i; ++k) {
      gL[i][k] -= gs * y[k];
      gy[k] -= gs * L[i][k];
    }
  }
}

// Reverse of a Gram product G = X X^T (K x N) of which only the lower
// triangle is read: adds to gX.
template <typename S, int K, int N>
__device__ __forceinline__ void gram_vjp(const S (&X)[K][N],
                                         const S (&gG)[K][K],
                                         S (&gX)[K][N]) {
#pragma unroll
  for (int a = 0; a < K; ++a)
#pragma unroll
    for (int b = 0; b <= a; ++b)
#pragma unroll
      for (int c = 0; c < N; ++c) {
        gX[a][c] += gG[a][b] * X[b][c];
        gX[b][c] += gG[a][b] * X[a][c];
      }
}

}  // namespace ek1dl
