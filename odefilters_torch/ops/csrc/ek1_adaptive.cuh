// Per-member bodies of the adaptive dense EK1 kernels' forwards
// (ek1_adaptive.cu): one attempt of the PI-controlled EK1(dynamic) step loop
// and the accepted-step stream row (the smoother spreads a member over a
// group of lanes: ek1_adaptive_group.cuh). Their plain PyTorch versions, in
// the same order of operations, are in odefilters_torch/ops/ek1_adaptive.py
// (attempt, ek1_adaptive_stream_plain).
//
// The loop is the adaptive EK0 kernels' (ek0_adaptive.cuh: begin, control,
// the save grid without a barrier, the compacted stream); the step is the
// fixed-grid EK1 filter's (ek1_fused.cuh: filter_step, with the field's
// Jacobian in the kernel) at each attempt's preconditioner. The state is
// flat and derivative-major, N = DIM * NQ entries, carried unpreconditioned;
// the D x D covariance is carried as a factor L (C = L L^T, not
// triangular), so preconditioning scales its rows only (scaling its columns
// too would change L L^T whenever the step changes: the JAX kernel's
// comment records stds that shrank 1e-5x over ~100 steps so).
#pragma once

#include "ek0_adaptive.cuh"
#include "ek1_fused.cuh"

namespace ek1a {

using ek0::AdaptConsts;
using ek0::exp_;
using ek0::floor_at;
using ek0::sqrt_;

// Row of the accepted-step stream: m (N) | L (N*N, row-major) | log dt_eff |
// s2 | save index (75 at NQ = 4, DIM = 2).
template <int N>
struct Layout {
  static constexpr int V = N + N * N + 3;
};

// The member: m (N) and the factor L (N x N), unpreconditioned.
template <typename S, int NQ, int DIM>
struct Member : ek0::Progress<S, DIM> {
  S m[NQ * DIM], L[NQ * DIM][NQ * DIM];
};

// One attempt of a live member (ek1_adaptive.py: attempt): ek0::begin, the
// EK1 step on the state preconditioned at the attempt's step (rows only),
// the error estimate err_j = sqrt(s2 (H Q H^T)_jj), ek0::control, and the
// commit of the mean and the factor.
template <typename S, int NQ, class F>
__device__ __forceinline__ void attempt(const AdaptConsts<S, NQ>& c,
                                        const S* p,
                                        Member<S, NQ, F::D>& st,
                                        ek0::AttemptOut<S>& o) {
  constexpr int DIM = F::D;
  constexpr int N = NQ * DIM;
  constexpr double QH = NQ - 0.5;  // q + 1/2
  S ps_[NQ];
  const ek0::Begin<S> a = ek0::begin<S, NQ, DIM>(c, st, ps_);
  S m[N], L[N][N], Lp[N][N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    m[r] = st.m[r] * ps_[r / DIM];
#pragma unroll
    for (int k = 0; k < N; ++k) L[r][k] = st.L[r][k] * ps_[r / DIM];
  }
  const S pinv0 = exp_(S(QH) * a.lh);
  const S pinv1 = exp_(S(QH - 1) * a.lh);
  ek1::StepStats<S, DIM> ss;
  const S s2 = ek1::filter_step<S, NQ, F, false>(c, pinv0, pinv1, p, a.t_new,
                                                 nullptr, m, L, Lp, &ss);
  S u_filt[DIM], err[DIM];
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    u_filt[j] = pinv0 * m[j];
    err[j] = sqrt_(floor_at(s2 * ss.hqh[j], S(0)));
  }
  // -- un-precondition (rows only), then commit --
  if (ek0::control<S, NQ, DIM>(c, a, err, u_filt, ss.ll_inc, st, o)) {
#pragma unroll
    for (int r = 0; r < N; ++r) {
      st.m[r] = m[r] / ps_[r / DIM];
#pragma unroll
      for (int k = 0; k < N; ++k) st.L[r][k] = L[r][k] / ps_[r / DIM];
    }
  }
  o.lh = a.lh;
  o.s2 = s2;
}

template <typename S, int NQ, int NP, int DIM>
__device__ __forceinline__ void start_member(const S* __restrict__ m0,
                                             const S* __restrict__ ps,
                                             const S* __restrict__ dt0s,
                                             int b, size_t sB,
                                             const AdaptConsts<S, NQ>& c,
                                             S (&p)[NP],
                                             Member<S, NQ, DIM>& st) {
  constexpr int N = NQ * DIM;
#pragma unroll
  for (int k = 0; k < NP; ++k) p[k] = ps[k * sB + b];
  S m[NQ][DIM];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    st.m[r] = m[r / DIM][r % DIM] = m0[r * sB + b];
#pragma unroll
    for (int k = 0; k < N; ++k) st.L[r][k] = S(0);
  }
  ek0::start_progress<S, NQ, DIM>(m, dt0s, b, c, st);
}

// Each dimension's std of block 0: the norms of the factor's first DIM
// rows.
template <typename S, int N, int DIM>
__device__ __forceinline__ S std_row(const S (&L)[N][N], int j) {
  S acc = S(0);
#pragma unroll
  for (int k = 0; k < N; ++k) acc += L[j][k] * L[j][k];
  return sqrt_(acc);
}

template <typename S, int N>
__device__ __forceinline__ void store_row(S* __restrict__ st, size_t row0,
                                          size_t sB, const S (&m)[N],
                                          const S (&L)[N][N], S lh, S s2,
                                          S mark) {
  int v = 0;
#pragma unroll
  for (int r = 0; r < N; ++r) st[row0 + (v++) * sB] = m[r];
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int k = 0; k < N; ++k) st[row0 + (v++) * sB] = L[r][k];
  st[row0 + (v++) * sB] = lh;
  st[row0 + (v++) * sB] = s2;
  st[row0 + v * sB] = mark;
}

}  // namespace ek1a
