// Per-member bodies of the adaptive dense EK1 kernels (ek1_adaptive.cu): one
// attempt of the PI-controlled EK1(dynamic) step loop, the accepted-step
// stream row, and one square-root RTS step over a member's accepted steps
// with its backward walk. Their plain PyTorch versions, in the same order of
// operations, are in odefilters_torch/ops/ek1_adaptive.py (attempt,
// smoother_step, ek1_adaptive_smoother_plain).
//
// The loop is the adaptive EK0 kernels' (ek0_adaptive.cuh: begin, control,
// the save grid without a barrier, the compacted stream); the step is the
// fixed-grid EK1 filter's (ek1_fused.cuh: filter_step, with the field's
// Jacobian in the kernel) at each attempt's preconditioner. The state is
// flat and derivative-major, N = DIM * NQ entries, carried unpreconditioned;
// the D x D covariance is carried as a factor L (C = L L^T, not
// triangular), so preconditioning scales its rows only (scaling its columns
// too would change L L^T whenever the step changes: the JAX kernel's
// comment records stds that shrank 1e-5x over ~100 steps so). The backward
// step recomputes the predicted factor by the forward's MGS and uses the
// streamed factor directly, with no re-factorisation.
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
struct Row {
  S m[N], L[N][N];
  S lh, s2, mark;
};

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

template <typename S, int N>
__device__ __forceinline__ void load_row(const S* __restrict__ st,
                                         size_t row0, size_t sB,
                                         Row<S, N>& r) {
  int v = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) r.m[i] = st[row0 + (v++) * sB];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k) r.L[i][k] = st[row0 + (v++) * sB];
  r.lh = st[row0 + (v++) * sB];
  r.s2 = st[row0 + (v++) * sB];
  r.mark = st[row0 + v * sB];
}

// One square-root RTS step (ek1_adaptive.py: smoother_step) from the
// filtered state (m_f, L_f) of an accepted step to the smoothed (ms, Ls) of
// the next one, with the next step's lh (log dt_eff) and s2, in place, in
// the frame preconditioned at the next step's size (rows scaled): the
// predicted factor by the forward's 2N x N MGS, the gain by Cholesky
// solves against it (ek1_fused.cuh: backward_shared), the smoothed factor
// by a 3N x N MGS.
template <typename S, int NQ, int DIM>
__device__ __forceinline__ void smoother_step(
    const AdaptConsts<S, NQ>& c, const S (&m_f)[NQ * DIM],
    const S (&L_f)[NQ * DIM][NQ * DIM], S lh, S s2, S (&ms)[NQ * DIM],
    S (&Ls)[NQ * DIM][NQ * DIM]) {
  constexpr int N = NQ * DIM;
  constexpr double QH = NQ - 0.5;
  S ps_[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) ps_[i] = exp_(S(i - QH) * lh);
  S mh[N], Lh[N][N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    mh[r] = m_f[r] * ps_[r / DIM];
#pragma unroll
    for (int k = 0; k < N; ++k) Lh[r][k] = L_f[r][k] * ps_[r / DIM];
  }
  const S sq = sqrt_(floor_at(s2, S(0)));
  S G[N][N], mp[N], v[3 * N][N];
  {
    S Lp[N][N];
    ek1::predict_lp<S, NQ, DIM>(c, Lh, sq, Lp);
    ek1::backward_shared<S, NQ, DIM, 3 * N>(c, mh, Lh, Lp, sq, G, mp, v);
  }
  S ms_new[N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    S g = S(0);
#pragma unroll
    for (int l = 0; l < N; ++l) g += G[r][l] * (ms[l] * ps_[l / DIM] - mp[l]);
    ms_new[r] = mh[r] + g;
  }
  // rows 2N + l: column l of G Lsh, Lsh the smoothed factor's rows scaled
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int l = 0; l < N; ++l) {
      S acc = S(0);
#pragma unroll
      for (int k = 0; k < N; ++k) acc += G[r][k] * (ps_[k / DIM] * Ls[k][l]);
      v[2 * N + l][r] = acc;
    }
  S Ls_new[N][N];
  ek0::mgs_tril<S, N, 3 * N, false>(v, Ls_new);
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const S pinv = exp_(S(QH - r / DIM) * lh);
    ms[r] = pinv * ms_new[r];
#pragma unroll
    for (int k = 0; k < N; ++k) Ls[r][k] = pinv * Ls_new[r][k];
  }
}

// The backward pass of member b (ek1_adaptive.py:
// ek1_adaptive_smoother_plain) over its K accepted rows of the stream st
// (max_iters, V, B), rows K - 1 .. 0, into us and stds (S+1, DIM, B): row 0
// the exact initial state with std 0, each save row the smoothed state of
// the step that reached it, the rows past the segs save points reached the
// last accepted step's filtered state.
template <typename S, int NQ, int DIM>
__device__ __forceinline__ void smooth_member(const AdaptConsts<S, NQ>& c,
                                              const S* __restrict__ st,
                                              const S* __restrict__ m0,
                                              S* __restrict__ us,
                                              S* __restrict__ stds, int K,
                                              int segs, int b, size_t sB) {
  constexpr int N = NQ * DIM;
  constexpr size_t V = Layout<N>::V;
  Row<S, N> r;
  auto emit = [&](int k, const S (&m)[N], const S (&L)[N][N], bool zero) {
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      us[((size_t)k * DIM + j) * sB + b] = m[j];
      stds[((size_t)k * DIM + j) * sB + b] =
          zero ? S(0) : std_row<S, N, DIM>(L, j);
    }
  };
#pragma unroll
  for (int j = 0; j < DIM; ++j) r.m[j] = m0[j * sB + b];
  emit(0, r.m, r.L, true);
  if (K == 0) {
    for (int k = 1; k <= c.n_save; ++k) emit(k, r.m, r.L, true);
    return;
  }
  load_row<S, N>(st, (size_t)(K - 1) * V * sB + b, sB, r);
  // the last accepted step: smoothed = filtered
  S ms[N], Ls[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    ms[i] = r.m[i];
#pragma unroll
    for (int k = 0; k < N; ++k) Ls[i][k] = r.L[i][k];
  }
  for (int k = segs + 1; k <= c.n_save; ++k) emit(k, ms, Ls, false);
  if (r.mark > S(0.5)) emit((int)r.mark, ms, Ls, false);
  S pend_lh = r.lh, pend_s2 = r.s2;
  for (int k = K - 2; k >= 0; --k) {
    load_row<S, N>(st, (size_t)k * V * sB + b, sB, r);
    smoother_step<S, NQ, DIM>(c, r.m, r.L, pend_lh, pend_s2, ms, Ls);
    pend_lh = r.lh;
    pend_s2 = r.s2;
    if (r.mark > S(0.5)) emit((int)r.mark, ms, Ls, false);
  }
}

}  // namespace ek1a
