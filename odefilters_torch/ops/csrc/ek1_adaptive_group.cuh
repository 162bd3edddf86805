// The backward pass of the adaptive dense EK1 solve with a group of
// N = NQ DIM lanes per member (ek1_adaptive.cu:
// ek1_adaptive_smoother_kernel). Each entry is formed by the operations of
// its plain version (odefilters_torch/ops/ek1_adaptive.py: smoother_step,
// ek1_adaptive_smoother_plain) in the same order, so the two are bit for
// bit.
//
// Lane r of a member owns row r of the filtered factor preconditioned at
// the next step's size (Lh), of A Lh, of the predicted factor Lp, of the
// gain and of the smoothed factor L_s, entry r of the means, and column r
// of each Gram-Schmidt stack (group_mgs.cuh): the 2N x N one that
// recomputes Lp as the forward did, and the 3N x N one of the smoothed
// factor. The members of a CTA sit at different rows of the stream (each
// walks its own accepted steps, nacc - 1 down to 0) and finish at
// different times, so each member runs on its own: its lanes read its
// row's V values together (lane r the values r, r + N, ...) into the
// member's shared memory, the next row's loads in flight while the current
// step computes, and every barrier is the member's own (no CTA-wide or
// warp-wide one).
#pragma once

#include "ek1_adaptive.cuh"  // ek1a::Layout, ek0::AdaptConsts, exp_
#include "ek1_group.cuh"     // ek1g::MemberSync, ek1g::Tile

namespace ek1ag {

using ek0::AdaptConsts;
using ek1::a_live;
using ek1::q_live;

// A member's shared memory: its stream row (V values), Lh, A Lh, Lp and
// L_s (N x N, rows contiguous and 16-byte aligned, read a row at a time in
// 16-byte loads), the smoothed and predicted means, the step's
// preconditioner entries (NQ) and their inverses (NQ), the Gram-Schmidt
// buffers (two of the 3N x N stack's columns, which the 2N x N one's fit
// in); 4 values of padding.
template <int NQ, int DIM>
struct MemberWs {
  static constexpr int N = NQ * DIM;
  static constexpr int P = N;
  static constexpr int ROW = 0, LH = (ek1a::Layout<N>::V + 3) / 4 * 4,
                       AL = LH + N * N, LP = AL + N * N, LS = LP + N * N,
                       MS = LS + N * N, MP = MS + (N + 3) / 4 * 4,
                       PS = MP + (N + 3) / 4 * 4,
                       Q = PS + (2 * NQ + 3) / 4 * 4, SIZE = Q + 2 * 3 * N + 4;
};

template <typename S, int NQ, int DIM, int MB>
constexpr size_t smoother_smem_bytes() {
  return (size_t)MB * MemberWs<NQ, DIM>::SIZE * sizeof(S);
}

// The backward pass over each member's K accepted rows of the stream st
// (max_iters, V, B), rows K - 1 .. 0, into us and stds (S+1, DIM, B): row
// 0 the exact initial state with std 0, each save row the smoothed state
// of the step that reached it, the rows past the segs save points reached
// the last accepted step's filtered state. MB members a CTA, N lanes a
// member; counts (4, B) hold K and segs.
template <typename S, int NQ, int DIM, int MB>
__device__ __forceinline__ void smoother_group(const AdaptConsts<S, NQ>& c,
                                               const S* __restrict__ st,
                                               const int* __restrict__ counts,
                                               const S* __restrict__ m0,
                                               S* __restrict__ us,
                                               S* __restrict__ stds, int B) {
  constexpr int N = NQ * DIM;
  constexpr int V = ek1a::Layout<N>::V;
  constexpr int PER = (V + N - 1) / N;  // row values a lane loads
  constexpr int LH_AT = N + N * N;      // the row's log dt_eff, s2, index
  constexpr double QH = NQ - 0.5;       // q + 1/2
  using W = MemberWs<NQ, DIM>;
  constexpr int P = W::P;
  extern __shared__ __align__(16) unsigned char ek1ag_smem[];
  const int tid = threadIdx.x, m = tid / N, r = tid % N;
  const int b = blockIdx.x * MB + m;
  if (b >= B) return;  // whole members: no barrier spans two of them
  S* ws = reinterpret_cast<S*>(ek1ag_smem) + m * W::SIZE;
  S* sRow = ws + W::ROW;
  S* sLh = ws + W::LH;
  S* sAL = ws + W::AL;
  S* sLp = ws + W::LP;
  S* sLs = ws + W::LS;
  S* sMs = ws + W::MS;
  S* sMp = ws + W::MP;
  S* sPs = ws + W::PS;
  S* q = ws + W::Q;
  const ek1g::MemberSync<N> sync;
  const size_t sB = (size_t)B;
  const int K = counts[b], segs = counts[3 * sB + b];
  const int rd = r % DIM, rq = r / DIM;
  S arow[NQ];
#pragma unroll
  for (int mq = 0; mq < NQ; ++mq) arow[mq] = c.At[rq][mq];

  // lane r < DIM writes dimension r of the solution at save row k
  auto emit = [&](int k, S mean, S sd) {
    if (r < DIM) {
      const size_t o = ((size_t)k * DIM + r) * sB + b;
      us[o] = mean;
      stds[o] = sd;
    }
  };
  auto std_of = [&](const S (&lrow)[N]) {
    S acc = S(0);
#pragma unroll
    for (int k = 0; k < N; ++k) acc += lrow[k] * lrow[k];
    return ek0::sqrt_(acc);
  };
  S reg[PER];
  auto fetch = [&](int k) {
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (r + N * i < V) reg[i] = st[((size_t)k * V + r + N * i) * sB + b];
  };
  auto put = [&]() {
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (r + N * i < V) sRow[r + N * i] = reg[i];
  };

  const S first = r < DIM ? m0[r * sB + b] : S(0);
  emit(0, first, S(0));
  if (K == 0) {
    for (int k = 1; k <= c.n_save; ++k) emit(k, first, S(0));
    return;
  }
  fetch(K - 1);
  put();
  sync();
  // the last accepted step: smoothed = filtered
  S ms = sRow[r];
  S ls[N];
#pragma unroll
  for (int j = 0; j < N; ++j) ls[j] = sRow[N + r * N + j];
  sMs[r] = ms;
  grp::st<S, N>(sLs + r * P, ls);
  {
    const S sd = std_of(ls);
    for (int k = segs + 1; k <= c.n_save; ++k) emit(k, ms, sd);
    const S mark = sRow[LH_AT + 2];
    if (mark > S(0.5)) emit((int)mark, ms, sd);
  }
  S pend_lh = sRow[LH_AT], pend_s2 = sRow[LH_AT + 1];
  if (K > 1) fetch(K - 2);
  for (int k = K - 2; k >= 0; --k) {
    // the member's lanes are done with row k+1 and the last step's work
    sync();
    put();
    // the step's preconditioner and its inverse, once a member
    for (int i = r; i < 2 * NQ; i += N)
      sPs[i] = i < NQ ? ek0::exp_(S(i - QH) * pend_lh)
                      : ek0::exp_(S(QH - (i - NQ)) * pend_lh);
    sync();
    if (k > 0) fetch(k - 1);
    S ps_[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) ps_[i] = sPs[i];
    // (ek1_adaptive.py: smoother_step) row r of Lh and of A Lh, entry r of
    // the predicted mean A mh
    S lh[N];
#pragma unroll
    for (int kk = 0; kk < N; ++kk) lh[kk] = sRow[N + r * N + kk] * ps_[rq];
    grp::st<S, N>(sLh + r * P, lh);
    {
      S acc = S(0);
#pragma unroll
      for (int mq = 0; mq < NQ; ++mq)
        if (mq >= rq) acc += arow[mq] * (sRow[rd + DIM * mq] * ps_[mq]);
      sMp[r] = acc;
    }
    sync();
    const S sq = ek0::sqrt_(ek0::floor_at(pend_s2, S(0)));
    {
      // column r of the prediction stack [(A Lh)^T; (sq QLf)^T]: row r of
      // A Lh (row r of A = kron(At, I) live at cc = rd + DIM m, m >= rq, in
      // ascending cc), row r of sq QLf
      S col[1][2 * N], lp[1][N];
#pragma unroll
      for (int kk = 0; kk < N; ++kk) {
        S al = S(0);
#pragma unroll
        for (int mq = 0; mq < NQ; ++mq)
          if (mq >= rq) al += arow[mq] * sLh[(rd + DIM * mq) * P + kk];
        col[0][kk] = al;
        col[0][N + kk] =
            q_live<DIM>(r, kk) ? sq * c.QLt[rq][kk / DIM] : S(0);
      }
#pragma unroll
      for (int kk = 0; kk < N; ++kk) sAL[r * P + kk] = col[0][kk];
      grp::mgs_rows<S, N, 2 * N, 1, true>(col, N, r, q, lp, sync);
      grp::st<S, N>(sLp + r * P, lp[0]);
    }
    sync();
    // row r of the gain G = Lh (A Lh)^T (Lp Lp^T)^-1
    S g[N];
    {
      S M[N], y[N];
#pragma unroll
      for (int l = 0; l < N; ++l) {
        S row[N];
        grp::ld<S, N>(sAL + l * P, row);
        S acc = S(0);
#pragma unroll
        for (int kk = 0; kk < N; ++kk) acc += lh[kk] * row[kk];
        M[l] = acc;
      }
#pragma unroll
      for (int i = 0; i < N; ++i) {
        S s = M[i];
#pragma unroll
        for (int kk = 0; kk < i; ++kk) s = s - sLp[i * P + kk] * y[kk];
        y[i] = s / sLp[i * P + i];
      }
#pragma unroll
      for (int i = N - 1; i >= 0; --i) {
        S s = y[i];
#pragma unroll
        for (int kk = i + 1; kk < N; ++kk) s = s - sLp[kk * P + i] * g[kk];
        g[i] = s / sLp[i * P + i];
      }
    }
    // column r of the smoothing stack: rows l of (I - G A) Lh, N + l of
    // sq G QLf, 2N + l of G Lsh (Lsh: L_s's rows scaled by ps_)
    S col[1][3 * N];
    {
      S iga[N];
#pragma unroll
      for (int l = 0; l < N; ++l) {
        S ga = S(0);
#pragma unroll
        for (int kk = 0; kk < N; ++kk)
          if (a_live<DIM>(kk, l)) ga += g[kk] * c.At[kk / DIM][l / DIM];
        iga[l] = (r == l ? S(1) : S(0)) - ga;
      }
      // sums over kk in index order, a row of Lh (of L_s) at a time
#pragma unroll
      for (int l = 0; l < N; ++l) col[0][l] = col[0][2 * N + l] = S(0);
#pragma unroll
      for (int kk = 0; kk < N; ++kk) {
        S row[N];
        grp::ld<S, N>(sLh + kk * P, row);
#pragma unroll
        for (int l = 0; l < N; ++l) col[0][l] += iga[kk] * row[l];
        grp::ld<S, N>(sLs + kk * P, row);
#pragma unroll
        for (int l = 0; l < N; ++l)
          col[0][2 * N + l] += g[kk] * (ps_[kk / DIM] * row[l]);
      }
#pragma unroll
      for (int l = 0; l < N; ++l) {
        S gq = S(0);
#pragma unroll
        for (int kk = 0; kk < N; ++kk)
          if (q_live<DIM>(kk, l)) gq += g[kk] * c.QLt[kk / DIM][l / DIM];
        col[0][N + l] = sq * gq;
      }
    }
    // entry r of the smoothed mean in the preconditioned frame
    S ms_new;
    {
      S gs = S(0);
#pragma unroll
      for (int l = 0; l < N; ++l)
        gs += g[l] * (sMs[l] * ps_[l / DIM] - sMp[l]);
      ms_new = sRow[r] * ps_[rq] + gs;
    }
    const S row_lh = sRow[LH_AT], row_s2 = sRow[LH_AT + 1],
            mark = sRow[LH_AT + 2];
    // the Gram-Schmidt's first barrier orders every lane's reads of m_s
    // and L_s above before the writes below
    S L[1][N];
    grp::mgs_rows<S, N, 3 * N, 1, false>(col, N, r, q, L, sync);
    const S pinv = sPs[NQ + rq];
    ms = pinv * ms_new;
#pragma unroll
    for (int j = 0; j < N; ++j) ls[j] = pinv * L[0][j];
    sMs[r] = ms;
    grp::st<S, N>(sLs + r * P, ls);
    if (mark > S(0.5)) emit((int)mark, ms, std_of(ls));
    pend_lh = row_lh;
    pend_s2 = row_s2;
  }
}

}  // namespace ek1ag
