// The backward passes of the fused EK1 solve with a group of N = NQ DIM
// lanes per member (ek1_fused.cu: ekd_smoother_kernel, ekd_sampler_kernel).
// Each entry is formed by the operations of its plain version
// (odefilters_torch/ops/ek1_fused.py: ekd_smoother_plain,
// ekd_sampler_plain) in the same order, so the two are bit for bit.
//
// Lane r of a member owns row r of the gain G and of A L_f, entry r of the
// means, and column r of the Gram-Schmidt stack (group_mgs.cuh): the gain's
// N Cholesky solves become one per lane, on its own row. The smoother's
// stack is 3N x N, and lane r also owns row r of the smoothed factor L_s;
// the sampler's is 2N x N (the conditional factor L_c, of which lane r owns
// row r), and lane r also owns entry r of each of its samples, so that a
// step's gain and conditional factor are formed once for all of them. A CTA
// holds MB members: it stages each step's stream row of its members (and
// the sampler's normals) in shared memory with loads that run along the
// contiguous member index, the next row's loads in flight (in registers)
// while the current step computes.
#pragma once

#include "ek1_fused.cuh"    // ek1::Consts, ek1::Layout, a_live, q_live
#include "group_mgs.cuh"    // grp::mgs_rows

namespace ek1g {

using ek1::a_live;
using ek1::Consts;
using ek1::Layout;
using ek1::q_live;

// Members per CTA: the staged rows of 32 float32 members (or 16 float64
// ones) are 128 bytes of each stream value.
template <typename S>
struct Tile {
  static constexpr int MB = sizeof(S) == 4 ? 32 : 16;
};

// A smoother member's shared memory: A L_f, L_s and L_f (N x N, rows
// contiguous and 16-byte aligned, read a row at a time in 16-byte loads),
// the smoothed and predicted means, the Gram-Schmidt buffers; 4 values of
// padding, so that the 4 members of a warp reading the same entry of their
// own workspaces hit 4 different banks.
template <int N>
struct MemberWs {
  static constexpr int P = N;
  static constexpr int AL = 0, LS = N * N, LF = 2 * N * N, MS = 3 * N * N,
                       MP = MS + N, Q = MP + N, SIZE = Q + 2 * 3 * N + 4;
};

// A sampler member's shared memory: A L_f and L_f (as MemberWs), the
// predicted mean, entry l of each of its SC samples at X + s N + l, and
// the Gram-Schmidt buffers of its 2N x N stack; 4 values of padding.
template <int N, int SC>
struct SamplerWs {
  static constexpr int P = N;
  static constexpr int AL = 0, LF = N * N, MP = 2 * N * N, X = MP + N,
                       Q = X + SC * N, SIZE = Q + 2 * 2 * N + 4;
};

// Staged values: K values x (MB + 1) members, rounded up to 16 bytes.
template <int K, int MB>
__host__ __device__ constexpr int staged_size() {
  return (K * (MB + 1) + 3) / 4 * 4;
}

// The staged stream rows of a CTA: 2 rows of V values, then MB members'
// MemberWs.
template <int N, int MB>
__host__ __device__ constexpr int stage_size() {
  return staged_size<2 * Layout<N>::V, MB>();
}

template <typename S, int NQ, int DIM, int MB>
constexpr size_t smoother_smem_bytes() {
  constexpr int N = NQ * DIM;
  return ((size_t)stage_size<N, MB>() + (size_t)MB * MemberWs<N>::SIZE)
         * sizeof(S);
}

// The sampler's: the 2 stream rows, one step's SC N normals, then MB
// members' SamplerWs.
template <typename S, int NQ, int DIM, int MB, int SC>
constexpr size_t sampler_smem_bytes() {
  constexpr int N = NQ * DIM;
  return ((size_t)stage_size<N, MB>() + (size_t)staged_size<SC * N, MB>()
          + (size_t)MB * SamplerWs<N, SC>::SIZE)
         * sizeof(S);
}

// The member's N lanes (N divides the warp).
template <int N>
struct MemberSync {
  unsigned mask;
  __device__ __forceinline__ MemberSync()
      : mask(((1u << N) - 1u) << ((threadIdx.x & 31) & ~(N - 1))) {}
  __device__ __forceinline__ void operator()() const { __syncwarp(mask); }
};

// K values of each of the CTA's MB members from a row block src, value v
// of member b0 + mm at src[v sB + b0 + mm] (idx = v MB + mm, consecutive
// threads on consecutive members), PER values a thread held in registers;
// the values at or past kmax, and those of members past B, are zero. put
// stores them at dst[v (MB + 1) + mm].
template <typename S, int K, int MB, int THREADS>
struct Stager {
  static constexpr int PER = (K * MB + THREADS - 1) / THREADS;
  S reg[PER];

  __device__ __forceinline__ void fetch(const S* __restrict__ src, size_t sB,
                                        int b0, int B, int tid, int kmax) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = tid + i * THREADS;
      if (idx < K * MB) {
        const int v = idx / MB, mm = idx % MB;
        reg[i] = v < kmax && b0 + mm < B ? src[(size_t)v * sB + b0 + mm]
                                         : S(0);
      }
    }
  }

  __device__ __forceinline__ void put(S* dst, int tid) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = tid + i * THREADS;
      if (idx < K * MB) dst[(idx / MB) * (MB + 1) + idx % MB] = reg[i];
    }
  }
};

// Lane r's share of a backward step's work that does not depend on what
// is carried from t_{k+1} (ek1_fused.py: _backward_shared, by rows): it
// publishes row r of L_f and of A L_f and entry r of the predicted mean
// A m_f, then forms row r of the gain G = L_f (A L_f)^T (Lp Lp^T)^-1 and
// the first 2N entries of column r of the stack: rows l of (I - G A) L_f
// and N + l of sq G QLf. R: the staged row k (m_f, L_f), Rn: row k+1 (s2,
// Lp), value v of this member at v SP; arow: row r / DIM of At.
template <typename S, int NQ, int DIM, int SP, int KM, class Sync>
__device__ __forceinline__ void condition_rows(
    const Consts<S, NQ, DIM>& c, const S* R, const S* Rn, int r,
    const S (&arow)[NQ], S* sLf, S* sAL, S* sMp, const Sync& sync,
    S (&g)[NQ * DIM], S (&col)[1][KM]) {
  constexpr int N = NQ * DIM;
  constexpr int P = N;
  const int rd = r % DIM, rq = r / DIM;
  auto Lf = [&](int i, int j) { return R[(Layout<N>::L + i * N + j) * SP]; };
  auto Lp = [&](int i, int j) {
    return Rn[(Layout<N>::LP + i * (i + 1) / 2 + j) * SP];
  };
  const S sq = ek0::sqrt_(ek0::floor_at(Rn[Layout<N>::S2 * SP], S(0)));

  // this lane's row of L_f, for the other lanes' (I - G A) L_f
  S lf[N];
#pragma unroll
  for (int j = 0; j < N; ++j) lf[j] = Lf(r, j);
  grp::st<S, N>(sLf + r * P, lf);
  // row r of A L_f, and entry r of the predicted mean A m_f: row r of A =
  // kron(At, I) is live at cc = rd + DIM m for m >= rq (a_live), in
  // ascending cc
  {
    S acc = S(0);
#pragma unroll
    for (int kk = 0; kk < N; ++kk) {
      S al = S(0);
#pragma unroll
      for (int mq = 0; mq < NQ; ++mq)
        if (mq >= rq) al += arow[mq] * Lf(rd + DIM * mq, kk);
      sAL[r * P + kk] = al;
    }
#pragma unroll
    for (int mq = 0; mq < NQ; ++mq)
      if (mq >= rq) acc += arow[mq] * R[(rd + DIM * mq) * SP];
    sMp[r] = acc;
  }
  sync();
  // row r of the gain G = L_f (A L_f)^T (Lp Lp^T)^-1
  {
    S M[N], y[N];
#pragma unroll
    for (int l = 0; l < N; ++l) {
      S row[N];
      grp::ld<S, N>(sAL + l * P, row);
      S acc = S(0);
#pragma unroll
      for (int kk = 0; kk < N; ++kk) acc += lf[kk] * row[kk];
      M[l] = acc;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      S s = M[i];
#pragma unroll
      for (int kk = 0; kk < i; ++kk) s = s - Lp(i, kk) * y[kk];
      y[i] = s / Lp(i, i);
    }
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
      S s = y[i];
#pragma unroll
      for (int kk = i + 1; kk < N; ++kk) s = s - Lp(kk, i) * g[kk];
      g[i] = s / Lp(i, i);
    }
  }
  // rows l of (I - G A) L_f, N + l of sq G QLf
  S iga[N];
#pragma unroll
  for (int l = 0; l < N; ++l) {
    S ga = S(0);
#pragma unroll
    for (int kk = 0; kk < N; ++kk)
      if (a_live<DIM>(kk, l)) ga += g[kk] * c.At[kk / DIM][l / DIM];
    iga[l] = (r == l ? S(1) : S(0)) - ga;
  }
  // b1[l] = sum_kk IGA[kk] L_f[kk][l], in kk order, a row of L_f at a time
  S b1[N];
#pragma unroll
  for (int l = 0; l < N; ++l) b1[l] = S(0);
#pragma unroll
  for (int kk = 0; kk < N; ++kk) {
    S row[N];
    grp::ld<S, N>(sLf + kk * P, row);
#pragma unroll
    for (int l = 0; l < N; ++l) b1[l] += iga[kk] * row[l];
  }
#pragma unroll
  for (int l = 0; l < N; ++l) {
    S gq = S(0);
#pragma unroll
    for (int kk = 0; kk < N; ++kk)
      if (q_live<DIM>(kk, l)) gq += g[kk] * c.QLt[kk / DIM][l / DIM];
    col[0][l] = b1[l];
    col[0][N + l] = sq * gq;
  }
}

// The backward pass over the stream st (T+1, V, B) into us, stds
// (T+1, DIM, B), MB members a CTA, N lanes a member.
template <typename S, int NQ, int DIM, int MB>
__device__ __forceinline__ void smoother_group(const Consts<S, NQ, DIM>& c,
                                               const S* __restrict__ st,
                                               S* __restrict__ us,
                                               S* __restrict__ stds, int B,
                                               int T) {
  constexpr int N = NQ * DIM;
  constexpr int THREADS = MB * N;
  constexpr int V = Layout<N>::V;
  constexpr int SP = MB + 1;  // staged value stride
  constexpr int P = MemberWs<N>::P;
  extern __shared__ __align__(16) unsigned char ek1g_smem[];
  S* stage = reinterpret_cast<S*>(ek1g_smem);  // [2][V][SP]
  const int tid = threadIdx.x, m = tid / N, r = tid % N;
  const int b0 = blockIdx.x * MB, b = b0 + m;
  const bool live = b < B;
  S* ws = stage + stage_size<N, MB>() + m * MemberWs<N>::SIZE;
  S* sAL = ws + MemberWs<N>::AL;
  S* sLs = ws + MemberWs<N>::LS;
  S* sLf = ws + MemberWs<N>::LF;
  S* sMs = ws + MemberWs<N>::MS;
  S* sMp = ws + MemberWs<N>::MP;
  S* q = ws + MemberWs<N>::Q;
  const MemberSync<N> sync;
  const size_t sB = (size_t)B;
  S arow[NQ];
#pragma unroll
  for (int mq = 0; mq < NQ; ++mq) arow[mq] = c.At[r / DIM][mq];

  Stager<S, V, MB, THREADS> rows;
  auto fetch = [&](int k) {
    rows.fetch(st + (size_t)k * V * sB, sB, b0, B, tid, V);
  };
  // lane r < DIM writes dimension r of the solution at row k
  auto emit = [&](int k, S mean, const S (&lrow)[N]) {
    if (live && r < DIM) {
      S ss = S(0);
#pragma unroll
      for (int j = 0; j < N; ++j) ss += lrow[j] * lrow[j];
      const size_t o = ((size_t)k * DIM + r) * sB + b;
      us[o] = c.pinv0 * mean;
      stds[o] = c.pinv0 * ek0::sqrt_(ss);
    }
  };

  fetch(T);
  rows.put(stage + (T & 1) * V * SP, tid);
  __syncthreads();
  {
    // the smoothed state at T is the filter's, its full factor
    const S* R = stage + (T & 1) * V * SP + m;
    S ls[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      ls[j] = R[(Layout<N>::L + r * N + j) * SP];
      sLs[r * P + j] = ls[j];
    }
    sMs[r] = R[r * SP];
    emit(T, R[r * SP], ls);
  }
  if (T > 0) fetch(T - 1);
  for (int k = T - 1; k >= 0; --k) {
    // step k+1 has read row k+2 (its Lp), whose buffer row k takes
    __syncthreads();
    rows.put(stage + (k & 1) * V * SP, tid);
    __syncthreads();
    if (k > 0) fetch(k - 1);
    const S* R = stage + (k & 1) * V * SP + m;         // row k: m_f, L_f
    const S* Rn = stage + ((k + 1) & 1) * V * SP + m;  // row k+1: s2, Lp
    // column r of the stack: rows l of (I - G A) L_f, N + l of sq G QLf,
    // 2N + l of G L_s
    S g[N];
    S col[1][3 * N];
    condition_rows<S, NQ, DIM, SP, 3 * N>(c, R, Rn, r, arow, sLf, sAL, sMp,
                                          sync, g, col);
    S ms;
    {
      S gs = S(0);
#pragma unroll
      for (int l = 0; l < N; ++l) gs += g[l] * (sMs[l] - sMp[l]);
      ms = R[r * SP] + gs;
      // column l of G L_s, sums in kk order, a row of L_s at a time
#pragma unroll
      for (int l = 0; l < N; ++l) col[0][2 * N + l] = S(0);
#pragma unroll
      for (int kk = 0; kk < N; ++kk) {
        S row[N];
        grp::ld<S, N>(sLs + kk * P, row);
#pragma unroll
        for (int l = 0; l < N; ++l) col[0][2 * N + l] += g[kk] * row[l];
      }
    }
    sync();  // the member's lanes have read m_s and L_s
    sMs[r] = ms;
    S L[1][N];
    grp::mgs_rows<S, N, 3 * N, 1, false>(col, N, r, q, L, sync);
    grp::st<S, N>(sLs + r * P, L[0]);
    emit(k, ms, L[0]);
  }
}

// The backward sampler over the stream st (T+1, V, B) with the normals zn
// (T+1, NS, N, B) into out (T+1, NS, DIM, B): samples s0 .. s0 + SC - 1
// (those below NS) of MB members a CTA, N lanes a member. Each step's gain
// and conditional factor are formed once, then every sample is
// conditioned on its drawn next value and re-drawn from the conditional.
template <typename S, int NQ, int DIM, int MB, int SC>
__device__ __forceinline__ void sampler_group(const Consts<S, NQ, DIM>& c,
                                              const S* __restrict__ st,
                                              const S* __restrict__ zn,
                                              S* __restrict__ out, int B,
                                              int T, int NS, int s0) {
  constexpr int N = NQ * DIM;
  constexpr int THREADS = MB * N;
  constexpr int V = Layout<N>::V;
  constexpr int SP = MB + 1;  // staged value stride
  using W = SamplerWs<N, SC>;
  extern __shared__ __align__(16) unsigned char ek1g_smem[];
  S* stage = reinterpret_cast<S*>(ek1g_smem);  // [2][V][SP]
  S* zst = stage + stage_size<N, MB>();        // [SC N][SP]
  const int tid = threadIdx.x, m = tid / N, r = tid % N;
  const int b0 = blockIdx.x * MB, b = b0 + m;
  const bool live = b < B;
  const int ns = NS - s0 < SC ? NS - s0 : SC;
  S* ws = zst + staged_size<SC * N, MB>() + m * W::SIZE;
  S* sAL = ws + W::AL;
  S* sLf = ws + W::LF;
  S* sMp = ws + W::MP;
  S* sX = ws + W::X;
  S* q = ws + W::Q;
  const MemberSync<N> sync;
  const size_t sB = (size_t)B;
  S arow[NQ];
#pragma unroll
  for (int mq = 0; mq < NQ; ++mq) arow[mq] = c.At[r / DIM][mq];

  Stager<S, V, MB, THREADS> rows;
  Stager<S, SC * N, MB, THREADS> zs;
  auto fetch = [&](int k) {
    rows.fetch(st + (size_t)k * V * sB, sB, b0, B, tid, V);
    zs.fetch(zn + ((size_t)k * NS + s0) * N * sB, sB, b0, B, tid, ns * N);
  };
  // lane r < DIM writes dimension r of each sample at row k
  auto emit = [&](int k, const S (&x)[SC]) {
    if (live && r < DIM) {
#pragma unroll
      for (int s = 0; s < SC; ++s)
        if (s < ns)
          out[(((size_t)k * NS + s0 + s) * DIM + r) * sB + b] = c.pinv0 * x[s];
    }
  };

  fetch(T);
  rows.put(stage + (T & 1) * V * SP, tid);
  zs.put(zst, tid);
  __syncthreads();
  // x_T = m_T + L_T z_T, L_T the filter's full factor
  S x[SC];
  {
    const S* R = stage + (T & 1) * V * SP + m;
#pragma unroll
    for (int s = 0; s < SC; ++s) {
      S acc = S(0);
#pragma unroll
      for (int kk = 0; kk < N; ++kk)
        acc += R[(Layout<N>::L + r * N + kk) * SP]
               * zst[(s * N + kk) * SP + m];
      x[s] = R[r * SP] + acc;
    }
  }
  emit(T, x);
  if (T > 0) fetch(T - 1);
  for (int k = T - 1; k >= 0; --k) {
    // step k+1 has read row k+2 (its Lp), whose buffer row k takes, its
    // normals and the samples
    __syncthreads();
    rows.put(stage + (k & 1) * V * SP, tid);
    zs.put(zst, tid);
#pragma unroll
    for (int s = 0; s < SC; ++s) sX[s * N + r] = x[s];
    __syncthreads();
    if (k > 0) fetch(k - 1);
    const S* R = stage + (k & 1) * V * SP + m;         // row k: m_f, L_f
    const S* Rn = stage + ((k + 1) & 1) * V * SP + m;  // row k+1: s2, Lp
    S g[N];
    S col[1][2 * N];
    condition_rows<S, NQ, DIM, SP, 2 * N>(c, R, Rn, r, arow, sLf, sAL, sMp,
                                          sync, g, col);
    // row r of the conditional factor: the smoothing stack without its
    // G L_s block (the conditioning target has zero covariance)
    S L[1][N];
    grp::mgs_rows<S, N, 2 * N, 1, false>(col, N, r, q, L, sync);
    S mp[N];
    grp::ld<S, N>(sMp, mp);
    const S mf = R[r * SP];
#pragma unroll
    for (int s = 0; s < SC; ++s) {
      S xs[N];
      grp::ld<S, N>(sX + s * N, xs);
      S gs = S(0), lz = S(0);
#pragma unroll
      for (int l = 0; l < N; ++l) gs += g[l] * (xs[l] - mp[l]);
#pragma unroll
      for (int l = 0; l < N; ++l)
        if (l <= r) lz += L[0][l] * zst[(s * N + l) * SP + m];
      x[s] = mf + gs + lz;
    }
    emit(k, x);
  }
}

}  // namespace ek1g
