// The fused time-parallel scan's combines and kernels above state dimension
// 32 (tp_wide.cu has the design): one combine to one CTA of G lanes, G the
// power of two at or above D (64 or 128), the operands in a workspace that
// is the CTA's shared memory where it fits and a per-CTA slice of a global
// buffer where it does not. The combines compute what tp_group.cuh's group
// combines compute, entry by entry in the same order of operations (the
// plain versions' in odefilters_torch/ops/tp_scan.py: every sum over an
// index in index order), so they are bit for bit with both.
//
// Lane r owns row r of every matrix and lane j column j of each
// Gram-Schmidt stack, as in the group kernels; here rows and columns stay
// in the workspace and every loop runs over D at run time, so that the
// code is one small body for every D.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ek0_common.cuh"  // sqrt_, floor_at
#include "tp_scan.cuh"     // tp::NC

namespace tpw {

using tp::NC;

constexpr int D_MIN = 33;     // below: tp_group.cuh
// The largest D: the largest held on the card against the plain versions
// (chip_smoke.py, phase 40; their plain combines take seconds a call at
// D = 96). The kernels' code has no limit of its own below a CTA's 1024
// threads; a larger D_MAX wants a hold at that D first.
constexpr int D_MAX = 96;
constexpr int G_MAX = 128;    // lanes a CTA at D_MAX
constexpr int N_VEC = 10;     // vectors of D: six, and two pivots of 2D

// The group size for state dimension D: the power of two at or above it,
// at least 64.
__host__ __device__ inline int lanes_for(int D) {
  int G = 64;
  while (G < D) G <<= 1;
  return G;
}

// Row pitch of the workspace's D x D matrices: D made odd, so that the
// lanes' rows start in different banks.
__host__ __device__ inline int pitch(int D) { return D | 1; }

// Matrices in a combine's workspace, the Gram-Schmidt stack's two
// included: filter Ui Zj Ai Aj Uj Zi W Lw Lv T X; smooth Ea Pa Eb Pb X.
__host__ __device__ inline int n_mats(bool filter) {
  return (filter ? 11 : 5) + 2;
}

// Values of a combine's workspace.
__host__ __device__ inline size_t ws_values(bool filter, int D) {
  return (size_t)n_mats(filter) * D * pitch(D) + (size_t)N_VEC * D;
}

__device__ __forceinline__ int width(bool filter, int D) {
  return filter ? 3 * D * D + 2 * D : 2 * D * D + D;
}

// A vector of D values at p[k * s]: a row (s = 1) or a column (s = the
// pitch) of a matrix in the workspace, or a row of a packed element in
// global memory (s = its stride).
template <typename S>
struct Vec {
  S* p;
  size_t s;
  __device__ __forceinline__ S& operator[](int k) const {
    return p[(size_t)k * s];
  }
};

template <typename S>
__device__ __forceinline__ Vec<S> row(S* M, int P, int r) {
  return {M + (size_t)r * P, 1};
}

template <typename S>
__device__ __forceinline__ Vec<S> col(S* M, int P, int c) {
  return {M + c, (size_t)P};
}

// ---- one lane's share of the small-matrix algebra ----

// Row r of the matrix at offset off of a packed element into row r of M.
template <typename S>
__device__ __forceinline__ void stage_row(const S* p, size_t s, int off,
                                          int D, int r, S* M, int P) {
  for (int j = 0; j < D; ++j)
    M[(size_t)r * P + j] = __ldcg(p + (size_t)(off + r * D + j) * s);
}

// c = a B: c[j] = a[0] B[0][j] + a[1] B[1][j] + ... (c not aliasing a or
// B)
template <typename S>
__device__ __forceinline__ void times(Vec<S> a, const S* B, int P, int D,
                                      Vec<S> c) {
  for (int j = 0; j < D; ++j) {
    S acc = a[0] * B[j];
    for (int k = 1; k < D; ++k) acc = acc + a[k] * B[(size_t)k * P + j];
    c[j] = acc;
  }
}

// a . x = a[0] x[0] + a[1] x[1] + ...
template <typename S>
__device__ __forceinline__ S dot(Vec<S> a, Vec<S> x, int D) {
  S acc = a[0] * x[0];
  for (int k = 1; k < D; ++k) acc = acc + a[k] * x[k];
  return acc;
}

// c = a B^T: c[j] = a . B[j]
template <typename S>
__device__ __forceinline__ void times_t(Vec<S> a, S* B, int P, int D,
                                        Vec<S> c) {
  for (int j = 0; j < D; ++j) c[j] = dot(a, row(B, P, j), D);
}

// y solving L y = x by forward substitution, y[i] = (x[i] - L[i][0] y[0]
// - ... - L[i][i-1] y[i-1]) / L[i][i] (y may be x)
template <typename S>
__device__ __forceinline__ void fwd(const S* L, int P, Vec<S> x, int D,
                                    Vec<S> y) {
  for (int i = 0; i < D; ++i) {
    const S* Li = L + (size_t)i * P;
    S s = x[i];
    for (int k = 0; k < i; ++k) s = s - Li[k] * y[k];
    y[i] = s / Li[i];
  }
}

// x solving L L^T x = b in place (b becomes x): forward, then back
// substitution x[i] = (y[i] - L[i+1][i] x[i+1] - ...) / L[i][i], i
// descending, k ascending (ek0::cho_solve).
template <typename S>
__device__ __forceinline__ void cho_solve(const S* L, int P, Vec<S> b,
                                          int D) {
  fwd(L, P, b, D, b);
  for (int i = D - 1; i >= 0; --i) {
    S s = b[i];
    for (int k = i + 1; k < D; ++k) s = s - L[(size_t)k * P + i] * b[k];
    b[i] = s / L[(size_t)i * P + i];
  }
}

// Entry k of stack column j is a structural zero of a TRI stack [M; I]
// (the identity block's rows below its diagonal).
template <bool TRI>
__device__ __forceinline__ bool tri_zero(int k, int j, int D) {
  return TRI && k >= D && j < k - D;
}

// Row `lane` of the lower factor L (L L^T = M^T M) of the 2D x D stack M,
// column `lane` of which the lane holds at St[k P + lane], into Lr, by
// grp::mgs_rows's pivots: column j's lane forms the norm and the scaled
// column and publishes it in q (two buffers of 2D, alternating), and every
// later lane takes its dot product and updates its own column. Ends at a
// barrier, after which every row of L is readable and St and q free.
template <typename S, bool TRI>
__device__ __forceinline__ void mgs(S* St, int P, int D, int lane, S* q,
                                    Vec<S> Lr) {
  const int K = 2 * D;
  if (lane < D)
    for (int j = 0; j < D; ++j) Lr[j] = S(0);
  for (int j = 0; j < D; ++j) {
    S* qj = q + (j & 1) * K;
    if (lane == j) {
      S ss = S(0);
      for (int k = 0; k < K; ++k)
        if (!tri_zero<TRI>(k, j, D)) {
          const S v = St[(size_t)k * P + lane];
          ss += v * v;
        }
      const S rjj = ek0::sqrt_(ek0::floor_at(ss, S(1e-30)));
      const S inv = S(1) / rjj;
      Lr[j] = rjj;
      for (int k = 0; k < K; ++k)
        qj[k] = tri_zero<TRI>(k, j, D) ? S(0)
                                        : St[(size_t)k * P + lane] * inv;
    }
    __syncthreads();
    if (lane > j && lane < D) {
      S r = S(0);
      for (int k = 0; k < K; ++k)
        if (!tri_zero<TRI>(k, j, D)) r += qj[k] * St[(size_t)k * P + lane];
      Lr[j] = r;
      for (int k = 0; k < K; ++k)
        if (!tri_zero<TRI>(k, j, D)) {
          S& v = St[(size_t)k * P + lane];
          v = v - r * qj[k];
        }
    }
  }
  __syncthreads();
}

// Stack column r of [M^T; I] (or [M; I]) from m, row (column) r of M.
template <typename S>
__device__ __forceinline__ void eye_col(Vec<S> m, int D, int r, S* St,
                                        int P) {
  for (int k = 0; k < D; ++k) {
    St[(size_t)k * P + r] = m[k];
    St[(size_t)(D + k) * P + r] = k == r ? S(1) : S(0);
  }
}

// Lane r's row of the workspace matrix M to row r of the packed leaf at
// offset off.
template <typename S>
__device__ __forceinline__ void store_row(S* o, size_t so, int off, int D,
                                          int r, const S* M, int P) {
  for (int j = 0; j < D; ++j)
    __stcg(o + (size_t)(off + r * D + j) * so, M[(size_t)r * P + j]);
}

// o = combine(a, b) for filtering elements (A, b, U, eta, Z): tp_group.cuh's
// filter_combine by a CTA, lane r computing row r of every result, in the
// workspace ws. Barriers are the CTA's.
template <typename S>
__device__ void filter_combine(const S* a, size_t sa, const S* b, size_t sb,
                               S* o, size_t so, int D, S* ws) {
  const int P = pitch(D);
  const size_t MAT = (size_t)D * P;
  const int OA = 0, OB = D * D, OU = D * D + D, OETA = 2 * D * D + D,
            OZ = 2 * D * D + 2 * D;
  const int r = threadIdx.x;
  const bool act = r < D;
  S* sU = ws;            // Ui
  S* sZ = sU + MAT;      // Zj
  S* sA = sZ + MAT;      // Ai
  S* sAj = sA + MAT;     // Aj
  S* sUj = sAj + MAT;    // Uj
  S* sZi = sUj + MAT;    // Zi
  S* sW = sZi + MAT;     // W = Ui^T Zj, then V2 = Zj Lv^-T
  S* sLw = sW + MAT;     // chol(I + W W^T)
  S* sLv = sLw + MAT;    // chol(I + W^T W)
  S* sT = sLv + MAT;     // W Zj^T, then G, then V1 = Ui Lw^-T
  S* sX = sT + MAT;      // I - Ui G, then AjT, then U's factor
  S* St = sX + MAT;      // the Gram-Schmidt stack, 2D x D
  S* v0 = St + 2 * MAT;  // etaj, then W^T Ui^T r
  S* v1 = v0 + D;        // bi, then r - Zj x
  S* v2 = v1 + D;
  S* v3 = v2 + D;
  S* vbj = v3 + D;       // bj
  S* vei = vbj + D;      // etai
  S* q = vei + D;        // 2 x 2D
  const Vec<S> V0{v0, 1}, V1{v1, 1}, V2{v2, 1}, V3{v3, 1};

  if (act) {
    stage_row(a, sa, OU, D, r, sU, P);
    stage_row(b, sb, OZ, D, r, sZ, P);
    stage_row(a, sa, OA, D, r, sA, P);
    stage_row(b, sb, OA, D, r, sAj, P);
    stage_row(b, sb, OU, D, r, sUj, P);
    stage_row(a, sa, OZ, D, r, sZi, P);
    v0[r] = __ldcg(b + (size_t)(OETA + r) * sb);
    v1[r] = __ldcg(a + (size_t)(OB + r) * sa);
    vbj[r] = __ldcg(b + (size_t)(OB + r) * sb);
    vei[r] = __ldcg(a + (size_t)(OETA + r) * sa);
  }
  __syncthreads();
  if (act) times(col(sU, P, r), sZ, P, D, row(sW, P, r));  // W = Ui^T Zj
  __syncthreads();
  // Lw = chol(I + W W^T), the MGS of [W^T; I]; Lv = chol(I + W^T W), of
  // [W; I]: column r of each stack from row r and column r of W
  if (act) eye_col(row(sW, P, r), D, r, St, P);
  mgs<S, true>(St, P, D, r, q, row(sLw, P, r));
  if (act) eye_col(col(sW, P, r), D, r, St, P);
  mgs<S, true>(St, P, D, r, q, row(sLv, P, r));
  // G = (Lw Lw^T)^-1 W Zj^T, a column a lane, in place
  if (act) times_t(row(sW, P, r), sZ, P, D, row(sT, P, r));  // W Zj^T
  __syncthreads();
  if (act) cho_solve(sLw, P, col(sT, P, r), D);
  __syncthreads();
  // AjT = Aj (I - Ui G); A = AjT Ai
  if (act) {
    const Vec<S> m2 = row(sX, P, r);
    times(row(sU, P, r), sT, P, D, m2);  // Ui G
    for (int j = 0; j < D; ++j) m2[j] = (r == j ? S(1) : S(0)) - m2[j];
  }
  __syncthreads();
  {
    S* t = sT;  // sT: I - Ui G; sX free
    sT = sX;
    sX = t;
  }
  if (act) {
    const Vec<S> ajt = row(sX, P, r);
    times(row(sAj, P, r), sT, P, D, ajt);
    times(ajt, sA, P, D, Vec<S>{o + (size_t)(OA + r * D) * so, so});
    // b = AjT (bi + Ui Ui^T etaj) + bj
    v2[r] = dot(col(sU, P, r), V0, D);  // Ui^T etaj
  }
  __syncthreads();
  if (act) v3[r] = v1[r] + dot(row(sU, P, r), V2, D);  // bi + Ui y
  __syncthreads();
  S rr = S(0);
  if (act) {
    __stcg(o + (size_t)(OB + r) * so, dot(row(sX, P, r), V3, D) + vbj[r]);
    // eta = Ai^T [r - Zj (Lv Lv^T)^-1 W^T Ui^T r] + etai,
    // r = etaj - Zj Zj^T bi
    v2[r] = dot(col(sZ, P, r), V1, D);  // Zj^T bi
  }
  __syncthreads();
  if (act) {
    rr = v0[r] - dot(row(sZ, P, r), V2, D);
    v3[r] = rr;
  }
  __syncthreads();
  if (act) v2[r] = dot(col(sU, P, r), V3, D);  // Ui^T r
  __syncthreads();
  if (act) v0[r] = dot(col(sW, P, r), V2, D);  // W^T x
  __syncthreads();
  if (r == 0) {
    // (Lv Lv^T) x = W^T x by one lane (each lane of a group kernel solves
    // it whole, by the same operations)
    for (int k = 0; k < D; ++k) v2[k] = v0[k];
    cho_solve(sLv, P, V2, D);
  }
  __syncthreads();
  if (act) v1[r] = rr - dot(row(sZ, P, r), V2, D);
  __syncthreads();
  if (act) {
    __stcg(o + (size_t)(OETA + r) * so, dot(col(sA, P, r), V1, D) + vei[r]);
    // U = tril of [(Aj V1)^T; Uj^T], V1 = Ui Lw^-T; Z = tril of
    // [(Ai^T V2)^T; Zi^T], V2 = Zj Lv^-T: row r of V1 solves Lw y = Ui[r],
    // row r of V2 solves Lv y = Zj[r]
    fwd(sLw, P, row(sU, P, r), D, row(sT, P, r));
    fwd(sLv, P, row(sZ, P, r), D, row(sW, P, r));
  }
  __syncthreads();
  if (act) {
    times(row(sAj, P, r), sT, P, D, col(St, P, r));  // Aj V1
    const Vec<S> c = col(St + (size_t)D * P, P, r);
    for (int k = 0; k < D; ++k) c[k] = sUj[(size_t)r * P + k];
  }
  mgs<S, false>(St, P, D, r, q, row(sX, P, r));
  if (act) {
    store_row(o, so, OU, D, r, sX, P);
    times(col(sA, P, r), sW, P, D, col(St, P, r));  // Ai^T V2
    const Vec<S> c = col(St + (size_t)D * P, P, r);
    for (int k = 0; k < D; ++k) c[k] = sZi[(size_t)r * P + k];
  }
  mgs<S, false>(St, P, D, r, q, row(sT, P, r));
  if (act) store_row(o, so, OZ, D, r, sT, P);
  __syncthreads();
}

// o = combine(a, b) for smoothing elements (E, g, P), a the accumulated
// suffix: tp_group.cuh's smooth_combine by a CTA.
template <typename S>
__device__ void smooth_combine(const S* a, size_t sa, const S* b, size_t sb,
                               S* o, size_t so, int D, S* ws) {
  const int P = pitch(D);
  const size_t MAT = (size_t)D * P;
  const int OE = 0, OG = D * D, OP = D * D + D;
  const int r = threadIdx.x;
  const bool act = r < D;
  S* sE = ws;            // Ea
  S* sP = sE + MAT;      // Pa
  S* sEb = sP + MAT;     // Eb
  S* sPb = sEb + MAT;    // Pb
  S* sX = sPb + MAT;     // the factor
  S* St = sX + MAT;      // the Gram-Schmidt stack, 2D x D
  S* v0 = St + 2 * MAT;  // ga
  S* q = v0 + D;
  S gb = S(0);
  if (act) {
    stage_row(b, sb, OE, D, r, sEb, P);
    stage_row(b, sb, OP, D, r, sPb, P);
    gb = __ldcg(b + (size_t)(OG + r) * sb);
    stage_row(a, sa, OE, D, r, sE, P);
    stage_row(a, sa, OP, D, r, sP, P);
    v0[r] = __ldcg(a + (size_t)(OG + r) * sa);
  }
  __syncthreads();
  if (act) {
    const Vec<S> eb = row(sEb, P, r);
    times(eb, sE, P, D, Vec<S>{o + (size_t)(OE + r * D) * so, so});  // Eb Ea
    __stcg(o + (size_t)(OG + r) * so, gb + dot(eb, Vec<S>{v0, 1}, D));
    for (int k = 0; k < D; ++k) St[(size_t)k * P + r] = sPb[(size_t)r * P + k];
    times(eb, sP, P, D, col(St + (size_t)D * P, P, r));  // Eb Pa
  }
  mgs<S, false>(St, P, D, r, q, row(sX, P, r));
  if (act) store_row(o, so, OP, D, r, sX, P);
  __syncthreads();
}

// Copy an element of V values, a value a lane.
template <typename S>
__device__ __forceinline__ void copy_elem(const S* a, size_t sa, S* o,
                                          size_t so, int V) {
  for (int v = threadIdx.x; v < V; v += blockDim.x)
    __stcg(o + (size_t)v * so, __ldcg(a + (size_t)v * sa));
}

template <typename S, bool FILTER>
__device__ __forceinline__ void combine(const S* a, size_t sa, const S* b,
                                        size_t sb, S* o, size_t so, int D,
                                        S* ws) {
  if constexpr (FILTER)
    filter_combine<S>(a, sa, b, sb, o, so, D, ws);
  else
    smooth_combine<S>(a, sa, b, sb, o, so, D, ws);
}

// The CTA's workspace: its dynamic shared memory, or its slice of gws.
template <typename S>
__device__ __forceinline__ S* cta_ws(S* gws, size_t wsz) {
  extern __shared__ __align__(16) unsigned char tpw_smem[];
  return gws ? gws + blockIdx.x * wsz : reinterpret_cast<S*>(tpw_smem);
}

// ---- the three kernels (a CTA per combine) ----

// prefixes[k][c] = combine(prefixes[k-1][c], elems[k][c]): a CTA per chunk
// c over its L rows, the CTAs striding over the chunks.
template <typename S, bool FILTER>
__global__ void __launch_bounds__(G_MAX)
    tp_chunk_scan_wide_kernel(const S* __restrict__ elems,
                              S* __restrict__ out, int L, int D, S* gws,
                              size_t wsz) {
  S* ws = cta_ws<S>(gws, wsz);
  const int V = width(FILTER, D);
  const size_t rw = (size_t)V * NC;
  for (int c = blockIdx.x; c < NC; c += gridDim.x) {
    copy_elem<S>(elems + c, NC, out + c, NC, V);
    __syncthreads();
    for (int k = 1; k < L; ++k)
      combine<S, FILTER>(out + (k - 1) * rw + c, NC, elems + k * rw + c, NC,
                         out + k * rw + c, NC, D, ws);
  }
}

// The inclusive scan of the chunk totals (V, 1024), shifted by one into
// out, as tp_group.cuh's tp_totals_scan_group_kernel: cooperative, gridDim.x
// (a power of two) CTAs, each combining 1024 / gridDim.x totals one after
// another within each round; work: two (V, 1024) buffers.
template <typename S, bool FILTER>
__global__ void __launch_bounds__(G_MAX)
    tp_totals_scan_wide_kernel(const S* __restrict__ totals, S* work,
                               S* __restrict__ out, int D, S* gws,
                               size_t wsz) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  S* ws = cta_ws<S>(gws, wsz);
  const int NG = gridDim.x, TPG = NC / NG;
  const int V = width(FILTER, D);
  const size_t size = (size_t)V * NC;
  const S* src = totals;
  int w = 0;
  for (int shift = 1; shift < NC; shift <<= 1) {
    const bool last = 2 * shift >= NC;
    S* dst = last ? out : work + w * size;
    for (int t = 0; t < TPG; ++t) {
      const int i = blockIdx.x + t * NG;
      const int o = last ? (i + 1) % NC : i;
      if (i >= shift)
        combine<S, FILTER>(src + (i - shift), NC, src + i, NC, dst + o, NC,
                           D, ws);
      else
        copy_elem<S>(src + i, NC, dst + o, NC, V);
    }
    if (!last) {
      grid.sync();
      src = work + w * size;
      w ^= 1;
    }
  }
}

// out[k][c] = combine(t_excl[c], prefixes[k][c]) for c > 0, out[k][0] =
// prefixes[k][0]: a CTA per element, the CTAs striding over them.
template <typename S, bool FILTER>
__global__ void __launch_bounds__(G_MAX)
    tp_fixup_wide_kernel(const S* __restrict__ prefixes,
                         const S* __restrict__ t_excl, S* __restrict__ out,
                         int L, int D, S* gws, size_t wsz) {
  S* ws = cta_ws<S>(gws, wsz);
  const int V = width(FILTER, D);
  const size_t n = (size_t)L * NC;
  for (size_t t = blockIdx.x; t < n; t += gridDim.x) {
    const int k = (int)(t / NC), c = (int)(t % NC);
    const size_t at = (size_t)k * V * NC + c;
    if (c == 0)
      copy_elem<S>(prefixes + at, NC, out + at, NC, V);
    else
      combine<S, FILTER>(t_excl + c, NC, prefixes + at, NC, out + at, NC, D,
                         ws);
  }
}

// ---- launches ----

template <typename S, bool FILTER>
const void* kernel_of(int op) {
  if (op == 0) return (const void*)tp_chunk_scan_wide_kernel<S, FILTER>;
  if (op == 1) return (const void*)tp_totals_scan_wide_kernel<S, FILTER>;
  return (const void*)tp_fixup_wide_kernel<S, FILTER>;
}

// How a launch of op at D runs: G lanes a CTA, `shared` bytes of dynamic
// shared memory (the workspace, or 0 when it is global), `blocks` CTAs and,
// when the workspace is global, `global_values` of it (blocks slices).
struct Plan {
  int G, blocks;
  size_t shared, wsz, global_values;
};

// The plan for op (0 chunk scan, 1 totals scan, 2 fixup) of L rows at D:
// the workspace in shared memory where the CTA may take it; the totals
// scan on a power of two of CTAs that are all resident (its grid barrier
// needs them so), each carrying 1024 / blocks totals; with a global
// workspace, the chunk scan and fixup on as many CTAs as are resident,
// striding over their combines. Returns a CUDA error code.
template <typename S, bool FILTER>
int plan(int op, int D, int L, Plan& p) {
  if (D < D_MIN || D > D_MAX || op < 0 || op > 2 || L < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return (int)e;
  p.G = lanes_for(D);
  p.wsz = ws_values(FILTER, D);
  const size_t bytes = p.wsz * sizeof(S);
  const bool in_shared = bytes <= (size_t)optin;
  p.shared = in_shared ? bytes : 0;
  const void* kern = kernel_of<S, FILTER>(op);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)p.shared);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, p.G,
                                                      p.shared);
  if (e != cudaSuccess) return (int)e;
  const long resident = (long)per_sm * sms;
  if (resident < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long work = op == 0 ? NC : op == 1 ? NC : (long)L * NC;
  if (op == 1) {
    int nb = 1;
    while (2 * nb <= NC && 2 * nb <= resident) nb <<= 1;
    p.blocks = nb;
  } else {
    p.blocks = (int)(in_shared ? work : (work < resident ? work : resident));
  }
  p.global_values = in_shared ? 0 : p.wsz * (size_t)p.blocks;
  return 0;
}

// op 0 the chunk scan (elems a, out o), 1 the totals scan (totals a, work
// w, out o), 2 the fixup (prefixes a, t_excl b, out o); kind 0 filtering,
// 1 smoothing elements; gws the global workspace when the plan has one.
template <typename S, bool FILTER>
int launch(int op, int D, const void* a, const void* b, void* w, void* o,
           int L, void* gws, void* stream) {
  Plan p;
  int e = plan<S, FILTER>(op, D, L, p);
  if (e) return e;
  if (p.global_values && !gws) return (int)cudaErrorInvalidValue;
  S* ws = p.global_values ? (S*)gws : nullptr;
  size_t wsz = p.wsz;
  const cudaStream_t s = (cudaStream_t)stream;
  if (op == 0) {
    tp_chunk_scan_wide_kernel<S, FILTER><<<p.blocks, p.G, p.shared, s>>>(
        (const S*)a, (S*)o, L, D, ws, wsz);
  } else if (op == 2) {
    tp_fixup_wide_kernel<S, FILTER><<<p.blocks, p.G, p.shared, s>>>(
        (const S*)a, (const S*)b, (S*)o, L, D, ws, wsz);
  } else {
    const S* tp_ = (const S*)a;
    S *wp = (S*)w, *op_ = (S*)o;
    void* args[] = {&tp_, &wp, &op_, &D, &ws, &wsz};
    return (int)cudaLaunchCooperativeKernel(kernel_of<S, FILTER>(1), p.blocks,
                                            p.G, args, p.shared, s);
  }
  return (int)cudaGetLastError();
}

template <typename S>
int run(int op, int kind, int D, const void* a, const void* b, void* w,
        void* o, int L, void* gws, void* stream) {
  if (kind == 0) return launch<S, true>(op, D, a, b, w, o, L, gws, stream);
  if (kind == 1) return launch<S, false>(op, D, a, b, w, o, L, gws, stream);
  return (int)cudaErrorInvalidValue;
}

// Writes to *values the values of global workspace that op needs at D and
// L rows (0 when its workspace is the CTAs' shared memory); returns a CUDA
// error code.
template <typename S>
int workspace(int op, int kind, int D, int L, long long* values) {
  Plan p;
  int e = kind == 0   ? plan<S, true>(op, D, L, p)
          : kind == 1 ? plan<S, false>(op, D, L, p)
                      : (int)cudaErrorInvalidValue;
  if (!e) *values = (long long)p.global_values;
  return e;
}

}  // namespace tpw
