// The fused time-parallel scan's combines spread over a group of lanes, at
// any state dimension 2 <= D <= 32 (a run-time argument; tp_wide.cuh takes
// the larger ones), and the three
// scan kernels built on them (tp_group.cu has the design). The combines
// compute what tp_scan.cuh's one-thread combines compute, entry by entry in
// the same order of operations (the plain versions' in
// odefilters_torch/ops/tp_scan.py: every sum over an index in index order),
// so they are bit for bit with both.
//
// A group of G lanes (G the power of two at or above D, G <= 32) combines
// one element pair: lane r owns row r of every matrix and entry r of every
// vector, computes that row of each product, and publishes in the group's
// shared memory the operands that other rows need; lane j owns column j of
// each Gram-Schmidt stack (group_mgs.cuh). Loop bounds are G, the entries at
// or past D skipped, so each loop unrolls at compile time.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cooperative.cuh"  // coop::launch_cooperative
#include "group_mgs.cuh"    // grp::mgs_rows
#include "tp_scan.cuh"      // tp::NC

namespace tpg {

using tp::NC;

// The group kernels' largest state dimension: above it the ten D x D
// operands of a filtering combine outgrow a group's share of an SM's shared
// memory (at D = 64 in float64, 327 kB against the 227 kB a CTA may take),
// and tp_wide.cuh runs a combine on a whole CTA.
constexpr int D_MAX = 32;
constexpr int BLOCK = 128;  // threads per CTA, all three kernels

// The group size for state dimension D: the power of two at or above it.
inline int group_for(int D) {
  return D <= 2 ? 2 : D <= 4 ? 4 : D <= 8 ? 8 : D <= 16 ? 16 : 32;
}

// Offsets of the leaves in a packed element at run-time D.
struct FilterOff {  // (A, b, U, eta, Z)
  int A, B, U, ETA, Z;
  __device__ __forceinline__ explicit FilterOff(int D)
      : A(0), B(D * D), U(D * D + D), ETA(2 * D * D + D),
        Z(2 * D * D + 2 * D) {}
};

struct SmoothOff {  // (E, g, P)
  int E, G, P;
  __device__ __forceinline__ explicit SmoothOff(int D)
      : E(0), G(D * D), P(D * D + D) {}
};

// A group's shared memory: matrices of G rows of G (rows contiguous and
// 16-byte aligned, read and written a row at a time in 16-byte accesses),
// vectors of G, and the Gram-Schmidt buffers (2 alternating x 2 stacks x
// 2G).
template <int G>
struct Ws {
  static constexpr int P = G;
  static constexpr int MAT = G * P;
  static constexpr int NMAT = 10;  // filter: Ui Zj Ai Aj Uj Zi W Lw Lv T
  static constexpr int NVEC = 6;
  static constexpr int Q = 2 * 2 * 2 * G;
  static constexpr int SIZE = NMAT * MAT + NVEC * G + Q;
};

// The group's workspace in the kernel's dynamic shared memory.
template <typename S, int G>
__device__ __forceinline__ S* group_ws() {
  extern __shared__ __align__(16) unsigned char tp_smem[];
  return reinterpret_cast<S*>(tp_smem) + (threadIdx.x / G) * Ws<G>::SIZE;
}

// The barrier of the group of G lanes (G divides the warp; at G = 32 the
// whole warp, whose mask 1 << 32 would not give).
template <int G>
struct GroupSync {
  unsigned mask;
  __device__ __forceinline__ GroupSync()
      : mask(G == 32 ? 0xffffffffu
                     : ((1u << (G % 32)) - 1u)
                           << ((threadIdx.x & 31) & ~(G - 1))) {}
  __device__ __forceinline__ void operator()() const { __syncwarp(mask); }
};

// ---- one lane's share of the small-matrix algebra; D <= G at run time ----

// x = row r of the matrix at offset off of a packed element
template <typename S, int G>
__device__ __forceinline__ void load_row(const S* p, size_t s, int off, int D,
                                         int r, S (&x)[G]) {
#pragma unroll
  for (int j = 0; j < G; ++j)
    if (j < D) x[j] = __ldcg(p + (size_t)(off + r * D + j) * s);
}

template <typename S, int G>
__device__ __forceinline__ void store_row(S* p, size_t s, int off, int D,
                                          int r, const S (&x)[G]) {
#pragma unroll
  for (int j = 0; j < G; ++j)
    if (j < D) __stcg(p + (size_t)(off + r * D + j) * s, x[j]);
}

// Row r of the matrix at offset off of a packed element into shared M
// (the entries past D of the shared row are not used).
template <typename S, int G>
__device__ __forceinline__ void stage_row(const S* p, size_t s, int off,
                                          int D, int r, S* M) {
  S x[G];
#pragma unroll
  for (int j = 0; j < G; ++j)
    x[j] = j < D ? __ldcg(p + (size_t)(off + r * D + j) * s) : S(0);
  grp::st<S, G>(M + r * Ws<G>::P, x);
}

template <typename S, int G>
__device__ __forceinline__ void get_row(const S* M, int, int r, S (&x)[G]) {
  grp::ld<S, G>(M + r * Ws<G>::P, x);
}

template <typename S, int G>
__device__ __forceinline__ void put_row(S* M, int, int r, const S (&x)[G]) {
  grp::st<S, G>(M + r * Ws<G>::P, x);
}

template <typename S, int G>
__device__ __forceinline__ void get_col(const S* M, int D, int c, S (&x)[G]) {
#pragma unroll
  for (int k = 0; k < G; ++k)
    if (k < D) x[k] = M[k * Ws<G>::P + c];
}

// The loops over a group's rows below (k, j, i up to D) are unrolled up to
// 16 lanes; at 32 they stay rolled, as grp::mgs_rows's pivots, each step a
// forced-inline function so that the unrolled code is the plain loop's.

// c += ak B[k] (row k of B at Bk in shared memory)
template <typename S, int G>
__device__ __forceinline__ void row_acc(S ak, const S* Bk, S (&c)[G]) {
  S row[G];
  grp::ld<S, G>(Bk, row);
#pragma unroll
  for (int j = 0; j < G; ++j) c[j] = c[j] + ak * row[j];
}

// c = a B: c[j] = a[0] B[0][j] + a[1] B[1][j] + ... (B in shared memory,
// a row of B at a time; each entry summed over k in index order; the
// entries past D are not used)
template <typename S, int G>
__device__ __forceinline__ void row_times(const S (&a)[G], const S* B, int D,
                                          S (&c)[G]) {
  constexpr int P = Ws<G>::P;
  S row[G];
  grp::ld<S, G>(B, row);
#pragma unroll
  for (int j = 0; j < G; ++j) c[j] = a[0] * row[j];
  if constexpr (G <= 16) {
#pragma unroll
    for (int k = 1; k < G; ++k) {
      if (k >= D) break;
      row_acc<S, G>(a[k], B + k * P, c);
    }
  } else {
#pragma unroll 1
    for (int k = 1; k < G; ++k) {
      if (k >= D) break;
      row_acc<S, G>(a[k], B + k * P, c);
    }
  }
}

// a . B[j] = a[0] B[j][0] + a[1] B[j][1] + ... (row j at Bj)
template <typename S, int G>
__device__ __forceinline__ S row_dot(const S (&a)[G], const S* Bj, int D) {
  S row[G];
  grp::ld<S, G>(Bj, row);
  S acc = a[0] * row[0];
#pragma unroll
  for (int k = 1; k < G; ++k)
    if (k < D) acc = acc + a[k] * row[k];
  return acc;
}

// c = a B^T: c[j] = a[0] B[j][0] + a[1] B[j][1] + ...
template <typename S, int G>
__device__ __forceinline__ void row_times_t(const S (&a)[G], const S* B,
                                            int D, S (&c)[G]) {
  constexpr int P = Ws<G>::P;
  if constexpr (G <= 16) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j >= D) break;
      c[j] = row_dot<S, G>(a, B + j * P, D);
    }
  } else {
#pragma unroll 1
    for (int j = 0; j < G; ++j) {
      if (j >= D) break;
      c[j] = row_dot<S, G>(a, B + j * P, D);
    }
  }
}

// a . x = a[0] x[0] + a[1] x[1] + ... (x in shared memory)
template <typename S, int G>
__device__ __forceinline__ S dot(const S (&a)[G], const S* x, int D) {
  S xv[G];
  grp::ld<S, G>(x, xv);
  S acc = a[0] * xv[0];
#pragma unroll
  for (int k = 1; k < G; ++k)
    if (k < D) acc = acc + a[k] * xv[k];
  return acc;
}

// y[i] = (x[i] - L[i][0] y[0] - ... - L[i][i-1] y[i-1]) / L[i][i] (row i
// of L at Li)
template <typename S, int G>
__device__ __forceinline__ void fwd_step(const S* Li, const S (&x)[G], int i,
                                         S (&y)[G]) {
  S row[G];
  grp::ld<S, G>(Li, row);
  S s = x[i];
#pragma unroll
  for (int k = 0; k < i; ++k) s = s - row[k] * y[k];
  y[i] = s / row[i];
}

// Row r of Y solving L y = x by forward substitution (L lower, shared).
template <typename S, int G>
__device__ __forceinline__ void fwd_row(const S* L, const S (&x)[G], int D,
                                        S (&y)[G]) {
  constexpr int P = Ws<G>::P;
  if constexpr (G <= 16) {
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (i >= D) break;
      fwd_step<S, G>(L + i * P, x, i, y);
    }
  } else {
#pragma unroll 1
    for (int i = 0; i < G; ++i) {
      if (i >= D) break;
      fwd_step<S, G>(L + i * P, x, i, y);
    }
  }
}

// x[i] = (y[i] - L[i+1][i] x[i+1] - ...) / L[i][i], the terms past D
// skipped
template <typename S, int G>
__device__ __forceinline__ void back_step(const S* L, const S (&y)[G], int D,
                                          int i, S (&x)[G]) {
  constexpr int P = Ws<G>::P;
  S s = y[i];
#pragma unroll
  for (int k = i + 1; k < G; ++k)
    if (k < D) s = s - L[k * P + i] * x[k];
  x[i] = s / L[i * P + i];
}

// x solving L L^T x = b: forward, then back substitution (k ascending),
// dividing by the pivots (ek0::cho_solve).
template <typename S, int G>
__device__ __forceinline__ void cho_solve(const S* L, const S (&b)[G], int D,
                                          S (&x)[G]) {
  S y[G];
  fwd_row<S, G>(L, b, D, y);
  if constexpr (G <= 16) {
#pragma unroll
    for (int i = G - 1; i >= 0; --i)
      if (i < D) back_step<S, G>(L, y, D, i, x);
  } else {
#pragma unroll 1
    for (int i = G - 1; i >= 0; --i)
      if (i < D) back_step<S, G>(L, y, D, i, x);
  }
}

// The factors of NS stacks, one column a lane, into this lane's rows L.
template <typename S, int G, int NS, bool TRI>
__device__ __forceinline__ void factor(S (&col)[NS][2 * G], int D, int r,
                                       S* q, S (&L)[NS][G],
                                       const GroupSync<G>& sync) {
  grp::mgs_rows<S, G, 2 * G, NS, TRI>(col, D, r, q, L, sync);
}

// Stack column r of [X^T; Y^T] from row r of X and of Y (the second
// block at col[G ..], group_mgs.cuh).
template <typename S, int G>
__device__ __forceinline__ void stack2_col(const S (&x)[G], const S (&y)[G],
                                           int D, S (&col)[2 * G]) {
#pragma unroll
  for (int k = 0; k < G; ++k)
    if (k < D) {
      col[k] = x[k];
      col[G + k] = y[k];
    }
}

// Stack column r of [M^T; I] (or [M; I]) from m, row (column) r of M.
template <typename S, int G>
__device__ __forceinline__ void eye_col(const S (&m)[G], int D, int r,
                                        S (&col)[2 * G]) {
#pragma unroll
  for (int k = 0; k < G; ++k)
    if (k < D) {
      col[k] = m[k];
      col[G + k] = k == r ? S(1) : S(0);
    }
}

// The two factors a combine ends with: one two-stack factorization where
// the registers allow it (G <= 8), else one after the other.
template <typename S, int G, bool TRI>
__device__ __forceinline__ void factor2(S (&c0)[2 * G], S (&c1)[2 * G], int D,
                                        int r, S* q, S (&l0)[G], S (&l1)[G],
                                        const GroupSync<G>& sync) {
  if constexpr (G <= 8) {
    S col[2][2 * G], L[2][G];
#pragma unroll
    for (int k = 0; k < 2 * G; ++k) {
      col[0][k] = c0[k];
      col[1][k] = c1[k];
    }
    factor<S, G, 2, TRI>(col, D, r, q, L, sync);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      l0[j] = L[0][j];
      l1[j] = L[1][j];
    }
  } else {
    S col[1][2 * G], L[1][G];
#pragma unroll
    for (int k = 0; k < 2 * G; ++k) col[0][k] = c0[k];
    factor<S, G, 1, TRI>(col, D, r, q, L, sync);
#pragma unroll
    for (int j = 0; j < G; ++j) l0[j] = L[0][j];
    sync();
#pragma unroll
    for (int k = 0; k < 2 * G; ++k) col[0][k] = c1[k];
    factor<S, G, 1, TRI>(col, D, r, q, L, sync);
#pragma unroll
    for (int j = 0; j < G; ++j) l1[j] = L[0][j];
  }
}

// o = combine(a, b) for filtering elements (A, b, U, eta, Z): tp_scan.cuh's
// filter_combine by a group, lane r computing row r of every result. The
// operands are staged in the group's shared memory first (every global
// load issued at once), and a lane reads its own rows back from there, so
// that few rows stay live in registers. DC: the state dimension when it is
// known at compile time (D = G = 8), else 0 and D = d.
template <typename S, int G, int DC>
__device__ __noinline__ void filter_combine(const S* a, size_t sa,
                                            const S* b, size_t sb, S* o,
                                            size_t so, int d) {
  using W_ = Ws<G>;
  const int D = DC ? DC : d;
  const FilterOff Y(D);
  const GroupSync<G> sync;
  const int r = threadIdx.x % G;
  const bool act = r < D;
  S* ws = group_ws<S, G>();
  S* sU = ws;                 // Ui
  S* sZ = sU + W_::MAT;       // Zj
  S* sA = sZ + W_::MAT;       // Ai
  S* sAj = sA + W_::MAT;      // Aj
  S* sUj = sAj + W_::MAT;     // Uj
  S* sZi = sUj + W_::MAT;     // Zi
  S* sW = sZi + W_::MAT;      // W = Ui^T Zj, then V2 = Zj Lv^-T
  S* sLw = sW + W_::MAT;      // chol(I + W W^T)
  S* sLv = sLw + W_::MAT;     // chol(I + W^T W)
  S* sT = sLv + W_::MAT;      // G, then I - Ui G, then V1 = Ui Lw^-T
  S* v0 = ws + W_::NMAT * W_::MAT;  // etaj, then W^T Ui^T r
  S* v1 = v0 + G;                   // bi, then r - Zj x
  S* v2 = v1 + G;
  S* v3 = v2 + G;
  S* vbj = v3 + G;                  // bj
  S* vei = vbj + G;                 // etai
  S* q = vei + G;

  if (act) {
    stage_row<S, G>(a, sa, Y.U, D, r, sU);
    stage_row<S, G>(b, sb, Y.Z, D, r, sZ);
    stage_row<S, G>(a, sa, Y.A, D, r, sA);
    stage_row<S, G>(b, sb, Y.A, D, r, sAj);
    stage_row<S, G>(b, sb, Y.U, D, r, sUj);
    stage_row<S, G>(a, sa, Y.Z, D, r, sZi);
    v0[r] = __ldcg(b + (size_t)(Y.ETA + r) * sb);
    v1[r] = __ldcg(a + (size_t)(Y.B + r) * sa);
    vbj[r] = __ldcg(b + (size_t)(Y.B + r) * sb);
    vei[r] = __ldcg(a + (size_t)(Y.ETA + r) * sa);
  }
  sync();
  S w[G];
  if (act) {
    S t[G];
    get_col<S, G>(sU, D, r, t);
    row_times<S, G>(t, sZ, D, w);  // W = Ui^T Zj
    put_row<S, G>(sW, D, r, w);
  }
  sync();
  {
    // Lw = chol(I + W W^T), the MGS of [W^T; I]; Lv = chol(I + W^T W), of
    // [W; I]: column r of each stack from row r and column r of W
    S c0[2 * G], c1[2 * G], lw[G], lv[G];
    if (act) {
      S t[G];
      get_col<S, G>(sW, D, r, t);
      eye_col<S, G>(w, D, r, c0);
      eye_col<S, G>(t, D, r, c1);
    }
    factor2<S, G, true>(c0, c1, D, r, q, lw, lv, sync);
    if (act) {
      put_row<S, G>(sLw, D, r, lw);
      put_row<S, G>(sLv, D, r, lv);
    }
  }
  // G = (Lw Lw^T)^-1 W Zj^T, a column a lane
  if (act) {
    S wz[G];
    row_times_t<S, G>(w, sZ, D, wz);  // W Zj^T
    put_row<S, G>(sT, D, r, wz);
  }
  sync();
  S gcol[G];
  if (act) {
    S bc[G];
    get_col<S, G>(sT, D, r, bc);
    cho_solve<S, G>(sLw, bc, D, gcol);
  }
  sync();
  if (act) {
#pragma unroll
    for (int i = 0; i < G; ++i)
      if (i < D) sT[i * W_::P + r] = gcol[i];
  }
  sync();
  // AjT = Aj (I - Ui G); A = AjT Ai
  S m2[G];
  if (act) {
    S ui[G];
    get_row<S, G>(sU, D, r, ui);
    row_times<S, G>(ui, sT, D, m2);  // Ui G
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (j < D) m2[j] = (r == j ? S(1) : S(0)) - m2[j];
  }
  sync();
  if (act) put_row<S, G>(sT, D, r, m2);
  sync();
  S ajt[G];
  if (act) {
    S aj[G], an[G], t[G];
    get_row<S, G>(sAj, D, r, aj);
    row_times<S, G>(aj, sT, D, ajt);
    row_times<S, G>(ajt, sA, D, an);
    store_row<S, G>(o, so, Y.A, D, r, an);
    // b = AjT (bi + Ui Ui^T etaj) + bj
    get_col<S, G>(sU, D, r, t);
    v2[r] = dot<S, G>(t, v0, D);  // Ui^T etaj
  }
  sync();
  if (act) {
    S ui[G];
    get_row<S, G>(sU, D, r, ui);
    v3[r] = v1[r] + dot<S, G>(ui, v2, D);  // bi + Ui y
  }
  sync();
  if (act) {
    __stcg(o + (size_t)(Y.B + r) * so, dot<S, G>(ajt, v3, D) + vbj[r]);
    // eta = Ai^T [r - Zj (Lv Lv^T)^-1 W^T Ui^T r] + etai,
    // r = etaj - Zj Zj^T bi
    S t[G];
    get_col<S, G>(sZ, D, r, t);
    v2[r] = dot<S, G>(t, v1, D);  // Zj^T bi
  }
  sync();
  S rr = S(0);
  if (act) {
    S zj[G];
    get_row<S, G>(sZ, D, r, zj);
    rr = v0[r] - dot<S, G>(zj, v2, D);
    v3[r] = rr;
  }
  sync();
  if (act) {
    S t[G];
    get_col<S, G>(sU, D, r, t);
    v2[r] = dot<S, G>(t, v3, D);  // Ui^T r
  }
  sync();
  if (act) {
    S t[G];
    get_col<S, G>(sW, D, r, t);
    v0[r] = dot<S, G>(t, v2, D);  // W^T x
  }
  sync();
  if (act) {
    // every lane solves the whole (Lv Lv^T) x = y, the same operations
    S y[G], x[G], zj[G];
#pragma unroll
    for (int k = 0; k < G; ++k)
      if (k < D) y[k] = v0[k];
    cho_solve<S, G>(sLv, y, D, x);
    get_row<S, G>(sZ, D, r, zj);
    S zx = zj[0] * x[0];
#pragma unroll
    for (int k = 1; k < G; ++k)
      if (k < D) zx = zx + zj[k] * x[k];
    v1[r] = rr - zx;
  }
  sync();
  if (act) {
    S t[G];
    get_col<S, G>(sA, D, r, t);
    __stcg(o + (size_t)(Y.ETA + r) * so, dot<S, G>(t, v1, D) + vei[r]);
    // U = tril of [(Aj V1)^T; Uj^T], V1 = Ui Lw^-T; Z = tril of
    // [(Ai^T V2)^T; Zi^T], V2 = Zj Lv^-T: row r of V1 solves Lw y = Ui[r],
    // row r of V2 solves Lv y = Zj[r]
    S x[G], y[G];
    get_row<S, G>(sU, D, r, x);
    fwd_row<S, G>(sLw, x, D, y);
    put_row<S, G>(sT, D, r, y);
    get_row<S, G>(sZ, D, r, x);
    fwd_row<S, G>(sLv, x, D, y);
    put_row<S, G>(sW, D, r, y);
  }
  sync();
  S cu[2 * G], cz[2 * G], lu[G], lz[G];
  if (act) {
    S x[G], y[G];
    get_row<S, G>(sAj, D, r, x);
    row_times<S, G>(x, sT, D, y);  // Aj V1
    get_row<S, G>(sUj, D, r, x);
    stack2_col<S, G>(y, x, D, cu);
    get_col<S, G>(sA, D, r, x);
    row_times<S, G>(x, sW, D, y);  // Ai^T V2
    get_row<S, G>(sZi, D, r, x);
    stack2_col<S, G>(y, x, D, cz);
  }
  factor2<S, G, false>(cu, cz, D, r, q, lu, lz, sync);
  if (act) {
    store_row<S, G>(o, so, Y.U, D, r, lu);
    store_row<S, G>(o, so, Y.Z, D, r, lz);
  }
  sync();
}

// o = combine(a, b) for smoothing elements (E, g, P), a the accumulated
// suffix: tp_scan.cuh's smooth_combine by a group.
template <typename S, int G, int DC>
__device__ __noinline__ void smooth_combine(const S* a, size_t sa,
                                            const S* b, size_t sb, S* o,
                                            size_t so, int d) {
  using W_ = Ws<G>;
  const int D = DC ? DC : d;
  const SmoothOff Y(D);
  const GroupSync<G> sync;
  const int r = threadIdx.x % G;
  const bool act = r < D;
  S* ws = group_ws<S, G>();
  S* sE = ws;             // Ea
  S* sP = ws + W_::MAT;   // Pa
  S* v0 = ws + W_::NMAT * W_::MAT;
  S* q = v0 + W_::NVEC * G;
  S eb[G], pb[G], gb = S(0);
  if (act) {
    load_row<S, G>(b, sb, Y.E, D, r, eb);
    load_row<S, G>(b, sb, Y.P, D, r, pb);
    gb = __ldcg(b + (size_t)(Y.G + r) * sb);
    stage_row<S, G>(a, sa, Y.E, D, r, sE);
    stage_row<S, G>(a, sa, Y.P, D, r, sP);
    v0[r] = __ldcg(a + (size_t)(Y.G + r) * sa);
  }
  sync();
  S col[1][2 * G], L[1][G];
  if (act) {
    S e[G], ep[G];
    row_times<S, G>(eb, sE, D, e);  // Eb Ea
    store_row<S, G>(o, so, Y.E, D, r, e);
    __stcg(o + (size_t)(Y.G + r) * so, gb + dot<S, G>(eb, v0, D));  // + Eb ga
    row_times<S, G>(eb, sP, D, ep);  // Eb Pa
    stack2_col<S, G>(pb, ep, D, col[0]);
  }
  factor<S, G, 1, false>(col, D, r, q, L, sync);
  if (act) store_row<S, G>(o, so, Y.P, D, r, L[0]);
  sync();
}

// Copy an element of V values, a value every G lanes.
template <typename S, int G>
__device__ __forceinline__ void copy_elem(const S* a, size_t sa, S* o,
                                          size_t so, int V) {
  for (int v = threadIdx.x % G; v < V; v += G)
    __stcg(o + (size_t)v * so, __ldcg(a + (size_t)v * sa));
}

template <typename S, int G, bool FILTER, int DC>
__device__ __forceinline__ void combine(const S* a, size_t sa, const S* b,
                                        size_t sb, S* o, size_t so, int D) {
  if constexpr (FILTER)
    filter_combine<S, G, DC>(a, sa, b, sb, o, so, D);
  else
    smooth_combine<S, G, DC>(a, sa, b, sb, o, so, D);
}

__device__ __forceinline__ int width(bool filter, int D) {
  return filter ? 3 * D * D + 2 * D : 2 * D * D + D;
}

// Threads per CTA at group size G: BLOCK, except float64 at G = 32, whose
// group workspace (85.5 kB) lets two groups share a CTA.
template <typename S, int G>
__host__ __device__ constexpr int block_of() {
  return sizeof(S) == 8 && G == 32 ? 64 : BLOCK;
}

// Chunk totals per group in the cooperative totals scan: 1, except at
// G = 32, where an SM holds one CTA of 4 (float32) or 2 (float64) groups
// and 1024 groups would not all be resident at once (a grid barrier needs
// them so): 2 (float32) or 4 (float64) totals a group, 128 CTAs.
template <typename S, int G>
__host__ __device__ constexpr int totals_per_group() {
  return G < 32 ? 1 : sizeof(S) == 8 ? 4 : 2;
}

// ---- the three kernels (a group per combine) and their launches ----

// prefixes[k][c] = combine(prefixes[k-1][c], elems[k][c]): a group per
// chunk c over its L rows.
template <typename S, int G, bool FILTER>
__global__ void __launch_bounds__(BLOCK)
    tp_chunk_scan_group_kernel(const S* __restrict__ elems,
                               S* __restrict__ out, int L, int D) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  const int V = width(FILTER, D);
  const size_t row = (size_t)V * NC;
  const GroupSync<G> sync;
  copy_elem<S, G>(elems + c, NC, out + c, NC, V);
  sync();
  for (int k = 1; k < L; ++k)
    combine<S, G, FILTER, 0>(out + (k - 1) * row + c, NC,
                             elems + k * row + c, NC, out + k * row + c, NC,
                             D);
}

// The inclusive scan of the chunk totals (V, 1024), shifted by one into
// out, as tp_scan.cuh's tp_totals_scan_kernel: a group per total (or
// totals_per_group of them, one after another within each round), 1024
// totals, cooperative; work: two (V, 1024) buffers. DC: D when known at
// compile time, else 0.
template <typename S, int G, bool FILTER, int DC>
__global__ void __launch_bounds__(BLOCK)
    tp_totals_scan_group_kernel(const S* __restrict__ totals, S* work,
                                S* __restrict__ out, int D) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  constexpr int TPG = totals_per_group<S, G>();
  constexpr int NG = NC / TPG;  // groups in the grid
  const int g0 = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  const int V = width(FILTER, D);
  const size_t size = (size_t)V * NC;
  const S* src = totals;
  int w = 0;
  for (int shift = 1; shift < NC; shift <<= 1) {
    const bool last = 2 * shift >= NC;
    S* dst = last ? out : work + w * size;
#pragma unroll
    for (int t = 0; t < TPG; ++t) {
      const int i = g0 + t * NG;
      const int o = last ? (i + 1) % NC : i;
      if (i >= shift)
        combine<S, G, FILTER, DC>(src + (i - shift), NC, src + i, NC,
                                  dst + o, NC, D);
      else
        copy_elem<S, G>(src + i, NC, dst + o, NC, V);
    }
    if (!last) {
      grid.sync();
      src = work + w * size;
      w ^= 1;
    }
  }
}

// out[k][c] = combine(t_excl[c], prefixes[k][c]) for c > 0, out[k][0] =
// prefixes[k][0]: a group per element.
template <typename S, int G, bool FILTER>
__global__ void __launch_bounds__(BLOCK)
    tp_fixup_group_kernel(const S* __restrict__ prefixes,
                          const S* __restrict__ t_excl, S* __restrict__ out,
                          int L, int D) {
  const size_t t = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (t >= (size_t)L * NC) return;  // whole groups
  const int V = width(FILTER, D);
  const int k = (int)(t / NC), c = (int)(t % NC);
  const size_t at = (size_t)k * V * NC + c;
  if (c == 0)
    copy_elem<S, G>(prefixes + at, NC, out + at, NC, V);
  else
    combine<S, G, FILTER, 0>(t_excl + c, NC, prefixes + at, NC, out + at, NC,
                             D);
}

template <typename S, int G>
constexpr size_t smem_bytes() {
  return (size_t)(block_of<S, G>() / G) * Ws<G>::SIZE * sizeof(S);
}

// Dynamic shared memory above the 48 kB default must be asked for per
// kernel.
inline int allow_smem(const void* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename S, int G, bool FILTER>
int chunk_scan(const void* elems, void* out, int L, int D, void* stream) {
  const void* kern = (const void*)tp_chunk_scan_group_kernel<S, G, FILTER>;
  const size_t sh = smem_bytes<S, G>();
  int e = allow_smem(kern, sh);
  if (e) return e;
  constexpr int bl = block_of<S, G>();
  tp_chunk_scan_group_kernel<S, G, FILTER>
      <<<NC * G / bl, bl, sh, (cudaStream_t)stream>>>((const S*)elems,
                                                      (S*)out, L, D);
  return (int)cudaGetLastError();
}

template <typename S, int G, bool FILTER, int DC = 0>
int totals_scan(const void* totals, void* work, void* out, int D,
                void* stream) {
  const void* kern =
      (const void*)tp_totals_scan_group_kernel<S, G, FILTER, DC>;
  const size_t sh = smem_bytes<S, G>();
  int e = allow_smem(kern, sh);
  if (e) return e;
  const S* tp_ = (const S*)totals;
  S *wp = (S*)work, *op = (S*)out;
  void* args[] = {&tp_, &wp, &op, &D};
  constexpr int bl = block_of<S, G>();
  return coop::launch_cooperative(
      kern, NC * G / bl / totals_per_group<S, G>(), bl, args, sh, stream);
}

template <typename S, int G, bool FILTER>
int fixup(const void* prefixes, const void* t_excl, void* out, int L, int D,
          void* stream) {
  const void* kern = (const void*)tp_fixup_group_kernel<S, G, FILTER>;
  const size_t sh = smem_bytes<S, G>();
  int e = allow_smem(kern, sh);
  if (e) return e;
  constexpr int bl = block_of<S, G>();
  const int nb = (int)(((size_t)L * NC * G + bl - 1) / bl);
  tp_fixup_group_kernel<S, G, FILTER><<<nb, bl, sh, (cudaStream_t)stream>>>(
      (const S*)prefixes, (const S*)t_excl, (S*)out, L, D);
  return (int)cudaGetLastError();
}

// The three kernels at group size G: op 0 the chunk scan (elems a, out o),
// 1 the totals scan (totals a, work w, out o), 2 the fixup (prefixes a,
// t_excl b, out o); kind 0 filtering, 1 smoothing elements. D = G = 8 (the
// solver's d = 2, q = 3) is compiled with D known in the totals scan.
template <typename S, int G>
int run(int op, int kind, int D, const void* a, const void* b, void* w,
        void* o, int L, void* stream) {
  if (kind != 0 && kind != 1) return (int)cudaErrorInvalidValue;
  const bool f = kind == 0;
  if (op == 1) {
    if constexpr (G == 8) {
      if (D == 8)
        return f ? totals_scan<S, 8, true, 8>(a, w, o, D, stream)
                 : totals_scan<S, 8, false, 8>(a, w, o, D, stream);
    }
    return f ? totals_scan<S, G, true>(a, w, o, D, stream)
             : totals_scan<S, G, false>(a, w, o, D, stream);
  }
  if (L < 1) return (int)cudaErrorInvalidValue;
  if (op == 0)
    return f ? chunk_scan<S, G, true>(a, o, L, D, stream)
             : chunk_scan<S, G, false>(a, o, L, D, stream);
  if (op == 2)
    return f ? fixup<S, G, true>(a, b, o, L, D, stream)
             : fixup<S, G, false>(a, b, o, L, D, stream);
  return (int)cudaErrorInvalidValue;
}

using RunFn = int (*)(int, int, int, const void*, const void*, void*, void*,
                     int, void*);

// run at the group size for D, 2 <= D <= 32; group sizes 16 and 32
// through run16 and run32 (each built in a unit of its own).
template <typename S>
int run_for(int op, int kind, int D, const void* a, const void* b, void* w,
            void* o, int L, void* stream, RunFn run16, RunFn run32) {
  if (D < 2 || D > D_MAX) return (int)cudaErrorInvalidValue;
  switch (group_for(D)) {
    case 2: return run<S, 2>(op, kind, D, a, b, w, o, L, stream);
    case 4: return run<S, 4>(op, kind, D, a, b, w, o, L, stream);
    case 8: return run<S, 8>(op, kind, D, a, b, w, o, L, stream);
    case 16: return run16(op, kind, D, a, b, w, o, L, stream);
    default: return run32(op, kind, D, a, b, w, o, L, stream);
  }
}

}  // namespace tpg
