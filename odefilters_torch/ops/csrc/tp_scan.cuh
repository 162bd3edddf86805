// The fused time-parallel scan kernels (tp_scan.cu has the design): the
// square-root filtering and smoothing combines, in the order of operations
// of their plain PyTorch versions (odefilters_torch/ops/tp_scan.py:
// filter_combine, smooth_combine; every sum over an index in index order),
// the one-thread chunk scan and fixup at D = 8 that call them, and their
// launches (tp_group.cuh runs the totals scan, and every other D).
//
// An element is V values at p[v * s], v = 0..V-1: a packed (rows, V, 1024)
// tensor holds element (k, c) at p = base + k V 1024 + c, s = 1024, so a
// thread per chunk reads coalesced. Loads and stores go through L2
// (__ldcg / __stcg).
#pragma once

#include <cuda_runtime.h>

#include "ek0_sample.cuh"   // ek0::mgs_tril, ek0::cho_solve

namespace tp {

constexpr int NC = 1024;  // chunks

// Offsets of the leaves in a packed element.
template <int D>
struct FilterLayout {  // (A, b, U, eta, Z)
  static constexpr int A = 0, B = D * D, U = D * D + D, ETA = 2 * D * D + D,
                       Z = 2 * D * D + 2 * D, V = 3 * D * D + 2 * D;
};

template <int D>
struct SmoothLayout {  // (E, g, P)
  static constexpr int E = 0, G = D * D, P = D * D + D, V = 2 * D * D + D;
};

template <typename S, int D>
__device__ __forceinline__ void load_mat(const S* p, size_t s, int off,
                                         S (&M)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) M[i][j] = __ldcg(p + (size_t)(off + i * D + j) * s);
}

template <typename S, int D>
__device__ __forceinline__ void load_vec(const S* p, size_t s, int off,
                                         S (&x)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) x[i] = __ldcg(p + (size_t)(off + i) * s);
}

template <typename S, int D>
__device__ __forceinline__ void store_mat(S* p, size_t s, int off,
                                          const S (&M)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) __stcg(p + (size_t)(off + i * D + j) * s, M[i][j]);
}

template <typename S, int D>
__device__ __forceinline__ void store_vec(S* p, size_t s, int off,
                                          const S (&x)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) __stcg(p + (size_t)(off + i) * s, x[i]);
}

// Copy an element of V values.
template <typename S, int V>
__device__ __forceinline__ void copy_elem(const S* a, size_t sa, S* o,
                                          size_t so) {
  for (int v = 0; v < V; ++v) __stcg(o + (size_t)v * so, __ldcg(a + (size_t)v * sa));
}

// C = A B (TA: A^T; TB: B^T), each entry summed over k in index order.
template <typename S, int D, bool TA, bool TB>
__device__ __forceinline__ void mm(const S (&A)[D][D], const S (&B)[D][D],
                                   S (&C)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      S acc = (TA ? A[0][i] : A[i][0]) * (TB ? B[j][0] : B[0][j]);
#pragma unroll
      for (int k = 1; k < D; ++k)
        acc = acc + (TA ? A[k][i] : A[i][k]) * (TB ? B[j][k] : B[k][j]);
      C[i][j] = acc;
    }
}

// y = A x (TA: A^T x), summed over k in index order.
template <typename S, int D, bool TA>
__device__ __forceinline__ void mv(const S (&A)[D][D], const S (&x)[D],
                                   S (&y)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    S acc = (TA ? A[0][i] : A[i][0]) * x[0];
#pragma unroll
    for (int k = 1; k < D; ++k) acc = acc + (TA ? A[k][i] : A[i][k]) * x[k];
    y[i] = acc;
  }
}

// Row r of Y solves L y = X[r] by forward substitution (lower L).
template <typename S, int D>
__device__ __forceinline__ void fwd_rows(const S (&L)[D][D],
                                         const S (&X)[D][D], S (&Y)[D][D]) {
#pragma unroll
  for (int r = 0; r < D; ++r)
#pragma unroll
    for (int i = 0; i < D; ++i) {
      S s = X[r][i];
#pragma unroll
      for (int k = 0; k < i; ++k) s = s - L[i][k] * Y[r][k];
      Y[r][i] = s / L[i][i];
    }
}

// Column c of X solves L L^T x = B[:, c].
template <typename S, int D>
__device__ __forceinline__ void cho_solve_cols(const S (&L)[D][D],
                                               const S (&B)[D][D],
                                               S (&X)[D][D]) {
#pragma unroll
  for (int c = 0; c < D; ++c) {
    S b[D], x[D];
#pragma unroll
    for (int i = 0; i < D; ++i) b[i] = B[i][c];
    ek0::cho_solve<S, D>(L, b, x);
#pragma unroll
    for (int i = 0; i < D; ++i) X[i][c] = x[i];
  }
}

// Lower L with L L^T = I + M M^T (TM: I + M^T M), the MGS of the stack
// [M^T; I] ([M; I]); the identity block's structural zeros are skipped.
template <typename S, int D, bool TM>
__device__ __forceinline__ void chol_I_plus(const S (&M)[D][D],
                                            S (&L)[D][D]) {
  S v[2 * D][D];
#pragma unroll
  for (int k = 0; k < D; ++k)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      v[k][j] = TM ? M[k][j] : M[j][k];
      v[D + k][j] = j == k ? S(1) : S(0);
    }
  ek0::mgs_tril<S, D, 2 * D, true>(v, L);
}

// Lower L with L L^T = X X^T + Y Y^T, the MGS of the stack [X^T; Y^T].
template <typename S, int D>
__device__ __forceinline__ void stack2_factor(const S (&X)[D][D],
                                              const S (&Y)[D][D],
                                              S (&L)[D][D]) {
  S v[2 * D][D];
#pragma unroll
  for (int k = 0; k < D; ++k)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      v[k][j] = X[j][k];
      v[D + k][j] = Y[j][k];
    }
  ek0::mgs_tril<S, D, 2 * D, false>(v, L);
}

// o = combine(a, b) for filtering elements (A, b, U, eta, Z): the
// square-root combine of pallas_scan.py's _filter_combine_lists. Not inlined:
// the two kernels share one body per dtype.
template <typename S, int D>
__device__ __noinline__ void filter_combine(const S* a, size_t sa,
                                            const S* b, size_t sb, S* o,
                                            size_t so) {
  using Y = FilterLayout<D>;
  S W[D][D], Lw[D][D], Lv[D][D], AjT[D][D];
  {
    S Ui[D][D], Zj[D][D];
    load_mat<S, D>(a, sa, Y::U, Ui);
    load_mat<S, D>(b, sb, Y::Z, Zj);
    mm<S, D, true, false>(Ui, Zj, W);
  }
  chol_I_plus<S, D, false>(W, Lw);  // chol(I + W W^T)
  chol_I_plus<S, D, true>(W, Lv);   // chol(I + W^T W)
  {
    // AjT = Aj (I - Ui (Lw Lw^T)^-1 W Zj^T); A = AjT Ai
    S Ui[D][D], M1[D][D], M2[D][D];
    load_mat<S, D>(b, sb, Y::Z, M1);
    mm<S, D, false, true>(W, M1, M2);  // W Zj^T
    cho_solve_cols<S, D>(Lw, M2, M1);  // G
    load_mat<S, D>(a, sa, Y::U, Ui);
    mm<S, D, false, false>(Ui, M1, M2);  // Ui G
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) M2[i][j] = (i == j ? S(1) : S(0)) - M2[i][j];
    load_mat<S, D>(b, sb, Y::A, M1);  // Aj
    mm<S, D, false, false>(M1, M2, AjT);
    load_mat<S, D>(a, sa, Y::A, M1);  // Ai
    mm<S, D, false, false>(AjT, M1, M2);
    store_mat<S, D>(o, so, Y::A, M2);
    // b = AjT (bi + Ui Ui^T etaj) + bj
    S x[D], y[D], z[D];
    load_vec<S, D>(b, sb, Y::ETA, x);
    mv<S, D, true>(Ui, x, y);
    mv<S, D, false>(Ui, y, z);
    load_vec<S, D>(a, sa, Y::B, x);
#pragma unroll
    for (int i = 0; i < D; ++i) y[i] = x[i] + z[i];
    mv<S, D, false>(AjT, y, z);
    load_vec<S, D>(b, sb, Y::B, x);
#pragma unroll
    for (int i = 0; i < D; ++i) y[i] = z[i] + x[i];
    store_vec<S, D>(o, so, Y::B, y);
    // U = tril of [(Aj V1)^T ; Uj^T], V1 = Ui Lw^-T
    fwd_rows<S, D>(Lw, Ui, M1);
    load_mat<S, D>(b, sb, Y::A, M2);  // Aj
    mm<S, D, false, false>(M2, M1, AjT);
    load_mat<S, D>(b, sb, Y::U, M2);  // Uj
    stack2_factor<S, D>(AjT, M2, M1);
    store_mat<S, D>(o, so, Y::U, M1);
  }
  {
    // eta = Ai^T [r - Zj (Lv Lv^T)^-1 W^T Ui^T r] + etai,
    // r = etaj - Zj Zj^T bi
    S Zj[D][D], M1[D][D], r[D], x[D], y[D];
    load_mat<S, D>(b, sb, Y::Z, Zj);
    load_vec<S, D>(a, sa, Y::B, x);
    mv<S, D, true>(Zj, x, y);
    mv<S, D, false>(Zj, y, x);
    load_vec<S, D>(b, sb, Y::ETA, y);
#pragma unroll
    for (int i = 0; i < D; ++i) r[i] = y[i] - x[i];
    load_mat<S, D>(a, sa, Y::U, M1);  // Ui
    mv<S, D, true>(M1, r, x);
    mv<S, D, true>(W, x, y);
    ek0::cho_solve<S, D>(Lv, y, x);
    mv<S, D, false>(Zj, x, y);
#pragma unroll
    for (int i = 0; i < D; ++i) x[i] = r[i] - y[i];
    load_mat<S, D>(a, sa, Y::A, M1);  // Ai
    mv<S, D, true>(M1, x, y);
    load_vec<S, D>(a, sa, Y::ETA, x);
#pragma unroll
    for (int i = 0; i < D; ++i) r[i] = y[i] + x[i];
    store_vec<S, D>(o, so, Y::ETA, r);
    // Z = tril of [(Ai^T V2)^T ; Zi^T], V2 = Zj Lv^-T
    S V2[D][D], M2[D][D];
    fwd_rows<S, D>(Lv, Zj, V2);
    mm<S, D, true, false>(M1, V2, M2);
    load_mat<S, D>(a, sa, Y::Z, Zj);  // Zi
    stack2_factor<S, D>(M2, Zj, V2);
    store_mat<S, D>(o, so, Y::Z, V2);
  }
}

// o = combine(a, b) for smoothing elements (E, g, P), a the accumulated
// suffix: pallas_scan.py's _smooth_combine_lists.
template <typename S, int D>
__device__ __noinline__ void smooth_combine(const S* a, size_t sa,
                                            const S* b, size_t sb, S* o,
                                            size_t so) {
  using Y = SmoothLayout<D>;
  S Eb[D][D], M1[D][D], M2[D][D], x[D], y[D];
  load_mat<S, D>(b, sb, Y::E, Eb);
  load_mat<S, D>(a, sa, Y::E, M1);
  mm<S, D, false, false>(Eb, M1, M2);
  store_mat<S, D>(o, so, Y::E, M2);
  load_vec<S, D>(a, sa, Y::G, x);
  mv<S, D, false>(Eb, x, y);
  load_vec<S, D>(b, sb, Y::G, x);
#pragma unroll
  for (int i = 0; i < D; ++i) x[i] = x[i] + y[i];
  store_vec<S, D>(o, so, Y::G, x);
  load_mat<S, D>(a, sa, Y::P, M1);
  mm<S, D, false, false>(Eb, M1, M2);  // Eb Pa
  load_mat<S, D>(b, sb, Y::P, M1);     // Pb
  stack2_factor<S, D>(M1, M2, Eb);
  store_mat<S, D>(o, so, Y::P, Eb);
}

// The two element kinds at state dimension D.
template <typename S, int D>
struct FilterKind {
  static constexpr int V = FilterLayout<D>::V;
  static __device__ __forceinline__ void combine(const S* a, size_t sa,
                                                 const S* b, size_t sb, S* o,
                                                 size_t so) {
    filter_combine<S, D>(a, sa, b, sb, o, so);
  }
};

template <typename S, int D>
struct SmoothKind {
  static constexpr int V = SmoothLayout<D>::V;
  static __device__ __forceinline__ void combine(const S* a, size_t sa,
                                                 const S* b, size_t sb, S* o,
                                                 size_t so) {
    smooth_combine<S, D>(a, sa, b, sb, o, so);
  }
};

// ---- the two kernels and their launches, instantiated by tp_scan.cu
// (float32) and tp_scan_f64.cu (float64): two translation units, which nvcc
// builds in parallel ----

constexpr int KD = 8;             // the instantiated state dimension
constexpr int CHUNK_BLOCK = 32;   // threads per CTA, chunk scan
constexpr int FIXUP_BLOCK = 64;   // threads per CTA, fixup

// prefixes[k][c] = combine(prefixes[k-1][c], elems[k][c]), prefixes[0] =
// elems[0]; both (L, V, 1024).
template <typename S, class K>
__global__ void __launch_bounds__(CHUNK_BLOCK)
    tp_chunk_scan_kernel(const S* __restrict__ elems, S* __restrict__ out,
                         int L) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= NC) return;
  const size_t row = (size_t)K::V * NC;
  copy_elem<S, K::V>(elems + c, NC, out + c, NC);
  for (int k = 1; k < L; ++k)
    K::combine(out + (k - 1) * row + c, NC, elems + k * row + c, NC,
               out + k * row + c, NC);
}

// out[k][c] = combine(t_excl[c], prefixes[k][c]) for c > 0, out[k][0] =
// prefixes[k][0]; a thread per element.
template <typename S, class K>
__global__ void __launch_bounds__(FIXUP_BLOCK)
    tp_fixup_kernel(const S* __restrict__ prefixes,
                    const S* __restrict__ t_excl, S* __restrict__ out,
                    int L) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)L * NC) return;
  const int k = (int)(t / NC), c = (int)(t % NC);
  const size_t at = (size_t)k * K::V * NC + c;
  if (c == 0)
    copy_elem<S, K::V>(prefixes + at, NC, out + at, NC);
  else
    K::combine(t_excl + c, NC, prefixes + at, NC, out + at, NC);
}

template <typename S, class K>
int chunk_scan(const void* elems, void* out, int L, void* stream) {
  if (L < 1) return (int)cudaErrorInvalidValue;
  tp_chunk_scan_kernel<S, K><<<NC / CHUNK_BLOCK, CHUNK_BLOCK, 0,
                               (cudaStream_t)stream>>>((const S*)elems,
                                                       (S*)out, L);
  return (int)cudaGetLastError();
}

template <typename S, class K>
int fixup(const void* prefixes, const void* t_excl, void* out, int L,
          void* stream) {
  if (L < 1) return (int)cudaErrorInvalidValue;
  const int nb = (int)(((size_t)L * NC + FIXUP_BLOCK - 1) / FIXUP_BLOCK);
  tp_fixup_kernel<S, K><<<nb, FIXUP_BLOCK, 0, (cudaStream_t)stream>>>(
      (const S*)prefixes, (const S*)t_excl, (S*)out, L);
  return (int)cudaGetLastError();
}

template <typename S>
int chunk_scan_kind(int kind, const void* elems, void* out, int L,
                    void* stream) {
  if (kind == 0) return chunk_scan<S, FilterKind<S, KD>>(elems, out, L, stream);
  if (kind == 1) return chunk_scan<S, SmoothKind<S, KD>>(elems, out, L, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename S>
int fixup_kind(int kind, const void* prefixes, const void* t_excl, void* out,
               int L, void* stream) {
  if (kind == 0)
    return fixup<S, FilterKind<S, KD>>(prefixes, t_excl, out, L, stream);
  if (kind == 1)
    return fixup<S, SmoothKind<S, KD>>(prefixes, t_excl, out, L, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tp
