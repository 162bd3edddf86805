// The modified Gram-Schmidt of ek0_sample.cuh (ek0::mgs_tril) spread over
// a group of lanes, for the kernels that hold one element or one member in
// a group (tp_group.cuh, ek1_group.cuh). Lane l owns column l of the stack
// in registers; column j's pivot lane forms its norm and its scaled
// column, which it publishes in shared memory, and every later lane takes
// its dot product with that column and updates its own. Each entry is
// formed by the operations of ek0::mgs_tril in the same order (every sum
// over the stack rows in index order, pivots sqrt(max(ss, 1e-30)) and
// their reciprocals 1 / R, the terms through structural zeros skipped), so
// the factor is bit for bit the one-thread body's.
#pragma once

#include "ek0_common.cuh"  // sqrt_, floor_at

namespace grp {

// x = p[0 .. K-1] from shared memory in 16-byte loads (p 16-byte aligned).
template <typename S, int K>
__device__ __forceinline__ void ld(const S* p, S (&x)[K]) {
  if constexpr (sizeof(S) == 4 && K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      x[4 * i] = v.x;
      x[4 * i + 1] = v.y;
      x[4 * i + 2] = v.z;
      x[4 * i + 3] = v.w;
    }
  } else if constexpr (sizeof(S) == 8 && K % 2 == 0) {
#pragma unroll
    for (int i = 0; i < K / 2; ++i) {
      const double2 v = reinterpret_cast<const double2*>(p)[i];
      x[2 * i] = v.x;
      x[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) x[i] = p[i];
  }
}

// p[0 .. K-1] = x in shared memory in 16-byte stores (p 16-byte aligned).
template <typename S, int K>
__device__ __forceinline__ void st(S* p, const S (&x)[K]) {
  if constexpr (sizeof(S) == 4 && K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
  } else if constexpr (sizeof(S) == 8 && K % 2 == 0) {
#pragma unroll
    for (int i = 0; i < K / 2; ++i)
      reinterpret_cast<double2*>(p)[i] = make_double2(x[2 * i], x[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) p[i] = x[i];
  }
}

// The stack is KM / GM blocks of D rows (D <= GM, D at run time); a
// lane's column keeps block b's rows at col[b GM .. b GM + D - 1], so that
// every index is known at compile time, and the entries past D in each
// block are not rows of the stack.
template <int GM>
__device__ __forceinline__ bool live(int k, int D) {
  return k % GM < D;
}

// Entry k of stack column j is a structural zero of a TRI stack [M; I]
// (the identity block's rows below its diagonal), as ek0::stack_zero.
template <int GM, bool TRI>
__device__ __forceinline__ bool tri_zero(int k, int j) {
  return TRI && k >= GM && j < k - GM;
}

// Pivot j of mgs_rows (below): its lane forms the norm and the scaled
// column and publishes them, and every later lane takes its dot product and
// updates its own column.
template <typename S, int GM, int KM, int NS, bool TRI, class Sync>
__device__ __forceinline__ void mgs_pivot(S (&col)[NS][KM], int D, int lane,
                                          S* q, S (&L)[NS][GM], Sync sync,
                                          int j) {
  S* qj = q + (j & 1) * NS * KM;
  if (lane == j) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      S ss = S(0);
#pragma unroll
      for (int k = 0; k < KM; ++k)
        if (live<GM>(k, D) && !tri_zero<GM, TRI>(k, j))
          ss += col[s][k] * col[s][k];
      const S rjj = ek0::sqrt_(ek0::floor_at(ss, S(1e-30)));
      const S inv = S(1) / rjj;
      L[s][j] = rjj;
      S qv[KM];
#pragma unroll
      for (int k = 0; k < KM; ++k)
        qv[k] = live<GM>(k, D) && !tri_zero<GM, TRI>(k, j) ? col[s][k] * inv
                                                           : S(0);
      st<S, KM>(qj + s * KM, qv);
    }
  }
  sync();
  if (lane > j && lane < D) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      S qv[KM];
      ld<S, KM>(qj + s * KM, qv);
      S r = S(0);
#pragma unroll
      for (int k = 0; k < KM; ++k)
        if (live<GM>(k, D) && !tri_zero<GM, TRI>(k, j))
          r += qv[k] * col[s][k];
      L[s][j] = r;
#pragma unroll
      for (int k = 0; k < KM; ++k)
        if (live<GM>(k, D) && !tri_zero<GM, TRI>(k, j))
          col[s][k] = col[s][k] - r * qv[k];
    }
  }
}

// Row `lane` of the lower factor L (L L^T = M^T M) of the stack M whose
// column `lane` is col (laid out as above), for NS stacks at once (each
// lane holds column `lane` of every stack in col[s]; the stacks' pivots
// interleave). q: 2 NS KM values of the group's shared memory, 16-byte
// aligned (two buffers, alternating between pivots, so one barrier a pivot
// suffices).
// L[s][j] = 0 above the diagonal; col is overwritten. Lanes at or past D
// hold no column and only take the barriers, which `sync` runs over the
// group (uniformly in every lane). The pivots are unrolled up to 16 lanes;
// at 32 (tp_group.cuh, a warp per combine) they stay rolled, so that the
// code, and nvcc's time, stay a fraction of the unrolled one's (L then
// lives in local memory); the arithmetic is the same.
template <typename S, int GM, int KM, int NS, bool TRI, class Sync>
__device__ __forceinline__ void mgs_rows(S (&col)[NS][KM], int D, int lane,
                                         S* q, S (&L)[NS][GM], Sync sync) {
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int j = 0; j < GM; ++j) L[s][j] = S(0);
  if constexpr (GM <= 16) {
#pragma unroll
    for (int j = 0; j < GM; ++j) {
      if (j >= D) break;
      mgs_pivot<S, GM, KM, NS, TRI>(col, D, lane, q, L, sync, j);
    }
  } else {
#pragma unroll 1
    for (int j = 0; j < GM; ++j) {
      if (j >= D) break;
      mgs_pivot<S, GM, KM, NS, TRI>(col, D, lane, q, L, sync, j);
    }
  }
}

}  // namespace grp
