// Device pieces of the Kron-grid PDE solves (kron_grid.cu): the constants,
// the Brusselator grid stencil, and the fixed-order sums.
//
// The order of operations follows the plain versions in
// odefilters_torch/ops/kron_grid.py and the model's PyTorch form in
// odefilters_torch/models/library.py (brusselator_2d_f_grids,
// brusselator_2d_jd_grids), so the kernels equal them bit for bit when
// built without FMA contraction.
#pragma once

#include <cuda_runtime.h>

namespace kron {

// CTA width: one thread per grid point (ops/kron_grid.py: KRON_BLOCK).
constexpr int BLOCK = 128;
// The cluster kernel's largest CTA: 3 blocks of points (so that a thread
// may hold 168 registers: a float64 point's state and its four
// neighbours' addresses without spilling).
constexpr int CLUSTER_THREADS = 3 * BLOCK;
// CTAs in the DiagonalEK1 kernel's cluster (ops/kron_grid.py:
// KRON_CLUSTER): 16, a non-portable size, which the H100 schedules and
// which ran faster than 8 (scripts/torch_redesign_ab.py builds this file
// with -DKRON_CLUSTER=8 to compare the two).
#ifndef KRON_CLUSTER
#define KRON_CLUSTER 16
#endif
constexpr int CLUSTER = KRON_CLUSTER;
// Points a thread of the cluster kernel carries at most (its state stays
// in registers): grids of more than CLUSTER CLUSTER_THREADS PPT_MAX points
// run on the cooperative kernel instead.
constexpr int PPT_MAX = 4;

// The solve's constants, each a float64 host value rounded once to S
// (ops/kron_grid.py: kernel_scalars and _grid_consts).
template <typename S, int NQ>
struct Consts {
  S At[NQ][NQ], Qt[NQ][NQ];
  S pinv0, pinv1;
  S p0sq;     // pinv0^2
  S p1sq;     // pinv1^2
  S inv_dhq;  // EK0: 1 / (d pinv1^2 Qt[1][1])
  S inv_d;    // DiagonalEK1: 1 / d
  S c1;       // DiagonalEK1: pinv1^2 Qt[1][1]
  S c2;       // DiagonalEK1: 2 pinv1 Qt[0][1]
  S d;        // the state dimension ns N M
  S log2pi;   // log(2 pi)
  S dlog2pi;  // d log(2 pi)
};

// consts: At, Qt (NQ*NQ each), then the 11 scalars above in order, then the
// grid field's own (G::read).
template <typename S, int NQ>
inline Consts<S, NQ> read_consts(const double* k) {
  Consts<S, NQ> c;
  int o = 0;
  for (int i = 0; i < NQ; ++i)
    for (int l = 0; l < NQ; ++l) c.At[i][l] = S(k[o++]);
  for (int i = 0; i < NQ; ++i)
    for (int l = 0; l < NQ; ++l) c.Qt[i][l] = S(k[o++]);
  S* dst[] = {&c.pinv0, &c.pinv1, &c.p0sq, &c.p1sq, &c.inv_dhq, &c.inv_d,
              &c.c1,    &c.c2,    &c.d,    &c.log2pi, &c.dlog2pi};
  for (S* x : dst) *x = S(k[o++]);
  return c;
}

template <int NQ>
constexpr int n_consts() {
  return 2 * NQ * NQ + 11;
}

// The 2-D Brusselator on N x M periodic grids (field "brusselator_2d"):
// species a and b at each point. f reads the four periodic neighbours of
// the predicted solution u (species-major grids in global memory) and the
// point's own values; jac_diag reads only the point's own values.
template <typename S>
struct BrusselatorGrid {
  static constexpr int NS = 2;
  // alpha, (N-1)^2, A, A + 1, B, -4 alpha (N-1)^2
  S alpha, scale, A, A1, B, lap_diag;

  static inline BrusselatorGrid read(const double* k) {
    return BrusselatorGrid{S(k[0]), S(k[1]), S(k[2]), S(k[3]), S(k[4]),
                           S(k[5])};
  }

  // (((x[i-1] + x[i+1]) + x[j-1]) + x[j+1]) - 4 x, times (N-1)^2: the order
  // of torch.roll(x, 1, 0) + roll(x, -1, 0) + roll(x, 1, 1) + roll(x, -1, 1)
  __device__ __forceinline__ S lap(const S* x, S xc, int N, int M, int i,
                                   int j) const {
    const int im = i == 0 ? N - 1 : i - 1, ip = i == N - 1 ? 0 : i + 1;
    const int jm = j == 0 ? M - 1 : j - 1, jp = j == M - 1 ? 0 : j + 1;
    const S s = __ldcg(x + im * M + j) + __ldcg(x + ip * M + j);
    return ((s + __ldcg(x + i * M + jm)) + __ldcg(x + i * M + jp) -
            S(4) * xc) *
           scale;
  }

  __device__ __forceinline__ void f(const S* u, int N, int M, int i, int j,
                                    const S (&own)[NS], S (&du)[NS]) const {
    const int NM = N * M;
    const S a = own[0], b = own[1];
    const S aab = (a * a) * b;
    du[0] = ((B + aab) - A1 * a) + alpha * lap(u, a, N, M, i, j);
    du[1] = ((A * a) - aab) + alpha * lap(u + NM, b, N, M, i, j);
  }

  // lap and f with the four neighbours' values read through pointers:
  // nb[0 .. 3] at (i-1, j), (i+1, j), (i, j-1), (i, j+1) for species 0,
  // species 1 at nb[x][off1]; the same order of operations
  __device__ __forceinline__ S lap_at(const S* const (&nb)[4], int off,
                                      S xc) const {
    const S s = nb[0][off] + nb[1][off];
    return ((s + nb[2][off]) + nb[3][off] - S(4) * xc) * scale;
  }

  __device__ __forceinline__ void f_at(const S* const (&nb)[4], int off1,
                                       const S (&own)[NS],
                                       S (&du)[NS]) const {
    const S a = own[0], b = own[1];
    const S aab = (a * a) * b;
    du[0] = ((B + aab) - A1 * a) + alpha * lap_at(nb, 0, a);
    du[1] = ((A * a) - aab) + alpha * lap_at(nb, off1, b);
  }

  // the flat indices of the four periodic neighbours of (i, j), in lap's
  // order
  static __device__ __forceinline__ void neighbours(int N, int M, int i,
                                                    int j, int (&at)[4]) {
    const int im = i == 0 ? N - 1 : i - 1, ip = i == N - 1 ? 0 : i + 1;
    const int jm = j == 0 ? M - 1 : j - 1, jp = j == M - 1 ? 0 : j + 1;
    at[0] = im * M + j;
    at[1] = ip * M + j;
    at[2] = i * M + jm;
    at[3] = i * M + jp;
  }

  __device__ __forceinline__ void jac_diag(const S (&own)[NS],
                                           S (&jd)[NS]) const {
    const S a = own[0], b = own[1];
    jd[0] = (((S(2) * a) * b) - A1) + lap_diag;
    jd[1] = ((-a) * a) + lap_diag;
  }
};

template <typename S>
__device__ __forceinline__ S clamp_min(S x, S lo) {
  return x < lo ? lo : x;
}

// The residual pb h - f (ek0_pair.py: innovation): in float the exact
// product in double, rounded once.
__device__ __forceinline__ float innovation(float pb, float h, float f) {
  return (float)((double)pb * (double)h - (double)f);
}

__device__ __forceinline__ double innovation(double pb, double h, double f) {
  return pb * h - f;
}

// The first level of grid_sum: NV values per thread summed over the CTA by
// the halving tree sh[x] + sh[x + w] in shared rows of width W; thread 0
// writes row q's sum to part[q * nb + blockIdx.x].
template <typename S, int NV>
__device__ __forceinline__ void cta_tree(S* sh, int W, const S (&v)[NV],
                                         S* part, int nb) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int q = 0; q < NV; ++q) sh[q * W + tid] = v[q];
  __syncthreads();
#pragma unroll
  for (int w = BLOCK / 2; w > 0; w >>= 1) {
    if (tid < w) {
#pragma unroll
      for (int q = 0; q < NV; ++q) sh[q * W + tid] += sh[q * W + tid + w];
    }
    __syncthreads();
  }
  if (tid == 0) {
#pragma unroll
    for (int q = 0; q < NV; ++q) __stcg(part + q * nb + blockIdx.x, sh[q * W]);
  }
}

// The second level: the nb partials of each row, zero-padded to P (a power
// of two), by the same tree; every thread of the CTA gets the NV sums. All
// CTAs that call it read the same partials in the same order, so all get the
// same bits.
template <typename S, int NV>
__device__ __forceinline__ void partials_tree(S* sh, int W, const S* part,
                                              int nb, int P, S (&out)[NV]) {
  const int tid = threadIdx.x;
  for (int x = tid; x < P; x += BLOCK) {
#pragma unroll
    for (int q = 0; q < NV; ++q)
      sh[q * W + x] = x < nb ? __ldcg(part + q * nb + x) : S(0);
  }
  __syncthreads();
  for (int w = P / 2; w > 0; w >>= 1) {
    for (int x = tid; x < w; x += BLOCK) {
#pragma unroll
      for (int q = 0; q < NV; ++q) sh[q * W + x] += sh[q * W + x + w];
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < NV; ++q) out[q] = sh[q * W];
  __syncthreads();  // sh is written again by the next tree
}

// The halving tree's levels below a warp (w = 16, 8, 4, 2, 1, those under
// P): lane x adds lane x + w's value to its own, as sh[x] += sh[x + w]
// does, so lane 0 ends with the sum in the tree's order.
template <typename S>
__device__ __forceinline__ S warp_tree(S v, int P) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
    if (w < P) v = v + __shfl_down_sync(0xffffffffu, v, w);
  return v;
}

// cta_tree for a CTA of K = blockDim.x / BLOCK groups of BLOCK threads,
// each thread holding PPT points (point p of group g in the CTA's block
// g + K p): each block's NV sums by the same halving tree, the levels 64
// and 32 by the group's first warp from the values the group left in sh
// (rows of blockDim.x), the others by warp_tree; that warp's first lane
// writes its blocks' sums to part[q * bpc + block] (blocks at or past bpc
// are not the grid's). One CTA barrier; sh is read by the first warps
// until the caller's next barrier.
template <typename S, int NV, int PPT>
__device__ __forceinline__ void cluster_cta_tree(S* sh, const S (&v)[PPT][NV],
                                                 S* part, int bpc) {
  static_assert(BLOCK == 128, "the first warp folds the levels 64 and 32");
  const int tid = threadIdx.x, RW = blockDim.x, K = RW / BLOCK;
  const int grp = tid / BLOCK, x = tid % BLOCK;
#pragma unroll
  for (int p = 0; p < PPT; ++p)
#pragma unroll
    for (int q = 0; q < NV; ++q) sh[(q * PPT + p) * RW + tid] = v[p][q];
  __syncthreads();
  if (x < 32) {
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const int lb = grp + K * p;
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        const S* row = sh + (q * PPT + p) * RW + grp * BLOCK;
        const S lo = row[x] + row[x + 64];
        const S hi = row[x + 32] + row[x + 96];
        const S t = warp_tree(lo + hi, BLOCK);
        if (x == 0 && lb < bpc) part[q * bpc + lb] = t;
      }
    }
  }
}

// partials_tree over the nb block partials that get(q, block) reads
// (from whichever CTA of the cluster holds them), zero-padded to P, by
// the same tree: the levels of 64 and above through sh (rows of P) with a
// CTA barrier each, the level 32 and below by the first warp; every thread
// of the CTA gets the NV sums. Ends at a barrier.
template <typename S, int NV, class Get>
__device__ __forceinline__ void cluster_partials_tree(S* sh, int P, int nb,
                                                      Get get, S (&out)[NV]) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int x = tid; x < P; x += nt) {
#pragma unroll
    for (int q = 0; q < NV; ++q) sh[q * P + x] = x < nb ? get(q, x) : S(0);
  }
  __syncthreads();
  for (int w = P / 2; w >= 64; w >>= 1) {
    for (int x = tid; x < w; x += nt) {
#pragma unroll
      for (int q = 0; q < NV; ++q) sh[q * P + x] += sh[q * P + x + w];
    }
    __syncthreads();
  }
  S* res = sh + NV * P;
  if (tid < 32) {
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      S t = S(0);
      if (P >= 64)
        t = sh[q * P + tid] + sh[q * P + tid + 32];
      else if (tid < P)
        t = sh[q * P + tid];
      t = warp_tree(t, P >= 64 ? 32 : P);
      if (tid == 0) res[q] = t;
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NV; ++q) out[q] = res[q];
  __syncthreads();  // sh is written again by the next tree
}

// mp[i][s] = sum_{l >= i} At[i][l] m[l][s]: the IBM transition is upper
// triangular with no zero on or above the diagonal, the plain version's
// nonzero terms.
template <typename S, int NQ, int NS>
__device__ __forceinline__ void predict_means(const Consts<S, NQ>& c,
                                              const S (&m)[NQ][NS],
                                              S (&mp)[NQ][NS]) {
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      S acc = c.At[i][i] * m[i][s];
#pragma unroll
      for (int l = i + 1; l < NQ; ++l) acc = acc + c.At[i][l] * m[l][s];
      mp[i][s] = acc;
    }
}

}  // namespace kron
