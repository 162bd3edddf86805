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
