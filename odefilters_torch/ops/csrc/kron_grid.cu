// Single-trajectory Kron-grid PDE solves for Hopper (sm_90a): two
// cooperative kernels.
//
// Replaces the TPU kernels in odefilters/ops/pallas_kernels.py:
//   ek0_kron_grid_kernel  <- _ek0_kron_grid_kernel (EK0, dynamic diffusion:
//                            grid means, one shared (q+1)^2 covariance);
//   ek1d_kron_grid_kernel <- _ek1d_kron_grid_kernel (DiagonalEK1: the plain
//                            (q+1)^2 covariance per point, upper triangle).
// Their plain PyTorch versions, in the same order of operations, and the
// Python wrappers are in odefilters_torch/ops/kron_grid.py; the stencil and
// the fixed-order sums in kron_grid.cuh.
//
// Design: one trajectory whose state is NS grids of N x M points. One
// thread per grid point carries both species (the reaction couples them at
// the point) and its state in registers for the whole loop: the means
// m[NQ][NS] and, for DiagonalEK1, the covariance's upper triangle per
// species. EK0's scalar covariance is carried redundantly by every thread.
// A step needs two grid-wide exchanges, so the grid is launched
// cooperatively (every CTA resident) and meets at two grid barriers a step:
//   1. after each thread writes its predicted solution pinv0 mp[0] to a
//      scratch grid in global memory: the stencil reads the neighbours';
//   2. after each CTA writes its partial of the calibration sum (a halving
//      tree over its points): then every CTA sums all partials in the same
//      fixed order (kron_grid.cuh: partials_tree), so s2 is the same bits
//      everywhere and the redundant covariance never splits across CTAs.
// Between barrier 2 of one step and barrier 1 of the next nothing reads the
// scratch grid, and between barrier 1 and 2 nothing reads the partials, so
// one scratch grid and one partials buffer serve every step. DiagonalEK1's
// log-likelihood needs two more grid sums a step (per species, sum z^2/sc
// and sum log sc); they only feed ll, so each CTA writes their partials
// after barrier 2 and CTA 0 sums them after barrier 1 of the next step (or
// after a last barrier), with no barrier of their own.
//
// What bounds them (N = 70, d = 9800, 1000 steps): they read the initial
// means once and write the 21 save rows, ~1 MB, 0.3 us at 3.35 TB/s, and do
// a few hundred operations per point a step, ~2 GFLOP in all, 30 us at 67
// TFLOP/s; the 2000 grid barriers, each a round trip through L2 by every
// CTA, are the floor: on an H100 SXM (700 W) the barriers alone take 2.2 ms
// over 39 CTAs and the kernels 4.1 ms (EK0) and 6.2 ms (DiagonalEK1) in
// float32 (chip_smoke.py, phase 39). Built without FMA contraction (ops/_build.py:
// SOURCE_FLAGS): the kernels round op by op as their plain versions do on
// the card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cooperative.cuh"
#include "kron_grid.cuh"

namespace cg = cooperative_groups;
using kron::BLOCK;
using kron::Consts;

namespace {

// The partials' tree width: the CTA count padded to a power of two.
__host__ __device__ inline int pow2_at_least(int n) {
  int P = 1;
  while (P < n) P <<= 1;
  return P;
}

}  // namespace

// EK0: us (S+1, NS, N, M) every save_every steps (row 0 the initial mean),
// var (S+1,) the isotropic variance pinv0^2 max(C[0][0], 0), ll (). work:
// the scratch grid (NS N M) then the partials (2 nb). The grid fields are
// autonomous: the step's time t0 + dt (k+1) is not formed.
template <typename S, int NQ, class G>
__global__ void __launch_bounds__(BLOCK)
    ek0_kron_grid_kernel(const S* __restrict__ m0, S* __restrict__ us,
                         S* __restrict__ var, S* __restrict__ ll_out, S* work,
                         int N, int M, int T, int save_every,
                         Consts<S, NQ> c, G g) {
  constexpr int NS = G::NS;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ unsigned char smem_raw[];
  S* sh = reinterpret_cast<S*>(smem_raw);
  const int NM = N * M, nb = gridDim.x, P = pow2_at_least(nb);
  const int W = P > BLOCK ? P : BLOCK;
  const int pt = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = pt < NM;
  const int i = live ? pt / M : 0, j = live ? pt % M : 0;
  S* U = work;
  S* part = work + NS * NM;

  S m[NQ][NS], C[NQ][NQ];
#pragma unroll
  for (int a = 0; a < NQ; ++a) {
#pragma unroll
    for (int s = 0; s < NS; ++s)
      m[a][s] = live ? m0[((size_t)a * NS + s) * NM + pt] : S(0);
#pragma unroll
    for (int b = 0; b < NQ; ++b) C[a][b] = S(0);
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < NS; ++s) us[(size_t)s * NM + pt] = c.pinv0 * m[0][s];
  }
  if (pt == 0) var[0] = S(0);
  S ll = S(0);

  for (int k = 0; k < T; ++k) {
    S mp[NQ][NS], u[NS], du[NS], z[NS], zsq[NS];
    kron::predict_means(c, m, mp);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      u[s] = c.pinv0 * mp[0][s];
      if (live) __stcg(U + s * NM + pt, u[s]);
    }
    grid.sync();
    if (live) g.f(U, N, M, i, j, u, du);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      z[s] = live ? kron::innovation(c.pinv1, mp[1][s], du[s]) : S(0);
      zsq[s] = z[s] * z[s];
    }
    kron::cta_tree<S, NS>(sh, W, zsq, part, nb);
    grid.sync();
    S sums[NS];
    kron::partials_tree<S, NS>(sh, W, part, nb, P, sums);
    S zz = sums[0];
#pragma unroll
    for (int s = 1; s < NS; ++s) zz = zz + sums[s];
    const S s2 = zz * c.inv_dhq;

    S tmp[NQ][NQ], Cp[NQ][NQ], kg[NQ];
#pragma unroll
    for (int a = 0; a < NQ; ++a)
#pragma unroll
      for (int b = 0; b < NQ; ++b) {
        S acc = c.At[a][a] * C[a][b];
#pragma unroll
        for (int e = a + 1; e < NQ; ++e) acc = acc + c.At[a][e] * C[e][b];
        tmp[a][b] = acc;
      }
#pragma unroll
    for (int a = 0; a < NQ; ++a)
#pragma unroll
      for (int l = 0; l < NQ; ++l) {
        S acc = tmp[a][l] * c.At[l][l];
#pragma unroll
        for (int b = l + 1; b < NQ; ++b) acc = acc + tmp[a][b] * c.At[l][b];
        Cp[a][l] = acc + c.Qt[a][l] * s2;
      }
    const S sc = c.p1sq * Cp[1][1];
    const S inv_s = S(1) / sc;
#pragma unroll
    for (int a = 0; a < NQ; ++a) kg[a] = (c.pinv1 * Cp[a][1]) * inv_s;
#pragma unroll
    for (int a = 0; a < NQ; ++a) {
#pragma unroll
      for (int s = 0; s < NS; ++s) m[a][s] = mp[a][s] - kg[a] * z[s];
#pragma unroll
      for (int l = 0; l < NQ; ++l) C[a][l] = Cp[a][l] - (kg[a] * kg[l]) * sc;
    }
    ll = ll + S(-0.5) * (zz * inv_s +
                         c.d * (log(kron::clamp_min(sc, S(1e-30))) + c.log2pi));

    if ((k + 1) % save_every == 0) {
      const int row = (k + 1) / save_every;
      if (live) {
#pragma unroll
        for (int s = 0; s < NS; ++s)
          us[((size_t)row * NS + s) * NM + pt] = c.pinv0 * m[0][s];
      }
      if (pt == 0) var[row] = c.p0sq * kron::clamp_min(C[0][0], S(0));
    }
  }
  if (pt == 0) ll_out[0] = ll;
}

// DiagonalEK1: as ek0_kron_grid_kernel with var (S+1, NS, N, M) per point.
// work: the scratch grid (NS N M), the partials (2 nb), the log-likelihood's
// partials (2 NS nb: per species sum z^2/sc, sum log sc).
template <typename S, int NQ, class G>
__global__ void __launch_bounds__(BLOCK)
    ek1d_kron_grid_kernel(const S* __restrict__ m0, S* __restrict__ us,
                          S* __restrict__ var, S* __restrict__ ll_out,
                          S* work, int N, int M, int T, int save_every,
                          Consts<S, NQ> c, G g) {
  constexpr int NS = G::NS;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ unsigned char smem_raw[];
  S* sh = reinterpret_cast<S*>(smem_raw);
  const int NM = N * M, nb = gridDim.x, P = pow2_at_least(nb);
  const int W = P > BLOCK ? P : BLOCK;
  const int pt = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = pt < NM;
  const int i = live ? pt / M : 0, j = live ? pt % M : 0;
  S* U = work;
  S* part = work + NS * NM;
  S* llpart = part + NS * nb;

  // C[a][b][s] for a <= b: the upper triangle; the lower mirror aliased
  S m[NQ][NS], C[NQ][NQ][NS];
#pragma unroll
  for (int a = 0; a < NQ; ++a)
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      m[a][s] = live ? m0[((size_t)a * NS + s) * NM + pt] : S(0);
#pragma unroll
      for (int b = 0; b < NQ; ++b) C[a][b][s] = S(0);
    }
  if (live) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      us[(size_t)s * NM + pt] = c.pinv0 * m[0][s];
      var[(size_t)s * NM + pt] = S(0);
    }
  }
  S ll = S(0);
  // CTA 0: the previous step's log-likelihood partials into ll
  auto fold_ll = [&]() {
    S lsum[2 * NS];
    kron::partials_tree<S, 2 * NS>(sh, W, llpart, nb, P, lsum);
    S tot = lsum[0] + lsum[1];
#pragma unroll
    for (int s = 1; s < NS; ++s) tot = tot + (lsum[2 * s] + lsum[2 * s + 1]);
    ll = ll + S(-0.5) * (tot + c.dlog2pi);
  };

  for (int k = 0; k < T; ++k) {
    S mp[NQ][NS], u[NS], du[NS], jd[NS], z[NS], a[NS], r[NS];
    kron::predict_means(c, m, mp);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      u[s] = c.pinv0 * mp[0][s];
      if (live) __stcg(U + s * NM + pt, u[s]);
    }
    grid.sync();
    if (k > 0 && blockIdx.x == 0) fold_ll();
    if (live) g.f(U, N, M, i, j, u, du);
    g.jac_diag(u, jd);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      z[s] = live ? kron::innovation(c.pinv1, mp[1][s], du[s]) : S(0);
      a[s] = jd[s] * c.pinv0;
      const S hq = (c.c1 - c.c2 * a[s]) + (c.Qt[0][0] * a[s]) * a[s];
      r[s] = live ? (z[s] * z[s]) / hq : S(0);
    }
    kron::cta_tree<S, NS>(sh, W, r, part, nb);
    grid.sync();
    S sums[NS];
    kron::partials_tree<S, NS>(sh, W, part, nb, P, sums);
    S zz_hq = sums[0];
#pragma unroll
    for (int s = 1; s < NS; ++s) zz_hq = zz_hq + sums[s];
    const S s2 = zz_hq * c.inv_d;

    S lterm[2 * NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      // Cp = At C At^T + s2 Qt, upper triangle, from the aliased C
      S tmp[NQ][NQ], Cp[NQ][NQ], hC[NQ], kg[NQ];
#pragma unroll
      for (int x = 0; x < NQ; ++x)
#pragma unroll
        for (int b = 0; b < NQ; ++b) {
          S acc = c.At[x][x] * (x <= b ? C[x][b][s] : C[b][x][s]);
#pragma unroll
          for (int e = x + 1; e < NQ; ++e)
            acc = acc + c.At[x][e] * (e <= b ? C[e][b][s] : C[b][e][s]);
          tmp[x][b] = acc;
        }
#pragma unroll
      for (int x = 0; x < NQ; ++x)
#pragma unroll
        for (int l = x; l < NQ; ++l) {
          S acc = tmp[x][l] * c.At[l][l];
#pragma unroll
          for (int b = l + 1; b < NQ; ++b) acc = acc + tmp[x][b] * c.At[l][b];
          Cp[x][l] = acc + c.Qt[x][l] * s2;
        }
#pragma unroll
      for (int x = 0; x < NQ; ++x)
        hC[x] = c.pinv1 * (1 <= x ? Cp[1][x] : Cp[x][1]) - a[s] * Cp[0][x];
      const S sc = c.pinv1 * hC[1] - a[s] * hC[0];
      const S inv_s = S(1) / sc;
#pragma unroll
      for (int x = 0; x < NQ; ++x) {
        kg[x] = hC[x] * inv_s;
        m[x][s] = mp[x][s] - kg[x] * z[s];
      }
#pragma unroll
      for (int x = 0; x < NQ; ++x)
#pragma unroll
        for (int l = x; l < NQ; ++l)
          C[x][l][s] = Cp[x][l] - (kg[x] * kg[l]) * sc;
      lterm[2 * s] = live ? (z[s] * z[s]) * inv_s : S(0);
      lterm[2 * s + 1] = live ? log(kron::clamp_min(sc, S(1e-30))) : S(0);
    }
    kron::cta_tree<S, 2 * NS>(sh, W, lterm, llpart, nb);

    if ((k + 1) % save_every == 0 && live) {
      const int row = (k + 1) / save_every;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const size_t o = ((size_t)row * NS + s) * NM + pt;
        us[o] = c.pinv0 * m[0][s];
        var[o] = c.p0sq * kron::clamp_min(C[0][0][s], S(0));
      }
    }
  }
  if (T > 0) {
    grid.sync();
    if (blockIdx.x == 0) fold_ll();
  }
  if (pt == 0) ll_out[0] = ll;
}

// Runs n grid barriers and nothing else: the latency floor of the kernels'
// 2 T barriers at the same grid (chip_smoke.py reports it beside the bound).
__global__ void __launch_bounds__(BLOCK) kron_grid_sync_probe_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < n; ++k) grid.sync();
}

namespace {

// Shared rows of the trees: NV_SH rows of max(BLOCK, P) values.
template <typename S, bool EK1D>
size_t shared_bytes(int nb) {
  const int P = pow2_at_least(nb);
  return (size_t)(EK1D ? 4 : 2) * (P > BLOCK ? P : BLOCK) * sizeof(S);
}

template <typename S, bool EK1D>
void* kernel_ptr() {
  using G = kron::BrusselatorGrid<S>;
  if (EK1D) return (void*)ek1d_kron_grid_kernel<S, 4, G>;
  return (void*)ek0_kron_grid_kernel<S, 4, G>;
}

template <typename S, bool EK1D>
int launch_grid(const void* m0, void* us, void* var, void* ll, void* work,
                int N, int M, int T, int save_every, const double* k,
                void* stream) {
  using G = kron::BrusselatorGrid<S>;
  if (N < 1 || M < 1 || T < 0 || save_every < 1 || T % save_every)
    return (int)cudaErrorInvalidValue;
  const int nb = (N * M + BLOCK - 1) / BLOCK;
  Consts<S, 4> c = kron::read_consts<S, 4>(k);
  G g = G::read(k + kron::n_consts<4>());
  const S* m0p = (const S*)m0;
  S *usp = (S*)us, *varp = (S*)var, *llp = (S*)ll, *wp = (S*)work;
  void* args[] = {&m0p, &usp, &varp, &llp, &wp, &N, &M, &T, &save_every,
                  &c, &g};
  return coop::launch_cooperative(kernel_ptr<S, EK1D>(), nb, BLOCK, args,
                                  shared_bytes<S, EK1D>(nb), stream);
}

}  // namespace

// Plain C entry points, bound with ctypes (ops/_build.py: ENTRIES). Each
// launches on the given stream, does not synchronise, and returns the CUDA
// error code of the launch (cudaErrorCooperativeLaunchTooLarge when the
// grid cannot be co-resident). Instantiated for q = 3 (NQ = 4) and the
// Brusselator stencil. consts: At, Qt (NQ*NQ each), the 11 scalars of
// kron::Consts, then alpha, (N-1)^2, A, A + 1, B, -4 alpha (N-1)^2.
extern "C" {

int ek0_kron_grid_f32(const void* m0, void* us, void* var, void* ll,
                      void* work, int N, int M, int T, int save_every,
                      const double* consts, void* stream) {
  return launch_grid<float, false>(m0, us, var, ll, work, N, M, T,
                                   save_every, consts, stream);
}

int ek0_kron_grid_f64(const void* m0, void* us, void* var, void* ll,
                      void* work, int N, int M, int T, int save_every,
                      const double* consts, void* stream) {
  return launch_grid<double, false>(m0, us, var, ll, work, N, M, T,
                                    save_every, consts, stream);
}

int ek1d_kron_grid_f32(const void* m0, void* us, void* var, void* ll,
                       void* work, int N, int M, int T, int save_every,
                       const double* consts, void* stream) {
  return launch_grid<float, true>(m0, us, var, ll, work, N, M, T,
                                  save_every, consts, stream);
}

int ek1d_kron_grid_f64(const void* m0, void* us, void* var, void* ll,
                       void* work, int N, int M, int T, int save_every,
                       const double* consts, void* stream) {
  return launch_grid<double, true>(m0, us, var, ll, work, N, M, T,
                                   save_every, consts, stream);
}

// n grid barriers of `blocks` CTAs of BLOCK threads, cooperatively (refused
// when the CTAs cannot all be resident).
int kron_grid_sync_probe(int blocks, int n, void* stream) {
  void* args[] = {&n};
  return coop::launch_cooperative((const void*)kron_grid_sync_probe_kernel,
                                  blocks, BLOCK, args, 0, stream);
}

}  // extern "C"
