// Single-trajectory Kron-grid PDE solves for Hopper (sm_90a): a
// cooperative kernel (EK0) and, for DiagonalEK1, a thread-block-cluster
// kernel with a cooperative one for grids larger than a cluster holds.
//
// Replaces the TPU kernels in odefilters/ops/pallas_kernels.py:
//   ek0_kron_grid_kernel      <- _ek0_kron_grid_kernel (EK0, dynamic
//                                diffusion: grid means, one shared
//                                (q+1)^2 covariance);
//   ek1d_kron_cluster_kernel  <- _ek1d_kron_grid_kernel (DiagonalEK1: the
//   ek1d_kron_grid_kernel        plain (q+1)^2 covariance per point, upper
//                                triangle; the cluster kernel up to
//                                CLUSTER x 384 x 4 points, the
//                                cooperative one above).
// Their plain PyTorch versions, in the same order of operations, and the
// Python wrappers are in odefilters_torch/ops/kron_grid.py; the stencil and
// the fixed-order sums in kron_grid.cuh.
//
// Design: one trajectory whose state is NS grids of N x M points. One
// thread per grid point carries both species (the reaction couples them at
// the point) and its state in registers for the whole loop: the means
// m[NQ][NS] and, for DiagonalEK1, the covariance's upper triangle per
// species. EK0's scalar covariance is carried redundantly by every thread.
// A step needs two grid-wide exchanges:
//   1. after each thread writes its predicted solution pinv0 mp[0] to a
//      scratch grid: the stencil reads the neighbours';
//   2. after each block of KRON_BLOCK points has summed its partial of the
//      calibration sum (a halving tree): then every CTA sums all partials
//      in the same fixed order (kron_grid.cuh: partials_tree), so s2 is the
//      same bits everywhere and the redundant covariance never splits.
// Between barrier 2 of one step and barrier 1 of the next nothing reads the
// scratch grid, and between barrier 1 and 2 nothing reads the partials, so
// one scratch grid and one partials buffer serve every step. DiagonalEK1's
// log-likelihood needs two more grid sums a step (per species, sum z^2/sc
// and sum log sc); they only feed ll, so each block writes their partials
// after barrier 2 and CTA 0 sums them after barrier 1 of the next step (or
// after a last barrier), with no barrier of their own.
//
// Cooperative (EK0, and DiagonalEK1 above a cluster's points): a CTA per
// block of points, every CTA resident, the scratch grid and partials in
// global memory (L2), two grid barriers a step. DiagonalEK1 on a cluster:
// the whole trajectory on one cluster of C = CLUSTER CTAs (16, a
// non-portable size) on neighbouring SMs, CTA r owning blocks
// r bpc .. r bpc + bpc - 1 (bpc = ceil(blocks / C)), bpc KRON_BLOCK threads
// a CTA up to 384 and, above, up to 4 points a thread; the scratch grid
// and the partials live in each CTA's shared memory and are read by the
// others through distributed shared memory (cluster.map_shared_rank: the
// stencil's neighbours, the periodic wrap included, and every block's
// partials), and the two barriers a step are cluster barriers
// (barrier.cluster arrive.release / wait.acquire) that never leave the
// chip. The sums keep grid_sum's order (a halving tree per block of
// KRON_BLOCK points, then the block partials zero-padded to a power of
// two), so both kernels equal their plain versions bit for bit.
//
// What bounds them (N = 70, d = 9800, 1000 steps): they read the initial
// means once and write the 21 save rows, ~1 MB, 0.3 us at 3.35 TB/s, and do
// a few hundred operations per point a step, ~2 GFLOP in all, 30 us at 67
// TFLOP/s; the 2000 barriers are the floor: on an H100 SXM (700 W) the
// grid barriers alone take 2.2 ms over 39 CTAs and the EK0 kernel 4.1 ms in
// float32 (chip_smoke.py, phase 39, which also times the cluster barriers
// and the DiagonalEK1 kernel). Built without FMA contraction
// (ops/_build.py: SOURCE_FLAGS): the kernels round op by op as their plain
// versions do on the card.

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

// DiagonalEK1 on a cooperative grid, for grids larger than a cluster holds
// (launch_ek1d): as ek0_kron_grid_kernel with var (S+1, NS, N, M) per point.
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

// DiagonalEK1 on one thread-block cluster: as ek0_kron_grid_kernel with
// var (S+1, NS, N, M) per point, but the trajectory on the C CTAs of one
// cluster (gridDim.x = C), CTA r owning the bpc blocks of KRON_BLOCK points
// r bpc .. r bpc + bpc - 1 (blockDim.x = K KRON_BLOCK threads, K = min(bpc,
// 3); PPT points a thread, block g + K p of the CTA for thread group g).
// The scratch grid, the s2 partials and the log-likelihood's partials (two
// buffers, by the step's parity) live in each CTA's shared memory, read by
// the others through distributed shared memory; the two barriers a step
// are cluster barriers, split into arrive and wait so that what does not
// read the other CTAs runs between the two: each point's Jacobian diagonal
// and the measurement's variance at barrier 1, CTA 0's sum of the previous
// step's log-likelihood partials at barrier 2.
template <typename S, int NQ, class G, int PPT>
__global__ void __launch_bounds__(kron::CLUSTER_THREADS)
    ek1d_kron_cluster_kernel(const S* __restrict__ m0, S* __restrict__ us,
                             S* __restrict__ var, S* __restrict__ ll_out,
                             int N, int M, int T, int save_every, int bpc,
                             Consts<S, NQ> c, G g) {
  constexpr int NS = G::NS;
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ unsigned char smem_raw[];
  const int NM = N * M, nb = (NM + BLOCK - 1) / BLOCK, P = pow2_at_least(nb);
  const int K = blockDim.x / BLOCK, tid = threadIdx.x;
  const int grp = tid / BLOCK, x = tid % BLOCK;
  const int rank = (int)cl.block_rank();
  const int CAP = bpc * BLOCK;
  // shared: the scratch grid (NS CAP), the s2 partials (NS bpc), the ll
  // partials (2 x 2 NS bpc), the trees' rows
  S* Uloc = reinterpret_cast<S*>(smem_raw);
  S* part = Uloc + NS * CAP;
  S* llpart = part + NS * bpc;
  S* sh = llpart + 4 * NS * bpc;
  // barrier.cluster, arrive (release) and wait (acquire)
  auto arrive = []() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  };
  auto wait = []() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  };

  bool live[PPT];
  int pt[PPT], li[PPT];
  const S* nbp[PPT][4];
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int lb = grp + K * p;
    pt[p] = (rank * bpc + lb) * BLOCK + x;
    li[p] = lb * BLOCK + x;
    live[p] = lb < bpc && pt[p] < NM;
    int at[4] = {0, 0, 0, 0};
    if (live[p]) G::neighbours(N, M, pt[p] / M, pt[p] % M, at);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int bk = at[e] / BLOCK;
      nbp[p][e] = cl.map_shared_rank(Uloc + (bk % bpc) * BLOCK + at[e] % BLOCK,
                                     bk / bpc);
    }
  }

  // C[a][b][s] for a <= b: the upper triangle; the lower mirror aliased
  S m[PPT][NQ][NS], C[PPT][NQ][NQ][NS];
#pragma unroll
  for (int p = 0; p < PPT; ++p)
#pragma unroll
    for (int a = 0; a < NQ; ++a)
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        m[p][a][s] = live[p] ? m0[((size_t)a * NS + s) * NM + pt[p]] : S(0);
#pragma unroll
        for (int b = 0; b < NQ; ++b) C[p][a][b][s] = S(0);
      }
#pragma unroll
  for (int p = 0; p < PPT; ++p)
    if (live[p]) {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        us[(size_t)s * NM + pt[p]] = c.pinv0 * m[p][0][s];
        var[(size_t)s * NM + pt[p]] = S(0);
      }
    }
  S ll = S(0);
  // the partials of every block of the grid, read from their CTAs
  auto remote = [&](S* base, int q, int blk) {
    return *cl.map_shared_rank(base + q * bpc + blk % bpc, blk / bpc);
  };
  // CTA 0: step k's log-likelihood partials into ll (after its own last
  // tree's reads of sh)
  auto fold_ll = [&](int k) {
    S lsum[2 * NS];
    S* lp = llpart + (k & 1) * 2 * NS * bpc;
    __syncthreads();
    kron::cluster_partials_tree<S, 2 * NS>(
        sh, P, nb, [&](int q, int blk) { return remote(lp, q, blk); }, lsum);
    S tot = lsum[0] + lsum[1];
#pragma unroll
    for (int s = 1; s < NS; ++s) tot = tot + (lsum[2 * s] + lsum[2 * s + 1]);
    ll = ll + S(-0.5) * (tot + c.dlog2pi);
  };

  for (int k = 0; k < T; ++k) {
    S mp[PPT][NQ][NS], u[PPT][NS], z[PPT][NS], a[PPT][NS], r[PPT][NS],
        hq[PPT][NS];
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      kron::predict_means(c, m[p], mp[p]);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        u[p][s] = c.pinv0 * mp[p][0][s];
        if (live[p]) Uloc[s * CAP + li[p]] = u[p][s];
      }
    }
    arrive();  // barrier 1: the scratch grid is written
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      S jd[NS];
      g.jac_diag(u[p], jd);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        a[p][s] = jd[s] * c.pinv0;
        hq[p][s] = (c.c1 - c.c2 * a[p][s]) + (c.Qt[0][0] * a[p][s]) * a[p][s];
      }
    }
    wait();
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      S du[NS];
      if (live[p]) g.f_at(nbp[p], CAP, u[p], du);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        z[p][s] = live[p] ? kron::innovation(c.pinv1, mp[p][1][s], du[s])
                          : S(0);
        r[p][s] = live[p] ? (z[p][s] * z[p][s]) / hq[p][s] : S(0);
      }
    }
    kron::cluster_cta_tree<S, NS, PPT>(sh, r, part, bpc);
    arrive();  // barrier 2: the s2 partials are written
    if (k > 0 && rank == 0) fold_ll(k - 1);
    wait();
    S sums[NS];
    kron::cluster_partials_tree<S, NS>(
        sh, P, nb, [&](int q, int blk) { return remote(part, q, blk); }, sums);
    S zz_hq = sums[0];
#pragma unroll
    for (int s = 1; s < NS; ++s) zz_hq = zz_hq + sums[s];
    const S s2 = zz_hq * c.inv_d;

    S lterm[PPT][2 * NS];
#pragma unroll
    for (int p = 0; p < PPT; ++p)
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        // Cp = At C At^T + s2 Qt, upper triangle, from the aliased C
        S tmp[NQ][NQ], Cp[NQ][NQ], hC[NQ], kg[NQ];
        const S(&Cs)[NQ][NQ][NS] = C[p];
#pragma unroll
        for (int xx = 0; xx < NQ; ++xx)
#pragma unroll
          for (int b = 0; b < NQ; ++b) {
            S acc = c.At[xx][xx] * (xx <= b ? Cs[xx][b][s] : Cs[b][xx][s]);
#pragma unroll
            for (int e = xx + 1; e < NQ; ++e)
              acc = acc + c.At[xx][e] * (e <= b ? Cs[e][b][s] : Cs[b][e][s]);
            tmp[xx][b] = acc;
          }
#pragma unroll
        for (int xx = 0; xx < NQ; ++xx)
#pragma unroll
          for (int l = xx; l < NQ; ++l) {
            S acc = tmp[xx][l] * c.At[l][l];
#pragma unroll
            for (int b = l + 1; b < NQ; ++b)
              acc = acc + tmp[xx][b] * c.At[l][b];
            Cp[xx][l] = acc + c.Qt[xx][l] * s2;
          }
#pragma unroll
        for (int xx = 0; xx < NQ; ++xx)
          hC[xx] = c.pinv1 * (1 <= xx ? Cp[1][xx] : Cp[xx][1]) -
                   a[p][s] * Cp[0][xx];
        const S sc = c.pinv1 * hC[1] - a[p][s] * hC[0];
        const S inv_s = S(1) / sc;
#pragma unroll
        for (int xx = 0; xx < NQ; ++xx) {
          kg[xx] = hC[xx] * inv_s;
          m[p][xx][s] = mp[p][xx][s] - kg[xx] * z[p][s];
        }
#pragma unroll
        for (int xx = 0; xx < NQ; ++xx)
#pragma unroll
          for (int l = xx; l < NQ; ++l)
            C[p][xx][l][s] = Cp[xx][l] - (kg[xx] * kg[l]) * sc;
        lterm[p][2 * s] = live[p] ? (z[p][s] * z[p][s]) * inv_s : S(0);
        lterm[p][2 * s + 1] =
            live[p] ? log(kron::clamp_min(sc, S(1e-30))) : S(0);
      }
    kron::cluster_cta_tree<S, 2 * NS, PPT>(
        sh, lterm, llpart + (k & 1) * 2 * NS * bpc, bpc);

    if ((k + 1) % save_every == 0) {
      const int row = (k + 1) / save_every;
#pragma unroll
      for (int p = 0; p < PPT; ++p)
        if (live[p]) {
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const size_t o = ((size_t)row * NS + s) * NM + pt[p];
            us[o] = c.pinv0 * m[p][0][s];
            var[o] = c.p0sq * kron::clamp_min(C[p][0][0][s], S(0));
          }
        }
    }
  }
  if (T > 0) {
    cl.sync();
    if (rank == 0) fold_ll(T - 1);
    cl.sync();  // no CTA leaves while CTA 0 reads its shared memory
  }
  if (rank == 0 && tid == 0) ll_out[0] = ll;
}

// Runs n grid barriers and nothing else: the latency floor of the EK0
// kernel's 2 T barriers at the same grid (chip_smoke.py reports it beside
// the bound).
__global__ void __launch_bounds__(BLOCK) kron_grid_sync_probe_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < n; ++k) grid.sync();
}

// Runs n cluster barriers and nothing else: the floor of the DiagonalEK1
// cluster kernel's 2 T barriers.
__global__ void __launch_bounds__(kron::CLUSTER_THREADS)
    kron_cluster_sync_probe_kernel(int n) {
  cg::cluster_group cl = cg::this_cluster();
  for (int k = 0; k < n; ++k) cl.sync();
}

namespace {

// The cooperative kernels' shared rows of the trees: `rows` rows (EK0 2,
// DiagonalEK1 4) of max(BLOCK, P) values.
template <typename S>
size_t shared_bytes(int nb, int rows) {
  const int P = pow2_at_least(nb);
  return (size_t)rows * (P > BLOCK ? P : BLOCK) * sizeof(S);
}

int bad_grid_args(int N, int M, int T, int save_every) {
  return N < 1 || M < 1 || T < 0 || save_every < 1 || T % save_every;
}

// Launches `kernel` as one cluster of kron::CLUSTER CTAs of `threads`
// threads with `shared` bytes of dynamic shared memory; refused with
// cudaErrorLaunchOutOfResources when the card cannot schedule such a
// cluster (cudaOccupancyMaxActiveClusters), instead of failing at launch.
int launch_cluster(const void* kernel, int threads, size_t shared,
                   void** args, void* stream) {
  constexpr int C = kron::CLUSTER;
  static_assert(C >= 1 && C <= 16, "a cluster holds 1 to 16 CTAs");
  if (threads < 1 || threads > kron::CLUSTER_THREADS)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  if (C > 8)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = shared;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  return (int)cudaLaunchKernelExC(&cfg, kernel, args);
}

// The DiagonalEK1 cluster's shape for nb blocks of points: bpc blocks a
// CTA, K = min(bpc, 3) groups of BLOCK threads, and the points a thread,
// ceil(bpc / K) rounded up to 1, 2 or 4 (0: the grid is larger than a
// cluster holds, and runs on the cooperative kernel).
struct Shape {
  int bpc, K, ppt;
};

inline Shape cluster_shape(int nb) {
  Shape s;
  s.bpc = (nb + kron::CLUSTER - 1) / kron::CLUSTER;
  constexpr int KMAX = kron::CLUSTER_THREADS / BLOCK;
  s.K = s.bpc < KMAX ? s.bpc : KMAX;
  const int need = (s.bpc + s.K - 1) / s.K;
  static_assert(kron::PPT_MAX == 4, "cluster_shape instantiates 1, 2, 4");
  s.ppt = need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : 0;
  return s;
}

// Its shared memory: the scratch grid, the partials, the trees' rows and
// their sums.
template <typename S>
size_t cluster_shared_bytes(int nb, const Shape& sh) {
  constexpr int NS = 2;
  const int P = pow2_at_least(nb), rows = sh.ppt * sh.K * BLOCK;
  return ((size_t)NS * sh.bpc * BLOCK + (size_t)5 * NS * sh.bpc +
          (size_t)2 * NS * (rows > P ? rows : P) + (size_t)2 * NS) *
         sizeof(S);
}

// EK0 on a cooperative grid; DiagonalEK1 on one cluster where the grid
// fits it (cluster_shape), else on a cooperative grid (work is read by the
// cooperative kernels only).
template <typename S, bool EK1D>
int launch_grid(const void* m0, void* us, void* var, void* ll, void* work,
                int N, int M, int T, int save_every, const double* k,
                void* stream) {
  using G = kron::BrusselatorGrid<S>;
  if (bad_grid_args(N, M, T, save_every))
    return (int)cudaErrorInvalidValue;
  const int nb = (N * M + BLOCK - 1) / BLOCK;
  Consts<S, 4> c = kron::read_consts<S, 4>(k);
  G g = G::read(k + kron::n_consts<4>());
  const S* m0p = (const S*)m0;
  S *usp = (S*)us, *varp = (S*)var, *llp = (S*)ll, *wp = (S*)work;
  const Shape sh = cluster_shape(nb);
  if (EK1D && sh.ppt) {
    int bpc = sh.bpc;
    void* args[] = {&m0p, &usp, &varp, &llp, &N, &M, &T, &save_every, &bpc,
                    &c, &g};
    const void* kern =
        sh.ppt == 1   ? (const void*)ek1d_kron_cluster_kernel<S, 4, G, 1>
        : sh.ppt == 2 ? (const void*)ek1d_kron_cluster_kernel<S, 4, G, 2>
                      : (const void*)ek1d_kron_cluster_kernel<S, 4, G, 4>;
    return launch_cluster(kern, sh.K * BLOCK, cluster_shared_bytes<S>(nb, sh),
                          args, stream);
  }
  void* args[] = {&m0p, &usp, &varp, &llp, &wp, &N, &M, &T, &save_every,
                  &c, &g};
  const void* kern = EK1D ? (const void*)ek1d_kron_grid_kernel<S, 4, G>
                          : (const void*)ek0_kron_grid_kernel<S, 4, G>;
  return coop::launch_cooperative(kern, nb, BLOCK, args,
                                  shared_bytes<S>(nb, EK1D ? 4 : 2), stream);
}

}  // namespace

// Plain C entry points, bound with ctypes (ops/_build.py: ENTRIES). Each
// launches on the given stream, does not synchronise, and returns the CUDA
// error code of the launch (cudaErrorCooperativeLaunchTooLarge when a
// cooperative grid cannot be co-resident; cudaErrorLaunchOutOfResources
// when the card cannot schedule DiagonalEK1's cluster). work: the scratch
// grid (NS N M), then the s2 partials (NS nb) and, for DiagonalEK1, the
// log-likelihood's partials (2 NS nb); DiagonalEK1 reads it only above a
// cluster's points. Instantiated for q = 3 (NQ = 4) and the Brusselator
// stencil. consts: At, Qt (NQ*NQ each), the 11 scalars of kron::Consts,
// then alpha, (N-1)^2, A, A + 1, B, -4 alpha (N-1)^2.
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

// The kernel DiagonalEK1 runs on an N x M grid: 1 the cluster kernel, 0
// the cooperative one.
int ek1d_kron_grid_on_cluster(int N, int M) {
  return cluster_shape((N * M + BLOCK - 1) / BLOCK).ppt != 0;
}

// n grid barriers of `blocks` CTAs of BLOCK threads, cooperatively (refused
// when the CTAs cannot all be resident).
int kron_grid_sync_probe(int blocks, int n, void* stream) {
  void* args[] = {&n};
  return coop::launch_cooperative((const void*)kron_grid_sync_probe_kernel,
                                  blocks, BLOCK, args, 0, stream);
}

// n cluster barriers of one cluster of kron::CLUSTER CTAs of `threads`
// threads.
int kron_cluster_sync_probe(int threads, int n, void* stream) {
  void* args[] = {&n};
  return launch_cluster((const void*)kron_cluster_sync_probe_kernel, threads,
                        0, args, stream);
}

}  // extern "C"
