// Fused EK0 filter + RTS smoother pair for Hopper (sm_90a).
//
// Replaces the TPU kernels odefilters/ops/pallas_kernels.py::
// _ek0_pair_fwd_kernel (the forward filter) and ::_ek0_pair_bwd_kernel with
// plain=True (the backward smoother in additive Joseph form). Their plain
// PyTorch versions, in the same order of operations, are in
// odefilters_torch/ops/ek0_pair.py, which also holds the Python wrappers.
//
// Design: one thread per ensemble member. A thread keeps its member's state
// (mean nq x d, covariance nq x nq) in registers for the whole time loop,
// as the TPU kernel kept it in VMEM. Every loop over matrix indices is
// unrolled at compile time, so the structural zeros of the measured block
// (row and column BX of a committed EK0 covariance, exactly zero after the
// R = 0 update) and of the IBM prior's upper-triangular transition cost
// nothing. Arrays are (T+1, rows, B) with the member index contiguous, so
// a warp's loads and stores of one row entry coalesce.
//
// What bounds it: the serial time recursion. At the headline configuration
// (8192 members, 500 steps, float32) the stream is 8192*501*15*4 B = 246 MB
// and the output 49 MB, which 3.35 TB/s moves in about 0.1 ms; each step is
// a chain of dependent floating-point operations per member. Measured on
// an H100 SXM at 700 W: the forward takes ~0.14 ms, about half the card's
// bandwidth for its stores; the backward ~0.57 ms, some 16% of it, bound by
// its longer chain (four rsqrt pivots, two triangular solves per gain row
// and the Joseph products per step). With 64 threads per block, 8192
// members make 128 blocks, about one per SM: 8192 threads against the
// card's 132 x 2048, far from full occupancy. Filling the card (several
// members per thread, or a member's work split over threads) is left for
// later work.
//
// Not carried over from the TPU kernels: DMA double buffering, chain
// interleave, the (8, 128) lane tiling and the 1024-member block size. Any
// B >= 1 works; threads past the ragged edge return at once.

#include <cuda_runtime.h>

#include "ek0_common.cuh"
#include "fields.cuh"

using ek0::BX;
using ek0::FwdConsts;
using ek0::Layout;

namespace {

constexpr int THREADS = 64;

template <typename S, int NQ>
struct BwdConsts {
  S At[NQ][NQ];
  S Qt[NQ][NQ];
  S QLt[NQ][NQ];  // its lower Cholesky factor
  S pinv0, one_plus_jitter;
};

}  // namespace

// Forward filter: writes row 0 (the exact initial state, s2 = 1) and then
// one packed row per step into st (T+1, V, B).
template <typename S, int NQ, class F>
__global__ void __launch_bounds__(THREADS)
    ek0_pair_fwd_kernel(const S* __restrict__ m0, const S* __restrict__ ps,
                        S* __restrict__ st, int B, int T,
                        FwdConsts<S, NQ> c) {
  constexpr int D = F::D;
  constexpr int V = Layout<NQ, D>::V;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;

  S p[F::NP], m[NQ][D], C[NQ][NQ];
  ek0::load_member<S, NQ, F::NP, D>(m0, ps, b, sB, p, m, C);
  ek0::store_row<S, NQ, D>(st, b, sB, m, C, S(1));

  for (int k = 0; k < T; ++k) {
    // t_{k+1} in the working dtype, never accumulated
    const S t = c.t0 + c.dt * S(k + 1);
    ek0::StepVals<S, NQ, D> v;
    ek0::ek0_step<S, NQ, F, false>(c, p, t, m, C, v);
    ek0::commit<S, NQ, D>(v, m, C);
    ek0::store_row<S, NQ, D>(st, (size_t)(k + 1) * V * sB + b, sB, m, C,
                             v.s2);
  }
}

// Backward smoother: reads st from row T down to 0 and writes out
// (T+1, D+1, B) rows [pinv0 * smoothed mean of block 0 | raw variance].
template <typename S, int NQ, int D>
__global__ void __launch_bounds__(THREADS)
    ek0_pair_bwd_kernel(const S* __restrict__ st, S* __restrict__ out,
                        int B, int T, BwdConsts<S, NQ> c) {
  constexpr int V = Layout<NQ, D>::V;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;

  // smoothed == filtered at the last grid point
  S m_s[NQ][D], Cs[NQ][NQ], s2;
  ek0::load_row<S, NQ, D>(st, (size_t)T * V * sB + b, sB, m_s, Cs, s2);
  {
    const size_t o = (size_t)T * (D + 1) * sB + b;
#pragma unroll
    for (int j = 0; j < D; ++j) out[o + j * sB] = c.pinv0 * m_s[0][j];
    out[o + D * sB] = Cs[0][0];
  }

  for (int k = T - 1; k >= 0; --k) {
    S m_f[NQ][D], C_f[NQ][NQ], s2_k;
    ek0::load_row<S, NQ, D>(st, (size_t)k * V * sB + b, sB, m_f, C_f,
                            s2_k);

    // s2 is the diffusion of interval k -> k+1 (stored in row k+1)
    S tmp[NQ][NQ], Cp[NQ][NQ];
    ek0::at_times_c<S, NQ>(c.At, C_f, tmp);
    ek0::predict_cov<S, NQ>(tmp, c.At, c.Qt, s2, Cp);
#pragma unroll
    for (int i = 0; i < NQ; ++i) Cp[i][i] = Cp[i][i] * c.one_plus_jitter;

    // Cholesky with rsqrt pivots; the clamp acts inside the rsqrt only
    S L[NQ][NQ], invd[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        S sum = Cp[i][j];
#pragma unroll
        for (int k2 = 0; k2 < j; ++k2) sum = sum - L[i][k2] * L[j][k2];
        if (i == j) {
          const S inv = ek0::rsqrt_(sum > S(1e-30) ? sum : S(1e-30));
          invd[i] = inv;
          L[i][i] = sum * inv;
        } else {
          L[i][j] = sum * invd[j];
        }
      }

    // gain rows G[i] = Cp^-1 tmp[:, i]; row BX is zero
    S G[NQ][NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      if (i == BX) {
#pragma unroll
        for (int l = 0; l < NQ; ++l) G[i][l] = S(0);
        continue;
      }
      S y[NQ];
#pragma unroll
      for (int r = 0; r < NQ; ++r) {
        S sum = tmp[r][i];
#pragma unroll
        for (int k2 = 0; k2 < r; ++k2) sum = sum - L[r][k2] * y[k2];
        y[r] = sum * invd[r];
      }
#pragma unroll
      for (int r = NQ - 1; r >= 0; --r) {
        S sum = y[r];
#pragma unroll
        for (int k2 = r + 1; k2 < NQ; ++k2) sum = sum - L[k2][r] * G[i][k2];
        G[i][r] = sum * invd[r];
      }
    }

    // mean update: m_f + G (m_s - At m_f)
    S dm[NQ][D];
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        S acc = S(0);
#pragma unroll
        for (int l = i; l < NQ; ++l) acc += c.At[i][l] * m_f[l][j];
        dm[i][j] = m_s[i][j] - acc;
      }
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        if (i == BX) {
          m_s[i][j] = m_f[i][j];
          continue;
        }
        S inc = S(0);
#pragma unroll
        for (int l = 0; l < NQ; ++l) inc += G[i][l] * dm[l][j];
        m_s[i][j] = m_f[i][j] + inc;
      }

    // additive Joseph form:
    //   Cs' = (I-GA) C_f (I-GA)^T + s2 (G QL)(G QL)^T + G Cs G^T
    S IGA[NQ][NQ], Y[NQ][NQ], GL[NQ][NQ], Vm[NQ][NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      if (i == BX) continue;
#pragma unroll
      for (int l = 0; l < NQ; ++l) {
        S ga = S(0);
#pragma unroll
        for (int a = 0; a <= l; ++a) ga += G[i][a] * c.At[a][l];
        IGA[i][l] = (i == l ? S(1) : S(0)) - ga;
      }
    }
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      if (i == BX) continue;
#pragma unroll
      for (int col = 0; col < NQ; ++col) {
        S y = S(0), v = S(0), gl = S(0);
        if (col != BX) {
#pragma unroll
          for (int a = 0; a < NQ; ++a)
            if (a != BX) {
              y += IGA[i][a] * C_f[a][col];
              v += G[i][a] * Cs[a][col];
            }
        }
#pragma unroll
        for (int a = col; a < NQ; ++a) gl += G[i][a] * c.QLt[a][col];
        Y[i][col] = y;
        Vm[i][col] = v;
        GL[i][col] = gl;
      }
    }
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int l = 0; l < NQ; ++l) Cs[i][l] = S(0);
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      if (i == BX) continue;
#pragma unroll
      for (int l = i; l < NQ; ++l) {
        if (l == BX) continue;
        S b1 = S(0), b2 = S(0), b3 = S(0);
#pragma unroll
        for (int col = 0; col < NQ; ++col)
          if (col != BX) {
            b1 += Y[i][col] * IGA[l][col];
            b3 += Vm[i][col] * G[l][col];
          }
#pragma unroll
        for (int k2 = 0; k2 < NQ; ++k2) b2 += GL[i][k2] * GL[l][k2];
        Cs[i][l] = b1 + s2 * b2 + b3;
        Cs[l][i] = Cs[i][l];
      }
    }

    const size_t o = (size_t)k * (D + 1) * sB + b;
#pragma unroll
    for (int j = 0; j < D; ++j) out[o + j * sB] = c.pinv0 * m_s[0][j];
    out[o + D * sB] = Cs[0][0];
    s2 = s2_k;
  }
}

namespace {

template <typename S, int NQ, class F>
int launch_fwd(const void* m0, const void* ps, void* st, int B, int T,
               const double* k, void* stream) {
  if (B < 1 || T < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (B + THREADS - 1) / THREADS;
  ek0_pair_fwd_kernel<S, NQ, F><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const S*)m0, (const S*)ps, (S*)st, B, T,
      ek0::read_fwd_consts<S, NQ>(k));
  return (int)cudaGetLastError();
}

// consts: At, Qt, QLt (NQ*NQ each), then pinv0, 1 + jitter
template <typename S, int NQ, int D>
int launch_bwd(const void* st, void* out, int B, int T, const double* k,
               void* stream) {
  if (B < 1 || T < 0) return (int)cudaErrorInvalidValue;
  BwdConsts<S, NQ> c;
  int o = 0;
  for (int i = 0; i < NQ; ++i)
    for (int l = 0; l < NQ; ++l) c.At[i][l] = S(k[o++]);
  for (int i = 0; i < NQ; ++i)
    for (int l = 0; l < NQ; ++l) c.Qt[i][l] = S(k[o++]);
  for (int i = 0; i < NQ; ++i)
    for (int l = 0; l < NQ; ++l) c.QLt[i][l] = S(k[o++]);
  c.pinv0 = S(k[o++]);
  c.one_plus_jitter = S(k[o++]);
  const int blocks = (B + THREADS - 1) / THREADS;
  ek0_pair_bwd_kernel<S, NQ, D><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const S*)st, (S*)out, B, T, c);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes (ops/_build.py: ENTRIES). Each
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError() after the launch. Instantiated for q = 3 (NQ = 4).
extern "C" {

int ek0_pair_fwd_fhn_f32(const void* m0, const void* ps, void* st, int B,
                         int T, const double* consts, void* stream) {
  return launch_fwd<float, 4, Fhn<float>>(m0, ps, st, B, T, consts, stream);
}

int ek0_pair_fwd_fhn_f64(const void* m0, const void* ps, void* st, int B,
                         int T, const double* consts, void* stream) {
  return launch_fwd<double, 4, Fhn<double>>(m0, ps, st, B, T, consts, stream);
}

int ek0_pair_bwd_f32(const void* st, void* out, int B, int T,
                     const double* consts, void* stream) {
  return launch_bwd<float, 4, 2>(st, out, B, T, consts, stream);
}

int ek0_pair_bwd_f64(const void* st, void* out, int B, int T,
                     const double* consts, void* stream) {
  return launch_bwd<double, 4, 2>(st, out, B, T, consts, stream);
}

}  // extern "C"
