// Fused EK0 joint-posterior sampler for Hopper (sm_90a): two kernels.
//
// Replaces the TPU kernels in odefilters/ops/pallas_kernels.py:
//   ek0_filter_states_kernel <- _ek0_filter_states_kernel (the square-root
//                               EK0 filter streaming (mean | factor | s2)
//                               rows; dynamic diffusion, first order);
//   ek0_sampler_kernel       <- _ek0_sampler_kernel (the backward
//                               conditioning sampler, S samples a member).
// Their plain PyTorch versions, in the same order of operations, and the
// Python wrappers are in odefilters_torch/ops/ek0_sample.py; the per-member
// bodies are in ek0_sample.cuh.
//
// Design: one thread per ensemble member, its state in registers for the
// whole time loop, every index loop unrolled so that the structural zeros
// of the upper-triangular transition and of the lower-triangular noise
// factor in the Gram-Schmidt stacks cost nothing; arrays (T+1, rows, B)
// with the member index contiguous, so that a warp's loads and stores
// coalesce; 64 threads a block, any B >= 1. The filter carries the full
// nq x nq factor (the update L - kg (pb Lp[1])^T is not triangular) and
// streams 25 values a step at q = 3, d = 2 (the TPU row was 28 wide). The
// sampler keeps a chunk of SC samples in registers (SC = 1, 2, 4 or 8 in
// float32, up to 4 in float64, the largest not above S) and recomputes the
// shared per-step work (two Gram-Schmidt factorisations, nq Cholesky
// solves) once per chunk: the grid's y dimension runs over the chunks, the
// last one possibly partial. The TPU kernel's DMA double buffering does
// not carry over: each thread loads its row entries directly.
//
// What bounds them (8192 members, 500 steps, float32): the filter writes
// its 410.4 MB stream, 0.12 ms at 3.35 TB/s; the sampler reads the stream
// and 131.3 MB of normals and writes 32.8 MB at S = 1 (0.17 ms), and reads
// 1050.7 MB of normals and writes 262.7 MB at S = 8 (0.51 ms). Each is a
// serial recursion per member whose dependent chain per step (a square
// root and a division per Gram-Schmidt pivot, two solves per gain row) is
// far longer than its bytes take, and 8192 threads fill about one block of
// 64 per SM, so latency bounds them, not bandwidth. Built without FMA
// contraction (ops/_build.py: SOURCE_FLAGS): the stream's s2 carries the
// innovation at the accuracy floor and scales the noise factor in both
// kernels, so they round op by op as their plain versions do on the card.
// In float the filter's residual is the exact product in double, rounded
// once (innovation, ek0_common.cuh): a rounded product cancels to s2 = 0 now
// and then, and such a step leaves the sampler a singular predicted factor.

#include <cuda_runtime.h>

#include "ek0_sample.cuh"
#include "fields.cuh"

using ek0::BX;
using ek0::SampleConsts;
using ek0::StatesLayout;

namespace {

constexpr int THREADS = 64;

}  // namespace

// Square-root filter: row 0 (the exact initial state, L = 0, s2 = 1), then
// one row per step into st (T+1, V, B).
template <typename S, int NQ, class F>
__global__ void __launch_bounds__(THREADS)
    ek0_filter_states_kernel(const S* __restrict__ m0,
                             const S* __restrict__ ps, S* __restrict__ st,
                             int B, int T, SampleConsts<S, NQ> c) {
  constexpr int D = F::D;
  constexpr int V = StatesLayout<NQ, D>::V;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;

  S p[F::NP], m[NQ][D], L[NQ][NQ];
  ek0::load_member<S, NQ, F::NP, D>(m0, ps, b, sB, p, m, L);
  ek0::store_states<S, NQ, D>(st, b, sB, m, L, S(1));
  for (int k = 0; k < T; ++k) {
    // t_{k+1} in the working dtype, never accumulated
    const S t = c.t0 + c.dt * S(k + 1);
    const S s2 = ek0::filter_states_step<S, NQ, F>(c, p, t, m, L);
    ek0::store_states<S, NQ, D>(st, (size_t)(k + 1) * V * sB + b, sB, m, L,
                                s2);
  }
}

// Backward sampler: samples s0 .. s0 + SC - 1 (s0 = blockIdx.y * SC, those
// below NS) of member b, from the stream st (T+1, V, B) and the normals
// zn (T+1, NS, NQ, D, B), into out (T+1, NS, D, B) as pinv0 x[0].
template <typename S, int NQ, int D, int SC>
__global__ void __launch_bounds__(THREADS)
    ek0_sampler_kernel(const S* __restrict__ st, const S* __restrict__ zn,
                       S* __restrict__ out, int B, int T, int NS,
                       SampleConsts<S, NQ> c) {
  constexpr int V = StatesLayout<NQ, D>::V;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int s0 = blockIdx.y * SC;
  const int ns = NS - s0 < SC ? NS - s0 : SC;
  const size_t sB = (size_t)B;

  auto zrow = [&](int k, int s) {
    return ((size_t)k * NS + s0 + s) * NQ * D * sB + b;
  };
  auto emit = [&](int k, const S (&x)[SC][NQ][D]) {
#pragma unroll
    for (int s = 0; s < SC; ++s) {
      if (s >= ns) continue;
      const size_t o = ((size_t)k * NS + s0 + s) * D * sB + b;
#pragma unroll
      for (int j = 0; j < D; ++j) out[o + j * sB] = c.pinv0 * x[s][0][j];
    }
  };

  // x_T = m_T + L_T z_T
  S x[SC][NQ][D];
  S s2_next;
  {
    S m[NQ][D], L[NQ][NQ];
    ek0::load_states<S, NQ, D>(st, (size_t)T * V * sB + b, sB, m, L,
                               s2_next);
#pragma unroll
    for (int s = 0; s < SC; ++s) {
      if (s >= ns) continue;
      const size_t zo = zrow(T, s);
#pragma unroll
      for (int i = 0; i < NQ; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) {
          S acc = S(0);
#pragma unroll
          for (int l = 0; l < NQ; ++l)
            acc += L[i][l] * zn[zo + (l * D + j) * sB];
          x[s][i][j] = m[i][j] + acc;
        }
    }
  }
  emit(T, x);

  for (int k = T - 1; k >= 0; --k) {
    S m_f[NQ][D], L_f[NQ][NQ], s2_k;
    ek0::load_states<S, NQ, D>(st, (size_t)k * V * sB + b, sB, m_f, L_f,
                               s2_k);
    // s2_next is the diffusion of interval k -> k+1 (stored in row k+1)
    S G[NQ][NQ], mp[NQ][D], Lc[NQ][NQ];
    ek0::sampler_shared<S, NQ, D>(c, m_f, L_f, ek0::sqrt_(s2_next), G, mp,
                                  Lc);
#pragma unroll
    for (int s = 0; s < SC; ++s) {
      if (s >= ns) continue;
      const size_t zo = zrow(k, s);
      S dm[NQ][D];
#pragma unroll
      for (int i = 0; i < NQ; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) dm[i][j] = x[s][i][j] - mp[i][j];
#pragma unroll
      for (int i = 0; i < NQ; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) {
          S g = S(0), lz = S(0);
#pragma unroll
          for (int l = 0; l < NQ; ++l) g += G[i][l] * dm[l][j];
#pragma unroll
          for (int l = 0; l <= i; ++l)
            lz += Lc[i][l] * zn[zo + (l * D + j) * sB];
          x[s][i][j] = m_f[i][j] + g + lz;
        }
    }
    emit(k, x);
    s2_next = s2_k;
  }
}

namespace {

// consts: At, QLt (NQ*NQ each), then pinv0, pinv1, t0, dt, hq
template <typename S, int NQ, int D>
SampleConsts<S, NQ> read_consts(const double* k, bool with_grid) {
  SampleConsts<S, NQ> c;
  int o = 0;
  for (int i = 0; i < NQ; ++i)
    for (int l = 0; l < NQ; ++l) c.At[i][l] = S(k[o++]);
  for (int i = 0; i < NQ; ++i)
    for (int l = 0; l < NQ; ++l) c.QLt[i][l] = S(k[o++]);
  c.pinv0 = S(k[o++]);
  c.pinv1 = c.t0 = c.dt = c.pb2 = c.inv_dhq = S(0);
  if (with_grid) {
    const double pinv1 = k[o++];
    c.pinv1 = S(pinv1);
    c.t0 = S(k[o++]);
    c.dt = S(k[o++]);
    c.pb2 = S(pinv1 * pinv1);
    c.inv_dhq = S(1.0 / (double(D) * k[o++]));
  }
  return c;
}

inline int blocks_for(int B) { return (B + THREADS - 1) / THREADS; }

template <typename S, int NQ, class F>
int launch_states(const void* m0, const void* ps, void* st, int B, int T,
                  const double* k, void* stream) {
  if (B < 1 || T < 0) return (int)cudaErrorInvalidValue;
  ek0_filter_states_kernel<S, NQ, F>
      <<<blocks_for(B), THREADS, 0, (cudaStream_t)stream>>>(
          (const S*)m0, (const S*)ps, (S*)st, B, T,
          read_consts<S, NQ, F::D>(k, true));
  return (int)cudaGetLastError();
}

template <typename S, int NQ, int D, int SC>
void launch_sampler_chunk(const void* st, const void* zn, void* out, int B,
                          int T, int NS, const SampleConsts<S, NQ>& c,
                          cudaStream_t stream) {
  const dim3 grid(blocks_for(B), (NS + SC - 1) / SC);
  ek0_sampler_kernel<S, NQ, D, SC><<<grid, THREADS, 0, stream>>>(
      (const S*)st, (const S*)zn, (S*)out, B, T, NS, c);
}

// The chunk of samples a thread keeps in registers: the largest of
// 1, 2, 4, 8 not above NS, at most MAX_SC.
template <typename S, int NQ, int D, int MAX_SC>
int launch_sampler(const void* st, const void* zn, void* out, int B, int T,
                   int NS, const double* k, void* stream) {
  if (B < 1 || T < 0 || NS < 1) return (int)cudaErrorInvalidValue;
  const SampleConsts<S, NQ> c = read_consts<S, NQ, D>(k, false);
  const cudaStream_t s = (cudaStream_t)stream;
  if constexpr (MAX_SC >= 8) {
    if (NS >= 8) {
      launch_sampler_chunk<S, NQ, D, 8>(st, zn, out, B, T, NS, c, s);
      return (int)cudaGetLastError();
    }
  }
  if (NS >= 4)
    launch_sampler_chunk<S, NQ, D, 4>(st, zn, out, B, T, NS, c, s);
  else if (NS >= 2)
    launch_sampler_chunk<S, NQ, D, 2>(st, zn, out, B, T, NS, c, s);
  else
    launch_sampler_chunk<S, NQ, D, 1>(st, zn, out, B, T, NS, c, s);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes (ops/_build.py: ENTRIES). Each
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError() after the launch. Instantiated for q = 3 (NQ = 4),
// d = 2, and the FHN and LV fields for the filter.
extern "C" {

#define EK0_STATES_ENTRIES(NAME, FIELD, S, SUF)                               \
  int ek0_filter_states_##NAME##_##SUF(const void* m0, const void* ps,       \
                                       void* st, int B, int T,               \
                                       const double* consts, void* stream) { \
    return launch_states<S, 4, FIELD<S>>(m0, ps, st, B, T, consts, stream);  \
  }

EK0_STATES_ENTRIES(fhn, Fhn, float, f32)
EK0_STATES_ENTRIES(fhn, Fhn, double, f64)
EK0_STATES_ENTRIES(lv, LotkaVolterra, float, f32)
EK0_STATES_ENTRIES(lv, LotkaVolterra, double, f64)

#undef EK0_STATES_ENTRIES

// consts: At, QLt (NQ*NQ each), then pinv0
int ek0_sampler_f32(const void* st, const void* zn, void* out, int B, int T,
                    int NS, const double* consts, void* stream) {
  return launch_sampler<float, 4, 2, 8>(st, zn, out, B, T, NS, consts,
                                        stream);
}

int ek0_sampler_f64(const void* st, const void* zn, void* out, int B, int T,
                    int NS, const double* consts, void* stream) {
  return launch_sampler<double, 4, 2, 4>(st, zn, out, B, T, NS, consts,
                                         stream);
}

}  // extern "C"
