// Fused EK1 dense-factor kernels for Hopper (sm_90a): three kernels.
//
// Replaces the TPU kernels in odefilters/ops/pallas_kernels.py:
//   ek1_filter_states_kernel <- _ek1_filter_states_kernel (the full D x D
//                               square-root EKF with the field's Jacobian
//                               in the kernel; dynamic, fixed or fixedMAP
//                               diffusion; optional IEKS linearization
//                               rows);
//   ekd_smoother_kernel      <- _ekd_smoother_kernel (the backward
//                               square-root RTS pass over its stream; a
//                               group of lanes per member, ek1_group.cuh);
//   ekd_sampler_kernel       <- _ekd_sampler_kernel (the backward
//                               conditioning sampler, S samples a member;
//                               a group of lanes per member, as the
//                               smoother).
// Their plain PyTorch versions, in the same order of operations, and the
// Python wrappers are in odefilters_torch/ops/ek1_fused.py; the filter's
// per-member body is in ek1_fused.cuh, the backward passes' group bodies
// in ek1_group.cuh.
//
// Design (the filter): one thread per ensemble member, its state in
// registers (and what does not fit, in local memory) for the whole time
// loop, every index loop unrolled so that the structural zeros of
// A = kron(At, I) and QLf = kron(QLt, I) cost nothing; arrays (T+1, rows,
// B) with the member index contiguous, so that a warp's loads and stores
// coalesce; 64 threads a block, any B >= 1. The filter streams 109 values
// a step at q = 3, d = 2 (mean, full factor, s2 and the lower triangle of
// the predicted factor, which the backward passes read instead of
// re-factoring; 73 without a backward pass). The smoother and the sampler
// spread a member over NQ DIM = 8 lanes (ek1_group.cuh): a lane owns a row
// of the gain and of the factors and a column of the Gram-Schmidt stack,
// its members' stream rows staged in shared memory, 32 float32 (16
// float64) members a CTA. The sampler's lane also owns its entry of up to
// 8 samples, so that a step's gain and conditional factor, most of its
// work, are formed once for all of them (more than 8 samples run in chunks
// of 8 on the grid's y dimension); its normals are staged with the rows.
//
// What bounds them (8192 members, 500 steps, float32): by bytes, the
// filter writes a 1.79 GB stream (0.53 ms at 3.35 TB/s), the smoother reads
// it (0.55 ms with its outputs), the sampler reads it and the normals
// (0.58 ms at S = 1). Each is a serial recursion per member of several
// thousand dependent operations a step (Gram-Schmidt on a 16 x 8 or
// 24 x 8 stack, eight 8 x 8 triangular solves for the gain): latency
// bounds them, not bandwidth. The filter holds about 200 (float32) to 400
// (float64) registers' worth of live state a thread, more than the 255 a
// thread may hold, and spills; the group bodies hold a row of each matrix
// a lane. Built without FMA contraction
// (ops/_build.py: SOURCE_FLAGS): the stream's s2 and the static models'
// sigma^2 carry the innovation at the accuracy floor, so the kernels round
// op by op as their plain versions do on the card.

#include <cuda_runtime.h>

#include "ek1_fused.cuh"
#include "ek1_group.cuh"
#include "fields.cuh"

using ek1::Consts;

namespace {

constexpr int THREADS = 64;

inline int blocks_for(int B) { return (B + THREADS - 1) / THREADS; }

// consts: At, QLt (NQ*NQ each), then pinv0 and, for the filter, pinv1,
// t0, dt
template <typename S, int NQ, int DIM>
Consts<S, NQ, DIM> read_consts(const double* k, bool with_grid) {
  Consts<S, NQ, DIM> c;
  double QLt[NQ][NQ];
  int o = 0;
  for (int i = 0; i < NQ; ++i)
    for (int l = 0; l < NQ; ++l) c.At[i][l] = S(k[o++]);
  for (int i = 0; i < NQ; ++i)
    for (int l = 0; l < NQ; ++l) {
      QLt[i][l] = k[o++];
      c.QLt[i][l] = S(QLt[i][l]);
    }
  for (int j = 0; j < NQ * DIM; ++j)
    c.qsq[j] = S(QLt[j / DIM][j / DIM] * QLt[j / DIM][j / DIM]);
  c.pinv0 = S(k[o++]);
  c.pinv1 = c.t0 = c.dt = S(0);
  if (with_grid) {
    c.pinv1 = S(k[o++]);
    c.t0 = S(k[o++]);
    c.dt = S(k[o++]);
  }
  return c;
}

}  // namespace

// The EK1 filter: row 0 (the exact initial state), then one row per step
// into st (T+1, V, B); sigma^2 into sig under a static model.
template <typename S, int NQ, class F, bool STATIC>
__global__ void __launch_bounds__(THREADS)
    ek1_filter_states_kernel(const S* __restrict__ m0,
                             const S* __restrict__ ps,
                             const S* __restrict__ lin, S* __restrict__ st,
                             S* __restrict__ sig, int B, int T, int mode,
                             int smooth, Consts<S, NQ, F::D> c) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  ek1::filter_member<S, NQ, F, STATIC>(c, m0, ps, lin, st, sig, b, B, T,
                                       mode, smooth != 0);
}

// The backward RTS pass: st (T+1, V, B) into us, stds (T+1, DIM, B), a
// group of NQ DIM lanes per member, MB members a CTA (ek1_group.cuh). Two
// CTAs an SM (at most 128 registers a lane in float32): 8192 members then
// fit the card at once.
template <typename S, int NQ, int DIM, int MB>
__global__ void __launch_bounds__(MB * NQ * DIM, 2)
    ekd_smoother_kernel(const S* __restrict__ st, S* __restrict__ us,
                        S* __restrict__ stds, int B, int T,
                        Consts<S, NQ, DIM> c) {
  ek1g::smoother_group<S, NQ, DIM, MB>(c, st, us, stds, B, T);
}

// The backward sampler: st (T+1, V, B) and the normals zn (T+1, NS, N, B)
// into out (T+1, NS, DIM, B), a group of NQ DIM lanes per member, MB
// members a CTA (ek1_group.cuh), samples blockIdx.y * SC .. SC at a time.
template <typename S, int NQ, int DIM, int MB, int SC>
__global__ void __launch_bounds__(MB * NQ * DIM, 2)
    ekd_sampler_kernel(const S* __restrict__ st, const S* __restrict__ zn,
                       S* __restrict__ out, int B, int T, int NS,
                       Consts<S, NQ, DIM> c) {
  ek1g::sampler_group<S, NQ, DIM, MB, SC>(c, st, zn, out, B, T, NS,
                                          blockIdx.y * SC);
}

namespace {

template <typename S, int NQ, class F>
int launch_filter(const void* m0, const void* ps, const void* lin, void* st,
                  void* sig, int B, int T, int mode, int smooth,
                  const double* k, void* stream) {
  if (B < 1 || T < 0 || mode < ek1::DYNAMIC || mode > ek1::FIXED_MAP
      || (mode != ek1::DYNAMIC && (lin != nullptr || sig == nullptr)))
    return (int)cudaErrorInvalidValue;
  const auto c = read_consts<S, NQ, F::D>(k, true);
  const cudaStream_t s = (cudaStream_t)stream;
  if (mode == ek1::DYNAMIC)
    ek1_filter_states_kernel<S, NQ, F, false><<<blocks_for(B), THREADS, 0, s>>>(
        (const S*)m0, (const S*)ps, (const S*)lin, (S*)st, (S*)sig, B, T, mode,
        smooth, c);
  else
    ek1_filter_states_kernel<S, NQ, F, true><<<blocks_for(B), THREADS, 0, s>>>(
        (const S*)m0, (const S*)ps, (const S*)lin, (S*)st, (S*)sig, B, T, mode,
        smooth, c);
  return (int)cudaGetLastError();
}

template <typename S, int NQ, int DIM>
int launch_smoother(const void* st, void* us, void* stds, int B, int T,
                    const double* k, void* stream) {
  if (B < 1 || T < 0) return (int)cudaErrorInvalidValue;
  constexpr int MB = ek1g::Tile<S>::MB;
  constexpr size_t sh = ek1g::smoother_smem_bytes<S, NQ, DIM, MB>();
  const void* kern = (const void*)ekd_smoother_kernel<S, NQ, DIM, MB>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh);
  if (e != cudaSuccess) return (int)e;
  ekd_smoother_kernel<S, NQ, DIM, MB>
      <<<(B + MB - 1) / MB, MB * NQ * DIM, sh, (cudaStream_t)stream>>>(
          (const S*)st, (S*)us, (S*)stds, B, T,
          read_consts<S, NQ, DIM>(k, false));
  return (int)cudaGetLastError();
}

template <typename S, int NQ, int DIM, int SC>
int launch_sampler_chunks(const void* st, const void* zn, void* out, int B,
                          int T, int NS, const Consts<S, NQ, DIM>& c,
                          cudaStream_t stream) {
  constexpr int MB = ek1g::Tile<S>::MB;
  constexpr size_t sh = ek1g::sampler_smem_bytes<S, NQ, DIM, MB, SC>();
  const void* kern = (const void*)ekd_sampler_kernel<S, NQ, DIM, MB, SC>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + MB - 1) / MB, (NS + SC - 1) / SC);
  ekd_sampler_kernel<S, NQ, DIM, MB, SC><<<grid, MB * NQ * DIM, sh, stream>>>(
      (const S*)st, (const S*)zn, (S*)out, B, T, NS, c);
  return (int)cudaGetLastError();
}

// The samples a lane keeps in registers: the least of 1, 2, 4, 8 at or
// above NS, so that up to 8 samples share one launch's conditioning; above
// 8, chunks of 8 on the grid's y dimension.
template <typename S, int NQ, int DIM>
int launch_sampler(const void* st, const void* zn, void* out, int B, int T,
                   int NS, const double* k, void* stream) {
  if (B < 1 || T < 0 || NS < 1) return (int)cudaErrorInvalidValue;
  const auto c = read_consts<S, NQ, DIM>(k, false);
  const cudaStream_t s = (cudaStream_t)stream;
  if (NS == 1)
    return launch_sampler_chunks<S, NQ, DIM, 1>(st, zn, out, B, T, NS, c, s);
  if (NS == 2)
    return launch_sampler_chunks<S, NQ, DIM, 2>(st, zn, out, B, T, NS, c, s);
  if (NS <= 4)
    return launch_sampler_chunks<S, NQ, DIM, 4>(st, zn, out, B, T, NS, c, s);
  return launch_sampler_chunks<S, NQ, DIM, 8>(st, zn, out, B, T, NS, c, s);
}

}  // namespace

// Plain C entry points, bound with ctypes (ops/_build.py: ENTRIES). Each
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError() after the launch. Instantiated for q = 3 (NQ = 4),
// d = 2, and the FHN and LV fields and their Jacobians for the filter.
extern "C" {

// mode: 0 dynamic, 1 fixed, 2 fixedMAP; lin may be null (no IEKS rows;
// dynamic only); sig is written under a static mode; smooth: stream Lp
#define EK1_STATES_ENTRIES(NAME, FIELD, S, SUF)                               \
  int ek1_filter_states_##NAME##_##SUF(                                      \
      const void* m0, const void* ps, const void* lin, void* st, void* sig,  \
      int B, int T, int mode, int smooth, const double* consts,              \
      void* stream) {                                                        \
    return launch_filter<S, 4, FIELD<S>>(m0, ps, lin, st, sig, B, T, mode,   \
                                         smooth, consts, stream);            \
  }

EK1_STATES_ENTRIES(fhn, Fhn, float, f32)
EK1_STATES_ENTRIES(fhn, Fhn, double, f64)
EK1_STATES_ENTRIES(lv, LotkaVolterra, float, f32)
EK1_STATES_ENTRIES(lv, LotkaVolterra, double, f64)

#undef EK1_STATES_ENTRIES

int ekd_smoother_f32(const void* st, void* us, void* stds, int B, int T,
                     const double* consts, void* stream) {
  return launch_smoother<float, 4, 2>(st, us, stds, B, T, consts, stream);
}

int ekd_smoother_f64(const void* st, void* us, void* stds, int B, int T,
                     const double* consts, void* stream) {
  return launch_smoother<double, 4, 2>(st, us, stds, B, T, consts, stream);
}

int ekd_sampler_f32(const void* st, const void* zn, void* out, int B, int T,
                    int NS, const double* consts, void* stream) {
  return launch_sampler<float, 4, 2>(st, zn, out, B, T, NS, consts,
                                     stream);
}

int ekd_sampler_f64(const void* st, const void* zn, void* out, int B, int T,
                    int NS, const double* consts, void* stream) {
  return launch_sampler<double, 4, 2>(st, zn, out, B, T, NS, consts,
                                      stream);
}

}  // extern "C"
