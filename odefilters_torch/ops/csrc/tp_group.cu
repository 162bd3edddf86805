// The fused time-parallel scan for Hopper (sm_90a) at any state dimension
// 2 <= D <= 32: the three scan kernels with a group of lanes per combine.
//
// Replaces the TPU kernels in odefilters/parallel/pallas_scan.py, which take
// D from the elements:
//   tp_chunk_scan_group_kernel  <- _chunk_scan_kernel (D != 8; D = 8 runs
//                                  tp_scan.cu's one-thread kernel);
//   tp_totals_scan_group_kernel <- _totals_scan_kernel (every D);
//   tp_fixup_group_kernel       <- _fixup_kernel (D != 8, as the chunk scan).
// Their plain PyTorch versions, in the same order of operations, and the
// Python wrappers are in odefilters_torch/ops/tp_scan.py; the group combines
// and the kernels in tp_group.cuh. This unit instantiates them in float32,
// tp_group_f64.cu in float64, so that nvcc builds the two in parallel.
//
// Design. A combine of square-root elements is a few thousand dependent
// operations on ~400 live values: one thread runs it serially and spills
// (tp_scan.cu). Here a group of G lanes (the power of two at or above D)
// runs it: lane r owns row r of every matrix and computes that row of each
// product, lane j owns column j of each Gram-Schmidt stack, and the
// operands other rows need go through the group's shared memory between
// warp-level barriers. Every sum stays in one lane, in index order, so the
// group combines are bit for bit with the one-thread ones and the plain
// versions. The totals scan is one cooperative launch of 1024 groups
// (8192 threads in 64 CTAs at D = 8): ten Hillis-Steele rounds through two
// ping-pong buffers in L2 with a grid barrier between, the last written
// shifted by one. The chunk scan runs a group per chunk over its rows, the
// fixup a group per element. D is an argument; G is a template parameter,
// so every loop is unrolled over G with the entries at or past D skipped.
// At G = 32 (17 <= D <= 32) a group is a warp, and its workspace (ten
// 32 x 32 operands, 42.75 kB in float32, 85.5 kB in float64) leaves room
// for one CTA an SM of 4 (2) groups: the totals scan's 1024 totals then
// run 2 (4) a group, one after another within each round, in 128 CTAs that
// are all resident. Above D = 32 the ten operands of a combine outgrow an
// SM's shared memory (327 kB at D = 64 in float64): tp_wide.cu runs a
// combine on a whole CTA there.
//
// What bounds them: as tp_scan.cu's kernels, their bytes (the totals scan
// moves 1.7 MB of float32 filter totals at D = 8: half a microsecond), far
// below the latency of a combine's chain of dependent operations, ten of
// which the totals scan runs one after another. Built without FMA
// contraction (ops/_build.py: SOURCE_FLAGS).

#include "tp_group.cuh"

// Group size 16 (9 <= D <= 16), built by tp_group16.cu in parallel.
extern "C" int tp_group16_f32(int, int, int, const void*, const void*,
                              void*, void*, int, void*);
// Group size 32 (17 <= D <= 32), built by tp_group32.cu in parallel.
extern "C" int tp_group32_f32(int, int, int, const void*, const void*,
                              void*, void*, int, void*);

// The D = 8 one-thread chunk scan and fixup (tp_scan.cu).
extern "C" int tp_chunk_scan_d8_f32(int, const void*, void*, int, void*);
extern "C" int tp_fixup_d8_f32(int, const void*, const void*, void*, int,
                               void*);

// Plain C entry points, bound with ctypes (ops/_build.py: ENTRIES). kind: 0
// filter elements (A, b, U, eta, Z), 1 smoothing elements (E, g, P); D the
// state dimension, 2..32. Each launches on the given stream, does not
// synchronise, and returns the CUDA error code of the launch (the totals
// scan cudaErrorCooperativeLaunchTooLarge when its grid cannot be
// co-resident).
extern "C" {

int tp_chunk_scan_f32(int kind, int D, const void* elems, void* out, int L,
                      void* stream) {
  if (D == 8) return tp_chunk_scan_d8_f32(kind, elems, out, L, stream);
  return tpg::run_for<float>(0, kind, D, elems, nullptr, nullptr, out, L,
                          stream, tp_group16_f32, tp_group32_f32);
}

int tp_totals_scan_f32(int kind, int D, const void* totals, void* work,
                       void* out, void* stream) {
  return tpg::run_for<float>(1, kind, D, totals, nullptr, work, out, 1, stream,
                          tp_group16_f32, tp_group32_f32);
}

int tp_fixup_f32(int kind, int D, const void* prefixes, const void* t_excl,
                 void* out, int L, void* stream) {
  if (D == 8) return tp_fixup_d8_f32(kind, prefixes, t_excl, out, L, stream);
  return tpg::run_for<float>(2, kind, D, prefixes, t_excl, nullptr, out, L,
                          stream, tp_group16_f32, tp_group32_f32);
}

}  // extern "C"
