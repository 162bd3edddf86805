// The fused time-parallel scan for Hopper (sm_90a) above state dimension
// 32: the three scan kernels with a CTA per combine, in float32
// (tp_wide_f64.cu: float64, so that nvcc builds the two in parallel).
//
// Replaces the TPU kernels in odefilters/parallel/pallas_scan.py, which take
// D from the elements, at D > 32 (tp_group.cu runs 2 <= D <= 32):
//   tp_chunk_scan_wide_kernel  <- _chunk_scan_kernel;
//   tp_totals_scan_wide_kernel <- _totals_scan_kernel (cooperative);
//   tp_fixup_wide_kernel       <- _fixup_kernel.
// Their plain PyTorch versions, in the same order of operations, and the
// Python wrappers are in odefilters_torch/ops/tp_scan.py; the combines and
// kernels in tp_wide.cuh.
//
// Design. Above D = 32 a combine's ten D x D operands outgrow a warp's
// registers and, for a group of several combines, an SM's shared memory
// (327 kB at D = 64 in float64). So one combine runs on one CTA of G lanes
// (G the power of two at or above D, 64 or 128), lane r owning row r of
// every matrix and lane j column j of each Gram-Schmidt stack, as in the
// group kernels, with CTA barriers where they have warp barriers; every
// sum stays in one lane, in index order, so the combines are bit for bit
// with the group kernels' and the plain versions. The operands, the
// Gram-Schmidt stack and the vectors (13 D x D matrices and 10 D vectors
// a filtering combine) live in a workspace: the CTA's dynamic shared
// memory where it fits in the 227 kB a CTA may take (float32 up to D = 65,
// float64 up to D = 46), else a per-CTA slice of a global buffer that the
// wrapper allocates (tp_wide_ws_*), read through L1 and L2. The kernels
// take D up to tpw::D_MAX = 96, the largest held on the card; their code
// has no limit of its own below 1024. Every loop runs over D at run time,
// so one small body serves every D and nvcc's time does not grow with it.
// The chunk scan and fixup run a CTA per chunk or element (with a global
// workspace, as many CTAs as are resident, striding); the cooperative
// totals scan runs a power of two of resident CTAs, each carrying 1024 /
// CTAs totals one after another in every round.
//
// What bounds them: the chain of dependent operations of a combine (2D
// Gram-Schmidt pivots of 4D values each, forward and back substitutions
// of D steps), run by one lane at a time at each pivot, far above the
// bytes moved (a filtering element is 3 D^2 + 2 D values). Built without
// FMA contraction (ops/_build.py: SOURCE_FLAGS).

#include "tp_wide.cuh"

// Plain C entry points, bound with ctypes (ops/_build.py: ENTRIES). op 0
// the chunk scan (elems a, out o, L rows), 1 the totals scan (totals a,
// work w, out o), 2 the fixup (prefixes a, t_excl b, out o, L rows); kind
// 0 filtering, 1 smoothing elements; 33 <= D <= 96; gws the global
// workspace of the values tp_wide_ws_f32(op, kind, D, L, &values) writes
// (null when that is 0). tp_wide_f32 launches on the given stream, does not
// synchronise, and returns the CUDA error code of the launch.
extern "C" {

int tp_wide_f32(int op, int kind, int D, const void* a, const void* b,
                void* w, void* o, int L, void* gws, void* stream) {
  return tpw::run<float>(op, kind, D, a, b, w, o, L, gws, stream);
}

int tp_wide_ws_f32(int op, int kind, int D, int L, void* values) {
  return tpw::workspace<float>(op, kind, D, L, (long long*)values);
}

}  // extern "C"
