// The fused time-parallel scan's group kernels at group size 32 (state
// dimensions 17..32) in float64 (tp_group.cuh; tp_group.cu has the
// design): a translation unit of its own, as each of the two largest group sizes,
// so that nvcc builds it in parallel with tp_group_f64.cu, whose entries
// call it.

#include "tp_group.cuh"

// Plain C entry point, bound with ctypes (ops/_build.py: ENTRIES) and
// called by tp_group_f64.cu's entries: the three kernels at group size 32
// (tpg::run: op 0 chunk scan, 1 totals scan, 2 fixup).
extern "C" {

int tp_group32_f64(int op, int kind, int D, const void* a, const void* b,
                   void* w, void* o, int L, void* stream) {
  return tpg::run<double, 32>(op, kind, D, a, b, w, o, L, stream);
}

}  // extern "C"
