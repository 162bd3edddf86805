// The fused time-parallel scan's group kernels at group size 16 (state
// dimensions 9..16) in float32 (tp_group.cuh; tp_group.cu has the
// design): a translation unit of its own, as each of the two largest group sizes,
// so that nvcc builds it in parallel with tp_group.cu, whose entries call it.

#include "tp_group.cuh"

// Plain C entry point, bound with ctypes (ops/_build.py: ENTRIES) and
// called by tp_group.cu's entries: the three kernels at group size 16
// (tpg::run: op 0 chunk scan, 1 totals scan, 2 fixup).
extern "C" {

int tp_group16_f32(int op, int kind, int D, const void* a, const void* b,
                   void* w, void* o, int L, void* stream) {
  return tpg::run<float, 16>(op, kind, D, a, b, w, o, L, stream);
}

}  // extern "C"
