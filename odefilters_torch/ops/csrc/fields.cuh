// Vector fields the fused EK0 pair is built for.
//
// Each field is a functor over one ensemble member: D (state dimension),
// NP (parameter count) and operator()(u, p, t, du). The order of
// operations follows the model's PyTorch form in
// odefilters_torch/models/library.py, which the plain version of the pair
// evaluates; a field is selected by the name that ODEProblem.field
// carries (ops/ek0_pair.py: CUDA_FIELDS).
#pragma once

// FitzHugh-Nagumo, p = (a, b, 1/tau, I0): "fhn".
template <typename S>
struct Fhn {
  static constexpr int D = 2;
  static constexpr int NP = 4;

  __device__ __forceinline__ void operator()(const S* u, const S* p, S t,
                                             S* du) const {
    (void)t;
    const S a = p[0], b = p[1], tinv = p[2], izero = p[3];
    const S v = u[0], w = u[1];
    du[0] = v - v * (v * v) / S(3) - w + izero;
    du[1] = tinv * (v + a - b * w);
  }
};
