// Vector fields the fused EK0 pair is built for.
//
// Each field is a functor over one ensemble member: D (state dimension),
// NP (parameter count), operator()(u, p, t, du), its vector-Jacobian
// product vjp(u, p, t, g, gu, gp), which writes gu = (df/du)^T g and adds
// (df/dp)^T g to gp (the filter's hand-written adjoint calls it), and its
// Jacobian jac(u, p, t, J), J = df/du row-major D x D (the EK1 kernels
// evaluate it in the kernel). The
// order of operations follows the model's PyTorch form in
// odefilters_torch/models/library.py, which the plain versions evaluate
// and differentiate by autograd; a field is selected by the name that
// ODEProblem.field carries (ops/_launch.py: CUDA_FIELDS). A division by
// a constant is a product with the constant's reciprocal, as PyTorch's CUDA
// division by a Python number computes it.
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
    du[0] = v - v * (v * v) * (S(1) / S(3)) - w + izero;
    du[1] = tinv * (v + a - b * w);
  }

  __device__ __forceinline__ void vjp(const S* u, const S* p, S t,
                                      const S* g, S* gu, S* gp) const {
    (void)t;
    const S a = p[0], b = p[1], tinv = p[2];
    const S v = u[0], w = u[1];
    const S g1t = g[1] * tinv;
    gu[0] = g[0] * (S(1) - v * v) + g1t;
    gu[1] = -g[0] - g1t * b;
    gp[0] += g1t;
    gp[1] -= g1t * w;
    gp[2] += g[1] * (v + a - b * w);
    gp[3] += g[0];
  }

  __device__ __forceinline__ void jac(const S* u, const S* p, S t,
                                      S* J) const {
    (void)t;
    const S b = p[1], tinv = p[2];
    const S v = u[0];
    J[0] = S(1) - v * v;
    J[1] = S(-1);
    J[2] = tinv;
    J[3] = -tinv * b;
  }
};
