// Vector fields the fused kernels are built for: FitzHugh-Nagumo and
// Lotka-Volterra.
//
// Each field is a functor over one ensemble member: D (state dimension),
// NP (parameter count), operator()(u, p, t, du), its vector-Jacobian
// product vjp(u, p, t, g, gu, gp), which writes gu = (df/du)^T g and adds
// (df/dp)^T g to gp (the filter's hand-written adjoint calls it), and its
// Jacobian jac(u, p, t, J), J = df/du row-major D x D (the EK1 kernels
// evaluate it in the kernel), and its diagonal jac_diag(u, p, t, jd), the
// entries J[j][j] as jac computes them (the DiagonalEK1 kernels), with its
// vector-Jacobian product jac_diag_vjp(u, p, t, g, gu, gp), which writes
// gu = (d jd/du)^T g and adds (d jd/dp)^T g to gp (the per-dimension data
// likelihood's hand-written DiagonalEK1 adjoint), and the vector-Jacobian
// product of the whole Jacobian, jac_vjp(u, p, t, G, gu, gp), which for a
// row-major D x D cotangent G writes gu[k] = sum_ab G[a][b] dJ_ab/du_k and
// adds sum_ab G[a][b] dJ_ab/dp_i to gp[i] (the dense EK1 data likelihood's
// hand-written adjoint). The
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

  __device__ __forceinline__ void jac_diag(const S* u, const S* p, S t,
                                           S* jd) const {
    (void)t;
    const S b = p[1], tinv = p[2];
    const S v = u[0];
    jd[0] = S(1) - v * v;
    jd[1] = -tinv * b;
  }

  // jd = (1 - v^2, -tinv b)
  __device__ __forceinline__ void jac_diag_vjp(const S* u, const S* p, S t,
                                               const S* g, S* gu,
                                               S* gp) const {
    (void)t;
    const S b = p[1], tinv = p[2];
    const S v = u[0];
    gu[0] = -g[0] * (v + v);
    gu[1] = S(0);
    gp[1] -= g[1] * tinv;
    gp[2] -= g[1] * b;
  }

  // J = [[1 - v^2, -1], [tinv, -tinv b]]
  __device__ __forceinline__ void jac_vjp(const S* u, const S* p, S t,
                                          const S* G, S* gu, S* gp) const {
    (void)t;
    const S b = p[1], tinv = p[2];
    const S v = u[0];
    gu[0] = -G[0] * (v + v);
    gu[1] = S(0);
    gp[1] -= G[3] * tinv;
    gp[2] += G[2] - G[3] * b;
  }
};

// Lotka-Volterra, p = (a, b, c, d): "lv". -c * y is the negation of c times
// y, and b * x * y is (b * x) * y, as in the PyTorch form.
template <typename S>
struct LotkaVolterra {
  static constexpr int D = 2;
  static constexpr int NP = 4;

  __device__ __forceinline__ void operator()(const S* u, const S* p, S t,
                                             S* du) const {
    (void)t;
    const S a = p[0], b = p[1], c = p[2], d = p[3];
    const S x = u[0], y = u[1];
    du[0] = a * x - b * x * y;
    du[1] = -c * y + d * x * y;
  }

  __device__ __forceinline__ void vjp(const S* u, const S* p, S t,
                                      const S* g, S* gu, S* gp) const {
    (void)t;
    const S a = p[0], b = p[1], c = p[2], d = p[3];
    const S x = u[0], y = u[1];
    gu[0] = g[0] * (a - b * y) + g[1] * (d * y);
    gu[1] = -g[0] * (b * x) + g[1] * (d * x - c);
    gp[0] += g[0] * x;
    gp[1] -= g[0] * (x * y);
    gp[2] -= g[1] * y;
    gp[3] += g[1] * (x * y);
  }

  __device__ __forceinline__ void jac(const S* u, const S* p, S t,
                                      S* J) const {
    (void)t;
    const S a = p[0], b = p[1], c = p[2], d = p[3];
    const S x = u[0], y = u[1];
    J[0] = a - b * y;
    J[1] = -b * x;
    J[2] = d * y;
    J[3] = -c + d * x;
  }

  __device__ __forceinline__ void jac_diag(const S* u, const S* p, S t,
                                           S* jd) const {
    (void)t;
    const S a = p[0], b = p[1], c = p[2], d = p[3];
    const S x = u[0], y = u[1];
    jd[0] = a - b * y;
    jd[1] = -c + d * x;
  }

  // jd = (a - b y, -c + d x)
  __device__ __forceinline__ void jac_diag_vjp(const S* u, const S* p, S t,
                                               const S* g, S* gu,
                                               S* gp) const {
    (void)t;
    const S b = p[1], d = p[3];
    const S x = u[0], y = u[1];
    gu[0] = g[1] * d;
    gu[1] = -g[0] * b;
    gp[0] += g[0];
    gp[1] -= g[0] * y;
    gp[2] -= g[1];
    gp[3] += g[1] * x;
  }

  // J = [[a - b y, -b x], [d y, -c + d x]]
  __device__ __forceinline__ void jac_vjp(const S* u, const S* p, S t,
                                          const S* G, S* gu, S* gp) const {
    (void)t;
    const S b = p[1], d = p[3];
    const S x = u[0], y = u[1];
    gu[0] = -G[1] * b + G[3] * d;
    gu[1] = -G[0] * b + G[2] * d;
    gp[0] += G[0];
    gp[1] -= G[0] * y + G[1] * x;
    gp[2] -= G[3];
    gp[3] += G[2] * y + G[3] * x;
  }
};
