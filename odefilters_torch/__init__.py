"""odefilters_torch — the PyTorch / CUDA port of ``odefilters``.

Probabilistic ODE solvers (Gaussian ODE filters) on PyTorch, with the hot
path in hand-written CUDA kernels for the NVIDIA H100. The JAX package
``odefilters`` beside it is the reference; module paths mirror it.

Ported so far, with the IBM prior: the adaptive per-member ensemble
solves with EK0, DiagonalEK1 and EK1 (the default, as in the JAX package:
PI-controlled steps per member, filter + RTS smoother over each member's
accepted steps, or the filter alone), joint posterior samples of the
adaptive EK0 solve, a single adaptive solve on the same kernels, and on a
uniform grid the fused EK0 filter + RTS smoother ensemble
solve (dynamic or static diffusion), the fused EK0 filter with its
per-member log-likelihood (dynamic or static diffusion) and that
likelihood's gradient by ``torch.autograd``, joint smoothing-posterior
sample paths (dynamic diffusion), and the same solve (dynamic, fixed or
fixedMAP; with or without the smoother) and sampler with EK1, and the
ensemble IEKS; and the per-candidate data likelihood with its gradient
(``ensemble_data_loglik``): noisy full-state observations on or off the
grid (isotropic EK0), and on the grid partial one-hot observations,
per-dimension noise, per-member data, DiagonalEK1 and, with ``ek1=True``,
dense EK1 with any observation matrix; and one trajectory of a
semi-discretized PDE on a grid (the 2-D Brusselator, d = 2 N^2) with EK0
or DiagonalEK1, on cooperative kernels; and one trajectory on a long
uniform grid in parallel in time (``solve_fixed_parallel``: iterated
square-root associative scans, global or in windows, on the fused scan
kernels). Vector fields with CUDA kernels: FitzHugh-Nagumo and
Lotka-Volterra (ensembles, and the time-parallel warm start), the
Brusselator stencil (grids); the time-parallel scans take any vector field
of a state of dimension d (q+1) = 8::

    import torch
    import odefilters_torch as odt
    prob = odt.models.fitzhugh_nagumo(dtype=torch.float32)  # on the card
    sol = odt.solve_ensemble(prob, odt.EK0(order=3), u0s, ps, n_save=20,
                             abstol=1e-6, reltol=1e-4)   # adaptive
    sol.us, sol.stds   # (21, 2, B), (21, B) smoothed, on the save grid
    sol.nacc, sol.nrej, sol.failed  # (B,) per-member step counts, flags
    sol = odt.solve_ensemble(prob, odt.EK0(order=3), u0s, ps, n_save=500,
                             adaptive=False)             # 500 uniform steps
    mv = odt.solve_ensemble(prob, odt.EK0(order=3, diffusionmodel="fixedMV"),
                            u0s, ps, n_save=500, adaptive=False)
    mv.diffusions      # (2, B) calibrated sigma^2; mv.stds is (501, 2, B)
    fil = odt.solve_ensemble(prob, odt.EK0(order=3, smooth=False), u0s, ps,
                             n_save=500, adaptive=False)
    fil.lls            # (B,), differentiable in u0s and ps
    g = torch.Generator(device="cuda").manual_seed(0)
    paths = odt.sample_ensemble(prob, odt.EK0(order=3), u0s, ps, generator=g,
                                n_steps=500, n_samples=8)  # (501, 8, 2, B)
    ek1 = odt.solve_ensemble(prob, odt.EK1(order=3), u0s, ps, n_save=500,
                             adaptive=False)
    ek1.stds           # (501, 2, B): per-dimension stds
    odt.sample_ensemble(prob, odt.EK1(order=3), u0s, ps, generator=g,
                        n_steps=500)                     # (501, 2, B)
    odt.ieks_ensemble(prob, odt.IEKS(order=3), u0s, ps, n_steps=500,
                      iterations=3)                      # us, stds
    odt.solve_ensemble(prob, odt.EK1(order=3), u0s, ps)  # adaptive, smoothed
    odt.sample_ensemble(prob, odt.EK0(order=3), u0s, ps, generator=g,
                        n_steps=20, adaptive=True)       # (21, 2, B)
    lv = odt.models.lotka_volterra(tspan=(0.0, 3.0))
    dll, ll = odt.ensemble_data_loglik(lv.f, u0s, ps, lv.tspan, 120, ts, ys,
                                       0.05, field=lv.field)  # (B,) each,
                                       # differentiable in u0s, ps and ys
    odt.ensemble_data_loglik(lv.f, u0s, ps, lv.tspan, 120, ts, ys[:, :1],
                             0.05, obs_matrix=[[1.0, 0.0]],
                             field=lv.field)  # prey only, ts on the grid
    odt.ensemble_data_loglik(lv.f, u0s, ps, lv.tspan, 120, ts, ys, 0.05,
                             obs_matrix=[[1.0, 0.0], [1.0, 1.0]], ek1=True,
                             jac=lv.jac, field=lv.field)  # dense EK1
    us, var, ll = odt.solve_brusselator_ek0(70, (0.0, 0.01), 1000,
                                            save_every=50)  # d = 9800
    us.shape, var.shape  # (21, 2, 70, 70), (21,): isotropic variance
    us, var, ll = odt.solve_brusselator_ek1d(70, (0.0, 0.01), 1000,
                                             save_every=50)
    var.shape          # (21, 2, 70, 70): per point
    u, u_std, means, covs, sigma2 = odt.solve_fixed_parallel(
        prob, odt.EK1(order=3), ts=torch.linspace(0.0, 20.0, 16385,
                                                  device="cuda"),
        iterations=2)  # N = 16384: fused scans, warm start by default
    u.shape, covs.shape  # (16385, 2), (16385, 8, 8)
    odt.solve_fixed_parallel(prob, odt.EK0(order=3), dt=20.0 / 16384,
                             iterations=2, windows=16)  # 1024-step windows

Constructors build on the CUDA card unless given ``device="cpu"``.

This package never imports JAX.
"""

import torch

# float32 products at full precision, as the JAX package's
# `linalg.highest_precision`: no TF32 in matmuls or convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from odefilters_torch import models  # noqa: E402
from odefilters_torch.algorithms import (  # noqa: E402
    EK0, EK1, IEKS, AbstractEK, DiagonalEK1,
)
from odefilters_torch.ensemble import (  # noqa: E402
    EnsembleKernelSolution,
    ieks_ensemble,
    sample_ensemble,
    solve_ensemble,
)
from odefilters_torch.ops.ek0_datalik import ensemble_data_loglik  # noqa: E402
from odefilters_torch.ops.ek1_adaptive import solve_adaptive_single  # noqa: E402
from odefilters_torch.ops.kron_grid import (  # noqa: E402
    solve_brusselator_ek0,
    solve_brusselator_ek1d,
)
from odefilters_torch.parallel.associative import (  # noqa: E402
    solve_fixed_parallel,
)
from odefilters_torch.problem import ODEProblem, ode_problem, remake  # noqa: E402

__all__ = [
    "AbstractEK",
    "DiagonalEK1",
    "EK0",
    "EK1",
    "EnsembleKernelSolution",
    "IEKS",
    "ODEProblem",
    "ensemble_data_loglik",
    "ieks_ensemble",
    "models",
    "ode_problem",
    "remake",
    "sample_ensemble",
    "solve_adaptive_single",
    "solve_brusselator_ek0",
    "solve_brusselator_ek1d",
    "solve_ensemble",
    "solve_fixed_parallel",
]
