"""odefilters_torch — the PyTorch / CUDA port of ``odefilters``.

Probabilistic ODE solvers (Gaussian ODE filters) on PyTorch, with the hot
path in hand-written CUDA kernels for the NVIDIA H100. The JAX package
``odefilters`` beside it is the reference; module paths mirror it.

Ported so far, on a uniform grid with the IBM prior: the fused EK0 filter +
RTS smoother ensemble solve (dynamic or static diffusion), the fused EK0
filter with its per-member log-likelihood (dynamic or static diffusion)
and that likelihood's gradient by ``torch.autograd``, joint
smoothing-posterior sample paths (dynamic diffusion), and the same solve
(dynamic, fixed or fixedMAP; with or without the smoother) and sampler
with EK1, and the ensemble IEKS::

    import torch
    import odefilters_torch as odt
    prob = odt.models.fitzhugh_nagumo(dtype=torch.float32)  # on the card
    sol = odt.solve_ensemble(prob, odt.EK0(order=3), u0s, ps, n_save=500)
    sol.us, sol.stds   # (501, 2, B), (501, B)
    mv = odt.solve_ensemble(prob, odt.EK0(order=3, diffusionmodel="fixedMV"),
                            u0s, ps, n_save=500)
    mv.diffusions      # (2, B) calibrated sigma^2; mv.stds is (501, 2, B)
    fil = odt.solve_ensemble(prob, odt.EK0(order=3, smooth=False), u0s, ps,
                             n_save=500)
    fil.lls            # (B,), differentiable in u0s and ps
    g = torch.Generator(device="cuda").manual_seed(0)
    paths = odt.sample_ensemble(prob, odt.EK0(order=3), u0s, ps, generator=g,
                                n_steps=500, n_samples=8)  # (501, 8, 2, B)
    ek1 = odt.solve_ensemble(prob, odt.EK1(order=3), u0s, ps, n_save=500)
    ek1.stds           # (501, 2, B): per-dimension stds
    odt.sample_ensemble(prob, odt.EK1(order=3), u0s, ps, generator=g,
                        n_steps=500)                     # (501, 2, B)
    odt.ieks_ensemble(prob, odt.IEKS(order=3), u0s, ps, n_steps=500,
                      iterations=3)                      # us, stds

Constructors build on the CUDA card unless given ``device="cpu"``.

This package never imports JAX.
"""

import torch

# float32 products at full precision, as the JAX package's
# `linalg.highest_precision`: no TF32 in matmuls or convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from odefilters_torch import models  # noqa: E402
from odefilters_torch.algorithms import EK0, EK1, IEKS, AbstractEK  # noqa: E402
from odefilters_torch.ensemble import (  # noqa: E402
    EnsembleKernelSolution,
    ieks_ensemble,
    sample_ensemble,
    solve_ensemble,
)
from odefilters_torch.problem import ODEProblem, ode_problem, remake  # noqa: E402

__all__ = [
    "AbstractEK",
    "EK0",
    "EK1",
    "EnsembleKernelSolution",
    "IEKS",
    "ODEProblem",
    "ieks_ensemble",
    "models",
    "ode_problem",
    "remake",
    "sample_ensemble",
    "solve_ensemble",
]
