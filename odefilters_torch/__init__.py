"""odefilters_torch — the PyTorch / CUDA port of ``odefilters``.

Probabilistic ODE solvers (Gaussian ODE filters) on PyTorch, with the hot
path in hand-written CUDA kernels for the NVIDIA H100. The JAX package
``odefilters`` beside it is the reference; module paths mirror it.

Ported so far: the fused EK0 filter + RTS smoother ensemble solve on a
uniform grid, with the dynamic diffusion and the IBM prior::

    import torch
    import odefilters_torch as odt
    prob = odt.models.fitzhugh_nagumo(device="cuda", dtype=torch.float32)
    sol = odt.solve_ensemble(prob, odt.EK0(order=3), u0s, ps, n_save=500)
    sol.us, sol.stds   # (501, 2, B), (501, B)

This package never imports JAX.
"""

import torch

# float32 products at full precision, as the JAX package's
# `linalg.highest_precision`: no TF32 in matmuls or convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from odefilters_torch import models  # noqa: E402
from odefilters_torch.algorithms import EK0, EK1, AbstractEK  # noqa: E402
from odefilters_torch.ensemble import (  # noqa: E402
    EnsembleKernelSolution,
    solve_ensemble,
)
from odefilters_torch.problem import ODEProblem, ode_problem, remake  # noqa: E402

__all__ = [
    "AbstractEK",
    "EK0",
    "EK1",
    "EnsembleKernelSolution",
    "ODEProblem",
    "models",
    "ode_problem",
    "remake",
    "solve_ensemble",
]
