"""odefilters_torch — the PyTorch / CUDA port of ``odefilters``.

Probabilistic ODE solvers (Gaussian ODE filters) on PyTorch, with the hot
path in hand-written CUDA kernels for the NVIDIA H100. The JAX package
``odefilters`` beside it is the reference; module paths mirror it.

Ported so far, on a uniform grid with the IBM prior: the fused EK0 filter +
RTS smoother ensemble solve (dynamic diffusion), and the fused EK0 filter
with its per-member log-likelihood (dynamic or static diffusion) and that
likelihood's gradient by ``torch.autograd``::

    import torch
    import odefilters_torch as odt
    prob = odt.models.fitzhugh_nagumo(dtype=torch.float32)  # on the card
    sol = odt.solve_ensemble(prob, odt.EK0(order=3), u0s, ps, n_save=500)
    sol.us, sol.stds   # (501, 2, B), (501, B)
    fil = odt.solve_ensemble(prob, odt.EK0(order=3, smooth=False), u0s, ps,
                             n_save=500)
    fil.lls            # (B,), differentiable in u0s and ps

Constructors build on the CUDA card unless given ``device="cpu"``.

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
