"""Front door of the fused ensemble solves (counterpart of
``odefilters/ensemble.py``).

Ported so far: the fixed-grid EK0 filter + RTS smoother with the dynamic
diffusion, which runs on the fused pair (`ops.ek0_pair`). Every other
branch of the JAX front door raises ``NotImplementedError`` naming the
ROADMAP.md slice that ports it.
"""

from __future__ import annotations

import dataclasses

import torch

from odefilters_torch.algorithms import AbstractEK
from odefilters_torch.ops.ek0_pair import solve_ensemble_ek0_smooth
from odefilters_torch.problem import ODEProblem


@dataclasses.dataclass(frozen=True)
class EnsembleKernelSolution:
    """Batched output of a fused ensemble solve.

    ``us``: ``(S+1, d, B)`` posterior means on the save grid; ``stds``:
    ``(S+1, B)`` marginal stds (the EK0 covariance is isotropic across
    dims). The JAX package's log-likelihoods, step counts and calibrated
    diffusions come with the paths that produce them.
    """

    us: torch.Tensor
    stds: torch.Tensor


def solve_ensemble(
    prob: ODEProblem,
    alg: AbstractEK,
    u0s: torch.Tensor,
    ps: torch.Tensor,
    *,
    n_save: int,
    adaptive: bool = False,
    mesh=None,
) -> EnsembleKernelSolution:
    """Solve ``B`` independent IVPs ``(u0s[i], ps[i])`` on the fused kernels.

    ``u0s``: ``(B, d)``; ``ps``: ``(B, n_params)``; any ``B >= 1``.
    ``n_save`` is the number of uniform steps over ``prob.tspan``. Tensors
    on a CUDA device run the CUDA kernels (the problem must name a CUDA
    vector field in ``prob.field``); CPU tensors run the plain versions.
    """
    if adaptive:
        raise NotImplementedError(
            "adaptive ensemble kernels are not ported yet "
            "(ROADMAP.md queue 1, slice 5); pass adaptive=False"
        )
    if alg.is_ek1:
        raise NotImplementedError(
            "EK1 ensemble kernels are not ported yet (ROADMAP.md queue 1, slice 4)"
        )
    if not alg.smooth:
        raise NotImplementedError(
            "the fixed-grid EK0 filter without smoother is not ported yet "
            "(ROADMAP.md queue 1, slice 2)"
        )
    us, stds = solve_ensemble_ek0_smooth(
        prob.f, u0s, ps, prob.tspan, n_save, q=alg.order, field=prob.field,
        prior=alg.prior, mesh=mesh, diffusion=alg.diffusionmodel,
    )
    return EnsembleKernelSolution(us, stds)
