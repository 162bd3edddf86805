"""Front door of the fused ensemble solves (counterpart of
``odefilters/ensemble.py``).

Ported so far, on uniform grids with EK0: the filter + RTS smoother with
the dynamic diffusion, on the fused pair (`ops.ek0_pair`), and the filter
alone with its per-member log-likelihood and gradient, under the dynamic
or a static diffusion (`ops.ek0_filter`). Every other branch of the JAX
front door raises ``NotImplementedError`` naming the ROADMAP.md slice that
ports it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from odefilters_torch.algorithms import AbstractEK
from odefilters_torch.ops.ek0_filter import solve_ensemble_ek0
from odefilters_torch.ops.ek0_pair import solve_ensemble_ek0_smooth
from odefilters_torch.problem import ODEProblem


@dataclasses.dataclass(frozen=True)
class EnsembleKernelSolution:
    """Batched output of a fused ensemble solve.

    ``us``: ``(S+1, d, B)`` posterior means on the save grid; ``stds``:
    ``(S+1, B)`` marginal stds (the EK0 covariance is isotropic across
    dims), or ``(S+1, d, B)`` under fixedMV. ``lls``: ``(B,)`` ODE-residual
    log-likelihoods from the filter path (all NaN under a static diffusion;
    None from the filter + smoother pair). ``diffusions``: the calibrated
    per-member global sigma^2 under a static diffusion, ``(B,)`` or
    ``(d, B)`` for fixedMV; None otherwise. The JAX package's step counts
    come with the adaptive paths that produce them.
    """

    us: torch.Tensor
    stds: torch.Tensor
    lls: Optional[torch.Tensor] = None
    diffusions: Optional[torch.Tensor] = None


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
    With ``smooth=False`` the result carries ``lls``, and gradients of it
    with respect to ``u0s`` and ``ps`` flow by ``torch.autograd`` (dynamic
    diffusion only).
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
    if alg.diffusionmodel == "dynamicMV":
        raise NotImplementedError(
            "dynamicMV is not on the fused kernels, as in the JAX package"
        )
    if not alg.smooth:
        out = solve_ensemble_ek0(
            prob.f, u0s, ps, prob.tspan, n_save, q=alg.order,
            field=prob.field, prior=alg.prior, mesh=mesh,
            diffusion=alg.diffusionmodel,
        )
        if alg.diffusionmodel == "dynamic":
            return EnsembleKernelSolution(*out)
        us, stds, lls, sig = out
        return EnsembleKernelSolution(us, stds, lls, diffusions=sig)
    us, stds = solve_ensemble_ek0_smooth(
        prob.f, u0s, ps, prob.tspan, n_save, q=alg.order, field=prob.field,
        prior=alg.prior, mesh=mesh, diffusion=alg.diffusionmodel,
    )
    return EnsembleKernelSolution(us, stds)
