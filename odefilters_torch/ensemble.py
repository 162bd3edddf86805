"""Front door of the fused ensemble solves (counterpart of
``odefilters/ensemble.py``).

Ported so far, on uniform grids with EK0: the filter + RTS smoother on the
fused pair (`ops.ek0_pair`), the filter alone with its per-member
log-likelihood and gradient (`ops.ek0_filter`), both under the dynamic or
a static diffusion, and the joint-posterior sampler (`ops.ek0_sample`,
dynamic diffusion). Every other branch of the JAX front door raises
``NotImplementedError`` naming the ROADMAP.md slice that ports it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from odefilters_torch.algorithms import AbstractEK
from odefilters_torch.ops.ek0_filter import solve_ensemble_ek0
from odefilters_torch.ops.ek0_pair import solve_ensemble_ek0_smooth
from odefilters_torch.ops.ek0_sample import sample_ensemble_ek0
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
    if adaptive and alg.diffusionmodel != "dynamic":
        raise NotImplementedError(
            f"the fused adaptive kernels implement the dynamic diffusion "
            f"model; got {alg.diffusionmodel!r}: static models are per-lane "
            f"ill-posed under per-lane step control; use adaptive=False "
            f"(the fixed-grid kernels run fixed/fixedMAP/fixedMV)"
        )
    _check_unported(alg, adaptive)
    if alg.diffusionmodel == "dynamicMV":
        raise NotImplementedError(
            "dynamicMV is not on the fused kernels, as in the JAX package"
        )
    solve = solve_ensemble_ek0_smooth if alg.smooth else solve_ensemble_ek0
    out = solve(prob.f, u0s, ps, prob.tspan, n_save, q=alg.order,
                field=prob.field, prior=alg.prior, mesh=mesh,
                diffusion=alg.diffusionmodel)
    if alg.diffusionmodel == "dynamic":
        return EnsembleKernelSolution(*out)
    *outs, sig = out
    return EnsembleKernelSolution(*outs, diffusions=sig)


def _check_unported(alg: AbstractEK, adaptive: bool) -> None:
    if adaptive:
        raise NotImplementedError(
            "adaptive ensemble kernels are not ported yet "
            "(ROADMAP.md queue 1, slice 5); pass adaptive=False"
        )
    if alg.is_ek1:
        raise NotImplementedError(
            "EK1 ensemble kernels are not ported yet (ROADMAP.md queue 1, slice 4)"
        )


def sample_ensemble(
    prob: ODEProblem,
    alg: AbstractEK,
    u0s: torch.Tensor,
    ps: torch.Tensor,
    *,
    generator: torch.Generator,
    n_steps: int = 100,
    n_samples: int = 1,
    adaptive: bool = False,
    mesh=None,
) -> torch.Tensor:
    """Joint smoothing-posterior sample paths per ensemble member.

    A fixed-grid square-root EK0 filter kernel and a backward conditioning
    sampler kernel over ``n_steps`` uniform steps of ``prob.tspan``:
    ``(n_steps+1, d, B)`` samples of the solution, or
    ``(n_steps+1, n_samples, d, B)`` for ``n_samples > 1``; all samples of
    a member share one backward pass. The standard normals are drawn from
    ``generator``, which lies on the tensors' device. ``u0s``: ``(B, d)``;
    ``ps``: ``(B, n_params)``; any ``B >= 1``. EK0 with the dynamic
    diffusion only, and ``alg.smooth`` must be set (a joint backward draw
    is a smoothing pass), as in the JAX package.
    """
    if getattr(prob, "mass_matrix", None) is not None:
        raise NotImplementedError(
            "mass-matrix problems are supported on the dense solver paths only"
        )
    if alg.diffusionmodel != "dynamic":
        raise NotImplementedError(
            "the fused sampler implements the dynamic diffusion model"
        )
    if getattr(alg, "is_diagonal_ek1", False):
        raise NotImplementedError(
            "the fused sampler runs on the EK0 or EK1 kernel pairs, not on "
            "DiagonalEK1"
        )
    if not alg.smooth:
        raise ValueError("sampling not implemented for non-smoothed posteriors")
    _check_unported(alg, adaptive)
    return sample_ensemble_ek0(
        prob.f, u0s, ps, prob.tspan, n_steps, generator, q=alg.order,
        n_samples=n_samples, field=prob.field, prior=alg.prior, mesh=mesh,
    )
