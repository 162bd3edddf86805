"""Front door of the fused ensemble solves (counterpart of
``odefilters/ensemble.py``).

Ported so far, on uniform grids with EK0: the filter + RTS smoother on the
fused pair (`ops.ek0_pair`), the filter alone with its per-member
log-likelihood and gradient (`ops.ek0_filter`), both under the dynamic or
a static diffusion, and the joint-posterior sampler (`ops.ek0_sample`,
dynamic diffusion); with EK1 (`ops.ek1_fused`): the filter with or without
the RTS smoother under the dynamic, fixed or fixedMAP diffusion, the
joint-posterior sampler and the ensemble IEKS (`ieks_ensemble`). Every
other branch of the JAX front door raises ``NotImplementedError`` naming
the ROADMAP.md slice that ports it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from odefilters_torch.algorithms import AbstractEK
from odefilters_torch.ops.ek0_filter import solve_ensemble_ek0
from odefilters_torch.ops.ek0_pair import solve_ensemble_ek0_smooth
from odefilters_torch.ops.ek0_sample import sample_ensemble_ek0
from odefilters_torch.ops.ek1_fused import (
    sample_ensemble_ek1, solve_ensemble_ek1,
)
from odefilters_torch.problem import ODEProblem


@dataclasses.dataclass(frozen=True)
class EnsembleKernelSolution:
    """Batched output of a fused ensemble solve.

    ``us``: ``(S+1, d, B)`` posterior means on the save grid; ``stds``:
    ``(S+1, B)`` marginal stds from EK0 (its covariance is isotropic across
    dims), or ``(S+1, d, B)`` per-dimension stds from EK1 (its covariance
    is not) and from EK0 under fixedMV. ``lls``: ``(B,)`` ODE-residual
    log-likelihoods from the EK0 filter path (all NaN under a static
    diffusion; None from the smoothers and from EK1). ``diffusions``: the
    calibrated per-member global sigma^2 under a static diffusion, ``(B,)``
    or ``(d, B)`` for fixedMV; None otherwise. The JAX package's step counts
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
    vector field in ``prob.field``, with a Jacobian for EK1); CPU tensors
    run the plain versions. With EK0 and ``smooth=False`` the result
    carries ``lls``, and gradients of it with respect to ``u0s`` and ``ps``
    flow by ``torch.autograd`` (dynamic diffusion only). EK1 runs the
    dynamic, fixed or fixedMAP diffusion, with or without the smoother.
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
    if alg.is_ek1:
        out = solve_ensemble_ek1(
            prob.f, prob.jac, u0s, ps, prob.tspan, n_save, q=alg.order,
            smooth=alg.smooth, field=prob.field, prior=alg.prior, mesh=mesh,
            diffusion=alg.diffusionmodel,
        )
    else:
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
    if getattr(alg, "is_diagonal_ek1", False):
        raise NotImplementedError(
            "DiagonalEK1 ensemble kernels are not ported yet (ROADMAP.md "
            "queue 1, the rest of slice 4: _ek1d_kernel)"
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

    A fixed-grid square-root filter kernel (EK0, or EK1 with its D x D
    factor) and a backward conditioning sampler kernel over ``n_steps``
    uniform steps of ``prob.tspan``:
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
    if alg.is_ek1:
        return sample_ensemble_ek1(
            prob.f, prob.jac, u0s, ps, prob.tspan, n_steps, generator,
            q=alg.order, n_samples=n_samples, field=prob.field,
            prior=alg.prior, mesh=mesh,
        )
    return sample_ensemble_ek0(
        prob.f, u0s, ps, prob.tspan, n_steps, generator, q=alg.order,
        n_samples=n_samples, field=prob.field, prior=alg.prior, mesh=mesh,
    )


def ieks_ensemble(
    prob: ODEProblem,
    alg: AbstractEK,
    u0s: torch.Tensor,
    ps: torch.Tensor,
    *,
    n_steps: int = 100,
    iterations: int = 10,
    mesh=None,
) -> EnsembleKernelSolution:
    """Ensemble IEKS (MAP estimation) on the fused EK1 kernels: iterate the
    EK1 filter + smoother, feeding the previous iteration's smoothed means
    to the filter kernel as per-member Jacobian linearization points. The
    first sweep linearizes at the predicted mean (a plain EK1 solve); every
    later sweep re-linearizes the whole trajectory at once. B independent
    MAP problems per call; first-order problems, EK1, the dynamic
    diffusion, as in the JAX package. Returns ``(us, stds)``, each
    ``(n_steps+1, d, B)``.
    """
    if getattr(prob, "mass_matrix", None) is not None:
        raise NotImplementedError(
            "mass-matrix problems are supported on the dense solver paths only"
        )
    if alg.diffusionmodel != "dynamic":
        raise NotImplementedError(
            "the fused kernels implement the dynamic diffusion model"
        )
    if getattr(alg, "is_diagonal_ek1", False) or not alg.is_ek1:
        raise NotImplementedError("ensemble IEKS linearizes on the EK1 kernel")
    if getattr(prob, "second_order", False):
        raise NotImplementedError("ensemble IEKS is first-order only")
    if not alg.smooth:
        raise ValueError(
            "IEKS requires smooth=True (it linearizes at smoothed means)"
        )
    us = stds = None
    for _ in range(max(int(iterations), 1)):
        us, stds = solve_ensemble_ek1(
            prob.f, prob.jac, u0s, ps, prob.tspan, n_steps, q=alg.order,
            smooth=True, field=prob.field, prior=alg.prior, mesh=mesh,
            linearize_traj=us,
        )
    return EnsembleKernelSolution(us, stds)
