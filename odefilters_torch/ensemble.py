"""Front door of the fused ensemble solves (counterpart of
``odefilters/ensemble.py``).

Ported so far, with adaptive steps (the default, as in the JAX package),
with EK0 (`ops.ek0_adaptive`), DiagonalEK1 (`ops.ek1d_adaptive`) and EK1
(`ops.ek1_adaptive`): the per-member adaptive filter and the adaptive
filter + RTS smoother over each member's accepted steps, and with EK0 the
joint-posterior sampler over them (`ops.ek0_adaptive_sample`). On uniform
grids (``adaptive=False``) with
EK0: the filter + RTS smoother on the fused pair (`ops.ek0_pair`), the
filter alone with its per-member log-likelihood and gradient
(`ops.ek0_filter`), both under the dynamic or a static diffusion, and the
joint-posterior sampler (`ops.ek0_sample`, dynamic diffusion); with EK1
(`ops.ek1_fused`): the filter with or without the RTS smoother under the
dynamic, fixed or fixedMAP diffusion, the joint-posterior sampler and the
ensemble IEKS (`ieks_ensemble`); with DiagonalEK1 (`ops.ek1d`): the filter
under the dynamic or a static diffusion. Every other branch of the JAX
front door raises as the JAX front door does, or names the ROADMAP.md item
that ports it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from odefilters_torch.algorithms import AbstractEK
from odefilters_torch.ops.ek0_adaptive import (
    solve_ensemble_ek0_adaptive, solve_ensemble_ek0_adaptive_smooth,
)
from odefilters_torch.ops.ek0_adaptive_sample import (
    sample_ensemble_ek0_adaptive,
)
from odefilters_torch.ops.ek0_filter import solve_ensemble_ek0
from odefilters_torch.ops.ek0_pair import solve_ensemble_ek0_smooth
from odefilters_torch.ops.ek0_sample import sample_ensemble_ek0
from odefilters_torch.ops.ek1_fused import (
    sample_ensemble_ek1, solve_ensemble_ek1,
)
from odefilters_torch.ops.ek1_adaptive import (
    solve_ensemble_ek1_adaptive, solve_ensemble_ek1_adaptive_smooth,
)
from odefilters_torch.ops.ek1d import jac_diag_of, solve_ensemble_ek1d
from odefilters_torch.ops.ek1d_adaptive import (
    solve_ensemble_ek1d_adaptive, solve_ensemble_ek1d_adaptive_smooth,
)
from odefilters_torch.problem import ODEProblem


@dataclasses.dataclass(frozen=True)
class EnsembleKernelSolution:
    """Batched output of a fused ensemble solve.

    ``us``: ``(S+1, d, B)`` posterior means on the save grid; ``stds``:
    ``(S+1, B)`` marginal stds from EK0 (its covariance is isotropic across
    dims), or ``(S+1, d, B)`` per-dimension stds from EK1 and DiagonalEK1
    (their covariances are not) and from EK0 under fixedMV. ``lls``:
    ``(B,)`` ODE-residual log-likelihoods from the EK0 and DiagonalEK1
    filter paths and the adaptive paths (all NaN under a static diffusion;
    None from the fixed-grid smoothers and the fixed-grid EK1). ``nacc``, ``nrej``:
    ``(B,)`` int32 accepted and rejected attempts per member, and
    ``failed``: ``(B,)`` bool, from the adaptive paths (None on fixed
    grids). ``diffusions``: the calibrated per-member global sigma^2 under
    a static diffusion, ``(B,)`` or ``(d, B)`` for fixedMV; None
    otherwise.
    """

    us: torch.Tensor
    stds: torch.Tensor
    lls: Optional[torch.Tensor] = None
    nacc: Optional[torch.Tensor] = None
    nrej: Optional[torch.Tensor] = None
    failed: Optional[torch.Tensor] = None
    diffusions: Optional[torch.Tensor] = None


def solve_ensemble(
    prob: ODEProblem,
    alg: AbstractEK,
    u0s: torch.Tensor,
    ps: torch.Tensor,
    *,
    n_save: int = 20,
    adaptive: bool = True,
    abstol: float = 1e-6,
    reltol: float = 1e-3,
    max_iters: Optional[int] = None,
    mesh=None,
) -> EnsembleKernelSolution:
    """Solve ``B`` independent IVPs ``(u0s[i], ps[i])`` on the fused kernels.

    ``u0s``: ``(B, d)``; ``ps``: ``(B, n_params)``; any ``B >= 1``.
    ``n_save``: the number of uniform save intervals over ``prob.tspan``;
    adaptive members land on the save grid exactly (tstops). On fixed
    grids (``adaptive=False``) it is the step count, and the tolerances
    are unused. Tensors on a CUDA device run the CUDA kernels (the problem
    must name a CUDA vector field in ``prob.field``, with a Jacobian for
    EK1 and a Jacobian diagonal for DiagonalEK1); CPU tensors run the plain
    versions.

    Adaptive (EK0, DiagonalEK1 or EK1, the dynamic diffusion): each member
    runs its own PI-controlled steps at ``abstol`` / ``reltol``;
    ``max_iters`` bounds each member's attempts (default 1024 with the
    smoother, whose stream it sizes, 512 for EK1's wider stream, else
    100 000) and the result carries ``lls``,
    ``nacc``, ``nrej`` and ``failed``. Fixed grids: with EK0 and
    ``smooth=False`` the result carries ``lls``, and gradients of it with
    respect to ``u0s`` and ``ps`` flow by ``torch.autograd`` (dynamic
    diffusion only); EK1 runs the dynamic, fixed or fixedMAP diffusion,
    with or without the smoother; DiagonalEK1 runs the filter alone
    (``smooth=False``) under the dynamic, fixed, fixedMAP or fixedMV
    diffusion and carries ``lls``.
    """
    if adaptive:
        return _solve_adaptive(prob, alg, u0s, ps, n_save=n_save,
                               abstol=abstol, reltol=reltol,
                               max_iters=max_iters, mesh=mesh)
    if alg.diffusionmodel == "dynamicMV":
        raise NotImplementedError(
            "dynamicMV is not on the fused kernels, as in the JAX package"
        )
    if alg.is_diagonal_ek1:
        if alg.smooth or getattr(prob, "second_order", False):
            raise NotImplementedError(
                "the fixed-grid DiagonalEK1 ensemble kernel is a first-order "
                "filter, as in the JAX package; pass smooth=False, or use "
                "adaptive=True for smoothing"
            )
        out = solve_ensemble_ek1d(
            prob.f, jac_diag_of(prob), u0s, ps, prob.tspan, n_save,
            q=alg.order, field=prob.field, prior=alg.prior, mesh=mesh,
            diffusion=alg.diffusionmodel,
        )
        if alg.diffusionmodel == "dynamic":
            return EnsembleKernelSolution(*out)
        us, stds, lls, sig = out
        return EnsembleKernelSolution(us, stds, lls, diffusions=sig)
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


def _solve_adaptive(prob, alg, u0s, ps, *, n_save, abstol, reltol, max_iters,
                    mesh) -> EnsembleKernelSolution:
    """The adaptive branch of `solve_ensemble` (EK0, DiagonalEK1, EK1)."""
    if getattr(prob, "mass_matrix", None) is not None:
        raise NotImplementedError(
            "mass-matrix problems are not on the port's fused kernels (the "
            "JAX package runs a diagonal mass on the adaptive DiagonalEK1 "
            "filter: ROADMAP.md queue 1, item 3)"
        )
    if alg.diffusionmodel != "dynamic":
        raise NotImplementedError(
            f"the fused adaptive kernels implement the dynamic diffusion "
            f"model; got {alg.diffusionmodel!r}: static models are per-lane "
            f"ill-posed under per-lane step control; use adaptive=False "
            f"(the fixed-grid kernels run fixed/fixedMAP/fixedMV)"
        )
    kw = dict(q=alg.order, abstol=abstol, reltol=reltol, prior=alg.prior,
              mesh=mesh, second_order=prob.second_order, field=prob.field)
    if alg.is_diagonal_ek1:
        if alg.smooth:
            out = solve_ensemble_ek1d_adaptive_smooth(
                prob.f, jac_diag_of(prob), u0s, ps, prob.tspan, n_save,
                max_iters=1024 if max_iters is None else max_iters, **kw)
        else:
            out = solve_ensemble_ek1d_adaptive(
                prob.f, jac_diag_of(prob), u0s, ps, prob.tspan, n_save,
                max_iters=100_000 if max_iters is None else max_iters, **kw)
        return EnsembleKernelSolution(*out)
    if alg.is_ek1:
        if alg.smooth:
            out = solve_ensemble_ek1_adaptive_smooth(
                prob.f, prob.jac, u0s, ps, prob.tspan, n_save,
                max_iters=512 if max_iters is None else max_iters, **kw)
        else:
            out = solve_ensemble_ek1_adaptive(
                prob.f, prob.jac, u0s, ps, prob.tspan, n_save,
                max_iters=100_000 if max_iters is None else max_iters, **kw)
        return EnsembleKernelSolution(*out)
    if alg.smooth:
        out = solve_ensemble_ek0_adaptive_smooth(
            prob.f, u0s, ps, prob.tspan, n_save,
            max_iters=1024 if max_iters is None else max_iters, **kw)
    else:
        out = solve_ensemble_ek0_adaptive(
            prob.f, u0s, ps, prob.tspan, n_save,
            max_iters=100_000 if max_iters is None else max_iters, **kw)
    return EnsembleKernelSolution(*out)


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
    abstol: float = 1e-6,
    reltol: float = 1e-3,
    max_iters: int = 1024,
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
    ``ps``: ``(B, n_params)``; any ``B >= 1``. The dynamic diffusion only,
    and ``alg.smooth`` must be set (a joint backward draw is a smoothing
    pass), as in the JAX package.

    ``adaptive=True`` (EK0 only, as in the JAX package): the adaptive EK0
    stream kernel at ``abstol`` / ``reltol`` with at most ``max_iters``
    attempts a member (which also sizes its stream and its normals) and the
    backward sampler over each member's accepted steps; ``n_steps`` is then
    the number of uniform save intervals, and the samples lie on that grid.
    ``generator`` takes the place of the JAX package's positional ``key``:
    the TPU's random bits do not carry over.
    """
    if getattr(prob, "mass_matrix", None) is not None:
        raise NotImplementedError(
            "mass-matrix problems are supported on the dense solver paths only"
        )
    if alg.diffusionmodel != "dynamic":
        raise NotImplementedError(
            "the fused sampler implements the dynamic diffusion model"
        )
    if alg.is_diagonal_ek1:
        raise NotImplementedError(
            "the fused sampler runs on the EK0 or EK1 kernel pairs, not on "
            "DiagonalEK1"
        )
    if not alg.smooth:
        raise ValueError("sampling not implemented for non-smoothed posteriors")
    if adaptive:
        if alg.is_ek1:
            raise NotImplementedError(
                "adaptive-solution sampling runs on the EK0 stream pair; use "
                "adaptive=False for EK1"
            )
        us, *_ = sample_ensemble_ek0_adaptive(
            prob.f, u0s, ps, prob.tspan, n_steps, generator, q=alg.order,
            n_samples=n_samples, abstol=abstol, reltol=reltol,
            max_iters=max_iters, prior=alg.prior, mesh=mesh,
            second_order=prob.second_order, field=prob.field)
        return us
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
    if alg.is_diagonal_ek1 or not alg.is_ek1:
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
