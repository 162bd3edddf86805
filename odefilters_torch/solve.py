"""Step-size heuristics of the adaptive solves (counterpart of
``odefilters/solve.py``).

Ported so far: `initial_dt`, the Hairer heuristic that picks each member's
first step size, batched over an ensemble. The sequential adaptive driver
is not ported yet (ROADMAP.md queue 1, slice 3).
"""

from __future__ import annotations

from typing import Callable

import torch


def initial_dt(f: Callable, u0s: torch.Tensor, ps: torch.Tensor, tspan,
               order: int, abstol: float, reltol: float) -> torch.Tensor:
    """Per-member initial step sizes ``(B,)`` (Hairer, OrdinaryDiffEq's
    ``ode_determine_initdt``) of a first-order problem ``u' = f(u, p, t)``.

    ``u0s``: ``(d, B)``; ``ps``: ``(n_params, B)``. The JAX package runs
    the same formula once per member under ``vmap``; here every member is
    a column, in the same order of operations (``hnorm(v)`` is
    ``sqrt(mean(v * v))`` over the state).
    """
    t0, t1 = (float(t) for t in tspan)
    tdir_span = t1 - t0
    d = u0s.shape[0]

    def hnorm(v):
        return torch.sqrt((v * v).sum(dim=0) / d)

    sc = abstol + torch.abs(u0s) * reltol
    d0 = hnorm(u0s / sc)
    t0_t = torch.tensor(t0, dtype=u0s.dtype, device=u0s.device)
    f0 = f(u0s, ps, t0_t)
    d1 = hnorm(f0 / sc)
    dt0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
    dt0 = torch.clamp(dt0, max=tdir_span)
    u1 = u0s + dt0 * f0
    f1 = f(u1, ps, t0_t + dt0)
    d2 = hnorm((f1 - f0) / sc) / dt0
    maxd = torch.maximum(d1, d2)
    dt1 = torch.where(
        maxd <= 1e-15,
        torch.clamp(dt0 * 1e-3, min=1e-6),
        # a true division: a Python number over a tensor is a reciprocal
        # times the number in PyTorch
        (torch.full_like(maxd, 0.01) / maxd) ** (1.0 / (order + 1)),
    )
    return torch.clamp(torch.minimum(100 * dt0, dt1), max=tdir_span)
