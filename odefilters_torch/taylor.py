"""Exact state initialization via Taylor-mode differentiation (counterpart
of ``odefilters/taylor.py``).

The solution's derivatives at ``t0`` come from the recursion
``F_{k+1}(x) = (dF_k/dx) g(x)`` on the autonomous system
``d/dt (u, t) = (f(u, p, t), 1)``, evaluated with nested
``torch.func.jvp``. An ensemble needs no ``vmap``: pass ``u0`` as
``(d, B)`` and ``p`` with a trailing batch axis, and every member's
derivatives come out as ``(d, B)``.

The JAX package switches to ``jax.experimental.jet`` above q = 5; torch has
no ``jet``, so q > 5 raises here (ROADMAP.md queue 1, slice 9).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import jvp


def taylor_coefficients(
    f: Callable, u0: torch.Tensor, p, t0, q: int
) -> list[torch.Tensor]:
    """Derivatives ``[u0, u'(t0), ..., u^(q)(t0)]``, each shaped like ``u0``."""
    if q > 5:
        raise NotImplementedError(
            "Taylor coefficients for q > 5 need the jet engine, which is not "
            "ported yet (ROADMAP.md queue 1, slice 9)"
        )
    t0 = torch.as_tensor(t0, dtype=u0.dtype, device=u0.device)

    def g(u, t):
        return f(u, p, t), torch.ones_like(t)

    derivs = [u0]
    Fk = g
    for _ in range(q):
        derivs.append(Fk(u0, t0)[0])
        Fk = lambda u, t, _F=Fk: jvp(_F, (u, t), g(u, t))[1]
    return derivs
