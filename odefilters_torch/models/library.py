"""Canonical problems for the PyTorch port (counterpart of
``odefilters/models/library.py``).

Vector fields are written in the same index-and-stack style as the JAX
package's, so they evaluate on ``(d,)`` and on ``(d, B)`` alike. A model
with a CUDA implementation names it in ``ODEProblem.field``.
"""

from __future__ import annotations

import torch

from odefilters_torch.problem import ODEProblem, ode_problem


def fitzhugh_nagumo_f(u, p, t):
    """FitzHugh-Nagumo vector field; ``p = (a, b, 1/tau, I0)``.

    ``v * (v * v)`` is the order in which JAX expands ``v**3``, so the two
    packages agree to the last bit; the CUDA field (``Fhn`` in
    ``ops/csrc/fields.cuh``) uses the same order.
    """
    a, b, tinv, izero = p
    v, w = u[0], u[1]
    dv = v - v * (v * v) / 3 - w + izero
    dw = tinv * (v + a - b * w)
    return torch.stack([dv, dw])


def fitzhugh_nagumo_jac(u, p, t):
    """Jacobian of `fitzhugh_nagumo_f` in ``u``, ``(d, d)`` or ``(d, d, B)``,
    built with stack and broadcast like the JAX package's (``v**2`` as
    ``v * v``); the CUDA field's ``jac`` uses the same order."""
    a, b, tinv, izero = p
    v = u[0]
    o = torch.ones_like(v)
    return torch.stack([
        torch.stack([1 - v * v, -o]),
        torch.stack([tinv * o, -tinv * b * o]),
    ])


def fitzhugh_nagumo(
    u0=(-1.0, 1.0), p=(0.7, 0.8, 1 / 12.5, 0.5), tspan=(0.0, 20.0), *,
    device="cuda", dtype=None,
) -> ODEProblem:
    """FitzHugh-Nagumo neuron model, as ``odefilters.models.fitzhugh_nagumo``,
    on the CUDA card unless ``device`` names another."""
    return ode_problem(fitzhugh_nagumo_f, u0, tspan, p=p,
                       jac=fitzhugh_nagumo_jac, field="fhn", device=device,
                       dtype=dtype)


def lotka_volterra_f(u, p, t):
    """Lotka-Volterra vector field; ``p = (a, b, c, d)``, in the JAX
    package's order of operations (``b * x * y`` is ``(b * x) * y``); the
    CUDA field (``LotkaVolterra`` in ``ops/csrc/fields.cuh``) uses the same
    order."""
    a, b, c, d = p
    x, y = u[0], u[1]
    return torch.stack([a * x - b * x * y, -c * y + d * x * y])


def lotka_volterra_jac(u, p, t):
    """Jacobian of `lotka_volterra_f` in ``u``, ``(d, d)`` or ``(d, d, B)``;
    the CUDA field's ``jac`` uses the same order."""
    a, b, c, d = p
    x, y = u[0], u[1]
    return torch.stack([
        torch.stack([a - b * y, -b * x]),
        torch.stack([d * y, -c + d * x]),
    ])


def lotka_volterra(
    u0=(1.0, 1.0), p=(1.5, 1.0, 3.0, 1.0), tspan=(0.0, 7.0), *,
    device="cuda", dtype=None,
) -> ODEProblem:
    """Lotka-Volterra predator-prey, as ``odefilters.models.lotka_volterra``,
    on the CUDA card unless ``device`` names another."""
    return ode_problem(lotka_volterra_f, u0, tspan, p=p,
                       jac=lotka_volterra_jac, field="lv", device=device,
                       dtype=dtype)
