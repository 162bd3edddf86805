"""Canonical problems for the PyTorch port (counterpart of
``odefilters/models/library.py``).

Vector fields are written in the same index-and-stack style as the JAX
package's, so they evaluate on ``(d,)`` and on ``(d, B)`` alike. A model
with a CUDA implementation names it in ``ODEProblem.field``.
"""

from __future__ import annotations

import numpy as np
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


BRUSSELATOR_A, BRUSSELATOR_B = 3.4, 1.0


def brusselator_2d_f_grids(N: int, alpha=None):
    """Grid-form Brusselator vector field ``[a, b] -> [da, db]`` on ``(N, N)``
    tensors: the stencil shared by the flat `brusselator_2d` and the
    Kron-grid solves (``ops/kron_grid.py``), as the JAX package's.

    The Laplacian is periodic (``torch.roll`` wraps, as ``jnp.roll``), yet
    scaled by ``(N-1)^2``; the sum runs in the JAX order, ``(((x[i-1] +
    x[i+1]) + x[j-1]) + x[j+1]) - 4x``, and ``a * a * b`` is ``(a a) b``.
    The CUDA stencil (``BrusselatorGrid`` in ``ops/csrc/kron_grid.cuh``)
    uses the same order. ``alpha``: a Python float folded into the stencil
    (the Kron-grid solves); None reads the diffusivity from ``p``.
    """
    A_, B_ = BRUSSELATOR_A, BRUSSELATOR_B
    scale = float((N - 1) ** 2)

    def f_grids(fields, p, t):
        a, b = fields
        al = float(alpha) if alpha is not None else p

        def lap(x):
            return (
                torch.roll(x, 1, 0) + torch.roll(x, -1, 0)
                + torch.roll(x, 1, 1) + torch.roll(x, -1, 1)
                - 4.0 * x
            ) * scale

        da = B_ + a * a * b - (A_ + 1.0) * a + al * lap(a)
        db = A_ * a - a * a * b + al * lap(b)
        return [da, db]

    return f_grids


def brusselator_2d_jd_grids(N: int, alpha=None):
    """Per-point Jacobian diagonal of the Brusselator stencil (DiagonalEK1):
    ``2ab - (A+1) - 4 alpha scale`` and ``-a^2 - 4 alpha scale``, reading
    only the point's own values."""
    A_ = BRUSSELATOR_A
    scale = float((N - 1) ** 2)

    def jd_grids(fields, p, t):
        a, b = fields
        al = float(alpha) if alpha is not None else p
        lap_diag = -4.0 * al * scale
        return [2.0 * a * b - (A_ + 1.0) + lap_diag, -a * a + lap_diag]

    return jd_grids


def brusselator_2d_u0(N: int) -> np.ndarray:
    """The initial state of `brusselator_2d`, ``(2 N^2,)`` float64 numpy:
    ``a0 = 22 (y (1-y))^1.5``, ``b0 = 27 (x (1-x))^1.5`` on ``linspace(0,
    1, N)`` (numpy's grid equals the JAX package's to the bit; its ``**``
    may differ in the last bit)."""
    x = np.linspace(0.0, 1.0, N)
    X, Y = np.meshgrid(x, x, indexing="ij")
    a0 = 22.0 * (Y * (1 - Y)) ** 1.5
    b0 = 27.0 * (X * (1 - X)) ** 1.5
    return np.concatenate([a0.ravel(), b0.ravel()])


def brusselator_2d(
    N: int = 16, tspan=(0.0, 1.0), alpha: float = 0.1, *, u0=None,
    device="cuda", dtype=None,
) -> ODEProblem:
    """2-D Brusselator reaction-diffusion on an N x N periodic grid, d = 2 N^2
    states, as ``odefilters.models.brusselator_2d``, on the CUDA card unless
    ``device`` names another. ``p`` is the diffusivity ``alpha``; ``u0``
    (flat, ``(2 N^2,)``) replaces `brusselator_2d_u0`. Its CUDA form is the
    grid stencil of the Kron-grid kernels (``field="brusselator_2d"``)."""
    f_grids = brusselator_2d_f_grids(N)
    jd_grids = brusselator_2d_jd_grids(N)

    def f(u, p, t):
        a = u[: N * N].reshape(N, N)
        b = u[N * N:].reshape(N, N)
        da, db = f_grids([a, b], p, t)
        return torch.cat([da.reshape(-1), db.reshape(-1)])

    def jac_diag(u, p, t):
        a = u[: N * N].reshape(N, N)
        b = u[N * N:].reshape(N, N)
        ja, jb = jd_grids([a, b], p, t)
        return torch.cat([ja.reshape(-1), jb.reshape(-1)])

    u0 = brusselator_2d_u0(N) if u0 is None else np.asarray(u0, np.float64)
    if u0.shape != (2 * N * N,):
        raise ValueError(f"u0 must be (2 N^2,) = ({2 * N * N},), got {u0.shape}")
    return ode_problem(f, u0, tspan, p=alpha, jac_diag=jac_diag,
                       field="brusselator_2d", device=device, dtype=dtype)
