"""Problem types for the PyTorch port (counterpart of ``odefilters/problem.py``).

The vector field keeps the reference's calling convention ``f(u, p, t)``
and its index-and-stack style, so one callable works on a single state
``(d,)`` and on an ensemble laid out as ``(d, B)``.

Only first-order problems without a mass matrix are ported so far;
second-order problems and mass matrices raise ``NotImplementedError``
(ROADMAP.md queue 1, items 5, 3 and 11).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ODEProblem:
    """An initial value problem ``u' = f(u, p, t), u(t0) = u0``.

    Attributes:
        u0: initial value, a tensor of shape ``(d,)``.
        tspan: ``(t0, t1)``.
        p: parameters passed through to ``f`` (a tensor or None).
        f: vector field ``f(u, p, t) -> du`` on torch tensors.
        jac: optional Jacobian ``jac(u, p, t) -> (d, d)`` of ``f`` in ``u``,
            in the same index-and-stack style (``(d, d, B)`` on an ensemble);
            the EK1 plain versions derive it from JVP columns when absent.
            The EK1 kernels use the CUDA field's own Jacobian instead.
        jac_diag: optional Jacobian diagonal ``jac_diag(u, p, t) -> (d,)``
            (``(d, B)`` on an ensemble), which the DiagonalEK1 plain
            versions take first (then the diagonal of ``jac``, then d JVP
            columns). The DiagonalEK1 kernels use the CUDA field's own
            ``jac_diag`` instead.
        field: name of the vector field's CUDA implementation
            (``odefilters_torch/ops/csrc/fields.cuh``), which the fused
            kernels select by; None when the problem has none, and then
            only the plain PyTorch path can solve it.
        second_order, mass_matrix: kept for parity with the reference;
            anything but the defaults raises ``NotImplementedError``.
    """

    u0: torch.Tensor
    tspan: tuple
    p: Any = None
    f: Optional[Callable] = None
    jac: Optional[Callable] = None
    jac_diag: Optional[Callable] = None
    field: Optional[str] = None
    second_order: bool = False
    mass_matrix: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.second_order:
            raise NotImplementedError(
                "second-order problems are not ported yet "
                "(ROADMAP.md queue 1, item 5, 'Widen the pair')"
            )
        if self.mass_matrix is not None:
            raise NotImplementedError(
                "mass matrices are not ported yet (ROADMAP.md queue 1: item 3 "
                "for the adaptive DiagonalEK1 filter's diagonal mass, item 11 "
                "for the rest)"
            )
        if self.u0.ndim != 1:
            raise ValueError(
                "Problems which are not vector-valued (e.g. u0 is a scalar "
                "or a matrix) are currently not supported"
            )

    @property
    def d(self) -> int:
        """Dimension of the ODE state u."""
        return self.u0.shape[-1]

    @property
    def dtype(self) -> torch.dtype:
        return self.u0.dtype


def remake(prob: ODEProblem, **changes) -> ODEProblem:
    """Functional update, like SciML's ``remake``."""
    return dataclasses.replace(prob, **changes)


def resolve_device(device) -> torch.device:
    """The device a constructor builds on: the CUDA card unless the caller
    names another. Without a usable CUDA device a CUDA request raises; it
    never falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was requested (the default), but CUDA is "
            "not available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU"
        )
    return device


def ode_problem(f, u0, tspan, p=None, *, jac=None, jac_diag=None, field=None,
                mass_matrix=None, device="cuda", dtype=None) -> ODEProblem:
    """Convenience constructor: coerces ``u0`` and ``p`` to tensors on
    ``device`` (the CUDA card unless given; see `resolve_device`) in
    ``dtype`` (float64 unless given). ``jac_diag``: the exact Jacobian
    diagonal that `DiagonalEK1` uses (see `ODEProblem`)."""
    dtype = torch.float64 if dtype is None else dtype
    device = resolve_device(device)
    u0 = torch.as_tensor(u0, dtype=dtype, device=device)
    if p is not None:
        p = torch.as_tensor(p, dtype=dtype, device=device)
    return ODEProblem(u0=u0, tspan=tuple(float(t) for t in tspan), p=p, f=f,
                      jac=jac, jac_diag=jac_diag, field=field,
                      mass_matrix=mass_matrix)
