"""Jacobian utilities (counterpart of part of ``odefilters/jacobians.py``)."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from odefilters_torch.ops.ek1_fused import auto_jac


def _diagonal(J: torch.Tensor) -> torch.Tensor:
    """The diagonal of a ``(d, d)`` or ``(d, d, B)`` Jacobian, ``(d,)`` or
    ``(d, B)``."""
    return torch.diagonal(J, dim1=0, dim2=1).movedim(-1, 0)


def resolve_jac_diag(f: Callable, jac: Optional[Callable] = None,
                     jac_diag: Optional[Callable] = None) -> Callable:
    """``(u, p, t) -> (d,)`` (or ``(d, B)``) Jacobian diagonal for
    `odefilters_torch.algorithms.DiagonalEK1`: an exact ``jac_diag`` if
    given, else the diagonal of ``jac``, else the diagonal of the Jacobian
    from d forward-mode JVP columns."""
    if jac_diag is not None:
        return jac_diag
    full = jac if jac is not None else auto_jac(f)
    return lambda u, p, t: _diagonal(full(u, p, t))
