"""Unrolled small-matrix algebra on list blocks, shared by the plain
versions of every kernel module.

A block is a list of lists whose entries are per-member ``(B,)`` tensors
(or ``(S, B)`` for a sampler's draws) or Python floats. A Python ``0.0``
entry is a structural zero: every product and sum through it is skipped,
as the JAX package's ``_is0`` / ``_smul`` / ``_sreduce`` skip it at trace
time (``odefilters/ops/pallas_kernels.py``).
"""

from __future__ import annotations

import functools

import numpy as np


def _is0(x):
    """Structural zero: a Python float 0.0 entry in a list block."""
    return isinstance(x, (int, float)) and x == 0.0


def _smul(a, b):
    if _is0(a) or _is0(b):
        return 0.0
    if isinstance(a, float) and a == 1.0:
        return b
    if isinstance(b, float) and b == 1.0:
        return a
    return a * b


def _sreduce(terms):
    live = [t for t in terms if not _is0(t)]
    if not live:
        return 0.0
    return functools.reduce(lambda a, b: a + b, live)


def _lists(M) -> list[list[float]]:
    """A numpy constant matrix as nested Python floats (static entries)."""
    return [[float(x) for x in row] for row in np.asarray(M)]
