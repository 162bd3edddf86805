"""Gauss-Markov prior constants for the PyTorch port (counterpart of
``odefilters/priors.py``).

The preconditioned q-times integrated Brownian motion (IBM / IWP) blocks
are solver constants: built host-side in float64 numpy from exact
rational arithmetic, with no framework in the loop, so the port's kernels
and the JAX package's kernels bake in bit-identical numbers. IOUP and
Matern priors are not ported yet (ROADMAP.md queue 1, item 5, "Widen the
pair").
"""

from __future__ import annotations

from fractions import Fraction
from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def _ibm_small_np(q: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact preconditioned (q+1)x(q+1) IBM blocks in float64.

    Returns ``(Atil, Qtil, Qtil_chol)`` with ``Atil[j, k] = 1/(k-j)!`` for
    ``k >= j`` and ``Qtil[row, col] = 1 / ((2q+1-row-col) (q-row)! (q-col)!)``;
    the Cholesky factor is computed on the exact rationals and only its
    pivots' square roots are taken in float.
    """
    n = q + 1
    fact = [1] * (n + 1)
    for i in range(1, n + 1):
        fact[i] = fact[i - 1] * i

    A = np.zeros((n, n))
    for j in range(n):
        for k in range(j, n):
            A[j, k] = float(Fraction(1, fact[k - j]))

    Qf = [[Fraction(0)] * n for _ in range(n)]
    for row in range(n):
        for col in range(n):
            idx = 2 * q + 1 - row - col
            Qf[row][col] = Fraction(1, idx * fact[q - row] * fact[q - col])
    Q = np.array([[float(x) for x in r] for r in Qf])

    Lf = [[Fraction(0)] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = sum(Lf[i][k] * Lf[j][k] for k in range(j))
            if i == j:
                Lf[i][j] = Fraction(float(Qf[i][i] - s) ** 0.5)
            else:
                Lf[i][j] = (Qf[i][j] - s) / Lf[j][j]
    L = np.array([[float(x) for x in r] for r in Lf])
    return A, Q, L


def precond_small(h: float, q: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-derivative-block preconditioner ``p[j] = h^(j - q - 1/2)`` for
    j = 0..q and its inverse, as float64 numpy arrays."""
    j = np.arange(q + 1, dtype=np.float64)
    p = float(h) ** (j - q - 0.5)
    return p, 1.0 / p
