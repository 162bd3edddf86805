"""Gauss-Markov prior constants for the PyTorch port (counterpart of
``odefilters/priors.py``).

The preconditioned q-times integrated Brownian motion (IBM / IWP) blocks
are solver constants: built host-side in float64 numpy from exact
rational arithmetic, with no framework in the loop, so the port's kernels
and the JAX package's kernels bake in bit-identical numbers;
`transition_precond_full` and `precond_full` give the full ``(D, D)`` forms
that the time-parallel solves use. IOUP and Matern priors are not ported yet (ROADMAP.md queue 1, item 5,
"Widen the pair"), nor matrix-rate ones (item 11).
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


def precond_full(h: float, d: int, q: int) -> tuple[np.ndarray, np.ndarray]:
    """Length-D diagonal preconditioner and its inverse, each block entry
    repeated d times (derivative-major), as float64 numpy arrays."""
    p, p_inv = precond_small(h, q)
    return np.repeat(p, d), np.repeat(p_inv, d)


def transition_precond_full(prior, d: int,
                            q: int) -> tuple[np.ndarray, np.ndarray]:
    """Full ``(D, D)`` preconditioned transition ``A`` and its noise factor
    ``QL`` (``Q = QL QL^T``) as float64 numpy arrays: the IBM blocks of
    `_ibm_small_np` as Kronecker products with I_d, the same at every step
    size. Other priors raise."""
    if prior is not None:
        if getattr(prior, "rate_is_matrix", False) or getattr(
                prior, "rate_is_jacobian", False):
            raise NotImplementedError(
                "matrix-rate priors (ExpEK, RosenbrockExpEK) are not ported "
                "yet (ROADMAP.md queue 1, item 11)"
            )
        raise NotImplementedError(
            "IOUP / Matern priors are not ported yet "
            "(ROADMAP.md queue 1, item 5, 'Widen the pair')"
        )
    A, _, L = _ibm_small_np(q)
    eye = np.eye(d)
    return np.kron(A, eye), np.kron(L, eye)
