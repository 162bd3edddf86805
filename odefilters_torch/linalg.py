"""Small dense linear algebra on batched tensors (counterpart of part of
``odefilters/linalg.py``).

The time-parallel solves (``odefilters_torch.parallel``) build and combine
``(..., D, D)`` square-root elements at D = d (q+1) ~ 8. The JAX package
unrolls these small factorizations, substitutions and products into plain
vector arithmetic; the port keeps the same functions in the same order of
operations, on tensors with any leading batch dimensions:

======================================  ==================================
this module                             ``odefilters/linalg.py``
======================================  ==================================
``tril_factor_mgs``                     ``tril_factor_mgs``
``solve_triangular_unrolled``           ``solve_triangular_unrolled``
``matmul_unrolled``                     ``matmul_unrolled``
``cholesky_psd``                        ``cholesky_psd``
======================================  ==================================

The sums over a contracted index run in index order, as the JAX unrolled
forms do; XLA's own reductions (``jnp.sum``) and PyTorch's (``torch.sum``)
may reassociate, so the two packages agree to rounding, not bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

# matmul_unrolled unrolls products up to this size in every dimension
UNROLL_MAX = 16


def _T(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def tril_factor_mgs(stacked_T: torch.Tensor) -> torch.Tensor:
    """Lower ``L`` with ``L L^T = X^T X`` for ``X = stacked_T`` ``(..., K,
    D)``, non-negative diagonal, by an unrolled modified Gram-Schmidt over
    the D columns: each column is reduced by the earlier directions in turn;
    a column with no residual gets a zero diagonal and a zero direction."""
    D = stacked_T.shape[-1]
    qs, rows = [], []
    for j in range(D):
        v = stacked_T[..., :, j]
        lrow = []
        for qi in qs:
            r = torch.sum(qi * v, dim=-1)
            v = v - r[..., None] * qi
            lrow.append(r)
        nrm2 = torch.sum(v * v, dim=-1)
        pos = nrm2 > 0
        safe = torch.where(pos, nrm2, torch.ones_like(nrm2))
        nrm = torch.where(pos, torch.sqrt(safe), torch.zeros_like(nrm2))
        inv = torch.where(pos, 1.0 / torch.sqrt(safe), torch.zeros_like(nrm2))
        qs.append(v * inv[..., None])
        zero = torch.zeros_like(nrm)
        rows.append(torch.stack(lrow + [nrm] + [zero] * (D - j - 1), dim=-1))
    return torch.stack(rows, dim=-2)


def solve_triangular_unrolled(A: torch.Tensor, B: torch.Tensor, *,
                              lower: bool = True) -> torch.Tensor:
    """``A^{-1} B`` for triangular ``A`` ``(..., D, D)`` and ``B`` ``(...,
    D, M)`` by unrolled substitution."""
    D = A.shape[-1]
    order = range(D) if lower else range(D - 1, -1, -1)
    xs: dict[int, torch.Tensor] = {}
    for i in order:
        acc = B[..., i, :]
        for j, xj in xs.items():
            acc = acc - A[..., i, j, None] * xj
        xs[i] = acc / A[..., i, i, None]
    return torch.stack([xs[i] for i in range(D)], dim=-2)


def matmul_unrolled(a: torch.Tensor, b: torch.Tensor, *,
                    max_unroll: Optional[int] = UNROLL_MAX) -> torch.Tensor:
    """``a @ b`` with each entry summed over k in index order, ``a_0 b_0 +
    a_1 b_1 + ...``, leading dimensions broadcast (above ``max_unroll`` in
    any dimension, ``a @ b``; ``None``: unrolled at every size)."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if max_unroll is not None and max(m, k, n) > max_unroll:
        return a @ b
    s = a[..., :, 0:1] * b[..., 0:1, :]
    for kk in range(1, k):
        s.add_(a[..., :, kk:kk + 1] * b[..., kk:kk + 1, :])
    return s


def cholesky_psd(mat: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of a PSD (possibly rank-deficient) ``(..., d,
    d)`` matrix: ``eps trace / d`` added to the diagonal, then unrolled
    substitution with the pivots floored at a tiny normal (1e-30 in
    float32, 1e-60 in float64)."""
    eps = torch.finfo(mat.dtype).eps
    d = mat.shape[-1]
    jitter = eps * torch.diagonal(mat, dim1=-2, dim2=-1).sum(-1) / d
    mat = mat + jitter[..., None, None] * torch.eye(d, dtype=mat.dtype,
                                                    device=mat.device)
    tiny = 1e-30 if mat.dtype == torch.float32 else 1e-60
    L = [[None] * d for _ in range(d)]
    for i in range(d):
        for j in range(i + 1):
            s = mat[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=tiny))
            else:
                L[i][j] = s / L[j][j]
    zero = torch.zeros_like(mat[..., 0, 0])
    return torch.stack([torch.stack([L[i][j] if j <= i else zero
                                     for j in range(d)], dim=-1)
                        for i in range(d)], dim=-2)
