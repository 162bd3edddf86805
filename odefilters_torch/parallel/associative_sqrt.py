"""Square-root time-parallel Kalman filtering and smoothing (counterpart of
``odefilters/parallel/associative_sqrt.py``).

Filtering element ``(A, b, U, eta, Z)`` with ``C = U U^T`` and ``J = Z
Z^T``; smoothing element ``(E, g, P)`` with the covariance carried as the
factor P. Every combination is a QR (an unrolled modified Gram-Schmidt) of
stacked factors plus Woodbury solves against small triangular matrices:

    (I + C1 J2)^-1      = I - U1 (I + W W^T)^-1 W Z2^T,   W = U1^T Z2
    (I + C1 J2)^-1 C1   = V1 V1^T,   V1 = U1 Lw^-T,  Lw = chol(I + W W^T)
    (I + J2 C1)^-1 J2   = V2 V2^T,   V2 = Z2 Lv^-T,  Lv = chol(I + W^T W)

The scans run through `_scan`: ``block="fused"`` takes the three CUDA
kernels of ``ops/tp_scan.py`` (their plain versions on the CPU), any other
``block`` the XLA-form combines below under
`blocked.blocked_associative_scan` (None: the plain associative scan).
"""

from __future__ import annotations

import torch

from odefilters_torch.linalg import matmul_unrolled as _bmm
from odefilters_torch.linalg import solve_triangular_unrolled as solve_triangular
from odefilters_torch.linalg import tril_factor_mgs as tril_factor
from odefilters_torch.parallel.blocked import blocked_associative_scan


def _T(x):
    return x.transpose(-1, -2)


def _eye(D, like):
    return torch.eye(D, dtype=like.dtype, device=like.device)


def _chol_of_I_plus_MMt(M):
    """Triangular factor of ``I + M M^T`` via QR of ``[M^T ; I]``."""
    D = M.shape[-2]
    I = _eye(D, M).expand(*M.shape[:-2], D, D)
    return tril_factor(torch.cat([_T(M), I], dim=-2))


def _rsolve_lt(X, L):
    """``X @ L^-T`` for lower-triangular L (right triangular solve)."""
    return _T(solve_triangular(L, _T(X), lower=True))


def check_block(block):
    """Raise for a string ``block`` other than ``"fused"``, the port's name
    of the fused scan (the JAX package's ``"pallas"``)."""
    if isinstance(block, str) and block != "fused":
        raise ValueError(
            f"block={block!r}: the port's fused scan kernels are selected "
            "with block='fused' (the JAX package's 'pallas' / "
            "'pallas_interpret'); or pass None, 0 or a chunk length for the "
            "XLA-form scans"
        )


def _scan(kind, combine, elems, block, reverse=False):
    check_block(block)
    if block == "fused":
        from odefilters_torch.ops.tp_scan import fused_associative_scan

        return fused_associative_scan(kind, elems, reverse=reverse)
    return blocked_associative_scan(combine, elems, block or None,
                                    reverse=reverse)


# --------------------------------------------------------------------------
# Filtering
# --------------------------------------------------------------------------


def sqrt_filter_elements_rest(F, QL, H, y):
    """Generic square-root elements e_k (k >= 2), batched over time.

    With R = 0: ``S = (H QL)(H QL)^T``, ``K = Q H^T S^-1``, ``C = (I - K
    H) Q`` with exact factor ``(I - K H) QL``, ``Z = F^T H^T S_chol^-T``
    (rank d, zero-padded to D columns).
    """
    D = F.shape[-1]
    d = H.shape[-2]
    HQ = _bmm(H, QL)                          # (N, d, D)
    S_chol = tril_factor(_T(HQ))              # (N, d, d)
    QHt = _bmm(QL, _T(HQ))                    # (N, D, d)
    Kt = solve_triangular(
        _T(S_chol), solve_triangular(S_chol, _T(QHt), lower=True),
        lower=False,
    )                                         # (N, d, D) = K^T
    K = _T(Kt)
    IKH = _eye(D, F) - _bmm(K, H)
    A = _bmm(IKH, F)
    b = _bmm(K, y[..., None])[..., 0]
    U = _bmm(IKH, QL)
    FtHt = _bmm(_T(F), _T(H))                 # (N, D, d)
    Z_thin = _rsolve_lt(FtHt, S_chol)         # (N, D, d)
    eta = _bmm(Z_thin,
               solve_triangular(S_chol, y[..., None], lower=True))[..., 0]
    Z = torch.cat([Z_thin, Z_thin.new_zeros(Z_thin.shape[:-1] + (D - d,))],
                  dim=-1)
    return A, b, U, eta, Z


def sqrt_filter_element_first(m0, U0, F, QL, H, y):
    """First element: the prior through the transition, then a square-root
    update."""
    D = m0.shape[-1]
    m_pred = _bmm(F, m0[..., None])[..., 0]
    U_pred = tril_factor(torch.cat([_T(_bmm(F, U0)), _T(QL)], dim=-2))
    HU = _bmm(H, U_pred)
    S_chol = tril_factor(_T(HU))
    PHt = _bmm(U_pred, _T(HU))
    Kt = solve_triangular(
        _T(S_chol), solve_triangular(S_chol, _T(PHt), lower=True), lower=False
    )
    K = _T(Kt)
    A = m0.new_zeros((D, D))
    b = m_pred + _bmm(
        K, (y - _bmm(H, m_pred[..., None])[..., 0])[..., None])[..., 0]
    U = _bmm(_eye(D, m0) - _bmm(K, H), U_pred)   # exact Joseph factor (R=0)
    return A, b, U, torch.zeros_like(m0), m0.new_zeros((D, D))


def filter_elements(m0, U0, F, QL, H, ys):
    """The N filtering elements of ``m0, U0`` through N steps of ``(F,
    QL)`` (constant ``(D, D)`` or ``(N, D, D)``) measured by ``H`` ``(N, d,
    D)``, ``ys`` ``(N, d)``."""
    N = ys.shape[0]
    D = m0.shape[-1]
    F_ = F.expand(N, D, D)
    QL_ = QL.expand(N, D, D)
    e_rest = sqrt_filter_elements_rest(F_, QL_, H, ys)
    e1 = sqrt_filter_element_first(m0, U0, F_[0], QL_[0], H[0], ys[0])
    return tuple(torch.cat([a[None], rest[1:]], dim=0)
                 for a, rest in zip(e1, e_rest))


def _sqrt_filter_combine(ei, ej):
    """Square-root associative combination."""
    Ai, bi, Ui, etai, Zi = ei
    Aj, bj, Uj, etaj, Zj = ej
    D = Ai.shape[-1]
    W = _T(Ui) @ Zj                            # (..., D, D)
    Lw = _chol_of_I_plus_MMt(W)                # chol(I + W W^T)
    Lv = _chol_of_I_plus_MMt(_T(W))            # chol(I + W^T W)

    def Tmul(X):
        # (I + Ci Jj)^-1 X = X - Ui (Lw Lw^T)^-1 W (Zj^T X)
        ZtX = _T(Zj) @ X
        inner = solve_triangular(
            _T(Lw), solve_triangular(Lw, W @ ZtX, lower=True), lower=False
        )
        return X - Ui @ inner

    AjT = Aj @ Tmul(_eye(D, Ai).expand(Ai.shape))
    A = AjT @ Ai
    b = (AjT @ (bi[..., None] + Ui @ (_T(Ui) @ etaj[..., None])))[..., 0] + bj
    V1 = _rsolve_lt(Ui, Lw)                    # factor of (I+CiJj)^-1 Ci
    U = tril_factor(torch.cat([_T(Aj @ V1), _T(Uj)], dim=-2))
    # (I + Jj Ci)^-1 Jj = V2 V2^T with V2 = Zj Lv^-T; eta = Ai^T (I + Jj
    # Ci)^-1 (etaj - Jj bi) + etai
    V2 = _rsolve_lt(Zj, Lv)
    r = etaj[..., None] - Zj @ (_T(Zj) @ bi[..., None])
    UtR = _T(Ui) @ r
    inner = solve_triangular(
        _T(Lv), solve_triangular(Lv, _T(W) @ UtR, lower=True), lower=False
    )
    eta = (_T(Ai) @ (r - Zj @ inner))[..., 0] + etai
    Z = tril_factor(torch.cat([_T(_T(Ai) @ V2), _T(Zi)], dim=-2))
    return A, b, U, eta, Z


def parallel_filter_sqrt(m0, U0, F, QL, H, ys, block=None):
    """All-time filtered means and covariance factors, ``(ms, Us)`` with
    ``C_k = U_k U_k^T``, for the N post-transition states."""
    _, b, U, _, _ = _scan("filter", _sqrt_filter_combine,
                          filter_elements(m0, U0, F, QL, H, ys), block)
    return b, U


# --------------------------------------------------------------------------
# Smoothing
# --------------------------------------------------------------------------


def _sqrt_smooth_combine(suffix, elem):
    Ea, ga, Pa = suffix
    Eb, gb, Pb = elem
    E = Eb @ Ea
    g = gb + (Eb @ ga[..., None])[..., 0]
    P = tril_factor(torch.cat([_T(Pb), _T(Eb @ Pa)], dim=-2))
    return E, g, P


def smoother_gains(mf, Uf, F, QL):
    """The RTS gain elements ``(G, g, P)`` of the filtered states ``mf``
    ``(M, D)``, factors ``Uf`` toward the next state: predicted factor by
    QR, gain by two triangular solves, element covariance by the Joseph
    two-block QR ``[(I - G F) U_f | G QL]``."""
    M, D = mf.shape
    F_ = F.expand(M, D, D)
    QL_ = QL.expand(M, D, D)
    FUf = _bmm(F_, Uf)
    U_pred = tril_factor(torch.cat([_T(FUf), _T(QL_)], dim=-2))
    CFt = _bmm(Uf, _T(FUf))                   # G = C_f F^T Cp^-1
    Gt = solve_triangular(
        _T(U_pred), solve_triangular(U_pred, _T(CFt), lower=True),
        lower=False,
    )
    G = _T(Gt)
    g = mf - _bmm(G, _bmm(F_, mf[..., None]))[..., 0]
    P = tril_factor(torch.cat([_T(_bmm(_eye(D, mf) - _bmm(G, F_), Uf)),
                               _T(_bmm(G, QL_))], dim=-2))
    return G, g, P, U_pred


def smoother_elements(ms, Us, F, QL):
    """The N smoothing elements of the N filtered states ``ms``, ``Us``:
    the gains toward each next state, then the terminal element ``(0,
    m_N, U_N)``."""
    G, g, P, _ = smoother_gains(ms[:-1], Us[:-1], F, QL)
    return (torch.cat([G, G.new_zeros((1,) + G.shape[1:])], dim=0),
            torch.cat([g, ms[-1:]], dim=0), torch.cat([P, Us[-1:]], dim=0))


def parallel_smoother_sqrt(ms, Us, F, QL, block=None):
    """Smoothed means and covariance factors from the filtered ones, by the
    reverse scan of `smoother_elements`."""
    _, gr, Pr = _scan("smooth", _sqrt_smooth_combine,
                      smoother_elements(ms, Us, F, QL), block, reverse=True)
    return gr, Pr
