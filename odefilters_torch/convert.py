"""Problem arrays from numpy into the port's tensors.

The system has no weights: a problem's initial values, parameters and time
span are its inputs, and a sampler's standard normals are its noise. These
helpers build the port's problem, ensemble, normals and state-stream
tensors from numpy arrays (for instance the JAX package's arrays, as
numpy), so that both packages solve the same problem.
"""

from __future__ import annotations

import numpy as np
import torch

from odefilters_torch import models
from odefilters_torch.ops import ek1_datalik
from odefilters_torch.ops.ek0_datalik_pd import pd_layout
from odefilters_torch.problem import ODEProblem, resolve_device

_MODELS = {"fitzhugh_nagumo": models.fitzhugh_nagumo,
           "lotka_volterra": models.lotka_volterra}


def problem_from_numpy(model_name: str, u0, p, tspan, *, device="cuda",
                       dtype=torch.float64) -> ODEProblem:
    """The port's ``model_name`` problem with ``u0``, ``p`` and ``tspan``
    taken from numpy values, on ``device`` (the CUDA card unless given) in
    ``dtype``. ``"brusselator_2d"`` takes the flat ``(2 N^2,)`` initial
    state, N inferred from it, and the diffusivity ``alpha`` as ``p``."""
    if model_name == "brusselator_2d":
        u0 = np.asarray(u0, dtype=np.float64)
        N = int(round((u0.size / 2) ** 0.5))
        if u0.shape != (2 * N * N,):
            raise ValueError(
                f"brusselator_2d takes a flat u0 of 2 N^2 values, got {u0.shape}"
            )
        return models.brusselator_2d(
            N=N, tspan=tuple(float(t) for t in tspan), alpha=float(p), u0=u0,
            device=device, dtype=dtype)
    if model_name not in _MODELS:
        raise NotImplementedError(
            f"model {model_name!r} is not ported yet; ported: "
            f"{sorted(_MODELS) + ['brusselator_2d']}"
        )
    return _MODELS[model_name](
        u0=np.asarray(u0, dtype=np.float64), p=np.asarray(p, dtype=np.float64),
        tspan=tuple(float(t) for t in tspan), device=device, dtype=dtype,
    )


def grid_init_from_numpy(m0, *, device="cuda", dtype=torch.float64):
    """A Kron-grid solve's Taylor init, the ``(q+1, ns, N, M)`` numpy array
    of derivative grids (the JAX package's ``m0`` of
    ``ek0_kron_grid_solve``), as a contiguous tensor on ``device`` (the CUDA
    card unless given)."""
    m0 = np.asarray(m0)
    if m0.ndim != 4 or min(m0.shape) < 1 or m0.shape[0] < 2:
        raise ValueError(
            f"a grid init must be (q+1, ns, N, M) with q >= 1, got {m0.shape}"
        )
    return torch.as_tensor(np.ascontiguousarray(m0), dtype=dtype,
                           device=resolve_device(device))


def ensemble_inputs_from_numpy(u0s, ps, *, device="cuda",
                               dtype=torch.float64):
    """``(u0s (B, d), ps (B, n_params))`` numpy arrays as contiguous tensors
    on ``device`` (the CUDA card unless given)."""
    device = resolve_device(device)
    return (
        torch.as_tensor(np.ascontiguousarray(u0s), dtype=dtype, device=device),
        torch.as_tensor(np.ascontiguousarray(ps), dtype=dtype, device=device),
    )


def normals_from_numpy(z, *, device="cuda", dtype=torch.float64):
    """A sampler's standard normals, a ``(T+1, S, nq, d, B)`` numpy array
    (the layout of the JAX package's ``ek0_fused_sample``; the adaptive
    sampler's ``(max_iters, S, nq, d, B)``), as a contiguous tensor on
    ``device`` (the CUDA card unless given)."""
    z = np.asarray(z)
    if z.ndim != 5:
        raise ValueError(f"normals must be (T+1, S, nq, d, B), got {z.shape}")
    return torch.as_tensor(np.ascontiguousarray(z), dtype=dtype,
                           device=resolve_device(device))


def state_stream_from_numpy(st, *, nq: int, d: int, device="cuda",
                            dtype=torch.float64):
    """The JAX package's ``ek0_filter_state_stream`` output as numpy,
    ``(nb, T+1, nq, d+nq+1, 8, 128)`` rows ``[mean | factor | s2 in row
    0]``, reordered into the port's filter-states stream ``(T+1, V, B)``
    rows ``[mean (nq*d) | factor (nq*nq, row-major) | s2]`` (member
    ``blk*1024 + sub*128 + lane``), on ``device`` (the CUDA card unless
    given)."""
    st = np.asarray(st)
    if st.ndim != 6 or st.shape[2:4] != (nq, d + nq + 1):
        raise ValueError(
            f"expected a (nb, T+1, {nq}, {d + nq + 1}, sub, lane) stream, got "
            f"{st.shape}"
        )
    nb, T1, _, W, sub, lane = st.shape
    x = st.transpose(1, 2, 3, 0, 4, 5).reshape(T1, nq, W, nb * sub * lane)
    rows = np.concatenate([
        x[:, :, :d].reshape(T1, nq * d, -1),
        x[:, :, d:d + nq].reshape(T1, nq * nq, -1),
        x[:, :1, d + nq],
    ], axis=1)
    return torch.as_tensor(np.ascontiguousarray(rows), dtype=dtype,
                           device=resolve_device(device))


def pd_stream_from_numpy(st, *, nq: int, d: int, device="cuda",
                        dtype=torch.float64):
    """The JAX package's per-dimension data-likelihood stream (the residual
    of ``_ek0_datalik_pd_vjp_fwd``) as numpy, ``(nb, T, nq, W, 8, 128)``
    with ``W = d + d nq`` and derivative row i ``[m[i] (d) | C_0[i] (nq) |
    ... | C_{d-1}[i] (nq)]``, reordered into the port's stream ``(T, V, B)``
    (``ops.ek0_datalik_pd.pd_layout``: the rows i one after the other,
    ``V = nq W``; member ``blk*1024 + sub*128 + lane``), on ``device`` (the
    CUDA card unless given)."""
    st = np.asarray(st)
    W, V = pd_layout(nq, d)
    if st.ndim != 6 or st.shape[2:4] != (nq, W):
        raise ValueError(
            f"expected a (nb, T, {nq}, {W}, sub, lane) stream, got {st.shape}"
        )
    nb, T, _, _, sub, lane = st.shape
    x = st.transpose(1, 2, 3, 0, 4, 5).reshape(T, V, nb * sub * lane)
    return torch.tensor(x, dtype=dtype, device=resolve_device(device))


def ek1_normals_from_numpy(z, *, device="cuda", dtype=torch.float64):
    """The EK1 sampler's standard normals, a ``(T+1, S, D, B)`` numpy array
    (the layout of the JAX package's ``ek1_fused_sample``, D = d(q+1)), as
    a contiguous tensor on ``device`` (the CUDA card unless given)."""
    z = np.asarray(z)
    if z.ndim != 4:
        raise ValueError(f"EK1 normals must be (T+1, S, D, B), got {z.shape}")
    return torch.as_tensor(np.ascontiguousarray(z), dtype=dtype,
                           device=resolve_device(device))


def ek1_stream_from_numpy(st, *, nq: int, d: int, device="cuda",
                          dtype=torch.float64):
    """The JAX package's EK1 filter stream (``ek1_fused_solve(...,
    _debug=True)``) as numpy, ``(nb, T+1, D, W, 8, 128)`` with row r
    ``[L row r (D) | m[r] | s2 (row 0 only) | tril(Lp) row r (W = 2D+2
    only)]``, reordered into the port's stream ``(T+1, V, B)`` rows
    ``[m (D) | L (D*D, row-major) | s2 | tril(Lp) row by row]``
    (``ops.ek1_fused.stream_layout``; member ``blk*1024 + sub*128 +
    lane``), on ``device`` (the CUDA card unless given)."""
    st = np.asarray(st)
    D = d * nq
    if st.ndim != 6 or st.shape[2] != D or st.shape[3] not in (D + 2,
                                                              2 * D + 2):
        raise ValueError(
            f"expected a (nb, T+1, {D}, {D + 2} or {2 * D + 2}, sub, lane) "
            f"EK1 stream, got {st.shape}"
        )
    nb, T1, _, W, sub, lane = st.shape
    x = st.transpose(1, 2, 3, 0, 4, 5).reshape(T1, D, W, nb * sub * lane)
    parts = [x[:, :, D], x[:, :, :D].reshape(T1, D * D, -1), x[:, :1, D + 1]]
    if W == 2 * D + 2:
        parts.append(np.stack([x[:, r, D + 2 + c] for r in range(D)
                               for c in range(r + 1)], axis=1))
    return torch.as_tensor(np.ascontiguousarray(np.concatenate(parts, axis=1)),
                           dtype=dtype, device=resolve_device(device))


def ek1_datalik_stream_from_numpy(st, *, nq: int, d: int, device="cuda",
                                  dtype=torch.float64):
    """The JAX package's dense EK1 data-likelihood stream (the residual of
    ``_ek1_datalik_vjp_fwd``) as numpy, ``(nb, T, D, D+1, 8, 128)`` with
    row r ``[L[r] (D) | m[r]]``, D = d nq, reordered into the port's
    stream ``(T, V, B)`` (``ops.ek1_datalik.pack_state``: ``[m (D) | L
    (D*D, row-major)]``; member ``blk*1024 + sub*128 + lane``), on
    ``device`` (the CUDA card unless given)."""
    st = np.asarray(st)
    D = d * nq
    if st.ndim != 6 or st.shape[2:4] != (D, D + 1):
        raise ValueError(
            f"expected a (nb, T, {D}, {D + 1}, sub, lane) EK1 data-likelihood "
            f"stream, got {st.shape}"
        )
    nb, T, _, _, sub, lane = st.shape
    x = st.transpose(1, 2, 3, 0, 4, 5).reshape(T, D, D + 1, nb * sub * lane)
    rows = ek1_datalik.pack_state([x[:, r, D] for r in range(D)],
                                  [[x[:, r, c] for c in range(D)]
                                   for r in range(D)])
    return torch.tensor(np.stack(rows, axis=1), dtype=dtype,
                        device=resolve_device(device))


def scan_elements_from_numpy(elems, *, device="cuda", dtype=torch.float64):
    """A time-parallel scan's elements, the JAX package's tuple of numpy
    leaves batched on axis 0 (``(N, D, D)`` / ``(N, D)``: the filter's ``(A,
    b, U, eta, Z)`` or the smoother's ``(E, g, P)``), as a tuple of
    contiguous tensors on ``device`` (the CUDA card unless given)."""
    leaves = tuple(np.asarray(e) for e in elems)
    if len(leaves) not in (3, 5):
        raise ValueError(
            f"expected the 5 filter or 3 smoother leaves, got {len(leaves)}")
    N, D = leaves[0].shape[0], leaves[0].shape[-1]
    for e in leaves:
        if e.shape not in ((N, D, D), (N, D)):
            raise ValueError(
                f"leaves must be (N, D, D) or (N, D) with N = {N}, D = {D}; "
                f"got {e.shape}")
    device = resolve_device(device)
    return tuple(torch.as_tensor(np.ascontiguousarray(e), dtype=dtype,
                                 device=device) for e in leaves)


def trajectory_from_numpy(u_init, *, device="cuda", dtype=torch.float64):
    """A time-parallel solve's linearization trajectory (the JAX package's
    warm start ``u_init``, ``(N, d)`` at the grid's N points after t0) as a
    contiguous tensor on ``device`` (the CUDA card unless given)."""
    u_init = np.asarray(u_init)
    if u_init.ndim != 2:
        raise ValueError(f"a trajectory must be (N, d), got {u_init.shape}")
    return torch.as_tensor(np.ascontiguousarray(u_init), dtype=dtype,
                           device=resolve_device(device))
