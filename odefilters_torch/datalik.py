"""Data conditioning and the marginal data likelihood (counterpart of
``odefilters/datalik.py``).

Ported so far: `_merged_grid`, the host-side union of a uniform solve grid
with the observation times, which the fused data likelihood
(``ops/ek0_datalik.ensemble_data_loglik``) walks when observations lie off
the grid. The sequential ``filter_with_data`` and ``data_loglik`` run on
the sequential dense solver, which is not ported yet (ROADMAP.md queue 1,
item 8): they raise.
"""

from __future__ import annotations

import numpy as np
import torch

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _np_dtype(dtype) -> np.dtype:
    """A numpy dtype from a torch or numpy float dtype."""
    return np.dtype(_NP_DTYPES.get(dtype, dtype))


def _merged_grid(prob, ts_data, n_grid, dtype):
    """Host-side grid construction: a uniform ``n_grid + 1`` grid over
    ``prob.tspan``, unioned with the (concrete) observation times.

    Base points within a tolerance of an observation time are dropped
    before the merge: an interval of a few ULPs of the span would give a
    preconditioner ``h**(-q-1/2)`` that overflows. The tolerance and the
    rejection of observation times closer than 64 ULPs of the span follow
    ``dtype`` (a torch or numpy float dtype).

    Returns numpy ``(ts, is_data, row_of)``: the merged times in ``dtype``,
    a flag per grid point that an observation sits there, and the
    observation's row (0 where none)."""
    t0, t1 = float(prob.tspan[0]), float(prob.tspan[1])
    td = np.asarray(ts_data, dtype=np.float64)
    if td.ndim != 1 or np.any(np.diff(td) <= 0):
        raise ValueError("ts_data must be a strictly increasing 1-D array")
    if td[0] < t0 or td[-1] > t1:
        raise ValueError("ts_data must lie within prob.tspan")
    base = np.linspace(t0, t1, int(n_grid) + 1)
    eps_span = (t1 - t0) * float(np.finfo(_np_dtype(dtype)).eps)
    tol = max((t1 - t0) / (int(n_grid) + 1) * 1e-6, 64.0 * eps_span)
    if td.shape[0] > 1 and np.any(np.diff(td) < 64.0 * eps_span):
        raise ValueError(
            "consecutive ts_data values are closer than ~64 ULP of the "
            f"tspan in {_np_dtype(dtype).name}; merge the observations or "
            "solve in a wider dtype"
        )
    near = np.min(np.abs(base[:, None] - td[None, :]), axis=1) < tol
    near[0] = near[0] and td[0] - t0 < tol       # keep the endpoints unless
    near[-1] = near[-1] and t1 - td[-1] < tol    # a data time IS the endpoint
    ts = np.union1d(base[~near], td)
    idx = np.searchsorted(ts, td)
    assert np.array_equal(ts[idx], td)
    is_data = np.zeros(ts.shape[0], dtype=bool)
    is_data[idx] = True
    row_of = np.zeros(ts.shape[0], dtype=np.int32)
    row_of[idx] = np.arange(td.shape[0], dtype=np.int32)
    return ts.astype(_np_dtype(dtype)), is_data, row_of


def _sequential_solver_missing(name: str):
    raise NotImplementedError(
        f"{name} runs on the sequential dense solver, which is not ported "
        "yet (ROADMAP.md queue 1, item 8); for an ensemble of candidates use "
        "odefilters_torch.ensemble_data_loglik"
    )


def filter_with_data(*args, **kwargs):
    """The data-conditioned filter of the sequential solver: not ported yet
    (ROADMAP.md queue 1, item 8)."""
    _sequential_solver_missing("filter_with_data")


def data_loglik(*args, **kwargs):
    """The sequential solver's marginal data log-likelihood: not ported yet
    (ROADMAP.md queue 1, item 8)."""
    _sequential_solver_missing("data_loglik")
