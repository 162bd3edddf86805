"""Problem arrays from numpy into the port's tensors.

The system has no weights: a problem's initial values, parameters and time
span are its inputs. These helpers build the port's problem and ensemble
tensors from numpy arrays (for instance the JAX package's arrays, as
numpy), so that both packages solve the same problem.
"""

from __future__ import annotations

import numpy as np
import torch

from odefilters_torch import models
from odefilters_torch.problem import ODEProblem, resolve_device

_MODELS = {"fitzhugh_nagumo": models.fitzhugh_nagumo}


def problem_from_numpy(model_name: str, u0, p, tspan, *, device="cuda",
                       dtype=torch.float64) -> ODEProblem:
    """The port's ``model_name`` problem with ``u0``, ``p`` and ``tspan``
    taken from numpy values, on ``device`` (the CUDA card unless given) in
    ``dtype``."""
    if model_name not in _MODELS:
        raise NotImplementedError(
            f"model {model_name!r} is not ported yet; ported: {sorted(_MODELS)}"
        )
    return _MODELS[model_name](
        u0=np.asarray(u0, dtype=np.float64), p=np.asarray(p, dtype=np.float64),
        tspan=tuple(float(t) for t in tspan), device=device, dtype=dtype,
    )


def ensemble_inputs_from_numpy(u0s, ps, *, device="cuda",
                               dtype=torch.float64):
    """``(u0s (B, d), ps (B, n_params))`` numpy arrays as contiguous tensors
    on ``device`` (the CUDA card unless given)."""
    device = resolve_device(device)
    return (
        torch.as_tensor(np.ascontiguousarray(u0s), dtype=dtype, device=device),
        torch.as_tensor(np.ascontiguousarray(ps), dtype=dtype, device=device),
    )
