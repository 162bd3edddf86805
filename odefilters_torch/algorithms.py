"""Solver configurations for the PyTorch port (counterpart of
``odefilters/algorithms.py``).

Frozen dataclasses validated as the JAX package validates them. The fused
ensemble solves run ``EK0``, ``EK1`` and ``DiagonalEK1`` (and ``IEKS``
through ``ieks_ensemble``); the sequential dense solver is not ported yet
(ROADMAP.md queue 1, slice 3).
"""

from __future__ import annotations

import dataclasses

DIFFUSION_MODELS = ("dynamic", "dynamicMV", "fixed", "fixedMV", "fixedMAP")
MV_DIFFUSIONS = ("dynamicMV", "fixedMV")


@dataclasses.dataclass(frozen=True)
class AbstractEK:
    """Shared configuration of the Gaussian ODE filters.

    The fields are in the JAX package's order, ``(prior, order,
    diffusionmodel, smooth)``, so positional constructions mean the same in
    both: ``EK0("ibm", 3)`` is order 3, and ``EK0(3)`` raises.

    ``prior``: None or ``"ibm"`` (the q-times integrated Wiener process,
    normalized to None); IOUP / Matern priors are not ported yet, and a
    solve given another prior raises ``NotImplementedError``.
    """

    prior: object = None
    order: int = 3
    diffusionmodel: str = "dynamic"
    smooth: bool = True

    def __post_init__(self):
        if self.prior == "ibm":
            object.__setattr__(self, "prior", None)
        elif isinstance(self.prior, (bool, int, float)):
            # as the JAX package's normalize_prior: EK0(3) is an error
            raise TypeError(
                f"prior must be a string or a prior object, got {self.prior!r}"
            )
        if self.diffusionmodel not in DIFFUSION_MODELS:
            raise ValueError(
                f"diffusionmodel must be one of {DIFFUSION_MODELS}, "
                f"got {self.diffusionmodel!r}"
            )
        if self.order < 1:
            raise ValueError("order must be >= 1")

    @property
    def is_ek1(self) -> bool:
        return False

    @property
    def is_diagonal_ek1(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class EK0(AbstractEK):
    """Gaussian ODE filtering with zeroth-order linearization (H = E1 P^-1)."""


@dataclasses.dataclass(frozen=True)
class EK1(AbstractEK):
    """Gaussian ODE filtering with first-order (extended Kalman) linearization."""

    def __post_init__(self):
        super().__post_init__()
        if self.diffusionmodel in MV_DIFFUSIONS:
            raise ValueError("MV diffusion models require the EK0 algorithm")

    @property
    def is_ek1(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class DiagonalEK1(EK1):
    """EK1 with a diagonal first-order linearization, ``J -> diag(J)``
    (Kraemer, Bosch, Schmidt, Hennig, ICML 2022): the measurement
    ``H = (E1 - diag(J) E0) P^-1`` couples each dimension only to itself,
    so every dimension runs its own ``(q+1) x (q+1)`` filter. The Jacobian
    diagonal comes from ``prob.jac_diag``, else the diagonal of
    ``prob.jac``, else d forward-mode JVPs. The MV diffusions are allowed:
    the per-dimension structure is kept, as in the JAX package."""

    def __post_init__(self):
        # skip EK1's MV rejection; run AbstractEK's validation only
        AbstractEK.__post_init__(self)

    @property
    def is_diagonal_ek1(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class IEKS(EK1):
    """Iterated extended Kalman smoothing: each outer iteration re-solves
    with the EK1 linearized at the previous smoothed mean
    (``odefilters_torch.ieks_ensemble``). ``smooth`` is forced True."""

    order: int = 1
    smooth: bool = True

    def __post_init__(self):
        super().__post_init__()
        if not self.smooth:
            raise ValueError("IEKS requires smooth=True")
