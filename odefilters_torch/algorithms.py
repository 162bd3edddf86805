"""Solver configurations for the PyTorch port (counterpart of
``odefilters/algorithms.py``).

Frozen dataclasses validated as the JAX package validates them. The fused
fixed-grid ensemble solves run ``EK0`` and ``EK1`` (and ``IEKS`` through
``ieks_ensemble``); the sequential dense solver is not ported yet
(ROADMAP.md queue 1, slice 3).
"""

from __future__ import annotations

import dataclasses

DIFFUSION_MODELS = ("dynamic", "dynamicMV", "fixed", "fixedMV", "fixedMAP")
MV_DIFFUSIONS = ("dynamicMV", "fixedMV")


@dataclasses.dataclass(frozen=True)
class AbstractEK:
    """Shared configuration of the Gaussian ODE filters.

    ``prior``: None or ``"ibm"`` (the q-times integrated Wiener process);
    IOUP / Matern priors are not ported yet.
    """

    order: int = 3
    smooth: bool = True
    diffusionmodel: str = "dynamic"
    prior: object = None

    def __post_init__(self):
        if self.prior == "ibm":
            object.__setattr__(self, "prior", None)
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
