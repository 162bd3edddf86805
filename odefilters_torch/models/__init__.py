from odefilters_torch.models.library import (
    BRUSSELATOR_A,
    BRUSSELATOR_B,
    brusselator_2d,
    brusselator_2d_f_grids,
    brusselator_2d_jd_grids,
    fitzhugh_nagumo,
    lotka_volterra,
)

__all__ = ["BRUSSELATOR_A", "BRUSSELATOR_B", "brusselator_2d",
           "brusselator_2d_f_grids", "brusselator_2d_jd_grids",
           "fitzhugh_nagumo", "lotka_volterra"]
