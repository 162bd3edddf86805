from odefilters_torch.models.library import fitzhugh_nagumo, lotka_volterra

__all__ = ["fitzhugh_nagumo", "lotka_volterra"]
