from odefilters_torch.models.library import fitzhugh_nagumo

__all__ = ["fitzhugh_nagumo"]
