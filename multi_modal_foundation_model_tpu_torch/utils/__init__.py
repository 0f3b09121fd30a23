from .convert import params_from_jax
from .device import resolve_device
from .rng import fold_in

__all__ = ["fold_in", "params_from_jax", "resolve_device"]
