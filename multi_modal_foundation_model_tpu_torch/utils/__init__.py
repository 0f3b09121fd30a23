from .convert import params_from_jax
from .device import resolve_device

__all__ = ["params_from_jax", "resolve_device"]
