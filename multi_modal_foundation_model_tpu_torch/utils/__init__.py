from .convert import (baseline_params_from_jax,
                      factors_projection_params_from_jax, params_from_jax,
                      reference_state_dict_select)
from .device import resolve_device
from .rng import fold_in
from .seeding import set_seed

__all__ = ["baseline_params_from_jax", "factors_projection_params_from_jax",
           "fold_in", "params_from_jax", "reference_state_dict_select",
           "resolve_device", "set_seed"]
