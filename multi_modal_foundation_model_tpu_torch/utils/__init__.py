"""Helpers of the port: weight conversion, devices, seeds, profiling, plots.

The plot functions (``utils/plotting.py``) are exported lazily, through
the module's ``__getattr__``: the package imports without matplotlib, and
only drawing a figure needs it.
"""

from .convert import (baseline_params_from_jax,
                      factors_projection_params_from_jax, params_from_jax,
                      reference_state_dict_select)
from .device import resolve_device
from .profiling import MFUTracker, StepTimer, chip_peak_flops, trace_context
from .rng import fold_in
from .seeding import set_seed

_PLOTS = ("plot_condition_avg_r2", "plot_gt_pred", "plot_neurons_r2")

__all__ = ["MFUTracker", "StepTimer", "baseline_params_from_jax",
           "chip_peak_flops", "factors_projection_params_from_jax",
           "fold_in", "params_from_jax", "reference_state_dict_select",
           "resolve_device", "set_seed", "trace_context", *_PLOTS]


def __getattr__(name):
    if name in _PLOTS:
        from . import plotting

        return getattr(plotting, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
