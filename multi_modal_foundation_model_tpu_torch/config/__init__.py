from .config import (
    Config,
    config_from_kwargs,
    coerce_value,
    default_config_path,
    load_config,
    update_config,
)

__all__ = [
    "Config",
    "config_from_kwargs",
    "coerce_value",
    "default_config_path",
    "load_config",
    "update_config",
]
