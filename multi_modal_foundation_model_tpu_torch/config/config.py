"""YAML configuration: attribute access, includes, merges, CLI overrides.

The port's copy of ``multi_modal_foundation_model_tpu/config/config.py``
(``Config``, ``load_config``, ``update_config``, ``coerce_value``,
``config_from_kwargs``, ``default_config_path`` and ``include:``
resolution), reading YAML with the port's own reader of the subset the
shipped files use (``config/yaml_subset.py``) where the JAX package uses
PyYAML. ``default_config_path`` names the port's copies of the shipped
configs (``config/configs/``, byte for byte the JAX package's).

- attribute-style access on nested dicts (``cfg.model.encoder.hidden_size``);
- string leaves ``include:<path>`` are replaced by the parsed YAML file at
  ``<path>``, resolved relative to the including file, then the working
  directory, then the packaged ``configs/`` directory;
- ``update_config(default, override)`` merges recursively, creating
  missing keys;
- dotted CLI kwargs (``a.b.c=1``), coerced from strings, build nested
  configs.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Mapping, Optional

from . import yaml_subset

_PKG_CONFIG_DIR = os.path.join(os.path.dirname(__file__), "configs")


def default_config_path(name: str) -> str:
    """Path of a YAML shipped with the package, e.g. ``multi_modal/mm.yaml``."""
    return os.path.join(_PKG_CONFIG_DIR, name)


class Config(dict):
    """A dict with attribute access; nested dicts are wrapped on the fly."""

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        if isinstance(value, dict) and not isinstance(value, Config):
            # store the wrapper back so mutations through attribute access
            # (cfg.training["num_epochs"] = 4) hit this config, not a copy
            value = Config(value)
            self[name] = value
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo) -> "Config":
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> Dict[str, Any]:
        """Plain nested-dict copy (for serialization)."""

        def unwrap(v: Any) -> Any:
            if isinstance(v, dict):
                return {k: unwrap(sv) for k, sv in v.items()}
            if isinstance(v, (list, tuple)):
                return [unwrap(sv) for sv in v]
            return v

        return unwrap(self)


def _resolve_include(path: str, base_dir: Optional[str]) -> str:
    """Find an included YAML: relative to the including file, CWD, or package."""
    candidates = []
    if os.path.isabs(path):
        candidates.append(path)
    else:
        if base_dir:
            candidates.append(os.path.join(base_dir, path))
        candidates.append(path)
        candidates.append(os.path.join(_PKG_CONFIG_DIR, path))
        # The reference uses paths like "src/configs/multi_modal/mm.yaml";
        # map those onto the packaged configs dir for drop-in compatibility.
        stripped = path
        for prefix in ("src/configs/", "configs/"):
            if path.startswith(prefix):
                stripped = path[len(prefix):]
        candidates.append(os.path.join(_PKG_CONFIG_DIR, stripped))
    for cand in candidates:
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"config include not found: {path!r} (tried {candidates})")


def _unpack_includes(node: Any, base_dir: Optional[str]) -> Any:
    """Recursively replace ``include:<path>`` string leaves with parsed YAML."""
    if isinstance(node, str) and node.split(":", 1)[0] == "include":
        path = _resolve_include(node.split(":", 1)[1], base_dir)
        loaded = yaml_subset.load(path)
        return _unpack_includes(loaded, os.path.dirname(path))
    if isinstance(node, dict):
        return {k: _unpack_includes(v, base_dir) for k, v in node.items()}
    return node


def _merge(base: Any, override: Any) -> Any:
    """Recursively overlay ``override`` onto ``base`` (override wins at leaves)."""
    if isinstance(override, dict):
        out = dict(base) if isinstance(base, dict) else {}
        for key, value in override.items():
            out[key] = _merge(out.get(key), value)
        return out
    return copy.deepcopy(override)


def load_config(path_or_dict: Any) -> Config:
    """Load a YAML file (or wrap a dict), resolving all includes."""
    base_dir = None
    if isinstance(path_or_dict, str):
        base_dir = os.path.dirname(os.path.abspath(path_or_dict))
        node = yaml_subset.load(path_or_dict)
    else:
        node = path_or_dict
    return Config(_unpack_includes(node, base_dir))


def update_config(default_config: Any, config: Any = None) -> Config:
    """Merge ``config`` over ``default_config``; either may be a YAML path.

    With ``config=None`` the default is returned with includes unpacked —
    same contract as the reference ``update_config``.
    """
    default_loaded = load_config(default_config)
    if config is None:
        return default_loaded
    override_loaded = load_config(config)
    return Config(_merge(default_loaded, override_loaded))


def coerce_value(value: str) -> Any:
    """Coerce a CLI string to list/None/bool/int/float, else keep the string."""
    value = value.strip()
    if value.startswith("[") and value.endswith("]"):
        inner = value[1:-1].strip()
        if not inner:
            return []
        return [coerce_value(v) for v in inner.split(",")]
    if value in ("null", "None", "none"):
        return None
    if value in ("true", "True"):
        return True
    if value in ("false", "False"):
        return False
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    return value


def config_from_kwargs(kwargs: Optional[Mapping[str, Any]],
                       coerce: bool = True) -> Config:
    """Build a nested config from dotted keys, e.g. ``{"a.b": "1"}``.

    String values are dtype-coerced and ``include:`` leaves resolved, matching
    the reference entry-script usage ``config_from_kwargs({"model":
    "include:.../mm.yaml"})``.
    """
    nested: Dict[str, Any] = {}
    if kwargs:
        for dotted, value in kwargs.items():
            if coerce and isinstance(value, str) and not value.startswith("include:"):
                value = coerce_value(value)
            cursor = nested
            parts = dotted.split(".")
            for part in parts[:-1]:
                cursor = cursor.setdefault(part, {})
            cursor[parts[-1]] = value
    return Config(_unpack_includes(nested, None))
