"""The port's config layer against the JAX package's.

- The port's YAML reader (``config/yaml_subset.py``) gives what
  ``yaml.safe_load`` gives on every shipped config file, and on a table of
  scalars either the same value or a ``ValueError`` (never another value).
- The port's copies of the shipped configs are byte for byte the JAX
  package's.
- ``coerce_value``, ``config_from_kwargs``, ``update_config`` and
  ``include:`` resolution give what JAX's ``config/config.py`` gives.
- The four ``from_config`` constructors give JAX's records field by field
  (dtypes by name; ``stacked_scan`` is the one field the port drops).
Exact equality throughout: nothing here is computed in floating point.
"""

import dataclasses
import math
from pathlib import Path

import jax.numpy as jnp
import pytest
import yaml

from multi_modal_foundation_model_tpu import config as jconfig
from multi_modal_foundation_model_tpu.models import multimodal as jmm
from multi_modal_foundation_model_tpu.ops import masking as jmasking
from multi_modal_foundation_model_tpu.train import schedule as jschedule
from multi_modal_foundation_model_tpu.train import trainer as jtrainer
from multi_modal_foundation_model_tpu_torch import config as tconfig
from multi_modal_foundation_model_tpu_torch.config import yaml_subset
from multi_modal_foundation_model_tpu_torch.models import multimodal as tmm
from multi_modal_foundation_model_tpu_torch.ops import masking as tmasking
from multi_modal_foundation_model_tpu_torch.train import schedule as tschedule
from multi_modal_foundation_model_tpu_torch.train import trainer as ttrainer

ROOT = Path(__file__).resolve().parents[1]
SHIPPED = ("baseline.yaml", "trainer.yaml", "multi_modal/mm.yaml",
           "multi_modal/trainer_mm.yaml")


@pytest.mark.parametrize("name", SHIPPED)
def test_reader_equals_safe_load_on_shipped_files(name):
    path = tconfig.default_config_path(name)
    with open(path) as f:
        want = yaml.safe_load(f)
    assert yaml_subset.load(path) == want


@pytest.mark.parametrize("name", SHIPPED)
def test_port_configs_are_byte_copies(name):
    assert (Path(tconfig.default_config_path(name)).read_bytes()
            == Path(jconfig.default_config_path(name)).read_bytes())


# (text, must the reader take it): every case either matches
# yaml.safe_load or is refused with ValueError; the "take" cases must match.
# The reader takes a whitelist, so some scalars PyYAML reads without
# surprise are refused as well (a float without a dot, other spellings of
# the booleans, escapes)
SCALARS = [
    ("a: 1e-5", False),         # no dot: a string in PyYAML
    ("a: 1.0e4", False),        # unsigned exponent: a string in PyYAML
    ("a: 5.e-4", True),
    ("a: 1.e-7", True),
    ("a: 1.E+7", True),
    ("a: 1E-7", False),
    ("a: 0.15", True),
    ("a: .5", False),
    ("a: -.5", False),          # a string in PyYAML
    ("a: 3.", True),
    ("a: -.inf", False),
    ("a: ~", True),
    ("a: null", True),
    ("a:", True),
    ("a: yes", False),
    ("a: No", False),
    ("a: OFF", False),
    ("a: true", True),
    ("a: False", False),
    ("a: 42", True),
    ("a: -3", True),
    ("a: +1", True),
    ("a: 09", False),           # not octal: a string in PyYAML
    ("a: 0o17", False),         # YAML 1.2 octal: a string in PyYAML
    ("a: 1.5.3", False),
    ("a: temporal", True),
    ("a: x#y", False),
    ("a: b  # trailing comment", True),
    ("a: 'quoted # not a comment'", True),
    ("a: \"double quoted\"", True),
    ("a: 'it''s'", False),
    ("a: \"esc\\\"aped\"", False),
    ("a: 671c7ea7-6726-4fbe-adeb-f89c2c8e489b", True),
    ("a: neurofm123/671c7ea7-6726-4fbe-adeb-f89c2c8e489b_aligned", True),
    ("a: include:multi_modal/mm.yaml", True),
    ("a: [\"temporal\"]", True),
    ("a: ['all']", True),
    ("a: [1, two, \"3\", 4.5, null]", True),
    ("a: []", True),
    ("a: {}", True),
    ("a: [x, y]   # comment after a flow list", True),
    ("# only a comment\na:\n  b: 1  # c\n\n  c:\n    d: e\nf: 2", True),
    ("a: 1_000", False),        # PyYAML: 1000
    ("a: 012", False),          # PyYAML: octal 10
    ("a: 00", False),
    ("a: 0x1f", False),
    ("a: 0b101", False),
    ("a: 1:30", False),         # PyYAML: base 60, 90
    ("a: 2001-12-14", False),   # PyYAML: a date
    ("a: =", False),
    ("a: b: c", False),
    ("a: &x 1", False),
    ("a: !!str 1", False),
    ("a: |\n  text", False),
    ("- 1", False),
    ("a: [1, 2,]", False),
    ("a: [[1]]", False),
    ("a: [1,\n  2]", False),
    ("a: {b: 1}", False),
    ("a: \"\\u00e9\"", False),
    ("a: 1\na: 2", False),
    ("---\na: 1", False),
    ("a:\n  b: 1\n c: 2", False),
    ("a:\n\tb: 1", False),
    ("yes: 1", False),          # PyYAML: the key True
    ("a: hello world", False),
    ("a: 'x' 'y'", False),
]


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(map(_same, a, b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("text,take", SCALARS,
                         ids=[repr(t)[:40] for t, _ in SCALARS])
def test_scalar_table_matches_safe_load_or_is_refused(text, take):
    try:
        got = yaml_subset.loads(text)
    except ValueError as e:
        assert not take, f"refused a case it must take: {e}"
        assert "line " in str(e)
        return
    assert _same(got, yaml.safe_load(text))
    assert take, "took a case outside the subset"


COERCE = ["[]", "[1, 2.5, x]", "null", "None", "none", "true", "True",
          "false", "False", "3", "-3", "1e-5", "3e-4", "0.1", "inf", "nan",
          "abc", " 7 ", "include:x.yaml", "1_000"]


@pytest.mark.parametrize("value", COERCE)
def test_coerce_value_matches_jax(value):
    assert _same(tconfig.coerce_value(value), jconfig.coerce_value(value))


def _configs(tmp_path):
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "inner.yaml").write_text(
        "x: 1\ny:\n  z: [a, b]\n")
    (tmp_path / "outer.yaml").write_text(
        "inner: include:sub/inner.yaml\npkg: include:baseline.yaml\n"
        "ref: include:src/configs/multi_modal/mm.yaml\nw: 5.e-4\n")
    (tmp_path / "over.yaml").write_text("inner:\n  y:\n    q: 2\nnew: 3\n")
    return tmp_path


def test_update_config_and_includes_match_jax(tmp_path):
    d = _configs(tmp_path)
    for args in ((str(d / "outer.yaml"),),
                 (str(d / "outer.yaml"), str(d / "over.yaml")),
                 (tconfig.default_config_path("trainer.yaml"),
                  {"model": "include:baseline.yaml"})):
        jargs = tuple(a if not isinstance(a, str) or not a.endswith(
            "trainer.yaml") else jconfig.default_config_path("trainer.yaml")
            for a in args)
        got = tconfig.update_config(*args)
        want = jconfig.update_config(*jargs)
        assert got.to_dict() == want.to_dict()
        assert isinstance(got, tconfig.Config)


def test_config_from_kwargs_matches_jax():
    kwargs = {"model": f"include:{tconfig.default_config_path('baseline.yaml')}",
              "training.num_epochs": "7", "optimizer.lr": "3e-4",
              "masker.mask_regions": "[CA1, DG]", "a.b.c": "null"}
    jkwargs = dict(kwargs, model="include:"
                   + jconfig.default_config_path("baseline.yaml"))
    got = tconfig.config_from_kwargs(kwargs)
    assert got.to_dict() == jconfig.config_from_kwargs(jkwargs).to_dict()
    assert got.training.num_epochs == 7
    assert tconfig.config_from_kwargs(kwargs, coerce=False).to_dict() == \
        jconfig.config_from_kwargs(jkwargs, coerce=False).to_dict()


def test_config_attribute_access_writes_through():
    cfg = tconfig.load_config(tconfig.default_config_path("trainer.yaml"))
    cfg.training["num_epochs"] = 4
    assert cfg.to_dict()["training"]["num_epochs"] == 4
    with pytest.raises(AttributeError):
        cfg.missing


def test_include_not_found_raises(tmp_path):
    (tmp_path / "a.yaml").write_text("b: include:nowhere.yaml\n")
    with pytest.raises(FileNotFoundError):
        tconfig.load_config(str(tmp_path / "a.yaml"))


def _mm_config(pkg):
    cfg = pkg.config_from_kwargs({"model": "include:"
                                  + pkg.default_config_path(
                                      "multi_modal/mm.yaml")})
    return pkg.update_config(
        pkg.default_config_path("multi_modal/trainer_mm.yaml"), cfg)


def _baseline_config(pkg):
    cfg = pkg.config_from_kwargs({"model": "include:"
                                  + pkg.default_config_path("baseline.yaml")})
    return pkg.update_config(pkg.default_config_path("trainer.yaml"), cfg)


def _fields(record):
    out = {}
    for f in dataclasses.fields(record):
        v = getattr(record, f.name)
        if dataclasses.is_dataclass(v):
            v = _fields(v)
        elif f.name == "compute_dtype":
            v = jnp.dtype(v).name if not isinstance(v, str) else v
        out[f.name] = v
    return out


def test_mask_params_from_config_matches_jax():
    got = tmasking.MaskParams.from_config(_mm_config(tconfig).model.masker)
    want = jmasking.MaskParams.from_config(_mm_config(jconfig).model.masker)
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("override", [{}, {"mod_loss_weights.behavior": "20",
                                           "compute.compute_dtype": "float32",
                                           "masker.channels": "[1, 2]"}],
                         ids=["mm.yaml", "overridden"])
def test_multimodal_config_from_config_matches_jax(override):
    def build(pkg, mm):
        cfg = _mm_config(pkg)
        if override:
            cfg = pkg.update_config(cfg, pkg.config_from_kwargs(
                {f"model.{k}": v for k, v in override.items()}))
        return mm.MultiModalConfig.from_config(
            cfg.model, n_channels={"ap": 668, "behavior": 2})

    got, want = build(tconfig, tmm), build(jconfig, jmm)
    assert _fields(got) == _fields(want)
    assert got.compute_dtype == ("float32" if override else "bfloat16")


def test_multimodal_config_from_config_refuses_unknown_dtype():
    cfg = tconfig.update_config(_mm_config(tconfig), tconfig.config_from_kwargs(
        {"model.compute.compute_dtype": "float16"}))
    with pytest.raises(ValueError, match="compute_dtype"):
        tmm.MultiModalConfig.from_config(
            cfg.model, n_channels={"ap": 668, "behavior": 2})


@pytest.mark.parametrize("which", ["trainer_mm.yaml", "trainer.yaml"])
def test_trainer_config_from_config_matches_jax(which):
    build = _mm_config if which == "trainer_mm.yaml" else _baseline_config
    over = dict(seed=3, log_dir="somewhere", steps_per_dispatch=10)
    got = _fields(ttrainer.TrainerConfig.from_config(build(tconfig), **over))
    want = _fields(jtrainer.TrainerConfig.from_config(build(jconfig), **over))
    # every field, the multi-session trainer's ``stacked_scan`` included
    assert got == want


@pytest.mark.parametrize("which", ["trainer_mm.yaml", "trainer.yaml"])
def test_optimizer_config_from_config_matches_jax(which):
    build = _mm_config if which == "trainer_mm.yaml" else _baseline_config
    got = tschedule.OptimizerConfig.from_config(build(tconfig).optimizer)
    want = jschedule.OptimizerConfig.from_config(build(jconfig).optimizer)
    assert _fields(got) == _fields(want)
