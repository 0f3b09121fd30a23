"""The port stands alone: it imports no JAX and nothing of the JAX package,
and the data side's optional packages (pandas, ``datasets``,
``huggingface_hub``, h5py and the IBL stack) and the figures' (matplotlib,
sklearn) only inside the functions that use them; a figure asked for
without matplotlib raises ``ImportError`` naming it; its entry points
refuse to fall back to the CPU, and ``chip_smoke.py`` fails (printing no
result) where there is no card or no repo."""

import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per xdist worker)
from multi_modal_foundation_model_tpu_torch.models import multimodal as tmm
from multi_modal_foundation_model_tpu_torch.ops import build
from multi_modal_foundation_model_tpu_torch.utils import device as tdevice

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "multi_modal_foundation_model_tpu_torch"
FORBIDDEN = re.compile(
    r"^(jax|jaxlib|flax|optax|orbax|multi_modal_foundation_model_tpu)(\.|$)")


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        name = ".".join(rel.parts)
        yield name[:-len(".__init__")] if name.endswith(".__init__") else name


def _imported_names(path: Path):
    """Absolute module names imported by a source file."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


# imported lazily, inside the functions that need them (JAX's data side
# does the same; its plots import matplotlib at module top, the port's
# inside the functions that draw)
LAZY = ["pandas", "datasets", "huggingface_hub", "h5py", "one", "brainbox",
        "iblatlas", "matplotlib", "sklearn"]


def test_port_imports_with_jax_blocked():
    """Every port module imports in a process where importing jax, flax,
    optax, orbax, the JAX package or one of the data side's optional
    packages raises."""
    blocked = ["jax", "jaxlib", "flax", "optax", "orbax",
               "multi_modal_foundation_model_tpu"] + LAZY
    code = "\n".join(
        ["import importlib, sys"]
        + [f"sys.modules[{m!r}] = None" for m in blocked]
        + [f"importlib.import_module({m!r})" for m in _port_modules()]
        + ["assert not any(sys.modules.get(m) for m in %r)" % blocked,
           "print('ok')"])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_profiling_and_plots_are_scanned():
    """The profiling and figure modules are among those loaded with JAX,
    matplotlib and sklearn blocked."""
    assert {f"multi_modal_foundation_model_tpu_torch.{m}" for m in (
        "utils.profiling", "utils.plotting", "scripts.profile_model",
        "scripts.draw_mask_ratio")} <= set(_port_modules())


def test_figures_without_matplotlib_raise():
    """With matplotlib blocked: the package and its plot exports import,
    the profiling runs, and every path that draws (a plot function, a
    trainer's epoch figures, ``draw_mask_ratio``) raises ``ImportError``
    naming matplotlib; the figures' trial order falls back to the first
    principal component without sklearn."""
    code = "\n".join([
        "import sys",
        "sys.modules['matplotlib'] = None",
        "sys.modules['sklearn'] = None",
        "import types, numpy as np, torch",
        "from multi_modal_foundation_model_tpu_torch import utils",
        "from multi_modal_foundation_model_tpu_torch.utils import plotting",
        "from multi_modal_foundation_model_tpu_torch.train import trainer",
        "from multi_modal_foundation_model_tpu_torch.scripts import "
        "draw_mask_ratio",
        "assert utils.MFUTracker.flops_of(torch.mm, torch.ones(4, 4), "
        "torch.ones(4, 4)) == 128",
        "y = np.random.default_rng(0).normal(size=(6, 5))",
        "assert sorted(plotting._cluster_trial_order(y)) == list(range(6))",
        "me = types.SimpleNamespace(mesh=None, modal_filter={'output': "
        "['behavior']})",
        "calls = [lambda: utils.plot_gt_pred(y, y),",
        "         lambda: trainer.BaselineTrainer._plot_epoch(me, {}, 0),",
        "         lambda: draw_mask_ratio.draw({}, {})]",
        "for call in calls:",
        "    try:",
        "        call()",
        "    except ImportError as err:",
        "        assert 'matplotlib' in str(err), err",
        "    else:",
        "        raise AssertionError('drew without matplotlib')",
        "print('ok')"])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_parallel_package_is_scanned():
    """``parallel/`` is among the modules the import tests load with JAX
    blocked, and its rank workers (``tests/torch_parallel_workers.py``)
    run the port without JAX as well."""
    assert {"multi_modal_foundation_model_tpu_torch.parallel",
            "multi_modal_foundation_model_tpu_torch.parallel.mesh",
            "multi_modal_foundation_model_tpu_torch.parallel.partition"} <= \
        set(_port_modules())
    blocked = ["jax", "jaxlib", "flax", "optax", "orbax",
               "multi_modal_foundation_model_tpu"]
    code = "\n".join(
        ["import sys"] + [f"sys.modules[{m!r}] = None" for m in blocked]
        + ["sys.path.insert(0, 'tests')", "import torch_parallel_workers",
           "print('ok')"])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_multisession_mesh_path_runs_without_jax(tmp_path):
    """The modules of the multi-session trainer under a mesh (the trainer,
    its resident buffers, the sharded schedule, the stitched tensor
    parallelism, the masker's per-rank draws, the script) are among those
    loaded with JAX blocked, and the rank workers' multi-session run
    (``run_ms``: a resident K = 2 epoch and the sharded schedule) goes
    through them in a process where importing JAX raises."""
    assert {f"multi_modal_foundation_model_tpu_torch.{m}" for m in (
        "train.trainer", "train.multisession", "train.cuda_graph",
        "parallel.partition", "ops.masking", "models.layers",
        "scripts.train_multi_session")} <= set(_port_modules())
    blocked = ["jax", "jaxlib", "flax", "optax", "orbax",
               "multi_modal_foundation_model_tpu"]
    code = "\n".join(
        ["import sys"] + [f"sys.modules[{m!r}] = None" for m in blocked]
        + ["sys.path.insert(0, 'tests')",
           "import torch",
           "import torch_parallel_workers as w",
           "from multi_modal_foundation_model_tpu_torch.models import "
           "multimodal as tmm",
           "from multi_modal_foundation_model_tpu_torch.train import "
           "multisession as ms",
           "g = dict(max_F=20, hidden_size=32, n_heads=2, n_enc_layers=1, "
           "n_dec_layers=1, inter_size=64)",
           "spec = dict(geometry=g, dropout=0.0, embed_dropout=0.0, "
           "mask=dict(channels=(1,)), menu=['co-smooth'], mixed=False, "
           "batch_size=8, log_dir=%r)" % str(tmp_path),
           "cfg = tmm.MultiModalConfig(**g, n_sessions=3, "
           "n_channels={'ap': 64, 'behavior': 2})",
           "torch.save(tmm.MultiModal(cfg, device='cpu').state_dict(), "
           "%r)" % str(tmp_path / "init.pt"),
           "spec.update(init=%r, paths=[dict(name='k2', over=dict("
           "device_resident_data=True, steps_per_dispatch=2))])"
           % str(tmp_path / "init.pt"),
           "r = w.run_ms(spec, None)['k2']",
           "assert len(r['losses']) == 6",
           "assert len(ms.sharded_schedule([[11, 22]], 8, 2, 2, 0, 0)) == 3",
           "assert not any(sys.modules.get(m) for m in %r)" % blocked,
           "print('ok')"])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_imports_pull_in_no_data_packages():
    """Importing every port module (nothing blocked) loads none of the data
    side's optional packages, though this box has pandas, ``datasets``,
    ``huggingface_hub`` and h5py."""
    code = "\n".join(
        ["import importlib, sys"]
        + [f"importlib.import_module({m!r})" for m in _port_modules()]
        + ["print(sorted(m for m in %r if m in sys.modules))" % LAZY])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py", "tests/torch_parallel_workers.py"]))
def test_source_imports_no_jax_package(path):
    """Source scan: no import of jax/flax/optax/orbax or of the JAX
    package; the port's own name (``..._tpu_torch``) shares the JAX
    package's prefix and is allowed."""
    bad = [n for n in _imported_names(ROOT / path) if FORBIDDEN.match(n)]
    assert not bad, f"{path} imports {bad}"


def test_forbidden_pattern_tells_the_port_from_the_jax_package():
    assert FORBIDDEN.match("multi_modal_foundation_model_tpu.ops")
    assert FORBIDDEN.match("multi_modal_foundation_model_tpu")
    assert FORBIDDEN.match("jax.numpy")
    assert not FORBIDDEN.match("multi_modal_foundation_model_tpu_torch.ops")
    assert not FORBIDDEN.match("jaxtyping")


def test_entry_points_need_an_explicit_cpu():
    """Without a card, device=None raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdevice.resolve_device(None)
    with pytest.raises(RuntimeError):
        tmm.MultiModal(tmm.MultiModalConfig(hidden_size=32, n_heads=2,
                                            n_enc_layers=1, n_dec_layers=1))
    with pytest.raises(RuntimeError):       # the session-stitched model too
        tmm.MultiModal(tmm.MultiModalConfig(hidden_size=32, n_heads=2,
                                            n_enc_layers=1, n_dec_layers=1,
                                            n_sessions=3))
    assert tdevice.resolve_device("cpu") == torch.device("cpu")


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_kernel_sources_and_build_key(tmp_path, monkeypatch):
    """Every CUDA source is listed; its library name carries a hash of
    the source and the shared headers, so an edited source or header
    builds a new library."""
    assert {"attention_fwd", "attention_bwd", "layernorm", "random",
            "session_rows"} <= set(build.kernel_sources())
    path = build.library_path("attention_fwd")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libattention_fwd-")
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    assert build.library_path("attention_fwd") == path
    src = (csrc / "attention_fwd.cu").read_text()
    (csrc / "attention_fwd.cu").write_text(src + "\n// edited\n")
    edited = build.library_path("attention_fwd")
    assert edited != path
    header = (csrc / "philox.cuh").read_text()
    (csrc / "philox.cuh").write_text(header + "\n// edited\n")
    assert build.library_path("attention_fwd") not in (path, edited)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    if shutil.which("nvcc"):
        pytest.skip("nvcc is present")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(["attention_fwd"])
