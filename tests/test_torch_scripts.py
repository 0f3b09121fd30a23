"""The port's entry scripts against the JAX package's.

The port's ``train_baseline``, ``eval_baseline`` (both directions),
``train_multi_modal`` and ``eval_multi_modal``, and ``train_multi_session``
with ``eval_multi_modal --multi_session``, run through ``main(argv)`` on
the CPU (``--device cpu --synthetic --n_neurons 24 --n_trials 40
--num_epochs 1``; the MultiModal model cut by ``--set`` to one encoder and
one decoder layer and a narrow width). The JAX baseline scripts run with
the same arguments in one subprocess (``JAX_PLATFORMS=cpu``). Their log
dirs, ``baseline_config.json`` and the key sets of ``results.json`` are
equal; so is the MultiModal scripts' log dir (JAX's ``log_dir_for``, read
in that subprocess). The multi-session scripts write JAX's
``sessions.json`` (the eids, neuron counts and ``n_max`` of JAX's
``build_multisession_loaders`` on the same sessions) and per-session
results. Without ``--synthetic`` the scripts load IBL sessions through
``load_ibl_session``: with a stand-in ``datasets`` module in
``sys.modules`` (``chip_smoke.hub_stand_in``, serving hub rows that the
port's ETL made from seeded raw sessions; nothing is downloaded) both
baselines, ``train_multi_modal --eid``, ``eval_multi_modal --eid`` (and
``--unaligned``), ``train_multi_session --eids A B`` and ``eval_multi_modal
--multi_session`` run and give finite results; with no ``datasets`` they
raise ``ImportError``. Every flag that is not ported raises
``NotImplementedError``, and ``--device cuda`` without a card raises.
``train_multi_session --dp 2 --tp 2`` as ranks is in
``tests/test_torch_ms_mesh_scripts.py``.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke
import torch_parity  # noqa: F401  (one torch thread per xdist worker)
from multi_modal_foundation_model_tpu_torch.scripts import (
    eval_baseline, eval_multi_modal, train_baseline, train_multi_modal,
    train_multi_session)

ROOT = Path(__file__).resolve().parents[1]
COMMON = ["--synthetic", "--n_neurons", "24", "--n_trials", "40"]
SMALL_MM = ["--set", "model.encoder.transformer.n_layers=1",
            "--set", "model.decoder.transformer.n_layers=1",
            "--set", "model.encoder.transformer.hidden_size=64",
            "--set", "model.encoder.transformer.inter_size=128",
            "--set", "model.encoder.transformer.n_heads=2"]
MM_FLAGS = ["--use_MtM", "--mixed_training"]
EVAL_MODES = ["--co_smooth", "--forward_pred", "--inter_region",
              "--intra_region"]
DIRECTIONS = ("encoding", "decoding")
BASELINE_DIR = {
    "encoding": "results/ses-{eid}/set-train/inModal-behavior/outModal-ap/"
                "linear",
    "decoding": "results/ses-{eid}/set-train/inModal-ap/outModal-behavior/"
                "linear"}


def _baseline_runs(base):
    runs = []
    for d in DIRECTIONS:
        args = COMMON + ["--base_path", str(base), "--direction", d]
        runs.append(("train_baseline.py", args + ["--num_epochs", "1"]))
        runs.append(("eval_baseline.py", args))
    return runs


_JAX_DRIVER = """
import json, os, runpy, sys
sys.path.insert(0, os.path.join(os.getcwd(), "scripts"))
for script, argv in json.loads(sys.argv[1]):
    sys.argv = [script] + argv
    runpy.run_path(os.path.join("scripts", script), run_name="__main__")
import _common
print("LOG_DIR=" + _common.log_dir_for(
    "B", _common.DEFAULT_EID, {"input": ["ap", "behavior"],
                               "output": ["ap", "behavior"]},
    "mask-temporal_ratio-0.1_mixed-True"))
"""


@pytest.fixture(scope="module")
def jax_base(tmp_path_factory):
    base = tmp_path_factory.mktemp("jax_scripts")
    env = dict(os.environ, JAX_PLATFORMS="cpu", MMFM_PLATFORM="cpu",
               MMFM_COMPILE_CACHE="", MPLBACKEND="Agg")
    out = subprocess.run(
        [sys.executable, "-c", _JAX_DRIVER,
         json.dumps(_baseline_runs(base))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    log_dir = [ln for ln in out.stdout.splitlines()
               if ln.startswith("LOG_DIR=")][-1][len("LOG_DIR="):]
    return base, log_dir


@pytest.fixture(scope="module")
def port_base(tmp_path_factory):
    base = tmp_path_factory.mktemp("port_scripts")
    mains = {"train_baseline.py": train_baseline.main,
             "eval_baseline.py": eval_baseline.main}
    for script, argv in _baseline_runs(base):
        mains[script](argv + ["--device", "cpu"])
    mm = COMMON + MM_FLAGS + ["--base_path", str(base), "--device", "cpu"]
    summary = train_multi_modal.main(
        mm + SMALL_MM + ["--num_epochs", "1", "--device_resident",
                         "--set", "training.steps_per_dispatch=2"])
    results = eval_multi_modal.main(mm + EVAL_MODES)
    return base, summary, results


def _files(base):
    return sorted(str(p.relative_to(base)) for p in Path(base).rglob("*")
                  if p.is_file())


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def _eid():
    from multi_modal_foundation_model_tpu_torch.scripts._common import (
        DEFAULT_EID)
    return DEFAULT_EID


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_baseline_scripts_match_jax(jax_base, port_base, direction):
    jbase, _ = jax_base
    tbase = port_base[0]
    rel = BASELINE_DIR[direction].format(eid=_eid())
    jdir, tdir = Path(jbase) / rel, Path(tbase) / rel
    assert jdir.is_dir() and tdir.is_dir()
    # the same layout: sidecars, metrics, the eval's per-mode artifacts
    # (checkpoints are the port's .pt files, orbax directories in JAX)
    shared = {"baseline_config.json", "metrics.jsonl", "model_best.json",
              "model_last.json", "eval/results.json"}
    mode = "modal_spike" if direction == "encoding" else "modal_behavior"
    shared |= {f"eval/{mode}/bps.npy", f"eval/{mode}/r2.npy"}
    assert shared <= set(_files(jdir)) and shared <= set(_files(tdir))
    assert {"model_best.pt", "model_last.pt"} <= set(_files(tdir))
    assert json.loads((tdir / "baseline_config.json").read_text()) == \
        json.loads((jdir / "baseline_config.json").read_text())
    tres = json.loads((tdir / "eval/results.json").read_text())
    jres = json.loads((jdir / "eval/results.json").read_text())
    assert _keys(tres) == _keys(jres)
    row = json.loads((tdir / "metrics.jsonl").read_text().splitlines()[0])
    jrow = json.loads((jdir / "metrics.jsonl").read_text().splitlines()[0])
    assert set(row) == set(jrow)


def _finite_or_nan(v):
    if isinstance(v, dict):
        return all(_finite_or_nan(x) for x in v.values())
    return isinstance(v, float) and (math.isfinite(v) or math.isnan(v))


def test_multi_modal_scripts_write_their_results(jax_base, port_base):
    _, jlog = jax_base
    tbase, summary, results = port_base
    log_dir = Path(tbase) / os.path.relpath(jlog, "B")
    assert log_dir.is_dir()
    for name in ("model_best.pt", "model_last.pt", "model_config.json",
                 "metrics.jsonl", "eval/results.json"):
        assert (log_dir / name).exists(), name
    modes = ("per_neuron", "forward_pred", "inter_region", "intra_region",
             "modal_spike")
    want = {f"{m}_mean_{s}" for m in modes
            for s in ("bps", "r2_psth", "r2_trial")}
    want.add("modal_behavior_behav_results")
    assert set(results) == want
    assert json.loads((log_dir / "eval/results.json").read_text()).keys() \
        == want
    for m in modes + ("modal_behavior",):
        assert (log_dir / "eval" / m / "bps.npy").exists()
    assert all(_finite_or_nan(v) for v in results.values())
    assert math.isfinite(summary["best_eval_trial_avg_r2"])
    cfg = json.loads((log_dir / "model_config.json").read_text())
    assert cfg["compute_dtype"] == "bfloat16"      # mm.yaml's default
    assert cfg["n_enc_layers"] == cfg["n_dec_layers"] == 1


def test_multi_session_scripts_write_their_results(tmp_path):
    """``train_multi_session`` (2 sessions of 24 and 61 neurons, MtM,
    mixed objectives, resident, 2 steps a dispatch) and ``eval_multi_modal
    --multi_session`` (every mode a session) on the CPU."""
    from multi_modal_foundation_model_tpu.data.session import (
        synthetic_splits as jax_splits)
    from multi_modal_foundation_model_tpu.train.multisession import (
        build_multisession_loaders as jax_build)

    argv = COMMON + MM_FLAGS + ["--base_path", str(tmp_path), "--device",
                                "cpu", "--num_sessions", "2", "--eid", "x"]
    summary = train_multi_session.main(
        argv + SMALL_MM + ["--n_neurons", "24", "--num_epochs", "1",
                           "--device_resident", "--steps_per_dispatch", "2",
                           "--pad_multiple", "32", "--n_buckets", "2"])
    log_dir = (tmp_path / "results/ses-multi2/set-train/"
               "inModal-ap-behavior/outModal-ap-behavior/"
               "stitched_ratio-0.3")
    sessions = json.loads((log_dir / "sessions.json").read_text())
    _, _, _, meta = jax_build(
        {f"x-{i}": jax_splits(seed=42 + i, n_trials=40,
                              n_neurons=24 + 37 * i, eid=f"x-{i}")
         for i in range(2)}, batch_size=16, pad_multiple=32, n_buckets=2)
    assert sessions == {"eids": meta["eids"],
                        "num_neurons": meta["num_neurons"],
                        "n_max": meta["n_max"]} == {
        "eids": ["x-0", "x-1"], "num_neurons": [24, 61], "n_max": 64}
    cfg = json.loads((log_dir / "model_config.json").read_text())
    assert cfg["n_sessions"] == 2 and cfg["n_channels"]["ap"] == 64
    assert math.isfinite(summary["best_eval_trial_avg_r2"])
    results = eval_multi_modal.main(
        ["--synthetic", "--n_trials", "40", "--device", "cpu",
         "--multi_session", "--model_dir", str(log_dir), "--use_MtM"]
        + EVAL_MODES)
    assert set(results) == {"x-0", "x-1", "mean_over_sessions"}
    for eid in ("x-0", "x-1"):
        assert "modal_behavior_behav_results" in results[eid]
        assert all(_finite_or_nan(v) for v in results[eid].values())
        for m in ("per_neuron", "forward_pred", "inter_region",
                  "intra_region", "modal_spike", "modal_behavior"):
            assert (log_dir / "eval" / eid / m / "bps.npy").exists()
    assert json.loads((log_dir / "eval/results.json").read_text()).keys() \
        == results.keys()


def test_mixed_session_batches_script_runs(tmp_path):
    """``train_multi_session --mixed_session_batches`` (2 sessions of 24
    and 61 neurons in one bucket, resident, 2 steps a dispatch, 1 epoch)
    on the CPU: finite rows, the mixed epoch's length (ceil(train trials /
    16), both sessions in one pool), checkpoints; without ``--device_resident`` it
    refuses, as JAX does."""
    argv = COMMON + MM_FLAGS + SMALL_MM + [
        "--base_path", str(tmp_path), "--device", "cpu", "--num_sessions",
        "2", "--eid", "x", "--n_neurons", "24", "--num_epochs", "1",
        "--pad_multiple", "32", "--mixed_session_batches"]
    summary = train_multi_session.main(
        argv + ["--device_resident", "--steps_per_dispatch", "2"])
    log_dir = (tmp_path / "results/ses-multi2/set-train/"
               "inModal-ap-behavior/outModal-ap-behavior/"
               "stitched_ratio-0.3")
    from multi_modal_foundation_model_tpu_torch.data.session import (
        synthetic_splits)

    trials = sum(synthetic_splits(seed=42 + i, n_trials=40,
                                  n_neurons=24 + 37 * i).train.n_trials
                 for i in range(2))
    (row,) = summary["history"]
    assert len(row["step_losses"]) == -(-trials // 16) == 4
    assert all(math.isfinite(x) for x in row["step_losses"])
    assert (log_dir / "model_last.pt").exists()
    with pytest.raises(ValueError, match="device_resident_data"):
        train_multi_session.main(argv + ["--overwrite"])


def _script_args(script, tmp_path):
    base = ["--base_path", str(tmp_path), "--device", "cpu"]
    return {"train_baseline": train_baseline.main,
            "eval_baseline": eval_baseline.main,
            "train_multi_modal": train_multi_modal.main,
            "eval_multi_modal": eval_multi_modal.main,
            "train_multi_session": train_multi_session.main}[script], base


UNPORTED = [
    # DP-sharded resident sessions (JAX: with mixed batches), ported since
    ("train_multi_session", ["--synthetic", "--mixed_session_batches",
                             "--shard_sessions"]),
    ("train_multi_session", ["--synthetic", "--shard_sessions"]),
    ("train_multi_session", ["--synthetic", "--compile_retries", "1"]),
    ("train_multi_session", ["--synthetic", "--dp", "2"]),
    ("eval_multi_modal", ["--synthetic", "--save_plot"]),
    ("eval_baseline", ["--synthetic", "--save_plot"]),
    ("train_baseline", ["--synthetic", "--dp", "2"]),
    ("train_multi_modal", ["--synthetic", "--dp", "2"]),
    ("train_multi_modal", ["--synthetic", "--tp", "2"]),
]
# ported since: a mesh that is not the world of ranks (one process here)
WRONG_WORLD = {"train_baseline:--synthetic --dp 2",
               "train_multi_modal:--synthetic --dp 2",
               "train_multi_modal:--synthetic --tp 2",
               "train_multi_session:--synthetic --dp 2"}
# ported since: per-neuron figures, drawn from the module's trained
# checkpoints (the first 2 a mode, JAX's names)
SAVE_PLOT = {"eval_multi_modal:--synthetic --save_plot":
             ("mask-temporal_ratio-0.1_mixed-True", "per_neuron", "mm"),
             "eval_baseline:--synthetic --save_plot":
             ("linear", "modal_spike", "linear")}
# ported since: sharded sessions in one process, as JAX runs them (a tiny
# run): ignored without mixed batches; with mixed batches but no resident
# data the first epoch refuses, as it does without --shard_sessions
SHARD_SESSIONS = {
    "train_multi_session:--synthetic --shard_sessions": None,
    "train_multi_session:--synthetic --mixed_session_batches "
    "--shard_sessions": "device_resident_data"}


@pytest.mark.parametrize("script,argv", UNPORTED,
                         ids=[f"{s}:{' '.join(a) or 'no --synthetic'}"
                              for s, a in UNPORTED])
def test_unported_flags_raise(script, argv, tmp_path, request):
    """Each flag that is not ported raises ``NotImplementedError``;
    ``--dp``/``--tp`` of the train scripts are ported and raise
    ``ValueError`` when dp * tp is not the world of ranks;
    ``--shard_sessions`` is ported and runs as JAX runs it; ``--save_plot``
    is ported and draws the per-neuron figures."""
    main, base = _script_args(script, tmp_path)
    key = f"{script}:{' '.join(argv)}"
    if key in SAVE_PLOT:
        run, mode, method = SAVE_PLOT[key]
        trained = str(request.getfixturevalue("port_base")[0])
        flags = (MM_FLAGS + ["--co_smooth", "--no_modal_spike",
                             "--no_modal_behavior"]
                 if script == "eval_multi_modal" else
                 ["--direction", "encoding"])
        main(argv + COMMON[1:] + flags + ["--base_path", trained, "--device",
                                          "cpu", "--max_plots", "2"])
        modal = ({"input": ["ap", "behavior"], "output": ["ap", "behavior"]}
                 if script == "eval_multi_modal" else
                 {"input": ["behavior"], "output": ["ap"]})
        from multi_modal_foundation_model_tpu_torch.scripts._common import (
            log_dir_for)
        out = Path(log_dir_for(trained, _eid(), modal, run)) / "eval" / mode
        names = sorted(p.name for p in out.glob("*.png"))
        assert len(names) == 2, names
        assert all(n.endswith(f"_{method}.png") for n in names)
        return
    if key in WRONG_WORLD:
        with pytest.raises(ValueError, match="world"):
            main(argv + base)
        return
    if key in SHARD_SESSIONS:
        tiny = argv + base + COMMON + SMALL_MM + [
            "--num_sessions", "2", "--num_epochs", "1", "--pad_multiple",
            "32"]
        if SHARD_SESSIONS[key] is None:
            row = main(tiny)["history"][0]
            assert all(math.isfinite(x) for x in row["step_losses"])
        else:
            with pytest.raises(ValueError, match=SHARD_SESSIONS[key]):
                main(tiny)
        return
    with pytest.raises(NotImplementedError):
        main(argv + base)


@pytest.mark.parametrize("script", ["train_baseline", "eval_baseline",
                                    "train_multi_modal", "eval_multi_modal",
                                    "train_multi_session"])
def test_cuda_without_a_card_raises(script, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    main, _ = _script_args(script, tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(COMMON + ["--base_path", str(tmp_path)])


def test_overwrite_guard(port_base):
    tbase = port_base[0]
    with pytest.raises(FileExistsError):
        train_baseline.main(COMMON + ["--base_path", str(tbase), "--device",
                                      "cpu", "--direction", "decoding"])


# ---------------------------------------------------------------------------
# real (IBL) sessions: the scripts without --synthetic
# ---------------------------------------------------------------------------

REAL = ["etl-0", "etl-1"]


def _real_rows():
    """Hub rows of two stand-in sessions (24 and 30 of 34 clusters kept,
    100 trials, 100 bins) made by the port's ETL, by dataset name."""
    from multi_modal_foundation_model_tpu_torch.data import etl, sparse

    out = {}
    for i, (eid, kept) in enumerate(zip(REAL, (24, 30))):
        raw = chip_smoke.raw_session(seed=i, n_clusters=34, n_kept=kept,
                                     n_trials=100)
        rows, _, _ = chip_smoke.etl_rows(raw, eid, etl, sparse)
        for suffix in ("aligned", "unaligned"):
            out[f"neurofm123/{eid}_{suffix}"] = rows
    return out


@pytest.fixture(scope="module")
def real_runs(tmp_path_factory):
    """Every script's real-session branch, run once through the stand-in:
    results by run name, and the dataset names the stand-in served."""
    base = str(tmp_path_factory.mktemp("real_scripts"))
    one = ["--eid", REAL[0], "--base_path", base, "--device", "cpu"]
    mm = one + MM_FLAGS
    multi_dir = (Path(base) / "results/ses-multi2/set-train/"
                 "inModal-ap-behavior/outModal-ap-behavior/"
                 "stitched_ratio-0.3")
    runs = [
        ("train_baseline", train_baseline.main,
         one + ["--direction", "decoding", "--num_epochs", "1"]),
        ("eval_baseline", eval_baseline.main,
         one + ["--direction", "decoding"]),
        ("train_multi_modal", train_multi_modal.main,
         mm + SMALL_MM + ["--num_epochs", "1"]),
        ("eval_multi_modal", eval_multi_modal.main, mm + ["--co_smooth"]),
        ("eval_multi_modal_unaligned", eval_multi_modal.main,
         mm + ["--unaligned"]),
        ("train_multi_session", train_multi_session.main,
         ["--eids", *REAL, "--base_path", base, "--device", "cpu",
          "--num_epochs", "1", "--pad_multiple", "32"] + MM_FLAGS
         + SMALL_MM),
        ("eval_multi_modal_multi_session", eval_multi_modal.main,
         ["--multi_session", "--model_dir", str(multi_dir), "--device",
          "cpu", "--use_MtM"]),
    ]
    out, served = {}, {}
    with chip_smoke.hub_stand_in(_real_rows()) as hub:
        for name, main, argv in runs:
            n = len(hub.loaded)
            out[name] = main(argv)
            served[name] = hub.loaded[n:]
    return out, served, base, multi_dir


REAL_SERVED = {
    "train_baseline": ["etl-0_aligned"],
    "eval_baseline": ["etl-0_aligned"],
    "train_multi_modal": ["etl-0_aligned"],
    "eval_multi_modal": ["etl-0_aligned"],
    "eval_multi_modal_unaligned": ["etl-0_unaligned"],
    "train_multi_session": ["etl-0_aligned", "etl-1_aligned"],
    "eval_multi_modal_multi_session": ["etl-0_aligned", "etl-1_aligned"],
}


@pytest.mark.parametrize("run", list(REAL_SERVED))
def test_real_session_scripts_run(real_runs, run):
    """Without ``--synthetic`` each script loads its sessions from the
    hub's rows (here the stand-in's) and gives finite results."""
    out, served, base, multi_dir = real_runs
    assert served[run] == [f"neurofm123/{n}" for n in REAL_SERVED[run]]
    result = out[run]
    if run.startswith("train"):
        best = [v for k, v in result.items()
                if k.startswith("best_") and k != "best_epoch"]
        assert best and all(math.isfinite(v) for v in best)
        assert all(math.isfinite(x) for row in result["history"]
                   for x in row.get("step_losses", [row["train_loss"]]))
    else:
        assert result and all(_finite_or_nan(v) for v in (
            result.values() if "multi_session" not in run
            else result["mean_over_sessions"].values()))
    if run == "eval_multi_modal_unaligned":
        assert set(result) == set(out["eval_multi_modal"]) - {
            k for k in out["eval_multi_modal"] if k.startswith("per_neuron")}
    if run == "train_multi_session":
        sessions = json.loads((multi_dir / "sessions.json").read_text())
        assert sessions == {"eids": REAL, "num_neurons": [24, 30],
                            "n_max": 32}
    if run == "eval_multi_modal_multi_session":
        assert set(result) == {*REAL, "mean_over_sessions"}


@pytest.mark.parametrize("script,argv", [
    ("train_baseline", []), ("eval_baseline", []),
    ("train_multi_modal", []), ("eval_multi_modal", []),
    ("eval_multi_modal", ["--unaligned"]),
    ("eval_multi_modal", ["--reference_ckpt", "x.pt"]),
    ("train_multi_session", ["--eids", "x", "y"])],
    ids=lambda v: " ".join(v) if isinstance(v, list) else v)
def test_real_sessions_need_datasets(script, argv, tmp_path, monkeypatch):
    """No fallback to synthetic data: without ``datasets`` a real session
    raises ``ImportError``."""
    monkeypatch.setitem(sys.modules, "datasets", None)
    main, base = _script_args(script, tmp_path)
    with pytest.raises(ImportError):
        main(argv + base)


TORCHRUN = [
    ("train_multi_modal", COMMON + MM_FLAGS + SMALL_MM + ["--tp", "2"]),
    ("train_baseline", COMMON + ["--dp", "2", "--direction", "decoding"]),
]


@pytest.mark.parametrize("script,argv", TORCHRUN,
                         ids=[s for s, _ in TORCHRUN])
def test_train_scripts_as_two_gloo_ranks(script, argv, tmp_path):
    """torchrun starts two ranks on the CPU (``--backend gloo``): one epoch
    of ``train_multi_modal --tp 2`` or ``train_baseline --dp 2``, one
    metrics file written by rank 0 with a finite loss, and a checkpoint in
    the single-device layout that one process loads."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m",
           f"multi_modal_foundation_model_tpu_torch.scripts.{script}"]
    cmd += argv + ["--num_epochs", "1", "--device", "cpu", "--backend",
                   "gloo", "--base_path", str(tmp_path)]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, (out.stdout + out.stderr)[-4000:]
    (metrics,) = Path(tmp_path).rglob("metrics.jsonl")
    rows = [json.loads(ln) for ln in metrics.read_text().splitlines()]
    epochs = [r for r in rows if "epoch" in r]
    assert len(epochs) == 1 and math.isfinite(epochs[0]["train_loss"])
    tree = torch.load(metrics.parent / "model_last.pt", weights_only=True)
    if script == "train_multi_modal":
        from multi_modal_foundation_model_tpu_torch.eval import loading
        from multi_modal_foundation_model_tpu_torch.data.session import (
            synthetic_splits)
        model, _ = loading.load_model_data_local(
            model_dir=str(metrics.parent), checkpoint_name="last",
            test_session=synthetic_splits(seed=42, n_trials=40,
                                          n_neurons=24).test,
            device="cpu")
        assert model.encoder[0].attn.n_heads == 2     # the whole model
        assert all(torch.equal(model.state_dict()[k], v)
                   for k, v in tree["model"].items())
    else:
        assert tree["model"]["layer.weight"].shape == (2, 24)
