"""The port's figures against the JAX package's.

Every function of ``utils/plotting.py`` and ``draw_mask_ratio`` gets the
same numpy inputs (made from a seed) in both packages; the figures then
hold the same artists: the axes, each line's x/y data, colour, style and
label, each image's array and colour limits, the filled areas' vertices,
every title, axis label, legend entry and suptitle (arrays to rtol 1e-6).
The trainers' ``_plot_epoch`` (plain and ``best_``) and the harnesses'
``save_plot`` branches (per_neuron aligned and unaligned, the baseline's
modal_spike) write JAX's file names from the same converted weights, and
the trainers' epoch loops draw when JAX's do.
"""

import importlib.util
import types
from pathlib import Path

import jax
import numpy as np
import pytest

import torch_parity as tp
from multi_modal_foundation_model_tpu.data import loader as jloader
from multi_modal_foundation_model_tpu.data import session as jsession
from multi_modal_foundation_model_tpu.eval import baseline_harness as jbh
from multi_modal_foundation_model_tpu.eval import harness as jharness
from multi_modal_foundation_model_tpu.eval.metrics import (
    create_behavior_conditions)
from multi_modal_foundation_model_tpu.models import baseline as jbaseline
from multi_modal_foundation_model_tpu.train import trainer as jtrainer
from multi_modal_foundation_model_tpu.utils import plotting as jplot
from multi_modal_foundation_model_tpu_torch.data import loader as tloader
from multi_modal_foundation_model_tpu_torch.data import session as tsession
from multi_modal_foundation_model_tpu_torch.eval import baseline_harness
from multi_modal_foundation_model_tpu_torch.eval import harness
from multi_modal_foundation_model_tpu_torch.models import baseline as tbase
from multi_modal_foundation_model_tpu_torch.models import multimodal as tmm
from multi_modal_foundation_model_tpu_torch.scripts import draw_mask_ratio
from multi_modal_foundation_model_tpu_torch.train import trainer as ttrainer
from multi_modal_foundation_model_tpu_torch.utils import plotting as tplot
from multi_modal_foundation_model_tpu_torch.utils.convert import (
    baseline_params_from_jax)

import matplotlib  # noqa: E402  (after the packages: JAX's sets Agg)

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-6
K, T, N = 24, 30, 6


def _arr(x):
    return np.ma.filled(np.ma.asarray(x, dtype=np.float64), np.nan)


def _axes_record(ax):
    legend = ax.get_legend()
    return dict(
        titles=[ax.get_title(loc) for loc in ("left", "center", "right")],
        xlabel=ax.get_xlabel(), ylabel=ax.get_ylabel(),
        xticks=_arr(ax.get_xticks()), yticks=_arr(ax.get_yticks()),
        lines=[dict(x=_arr(ln.get_xdata()), y=_arr(ln.get_ydata()),
                    color=ln.get_color(), style=ln.get_linestyle(),
                    width=ln.get_linewidth(), alpha=ln.get_alpha(),
                    label=ln.get_label()) for ln in ax.get_lines()],
        images=[dict(a=_arr(im.get_array()), clim=_arr(im.get_clim()),
                     cmap=im.get_cmap().name) for im in ax.get_images()],
        fills=[[_arr(p.vertices) for p in c.get_paths()]
               for c in ax.collections],
        texts=[t.get_text() for t in ax.texts],
        legend=None if legend is None else [t.get_text()
                                            for t in legend.get_texts()],
        visible_spines={k: s.get_visible() for k, s in ax.spines.items()})


def _record(fig):
    sup = fig._suptitle
    return dict(suptitle=None if sup is None else sup.get_text(),
                size=tuple(fig.get_size_inches()),
                axes=[_axes_record(ax) for ax in fig.axes])


def _same(a, b, where="fig"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.shape == b.shape, where
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=0, err_msg=where)
    else:
        assert a == b, (where, a, b)


def _both(fn_name, *args, **kwargs):
    """JAX's and the port's figure of ``fn_name`` on the same inputs."""
    figs = [getattr(mod, fn_name)(*args, **kwargs) for mod in (jplot, tplot)]
    recs = [_record(f) for f in figs]
    plt.close("all")
    _same(*recs)
    return recs[1]


def _data(seed=0):
    rng = np.random.default_rng(seed)
    gt = rng.poisson(1.0, (K, T, N)).astype(np.float64)
    pred = gt + rng.normal(scale=0.5, size=gt.shape)
    choice = rng.choice([-1.0, 1.0], K)
    reward = rng.choice([0.0, 1.0], K)
    block = rng.choice([0.2, 0.5, 0.8], K)
    X, name2idx, tasks, value2label, _ = create_behavior_conditions(
        choice, reward, block, T=T)
    # a behavior trace as a 4th column of X, for the behavior rasters
    X = np.concatenate([X, rng.normal(size=(K, T, 1))], axis=-1)
    return gt, pred, X, name2idx, tasks, value2label


def test_plot_gt_pred():
    gt, pred, *_ = _data()
    rec = _both("plot_gt_pred", gt.mean(0).T, pred.mean(0).T, epoch=3,
                modality="ap")
    assert len(rec["axes"]) == 4            # two panels, two colour bars


def test_plot_neurons_r2():
    gt, pred, *_ = _data()
    rec = _both("plot_neurons_r2", gt.mean(0), pred.mean(0), epoch=2,
                neuron_idx=[0, 3, 5], modality="ap")
    assert len(rec["axes"]) == 3


@pytest.mark.parametrize("labels", [True, False])
def test_plot_single_cell_psth(labels):
    gt, pred, X, name2idx, tasks, value2label = _data(1)
    _both("plot_single_cell_psth", X, gt[:, :, 0], pred[:, :, 0], tasks,
          name2idx, var_value2label=value2label if labels else None,
          neuron_idx=4, neuron_region="CA1", method="mm",
          r2_pair=(0.25, 0.5))


def test_plot_condition_avg_r2():
    gt, pred, *_ = _data(2)
    gt[1::2] = gt[0::2]                      # repeated trials: conditions
    _both("plot_condition_avg_r2", gt, pred, epoch=1, neuron_idx=2,
          condition_idx=1, first_n=3)


def test_raster_plot_and_cluster_order():
    gt, pred, *_ = _data(3)
    recs = []
    for mod in (jplot, tplot):
        fig, axes = plt.subplots(1, 2)
        mod.raster_plot(gt[:, :, 0], 2.0, -1.0, True, "obs.", axes[0],
                        aligned_tbins=(5, 12))
        mod.raster_plot(pred[:, :, 1], 0.0, 0.0, False, None, axes[1],
                        cmap="viridis")
        recs.append(_record(fig))
        plt.close("all")
    _same(*recs)
    for y, n in ((pred[:, :, 0], 4), (pred[:3, :, 1], 8)):
        np.testing.assert_array_equal(tplot._cluster_trial_order(y, n),
                                      jplot._cluster_trial_order(y, n))


@pytest.mark.parametrize("subtract", ["task", "global", None])
def test_plot_single_trial_activity(subtract):
    gt, pred, X, name2idx, tasks, _ = _data(4)
    name2idx = dict(name2idx, wheel=[3])
    recs = []
    for mod in (jplot, tplot):
        fig, axes = plt.subplots(5, 1)
        mod.plot_single_trial_activity(X, gt[:, :, 0], pred[:, :, 0],
                                       name2idx, ["wheel"], tasks, axes,
                                       subtract_psth=subtract,
                                       aligned_tbins=(10,))
        recs.append(_record(fig))
        plt.close("all")
    _same(*recs)


@pytest.mark.parametrize("behaviors", [(), ("wheel",)])
def test_viz_single_cell_figure(behaviors):
    gt, pred, X, name2idx, tasks, value2label = _data(5)
    name2idx = dict(name2idx, wheel=[3])
    _both("viz_single_cell_figure", X, gt[:, :, 2], pred[:, :, 2], tasks,
          name2idx, var_value2label=value2label, var_behlist=behaviors,
          neuron_idx=2, neuron_region="PO", method="mm", r2_pair=(0.1, 0.2))


@pytest.mark.parametrize("r2", [0.4, None])
def test_viz_single_cell_unaligned_figure(r2):
    gt, pred, *_ = _data(6)
    _both("viz_single_cell_unaligned_figure", gt[:, :, 1], pred[:, :, 1],
          neuron_idx=3, neuron_region="PO", method="mm", r2=r2)


def _jax_draw_main():
    spec = importlib.util.spec_from_file_location(
        "jax_draw_mask_ratio", ROOT / "scripts" / "draw_mask_ratio.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("linear", [False, True])
def test_draw_mask_ratio(linear, tmp_path, monkeypatch):
    rng = np.random.default_rng(7)
    ratios = ["0.1", "0.3", "0.5"]
    for r in ratios[:2]:                   # 0.5 has no artifacts: skipped
        d = tmp_path / "sweep" / f"ratio-{r}"
        (d / "modal_behavior").mkdir(parents=True)
        (d / "modal_spike").mkdir()
        np.save(d / "modal_behavior" / "r2.npy", {
            f"{b}_r2_{k}": float(rng.normal())
            for b in draw_mask_ratio.BEHAV_MOD for k in ("psth", "trial")})
        np.save(d / "modal_spike" / "bps.npy", rng.normal(size=9))
    argv = ["--result_dir", str(tmp_path / "sweep"), "--mask_ratios",
            *ratios] + (["--show_linear_baseline"] if linear else [])
    monkeypatch.setattr("sys.argv", ["draw_mask_ratio.py", *argv, "--out",
                                     str(tmp_path / "j.png")])
    _jax_draw_main().main()
    want = _record(plt.gcf())
    plt.close("all")
    got = _record(draw_mask_ratio.main(argv + ["--out",
                                               str(tmp_path / "t.png")]))
    plt.close("all")
    _same(want, got)
    assert (tmp_path / "t.png").exists()
    j = _jax_draw_main()
    assert (j.LINEAR_ENCODING_BASELINE, j.LINEAR_DECODING_BASELINE,
            j.FOURM_ENCODING_BASELINE, j.FOURM_DECODING_BASELINE) == (
        draw_mask_ratio.LINEAR_ENCODING_BASELINE,
        draw_mask_ratio.LINEAR_DECODING_BASELINE,
        draw_mask_ratio.FOURM_ENCODING_BASELINE,
        draw_mask_ratio.FOURM_DECODING_BASELINE)


# --- the trainers' and harnesses' files -------------------------------------

def _pngs(path):
    return sorted(p.name for p in Path(path).glob("*.png"))


class _Logger:
    def __init__(self):
        self.figures = []

    def log_figures(self, figs, extra=None):
        self.figures.append((sorted(figs), extra))


@pytest.mark.parametrize("prefix", ["", "best_"])
def test_plot_epoch_writes_jax_files(prefix, tmp_path):
    """The trainers' ``_plot_epoch`` on one eval result: the same files,
    byte for byte, and the same figures handed to the logger."""
    gt, pred, *_ = _data(8)
    beh = gt[:, :, :2] * 0.1
    eval_res = {"eval_gt": {"ap": gt, "behavior": beh},
                "eval_preds": {"ap": pred, "behavior": beh + 0.05}}
    active = [[5, 1, 3, 0, 2, 4]]
    cases = [(jtrainer.MultiModalTrainer, ttrainer.MultiModalTrainer,
              {"output": ["ap", "behavior"]}, eval_res),
             (jtrainer.BaselineTrainer, ttrainer.BaselineTrainer,
              {"output": ["behavior"]},
              {"eval_gt": beh, "eval_preds": beh + 0.05})]
    for i, (jcls, tcls, modal_filter, res) in enumerate(cases):
        out = {}
        for side, cls in (("j", jcls), ("t", tcls)):
            d = tmp_path / f"{i}{side}"
            d.mkdir()
            me = types.SimpleNamespace(
                modal_filter=modal_filter, session_active_neurons=active,
                tcfg=types.SimpleNamespace(log_dir=str(d)), mesh=None,
                logger=_Logger())
            cls._plot_epoch(me, res, 4, prefix=prefix)
            out[side] = (d, me.logger.figures)
        (jd, jfigs), (td, tfigs) = out["j"], out["t"]
        assert _pngs(td) == _pngs(jd) and _pngs(td)
        assert all(n.startswith(prefix) for n in _pngs(td))
        for name in _pngs(td):
            assert (td / name).read_bytes() == (jd / name).read_bytes(), name
        assert tfigs == jfigs


def test_trainers_draw_when_jax_does(tmp_path):
    """``train()`` with ``save_plot_every_n_epochs=2`` over 3 epochs: the
    epoch-0 and epoch-2 figures, and a ``best_`` set on each new best
    (JAX :766-775, :1041); the multi-session eval draws nothing."""
    from multi_modal_foundation_model_tpu_torch.train import (
        MultiModalTrainer, OptimizerConfig, TrainerConfig)

    sp = tsession.synthetic_splits(seed=0, n_trials=40, n_neurons=tp.N_AP,
                                   n_timesteps=tp.T)
    kw = dict(batch_size=8, max_time_length=tp.T, max_space_length=tp.N_AP)
    train = tloader.make_loader(sp.train, shuffle=False, **kw)
    val = tloader.make_loader(sp.val, shuffle=False, **kw)
    model = tmm.MultiModal(tmm.MultiModalConfig(**tp.TOY), device="cpu")
    tr = MultiModalTrainer(model, train, val, OptimizerConfig(lr=1e-3),
                           TrainerConfig(num_epochs=3, log_dir=str(tmp_path),
                                         save_plot_every_n_epochs=2))
    res = tr.train()
    names = set(_pngs(tmp_path))
    want = {f"{kind}_fig_{mod}_{e}.png" for kind in ("gt_pred", "r2")
            for mod in ("ap", "behavior") for e in (0, 2)}
    bests, best = [], -float("inf")
    for row in res["history"]:
        if row["eval_trial_avg_r2"] > best:
            bests.append(row["epoch"])
            best = row["eval_trial_avg_r2"]
    want |= {f"best_{kind}_fig_{mod}_{e}.png" for kind in ("gt_pred", "r2")
             for mod in ("ap", "behavior") for e in bests}
    assert names == want
    assert tr.session_active_neurons and len(tr.session_active_neurons[0]) \
        == min(50, tp.N_AP)


def _eval_pair(tmp_path):
    channels = {"ap": tp.N_AP, "behavior": 2}
    jmodel, jparams = tp.jax_model(attn_impl="xla", seed=5,
                                   n_channels=channels)
    tmodel = tp.port_model(jparams, n_channels=channels)
    kw = dict(batch_size=20, max_time_length=tp.T, max_space_length=tp.N_AP)
    split = dict(seed=0, n_trials=100, n_neurons=tp.N_AP, n_timesteps=tp.T)
    jl = jloader.make_loader(jsession.synthetic_splits(**split).test,
                             shuffle=False, **kw)
    tl = tloader.make_loader(tsession.synthetic_splits(**split).test,
                             shuffle=False, **kw)
    return jmodel, jparams, tmodel, jl, tl


@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "unaligned"])
def test_harness_save_plot_writes_jax_files(aligned, tmp_path):
    """per_neuron with ``save_plot``: the first ``max_plots`` neurons'
    figures, JAX's names (region, neuron, R² to 2 places, method)."""
    jmodel, jparams, tmodel, jl, tl = _eval_pair(tmp_path)
    kw = dict(n_time_steps=tp.T, is_aligned=aligned, save_plot=True,
              max_plots=3, method_name="mm_test", chunk=8)
    jharness.co_smoothing_eval(jmodel, jparams, jl, "per_neuron",
                               save_path=str(tmp_path / "j"), **kw)
    harness.co_smoothing_eval(tmodel, tl, "per_neuron",
                              save_path=str(tmp_path / "t"), **kw)
    names = _pngs(tmp_path / "t")
    assert names == _pngs(tmp_path / "j") and len(names) == 3
    assert all(n.endswith("_mm_test.png") for n in names)


def test_baseline_harness_save_plot_writes_jax_files(tmp_path):
    sp = dict(seed=1, n_trials=120, n_neurons=tp.N_AP, n_timesteps=tp.T)
    loaders = [m.make_loader(s.synthetic_splits(**sp).test, batch_size=24,
                             max_time_length=tp.T,
                             max_space_length=tp.N_AP, shuffle=False)
               for m, s in ((jloader, jsession), (tloader, tsession))]
    batch = next(iter(loaders[0]))
    jm = jbaseline.BaselineEncoder(in_channel=2, out_channel=tp.N_AP,
                                   seq_len=tp.T)
    params = jm.init(jax.random.PRNGKey(2), {
        "inputs": batch["target"], "targets": batch["spikes_data"]})["params"]
    tm = tbase.BaselineEncoder(2, tp.N_AP, seq_len=tp.T, device="cpu")
    tm.load_state_dict(baseline_params_from_jax(params), strict=True)
    kw = dict(modal_filter={"input": ["behavior"], "output": ["ap"]},
              held_out_list=list(range(tp.T)), n_time_steps=tp.T,
              save_plot=True, max_plots=2)
    jbh.co_smoothing_eval_baseline(jm, params, loaders[0], "modal_spike",
                                   save_path=str(tmp_path / "j"), **kw)
    baseline_harness.co_smoothing_eval_baseline(
        tm, loaders[1], "modal_spike", save_path=str(tmp_path / "t"), **kw)
    names = _pngs(tmp_path / "t")
    assert names == _pngs(tmp_path / "j") and len(names) == 2
    assert all(n.endswith("_linear.png") for n in names)
