"""Rank workers of the port's data- and tensor-parallel tests.

Each rank is a process of its own, joined over gloo on the CPU, one torch
thread each; this module imports torch and the port only (no JAX), so the
workers start fast and stay small:

    python tests/torch_parallel_workers.py SPEC.json RANK WORLD PORT

``SPEC.json`` holds the geometry, the trainer settings, the mesh (``dp``,
``tp``), the initial ``state_dict`` file (``init``) and the output file
(``out``). ``run`` builds a ``MultiModalTrainer`` under the mesh (``None``
for one process), takes the first ``steps`` batches of epoch 0, and
returns: the step-0 loss and gradients (summed over the data group, the
shards gathered into the single-device layout), the data ranks' masked
counts and the mean of their own masked means (what averaging per-rank
losses would train on), whether every replicated
gradient is bit-equal across the model group, the losses of ``steps``
optimizer steps on those batches, the parameters after them (gathered),
whether they are bit-equal across the data group, the eval loss and R²
(predictions gathered over the data group) and (``save``) a ``last``
checkpoint. ``run_baseline`` does the same for the decoding
``BaselineTrainer``. ``run_ms`` trains the stitched toy model's
``MultiSessionTrainer`` (``MS_SESSIONS``) one epoch on each of the spec's
``paths`` (host batches, resident data at K = 1 or 2, session-mixed
batches, sharded resident sessions; a fresh trainer from ``init`` each)
and returns per path its step losses, the parameters after the epoch
(gathered), the equality checks, the step-0 loss and gradients (``grads``
paths), the eval and (``sharded``) the rank's resident block; ``run_mm``
does the epoch for the single-session trainer's resident path. ``Ranks``
starts the ranks (``launch`` also waits) and returns rank 0's result; a
rank that fails fails the call with its output.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from multi_modal_foundation_model_tpu_torch.data import loader as tloader  # noqa: E402
from multi_modal_foundation_model_tpu_torch.data import session as tsession  # noqa: E402
from multi_modal_foundation_model_tpu_torch.models import multimodal as tmm  # noqa: E402
from multi_modal_foundation_model_tpu_torch.models.baseline import (  # noqa: E402
    BaselineDecoder)
from multi_modal_foundation_model_tpu_torch.ops.masking import (  # noqa: E402
    MaskParams, RegionTable)
from multi_modal_foundation_model_tpu_torch.parallel import (  # noqa: E402
    build_mesh, full_state_dict, gather_full, initialize_multihost)
from multi_modal_foundation_model_tpu_torch.parallel.mesh import (  # noqa: E402
    all_gather_cat, all_reduce_many_)
from multi_modal_foundation_model_tpu_torch.train import (  # noqa: E402
    BaselineTrainer, MultiModalTrainer, MultiSessionTrainer, OptimizerConfig,
    TrainerConfig, build_multisession_loaders)

WORKER = Path(__file__).resolve()


def loaders(spec):
    g = spec["geometry"]
    n_ap, T = g["n_channels"]["ap"], g["max_F"]
    sp = tsession.synthetic_splits(seed=0, n_trials=spec["n_trials"],
                                   n_neurons=n_ap, n_timesteps=T)
    kw = dict(batch_size=spec["batch_size"], max_time_length=T,
              max_space_length=n_ap)
    return (tloader.make_loader(sp.train, **kw),
            tloader.make_loader(sp.val, shuffle=False, **kw))


def trainer(spec, mesh):
    """The spec's ``MultiModalTrainer`` under ``mesh``, from ``init``."""
    cfg = tmm.MultiModalConfig(
        **spec["geometry"], dropout=spec["dropout"],
        embed_dropout=spec["embed_dropout"],
        mask_params=MaskParams(**spec["mask"]),
        remat_layers=spec.get("remat", True))
    model = tmm.MultiModal(cfg, device="cpu")
    model.load_state_dict(torch.load(spec["init"], weights_only=True))
    train, val = loaders(spec)
    tcfg = TrainerConfig(**{**dict(
        num_epochs=2, log_dir=spec["log_dir"], seed=0, mask_type="input",
        mask_mode=tuple(spec["menu"]), mixed_training=spec["mixed"],
        eval_every=10 ** 9), **spec.get("tcfg", {})})
    opt = OptimizerConfig(lr=1e-3, max_grad_norm=spec.get("max_grad_norm"))
    return MultiModalTrainer(model, train, val, opt, tcfg, mesh=mesh)


def _equal_over(t: torch.Tensor, group) -> bool:
    """Whether ``t`` is bit-equal on every rank of ``group``."""
    if group is None:
        return True
    parts = all_gather_cat(t[None], group)
    return bool((parts == parts[:1]).all())


def run(spec, mesh):
    tr = trainer(spec, mesh)
    tr.train_dataloader.set_epoch(0)
    tr._reseed_host_rng(0)
    steps = []
    for batch, _ in zip(tr.train_dataloader, range(spec["steps"])):
        steps.append((tr._device_batch(batch), tr._sample_modes()))

    # step 0's loss and gradients, without an update
    batch, (mode, scheme) = steps[0]
    out = tr.step_loss(batch, mode, scheme, step=0)
    params = dict(tr.model.named_parameters())
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        params.values(), torch.autograd.grad(out.loss, list(params.values()),
                                             allow_unused=True))]
    if mesh is not None:
        all_reduce_many_(grads, mesh.data_group)
    model_group = None if mesh is None else mesh.model_group
    replicated_equal = all(
        _equal_over(g, model_group) for p, g in zip(params.values(), grads)
        if getattr(p, "tp_dim", None) is None)
    full_grads = {n: gather_full(g, getattr(p, "tp_dim", None), mesh)
                  for (n, p), g in zip(params.items(), grads)}
    # what each rank's own masked mean would give (DDP's default)
    n_local = sum(out.mod_n_examples.values())
    own_mean = (sum(out.mod_loss.values()) / n_local.clamp_min(1.0)).detach()
    counts = n_local.reshape(1)
    if mesh is not None:
        own_mean = all_gather_cat(own_mean.reshape(1), mesh.data_group)
        counts = all_gather_cat(counts, mesh.data_group)

    losses = [float(tr.train_step(b, m, s)) for b, (m, s) in steps]
    data_group = None if mesh is None else mesh.data_group
    data_equal = all(_equal_over(p.detach(), data_group)
                     for p in params.values())
    if spec.get("save"):
        tr.save_model("last", epoch=0)
    ev = tr.eval_epoch()
    return dict(loss0=float(out.loss.detach()), grads=full_grads,
                eval_loss=ev["eval_loss"],
                eval_r2=ev["eval_trial_avg_r2"],
                losses=losses, mean_of_means=float(own_mean.mean()),
                counts=counts.tolist(),
                modes=[m for _, m in steps],
                params=full_state_dict(tr.model, mesh),
                replicated_equal=replicated_equal, data_equal=data_equal)


def run_baseline(spec, mesh):
    """The decoding baseline's losses over ``steps`` batches and its
    parameters after them."""
    train, val = loaders(spec)
    g = spec["geometry"]
    model = BaselineDecoder(g["n_channels"]["ap"], g["n_channels"]["behavior"],
                            device="cpu")
    model.load_state_dict(torch.load(spec["init"], weights_only=True))
    tcfg = TrainerConfig(num_epochs=2, log_dir=spec["log_dir"], seed=0)
    tr = BaselineTrainer(model, train, val, OptimizerConfig(lr=1e-3), tcfg,
                         modal_filter={"input": ["ap"],
                                       "output": ["behavior"]},
                         mesh=mesh)
    train.set_epoch(0)
    losses = [float(tr.train_step(tr._data_dict(b)))
              for b, _ in zip(train, range(spec["steps"]))]
    return dict(losses=losses, params=tr.model.state_dict(),
                eval=tr.eval_epoch()["eval_trial_avg_r2"])


# the multi-session toy: three sessions (neurons, trials) of 11 train
# trials each (one resident shape: JAX compiles its K = 1 step once),
# padded to 64 channels in one bucket: six batches of 8 an epoch, three of
# them padded tails; five session-mixed batches
MS_SESSIONS = ((24, 14), (41, 14), (61, 14))


def ms_loaders(spec):
    T = spec["geometry"]["max_F"]
    sessions = {f"s{i}": tsession.synthetic_splits(
                    seed=i, n_trials=nt, n_neurons=n, n_timesteps=T,
                    eid=f"s{i}")
                for i, (n, nt) in enumerate(MS_SESSIONS)}
    return build_multisession_loaders(
        sessions, batch_size=spec["batch_size"], max_time_length=T,
        pad_multiple=32)


def ms_trainer(spec, mesh, log_dir, **over):
    """The spec's ``MultiSessionTrainer`` under ``mesh`` from ``init``,
    ``over`` on its ``TrainerConfig``."""
    train, val, _, meta = ms_loaders(spec)
    table = RegionTable.build(meta["per_session_region_ids"],
                              region_vocab=meta["region_vocab"],
                              device="cpu")
    g = dict(spec["geometry"], n_channels={"ap": meta["n_max"],
                                           "behavior": 2})
    cfg = tmm.MultiModalConfig(
        **g, n_sessions=len(meta["eids"]), dropout=spec["dropout"],
        embed_dropout=spec["embed_dropout"],
        mask_params=MaskParams(**spec["mask"]), remat_layers=False)
    model = tmm.MultiModal(cfg, device="cpu")
    model.load_state_dict(torch.load(spec["init"], weights_only=True))
    tcfg = TrainerConfig(**{**dict(
        num_epochs=4, log_dir=str(log_dir), seed=0, mask_type="input",
        mask_mode=tuple(spec["menu"]), mixed_training=spec["mixed"],
        eval_every=10 ** 9), **over})
    return MultiSessionTrainer(
        model, train, val, OptimizerConfig(lr=1e-3,
                                           max_grad_norm=spec.get(
                                               "max_grad_norm")),
        tcfg, region_table=table, eid_to_sid=meta["eid_to_sid"], mesh=mesh)


def _step0(tr, mesh):
    """The step-0 loss and gradients of ``tr``'s first host batch of epoch
    0 (summed over the data group, gathered), without an update, and
    whether the replicated gradients are bit-equal over the model group."""
    tr._reseed_host_rng(0)
    eid = tr._epoch_schedule(0)[0]
    loader = tr.train_loaders[eid]
    loader.set_epoch(0)
    batch = tr._device_batch(next(iter(loader)))
    mode, scheme = tr._sample_modes()
    out = tr.step_loss(batch, mode, scheme, step=0,
                       session=tr.eid_to_sid[eid])
    params = dict(tr.model.named_parameters())
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        params.values(), torch.autograd.grad(out.loss, list(params.values()),
                                             allow_unused=True))]
    if mesh is not None:
        all_reduce_many_(grads, mesh.data_group)
    model_group = None if mesh is None else mesh.model_group
    replicated_equal = all(
        _equal_over(g, model_group) for p, g in zip(params.values(), grads)
        if getattr(p, "tp_dim", None) is None)
    return dict(loss0=float(out.loss.detach()), replicated_equal=replicated_equal,
                grads={n: gather_full(g, getattr(p, "tp_dim", None), mesh)
                       for (n, p), g in zip(params.items(), grads)})


def _epoch(tr, mesh, name, save):
    """One epoch of ``tr``: its losses, host draws, parameters after it
    (gathered, copied), their equality over the data group, the eval."""
    modes = []
    one, group = tr._sample_modes, tr._sample_group_modes
    tr._sample_modes = lambda: modes.append(one()) or modes[-1]
    tr._sample_group_modes = lambda n: modes.append(group(n)) or modes[-1]
    losses = tr.train_epoch(0)["step_losses"]
    tr._sample_modes, tr._sample_group_modes = one, group
    data_group = None if mesh is None else mesh.data_group
    out = dict(losses=losses, modes=modes, step=tr.step,
               data_equal=all(_equal_over(p.detach(), data_group)
                              for p in tr.model.parameters()),
               params={k: v.clone() for k, v in
                       full_state_dict(tr.model, mesh).items()})
    if save:
        tr.save_model("last", epoch=0)
    ev = tr.eval_epoch()
    out.update(eval_loss=ev["eval_loss"], eval_r2=ev["eval_trial_avg_r2"])
    return out


def run_ms(spec, mesh):
    res = {}
    for path in spec["paths"]:
        name = path["name"]
        tr = ms_trainer(spec, mesh, Path(spec["log_dir"]) / name,
                        **path["over"])
        r = _step0(tr, mesh) if path.get("grads") else {}
        r.update(_epoch(tr, mesh, name, path.get("save", False)))
        if tr.tcfg.shard_resident_sessions:
            block = tr._sharded_cache[tuple(tr.train_loaders)]
            data = block[1]
            r["resident_bytes"] = sum(
                t.numel() * t.element_size() for k, t in data.items()
                if k != "session_ids")
            r["rows"] = int(data["spikes_data"].shape[0])
            r["pools"] = block[3]
            r["replicated_bytes"] = sum(
                t.numel() * t.element_size() for k, t in
                tr._stacked(tuple(tr.train_loaders))[1].items())
        res[name] = r
    return res


def run_mm(spec, mesh):
    """The single-session trainer's resident path: per ``paths`` entry one
    epoch from ``init``, its losses and the parameters after it."""
    res = {}
    for path in spec["paths"]:
        tr = trainer(dict(spec, tcfg=path["over"], log_dir=str(
            Path(spec["log_dir"]) / path["name"])), mesh)
        res[path["name"]] = _epoch(tr, mesh, path["name"], False)
    return res


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """``world`` gloo ranks running ``spec``, started at once; ``result``
    waits for them and returns rank 0's result (a rank that failed raises
    with its output; every rank is killed on the way out)."""

    def __init__(self, spec: dict, world: int, tmp: Path):
        tmp.mkdir(parents=True, exist_ok=True)
        self.out = tmp / "result.pt"
        path = tmp / "spec.json"
        path.write_text(json.dumps(dict(spec, out=str(self.out))))
        port = _free_port()
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
        self.procs = [subprocess.Popen(
            [sys.executable, str(WORKER), str(path), str(r), str(world),
             str(port)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]

    def result(self, timeout: float = 240.0):
        outs = []
        try:
            for p in self.procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
        for r, (p, out) in enumerate(zip(self.procs, outs)):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} exited {p.returncode}:\n{out}")
        return torch.load(self.out, weights_only=False)


def launch(spec: dict, world: int, tmp: Path):
    """Run ``spec`` as ``world`` gloo ranks; rank 0's result."""
    return Ranks(spec, world, tmp).result()


def main(argv):
    spec_path, rank, world, port = argv
    torch.set_num_threads(1)
    spec = json.loads(Path(spec_path).read_text())
    initialize_multihost(f"localhost:{port}", int(world), int(rank),
                         backend="gloo", device="cpu")
    mesh = build_mesh(spec["dp"], spec["tp"])
    fn = {"baseline": run_baseline, "ms": run_ms, "mm": run_mm}.get(
        spec.get("kind"), run_baseline if spec.get("baseline") else run)
    result = fn(spec, mesh)
    if int(rank) == 0:
        torch.save(result, spec["out"])
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
