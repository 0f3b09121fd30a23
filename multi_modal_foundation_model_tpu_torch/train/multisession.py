"""Multi-session pretraining: session-stitched model, interleaved loaders.

Port of ``multi_modal_foundation_model_tpu/train/multisession.py``:

- **Loaders** (``build_multisession_loaders``, JAX :94-153): one region
  vocabulary shared by all sessions, each session's space axis padded to
  its bucket's width (``_bucket_session_widths``, :42-91: sessions sorted
  by neuron count, cut into at most ``n_buckets`` contiguous groups by an
  exact DP over padded cells), and the ``meta`` dict.
- **Schedule** (``MultiSessionTrainer``, :156): every batch holds one
  session's trials; an epoch interleaves every session's batches in the
  order ``np.random.default_rng((seed, epoch, 7))`` shuffles them to
  (``_epoch_schedule``), and the one-cycle schedule counts every session's
  batches (``_steps_per_epoch``).
- **Streaming** (the default): host batches, each step run eagerly with
  its session id in the step's row.
- **Resident** (``device_resident_data``): each shape bucket's train splits
  are stacked into ONE resident block with per-session trial offsets
  (``_stacked_train_data``, :393), and every step gathers from its
  bucket's block by offset-shifted indices, its session id riding in the
  step's row (``train/trainer.py`` ``_RowLayout``). The stitched
  tokenizers' and head's rows, the session embedding and the region
  table's row are gathered on the device by that id, so one captured
  graph serves every session of a bucket: graphs are keyed by (bucket
  width, batch, variant). The schedules are JAX's: K = 1 runs the
  interleave step by step; ``steps_per_dispatch = K > 1`` with
  ``stacked_scan`` and one bucket keeps the K = 1 interleave in groups of
  K crossing sessions (:848-900), so without mixed training its
  trajectory is K = 1's step for step; otherwise each session's batches
  form K-groups, shuffled by ``(seed, epoch, 7)`` (:902-941). Steps left
  over from a group run as single steps.
- **Session-mixed batches** (``mixed_session_batches``, resident only, JAX
  :726-789): per bucket one permutation of the block's trials from
  ``(seed, epoch, 11[, bucket])``, cut into full B-batches with one
  valid-masked tail, in K-groups; with several buckets the groups are
  shuffled by ``(seed, epoch, 13)``. A batch's per-sample session ids are
  gathered on the device from the block's per-trial ``session_ids`` by the
  step's indices (JAX :500); the host keeps a copy to draw each sample's
  regions from its own session's candidates. The epoch, and so OneCycle,
  is ``sum over buckets of ceil(bucket trials / B)`` steps (:184-202).
  Without ``device_resident_data`` it raises ``ValueError``, as JAX does.
- **Eval** (``eval_epoch``, :943-1028): per session, the fixed eval
  stream; 'ap' metrics over the session's real neurons (bits/spike and
  the R² of the 50 most active), behavior R²; keyed by eid.
- **Under a DP/TP mesh** (``mesh=``, JAX :163-226): every path above runs
  on a rank, eagerly (``train/trainer.py``). A streaming batch keeps the
  rank's rows, ``space_attn_mask`` included (JAX ``_device_batch``,
  :222-226); a resident block is uploaded whole on every rank and each
  step gathers the rank's rows of the global batch; a session-mixed step
  draws its region picks for the global batch and keeps the rank's; eval
  gathers the predictions over the data group. Checkpoints hold the
  single-device layout.
- **Sharded resident sessions** (``shard_resident_sessions``, with
  session-mixed batches under a mesh, JAX :530-724): each bucket's
  sessions are dealt to the dp data shards (``shard_assignment``: largest
  first into the lightest shard), and a rank uploads only its shard's
  sessions' rows, zero-padded to the heaviest shard's ``L`` (the tp ranks
  of a data row hold the same shard), so its resident bytes are about
  1/dp of the replicated block. A step takes ``B / dp`` rows from each
  shard's without-replacement stream (``sharded_schedule``, JAX's
  schedule exactly); a rank gathers its rows from its own block, with no
  collective for data. ``B % dp`` raises ``ValueError``, as does the
  option without a mesh.

AdamW updates the whole stitched stacks every step, weight decay included,
as optax does: the other sessions' slices get zero gradients, not a
skipped update.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.loader import DataLoader, make_loader
from ..data.prefetch import DevicePrefetcher, pinned_batch_placer
from ..data.session import SessionSplits
from ..eval.metrics import bits_per_spike, metrics_list
from ..ops.masking import RegionSets, RegionTable
from ..utils.rng import fold_in
from .logging import MetricLogger
from .schedule import OptimizerConfig
from ..parallel.mesh import all_gather_cat, shard_batch
from .trainer import (_BATCH_KEYS, _EVAL_STEP, MultiModalTrainer,
                      TrainerConfig)


def _bucket_session_widths(
    num_neurons: Sequence[int], num_trials: Sequence[int],
    pad_multiple: int, n_buckets: int,
) -> List[int]:
    """Per-session padded widths for at most ``n_buckets`` shape buckets:
    the sessions sorted by neuron count, cut into contiguous groups, each
    padded to its widest member's width rounded up to ``pad_multiple``; the
    cut minimises the padded cells (``(width - n_neurons) * n_trials``
    summed over sessions) by exact dynamic programming."""
    S = len(num_neurons)
    order = sorted(range(S), key=lambda i: num_neurons[i])

    def q(w: int) -> int:
        return -(-w // pad_multiple) * pad_multiple

    INF = float("inf")
    nb = min(n_buckets, S)
    dp = [[INF] * (nb + 1) for _ in range(S + 1)]
    back = [[0] * (nb + 1) for _ in range(S + 1)]
    dp[0][0] = 0.0
    for i in range(1, S + 1):
        w_i = q(num_neurons[order[i - 1]])
        for k in range(1, nb + 1):
            cost = 0.0
            for j in range(i - 1, -1, -1):
                if j < i - 1:
                    s = order[j]
                    cost += (w_i - num_neurons[s]) * num_trials[s]
                # sorted sessions j..i-1 form one bucket of width w_i
                e = order[i - 1]
                total = cost + (w_i - num_neurons[e]) * num_trials[e]
                if dp[j][k - 1] + total < dp[i][k]:
                    dp[i][k] = dp[j][k - 1] + total
                    back[i][k] = j
    k_best = min(range(1, nb + 1), key=lambda k: dp[S][k])
    widths = [0] * S
    i, k = S, k_best
    while i > 0:
        j = back[i][k]
        w = q(num_neurons[order[i - 1]])
        for t in range(j, i):
            widths[order[t]] = w
        i, k = j, k - 1
    return widths


def build_multisession_loaders(
    sessions: Dict[str, SessionSplits],
    batch_size: int,
    *,
    max_time_length: int = 100,
    pad_multiple: int = 128,
    n_buckets: int = 1,
    target: Optional[Sequence[str]] = None,
    seed: int = 42,
) -> Tuple[Dict[str, DataLoader], Dict[str, DataLoader],
           Dict[str, DataLoader], dict]:
    """(train, val, test) loader dicts by eid (sorted) and ``meta``: the
    eids, ``eid_to_sid``, the neuron counts, ``n_max``, the per-session
    ``bucket_widths``, the shared ``region_vocab`` and each session's
    train ``region_ids`` (for ``RegionTable.build``)."""
    eids = sorted(sessions.keys())
    widths = _bucket_session_widths(
        [sessions[e].n_neurons for e in eids],
        [sessions[e].train.n_trials for e in eids],
        pad_multiple, n_buckets)

    region_vocab: Dict[str, int] = {}
    for e in eids:
        for r in sorted(set(sessions[e].train.neuron_regions.astype(str))):
            region_vocab.setdefault(r, len(region_vocab))

    train, val, test = {}, {}, {}
    for e, w in zip(eids, widths):
        kw = dict(batch_size=batch_size, target=target,
                  max_time_length=max_time_length, max_space_length=w,
                  region_vocab=region_vocab, seed=seed)
        train[e] = make_loader(sessions[e].train, **kw)
        val[e] = make_loader(sessions[e].val, shuffle=False, **kw)
        test[e] = make_loader(sessions[e].test, shuffle=False, **kw)

    meta = {
        "eids": eids,
        "eid_to_sid": {e: i for i, e in enumerate(eids)},
        "num_neurons": [sessions[e].n_neurons for e in eids],
        "n_max": max(widths),
        "bucket_widths": dict(zip(eids, widths)),
        "region_vocab": region_vocab,
        "per_session_region_ids": [train[e].arrays["region_ids"]
                                   for e in eids],
    }
    return train, val, test, meta


def shard_assignment(n_trials: Dict[str, int], eids: Sequence[str],
                     dp: int) -> Tuple[List[Tuple[str, ...]], int]:
    """``eids`` dealt to ``dp`` data shards (JAX ``_shard_assignment``,
    :530-545): sessions by trial count, largest first (ties by eid), each
    into the lightest shard (ties by shard index). Returns the shards' eids
    and ``L``, the heaviest shard's trials (at least 1): every shard's
    block is padded to ``L`` rows."""
    order = sorted(eids, key=lambda e: (-n_trials[e], e))
    shards: List[List[str]] = [[] for _ in range(dp)]
    load = [0] * dp
    for e in order:
        s = min(range(dp), key=lambda t: (load[t], t))
        shards[s].append(e)
        load[s] += n_trials[e]
    return [tuple(x) for x in shards], max(max(load), 1)


def sharded_schedule(bucket_pools: Sequence[Sequence[int]], B: int,
                     dp: int, K: int, seed: int, epoch: int
                     ) -> List[Tuple[int, List[np.ndarray]]]:
    """The sharded mixed epoch's steps (JAX
    ``_train_epoch_dr_mixed_sharded``, :655-690): per bucket ``gi`` (its
    shards' trial counts ``bucket_pools[gi]``) ``ceil(total / B)`` steps,
    each of ``B / dp`` rows from every shard's without-replacement stream
    (a permutation of the shard's pool from ``default_rng((seed, epoch,
    17, gi, s, cycle))``, renewed each cycle); a step's (B,) indices are
    the shards' segments in shard order, each a row offset into its own
    shard's block. Steps form K-groups per bucket; with several buckets
    the groups are shuffled by ``(seed, epoch, 13)``. Returns (bucket,
    [indices of each step]) per group."""
    if B % dp:
        raise ValueError(f"batch_size {B} must divide by dp={dp}")
    bq = B // dp
    step_groups: List[Tuple[int, List[np.ndarray]]] = []
    for gi, pools in enumerate(bucket_pools):
        n_steps = -(-sum(pools) // B)
        streams = []
        for s, pool in enumerate(pools):
            rows: List[int] = []
            cyc = 0
            while len(rows) < n_steps * bq:
                rng = np.random.default_rng((seed, epoch, 17, gi, s, cyc))
                rows.extend(rng.permutation(max(pool, 1)).tolist())
                cyc += 1
            streams.append(rows)
        batches = [np.concatenate([
            np.asarray(streams[s][t * bq:(t + 1) * bq], np.int64)
            for s in range(dp)]) for t in range(n_steps)]
        for start in range(0, len(batches), K):
            step_groups.append((gi, batches[start:start + K]))
    if len(bucket_pools) > 1:
        np.random.default_rng((seed, epoch, 13)).shuffle(step_groups)
    return step_groups


class MultiSessionTrainer(MultiModalTrainer):
    """``MultiModalTrainer`` over a dict of per-session loaders. The model
    is built with ``n_sessions = len(train_loaders)`` and
    ``n_channels['ap'] = N_max``."""

    _BATCH_KEYS = _BATCH_KEYS + ("space_attn_mask",)

    def __init__(
        self,
        model,
        train_loaders: Dict[str, DataLoader],
        eval_loaders: Optional[Dict[str, DataLoader]],
        optimizer_config: OptimizerConfig,
        trainer_config: TrainerConfig,
        *,
        region_table: RegionTable,
        eid_to_sid: Dict[str, int],
        mesh=None,
        logger: Optional[MetricLogger] = None,
        modal_filter=None,
    ):
        self.train_loaders = dict(train_loaders)
        self.eval_loaders = dict(eval_loaders or {})
        self.eid_to_sid = dict(eid_to_sid)
        first = next(iter(self.train_loaders))
        # a mixed epoch draws from one trial pool a bucket (JAX :184-192)
        B = self.train_loaders[first].batch_size
        self._mixed_batches = sum(
            -(-sum(self.train_loaders[e].n_trials for e in grp) // B)
            for grp in self._stack_groups())
        super().__init__(
            model, self.train_loaders[first], self.eval_loaders.get(first),
            optimizer_config, trainer_config, modal_filter=modal_filter,
            mesh=mesh, logger=logger)
        self.region_table = region_table.to(self.device)
        self._stacked_cache: Dict[tuple, tuple] = {}
        self._sharded_cache: Dict[tuple, tuple] = {}

    def _steps_per_epoch(self) -> int:
        """The one-cycle schedule's epoch: every session's batches, or
        with mixed batches each bucket's ``ceil(trials / B)``."""
        if self.tcfg.mixed_session_batches:
            return self._mixed_batches
        return sum(len(loader) for loader in self.train_loaders.values())

    # ------------------------------------------------------------------
    # per-session regions and forward arguments
    # ------------------------------------------------------------------

    def _host_regions(self, session) -> RegionSets:
        """The session's candidates, or per sample for a mixed batch's
        host ids (B,)."""
        if np.ndim(session) > 0:
            return self.region_table.host_rows(session)
        return self.region_table.select(int(session))

    def _forward_kwargs(self, batch, session) -> Dict[str, Any]:
        # a mixed batch carries its per-sample ids, gathered on the device
        session = batch.get("session_ids", session)
        return {"regions": self.region_table.select(session),
                "session_id": session,
                "space_attn_mask": batch["space_attn_mask"]}

    # ------------------------------------------------------------------
    # schedules
    # ------------------------------------------------------------------

    def _epoch_schedule(self, epoch: int) -> List[str]:
        """Each eid once per batch its loader yields this epoch, shuffled
        by ``(seed, epoch, 7)``."""
        eids = []
        for e, loader in self.train_loaders.items():
            eids.extend([e] * len(loader))
        np.random.default_rng((self.tcfg.seed, epoch, 7)).shuffle(eids)
        return eids

    def _stack_groups(self) -> List[Tuple[str, ...]]:
        """Train eids grouped by the trailing shapes and dtypes of their
        per-trial arrays (one group a width bucket), in loader order."""
        groups: Dict[tuple, List[str]] = {}
        for e, loader in self.train_loaders.items():
            sig = tuple((loader.arrays[k].shape[1:], loader.arrays[k].dtype.str)
                        for k in self._BATCH_KEYS)
            groups.setdefault(sig, []).append(e)
        return [tuple(v) for v in groups.values()]

    def _can_stack(self) -> bool:
        return len(self._stack_groups()) == 1

    def _stacked_train_data(self, eids: Tuple[str, ...]):
        """``eids``' train splits (one stack group: equal shapes)
        concatenated along the trial axis in one resident block, and each
        eid's trial offset in it. Cached per eid tuple against the loader
        objects."""
        hit = self._stacked(eids)
        return hit[1], hit[2]

    def _stacked(self, eids: Tuple[str, ...]):
        """(loaders, block, offsets, per-trial session ids on the host and
        on the device) of ``eids``, cached against the loader objects."""
        loaders = tuple(self.train_loaders[e] for e in eids)
        hit = self._stacked_cache.get(eids)
        if hit is not None and all(a is b for a, b in zip(hit[0], loaders)):
            return hit
        data = {k: torch.from_numpy(np.concatenate(
                    [np.asarray(l.arrays[k]) for l in loaders])).to(
                        self.device)
                for k in self._BATCH_KEYS}
        offsets, pos = {}, 0
        for e, loader in zip(eids, loaders):
            offsets[e] = pos
            pos += loader.n_trials
        sids = np.concatenate([np.full(l.n_trials, self.eid_to_sid[e],
                                       np.int64)
                               for e, l in zip(eids, loaders)])
        hit = self._stacked_cache[eids] = (
            loaders, data, offsets, sids,
            torch.from_numpy(sids).to(self.device))
        return hit

    def _sharded_block(self, eids: Tuple[str, ...]):
        """This rank's shard of ``eids``' block (JAX
        ``_sharded_train_data``, :547-600): the sessions
        ``shard_assignment`` gives data rank ``d``, their rows concatenated
        and zero-padded to ``L``, with their per-trial ``session_ids``, on
        the device; every shard's host session ids padded to ``L`` (the
        host draws each sample's regions from its own session's); and the
        shards' trial counts. Cached against the loader objects."""
        loaders = tuple(self.train_loaders[e] for e in eids)
        hit = self._sharded_cache.get(eids)
        if hit is not None and all(a is b for a, b in zip(hit[0], loaders)):
            return hit[1:]
        n_trials = {e: l.n_trials for e, l in zip(eids, loaders)}
        shards, L = shard_assignment(n_trials, eids, self.mesh.dp)
        mine = [self.train_loaders[e] for e in shards[self.mesh.d]]
        data = {}
        for k in self._BATCH_KEYS:
            ref = loaders[0].arrays[k]
            block = np.zeros((L,) + ref.shape[1:], ref.dtype)
            if mine:
                rows = np.concatenate([np.asarray(l.arrays[k]) for l in mine])
                block[:len(rows)] = rows
            data[k] = torch.from_numpy(block).to(self.device)
        host_sids = []
        for grp in shards:
            sids = np.zeros(L, np.int64)
            ids = [np.full(n_trials[e], self.eid_to_sid[e], np.int64)
                   for e in grp]
            if ids:
                ids = np.concatenate(ids)
                sids[:len(ids)] = ids
            host_sids.append(sids)
        data["session_ids"] = torch.from_numpy(host_sids[self.mesh.d]).to(
            self.device)
        pools = [sum(n_trials[e] for e in grp) for grp in shards]
        hit = self._sharded_cache[eids] = (loaders, data, host_sids, pools)
        return hit[1:]

    def _mixed_block(self, eids: Tuple[str, ...]):
        """``eids``' resident block with its per-trial ``session_ids`` on
        the device (a mixed step gathers them by its indices, JAX :500),
        and the host's copy of those ids."""
        _, data, _, sids, sids_dev = self._stacked(eids)
        return {**data, "session_ids": sids_dev}, sids

    def _blocks(self) -> Dict[str, Tuple[Dict[str, torch.Tensor], int]]:
        """Per eid: its bucket's resident block and its offset there."""
        out = {}
        for group in self._stack_groups():
            data, offsets = self._stacked_train_data(group)
            out.update({e: (data, offsets[e]) for e in group})
        return out

    # ------------------------------------------------------------------
    # epochs
    # ------------------------------------------------------------------

    def train_epoch(self, epoch: int) -> Dict[str, Any]:
        self._reseed_host_rng(epoch)     # exact resume (train/trainer.py)
        if self.tcfg.device_resident_data:
            losses = self._train_epoch_dr(epoch)
        elif self.tcfg.mixed_session_batches:
            raise ValueError(
                "mixed_session_batches requires device_resident_data=True "
                "(the streaming path has no cross-session gather)")
        else:
            losses = self._train_epoch_streaming(epoch)
        # one host sync per epoch
        per_step = torch.cat(losses).tolist() if losses else []
        train_loss = float(sum(per_step))
        return {"train_loss": train_loss,
                "train_loss_avg": train_loss / max(len(per_step), 1),
                "step_losses": per_step}

    def _train_epoch_streaming(self, epoch: int) -> List[torch.Tensor]:
        iters = {}
        for e, loader in self.train_loaders.items():
            loader.set_epoch(epoch)
            iters[e] = iter(loader)

        def host_batches():
            for eid in self._epoch_schedule(epoch):
                yield eid, next(iters[eid])

        if self.tcfg.prefetch_depth > 0:
            place = pinned_batch_placer(self._BATCH_KEYS, self.device)
            batches = DevicePrefetcher(
                host_batches(),
                lambda t: (t[0], place(shard_batch(t[1], self.mesh,
                                                   self._BATCH_KEYS))),
                depth=self.tcfg.prefetch_depth, device=self.device)
        else:
            batches = ((eid, self._device_batch(b))
                       for eid, b in host_batches())
        losses = []
        for eid, batch in batches:
            training_mode, scheme_id = self._sample_modes()
            losses.append(self.train_step(
                batch, training_mode, scheme_id,
                self.eid_to_sid[eid]).reshape(1))
        return losses

    def _index_batches(self, epoch: int):
        out = {}
        for e, loader in self.train_loaders.items():
            loader.set_epoch(epoch)
            out[e] = loader.iter_index_batches()
        return out

    def _train_epoch_dr(self, epoch: int) -> List[torch.Tensor]:
        """The resident epoch: the K = 1 interleave, in groups of K across
        sessions when they share one block (``stacked_scan``), else
        per-session K-groups (``_train_epoch_dr_scan``)."""
        K = max(1, self.tcfg.steps_per_dispatch)
        if self.tcfg.mixed_session_batches:
            if self.tcfg.shard_resident_sessions:
                if self.mesh is None:
                    raise ValueError(
                        "shard_resident_sessions needs a mesh with a "
                        "'data' axis (build_mesh)")
                return self._train_epoch_dr_mixed_sharded(epoch, K)
            return self._train_epoch_dr_mixed(epoch, K)
        if K > 1 and not (self.tcfg.stacked_scan and self._can_stack()):
            return self._train_epoch_dr_scan(epoch, K)
        blocks = self._blocks()
        iters = self._index_batches(epoch)
        steps = []
        for eid in self._epoch_schedule(epoch):
            idx, valid, _ = next(iters[eid])
            data, off = blocks[eid]
            steps.append((data, idx + off, valid, self.eid_to_sid[eid]))
        losses = []
        for start in range(0, len(steps), K):
            chunk = steps[start:start + K]
            if len(chunk) < K or K == 1:      # single steps
                for data, idx, valid, sid in chunk:
                    training_mode, scheme_id = self._sample_modes()
                    losses.append(self._dispatch(
                        data, [(idx, valid, scheme_id, sid)], training_mode))
                continue
            training_mode, schemes = self._sample_group_modes(K)
            losses.append(self._dispatch(
                chunk[0][0], [(idx, valid, scheme, sid) for
                              (_, idx, valid, sid), scheme
                              in zip(chunk, schemes)], training_mode))
        return losses

    def _train_epoch_dr_scan(self, epoch: int, K: int
                             ) -> List[torch.Tensor]:
        """Per-session K-groups (several buckets, or ``stacked_scan``
        off): each session's batches in groups of K, the groups shuffled
        by ``(seed, epoch, 7)``; a short group runs as single steps."""
        blocks = self._blocks()
        groups = []
        for e, batches in self._index_batches(epoch).items():
            batches = [(idx, valid) for idx, valid, _ in batches]
            for i in range(0, len(batches), K):
                groups.append((e, batches[i:i + K]))
        np.random.default_rng((self.tcfg.seed, epoch, 7)).shuffle(groups)
        losses = []
        for eid, chunk in groups:
            data, off = blocks[eid]
            sid = self.eid_to_sid[eid]
            if len(chunk) < K:
                for idx, valid in chunk:
                    training_mode, scheme_id = self._sample_modes()
                    losses.append(self._dispatch(
                        data, [(idx + off, valid, scheme_id, sid)],
                        training_mode))
                continue
            training_mode, schemes = self._sample_group_modes(K)
            losses.append(self._dispatch(
                data, [(idx + off, valid, scheme, sid)
                       for (idx, valid), scheme in zip(chunk, schemes)],
                training_mode))
        return losses

    def _train_epoch_dr_mixed(self, epoch: int, K: int
                              ) -> List[torch.Tensor]:
        """Session-mixed batches (JAX ``_train_epoch_dr_mixed``): per
        bucket one permutation of its block's trials, full B-batches with
        one valid-masked tail (padded with trial 0, as JAX pads), K-groups
        (one objective a group, a scheme a step); several buckets' groups
        shuffled together. A short group runs as single steps."""
        groups = self._stack_groups()
        B = self.train_dataloader.batch_size
        seed = self.tcfg.seed
        blocks, step_groups = {}, []
        for gi, eids in enumerate(groups):
            data, sids = self._mixed_block(eids)
            blocks[gi] = (data, sids)
            rng = np.random.default_rng(
                (seed, epoch, 11) if len(groups) == 1
                else (seed, epoch, 11, gi))
            perm = rng.permutation(len(sids))
            batches = []
            for s in range(0, len(sids), B):
                chunk = perm[s:s + B]
                valid = np.ones(B, np.float32)
                if len(chunk) < B:
                    valid[len(chunk):] = 0.0
                    chunk = np.pad(chunk, (0, B - len(chunk)))
                batches.append((chunk.astype(np.int64), valid))
            for start in range(0, len(batches), K):
                step_groups.append((gi, batches[start:start + K]))
        if len(groups) > 1:
            np.random.default_rng((seed, epoch, 13)).shuffle(step_groups)
        return self._dispatch_mixed(
            [(blocks[gi][0], [(idx, valid, blocks[gi][1][idx])
                              for idx, valid in group])
             for gi, group in step_groups], K)

    def _dispatch_mixed(self, step_groups, K: int) -> List[torch.Tensor]:
        """Run session-mixed step groups (block, [(idx, valid, the global
        batch's host session ids)]): a whole K-group as one dispatch (one
        objective a group, a scheme a step), a short group or K = 1 as
        single steps."""
        losses = []
        for data, group in step_groups:
            if len(group) < K or K == 1:
                for idx, valid, sids in group:
                    training_mode, scheme_id = self._sample_modes()
                    losses.append(self._dispatch(
                        data, [(idx, valid, scheme_id, sids)],
                        training_mode))
                continue
            training_mode, schemes = self._sample_group_modes(len(group))
            losses.append(self._dispatch(
                data, [(idx, valid, scheme, sids)
                       for (idx, valid, sids), scheme in zip(group, schemes)],
                training_mode))
        return losses

    def _train_epoch_dr_mixed_sharded(self, epoch: int, K: int
                                      ) -> List[torch.Tensor]:
        """Session-mixed batches over sharded blocks (JAX
        ``_train_epoch_dr_mixed_sharded``): ``sharded_schedule``'s steps,
        every batch full; this rank gathers its segment of each step's
        indices from its own block, and the host draws the global batch's
        regions from every shard's session ids."""
        B, dp = self.train_dataloader.batch_size, self.mesh.dp
        blocks = [self._sharded_block(eids) for eids in self._stack_groups()]
        schedule = sharded_schedule([b[2] for b in blocks], B, dp, K,
                                    self.tcfg.seed, epoch)
        valid, bq = np.ones(B, np.float32), B // dp

        def host_ids(sids, idx):
            return np.concatenate([sids[s][idx[s * bq:(s + 1) * bq]]
                                   for s in range(dp)])

        return self._dispatch_mixed(
            [(blocks[gi][0], [(idx, valid, host_ids(blocks[gi][1], idx))
                              for idx in group])
             for gi, group in schedule], K)

    @torch.no_grad()
    def eval_epoch(self) -> Optional[Dict[str, Any]]:
        """Per-session metrics (JAX :943-1028; eids are the analog of the
        reference's neuron-count keys)."""
        if not self.eval_loaders:
            return None
        self._reseed_host_rng(0, tag=1)       # the same stream every epoch
        eval_seed = fold_in(self.tcfg.seed, _EVAL_STEP)
        outputs = self.modal_filter["output"]
        losses, results_list = [], []
        per_session: Dict[str, Dict[str, float]] = {}
        gt_all: Dict[str, dict] = {}
        preds_all: Dict[str, dict] = {}
        group = None if self.mesh is None else self.mesh.data_group
        for eid, loader in self.eval_loaders.items():
            sid = self.eid_to_sid[eid]
            space = np.asarray(loader.arrays["space_attn_mask"][0])
            zeros = np.nonzero(space == 0)[0]
            n_real_neurons = int(zeros.min()) if len(zeros) else len(space)
            if self.tcfg.device_resident_data:
                batches = self._resident_eval_batches(loader)
            else:
                batches = ((self._device_batch(b),
                            int(b.get("n_real", len(b["spikes_data"]))))
                           for b in loader)
            acc = {mod: {"gt": [], "preds": []} for mod in outputs}
            for batch, n_real in batches:
                training_mode, scheme_id = self._sample_modes()
                out = self.model(
                    self._build_mod_inputs(batch, training_mode),
                    masking_mode=scheme_id, mtm_modes=self.mtm_modes,
                    training=False, seed=eval_seed,
                    **self._forward_kwargs(batch, sid))
                losses.append(out.loss)
                for mod in outputs:
                    # the global batch's rows, in order, on every rank
                    acc[mod]["gt"].append(all_gather_cat(
                        out.mod_targets[mod], group)[:n_real])
                    acc[mod]["preds"].append(all_gather_cat(
                        out.mod_preds[mod], group)[:n_real])

            gt_all[eid], preds_all[eid], per_session[eid] = {}, {}, {}
            for mod in outputs:
                _gt = torch.cat(acc[mod]["gt"]).cpu().numpy()
                _pr = torch.cat(acc[mod]["preds"]).cpu().numpy()
                if mod == "ap":
                    _gt = _gt[:, :, :n_real_neurons]
                    _pr = np.exp(_pr[:, :, :n_real_neurons])
                    active = np.argsort(_gt.sum((0, 1)))[::-1][:50].tolist()
                    res = metrics_list(_gt[:, :, active].transpose(2, 1, 0),
                                       _pr[:, :, active].transpose(2, 1, 0),
                                       metrics=["r2"])
                    per_session[eid]["ap_bps"] = bits_per_spike(_pr, _gt)
                    per_session[eid]["ap_r2"] = res["r2"]
                else:
                    res = metrics_list(_gt, _pr, metrics=[self.metric])
                    per_session[eid][f"{mod}_{self.metric}"] = \
                        res[self.metric]
                gt_all[eid][mod], preds_all[eid][mod] = _gt, _pr
                results_list.append(res[self.metric])

        eval_loss = float(torch.stack(losses).sum()) if losses else 0.0
        return {
            "eval_loss": eval_loss,
            f"eval_trial_avg_{self.metric}": float(np.nanmean(results_list)),
            "eval_per_session": per_session,
            "eval_gt": gt_all,
            "eval_preds": preds_all,
        }
