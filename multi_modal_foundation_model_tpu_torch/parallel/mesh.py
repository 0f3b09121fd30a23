"""Process groups for data and tensor parallelism, and their collectives.

The port's counterpart of ``multi_modal_foundation_model_tpu/parallel/
mesh.py``. JAX places arrays on a device mesh and lets XLA insert the
collectives; here every rank is a process, the mesh is a grid of
``torch.distributed`` process groups, and the model and the trainers call
the collectives themselves:

- ``initialize_multihost`` starts the process group from torchrun's
  environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
  ``WORLD_SIZE``) or from its arguments. The backend is named: NCCL for
  CUDA, gloo for the CPU, or ``backend=``, so ranks that share one card
  can run over gloo, which takes CUDA tensors for ``all_reduce``,
  ``broadcast`` and ``all_gather`` (NCCL refuses two ranks on one GPU).
- ``build_mesh(dp, tp)`` arranges the world's ranks as a (dp, tp) grid,
  row-major as JAX's ``reshape(n_dp, tp)``: rank = d * tp + m. Each rank
  holds its ``data`` group (the ranks of its model column m, which hold
  the same parameter shards and other rows of the batch) and its
  ``model`` group (the ranks of its data row d, which hold the same rows
  and the other shards).
- ``shard_batch`` keeps a rank's rows of a global batch, JAX's
  ``P("data")``; ``replicate`` broadcasts a module from rank 0.
- ``copy_to_group`` / ``reduce_from_group`` are Megatron's f and g
  (Shoeybi et al., 2019): identity forward and ``all_reduce`` backward
  before a column-parallel layer, ``all_reduce`` forward and identity
  backward after a row-parallel one. The loss uses the second over the
  data group (``models/multimodal.py``).

Every collective is ``all_reduce``, ``broadcast`` or ``all_gather``: both
backends take them. Nothing here picks a device: a rank's device is
``rank_device``'s, a card unless the caller names the CPU.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         backend: Optional[str] = None,
                         device="cuda") -> None:
    """``torch.distributed.init_process_group`` (JAX ``mesh.py:20-30``);
    idempotent. With no arguments the world comes from torchrun's
    environment; ``coordinator_address`` ("host:port" or a URL) with
    ``num_processes`` and ``process_id`` names it. ``backend`` defaults to
    NCCL for a CUDA ``device`` and gloo for the CPU."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if coordinator_address is None:
        world = (int(os.environ["WORLD_SIZE"]) if num_processes is None
                 else int(num_processes))
        rank = (int(os.environ["RANK"]) if process_id is None
                else int(process_id))
        init = "env://"
    else:
        world, rank = int(num_processes), int(process_id)
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)


def rank_device(device="cuda") -> torch.device:
    """This rank's device: the CPU when asked for, else card
    ``LOCAL_RANK % device_count`` (ranks beyond the cards share them), made
    current. Raises without a card; never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    if dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (dp, tp) grid of the world's ranks; this rank is (d, m). The
    groups are ``torch.distributed`` process groups (``None`` for a group
    of one rank, whose collectives are the identity)."""

    dp: int
    tp: int
    rank: int
    data_group: Any
    model_group: Any

    @property
    def d(self) -> int:
        return self.rank // self.tp

    @property
    def m(self) -> int:
        """This rank's model coordinate, also the global rank of data rank
        0 in its data group."""
        return self.rank % self.tp

    @property
    def axis_names(self) -> tuple:
        return ("data", "model") if self.tp > 1 else ("data",)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, (self.dp, self.tp)))

    @property
    def size(self) -> int:
        return self.dp * self.tp

    @property
    def is_main(self) -> bool:
        """Rank 0: the rank that logs and writes."""
        return self.rank == 0


def make_mesh(dp: int, tp: int) -> Mesh:
    """The (dp, tp) mesh of a world of exactly dp * tp ranks. Every rank
    creates every group, in the same order, as ``new_group`` requires."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp * tp != world:
        raise ValueError(f"a {dp} x {tp} mesh needs {dp * tp} ranks, the "
                         f"world has {world} (start them with torchrun "
                         f"--nproc_per_node {dp * tp})")
    rank = dist.get_rank() if dist.is_initialized() else 0
    grid = np.arange(world).reshape(dp, tp)
    mine = {}
    for kind, lines in (("data", grid.T), ("model", grid)):
        for line in lines:
            ranks = [int(r) for r in line]
            group = dist.new_group(ranks) if len(ranks) > 1 else None
            if rank in ranks:
                mine[kind] = group
    return Mesh(dp=dp, tp=tp, rank=rank, data_group=mine["data"],
                model_group=mine["model"])


def mesh_shape(world: int, dp: int = -1, tp: int = 1
               ) -> Optional[Tuple[int, int]]:
    """(dp, tp) of JAX ``build_mesh`` over ``world`` devices
    (``mesh.py:33-55``): ``dp=-1`` takes every device not claimed by
    ``tp``, a larger ``dp`` is cut to what is left; None when dp * tp <= 1.
    ``tp`` larger than the world raises."""
    tp = max(1, int(tp))
    if tp > world:
        raise ValueError(f"tp={tp} exceeds {world} ranks")
    avail = world // tp
    n_dp = avail if dp in (-1, 0) else min(int(dp), avail)
    return None if n_dp * tp <= 1 else (n_dp, tp)


def build_mesh(dp: int = -1, tp: int = 1) -> Optional[Mesh]:
    """The (dp, tp) mesh of the world's ranks, None for a world of one;
    ``dp=-1`` takes every rank not claimed by ``tp``. ``dp * tp`` must be
    the world, else ``make_mesh`` raises: JAX runs on the devices it takes
    (``mesh_shape``), but a rank left out here would have nothing to
    run."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    tp = max(1, int(tp))
    n_dp = max(1, world // tp) if dp in (-1, 0) else int(dp)
    mesh = make_mesh(n_dp, tp)
    return None if mesh.size == 1 else mesh


def model_axis_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.tp


# ---------------------------------------------------------------------------
# batches and replicas
# ---------------------------------------------------------------------------

def shard_rows(x, mesh: Optional[Mesh]):
    """Rows ``[d * B / dp, (d + 1) * B / dp)`` of ``x`` (an array or a
    tensor with the batch first); raises when ``B % dp``."""
    if mesh is None or mesh.dp == 1:
        return x
    B = x.shape[0]
    if B % mesh.dp:
        raise ValueError(f"a batch of {B} does not split over {mesh.dp} "
                         "data ranks")
    n = B // mesh.dp
    return x[mesh.d * n:(mesh.d + 1) * n]


def shard_batch(batch: Dict[str, Any], mesh: Optional[Mesh],
                keys: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """This rank's rows of every array of ``batch`` (of ``keys``, the
    others as they are): JAX's ``P("data")`` (``mesh.py:67-77``)."""
    keys = batch.keys() if keys is None else keys
    return {k: shard_rows(v, mesh) if k in keys else v
            for k, v in batch.items()}


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Optional[Mesh]
              ) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` broadcast from rank 0 (the
    JAX ``replicate``'s placement: the same values on every rank), one
    broadcast a dtype."""
    if mesh is None or mesh.size == 1:
        return module
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in list(module.parameters()) + list(module.buffers()):
        by_dtype.setdefault(t.dtype, []).append(t.data)
    for tensors in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.broadcast(flat, src=0)
        for t, part in zip(tensors,
                           flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t))
    return module


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """In place over ``group`` (the identity for ``None``)."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_reduce_many_(tensors: List[torch.Tensor], group) -> None:
    """Sum each of ``tensors`` over ``group`` with one collective (their
    values packed into one buffer of their common dtype)."""
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) concatenated along ``dim`` in rank
    order of ``group``."""
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def broadcast_(t: torch.Tensor, group, src_rank: int) -> torch.Tensor:
    """In place from global rank ``src_rank`` of ``group``."""
    if group is not None:
        dist.broadcast(t, src=src_rank, group=group)
    return t


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None and mesh.size > 1:
        dist.barrier()


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: identity forward, gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: the partial results summed over the group, identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromGroup.apply(x, group)
