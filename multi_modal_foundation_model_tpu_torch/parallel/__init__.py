"""Data and tensor parallelism over ``torch.distributed`` process groups
(the JAX package's ``parallel/``): ``mesh`` holds the (dp, tp) grid of
ranks and its collectives, ``partition`` the Megatron rules over the
port's parameter names."""

from .mesh import (Mesh, build_mesh, initialize_multihost, make_mesh,
                   mesh_shape, model_axis_size, rank_device, replicate,
                   shard_batch, shard_rows)
from .partition import (full_state_dict, gather_full, module_placements,
                        partition_rules, shard_module, shard_state_dict,
                        shard_tensor, spec_for)

__all__ = [
    "Mesh", "build_mesh", "full_state_dict", "gather_full",
    "initialize_multihost", "make_mesh", "mesh_shape", "model_axis_size",
    "module_placements", "partition_rules", "rank_device", "replicate",
    "shard_batch", "shard_module", "shard_rows", "shard_state_dict",
    "shard_tensor", "spec_for",
]
