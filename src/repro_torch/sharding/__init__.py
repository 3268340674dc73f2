"""Logical-axis sharding rules and the ambient sharding context (the
counterpart of ``repro.sharding``)."""
from .rules import (DEFAULT_RULES, MeshShape, PartitionSpec, fsdp_rules,
                    local_shape, mesh_axes, placements, resolve, serve_rules,
                    sp_rules, tp_sp_rules, tree_shardings, with_updates)
from .ctx import use_sharding, constrain, current

__all__ = ["DEFAULT_RULES", "MeshShape", "PartitionSpec", "fsdp_rules",
           "local_shape", "mesh_axes", "placements", "resolve", "serve_rules",
           "sp_rules", "tp_sp_rules", "tree_shardings", "with_updates",
           "use_sharding", "constrain", "current"]
