"""The device setups of smoothed-aggregation (structured, general,
root-node and adaptive) and classical hierarchies, and their solvers, on
one device.  Setups and solves over several devices are not ported yet."""

from .sharding import (ShardedSolver, StructuredShardedSolver, pad_to,
                       shard_structured_solver)
from .classical_setup import classical_setup_sharded
from .setup import (structured_sa_setup_sharded, general_sa_setup_sharded,
                    rootnode_setup_sharded, adaptive_sa_setup_sharded)

__all__ = ["ShardedSolver", "StructuredShardedSolver",
           "shard_structured_solver", "pad_to",
           "structured_sa_setup_sharded", "general_sa_setup_sharded",
           "rootnode_setup_sharded", "adaptive_sa_setup_sharded",
           "classical_setup_sharded"]
