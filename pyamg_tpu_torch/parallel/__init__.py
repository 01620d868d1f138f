"""The device setups of general (unstructured-capable) smoothed-aggregation
and of classical hierarchies, and their padded-ELL solver, on one device.
Setups and solves over several devices are not ported yet."""

from .sharding import ShardedSolver, pad_to
from .classical_setup import classical_setup_sharded
from .setup import (general_sa_setup_sharded, rootnode_setup_sharded,
                    adaptive_sa_setup_sharded)

__all__ = ["ShardedSolver", "pad_to", "general_sa_setup_sharded",
           "rootnode_setup_sharded", "adaptive_sa_setup_sharded",
           "classical_setup_sharded"]
