"""The device setup of general (unstructured-capable) hierarchies and their
padded-ELL solver, on one device.  Setups and solves over several devices
are not ported yet."""

from .sharding import ShardedSolver, pad_to
from .setup import (general_sa_setup_sharded, rootnode_setup_sharded,
                    adaptive_sa_setup_sharded, classical_setup_sharded)

__all__ = ["ShardedSolver", "pad_to", "general_sa_setup_sharded",
           "rootnode_setup_sharded", "adaptive_sa_setup_sharded",
           "classical_setup_sharded"]
