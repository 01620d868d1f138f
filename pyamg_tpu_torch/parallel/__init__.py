"""The device setups of smoothed-aggregation (structured, general,
root-node and adaptive) and classical hierarchies, and their solvers, on
one device or spread over a mesh of ranks (``torch.distributed``): the
mesh and its launcher (``mesh``), the halo-exchange ELL (``halo``), the
masked products of row-sharded matrices (``products``), the sharded
solvers, and every setup built slab by slab over the ranks."""

from .mesh import Mesh, Layout, launch, make_mesh, one_rank_mesh
from .sharding import (ShardedSolver, StructuredShardedSolver, pad_to,
                       shard_solver, shard_structured_solver)
from .classical_setup import classical_setup_sharded
from .setup import (structured_sa_setup_sharded, general_sa_setup_sharded,
                    rootnode_setup_sharded, adaptive_sa_setup_sharded)

__all__ = ["make_mesh", "one_rank_mesh", "launch", "Mesh", "Layout",
           "shard_solver",
           "ShardedSolver", "StructuredShardedSolver",
           "shard_structured_solver", "pad_to",
           "structured_sa_setup_sharded", "general_sa_setup_sharded",
           "rootnode_setup_sharded", "adaptive_sa_setup_sharded",
           "classical_setup_sharded"]
