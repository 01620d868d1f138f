"""Visualization: VTK (.vtu) export of meshes, aggregates and C/F
splittings (host only)."""

from .vis_coarse import vis_aggregate_groups, vis_splitting
from .vtk_writer import write_basic_mesh, write_vtu

__all__ = ["write_vtu", "write_basic_mesh", "vis_aggregate_groups",
           "vis_splitting"]
