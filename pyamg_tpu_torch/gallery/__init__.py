"""Problem gallery: PDE discretizations and example matrices (numpy/scipy).

Port of ``pyamg_tpu/gallery``.
"""

from .stencil import stencil_grid
from .laplacian import poisson, gauge_laplacian
from .diffusion import diffusion_stencil_2d, diffusion_stencil_3d
from .elasticity import linear_elasticity, linear_elasticity_p1
from .mesh import regular_triangle_mesh
from .random_sparse import sprand
from .example import load_example
from .demo import demo

__all__ = [
    "stencil_grid", "poisson", "gauge_laplacian",
    "diffusion_stencil_2d", "diffusion_stencil_3d",
    "linear_elasticity", "linear_elasticity_p1",
    "regular_triangle_mesh", "sprand", "load_example", "demo",
]
