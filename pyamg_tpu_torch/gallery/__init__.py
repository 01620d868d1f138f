"""Problem gallery: PDE discretizations on regular grids (numpy/scipy)."""

from .stencil import stencil_grid
from .laplacian import poisson

__all__ = ["stencil_grid", "poisson"]
