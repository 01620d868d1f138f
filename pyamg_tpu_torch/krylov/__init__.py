"""Krylov methods on the hierarchy's device (CG)."""

from ._cg import cg_core

__all__ = ["cg_core"]
