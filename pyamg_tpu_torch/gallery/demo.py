"""A quick demonstration.  Port of ``pyamg_tpu/gallery/demo.py``."""

from __future__ import annotations

import numpy as np

__all__ = ["demo"]


def demo(n=100, device="cuda"):
    """Build a 2D Poisson problem, solve with smoothed aggregation on
    ``device``, and print a convergence summary."""
    from . import poisson
    from ..aggregation import smoothed_aggregation_solver

    A = poisson((n, n), format="csr")
    b = np.random.default_rng(0).standard_normal(A.shape[0])

    ml = smoothed_aggregation_solver(A, device=device)
    print(ml)

    residuals = []
    x = ml.solve(b, tol=1e-8, residuals=residuals)
    print(f"residual norm: {np.linalg.norm(b - A @ x.cpu().numpy()):.3e} "
          f"after {len(residuals) - 1} iterations")
    return x
