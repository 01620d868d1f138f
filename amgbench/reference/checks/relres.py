"""``relres_max``: the largest ||b - A x|| / ||b|| over the checked
requests, in float64, A the reference's operator and b = A x* from the
request's x*.  The parameter is the limit, the configuration's stated
tolerance."""

import numpy as np


def relres(op, x_star, x) -> float:
    """||b - A x|| / ||b|| in float64 with b = A x*."""
    b = op.matvec(x_star)
    r = b - op.matvec(np.asarray(x, dtype=np.float64))
    nb = np.linalg.norm(b)
    return float(np.linalg.norm(r) / (nb if nb else 1.0))


def compare(limit, evidence):
    worst = 0.0 if evidence.samples else float("inf")
    for op, x_star, x in evidence.samples:
        rr = relres(op, x_star, x)
        worst = max(worst, rr) if np.isfinite(rr) else float("inf")
    return {"relres_max": {"value": worst, "limit": float(limit)}}
