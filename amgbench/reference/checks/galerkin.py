"""The coarse operators of the hierarchy against the Galerkin product.

For each level l with a coarser one, the read-back ``A``, ``P`` and ``R``
of level l and ``A`` of level l + 1 (``A_c``), and random normal vectors
v (coarse) and u (fine) drawn from the run's probe seed:

* ``galerkin_max``: the largest |A_c v - P^T (A (P v))|_i over
  (|P|^T (|A| (|P| |v|)))_i, the row's size of the product, over rows,
  probes and levels: a coarse operator that is not P^T A P to the
  program's rounding reads far above it;
* ``transpose_max``: the largest |R u - P^T u|_i over (|P|^T |u|)_i: the
  restriction the cycle uses is P^T.

P^T A P is applied factor by factor in float64 and never formed, so a
level of 16.8M rows takes seconds.  A row whose size is zero but whose
value is not, or shapes that do not chain, read infinity.  The parameters
are ``probes`` (vectors a level) and the two limits.
"""

import numpy as np

from ..matrices import Product, host, to_bfloat16

HIERARCHY = True


def _gap(y, y_ref, scale):
    d = np.abs(y - y_ref)
    pos = scale > 0
    if np.any(d[~pos] > 0):
        return float("inf")
    return float(np.max(d[pos] / scale[pos], initial=0.0))


def levels(hierarchy):
    """``(A, P, R, A_c)`` of each level with a coarser one, as host
    matrices."""
    for fine, coarse in zip(hierarchy, hierarchy[1:]):
        yield (host(fine["A"]), Product(host(f) for f in fine["P"]),
               Product(host(f) for f in fine["R"]), host(coarse["A"]))


def readings(hierarchy, seed, probes, control=False):
    """``(galerkin, transpose)``: the two numbers of the program's
    hierarchy; with ``control`` those of the reference in its place,
    computed from the operands rounded to bfloat16 (the precision below
    the configuration's float32)."""
    rng = np.random.default_rng(seed)
    gal = tra = 0.0
    for A, P, R, Ac in levels(hierarchy):
        n, nc = P.shape
        if A.shape != (n, n) or Ac.shape != (nc, nc) or R.shape != (nc, n):
            return float("inf"), float("inf")
        aA, aP = A.map(np.abs), P.map(np.abs)
        if control:
            bA, bP = A.map(to_bfloat16), P.map(to_bfloat16)
        for _ in range(int(probes)):
            v, u = rng.standard_normal(nc), rng.standard_normal(n)
            y_ref = P.rmatvec(A.matvec(P.matvec(v)))
            scale = aP.rmatvec(aA.matvec(aP.matvec(np.abs(v))))
            y = (bP.rmatvec(bA.matvec(bP.matvec(v))) if control
                 else Ac.matvec(v))
            gal = max(gal, _gap(y, y_ref, scale))
            r = bP.rmatvec(u) if control else R.matvec(u)
            tra = max(tra, _gap(r, P.rmatvec(u), aP.rmatvec(np.abs(u))))
    return gal, tra


def compare(params, evidence):
    if evidence.hierarchy is None:
        gal = tra = float("inf")
    else:
        gal, tra = readings(evidence.hierarchy, evidence.probe_seed,
                            params["probes"])
    return {"galerkin_max": {"value": gal, "limit": float(params["limit"])},
            "transpose_max": {"value": tra,
                              "limit": float(params["transpose_limit"])}}
