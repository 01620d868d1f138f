"""Square DIA operators of the DIA SpMV variant checks, shared by the CPU
tests, the card's kernel tests and ``chip_smoke.py``.

Only numpy, scipy and the port's gallery are imported, so that the card's
machine (no JAX) can use it.  ``pallas300x257`` is tests/test_pallas.py's
second case, drawn from the same seed.
"""

import numpy as np
import scipy.sparse as sp

from pyamg_tpu_torch.gallery import poisson


def with_diagonals(A, extra, seed=0):
    """A plus ``scale * diag(random, offset)`` for each ``(offset, scale)``,
    the random values drawn in turn from one generator."""
    rng = np.random.default_rng(seed)
    n = A.shape[0]
    for off, scale in extra:
        A = A + scale * sp.diags(rng.random(n - abs(off)), off)
    return sp.csr_matrix(A)


ALL = {
    # offsets +-1, +-257, 0, and 258, -127, 5
    "pallas300x257": lambda: with_diagonals(
        poisson((300, 257), format="csr"),
        [(258, 0.3), (-127, 0.2), (5, 0.1)]),
    # +-256 (a multiple of 128), -1 (q, s = -1, 127), -384 and 129
    "lane_multiples": lambda: with_diagonals(
        poisson((64, 256), format="csr"), [(-384, 0.4), (129, 0.2)], 1),
    # offsets on the edge of dia_matvec_v2's widest window (128 halo rows:
    # q, s = -127, 0 / 127, 0 / 126, 127)
    "wide": lambda: with_diagonals(
        poisson((40001,), format="csr"),
        [(-16256, 0.3), (16256, 0.2), (16255, 0.1)], 3),
    "poisson512": lambda: poisson((512, 512), format="csr"),
    "poisson70001": lambda: poisson((70001,), format="csr"),
    # offsets on the edge of dia_matvec_v1's padded copy
    "margin": lambda: with_diagonals(poisson((1000,), format="csr"),
                                     [(-999, 0.5), (999, 0.25)], 5),
}


def random_dia(n, m, k, seed, edges=False):
    """An n x m operator with k distinct diagonals drawn from every offset
    that meets it, random values; ``edges``: the two outermost offsets
    ``-(n - 1)`` and ``m - 1`` among them (one entry each)."""
    rng = np.random.default_rng(seed)
    offsets = rng.choice(np.arange(-(n - 1), m), size=k, replace=False)
    if edges:
        rest = offsets[(offsets != -(n - 1)) & (offsets != m - 1)]
        offsets = np.concatenate([[-(n - 1), m - 1], rest[:k - 2]])
    data = rng.random((k, max(n, m))) + 0.5
    return sp.csr_matrix(sp.dia_matrix((data, offsets), shape=(n, m)))


# short, wide operators: few rows, many offsets -- the shapes on which
# dia_matvec's launcher takes its wide route (chip_smoke's per-shape sweep
# has the real ones: 4,096 x 179 and 2,154 x 285 levels, 603-offset
# smoothers)
WIDE = {
    "wide512x200": lambda: random_dia(512, 512, 200, 11),
    # the plain-CSR default hierarchy's level of 219 rows and 111 offsets
    "wide219x111": lambda: random_dia(219, 219, 111, 12),
    # more offsets than a float32 chunk of the wide route (512) holds
    "wide700x603": lambda: random_dia(700, 700, 603, 13),
    # rectangular, offsets past both edges
    "rect300x700": lambda: random_dia(300, 700, 150, 14, edges=True),
    "rect700x300": lambda: random_dia(700, 300, 150, 15, edges=True),
    "k1": lambda: sp.csr_matrix(sp.diags(
        np.random.default_rng(16).random(998) + 0.5, -2, shape=(1000, 1000))),
}
