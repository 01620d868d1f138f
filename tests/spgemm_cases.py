"""Operand pairs ``(A, B)`` of the masked-SpGEMM checks, shared by the CPU
tests, the card's kernel tests and ``chip_smoke.py``.

Only numpy and scipy are imported, so that the card's machine (no JAX)
can use it.  ``banded`` and ``near_band`` draw from their seed exactly as
tests/test_pallas.py's ``_banded_square`` and ``_banded_random`` do, so
that a case here is the same matrix the JAX package's kernel tests use.
"""

import numpy as np
import scipy.sparse as sp


def banded(n, offsets, seed, drop=0.1):
    """(n, n) matrix with random values on ``offsets``, a ``drop`` share
    of each diagonal left out."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for off in offsets:
        i = np.arange(max(0, -off), min(n, n - off))
        keep = rng.random(i.size) > drop
        rows.append(i[keep])
        cols.append((i + off)[keep])
        vals.append(rng.standard_normal(keep.sum()))
    A = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n)).tocsr()
    A.sort_indices()
    return A


def near_band(n, m, bw, per_row=5, seed=0):
    """(n, m) matrix, ``per_row`` draws a row within ``bw`` columns of the
    scaled diagonal (duplicates summed)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = np.clip((rows * m) // n
                   + rng.integers(-bw, bw + 1, size=rows.size), 0, m - 1)
    A = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)),
                      shape=(n, m)).tocsr()
    A.sum_duplicates()
    A.sort_indices()
    return A


def irregular(n, density, seed):
    """(n, n) matrix with a uniformly random pattern."""
    rng = np.random.default_rng(seed)
    A = sp.csr_matrix(rng.random((n, n)) < density, dtype=np.float64)
    A.data = rng.standard_normal(A.nnz)
    return A


# left operands with at most 64 distinct offsets (the banded kernel's)
BANDED = {
    "5pt": lambda: (banded(3000, [-50, -1, 0, 1, 50], seed=1),
                    near_band(3000, 900, 3, per_row=3, seed=2)),
    "9pt": lambda: (banded(2000, [-45, -44, -43, -1, 0, 1, 43, 44, 45],
                           seed=3),
                    near_band(2000, 2000, 5, seed=4)),
    "wideA": lambda: (banded(2200, [-2, 0, 2, 700], seed=5)[:1500],
                      near_band(2200, 500, 4, per_row=4, seed=6)),
    "multitile": lambda: (banded(30000, [-1500, -1, 0, 1, 1500], seed=7),
                          near_band(30000, 10000, 6, seed=8)),
}
# left operands of any pattern (the gather kernel's)
GENERAL = {
    "rectangular": lambda: (near_band(300, 200, 8, seed=1),
                            near_band(200, 150, 5, seed=2)),
    "multichunk": lambda: (near_band(700, 700, 40, seed=1),
                           near_band(700, 300, 20, seed=2)),
    "irregular": lambda: (irregular(800, 0.005, seed=0),
                          near_band(800, 400, 20, per_row=4, seed=9)),
}
# too large for the Pallas interpreter; run on the card only
LARGE = {
    "5pt_2^18": lambda: (banded(1 << 18, [-512, -1, 0, 1, 512], seed=10),
                         near_band(1 << 18, 1 << 16, 3, per_row=4, seed=11)),
}
ALL = {**BANDED, **GENERAL, **LARGE}
