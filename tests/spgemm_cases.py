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


def own_diagonal(n, bw, max_extra, seed):
    """(n, n) matrix that stores every diagonal entry (nonzero) and 0 to
    ``max_extra`` more entries a row within ``bw`` of it.  Its rows differ
    in length, so most of its ELL rows have padding slots, and a padding
    slot's column (the row's own index) is a stored column of that row."""
    rng = np.random.default_rng(seed)
    extra = np.repeat(np.arange(n), rng.integers(0, max_extra + 1, size=n))
    rows = np.concatenate([np.arange(n), extra])
    cols = np.concatenate([np.arange(n), np.clip(
        extra + rng.integers(-bw, bw + 1, size=extra.size), 0, n - 1)])
    vals = rng.standard_normal(rows.size)
    vals[:n] = 1 + rng.random(n)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    A.sum_duplicates()
    A.sort_indices()
    return A


def aggregation(n, size, seed):
    """(n, ceil(n / size)) matrix with one entry a row, in the column of
    the row's aggregate: a tentative prolongator, one slot wide."""
    rng = np.random.default_rng(seed)
    return sp.csr_matrix((1 + rng.random(n), (np.arange(n),
                                              np.arange(n) // size)),
                         shape=(n, -(-n // size)))


def empty_rows(A, every):
    """``A`` with every ``every``-th row left empty (all padding in ELL)."""
    A = sp.csr_matrix(A).tolil()
    A[::every] = 0
    A = A.tocsr()
    A.eliminate_zeros()
    return A


def block_diagonal(n, size, seed):
    """(n, n) matrix of dense ``size`` x ``size`` diagonal blocks."""
    rng = np.random.default_rng(seed)
    return sp.block_diag([rng.standard_normal((size, size))
                          for _ in range(n // size)], format="csr")


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
# the edges of the tiled kernels (a tile is 16 to 256 consecutive rows):
# B padding slots that alias a stored column of their row while the pattern
# holds it, row counts below and one past a tile, B one slot wide (S*T),
# 64 offsets with A and the pattern 64 wide, all three slabs 64 wide, and
# A rows that are all padding; the banded kernel's rectangular A is wideA
EDGES = {
    "alias": lambda: (banded(1000, [-2, -1, 0, 1, 2], seed=12),
                      own_diagonal(1000, 3, 4, seed=13)),
    "tiny": lambda: (banded(37, [-3, 0, 1], seed=14),
                     near_band(37, 13, 2, per_row=2, seed=15)),
    "tile_plus_one": lambda: (banded(257, [-16, -1, 0, 1, 16], seed=16),
                              own_diagonal(257, 2, 3, seed=17)),
    "width_one": lambda: (banded(600, [-1, 0, 1], seed=18),
                          aggregation(600, 3, seed=19)),
    "band64": lambda: (banded(640, list(range(-32, 32)), seed=20, drop=0),
                       aggregation(640, 1, seed=21)),
    "block64": lambda: (block_diagonal(320, 64, seed=22),
                        block_diagonal(320, 64, seed=23)),
    "empty_rows": lambda: (empty_rows(banded(500, [-1, 0, 1], seed=24), 7),
                           near_band(500, 170, 2, per_row=3, seed=25)),
}
# cases whose A has more than 64 offsets: the gather kernel's alone
NOT_BANDED = {*GENERAL, "block64"}
# too large for the Pallas interpreter; run on the card only
LARGE = {
    "5pt_2^18": lambda: (banded(1 << 18, [-512, -1, 0, 1, 512], seed=10),
                         near_band(1 << 18, 1 << 16, 3, per_row=4, seed=11)),
}
ALL = {**BANDED, **GENERAL, **EDGES, **LARGE}
