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


def dense_rows(n, m, width, seed):
    """(n, m) matrix whose row i holds ``width`` consecutive columns from
    ``i * (m - width) // (n - 1)``, random values."""
    rng = np.random.default_rng(seed)
    start = np.arange(n) * (m - width) // max(n - 1, 1)
    cols = (start[:, None] + np.arange(width)[None, :]).ravel()
    return sp.csr_matrix((rng.standard_normal(n * width), cols,
                          np.arange(n + 1) * width), shape=(n, m))


def p27_products(N, omega=0.5):
    """``(A, P, R, A P)`` of HPCG's 27-point operator (26 on the
    diagonal, -1 off it) on N^3 with aggregates of 3 x 3 x 3 nodes and
    P = (I - omega D^-1 A) T: the operands of the set-up's A P and
    R (A P)."""
    idx = np.arange(N ** 3).reshape(N, N, N)
    rows, cols = [], []
    for d in np.ndindex(3, 3, 3):
        lo = [max(0, 1 - k) for k in d]
        hi = [N - max(0, k - 1) for k in d]
        src = idx[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        dst = idx[lo[0] + d[0] - 1:hi[0] + d[0] - 1,
                  lo[1] + d[1] - 1:hi[1] + d[1] - 1,
                  lo[2] + d[2] - 1:hi[2] + d[2] - 1]
        rows.append(src.ravel())
        cols.append(dst.ravel())
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    A = sp.csr_matrix((np.where(rows == cols, 26.0, -1.0), (rows, cols)),
                      shape=(N ** 3, N ** 3))
    M = -(-N // 3)
    i, j, k = np.meshgrid(*(np.arange(N) // 3,) * 3, indexing="ij")
    agg = ((i * M + j) * M + k).ravel()
    T = sp.csr_matrix((np.ones(N ** 3), (np.arange(N ** 3), agg)),
                      shape=(N ** 3, M ** 3))
    P = sp.csr_matrix((sp.identity(N ** 3) - omega / 26.0 * A) @ T)
    R = sp.csr_matrix(P.T)
    for X in (A, P, R):
        X.sort_indices()
    AP = sp.csr_matrix(A @ P)
    AP.sort_indices()
    return A, P, R, AP


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
# slabs wider than 64 slots: A, B and the pattern wider than 64 (gather),
# B and the pattern wider than 64 under a banded A, and the products of
# HPCG's 27-point operator on 12^3 with 3x3x3 aggregates: A P and R (A P),
# R 125 slots wide
WIDE = {
    "wide_gather": lambda: (near_band(160, 1200, 120, per_row=110, seed=30),
                            near_band(1200, 400, 60, per_row=120, seed=31)),
    "wide_banded": lambda: (banded(300, list(range(-30, 30)), seed=32),
                            near_band(300, 300, 60, per_row=120, seed=33)),
    "p27_ap": lambda: p27_products(12)[:2],
    "p27_rap": lambda: p27_products(12)[2:],
}
# cases whose A has more than 64 offsets: the gather kernel's alone
NOT_BANDED = {*GENERAL, "block64", "wide_gather", "p27_rap",
              "wide_rows_2^17", "one_row_tiles"}
# too large for the Pallas interpreter; run on the card only
LARGE = {
    "5pt_2^18": lambda: (banded(1 << 18, [-512, -1, 0, 1, 512], seed=10),
                         near_band(1 << 18, 1 << 16, 3, per_row=4, seed=11)),
    # a row to a thread (enough rows) with A and the pattern over 64 wide
    "wide_rows_2^17": lambda: (near_band(1 << 17, 1 << 17, 60, per_row=100,
                                         seed=36),
                               near_band(1 << 17, 1 << 16, 20, per_row=8,
                                         seed=37)),
}
ALL = {**BANDED, **GENERAL, **EDGES, **WIDE, **LARGE}
# A and the pattern so wide (4,600 and 4,200 slots) that a tile holds one
# row in float32 and in float64: near the kernels' limit; on the card only
AT_THE_LIMIT = {
    "one_row_tiles": lambda: (dense_rows(24, 9000, 4600, seed=34),
                              near_band(9000, 9000, 1, per_row=2, seed=35)),
}
