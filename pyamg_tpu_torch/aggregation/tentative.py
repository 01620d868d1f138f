"""Tentative prolongator: a per-aggregate QR of the near-nullspace.

Port of ``fit_candidates`` (``pyamg_tpu/aggregation/tentative.py``).  The
aggregates are padded to a common size and factored by one batched QR;
with one candidate and one dof per node the QR is a column normalization
done by one bincount.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["fit_candidates", "ben_ideal_interpolation"]


def ben_ideal_interpolation(*args, **kwargs):
    """:func:`pyamg_tpu_torch.aggregation.rootnode_nii.ben_ideal_interpolation`
    under the name it has in this module in the JAX package."""
    from .rootnode_nii import ben_ideal_interpolation as impl

    return impl(*args, **kwargs)


def fit_candidates(AggOp, B, tol=1e-10):
    """Fit the near-nullspace candidates B (n_dof, K) into the aggregates
    of ``AggOp`` (n_nodes, n_agg); a node carries ``n_dof / n_nodes``
    dofs.

    Returns (T, coarse_B): T (n_dof, n_agg * K) has orthonormal columns
    per aggregate and ``T @ coarse_B`` reproduces B on aggregated rows.
    Each R factor is signed to a non-negative diagonal, and a candidate
    whose R diagonal falls under ``tol`` times the largest R diagonal of
    all aggregates is dropped from its aggregate.

    Examples
    --------
    >>> import numpy as np
    >>> import scipy.sparse as sp
    >>> AggOp = sp.csr_matrix(np.array([[1., 0], [1, 0], [0, 1], [0, 1]]))
    >>> T, Bc = fit_candidates(AggOp, np.ones((4, 1)))
    >>> bool(np.allclose(T @ Bc, 1.0))
    True
    """
    AggOp = sp.csr_matrix(AggOp)
    B = np.asarray(B)
    if B.ndim == 1:
        B = B[:, None]
    n_dof, K = B.shape
    n_nodes, n_agg = AggOp.shape
    if n_dof % n_nodes:
        raise ValueError("B rows must be a multiple of AggOp rows")
    bs = n_dof // n_nodes

    if K == 1 and bs == 1:
        nnz_row = np.diff(AggOp.indptr)
        if nnz_row.max(initial=0) <= 1:
            agg_of = AggOp.indices
            vals = np.ravel(B)[nnz_row.astype(bool)]
            nrm = np.sqrt(np.bincount(agg_of, weights=np.abs(vals) ** 2,
                                      minlength=n_agg))
            keep = nrm > tol * max(nrm.max(initial=0.0), 1e-300)
            safe = np.where(keep, nrm, 1.0)
            data = vals / safe[agg_of] * keep[agg_of]
            T = sp.csr_matrix((data.astype(B.dtype), AggOp.indices,
                               AggOp.indptr), shape=(n_nodes, n_agg))
            Bc = (nrm * keep).astype(B.dtype)[:, None]
            return T, Bc

    # the dof rows of every aggregate, padded to the largest with -1
    Acsc = AggOp.tocsc()
    agg_sizes = np.diff(Acsc.indptr)
    max_nodes = int(agg_sizes.max()) if n_agg else 0
    L = max_nodes * bs
    node_idx = np.full((n_agg, max_nodes), -1, dtype=np.int64)
    agg_of_entry = np.repeat(np.arange(n_agg), agg_sizes)
    pos_in_agg = np.arange(Acsc.indices.size) - \
        np.repeat(Acsc.indptr[:-1], agg_sizes)
    node_idx[agg_of_entry, pos_in_agg] = Acsc.indices
    valid_nodes = node_idx >= 0
    safe_nodes = np.where(valid_nodes, node_idx, 0)
    dof_idx = (safe_nodes[:, :, None] * bs +
               np.arange(bs)[None, None, :]).reshape(n_agg, L)
    valid = np.repeat(valid_nodes, bs, axis=1)
    blocks = B[dof_idx] * valid[:, :, None]     # (n_agg, L, K)

    if K == 1:
        # one candidate: the thin QR is a column normalization
        nrm = np.sqrt((np.abs(blocks[:, :, 0]) ** 2).sum(axis=1))
        safe = np.where(nrm > 0, nrm, 1.0)
        Q = (blocks / safe[:, None, None]).astype(blocks.dtype, copy=False)
        R = nrm.astype(blocks.dtype)[:, None, None]
    else:
        Q, R = np.linalg.qr(blocks, mode="reduced")
        Q = np.ascontiguousarray(Q)
        R = np.ascontiguousarray(R)

    # sign (phase) fix: R's diagonal real and non-negative
    for k in range(min(K, R.shape[1])):
        dk = R[:, k, k]
        if np.iscomplexobj(R):
            phase = np.where(np.abs(dk) > 0, dk / np.abs(np.where(
                np.abs(dk) > 0, dk, 1)), 1.0)
            R[:, k, :] = R[:, k, :] * np.conj(phase)[:, None]
            Q[:, :, k] = Q[:, :, k] * phase[:, None]
        else:
            sgn = np.where(dk < 0, -1.0, 1.0)
            R[:, k, :] = R[:, k, :] * sgn[:, None]
            Q[:, :, k] = Q[:, :, k] * sgn[:, None]

    # drop numerically dependent candidates per aggregate
    diagR = np.abs(np.diagonal(R, axis1=1, axis2=2))      # (n_agg, K)
    rank_mask = diagR > tol * max(diagR.max(initial=0.0), 1e-300)
    Q = Q * rank_mask[:, None, :]
    R = R * rank_mask[:, :, None]

    # T: aggregate a holds rows dof_idx[a] and columns a*K .. a*K+K-1
    rows = dof_idx.reshape(-1).repeat(K)
    cols = (np.arange(n_agg)[:, None, None] * K +
            np.arange(K)[None, None, :])
    cols = np.broadcast_to(cols, (n_agg, L, K)).reshape(-1)
    vals = (Q * valid[:, :, None]).reshape(-1)
    keep = np.abs(vals) > 0
    T = sp.coo_matrix((vals[keep], (rows[keep], cols[keep])),
                      shape=(n_dof, n_agg * K)).tocsr()
    return T, R.reshape(n_agg * K, K)
