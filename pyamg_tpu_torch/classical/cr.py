"""Compatible-relaxation (CR) coarsening (host, numpy/scipy).

Port of ``pyamg_tpu/classical/cr.py``: relaxation restricted to the F
points on ``A e = 0`` measures where the error decays slowly; such points
join C until the F-relaxation converges fast enough.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..util.utils import to_csr

__all__ = ["CR", "binormalize"]


def _cr_sweep(A, x, findex, nu, method="habituated"):
    """``nu`` sweeps of F-point relaxation on ``A x = 0`` from x: weighted
    Jacobi everywhere with C reset to 0 ("habituated"), or Gauss-Seidel on
    the F equations ("concurrent").  Returns x and the norm after each
    sweep."""
    from ..relaxation.relaxation import gauss_seidel_indexed, jacobi

    n = A.shape[0]
    b = np.zeros(n)
    norms = []
    for _ in range(nu):
        if method == "habituated":
            jacobi(A, x, b, iterations=1, omega=0.7)
            mask = np.ones(n, dtype=bool)
            mask[findex] = False
            x[mask] = 0.0
        else:
            gauss_seidel_indexed(A, x, b, indices=findex, iterations=1)
        norms.append(np.linalg.norm(x))
    return x, norms


def CR(A, method="habituated", B=None, maxiter=20, nu=3, thetacr=0.7,
       thetacs="auto", seed=0, verbose=False):
    """Compatible-relaxation C/F splitting (1 = C, 0 = F).

    From an all-F start, each iteration relaxes a random error on the F
    points and stops once its convergence factor is below ``thetacr``;
    otherwise the F points whose normalized slow error ``|e / B| / max``
    (``B`` the target smooth vector, constant when None) exceeds
    ``thetacs`` (a float, a schedule consumed one entry an iteration, or
    "auto": 1 - the factor) are candidates, and a greedy independent
    subset of them, heaviest first, joins C.

    Examples
    --------
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> splitting = CR(poisson((8, 8), format='csr'))
    >>> bool(0 < splitting.sum() < 64)
    True
    """
    A = to_csr(A)
    n = A.shape[0]
    if A.shape[0] != A.shape[1]:
        raise ValueError("expected square matrix")
    if method not in ("habituated", "concurrent"):
        raise ValueError("method must be 'habituated' or 'concurrent'")
    if not (0 < thetacr < 1):
        raise ValueError("Must have 0 < thetacr < 1")
    if thetacs != "auto":
        sched = [float(t) for t in (thetacs if isinstance(
            thetacs, (list, tuple)) else [thetacs])]
        if max(sched) >= 1 or min(sched) <= 0:
            raise ValueError("Must have 0 < thetacs < 1")
    else:
        sched = None
    if B is None:
        target = np.ones(n)
    else:
        target = np.asarray(B, dtype=float)
        if target.ndim > 1:
            target = target[:, 0]

    rng = np.random.default_rng(seed)
    splitting = np.zeros(n, dtype=np.int32)
    for it in range(maxiter):
        findex = np.flatnonzero(splitting == 0)
        if findex.size == 0:
            break
        x = np.zeros(n)
        x[findex] = 1.0 - 2.0 * rng.random(findex.size)
        x, norms = _cr_sweep(A, x, findex, nu, method=method)
        rho = (norms[-1] / norms[0]) ** (1.0 / max(len(norms) - 1, 1)) \
            if norms[0] > 0 else 0.0
        if verbose:
            print(f"CR iter {it}: rho = {rho:.3f}, "
                  f"|C| = {int(splitting.sum())}")
        if rho < thetacr:
            break
        if sched is None:
            tcs = 1.0 - rho
        else:
            tcs = sched[0]
            if len(sched) > 1:
                sched.pop(0)
        with np.errstate(divide="ignore", invalid="ignore"):
            e = np.abs(np.where(target != 0,
                                x / np.where(target != 0, target, 1), x))
        emax = e[findex].max() if findex.size else 0.0
        if emax == 0:
            break
        gamma = e / emax
        candidates = findex[gamma[findex] > tcs]
        if candidates.size == 0:
            break
        added = _independent_subset(A, candidates, gamma, splitting)
        if added.size == 0:
            break
        splitting[added] = 1

    if splitting.sum() == 0:
        splitting[int(np.argmax(np.abs(A.diagonal())))] = 1
    return splitting


def _independent_subset(A, candidates, gamma, splitting):
    """A greedy maximal independent subset of the candidates, heaviest
    first by ``omega_i = |N_i in F| + gamma_i``."""
    indptr, indices = A.indptr, A.indices
    nF = np.array([int((splitting[indices[indptr[i]:indptr[i + 1]]]
                        == 0).sum()) for i in candidates], dtype=float)
    order = candidates[np.argsort(-(nF + gamma[candidates]), kind="stable")]
    chosen = []
    excluded = set()
    for i in order:
        if i in excluded:
            continue
        chosen.append(i)
        excluded.update(indices[indptr[i]:indptr[i + 1]].tolist())
    return np.array(chosen, dtype=np.int64)


def binormalize(A, tol=1e-5, maxiter=10):
    """``D A D`` with every row (and column) 2-norm equal, D diagonal
    (after Livne and Golub)."""
    A = to_csr(A).copy()
    d = np.ones(A.shape[0])
    B = A.multiply(A.conjugate()).real.tocsr()
    for _ in range(maxiter):
        beta = B @ d
        beta_mean = beta.mean()
        if np.abs(beta / beta_mean - 1).max() < tol:
            break
        d = d * np.sqrt(beta_mean / np.maximum(beta, 1e-300))
    dsqrt = np.sqrt(np.abs(d))
    D = sp.dia_matrix((dsqrt[None, :], [0]), shape=A.shape)
    return (D @ A @ D).tocsr()
