"""The device adaptive SA setup's CG count as the grid grows, in both
packages, on the CPU.

``adaptive_sa_setup_sharded`` at its defaults (one candidate, 8 Jacobi
sweeps, float32) on N x N Poisson in the JAX package (``make_mesh(1)``)
and in the port (``device="cpu"``): the relaxed candidates against each
other, every level's A against each other, and both CG solves to 1e-8
(iterations, tracked and true float64 relres):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/adaptive_growth.py 128 256 512
"""

import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import pyamg_tpu.amg_core as jax_core  # noqa: E402
import pyamg_tpu.parallel.setup as jax_setups  # noqa: E402
import pyamg_tpu_torch.parallel.setup as port_setups  # noqa: E402
from pyamg_tpu.parallel import make_mesh  # noqa: E402
from pyamg_tpu_torch.gallery import poisson  # noqa: E402


def keep_candidates(module, store):
    """Record the B that the adaptive setup hands the general setup."""
    real = module.general_sa_setup_sharded

    def spy(A, B=None, **kw):
        store.append(np.asarray(B))
        return real(A, B=B, **kw)

    module.general_sa_setup_sharded = spy


def cg(sol, A, b):
    res = []
    x = np.asarray(sol.solve(b, tol=1e-8, accel="cg", maxiter=2000,
                             residuals=res), dtype=np.float64)
    return (len(res) - 1, float(res[-1] / res[0]),
            float(np.linalg.norm(b - A @ x) / np.linalg.norm(b)))


def main(grids):
    torch.set_num_threads(2)
    jax_core.have_native = lambda: True
    cj, cp = [], []
    keep_candidates(jax_setups, cj)
    keep_candidates(port_setups, cp)
    for N in grids:
        A = poisson((N, N), format="csr")
        b = A @ np.random.default_rng(0).random(A.shape[0])
        ref = jax_setups.adaptive_sa_setup_sharded(A.copy(),
                                                   mesh=make_mesh(1),
                                                   dtype=np.float32)
        ours = port_setups.adaptive_sa_setup_sharded(A.copy(),
                                                     dtype=np.float32,
                                                     device="cpu")
        cand = float(np.abs(cp[-1] - cj[-1]).max() / np.abs(cj[-1]).max())
        levels = [(lo.A_csr.shape[0], float(abs(lo.A_csr - lr.A_csr).max()
                                            / abs(lr.A_csr).max()))
                  for lo, lr in zip(ours.levels, ref.levels)]
        print(f"N={N}: candidate max rel {cand:.2e}; levels (rows, A max "
              f"rel) {levels}", flush=True)
        print(f"   CG (iterations, tracked, true relres): JAX "
              f"{cg(ref, A, b)}  port {cg(ours, A, b)}", flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [128, 256, 512])
