"""The port's device energy-minimization P and the setups built on it
against the JAX package's.

``pyamg_tpu_torch.parallel.energy.energy_smooth_sharded`` on a CPU device
(its masked products then run the kernels' plain twin) is held against
``pyamg_tpu.parallel.energy.energy_smooth_sharded`` on a one-device mesh
to 1e-12 in float64, and against the host flat path
``energy_prolongation_smoother`` to 1e-9, as ``tests/test_parallel.py``
holds the JAX function; with both weightings and in the root-node form.
Then the three setups that run it -- ``general_sa_setup_sharded`` with
``smooth='energy'``, ``rootnode_setup_sharded`` (with its C-points) and
``adaptive_sa_setup_sharded`` (with its relaxed candidates) -- level by
level at 32^2: A, P and R to 1e-10, the CG count exactly.  A weighting
neither package has raises the same error in both, and every new entry
point refuses several devices.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pyamg_tpu.amg_core as jax_core
import pyamg_tpu.parallel.setup as jax_setups
from pyamg_tpu.aggregation.aggregate import standard_aggregation as jax_std
from pyamg_tpu.aggregation.tentative import fit_candidates as jax_fit
from pyamg_tpu.gallery import poisson as jax_poisson
from pyamg_tpu.parallel import (adaptive_sa_setup_sharded as jax_adaptive,
                                general_sa_setup_sharded as jax_general,
                                make_mesh,
                                rootnode_setup_sharded as jax_rootnode)
from pyamg_tpu.parallel.energy import energy_smooth_sharded as jax_energy
from pyamg_tpu.sparse import SparseELL as JaxELL
from pyamg_tpu.strength import symmetric_strength_of_connection as jax_soc
from pyamg_tpu.util.utils import get_Cpt_params as jax_cpt_params
from pyamg_tpu.util.utils import scale_T as jax_scale_T
import pyamg_tpu_torch.parallel.setup as port_setups
from pyamg_tpu_torch import parallel
from pyamg_tpu_torch.aggregation.smooth import energy_prolongation_smoother
from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.parallel.energy import energy_smooth_sharded
from pyamg_tpu_torch.sparse import SparseELL

torch.set_num_threads(1)

N = 24


def _close(got, ref, rtol):
    got, ref = sp.csr_matrix(got), sp.csr_matrix(ref)
    assert got.shape == ref.shape
    assert abs(got - ref).max() <= rtol * max(abs(ref).max(), 1)


@pytest.fixture(scope="module")
def level0():
    """The first level's T, C and B_c of N^2 Poisson (float64), from the
    JAX package's host stages; and the root-node form's T and
    ``Cpt_params``."""
    A = jax_poisson((N, N), format="csr").astype(np.float64)
    C = jax_soc(A, theta=0.0)
    AggOp, Cnodes = jax_std(sp.csr_matrix(C))
    T, Bc = jax_fit(AggOp, np.ones((A.shape[0], 1)))
    cpt = jax_cpt_params(A, np.asarray(Cnodes), AggOp, sp.csr_matrix(T))
    T_rn = jax_scale_T(sp.csr_matrix(T), cpt["P_I"], cpt["I_F"])
    return A, sp.csr_matrix(C), sp.csr_matrix(T), Bc, T_rn, cpt


def _both(level0, weighting, rootnode):
    A, C, T, Bc, T_rn, cpt = level0
    kw = dict(degree=1, maxiter=4, tol=1e-8, weighting=weighting,
              dt=np.float64)
    if rootnode:
        T = sp.csr_matrix(T_rn)
        kw |= dict(fmask_host=np.asarray(
            sp.csr_matrix(cpt["I_F"]).diagonal()) != 0,
                   PI_host=cpt["P_I"])
        Bc = np.asarray(cpt["P_I"].T @ np.ones((A.shape[0], 1)))
    ours, pat = energy_smooth_sharded(
        SparseELL.from_scipy(A, dtype=np.float64, device="cpu"), T, C, Bc,
        **kw)
    ref, pat_ref = jax_energy(JaxELL.from_scipy(A, dtype=np.float64), T, C,
                              Bc, make_mesh(1), "rows", **kw)
    return ours, pat, ref, pat_ref, T, Bc


@pytest.mark.parametrize("weighting", ["local", "diagonal"])
@pytest.mark.parametrize("rootnode", [False, True],
                         ids=["plain", "root-node"])
def test_energy_p_matches_jax(level0, weighting, rootnode):
    ours, pat, ref, pat_ref, _, _ = _both(level0, weighting, rootnode)
    assert abs(pat - pat_ref).max() == 0
    assert torch.equal(ours.cols, torch.as_tensor(np.array(ref.cols)))
    got, want = ours.data.numpy(), np.asarray(ref.data)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("weighting", ["local", "diagonal"])
def test_energy_p_matches_the_host_flat_path(level0, weighting):
    A, C = level0[0], level0[1]
    ours, _, _, _, T, Bc = _both(level0, weighting, False)
    P_host = energy_prolongation_smoother(
        A, T, C, Bc, None, (False, {}), krylov="cg", maxiter=4, tol=1e-8,
        degree=1, weighting=weighting)
    _close(ours.to_scipy(), P_host, 1e-9)
    # P keeps the candidates: P B_c = B
    assert np.abs(ours.to_scipy() @ Bc - 1.0).max() <= 1e-12


@pytest.mark.parametrize("package", ["port", "jax"])
def test_block_weighting_raises_in_both_packages(level0, package):
    A, C, T, Bc = level0[:4]
    if package == "port":
        call = lambda: energy_smooth_sharded(  # noqa: E731
            SparseELL.from_scipy(A, dtype=np.float64, device="cpu"), T, C,
            Bc, weighting="block", dt=np.float64)
    else:
        call = lambda: jax_energy(  # noqa: E731
            JaxELL.from_scipy(A, dtype=np.float64), T, C, Bc, make_mesh(1),
            "rows", weighting="block", dt=np.float64)
    with pytest.raises(ValueError, match="supports weighting in "
                       r"\('local', 'diagonal'\); got 'block'"):
        call()


# -- the setups ---------------------------------------------------------------

SETUPS = {
    "energy": (parallel.general_sa_setup_sharded, jax_general,
               dict(smooth=("energy", {"maxiter": 4}))),
    "rootnode": (parallel.rootnode_setup_sharded, jax_rootnode, {}),
    "adaptive": (parallel.adaptive_sa_setup_sharded, jax_adaptive,
                 dict(candidate_iters=6)),
}


def _capture_candidates(monkeypatch, module, store):
    """Keep the B that the adaptive setup hands the general setup."""
    real = module.general_sa_setup_sharded

    def spy(A, B=None, **kw):
        store.append(np.asarray(B))
        return real(A, B=B, **kw)

    monkeypatch.setattr(module, "general_sa_setup_sharded", spy)


@pytest.fixture(scope="module", params=list(SETUPS))
def setups(request):
    ours_fn, ref_fn, kw = SETUPS[request.param]
    A = poisson((32, 32), format="csr")
    cands = {"port": [], "jax": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_core, "have_native", lambda: True)
        _capture_candidates(mp, port_setups, cands["port"])
        _capture_candidates(mp, jax_setups, cands["jax"])
        ref = ref_fn(A.copy(), mesh=make_mesh(1), dtype=np.float64,
                     max_coarse=20, **kw)
        ours = ours_fn(A.copy(), dtype=np.float64, max_coarse=20,
                       device="cpu", **kw)
    return request.param, A, ours, ref, cands


def test_setup_matches_jax_level_by_level(setups):
    name, _, ours, ref, cands = setups
    assert len(ours.levels) == len(ref.levels) >= 3
    assert ours.sizes == list(ref.sizes) and ours.n_orig == ref.n_orig
    for lo, lr in zip(ours.levels, ref.levels):
        _close(lo.A_csr, lr.A_csr, 1e-10)
        _close(lo.A.to_scipy(), lr.A.to_scipy(), 1e-10)
        if lr is ref.levels[-1]:
            continue
        _close(lo.P.to_scipy(), lr.P.to_scipy(), 1e-10)
        _close(lo.R.to_scipy(), lr.R.to_scipy(), 1e-10)
        assert lo.presmoother.kind == lr.presmoother.kind
        assert np.array_equal(lo.presmoother.color_masks.numpy(),
                              np.asarray(lr.presmoother.color_masks))
        if name == "rootnode":
            assert np.array_equal(lo.Cpts, lr.Cpts)
    assert ours.inner.operator_complexity() == pytest.approx(
        ref.inner.operator_complexity(), rel=1e-14)
    if name == "adaptive":
        assert len(cands["port"]) == len(cands["jax"]) == 1
        got, want = cands["port"][0], cands["jax"][0]
        assert got.shape == want.shape == (32 * 32, 1)
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_setup_solves_like_jax(setups):
    _, A, ours, ref, _ = setups
    b = A @ np.random.default_rng(0).random(A.shape[0])
    res, res_ref = [], []
    ref.solve(b, tol=1e-8, accel="cg", maxiter=100, residuals=res_ref)
    x = ours.solve(b, tol=1e-8, accel="cg", maxiter=100, residuals=res)
    assert len(res) == len(res_ref) > 3
    np.testing.assert_allclose(res, res_ref, rtol=1e-8)
    assert x.shape == (A.shape[0],)
    assert np.linalg.norm(b - A @ x.numpy()) <= 1e-8 * np.linalg.norm(b)


def test_rootnode_keeps_the_roots_as_identity_rows():
    A = poisson((24, 24), format="csr")
    sol = parallel.rootnode_setup_sharded(A, dtype=np.float64,
                                          max_coarse=20, device="cpu")
    lvl = sol.levels[0]
    P = lvl.P.to_scipy().toarray()
    assert np.array_equal(P[lvl.Cpts], np.eye(P.shape[1]))


def test_rootnode_requires_energy_smoothing():
    with pytest.raises(ValueError, match="'energy' prolongation"):
        parallel.rootnode_setup_sharded(poisson((10, 10), format="csr"),
                                        smooth="jacobi", device="cpu")


@pytest.mark.parametrize("setup", ["energy", "rootnode", "adaptive"])
@pytest.mark.parametrize("how", ["n_devices", "mesh"])
def test_setups_over_several_devices_raise(setup, how):
    """Over several devices the setups need a process group (``launch``;
    ``test_torch_sharded_ell_setup.py`` runs them over ranks), and a mesh
    must be a ``Mesh``."""
    fn, _, kw = SETUPS[setup]
    if how == "n_devices":
        where, error, match = {"n_devices": 2}, ValueError, \
            "requested 2 devices.*launch"
    else:
        where, error, match = {"mesh": object()}, TypeError, "mesh must be"
    with pytest.raises(error, match=match):
        fn(poisson((10, 10), format="csr"), device="cpu", **where, **kw)


def test_energy_smoothing_over_a_mesh_raises(level0):
    """A mesh that is no ``Mesh`` raises as the sharded solvers do."""
    A, C, T, Bc = level0[:4]
    with pytest.raises(TypeError, match="mesh must be"):
        energy_smooth_sharded(
            SparseELL.from_scipy(A, dtype=np.float64, device="cpu"), T, C,
            Bc, object())
