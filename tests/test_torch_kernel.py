"""The kernels' builds, wrappers and launches: the DIA SpMV kernel (float32,
float64, complex64, complex128 and bfloat16 diagonals), its two variants in
other layouts and the two masked-SpGEMM kernels; and the build of the host
library.

This file imports only the port, so that it also runs on a machine with a
card and no JAX.  There, from the repository root:

    python -m pytest --noconftest tests/test_torch_kernel.py -q

(``--noconftest`` skips tests/conftest.py, which configures JAX).  Here, on
the CPU, the ``cuda``-marked tests skip and the build plumbing runs against
a stand-in compiler.
"""

import os
import stat
import sys

import numpy as np
import pytest
import torch

from pyamg_tpu_torch import _build
from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.sparse import SparseDIA, SparseELL, dia_kernel
from pyamg_tpu_torch.sparse import dia_variants, spgemm_kernel
from pyamg_tpu_torch.sparse.spgemm_device import pattern_spgemm, sentinel_cols
from pyamg_tpu_torch.sparse.spgemm_dia import BandedSpgemmPlan

import dia_cases
import spgemm_cases

torch.set_num_threads(1)


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in nvcc that records its arguments and writes the -o file
    (or fails, when FAKE_NVCC_FAIL is set)."""
    script = tmp_path / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import os, sys\n"
        "open(os.environ['FAKE_NVCC_LOG'], 'a').write(' '.join(sys.argv[1:])"
        " + '\\n')\n"
        "if os.environ.get('FAKE_NVCC_FAIL'):\n"
        "    sys.stderr.write('error: bad source\\n'); sys.exit(2)\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('lib')\n"
        "print('ptxas info    : Used 20 registers')\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    (tmp_path / "cuda" / "bin").mkdir(parents=True)
    os.symlink(script, tmp_path / "cuda" / "bin" / "nvcc")
    monkeypatch.setenv("FAKE_NVCC_LOG", str(tmp_path / "calls.log"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return tmp_path


def test_build_targets_sm90a_and_caches_by_source_hash(fake_nvcc):
    out = _build.build("dia_matvec")
    assert out.parent == fake_nvcc / "_build"
    assert out.name.startswith("libdia_matvec-") and out.suffix == ".so"
    assert "ptxas info" in out.with_name(out.name + ".log").read_text()
    calls = (fake_nvcc / "calls.log").read_text().splitlines()
    assert len(calls) == 1
    assert "-gencode arch=compute_90a,code=sm_90a" in calls[0]
    assert str(_build.CSRC / "dia_matvec.cu") in calls[0]
    assert _build.build("dia_matvec") == out          # cached: no rebuild
    assert len((fake_nvcc / "calls.log").read_text().splitlines()) == 1


def test_build_failure_raises_with_the_compiler_message(fake_nvcc,
                                                        monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_FAIL", "1")
    with pytest.raises(RuntimeError, match="bad source"):
        _build.build("dia_matvec")
    assert not list((fake_nvcc / "_build").glob("*.so"))


def test_masked_spgemm_builds_with_the_same_flags(fake_nvcc):
    out = _build.build("masked_spgemm")
    assert out.name.startswith("libmasked_spgemm-")
    calls = (fake_nvcc / "calls.log").read_text().splitlines()
    assert "-gencode arch=compute_90a,code=sm_90a" in calls[0]
    assert str(_build.CSRC / "masked_spgemm.cu") in calls[0]


@pytest.mark.parametrize("source", ["dia_matvec_v2", "dia_matvec_v1"])
def test_dia_variants_build_with_the_same_flags(fake_nvcc, source):
    out = _build.build(source)
    assert out.name.startswith(f"lib{source}-") and out.suffix == ".so"
    calls = (fake_nvcc / "calls.log").read_text().splitlines()
    assert len(calls) == 1
    assert "-gencode arch=compute_90a,code=sm_90a" in calls[0]
    assert str(_build.CSRC / f"{source}.cu") in calls[0]


def test_cpu_tensors_never_load_the_spgemm_library():
    A = SparseELL.from_scipy(poisson((9, 9), format="csr"), device="cpu")
    pat = sentinel_cols(pattern_spgemm(A.to_scipy(), A.to_scipy(),
                                       dtype=np.float64, device="cpu"))
    before = (spgemm_kernel._lib, dict(spgemm_kernel.launches),
              spgemm_kernel.plain_cuda_calls)
    spgemm_kernel.masked_spgemm_gather(A.data, A.cols, A.data, A.cols, pat)
    spgemm_kernel.masked_spgemm_banded(A.data, A.cols, A.data, A.cols, pat,
                                       (-9, -1, 0, 1, 9))
    assert (spgemm_kernel._lib, dict(spgemm_kernel.launches),
            spgemm_kernel.plain_cuda_calls) == before


def test_cpu_tensors_never_load_the_kernel_library():
    A = poisson((20, 20), format="csr")
    D = SparseDIA.from_scipy(A, dtype=np.float32, device="cpu")
    x = torch.ones(A.shape[0])
    before = (dia_kernel._lib, dia_kernel.launches)
    D.matvec(x)
    assert (dia_kernel._lib, dia_kernel.launches) == before


def test_other_devices_raise():
    A = poisson((5, 5), format="csr")
    D = SparseDIA.from_scipy(A, device="cpu")
    meta = SparseDIA(D.diags.to("meta"), D.offsets, D.shape)
    with pytest.raises(ValueError, match="no kernel"):
        meta.matvec(torch.empty(A.shape[0], dtype=torch.float64,
                                device="meta"))


@pytest.mark.parametrize("itemsize", [4, 8, 16])
def test_every_shape_gets_a_route_whose_tile_fits(itemsize):
    """The launcher's choice as the wrapper mirrors it: tall or wide for
    every (n, k), wide only up to the row limit and from the offset limit
    on; the wide route's tile: 512 threads, no idle lane, a grid within
    4 blocks an SM where 512 rows allow it, and its staged products and
    offsets inside the 48 KB a block has without opting in (227 KB with
    it)."""
    for n in (1, 2, 219, 2154, 4096, 8192, 16384, 32768, 65536, 65537,
              131072, 1 << 20, 1 << 22):
        for k in (1, 2, 4, 6, 7, 15, 16, 17, 20, 21, 32, 33, 110, 111, 179,
                  285, 603, 4096):
            r = dia_kernel.route(n, k)
            want = next((k >= least for most, least in
                         ((8192, 7), (16384, 16), (32768, 21), (65536, 111))
                         if n <= most), False)
            assert r == ("wide" if want else "tall"), (n, k)
            rows, chunk = dia_kernel.wide_geometry(n, k, itemsize)
            lanes = dia_kernel.WIDE_THREADS // rows
            assert lanes * rows == dia_kernel.WIDE_THREADS
            assert 4 <= rows <= 512 and lanes <= max(1, k) * 2 - 1
            assert -(-n // rows) <= dia_kernel.WIDE_BLOCKS or rows == 512
            shared = rows * chunk * itemsize + 4 * (32 * 1024 // 16)
            assert chunk >= 1 and shared <= 48 * 1024 < 227 * 1024
    assert dia_kernel.route(4096, 179) == "wide"
    assert dia_kernel.route(1 << 20, 5) == "tall"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the DIA kernel runs only there")
    return torch.device("cuda")


def _ops(rng):
    def rand(offsets, shape):
        return SparseDIA(torch.as_tensor(
            rng.standard_normal((len(offsets), shape[0]))), offsets, shape)

    return [rand((-1024, -1, 0, 1, 1024), (1 << 20, 1 << 20)),
            rand((-2999, -7, 0, 5, 1999), (3000, 2000)),
            rand((-1999, -1, 0, 64, 2999), (2000, 3000)),
            rand((-14, -13, -12, -1, 0, 1, 12, 13, 14), (169, 169)),
            SparseDIA.from_scipy(poisson((37, 29), format="csr"),
                                 device="cpu")] + [
        SparseDIA.from_scipy(case(), max_offsets=1024, device="cpu")
        for case in dia_cases.WIDE.values()]


def _as_dtype(real, dtype, rng):
    """A real tensor in ``dtype``; for a complex dtype with a seeded
    imaginary part of the same size."""
    if not dtype.is_complex:
        return real.to(dtype)
    imag = torch.as_tensor(rng.standard_normal(tuple(real.shape)))
    return torch.complex(real.double(), imag).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["auto", "tall", "wide"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128,
                                   torch.bfloat16])
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, route):
    # each route rounds every product before adding it, in offset order, as
    # the twin does: the real types agree bit for bit (bfloat16 diagonals
    # with a float32 x); torch's complex product fuses multiply-adds
    tol = 1e-5 if dtype == torch.complex64 else 1e-12
    x_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
    rng = np.random.default_rng(0)
    for op in _ops(rng):
        op = SparseDIA(_as_dtype(op.diags, dtype, rng).to(cuda_device),
                       op.offsets, op.shape)
        x = _as_dtype(torch.as_tensor(rng.standard_normal(op.shape[1])),
                      x_dtype, rng).to(cuda_device)
        before = dia_kernel.launches
        y = dia_kernel._dia_matvec_route(op.diags, op.offsets_dev, x,
                                         op.shape[1], route)
        torch.cuda.synchronize()
        assert dia_kernel.launches == before + 1
        y_ref = op.matvec_plain(x)
        if dtype.is_complex:
            assert float((y - y_ref).abs().max()) <= \
                tol * float(y_ref.abs().max()), op.shape
        else:
            assert torch.equal(y, y_ref), (op.shape, op.n_offsets)


@pytest.mark.cuda
def test_cuda_route_choice_agrees_with_the_launcher(cuda_device):
    lib = dia_kernel.load()
    for n in (1, 219, 2154, 4096, 8192, 16384, 32768, 65536, 65537,
              1 << 20):
        for k in (1, 6, 7, 15, 16, 20, 21, 110, 111, 179, 603):
            assert lib.dia_matvec_route(n, k) == dia_kernel.ROUTES[
                dia_kernel.route(n, k)], (n, k)
            for itemsize in (4, 8, 16):
                rows, chunk = dia_kernel.wide_geometry(n, k, itemsize)
                assert lib.dia_matvec_wide_rows(n, k, itemsize) == rows
                assert lib.dia_matvec_wide_chunk(n, k, itemsize) == chunk


@pytest.mark.cuda
def test_cuda_refused_route_raises(cuda_device, monkeypatch):
    D = SparseDIA.from_scipy(poisson((8, 8), format="csr"),
                             device=cuda_device)
    x = torch.ones(D.shape[1], dtype=D.dtype, device=cuda_device)
    monkeypatch.setitem(dia_kernel.ROUTES, "bogus", 7)
    before = dia_kernel.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        dia_kernel._dia_matvec_route(D.diags, D.offsets_dev, x, D.shape[1],
                                     "bogus")
    assert dia_kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("op_dtype", [torch.complex64, torch.complex128])
def test_cuda_complex_default_call_solves_through_the_kernel(cuda_device,
                                                             op_dtype):
    """A complex Hermitian gauge Laplacian through the default call on the
    card: every DIA matvec on the complex kernel entries, no plain twin."""
    import pyamg_tpu_torch
    from pyamg_tpu_torch.gallery import gauge_laplacian

    A = gauge_laplacian(96, beta=0.1, seed=0)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(A.shape[0]) + 1j * rng.standard_normal(A.shape[0])
    ml = pyamg_tpu_torch.smoothed_aggregation_solver(
        A, max_coarse=20, op_dtype=op_dtype, device=cuda_device)
    cpu = pyamg_tpu_torch.smoothed_aggregation_solver(
        A, max_coarse=20, op_dtype=op_dtype, device="cpu")
    before = dia_kernel.launches
    single = op_dtype == torch.complex64
    res, res_cpu = [], []
    x = ml.solve(b, tol=1e-5 if single else 1e-10, accel="cg", residuals=res)
    cpu.solve(b, tol=1e-5 if single else 1e-10, accel="cg",
              residuals=res_cpu)
    assert dia_kernel.launches > before and x.dtype == op_dtype
    assert abs(len(res) - len(res_cpu)) <= (1 if single else 0)
    r = np.linalg.norm(b - A @ x.cpu().numpy().astype(np.complex128))
    assert r <= (5e-5 if single else 1e-9) * np.linalg.norm(b)


@pytest.mark.cuda
def test_cuda_solve_runs_through_the_kernel(cuda_device):
    import pyamg_tpu_torch

    A = poisson((81, 81), format="csr")
    b = A @ np.random.default_rng(0).random(A.shape[0])
    ml = pyamg_tpu_torch.smoothed_aggregation_solver(
        A, max_coarse=50, presmoother="chebyshev", postsmoother="chebyshev",
        improve_candidates=None, op_dtype=torch.float32, device=cuda_device)
    before = dia_kernel.launches
    x = ml.solve_mp(b, tol=1e-10, method="defect")
    assert dia_kernel.launches > before
    assert x.device.type == "cuda"
    x = x.cpu().numpy()
    assert np.linalg.norm(b - A @ x) <= 5e-10 * np.linalg.norm(b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["grid", "plain", "unstructured"])
@pytest.mark.parametrize("cycle", ["V", "AMLI"])
def test_cuda_default_call_cycles_like_the_cpu(cuda_device, case, cycle):
    """The default-argument hierarchy on the card (DIA levels and embedded
    transfers on the kernel, gather-form Gauss-Seidel, the coarse solve)
    against the same hierarchy on the CPU, one cycle in float64."""
    import scipy.sparse as sp

    import pyamg_tpu_torch
    import sa_cases

    def matrix():             # a fresh one each time: a copy loses A.grid
        if case == "unstructured":
            return sa_cases.unstructured(5000, seed=7, radius=0.03)
        A = poisson((128, 128), format="csr")
        return sp.csr_matrix(A.tocoo()) if case == "plain" else A

    kw = dict(max_coarse=100, coarse_solver="splu")
    A = matrix()
    on_card = pyamg_tpu_torch.smoothed_aggregation_solver(
        A, device=cuda_device, **kw)
    on_cpu = pyamg_tpu_torch.smoothed_aggregation_solver(
        matrix(), device="cpu", **kw)
    assert hasattr(on_cpu.levels[0], "struct_meta") == (case == "grid")
    rng = np.random.default_rng(0)
    x0, b = rng.standard_normal(A.shape[0]), rng.standard_normal(A.shape[0])
    before = dia_kernel.launches
    y = on_card.cycle_fn(cycle)(torch.as_tensor(x0, device=cuda_device),
                                torch.as_tensor(b, device=cuda_device))
    y_ref = on_cpu.cycle_fn(cycle)(torch.from_numpy(x0), torch.from_numpy(b))
    assert y.device.type == "cuda"
    if case != "unstructured":
        assert dia_kernel.launches > before
    else:
        assert on_card.levels[0].presmoother.color_rows.is_cuda
    assert float((y.cpu() - y_ref).abs().max()) <= \
        1e-10 * float(y_ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_schwarz_and_block_lines_step_like_the_cpu(cuda_device, dtype):
    """The Schwarz step and the node-blocked zebra sweep (plain torch: the
    gather of the subdomain residuals, the fixed-order sum of the
    corrections, the block cyclic reduction) on the card against the same
    state on the CPU; the Schwarz step twice, for the same bits."""
    import scipy.sparse as sp

    from pyamg_tpu_torch.multilevel import Level
    from pyamg_tpu_torch.relaxation import device, smoothing
    from pyamg_tpu_torch.sparse import device_operator

    tol = 1e-5 if dtype == torch.float32 else 1e-12
    rng = np.random.default_rng(0)
    A = poisson((64, 64), format="csr")
    M = rng.standard_normal((2, 2))
    A2 = sp.kron(poisson((32, 24), format="csr"),
                 M @ M.T + 2 * np.eye(2)).tocsr()
    for name, B, grid, q in (("schwarz", A, None, 1),
                             ("zebra", A2, (32, 24), 2)):
        x0, b = rng.standard_normal((2, B.shape[0]))
        out = {}
        for dev in ("cpu", cuda_device):
            lvl = Level(A_csr=B, grid=grid, blocksize=q)
            lvl.A = device_operator(B, dtype=dtype, device=dev)
            sm = smoothing.make_smoother_data(lvl, name, {}, dtype=dtype,
                                              device=dev)
            xs = [torch.as_tensor(v, dtype=dtype, device=dev)
                  for v in (x0, b)]
            out[str(dev)] = [device.apply_smoother(sm, lvl.A, *xs)
                             for _ in range(2)]
        y, y_cpu = out["cuda"][0], out["cpu"][0]
        assert y.is_cuda and torch.equal(y, out["cuda"][1])
        assert float((y.cpu() - y_cpu).abs().max()) <= \
            tol * float(y_cpu.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_spgemm_kernels_match_plain_version(cuda_device, dtype):
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for label, case in spgemm_cases.ALL.items():
        A_csr, B_csr = case()
        A = SparseELL.from_scipy(A_csr, dtype=dtype, device=cuda_device)
        B = SparseELL.from_scipy(B_csr, dtype=dtype, device=cuda_device)
        pat_ell = pattern_spgemm(A_csr, B_csr, device=cuda_device)
        pat = sentinel_cols(pat_ell)
        ref = spgemm_kernel.masked_matmul_vals_plain(A.data, A.cols, B.data,
                                                     B.cols, pat)
        scale = float(ref.abs().max())
        plan = BandedSpgemmPlan(A, B, pat_ell)
        runs = [("masked_spgemm_gather", lambda: spgemm_kernel.
                 masked_spgemm_gather(A.data, A.cols, B.data, B.cols, pat))]
        if plan.feasible:
            runs.append(("masked_spgemm_banded", lambda: plan(A, B).data))
        for name, run in runs:
            before = spgemm_kernel.launches[name]
            out = run()
            torch.cuda.synchronize()
            assert spgemm_kernel.launches[name] == before + 1
            err = float((out - ref).abs().max())
            assert err <= tol * scale, (label, name, err / scale)
        assert plan.feasible == (label not in spgemm_cases.NOT_BANDED), label


@pytest.mark.cuda
def test_cuda_spgemm_kernels_on_the_smallest_tile(cuda_device, monkeypatch):
    # 16-row tiles: many tiles a block, so the persistent loop's double
    # buffer turns over, and the slotwise bodies on the same operands
    monkeypatch.setattr(spgemm_kernel, "SHARED_TARGET", 0)
    for label, case in spgemm_cases.ALL.items():
        A_csr, B_csr = case()
        A = SparseELL.from_scipy(A_csr, dtype=np.float64, device=cuda_device)
        B = SparseELL.from_scipy(B_csr, dtype=np.float64, device=cuda_device)
        pat_ell = pattern_spgemm(A_csr, B_csr, device=cuda_device)
        slabs = (A.data, A.cols, B.data, B.cols, sentinel_cols(pat_ell))
        ref = spgemm_kernel.masked_matmul_vals_plain(*slabs)
        plan = BandedSpgemmPlan(A, B, pat_ell)
        outs = [spgemm_kernel.masked_spgemm_gather(*slabs),
                spgemm_kernel._masked_spgemm_gather_slotwise(*slabs)]
        if plan.feasible:
            outs += [spgemm_kernel.masked_spgemm_banded(*slabs, plan.offsets),
                     spgemm_kernel._masked_spgemm_banded_slotwise(
                         *slabs, plan.offsets)]
        torch.cuda.synchronize()
        for out in outs:
            assert torch.equal(out, ref), label


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_wide_spgemm_kernels_equal_the_twin(cuda_device, dtype):
    # slabs wider than 64 slots, down to tiles of one row: each kernel the
    # router may take gives the plain twin's values bit for bit
    cases = {**spgemm_cases.WIDE, **spgemm_cases.AT_THE_LIMIT,
             "wide_rows_2^17": spgemm_cases.LARGE["wide_rows_2^17"]}
    for label, case in cases.items():
        A_csr, B_csr = case()
        A = SparseELL.from_scipy(A_csr, dtype=dtype, device=cuda_device)
        B = SparseELL.from_scipy(B_csr, dtype=dtype, device=cuda_device)
        pat_ell = pattern_spgemm(A_csr, B_csr, device=cuda_device)
        slabs = (A.data, A.cols, B.data, B.cols, sentinel_cols(pat_ell))
        ref = spgemm_kernel.masked_matmul_vals_plain(*slabs)
        plan = BandedSpgemmPlan(A, B, pat_ell)
        assert plan.feasible == (label not in spgemm_cases.NOT_BANDED), label
        outs = {"masked_spgemm_gather":
                spgemm_kernel.masked_spgemm_gather(*slabs)}
        if plan.feasible:
            outs["masked_spgemm_banded"] = plan(A, B).data
        torch.cuda.synchronize()
        for name, out in outs.items():
            assert torch.equal(out, ref), (label, name)


@pytest.mark.cuda
def test_cuda_shared_bytes_agree_with_the_kernel(cuda_device):
    lib = spgemm_kernel.load()
    for rows in spgemm_kernel.TILE_ROWS + (8, 4, 2, 1):
        for w_a, w_out, itemsize, k in [(15, 10, 4, 0), (5, 6, 4, 5),
                                        (64, 64, 8, 64), (1, 1, 8, 1),
                                        (125, 27, 4, 0), (4600, 4195, 8, 0)]:
            assert lib.masked_spgemm_shared_bytes(rows, w_a, w_out, itemsize,
                                                  k) == spgemm_kernel.\
                shared_bytes(rows, w_a, w_out, itemsize, k)


@pytest.mark.cuda
def test_cuda_general_setup_runs_through_the_kernels(cuda_device):
    from pyamg_tpu_torch.parallel import general_sa_setup_sharded

    A = poisson((96, 96), format="csr")
    before = (dict(spgemm_kernel.launches), spgemm_kernel.plain_cuda_calls)
    sol = general_sa_setup_sharded(A, dtype=np.float64, device=cuda_device)
    for name in spgemm_kernel.launches:
        assert spgemm_kernel.launches[name] > before[0][name], name
    assert spgemm_kernel.plain_cuda_calls == before[1]
    ref = general_sa_setup_sharded(A, dtype=np.float64, device="cpu")
    assert len(sol.levels) == len(ref.levels)
    for lo, lr in zip(sol.levels, ref.levels):
        d = abs(lo.A_csr - lr.A_csr)
        assert (d.max() if d.nnz else 0.0) <= 1e-12 * abs(lr.A_csr).max()
    b = A @ np.random.default_rng(0).random(A.shape[0])
    res, res_ref = [], []
    x = sol.solve(b, tol=1e-8, accel="cg", maxiter=100, residuals=res)
    ref.solve(b, tol=1e-8, accel="cg", maxiter=100, residuals=res_ref)
    assert x.device.type == "cuda" and len(res) == len(res_ref)
    x = x.cpu().numpy()
    assert np.linalg.norm(b - A @ x) <= 1e-8 * np.linalg.norm(b)


def _variant(kernel, D, device):
    """``(launch, plain)`` of one DIA kernel on the float32 operator ``D``
    moved to ``device``: a variant, or dia_matvec on bfloat16 diagonals."""
    d = D.diags.to(device, torch.float32)
    if kernel == "dia_matvec_bf16":
        Db = SparseDIA(d.to(torch.bfloat16), D.offsets, D.shape)
        return Db.matvec, Db.matvec_plain
    return (lambda x: getattr(dia_variants, kernel)(d, D.offsets, x),
            lambda x: getattr(dia_variants, kernel + "_plain")(d, D.offsets,
                                                               x))


def _launches(kernel):
    if kernel == "dia_matvec_bf16":
        return dia_kernel.launches
    return dia_variants.launches[kernel]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["dia_matvec_v2", "dia_matvec_v1",
                                    "dia_matvec_bf16"])
def test_cuda_dia_variants_match_plain_version(cuda_device, kernel):
    # float32 sums of a few terms; bfloat16 diagonals: the twin does the
    # same float32 arithmetic in the same order
    tol = 1e-6 if kernel == "dia_matvec_bf16" else 1e-5
    rng = np.random.default_rng(0)
    for label, case in dia_cases.ALL.items():
        D = SparseDIA.from_scipy(case(), dtype=np.float32, device="cpu")
        launch, plain = _variant(kernel, D, cuda_device)
        x = torch.as_tensor(rng.random(D.shape[0], dtype=np.float32),
                            device=cuda_device)
        before = _launches(kernel)
        y = launch(x)
        torch.cuda.synchronize()
        assert _launches(kernel) == before + 1
        y_ref = plain(x)
        assert y.dtype == torch.float32 and bool(torch.isfinite(y).all())
        err = float((y - y_ref).abs().max())
        assert err <= tol * float(y_ref.abs().max()), (label, err)


@pytest.mark.cuda
def test_cuda_device_setups_build_like_the_cpu(cuda_device):
    """The structured device setup (power steps and comb probes on the DIA
    kernel) and the energy CG (its products routed once a level, through
    the SpGEMM kernels) on the card against the same setups on the CPU,
    in float64."""
    import scipy.sparse as sp

    from pyamg_tpu_torch.aggregation.device_setup import structured_sa_setup
    from pyamg_tpu_torch.parallel import general_sa_setup_sharded

    A = poisson((48, 48), format="csr")
    built = {str(dev): structured_sa_setup(A, (48, 48), dtype=torch.float64,
                                           max_coarse=50, device=dev)
             for dev in ("cpu", cuda_device)}
    assert len(built["cuda"].levels) == len(built["cpu"].levels) == 3
    for lg, lc in zip(built["cuda"].levels, built["cpu"].levels):
        assert lg.A.diags.is_cuda and lg.A.offsets == lc.A.offsets
        assert float((lg.A.diags.cpu() - lc.A.diags).abs().max()) <= \
            1e-12 * float(lc.A.diags.abs().max())
    before = dict(spgemm_kernel.launches)
    energy = {str(dev): general_sa_setup_sharded(
        A, smooth=("energy", {"maxiter": 4}), dtype=np.float64,
        max_coarse=50, device=dev) for dev in ("cpu", cuda_device)}
    assert sum(spgemm_kernel.launches.values()) > sum(before.values())
    for lg, lc in zip(energy["cuda"].levels[:-1], energy["cpu"].levels[:-1]):
        diff = sp.csr_matrix(lg.P.to_scipy() - lc.P.to_scipy())
        assert abs(diff).max() <= 1e-12 * abs(lc.P.to_scipy()).max()
