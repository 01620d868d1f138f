"""Smoke run of pyamg_tpu_torch on one NVIDIA GPU.

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version, drives the port's paths and
times each kernel beside its plain version, its least possible time (its
bytes over the card's memory rate) and the one PyTorch library call that
computes the same function:

* the structured path on the 1024^2 5-point Poisson problem (1,048,576
  unknowns): smoothed aggregation on the grid, solved to a float64
  relative residual of 1e-10 by float32 V-cycle-preconditioned CG inside
  float64 defect correction (kernel: dia_matvec);
* the general path on the same problem: ``parallel.general_sa_setup_sharded``
  in float32, its Galerkin products on the card (kernels:
  masked_spgemm_banded and masked_spgemm_gather), then CG with multicolor
  Gauss-Seidel V-cycles to 1e-8; all 15 of the setup's masked products are
  recorded, checked and timed on both kernel bodies (tiled, and the first
  slotwise one kept as a comparator);
* HPCG's 27-point operator (26 on the diagonal, -1 on each of the 26
  neighbours) on the 104^3 grid of its ``hpcg.dat``, as plain CSR through
  ``parallel.general_sa_setup_sharded`` in float32 (phase 39): every
  masked product of the setup held against the twin, the tiled bodies bit
  for bit, and level-0 A*P (27 wide) and R*(A*P) (R 125 wide) timed
  against their bounds beside the setup's own ``spgemm`` spans (kernels:
  masked_spgemm_banded and masked_spgemm_gather on slabs past 64 slots);
* the DIA SpMV benchmark (``pyamg_tpu_torch.benchmarks.dia_spmv_bench``) at
  2048^2 and 1024^2: every DIA kernel -- dia_matvec in float32 and on
  bfloat16 diagonals, dia_matvec_v1, dia_matvec_v2 -- beside the plain form
  and cuSPARSE's CSR SpMV;
* the front-door call ``smoothed_aggregation_solver(A)`` with every
  argument at its default (float32 operators) on the same 1024^2 problem,
  once as the gallery matrix with its grid metadata and once as plain CSR
  without it: CG to 1e-8, stand-alone V-cycles and, on the first
  hierarchy, one W, F and AMLI cycle and every dense coarse solver; then
  ``aspreconditioner`` inside scipy's CG at 256^2 (kernel: dia_matvec on
  every DIA level and DIA transfer);
* the compiled host library (``pyamg_tpu_torch.amg_core``), built with the
  kernels and held against its Python forms at 1024^2; the run fails if it
  did not load, so every setup above ran the compiled route;
* the Krylov suite: every ``accel`` of ``solve`` and a callable on the
  default 1024^2 hierarchy, ``solve_mp`` with BiCGStab and GMRES,
  stand-alone GMRES and BiCGStab in float64 on the 64^2 Poisson problem and
  on the generated nonsymmetric ``recirc_flow`` example, and a
  ``MultilevelSolverSet`` of the two default hierarchies;
* a complex Hermitian operator, ``gauge_laplacian(1024)``, through the
  default call in complex64 (kernel: dia_matvec's complex64 and complex128
  entries, timed at 2048^2);
* blocked smoothed aggregation on Q1 linear elasticity with its three
  rigid-body modes: ``benchmarks/suite.py``'s ``elasticity_1m_energy_sa``
  (724^2 nodes, 1,048,352 dofs, BSR 2x2, energy-minimization P,
  ``solve_mp`` to 1e-10) setup stage by stage, and at its
  ``elasticity_rbm_sa`` size (100^2) the energy call, the default call
  (Jacobi P on the structured path, ``SparseBDIA`` smoothers) and the
  same matrix as CSR with B (kernel: dia_matvec on level 0 flattened to
  21 scalar diagonals and on every DIA level below);
* classical AMG, ``benchmarks/suite.py``'s first two configurations:
  ``classical_poisson_500`` (``ruge_stuben_solver(A, CF="RS")``, float32
  operators, ``solve_mp`` to 1e-10; held against the reference pyamg's
  fingerprint of the hierarchy; with multicolor Gauss-Seidel and with zebra
  line relaxation) and ``anisotropic_1024_classical`` (the rotated
  anisotropic stencil at 1024^2, evolution strength, standard
  interpolation), setup stage by stage (kernel: dia_matvec on every DIA
  level and C-point-embedded DIA transfer); then the same operator through
  ``parallel.classical_setup_sharded`` in float32, its masked products on
  masked_spgemm_banded and masked_spgemm_gather, and CG to 1e-6;
* the symmetric SA front doors: ``benchmarks/suite.py``'s
  ``poisson3d_64_sa_chebyshev`` (64^3 Poisson, (2, 2, 2) grid blocks,
  Chebyshev, float32, ``solve_mp`` to 1e-10) and the default call on the
  same 3-D matrix (the unstructured chain); its
  ``adaptive_sa_anisotropy_1024`` (``adaptive_sa_solver`` with zebra on
  the grid-aligned anisotropic stencil, semicoarsened levels);
  ``rootnode_solver(A)`` on the 1024^2 Poisson problem with its grid and
  as plain CSR (root-embedded DIA transfers); the black box
  ``pyamg_tpu_torch.solve(A, b)``; and the work models of those
  hierarchies (kernel: dia_matvec on every DIA level and transfer, timed
  at the 3-D level-0 and widest coarse shapes);
* the nonsymmetric chain on recirculating convection-diffusion
  (``recirc_flow``, generated here at 1024^2): nonsymmetric smoothed
  aggregation with energy-GMRES P, R smoothed on A^H and Jacobi on the
  normal equations as smoother (float32 operators; ``solve_mp`` with
  GMRES to 1e-10, GMRES to 1e-8, cgnr and cgne), then at 256^2
  nonsymmetric root-node SA, the black box and the NE/NR and Krylov
  smoothers (kernel: dia_matvec on every DIA level, the explicit-R
  root-embedded transfers and A^H);
* the rest of the smoother menu and the Lloyd and pairwise aggregations:
  ``adaptive_sa_anisotropy_K2_1024`` (``adaptive_sa_solver`` with two
  candidates, full (3, 3) grid blocks and zebra on the anisotropic
  stencil: block-tridiagonal line relaxation on every level of two dofs a
  node, ``solve_mp`` to 1e-10); overlapping Schwarz smoothers on the
  1024^2 Poisson hierarchy (CG, ``solve_mp``, the fixed-order sum of the
  corrections, ``strength_based_schwarz``); ``aggregate="lloyd"`` and
  pairwise aggregation on the same matrix as plain CSR (kernel:
  dia_matvec on every DIA level and transfer);
* the device setups on one card: ``structured_sa_setup_sharded`` on the
  1024^2 problem with ``max_coarse=500`` (the sharded suite's headline,
  ``benchmarks/suite.py:262-280``: every numeric setup step on the card,
  the Galerkin product by comb probes), ``shard_structured_solver`` and CG
  to 1e-6, ``solve_mp`` to 1e-10; its level-1 operator against the
  float64 scipy product R A P; ``structured_sa_setup`` on 64^3 (27 probes
  a level); a checkpoint round trip (``save_hierarchy``,
  ``load_hierarchy``); then the device energy, root-node and adaptive SA
  setups at 1024^2 stage by stage, CG to 1e-8 and ``solve_mp`` to 1e-10,
  every masked product of their energy CG and Galerkin products held
  against the twin (kernels: dia_matvec in the power steps, the probes
  and the cycles; masked_spgemm_banded and masked_spgemm_gather in the
  energy CG and the products);
* the other constructors on the 1024^2 Poisson problem as plain CSR,
  every argument at its default (float64 operators):
  ``aggregation.newideal_solver`` (local least-squares ideal interpolation,
  solved as one batched pseudo-inverse) and the recursive adaptive SA
  ``aggregation.asa_solver``, setup stage by stage, CG to 1e-8 and
  ``solve_mp`` to 1e-10; the profiling tools on the card
  (``util.profiling``: cycle times, a ``torch.profiler`` trace that must
  name dia_matvec's kernel, solve timings, ``profile_solver``, the level
  spectra of a 256^2 hierarchy) and ``sparse.rap`` on the card against
  scipy; dia_matvec's float64 entry at level 0, warm and cold, beside its
  twin, its bound and cuSPARSE (kernel: dia_matvec on every DIA level);
* the distributed path (phase 37, ``torch.distributed`` through
  ``parallel.launch``): the sharded suite's headline built and solved over
  4 gloo ranks that share the card (exchanges staged through pinned host
  memory) and held against phase 33's one-card build, the same at 512^2
  over 8 ranks (the JAX package's 8-device record), on one NCCL rank, and
  ``shard_solver`` of the plain-CSR default call over 4 ranks (halo-ELL
  levels); every rank counts its dia_matvec launches on its row slabs,
  holds them bitwise against the twin and makes no twin call on CUDA, and
  its host seconds inside collectives; the headline's setup and solve run
  again with rank 0 under ``torch.profiler`` for its device-busy time
  (kernel: dia_matvec on rectangular slabs, offsets shifted by the halo);
* the ELL-product setups over ranks (phase 38): the sharded suite's
  anisotropic classical cell (``benchmarks/suite.py:289-311``, evolution
  strength, RS, standard interpolation, float32) at 1024^2 built slab by
  slab over 4 gloo ranks sharing the card and on one NCCL rank, held to
  phase 23's one-card build; ``general_sa_setup_sharded`` on the
  plain-CSR 1024^2 Poisson problem and the energy, root-node and adaptive
  setups over the same 4 ranks, held to phases 5 and 34; every rank holds
  only its rows of each level's A, P and R, gets the same pattern hashes,
  launches the SpGEMM kernels on its slabs (B's rows that its rows of A
  name fetched from the other ranks) and holds each product against the
  twin, and makes no twin call on CUDA (kernels: masked_spgemm_banded and
  masked_spgemm_gather on rank slabs, timed at the largest);
* dia_matvec at every DIA shape that the phases' hierarchies hold or
  their paths launched, with its launches there: both of the kernel's
  routes (a thread a row; threads over (row, offset) pairs for short,
  wide operators) held bitwise against the plain version and timed
  beside cuSPARSE and the bound, the launcher's route named; the widest
  shape's numbers join dia_matvec's record on the kernels line.  Every
  hierarchy's levels and operator complexity are held to their record
  (``HIERARCHY_PINS``).

    python3 chip_smoke.py          # from the repository root, one GPU

Without a CUDA device it exits non-zero and prints no result.  Every phase
raises on failure.  The line before the last is the kernels' record; the
last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import functools
import inspect
import json
import pathlib
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

GRID = (1024, 1024)
TOL = 1e-10
REL_TOL = {"float32": 1e-5, "float64": 1e-12,   # kernel vs plain, max rel
           "complex64": 1e-5, "complex128": 1e-12,
           "bfloat16": 1e-6}    # bf16 diagonals: the twin's float32 sums
BENCH_GRIDS = (2048, 1024)
F32_FLOP_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
F64_FLOP_PER_S = 34e12          # ... and float64 (NVIDIA's data sheet)
KERNELS = {
    "dia_matvec": {"route": "cuda",
                   "source": "pyamg_tpu_torch/csrc/dia_matvec.cu",
                   "replaces": "pyamg_tpu/sparse/pallas_kernels.py:182"},
    "masked_spgemm_banded": {
        "route": "cuda", "source": "pyamg_tpu_torch/csrc/masked_spgemm.cu",
        "replaces": "pyamg_tpu/sparse/spgemm_dia.py:157"},
    "masked_spgemm_gather": {
        "route": "cuda", "source": "pyamg_tpu_torch/csrc/masked_spgemm.cu",
        "replaces": "pyamg_tpu/sparse/spgemm_pallas.py:238"},
    "dia_matvec_v2": {"route": "cuda",
                      "source": "pyamg_tpu_torch/csrc/dia_matvec_v2.cu",
                      "replaces": "pyamg_tpu/sparse/pallas_kernels.py:111"},
    "dia_matvec_v1": {"route": "cuda",
                      "source": "pyamg_tpu_torch/csrc/dia_matvec_v1.cu",
                      "replaces": "pyamg_tpu/sparse/pallas_kernels.py:246"},
    # the complex entries of dia_matvec.cu: the JAX package sends a complex
    # DIA operator through the kernel's plain form (matvec_xla)
    "dia_matvec_c64": {"route": "cuda",
                       "source": "pyamg_tpu_torch/csrc/dia_matvec.cu",
                       "replaces": "pyamg_tpu/sparse/pallas_kernels.py:182"},
    "dia_matvec_c128": {"route": "cuda",
                        "source": "pyamg_tpu_torch/csrc/dia_matvec.cu",
                        "replaces": "pyamg_tpu/sparse/pallas_kernels.py:182"},
}
SETUP_KW = dict(max_coarse=500, presmoother="chebyshev",
                postsmoother="chebyshev", improve_candidates=None)
# the general path's hierarchy of GRID, as the JAX package builds it
# (general_sa_setup_sharded, float32, one device): rows and nnz per level
GENERAL_LEVELS = [(1048576, 5238784), (175104, 1572176), (19537, 175673),
                  (2154, 21246), (219, 2359), (22, 194)]


# phase 39: HPCG's 27-point operator on the HPCG_GRID^3 grid of its
# hpcg.dat through the general setup, as the benchmark's hpcg27_104
# configuration calls it (float32, every other argument at its default):
# rows per level, measured on an NVIDIA H100 80GB HBM3
HPCG_GRID = 104
HPCG_LEVELS = [1124864, 42875, 1728, 64]
# the default call's hierarchies of GRID and their solves, measured on an
# NVIDIA H100 80GB HBM3 (no record of the JAX package at this size exists):
# rows per level, operator complexity to 3 places, CG iterations to 1e-8
# and stand-alone V-cycles to a tracked relative residual of 1e-6, which
# float32 cycling reaches (both +-1)
GAUGE = dict(npts=1024, beta=0.1, seed=0)     # the complex Hermitian problem
# stand-alone float64 Krylov on the 64^2 Poisson problem to 1e-10: the JAX
# package's recorded counts (benchmarks/results/round4_v5e1.json:173-199).
# GMRES without restart is reproducible; BiCGStab's count moves with
# round-off (153 there, 154 and 151 on two CPU references)
KRYLOV_64 = dict(gmres=(204, 2), bicgstab=(153, 12))
ACCELS = ("cg", "bicgstab", "gmres", "fgmres", "cr", "steepest_descent",
          "minimal_residual", "cgnr", "cgne")
# the normal-equation methods square the condition number and the cycle
# does not precondition the normal system: they stall
ACCELS_STALL = ("cgnr", "cgne")
# the blocked elasticity cells of benchmarks/suite.py:410-445; the 1M
# cell's reference is 16 iterations (reference_cpu.json:128-149) and the
# JAX package's record 15 (ROUND4_NOTES.md:50-57)
ELASTICITY_1M = dict(grid=(724, 724), iters=15, iters_tol=2, opc_max=1.4)
ELASTICITY_RBM = (100, 100)
ELASTICITY_KW = dict(max_coarse=100, smooth=("energy", {"maxiter": 2}))
# the classical cells of benchmarks/suite.py:358-390: the JAX package's
# inner iterations of solve_mp to 1e-10 (tests/test_multilevel.py:388-428
# for classical_poisson_500: 8 with multicolor GS, 7 with zebra, the
# reference's 7; its structural record 12 for the anisotropic cell, where
# the reference takes 20: benchmarks/reference_cpu.json:2-29)
CLASSICAL_500 = dict(grid=(500, 500), iters={"gauss_seidel": 8, "zebra": 7})
ANISO = dict(grid=(1024, 1024), iters=12,
             stencil=dict(epsilon=0.01, theta=np.pi / 4, type="FD"),
             strength=("evolution", {"k": 2, "epsilon": 4.0}))
# classical_setup_sharded's grid (suite.py:289-313: CG to 1e-6 in 60)
SHARDED_GRID = (1024, 1024)
FINGERPRINTS = ("tests", "fixtures", "rs_reference_fingerprints.json")
# the symmetric SA front doors (phases 24-27).  poisson3d_64_sa_chebyshev
# (benchmarks/suite.py:393-408): the JAX package's record 14 inner
# iterations (benchmarks/results/round4_v5e1.json), the reference's 13
# (reference_cpu.json).  adaptive_sa_anisotropy_1024 (suite.py:448-468):
# the JAX record 12 (round4_v5e1.json), +-3 (the suite's comment says 15
# for the later code, and the JAX package's count at this size was not
# measured on a CPU).  rootnode_solver and the black box have no record at
# 1M: their counts are the card's own, and the CPU tests hold both
# packages equal
POISSON3D = dict(grid=(64, 64, 64), iters=14, block=(2, 2, 2))
ASA = dict(grid=(1024, 1024), iters=12, iters_tol=3,
           stencil=dict(epsilon=0.001, theta=0.0, type="FD"),
           kw=dict(num_candidates=1, candidate_iters=15, max_coarse=100,
                   prepostsmoother="zebra"))
ROOTNODE_GRID = (1024, 1024)
BLACKBOX_GRID = (1024, 1024)
# the nonsymmetric chain (phase 29): recirculating convection-diffusion at
# 1024^2 through nonsymmetric SA with the configuration of the JAX
# package's tests/test_aggregation.py::test_nonsymmetric_mode; root-node
# SA, the black box and the smoothers on the normal equations and the
# Krylov smoothers at 256^2.  The JAX package's own tests pin no count:
# every count here is the card's
NONSYM = dict(grid=1024, small=256, kw=dict(
    symmetry="nonsymmetric",
    smooth=("energy", {"krylov": "gmres", "maxiter": 2}),
    presmoother=("gauss_seidel_nr", {"sweep": "symmetric"}),
    postsmoother=("gauss_seidel_nr", {"sweep": "symmetric"}),
    max_coarse=500))
NONSYM_SMOOTHERS = ("jacobi_ne", "gauss_seidel_ne", "cgnr", "cgne", "cg",
                    "gmres")
# the rest of the smoother menu and the Lloyd and pairwise aggregations
# (phases 30-32).  adaptive_sa_anisotropy_K2_1024: the protocol of
# benchmarks/reference_harness/our_k2.py (two candidates, full (3, 3)
# grid blocks, zebra), whose operator complexity 1.90 and 10 inner
# iterations the JAX package's notes record (ROUND5_NOTES.md:31-35; no
# committed artifact); the Schwarz and the Lloyd and pairwise hierarchies
# have no record at 1M: their counts are the card's own, and the CPU tests
# hold both packages equal
K2 = dict(grid=(1024, 1024), iters=10, iters_tol=2, opc_max=2.1,
          stencil=dict(epsilon=0.001, theta=0.0, type="FD"),
          kw=dict(num_candidates=2, candidate_iters=5,
                  prepostsmoother="zebra",
                  aggregate=("grid", {"block": (3, 3)}), max_coarse=100))
SCHWARZ_KW = dict(presmoother="schwarz", postsmoother="schwarz",
                  max_coarse=500)
AGGREGATIONS = {"lloyd": "lloyd", "pairwise": ("pairwise", {"matchings": 2})}
DEFAULT_SA = {
    "structured": dict(rows=[1048576, 116964, 12996, 1444, 169], opc=1.225,
                       cg=9, cycles=10),
    "unstructured": dict(rows=[1048576, 175104, 19537, 2154, 219], opc=1.338,
                         cg=8, cycles=7),
}
# levels and operator complexity (to 6 places) of every hierarchy the
# phases build, as PERF.md section 2 records them (measured on an NVIDIA
# H100 80GB HBM3 by this script): the host stages of the setups decide
# them, except those of the device-built structured hierarchies, whose
# coarse stencils the comb probes compute on the card
HIERARCHY_PINS = {
    "structured path": (5, 1.224878),
    "default call, A.grid": (5, 1.224878),
    "default call, plain CSR": (5, 1.338144),
    "elasticity_1m_energy_sa": (5, 1.281555),
    "elasticity 100^2, energy": (4, 1.285393),
    "elasticity 100^2, default (Jacobi P, structured)": (3, 1.282527),
    "elasticity 100^2, CSR with B": (3, 1.438578),
    "classical_poisson_500, gauss_seidel": (6, 2.197930),
    "classical_poisson_500, zebra": (6, 2.197930),
    "anisotropic_1024_classical": (9, 1.972363),
    "poisson3d_64_sa_chebyshev": (5, 1.962051),
    "64^3 default call": (4, 1.550486),
    "adaptive_sa_anisotropy_1024": (9, 1.890048),
    "rootnode_solver, grid": (5, 1.338143),
    "rootnode_solver, plain CSR": (5, 1.338143),
    "black box": (4, 1.883869),
    "recirc_flow 1024^2, nonsymmetric SA": (5, 1.338143),
    "recirc_flow 256^2, nonsymmetric root-node": (4, 1.341215),
    "recirc_flow 256^2, black box": (4, 1.364530),
    "adaptive_sa_anisotropy_K2_1024": (6, 1.899639),
    "schwarz SA 1024^2": (5, 1.224878),
    "lloyd SA 1024^2": (4, 1.056553),
    "pairwise SA 1024^2": (7, 2.782670),
    "device structured SA 1024^2": (5, 1.224878),
    "device structured SA 64^3": (4, 1.150867),
    "energy SA (device)": (6, 1.338179),
    "root-node SA (device)": (6, 1.338179),
    "adaptive SA (device)": (6, 1.338179),
    "newideal_solver 1024^2": (6, 1.337429),
    "asa_solver 1024^2": (6, 3.335670),
}
# the device setups (phases 33-34): the sharded suite's headline
# (benchmarks/suite.py:262-280: structured_sa_setup_sharded at 1024^2,
# max_coarse=500, float32, CG to 1e-6 in 60 iterations at most) and the
# 64^3 device-built hierarchy
DEVICE_SA = dict(max_coarse=500, maxiter=60, grid3d=(64, 64, 64),
                 # the adaptive setup's default 8 Jacobi sweeps leave a rough
                 # candidate at 1M unknowns: its solves take hundreds of
                 # iterations, timed once, and over ~450 iterations float32
                 # CG's true residual drifts from its recursive one (true
                 # 8.8e-7 at a tracked 9.6e-9 on an NVIDIA H100 80GB HBM3,
                 # 700 W): its CG is held to the float32 floor of so long
                 # a run, its solve_mp to 5e-10 as the others
                 cg={"adaptive SA (device)": dict(maxiter=2000, repeats=1)},
                 mp={"adaptive SA (device)": dict(inner_maxiter=400,
                                                   repeats=1)},
                 cg_relres={"adaptive SA (device)": 2e-6})
# the other constructors (phases 35-36) on the 1024^2 Poisson problem as
# plain CSR, every argument at its default: newideal_solver (a weak
# preconditioner in both packages: its CG count doubles with the grid) and
# the recursive adaptive SA asa_solver (the JAX package's CPU runs take 11
# or 12 CG iterations at 128^2 to 512^2); the spectra of the 256^2
# asa_solver hierarchy (ARPACK on every level)
# phase 37: the sharded suite's headline built and solved over ranks
# (gloo ranks sharing the card; one NCCL rank), the JAX package's 8-device
# record at 512^2 (benchmarks/results/sharded_cpu8.json: 7 CG iterations,
# relres 1.98e-7), and shard_solver of the plain-CSR default call
RANKS = dict(ranks=4, ranks_512=8, grid_512=(512, 512), cg_512=7,
             timeout=600)
NEWIDEAL = dict(maxiter=2000)
ASA_NEW = dict(cg=12, cg_tol=3, spectrum_grid=256)
# short, wide random operators held on both routes of dia_matvec in phase
# 3: the widest DIA level of poisson3d_64_sa_chebyshev, level 3 of the
# plain-CSR default hierarchy, and a 603-offset smoother's width
WIDE_CASES = ((4096, 179), (2154, 285), (4096, 603))
# dia_matvec launches on the paths by (rows, cols, offsets, dtype), the
# offsets tensor each shape was first launched with, and the hierarchies
# (with the offsets of each of their DIA operators) that hold each shape
SHAPE_LAUNCHES = {}
SHAPE_OFFSETS = {}
SHAPE_SOURCES = {}
# phase 33's one-card headline hierarchy (rows, CG count, diagonals), which
# phase 37 holds the build over ranks against; the shapes of the row slabs
# the ranks of phase 37 launched dia_matvec on
PHASE33 = {}
RANK_SLABS = set()
# phase 38: the ELL-product setups over ranks (4 gloo ranks sharing the
# card, one NCCL rank), held to phase 23's one-card classical build
# (PHASE23: its float32 levels, opc and CG count), phase 5's general
# hierarchy, phase 34's pins and phase 34's adaptive setup (PHASE34: its
# candidate and its first CG residuals)
ELL_RANKS = dict(ranks=4, timeout=900, adaptive_iters=20, res_rel=1e-3,
                 cand_rel=1e-6)
PHASE23 = {}
PHASE34 = {}


def phase(name):
    print(f"== {name}", flush=True)


def find_card(torch):
    phase("1. card")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False -- "
                 "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.cuda.get_device_name(0)}, "
          f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")


def build_kernels():
    """One nvcc per source, all started together, then load each."""
    phase("2. build")
    from pyamg_tpu_torch import _build, amg_core
    from pyamg_tpu_torch.sparse import dia_kernel, dia_variants, spgemm_kernel

    t0 = time.perf_counter()
    sources = ("dia_matvec", "masked_spgemm", "dia_matvec_v2",
               "dia_matvec_v1")
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        host = pool.submit(_build.build_host, "amg_core")
        libs = list(pool.map(_build.build, sources))
        host_lib = host.result()
    if not amg_core.have_native():
        raise AssertionError("the host library amg_core did not load: the "
                             "setups would run their Python forms")
    print(f"host library {host_lib.name} built with "
          f"{_build.host_compilers()[0][0]} and loaded")
    dia_kernel.load()
    spgemm_kernel.load()
    dia_variants.load("dia_matvec_v2")
    dia_variants.load("dia_matvec_v1")
    print(f"{', '.join(sources)} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for lib in libs:
        print(lib.with_name(lib.name + ".log").read_text().strip())


def check_kernel(torch, rng):
    """DIA kernel vs plain version on the card: random operators (tall
    and short, wide ones, rectangular ones) on both of the kernel's routes
    in float32, float64 and on bfloat16 diagonals, then the structured
    probe hierarchy's operators on the route the launcher chooses; returns
    the largest absolute difference seen."""
    phase("3. dia_matvec vs plain")
    import pyamg_tpu_torch
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.sparse import SparseDIA

    def random_dia(offsets, shape):
        return SparseDIA(torch.as_tensor(
            rng.standard_normal((len(offsets), shape[0]))), offsets, shape)

    cases = [
        ("n=2^20, 5-point", random_dia((-1024, -1, 0, 1, 1024),
                                       (1 << 20, 1 << 20))),
        ("rectangular 3000x2000", random_dia((-2999, -7, 0, 5, 1999),
                                             (3000, 2000))),
        ("rectangular 2000x3000", random_dia((-1999, -1, 0, 64, 2999),
                                             (2000, 3000))),
        ("tiny n=169, 9-point", random_dia(
            (-14, -13, -12, -1, 0, 1, 12, 13, 14), (169, 169))),
    ]
    for n, k in WIDE_CASES:
        offsets = tuple(int(o) for o in np.sort(rng.choice(
            np.arange(-(n - 1), n), size=k, replace=False)))
        cases.append((f"wide {n}x{n}, {k} offsets",
                      random_dia(offsets, (n, n))))
    # both routes of the kernel on every case, bfloat16 diagonals too
    worst = hold_dia_cases(torch, rng, cases, (torch.float32, torch.float64,
                                               torch.bfloat16),
                           routes=("tall", "wide"))
    t0 = time.perf_counter()
    probe = pyamg_tpu_torch.smoothed_aggregation_solver(
        poisson(GRID, format="csr"), device="cuda", **SETUP_KW)
    print(f"float64 probe hierarchy of {GRID}: {len(probe.levels)} levels "
          f"in {time.perf_counter() - t0:.1f} s")
    cases = []
    for i, lvl in enumerate(probe.levels):
        cases.append((f"level {i} A {lvl.A.shape} offsets "
                      f"{len(lvl.A.offsets)}", lvl.A))
        if getattr(lvl, "P", None) is not None:
            cases.append((f"level {i} S {lvl.P.ops[0].shape}", lvl.P.ops[0]))
            cases.append((f"level {i} S^H {lvl.R.ops[-1].shape}",
                          lvl.R.ops[-1]))
    return max(worst, hold_dia_cases(torch, rng, cases))


def hold_dia_cases(torch, rng, cases, dtypes=None, routes=("auto",)):
    """dia_matvec on each of ``routes`` of the kernel ("auto": the one its
    launcher chooses) against ``op.matvec_plain`` on the card for every
    ``(label, SparseDIA)`` of ``cases``, in each of ``dtypes`` (float32
    and float64 by default; bfloat16 diagonals take a float32 x) on a
    random x; raises beyond REL_TOL, and on any difference at all from a
    wide-route launch in a real dtype (it adds as the twin does); returns
    the largest absolute difference.  The kernel launches made here are
    taken off the counts."""
    from pyamg_tpu_torch.sparse import SparseDIA, dia_kernel

    before = dia_kernel.launches, dict(dia_kernel.entry_launches)
    worst = 0.0
    for dtype in dtypes or (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        x_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
        for label, op in cases:
            op = SparseDIA(op.diags.to("cuda", dtype), op.offsets, op.shape)
            x = rng.standard_normal(op.shape[1])
            if dtype.is_complex:
                x = x + 1j * rng.standard_normal(op.shape[1])
            x = torch.as_tensor(x, device="cuda", dtype=x_dtype)
            y_ref = op.matvec_plain(x)
            for route in routes:
                y = dia_kernel._dia_matvec_route(op.diags, op.offsets_dev, x,
                                                 op.shape[1], route)
                torch.cuda.synchronize()
                taken = route if route != "auto" else dia_kernel.route(
                    op.shape[0], op.n_offsets)
                err = float((y - y_ref).abs().max())
                rel = err / max(float(y_ref.abs().max()), 1e-300)
                if not (bool(torch.isfinite(y).all()) and rel <= REL_TOL[name]
                        and (err == 0.0 or dtype.is_complex
                             or taken != "wide")):
                    raise AssertionError(f"dia_matvec {name} {label} route "
                                         f"{taken}: max abs error {err:.3e},"
                                         f" rel {rel:.3e}")
                worst = max(worst, err)
                print(f"{name:10s} {label:42s} {taken:4s}  max abs {err:.3e} "
                      f"rel {rel:.3e}")
    dia_kernel.launches = before[0]
    dia_kernel.entry_launches.update(before[1])
    return worst


def dia_operators(ml):
    """Every SparseDIA that a hierarchy's cycle applies, labelled: the
    levels' A, the DIA factors of composed transfers and the embedded DIA
    operators of Cpt transfers."""
    from pyamg_tpu_torch.sparse import SparseDIA

    def parts(op):
        if isinstance(op, SparseDIA):
            return [op]
        if hasattr(op, "dia"):
            return [op.dia]
        return [o for o in getattr(op, "ops", ()) if isinstance(o, SparseDIA)]

    cases = []
    for i, lvl in enumerate(ml.levels):
        for role in ("A", "P", "R"):
            for op in parts(getattr(lvl, role, None)):
                cases.append((f"level {i} {role} {tuple(op.shape)} offsets "
                              f"{len(op.offsets)}", op))
    return cases


def record_hierarchy(name, ml):
    """Hold a hierarchy's levels and operator complexity to
    ``HIERARCHY_PINS[name]`` and enter the shapes of its DIA operators
    (rows, cols, offsets, dtype) in ``SHAPE_SOURCES`` for phase 28;
    returns its ``dia_operators``."""
    cases = dia_operators(ml)
    for _, op in cases:
        key = (op.shape[0], op.shape[1], op.n_offsets,
               str(op.dtype).split(".")[-1])
        SHAPE_SOURCES.setdefault(key, (op.offsets, set()))[1].add(name)
    levels, opc = len(ml.levels), f"{ml.operator_complexity():.6f}"
    want = HIERARCHY_PINS[name]
    print(f"{name}: levels {levels}, operator complexity {opc} (recorded "
          f"{want[0]}, {want[1]:.6f}); {len(cases)} DIA operators")
    if (levels, opc) != (want[0], f"{want[1]:.6f}"):
        raise AssertionError(f"{name}: {levels} levels, operator complexity "
                             f"{opc}; PERF.md records {want}")
    return cases


def main_path(torch):
    """The structured 1024^2 solve through the package's entry points;
    returns the hierarchy and the DIA kernel's launch count over it."""
    phase("4. structured path")
    import pyamg_tpu_torch
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.sparse import dia_kernel

    A = poisson(GRID, format="csr")
    n = A.shape[0]
    b = A @ np.random.default_rng(0).random(n)
    normb = np.linalg.norm(b)

    dia_kernel.launches = 0
    twin = [0]
    with counting_twin_calls(torch, twin):
        t0 = time.perf_counter()
        ml = pyamg_tpu_torch.smoothed_aggregation_solver(
            A, op_dtype=torch.float32, device="cuda", **SETUP_KW)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        opc = ml.operator_complexity()
        print(ml)
        print(f"setup_s {setup_s:.3f}  levels {len(ml.levels)}  "
              f"operator_complexity {opc:.6f}")

        def solve():
            return ml.solve_mp(b, tol=TOL, method="defect", inner_maxiter=40,
                               max_rounds=4, inner_tol_factor=1e-6,
                               return_info=True)

        x, info = solve()
        torch.cuda.synchronize()
        launches_first = dia_kernel.launches
        x_np = x.cpu().numpy()
        relres = np.linalg.norm(b - A @ x_np) / normb
        # the JAX bench counts the inner CG iterations of each round;
        # solve_mp's count adds one per round (the residual of its start)
        cg_iters = info["inner_iterations"] - info["rounds"]
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve()
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        print(f"solve_mp(defect): rounds {info['rounds']}  inner CG "
              f"iterations {cg_iters} (solve_mp count "
              f"{info['inner_iterations']})  true f64 relres {relres:.3e}  "
              f"finite {bool(np.isfinite(x_np).all())}")
        print(f"solve_s best of 3 {min(runs):.4f}  runs "
              f"{[round(r, 4) for r in runs]} (after the first solve, which "
              f"also builds the float64 operator)  dia_matvec launches in the "
              f"first solve {launches_first}")

        res = []
        x_cg, it_info = ml.solve(b, tol=1e-8, accel="cg", residuals=res,
                                 return_info=True)
        torch.cuda.synchronize()
        relres_cg = (np.linalg.norm(b - A @ x_cg.double().cpu().numpy())
                     / normb)
        print(f"solve(accel='cg', tol=1e-8) float32: iterations "
              f"{len(res) - 1}  info {it_info}  true f64 relres "
              f"{relres_cg:.3e}")
    launches = dia_kernel.launches
    record_hierarchy("structured path", ml)

    if len(ml.levels) != 5:
        raise AssertionError(f"expected 5 levels, got {len(ml.levels)}")
    if round(opc, 3) != 1.225:
        raise AssertionError(f"expected operator complexity 1.225, got {opc}")
    if not (np.isfinite(x_np).all() and relres <= 5 * TOL):
        raise AssertionError(f"relres {relres} > {5 * TOL}")
    if abs(cg_iters - 18) > 1:
        raise AssertionError(f"inner CG iterations {cg_iters}, expected 18±1")
    if launches_first <= 0:
        raise AssertionError("the solve launched no dia_matvec kernel")
    if not np.isfinite(relres_cg):
        raise AssertionError("float32 PCG returned a non-finite solution")
    if twin[0]:
        raise AssertionError(f"the plain twin ran on CUDA {twin[0]} times")

    # the same path at a size a direct solver checks: 64^2 against spsolve
    from scipy.sparse.linalg import spsolve

    As = poisson((64, 64), format="csr")
    bs = np.random.default_rng(1).random(As.shape[0])
    mls = pyamg_tpu_torch.smoothed_aggregation_solver(
        As, op_dtype=torch.float32, device="cuda",
        **dict(SETUP_KW, max_coarse=50))
    xs = mls.solve_mp(bs, tol=TOL, method="defect").cpu().numpy()
    x_ref = spsolve(As.tocsc(), bs)
    diff = np.linalg.norm(xs - x_ref) / np.linalg.norm(x_ref)
    print(f"64^2 check against scipy spsolve: relative difference "
          f"{diff:.3e}")
    if not diff <= 1e-8:
        raise AssertionError(f"64^2 solution differs from spsolve: {diff}")
    return ml, launches


@contextlib.contextmanager
def recording_products(store, limit, module=None, names=("S*T", "A*P",
                                                        "R*AP")):
    """Keep the operands ``(label, A, B, pattern)`` of the first ``limit``
    masked products of a device setup (``module``, by default the general
    one: S*T, A*P, R*AP of each level in turn, labelled by ``names``) while
    passing every call on unchanged."""
    if module is None:
        from pyamg_tpu_torch.parallel import setup as module

    real = module.masked_spgemm_auto
    k_level = len(names)

    def record(A, B, pattern, **kw):
        if len(store) < limit:
            k = len(store)
            store.append((f"level {k // k_level} {names[k % k_level]}", A, B,
                          pattern))
        return real(A, B, pattern, **kw)

    module.masked_spgemm_auto = record
    try:
        yield
    finally:
        module.masked_spgemm_auto = real


def general_path(torch):
    """The general device setup of the 1024^2 problem and its CG solve
    through the package's entry points; returns the SpGEMM kernels' launch
    counts over the setup and all of its masked products, recorded."""
    phase("5. general path")
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.parallel import general_sa_setup_sharded
    from pyamg_tpu_torch.sparse import spgemm_kernel

    A = poisson(GRID, format="csr")
    b = A @ np.random.default_rng(0).random(A.shape[0])
    products = []
    for name in spgemm_kernel.launches:
        spgemm_kernel.launches[name] = 0
    spgemm_kernel.plain_cuda_calls = 0
    t0 = time.perf_counter()
    with recording_products(products, 3 * (len(GENERAL_LEVELS) - 1)):
        sol = general_sa_setup_sharded(A, dtype=np.float32, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    launches = dict(spgemm_kernel.launches)
    plain_calls = spgemm_kernel.plain_cuda_calls
    opc = sol.inner.operator_complexity()
    print(sol)
    print(f"setup_s {setup_s:.3f} (host stages on the compiled amg_core "
          f"library)  levels {len(sol.levels)}  "
          f"operator_complexity {opc:.6f}  launches {launches}  plain twin "
          f"calls on CUDA {plain_calls}")

    runs = []
    for _ in range(3):
        res = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = sol.solve(b, tol=1e-8, accel="cg", maxiter=200, residuals=res)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    x = x.double().cpu().numpy()
    relres = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
    iters = len(res) - 1
    print(f"solve(accel='cg', tol=1e-8) float32: iterations {iters}  true "
          f"f64 relres {relres:.3e}  finite {bool(np.isfinite(x).all())}  "
          f"solve_s best of 3 {min(runs):.4f}  runs "
          f"{[round(r, 4) for r in runs]}")

    got = [(lvl.A_csr.shape[0], lvl.A_csr.nnz) for lvl in sol.levels]
    if got != GENERAL_LEVELS:
        raise AssertionError(f"levels (rows, nnz) {got}, expected "
                             f"{GENERAL_LEVELS}")
    if round(opc, 3) != 1.338:
        raise AssertionError(f"expected operator complexity 1.338, got {opc}")
    if abs(iters - 9) > 1:
        raise AssertionError(f"CG iterations {iters}, expected 9±1")
    if not (np.isfinite(x).all() and relres <= 5e-7):
        raise AssertionError(f"relres {relres} > 5e-7")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a SpGEMM kernel never launched: {launches}")
    if plain_calls:
        raise AssertionError(f"the setup ran the plain twin on CUDA "
                             f"{plain_calls} times")
    if len(products) != sum(launches.values()):
        raise AssertionError(f"recorded {len(products)} masked products, "
                             f"the kernels launched {launches}")
    return launches, products


def spgemm_bodies(A, B, pattern):
    """The slabs of one masked product and ``{kernel: (tiled, slotwise,
    geometry)}``: the gather kernel's two bodies and the tiled body's
    launch geometry, and the banded kernel's where its plan takes A --
    which the router then chooses."""
    from pyamg_tpu_torch.sparse import spgemm_kernel as sk
    from pyamg_tpu_torch.sparse.spgemm_device import sentinel_cols
    from pyamg_tpu_torch.sparse.spgemm_dia import BandedSpgemmPlan

    slabs = (A.data, A.cols, B.data, B.cols, sentinel_cols(pattern))
    shape = (A.data.shape[0], A.width, B.width, pattern.width,
             A.data.element_size())
    bodies = {"masked_spgemm_gather": (
        functools.partial(sk.masked_spgemm_gather, *slabs),
        functools.partial(sk._masked_spgemm_gather_slotwise, *slabs),
        sk.tile_geometry(*shape))}
    plan = BandedSpgemmPlan(A, B, pattern)
    if plan.feasible:
        bodies["masked_spgemm_banded"] = (
            functools.partial(sk.masked_spgemm_banded, *slabs, plan.offsets),
            functools.partial(sk._masked_spgemm_banded_slotwise, *slabs,
                              plan.offsets),
            sk.tile_geometry(*shape, len(plan.offsets)))
    return slabs, bodies


def routed(bodies):
    """The kernel the router sends the product to."""
    return "masked_spgemm_banded" if "masked_spgemm_banded" in bodies \
        else "masked_spgemm_gather"


def check_spgemm(torch, products):
    """Both SpGEMM kernels, tiled and slotwise bodies, vs their plain twin
    on the card, on the test shapes and on every recorded product of the 1M
    setup, in float32 and float64; returns the largest absolute difference
    per kernel and body."""
    phase("6. masked_spgemm kernels vs plain")
    from pyamg_tpu_torch.sparse import SparseELL
    from pyamg_tpu_torch.sparse.spgemm_device import pattern_spgemm

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "tests"))
    import spgemm_cases

    def ell(M):
        return SparseELL.from_scipy(M, dtype=np.float64, device="cuda")

    cases = []
    for label, case in spgemm_cases.ALL.items():
        A, B = case()
        cases.append((label, ell(A), ell(B),
                      pattern_spgemm(A, B, device="cuda")))
    return hold_spgemm(torch, cases + products)


def hold_spgemm(torch, cases, bitwise=False):
    """Both SpGEMM kernels' bodies against the plain twin on every ``(label,
    A, B, pattern)`` of ``cases``, in float32 and float64; returns the
    largest absolute difference per kernel and body.  ``bitwise``: the
    tiled bodies must give the twin's values bit for bit.  The launches
    made here are taken off the kernels' counts."""
    from pyamg_tpu_torch.sparse import spgemm_kernel

    before = dict(spgemm_kernel.launches)
    worst = {}
    for dtype in (torch.float32, torch.float64):
        name_dt = str(dtype).split(".")[-1]
        for label, A, B, pattern in cases:
            A, B = A.astype(dtype), B.astype(dtype)
            slabs, bodies = spgemm_bodies(A, B, pattern)
            ref = spgemm_kernel.masked_matmul_vals_plain(*slabs)
            outs = {}
            for name, (tiled, slotwise, _) in bodies.items():
                outs[name] = tiled()
                outs[name + "_slotwise"] = slotwise()
            torch.cuda.synchronize()
            scale = max(float(ref.abs().max()), 1e-300)
            errs = {}
            for name, out in outs.items():
                err = errs[name] = float((out - ref).abs().max())
                if not (bool(torch.isfinite(out).all())
                        and err <= REL_TOL[name_dt] * scale):
                    raise AssertionError(f"{name} {name_dt} {label}: max rel "
                                         f"error {err / scale:.3e}")
                if (bitwise and not name.endswith("_slotwise")
                        and not torch.equal(out, ref)):
                    raise AssertionError(f"{name} {name_dt} {label}: not "
                                         f"bitwise equal to the twin (max "
                                         f"abs {err:.1e})")
                worst[name] = max(worst.get(name, 0.0), err)
            print(f"{name_dt:8s} {label:16s} {tuple(slabs[0].shape)}x"
                  f"{tuple(slabs[2].shape)}->{tuple(slabs[4].shape)}  max abs "
                  + "  ".join(f"{name.removeprefix('masked_spgemm_')} "
                              f"{err:.1e}" for name, err in errs.items()))
    print(f"largest absolute difference from the twin: {worst}")
    spgemm_kernel.launches.update(before)
    return worst


def hpcg27_phase(torch):
    """HPCG's 27-point operator on HPCG_GRID^3 through the general device
    setup, as the benchmark's hpcg27_104 configuration calls it: every
    masked product recorded and held against the twin (the tiled bodies
    bit for bit), level-0 A*P (banded) and R*(A*P) (gather, R 125 wide)
    timed against their bounds beside the setup's own ``spgemm`` spans;
    returns the SpGEMM kernels' launch counts over the setup and the
    largest absolute differences from the twin."""
    phase(f"39. HPCG's 27-point operator at {HPCG_GRID}^3: the general "
          f"setup's wide products")
    from pyamg_tpu_torch.gallery import stencil_grid
    from pyamg_tpu_torch.parallel import general_sa_setup_sharded
    from pyamg_tpu_torch.sparse import spgemm_kernel
    from pyamg_tpu_torch.sparse.spgemm_device import WIDE
    from pyamg_tpu_torch.util import profiling

    S = -np.ones((3, 3, 3))
    S[1, 1, 1] = 26.0
    A = stencil_grid(S, (HPCG_GRID,) * 3, format="csr")
    before = dict(spgemm_kernel.launches)
    plain_before = spgemm_kernel.plain_cuda_calls
    wide_before = profiling.counters.get("spgemm_wide", 0)
    products = []
    t0 = time.perf_counter()
    with recording_products(products, 3 * len(HPCG_LEVELS)):
        sol = general_sa_setup_sharded(A, dtype=np.float32, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    launches = {name: count - before[name]
                for name, count in spgemm_kernel.launches.items()}
    plain_calls = spgemm_kernel.plain_cuda_calls - plain_before
    wide = profiling.counters.get("spgemm_wide", 0) - wide_before
    spans = [r[5] for r in sol.inner.span_log.setup if r[2] == "spgemm"]
    rows = [lvl.A_csr.shape[0] for lvl in sol.levels]
    print(f"setup_s {setup_s:.3f}  levels {rows}  launches {launches}  "
          f"spgemm_wide {wide}  plain twin calls on CUDA {plain_calls}")
    for (label, *_), a in zip(products, spans):
        print(f"product {label:13s} {a['route']:6s} A ({a['n']}, "
              f"{a['w_a']}) B ({a['nb']}, {a['w_b']}) out ({a['n']}, "
              f"{a['w_out']})  in the setup's span "
              f"{a.get('device_us', float('nan')):.1f} us device")
    n_wide = sum(max(A_.width, B_.width, pat.width) > WIDE
                 for _, A_, B_, pat in products)
    if rows != HPCG_LEVELS:
        raise AssertionError(f"levels {rows}, expected {HPCG_LEVELS}")
    if plain_calls:
        raise AssertionError(f"the setup ran the plain twin on CUDA "
                             f"{plain_calls} times")
    if not (len(products) == len(spans) == sum(launches.values())
            == 3 * (len(rows) - 1)):
        raise AssertionError(f"recorded {len(products)} masked products "
                             f"and {len(spans)} spans, the kernels "
                             f"launched {launches}")
    if not all(a.get("device_us", 0) > 0 for a in spans):
        raise AssertionError("a product's span carries no device time")
    if wide != n_wide or products[2][1].width < 125:
        raise AssertionError(f"spgemm_wide {wide}, {n_wide} products past "
                             f"{WIDE} slots; level-0 R {products[2][1].width}"
                             f" wide")
    worst = hold_spgemm(torch, products, bitwise=True)

    by_label = {label: (i, A_, B_, pat)
                for i, (label, A_, B_, pat) in enumerate(products)}
    for name, label in (("masked_spgemm_banded", "level 0 A*P"),
                        ("masked_spgemm_gather", "level 0 R*AP")):
        i, A_, B_, pattern = by_label[label]
        slabs, bodies = spgemm_bodies(A_, B_, pattern)
        if routed(bodies) != name:
            raise AssertionError(f"{label} routed to {routed(bodies)}")
        kernel, slotwise, geom = bodies[name]
        plain = functools.partial(spgemm_kernel.masked_matmul_vals_plain,
                                  *slabs)
        library, same, rel = spgemm_library(torch, A_, B_, pattern, kernel())
        k_ms, s_ms, p_ms, lib_ms = _medians(torch, kernel, slotwise, plain,
                                            library, samples=10)
        b_ms, b_by, nbytes, needed = spgemm_bound(A_, B_, slabs)
        print(f"{name} float32: {label} A {tuple(slabs[0].shape)} B "
              f"{tuple(slabs[2].shape)} out {tuple(slabs[4].shape)} (tile "
              f"{geom.rows} rows x {geom.lanes} lanes, {geom.threads} "
              f"threads, {geom.blocks} blocks, {geom.shared_bytes} B shared)"
              f"  kernel {k_ms * 1e3:.1f} us device (in the setup's span "
              f"{spans[i]['device_us']:.1f} us);  slotwise body "
              f"{s_ms * 1e3:.1f} us;  plain {p_ms * 1e3:.1f} us, "
              f"plain/kernel {p_ms / k_ms:.2f}")
        print(f"{name} float32: {label} bound {b_ms * 1e3:.1f} us by "
              f"{b_by} ({nbytes / 1e6:.1f} MB, {needed} products), "
              f"kernel/bound {k_ms / b_ms:.2f};  cuSPARSE SpGEMM "
              f"(torch.sparse.mm, int32 CSR) {lib_ms * 1e3:.1f} us device, "
              f"library/kernel {lib_ms / k_ms:.2f}; library pattern equals "
              f"the mask: {same}; max rel difference from the kernel "
              f"{rel:.2e}")
    del sol, products, by_label
    return launches, worst


def _sample(torch, fn, inner=10):
    """Device ms per call of ``fn``: CUDA events around ``inner`` calls
    queued behind a ~10 ms sleep kernel, so that the host has queued every
    launch before the first one starts and the events bracket device time
    alone, not the host's launch pace."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(inner):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / inner


def _host_us(torch, fn, calls=200):
    """Host microseconds per call of ``fn``, synchronized at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def _medians(torch, *fns, samples=20):
    """Median device ms per call of each of ``fns``, sampled in turn
    (forward, then backward, alternately) after a warm-up."""
    for _ in range(3):
        for fn in fns:
            fn()
    times = [[] for _ in fns]
    for i in range(samples):
        order = range(len(fns)) if i % 2 else range(len(fns) - 1, -1, -1)
        for j in order:
            times[j].append(_sample(torch, fns[j]))
    return [statistics.median(t) for t in times]


def bound(nbytes, flops, flop_per_s=F32_FLOP_PER_S):
    """``(ms, "bytes" or "operations")``: the least time the card could
    take to move ``nbytes`` (each input read once, each output written
    once) and do ``flops`` operations at ``flop_per_s`` (float32 by
    default), and which of the two sets it."""
    from pyamg_tpu_torch.benchmarks.dia_spmv_bench import HBM_BYTES_PER_S

    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def dia_work(op, x):
    """Bytes and flops of one DIA matvec of ``op`` with ``x``: the
    diagonals, offsets and x read once, y written once; a multiply and an
    add per in-range entry (four multiplies and four adds when complex)."""
    n, m = op.shape
    entries = sum(max(0, min(n, m - o) - max(0, -o)) for o in op.offsets)
    nbytes = (op.diags.numel() * op.diags.element_size()
              + op.offsets_dev.numel() * 4
              + x.numel() * x.element_size() + n * x.element_size())
    return nbytes, (8 if x.dtype.is_complex else 2) * entries


def spgemm_library(torch, A, B, pattern, out):
    """cuSPARSE SpGEMM (``torch.sparse.mm`` of two CSR tensors) on the
    masked product's operands: the call, whether its pattern equals the
    mask (only then does it compute the masked product's values) and its
    largest difference from the kernel's output ``out``, relative to the
    largest |value|."""
    import scipy.sparse as sp
    from pyamg_tpu_torch.benchmarks.dia_spmv_bench import csr_tensor

    As, Bs = (csr_tensor(M.to_scipy(), "cuda", torch.float32) for M in (A, B))
    C = torch.sparse.mm(As, Bs)
    Cs = sp.csr_matrix((C.values().cpu().numpy(),
                        C.col_indices().cpu().numpy().astype(np.int64),
                        C.crow_indices().cpu().numpy().astype(np.int64)),
                       shape=tuple(C.shape))
    Cs.sort_indices()
    mask = pattern.to_scipy()
    mask.sort_indices()
    same = (Cs.shape == mask.shape
            and np.array_equal(Cs.indptr, mask.indptr)
            and np.array_equal(Cs.indices, mask.indices))
    ours = masked_values(out, pattern).tocsr()
    diff = abs(Cs - ours)
    scale = max(abs(ours).max(), 1e-300)
    rel = (diff.max() if diff.nnz else 0.0) / scale
    return functools.partial(torch.sparse.mm, As, Bs), same, rel


def masked_values(out, pattern):
    """The masked product's output slab on its pattern, as scipy COO."""
    import scipy.sparse as sp

    valid = pattern.valid_mask().cpu().numpy()
    n, w = valid.shape
    rows = np.broadcast_to(np.arange(n)[:, None], (n, w))
    return sp.coo_matrix((out.cpu().numpy()[valid],
                          (rows[valid], pattern.cols.cpu().numpy()[valid])),
                         shape=pattern.shape)


def time_kernels(torch, ml, products):
    """The DIA kernel at the structured level-0 shape (float32 and
    float64), and the SpGEMM kernels at the general path's level-0 A*P
    (banded) and R*AP (gather) shapes (float32), each beside its plain
    version; device time from :func:`_medians`, the host's own cost per
    call beside it.  The DIA kernel's level-0 set fits the card's L2, so it
    is timed both warm (back to back on one operand) and cold (cycling
    through copies that overflow L2).  The SpGEMM kernels also beside their
    slotwise bodies, bound and library call; their record for the kernels
    line.  Then every product of the setup on the kernel the router chose,
    tiled and slotwise bodies beside the bound (the banded kernel's
    products also on the gather kernel), and their sums over the setup."""
    phase("7. kernel time")
    from pyamg_tpu_torch.benchmarks.dia_spmv_bench import L2_BYTES, csr_tensor
    from pyamg_tpu_torch.sparse import SparseDIA, spgemm_kernel

    A0 = ml.levels[0].A
    out = {}
    for dtype in (torch.float32, torch.float64):
        op = SparseDIA(A0.diags.to(dtype), A0.offsets, A0.shape)
        x = torch.rand(op.shape[1], device="cuda", dtype=dtype)
        kernel, plain = (lambda: op.matvec(x)), (lambda: op.matvec_plain(x))
        name = str(dtype).split(".")[-1]
        nbytes, flops = dia_work(op, x)
        if dtype == torch.float32:
            csr = csr_tensor(op.to_scipy(), "cuda", dtype)
            k_ms, p_ms, lib_ms = _medians(torch, kernel, plain,
                                          lambda: torch.mv(csr, x))
        else:
            k_ms, p_ms = _medians(torch, kernel, plain)
        print(f"dia_matvec {name}: level-0 {op.shape} {op.n_offsets} offsets"
              f" ({nbytes / 1e6:.1f} MB; the card's L2 holds "
              f"{L2_BYTES / 2**20:.0f} MiB), warm (L2-resident): kernel "
              f"{k_ms * 1e3:.1f} us device, {_host_us(torch, kernel):.1f} us "
              f"per call on the host clock;  plain {p_ms * 1e3:.1f} us "
              f"device, {_host_us(torch, plain):.1f} us per call;  "
              f"plain/kernel {p_ms / k_ms:.2f}")
        if dtype == torch.float32:
            copies = int(2 * L2_BYTES // nbytes) + 2
            ops = [(SparseDIA(op.diags.clone(), op.offsets, op.shape),
                    x.clone()) for _ in range(copies)]

            def cold():
                for o, xo in ops:
                    o.matvec(xo)

            csrs = [(csr_tensor(op.to_scipy(), "cuda", dtype), xo)
                    for _, xo in ops]

            def cold_library():
                for c, xo in csrs:
                    torch.mv(c, xo)

            cold_ms, cold_lib_ms = (t / copies for t in _medians(
                torch, cold, cold_library))
            b_ms, _ = bound(nbytes, flops)
            print(f"dia_matvec float32: level-0 cold (L2 flushed: {copies} "
                  f"copies in turn) {cold_ms * 1e3:.2f} us device against "
                  f"its bound of {b_ms * 1e3:.2f} us (bytes over the HBM "
                  f"rate), kernel/bound {cold_ms / b_ms:.2f};  cold cuSPARSE "
                  f"CSR SpMV (the same copies in turn) "
                  f"{cold_lib_ms * 1e3:.2f} us;  warm cuSPARSE "
                  f"CSR SpMV (torch.mv, int32 indices) {lib_ms * 1e3:.1f} us "
                  f"device, library/kernel {lib_ms / k_ms:.2f} (both "
                  f"L2-resident)")

    by_label = {label: (A, B, pat) for label, A, B, pat in products}
    for name, label in (("masked_spgemm_banded", "level 0 A*P"),
                        ("masked_spgemm_gather", "level 0 R*AP")):
        A, B, pattern = by_label[label]
        slabs, bodies = spgemm_bodies(A, B, pattern)
        kernel, slotwise, _ = bodies[name]
        plain = functools.partial(spgemm_kernel.masked_matmul_vals_plain,
                                  *slabs)
        res = kernel()
        library, same, rel = spgemm_library(torch, A, B, pattern, res)
        k_ms, s_ms, p_ms, lib_ms = _medians(torch, kernel, slotwise, plain,
                                            library)
        print(f"{name} float32: {label} A {tuple(slabs[0].shape)} B "
              f"{tuple(slabs[2].shape)} out {tuple(slabs[4].shape)}  kernel "
              f"{k_ms * 1e3:.1f} us device, {_host_us(torch, kernel):.1f} us "
              f"per call on the host clock;  slotwise body {s_ms * 1e3:.1f} "
              f"us, slotwise/kernel {s_ms / k_ms:.2f};  plain "
              f"{p_ms * 1e3:.1f} us device, {_host_us(torch, plain, 20):.1f}"
              f" us per call;  plain/kernel {p_ms / k_ms:.2f}")
        b_ms, b_by, nbytes, needed = spgemm_bound(A, B, slabs)
        print(f"{name} float32: {label} bound {b_ms * 1e3:.1f} us "
              f"({nbytes / 1e6:.1f} MB, {needed} products), "
              f"kernel/bound {k_ms / b_ms:.2f};  cuSPARSE SpGEMM "
              f"(torch.sparse.mm, int32 CSR) {lib_ms * 1e3:.1f} us device, "
              f"library/kernel {lib_ms / k_ms:.2f}; library pattern equals "
              f"the mask: {same}; max rel difference from the kernel "
              f"{rel:.2e}")
        out[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms, slotwise_ms=s_ms,
                         setup_ms=0.0, setup_slotwise_ms=0.0)

    # every product of the setup on the kernel the router chose, both
    # bodies; the banded kernel's products also on the gather kernel
    total = dict.fromkeys(("tiled", "slotwise", "bound"), 0.0)
    for label, A, B, pattern in products:
        slabs, bodies = spgemm_bodies(A, B, pattern)
        name = routed(bodies)
        fns = [*bodies[name][:2]]
        if name == "masked_spgemm_banded":
            fns += bodies["masked_spgemm_gather"][:2]
        times = _medians(torch, *fns)
        geom = bodies[name][2]
        b_ms, _, _, _ = spgemm_bound(A, B, slabs)
        out[name]["setup_ms"] += times[0]
        out[name]["setup_slotwise_ms"] += times[1]
        for key, ms in zip(total, (times[0], times[1], b_ms)):
            total[key] += ms
        print(f"product {label:13s} {name.removeprefix('masked_spgemm_'):6s}"
              f" A {tuple(slabs[0].shape)} B {tuple(slabs[2].shape)} out "
              f"{tuple(slabs[4].shape)}  (tile {geom.rows} rows x "
              f"{geom.lanes} lanes, {geom.blocks} blocks)  tiled "
              f"{times[0] * 1e3:.1f} us, "
              f"slotwise {times[1] * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us;"
              f"  slotwise/tiled {times[1] / times[0]:.2f}, tiled/bound "
              f"{times[0] / b_ms:.2f}"
              + (f";  gather tiled {times[2] * 1e3:.1f} us, slotwise "
                 f"{times[3] * 1e3:.1f} us, banded/gather tiled "
                 f"{times[0] / times[2]:.2f}, slotwise "
                 f"{times[1] / times[3]:.2f}" if len(times) == 4 else ""))
    print(f"setup's {len(products)} masked products, float32: tiled "
          f"{total['tiled'] * 1e3:.1f} us, slotwise "
          f"{total['slotwise'] * 1e3:.1f} us, bound {total['bound'] * 1e3:.1f}"
          f" us;  slotwise/tiled {total['slotwise'] / total['tiled']:.2f}, "
          f"tiled/bound {total['tiled'] / total['bound']:.2f};  per kernel "
          + ", ".join(f"{name}: tiled {rec['setup_ms'] * 1e3:.1f} us, "
                      f"slotwise {rec['setup_slotwise_ms'] * 1e3:.1f} us"
                      for name, rec in out.items()
                      if name.startswith("masked")))
    for name in ("masked_spgemm_banded", "masked_spgemm_gather"):
        rec = out[name]
        if not (rec["ms"] < rec["slotwise_ms"]
                and rec["setup_ms"] < rec["setup_slotwise_ms"]):
            raise AssertionError(f"{name}: the tiled body is not faster than "
                                 f"the slotwise one: {rec}")
    return out


def spgemm_bound(A, B, slabs):
    """``(ms, bound_by, bytes, products)`` of one masked product: every
    slab read once and the output written once, and a multiply and an add
    for each product of A's stored entries with B's."""
    n, w_out = slabs[4].shape
    nbytes = (sum(t.numel() * t.element_size() for t in slabs)
              + n * w_out * slabs[0].element_size())
    As, Bs = A.to_scipy(), B.to_scipy()
    needed = int(np.diff(Bs.indptr)[As.indices].sum())
    return (*bound(nbytes, 2 * needed), nbytes, needed)


def _dia_variants(torch, D):
    """``{name: (launch, plain)}`` of the DIA kernels the benchmark adds,
    on the float32 operator ``D`` (on the card): the two variants, and
    dia_matvec on bfloat16 diagonals."""
    from pyamg_tpu_torch.sparse import SparseDIA, dia_variants

    d, offs = D.diags, D.offsets
    Db = SparseDIA(d.to(torch.bfloat16), offs, D.shape)
    return {
        "dia_matvec_v2": (lambda x: dia_variants.dia_matvec_v2(d, offs, x),
                          lambda x: dia_variants.dia_matvec_v2_plain(
                              d, offs, x)),
        "dia_matvec_v1": (lambda x: dia_variants.dia_matvec_v1(d, offs, x),
                          lambda x: dia_variants.dia_matvec_v1_plain(
                              d, offs, x)),
        "dia_matvec bf16 diags": (Db.matvec, Db.matvec_plain),
    }


def check_dia_variants(torch, rng, bench):
    """dia_matvec_v2, dia_matvec_v1 and dia_matvec on bfloat16 diagonals
    vs their plain twins on the card, on the CPU tests' operators and on
    the benchmark's problem ``bench`` (2048^2); returns the largest
    absolute difference per kernel."""
    phase("8. DIA variants vs plain")
    from pyamg_tpu_torch.sparse import SparseDIA

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "tests"))
    import dia_cases

    cases = [(label, SparseDIA.from_scipy(case(), dtype=np.float32,
                                          device="cuda"))
             for label, case in dia_cases.ALL.items()]
    cases.append((f"bench {bench.G}^2 (Poisson / 8)", bench.D))
    worst = {}
    for label, D in cases:
        x = torch.as_tensor(rng.random(D.shape[0], dtype=np.float32),
                            device="cuda")
        for name, (launch, plain) in _dia_variants(torch, D).items():
            y, y_ref = launch(x), plain(x)
            torch.cuda.synchronize()
            err = float((y - y_ref).abs().max())
            rel = err / max(float(y_ref.abs().max()), 1e-300)
            tol = REL_TOL["bfloat16" if "bf16" in name else "float32"]
            if not (y.dtype == torch.float32 and bool(torch.isfinite(y).all())
                    and rel <= tol):
                raise AssertionError(f"{name} {label}: max rel error "
                                     f"{rel:.3e} > {tol}")
            key = "dia_matvec" if "bf16" in name else name
            worst[key] = max(worst.get(key, 0.0), err)
            print(f"{name:22s} {label:28s} n={D.shape[0]:8d} offsets "
                  f"{len(D.offsets)}  max abs {err:.3e} rel {rel:.3e}")
    return worst


def dia_bench(torch, bench):
    """The DIA SpMV benchmark through its entry point at 2048^2 (on the
    problem ``bench``) and 1024^2; returns the variant kernels' launch
    counts over the 2048^2 run, and the float32 DIA kernels' records for
    the kernels line from that run's rows: the kernel's time, its twin's,
    cuSPARSE's SpMV and the bound of the 2048^2 operator, which streams
    from HBM."""
    phase("9. DIA SpMV benchmark")
    from pyamg_tpu_torch.benchmarks import dia_spmv_bench
    from pyamg_tpu_torch.sparse import dia_kernel, dia_variants

    print(dia_spmv_bench.card())
    for G in BENCH_GRIDS:
        for name in dia_variants.launches:
            dia_variants.launches[name] = 0
        dia_kernel.launches = 0
        records = dia_spmv_bench.run(G, p=bench if G == bench.G else None)
        if G == bench.G:
            launches = dict(dia_variants.launches)
            dia_launches = dia_kernel.launches
            timed = records
        print(dia_spmv_bench.report(records))
        print(json.dumps({"dia_spmv_bench": records}))
        for r in records:
            tol = REL_TOL["bfloat16" if "bf16" in r["row"] else "float32"]
            if not (r["finite"] and r["max_rel_err"] <= tol):
                raise AssertionError(f"dia_spmv_bench {G}: {r['row']} max rel "
                                     f"error {r['max_rel_err']:.3e}")
    print(f"launches over the {bench.G}^2 benchmark run: {launches},"
          f" dia_matvec (float32 and bfloat16 rows) {dia_launches}")
    if min(launches.values()) <= 0 or dia_launches <= 0:
        raise AssertionError(f"a DIA kernel never launched: {launches}, "
                             f"dia_matvec {dia_launches}")

    b_ms, b_by = bound(*dia_work(bench.D, bench.x))
    lib_us = next(r["us"] for r in timed if r["row"].startswith("cuSPARSE"))
    out = {}
    for r in timed:
        if r["kernel"] in KERNELS and "bf16" not in r["row"]:
            out[r["kernel"]] = dict(ms=r["us"] / 1e3,
                                    plain_ms=r["plain_us"] / 1e3,
                                    bound_ms=b_ms, bound_by=b_by,
                                    library_ms=lib_us / 1e3)
            print(f"{r['kernel']} float32 {bench.G}^2: kernel/bound "
                  f"{r['us'] / 1e3 / b_ms:.2f} (bound {b_ms * 1e3:.2f} us), "
                  f"library/kernel {lib_us / r['us']:.2f}")
    return launches, out


@contextlib.contextmanager
def counting_twin_calls(torch, count):
    """Count in ``count[0]`` the calls of the DIA kernel's plain twin on a
    CUDA tensor (the path must make none), and in ``SHAPE_LAUNCHES`` the
    kernel's launches by shape (rows, cols, offsets, dtype)."""
    from pyamg_tpu_torch.sparse import dia_kernel

    real, real_kernel = dia_kernel.dia_matvec_plain, dia_kernel.dia_matvec

    def counted(diags, offsets, x, m):
        count[0] += x.is_cuda
        return real(diags, offsets, x, m)

    def counted_kernel(diags, offsets, x, m):
        if diags.shape[1]:
            key = (diags.shape[1], m, diags.shape[0],
                   str(diags.dtype if diags.dtype == torch.bfloat16
                       else x.dtype).split(".")[-1])
            SHAPE_LAUNCHES[key] = SHAPE_LAUNCHES.get(key, 0) + 1
            SHAPE_OFFSETS.setdefault(key, offsets)
        return real_kernel(diags, offsets, x, m)

    dia_kernel.dia_matvec_plain = counted
    dia_kernel.dia_matvec = counted_kernel
    try:
        yield
    finally:
        dia_kernel.dia_matvec_plain = real
        dia_kernel.dia_matvec = real_kernel


def _launches_of(fn):
    """dia_matvec launches that one call of ``fn`` makes."""
    from pyamg_tpu_torch.sparse import dia_kernel

    before = dia_kernel.launches
    fn()
    return dia_kernel.launches - before


def describe_levels(torch, ml):
    """One line per level of a default-call hierarchy: rows, nnz, the
    operator classes of A, P and R, the Gauss-Seidel form, its colors and
    (gather form) its ``(C, R, W)`` arrays' bytes, and the dia_matvec
    launches that one V-cycle makes on that level.  Returns the launches of
    a whole V-cycle, summed over the levels."""
    from pyamg_tpu_torch.relaxation.device import apply_smoother

    def name(op):
        kind = type(op).__name__
        if kind == "ComposedOp":
            return "Composed(" + "+".join(
                type(o).__name__.replace("Sparse", "") for o in op.ops) + ")"
        return kind.replace("Sparse", "").replace("ProlongOp", "-DIA(P)") \
            .replace("RestrictOp", "-DIA(R)").replace("Op", "")

    total = 0
    for i, lvl in enumerate(ml.levels):
        A = lvl.A
        line = (f"level {i}: rows {A.shape[0]:8d} nnz {lvl.nnz:9d}  A "
                f"{name(A)}" + (f"({A.n_offsets})" if hasattr(A, "n_offsets")
                                else ""))
        if getattr(lvl, "P", None) is None:
            print(line + "  (coarse solve)")
            continue
        sm = lvl.presmoother
        x = torch.zeros(A.shape[1], device="cuda", dtype=A.dtype)
        xc = torch.zeros(lvl.P.shape[1], device="cuda", dtype=A.dtype)
        per = dict(
            pre=_launches_of(lambda: apply_smoother(sm, A, x, x)),
            residual=_launches_of(lambda: A.matvec(x)),
            R=_launches_of(lambda: lvl.R.matvec(x)),
            P=_launches_of(lambda: lvl.P.matvec(xc)),
            post=_launches_of(
                lambda: apply_smoother(lvl.postsmoother, A, x, x)))
        total += sum(per.values())
        if sm.color_rows is not None:
            C, R, W = sm.color_data.shape
            nbytes = sum(t.numel() * t.element_size() for t in
                         (sm.color_rows, sm.color_cols, sm.color_data))
            form = (f"gather form, {C} colors, (C, R, W) = ({C}, {R}, {W}) "
                    f"{nbytes / 1e6:.1f} MB")
        else:
            form = f"mask form, {sm.color_masks.shape[0]} colors"
        print(f"{line}  P {name(lvl.P)}  R {name(lvl.R)}  {sm.kind} "
              f"{sm.sweep}, {form};  dia_matvec launches a V-cycle: {per}")
    return total


def default_sa(torch, which):
    """``smoothed_aggregation_solver(A, device="cuda")`` with every other
    argument but ``op_dtype`` at its default, on the 1024^2 problem:
    ``which`` is "structured" (the gallery matrix, which carries its grid)
    or "unstructured" (the same matrix as plain CSR without it).  CG to
    1e-8, stand-alone V-cycles to 1e-8, and ``aspreconditioner`` applied
    once; then every DIA operator of the hierarchy (A, and the DIA parts of
    P and R, at the shapes and offset counts this path gives the kernel) is
    held against the plain twin.  Returns the hierarchy, the path's
    dia_matvec launches and the largest kernel-vs-plain difference."""
    phase({"structured": "10. default SA, structured (A.grid)",
           "unstructured": "11. default SA, unstructured (plain CSR)"}[which])
    import scipy.sparse as sp
    import pyamg_tpu_torch
    import pyamg_tpu_torch.relaxation.relaxation as rel
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.sparse import dia_kernel, spgemm_kernel
    from profile_general import stage_timer

    A = poisson(GRID, format="csr")
    if which == "unstructured":
        A = sp.csr_matrix(A.tocoo())      # a fresh matrix: no grid metadata
        if hasattr(A, "grid"):
            raise AssertionError("the plain CSR copy kept its grid")
    n = A.shape[0]
    b = A @ np.random.default_rng(0).random(n)
    normb = np.linalg.norm(b)

    dia_kernel.launches = 0
    spgemm_kernel.plain_cuda_calls = 0
    twin, relax_s, relax_calls = [0], {"relax": 0.0}, {"relax": 0}
    with counting_twin_calls(torch, twin):
        t0 = time.perf_counter()
        with stage_timer(torch.device("cuda"), relax_s, relax_calls,
                         [("relax", rel, "gauss_seidel")]):
            ml = pyamg_tpu_torch.smoothed_aggregation_solver(
                A, op_dtype=torch.float32, device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        launches_setup = dia_kernel.launches

        def timed_solve(**kw):
            runs = []
            for _ in range(3):
                res = []
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                x = ml.solve(b, tol=1e-8, residuals=res, **kw)
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t0)
            return x, res, runs

        x_cg, res_cg, runs_cg = timed_solve(accel="cg")
        launches_cg = dia_kernel.launches - launches_setup
        x_sa, res_sa, runs_sa = timed_solve()
        z = ml.aspreconditioner().matvec(torch.as_tensor(
            b, device="cuda", dtype=torch.float32))
        torch.cuda.synchronize()
        launches = dia_kernel.launches
    opc = ml.operator_complexity()
    rows = [lvl.A.shape[0] for lvl in ml.levels]
    print(ml)
    print(f"setup_s {setup_s:.3f} of which improve_candidates (4 symmetric "
          f"host Gauss-Seidel sweeps, compiled) "
          f"{relax_s['relax']:.3f} = "
          f"{100 * relax_s['relax'] / setup_s:.1f}%  levels "
          f"{len(ml.levels)}  rows {rows}  operator_complexity {opc:.6f}  "
          f"cycle_complexity V {ml.cycle_complexity('V'):.4f}")
    per_cycle = describe_levels(torch, ml)
    dia_kernel.launches = launches          # the description is no path
    print("dia_matvec vs plain on this hierarchy's own DIA operators:")
    worst = hold_dia_cases(torch, np.random.default_rng(4), record_hierarchy(
        {"structured": "default call, A.grid",
         "unstructured": "default call, plain CSR"}[which], ml))
    relres = {}
    for name, x in (("cg", x_cg), ("cycles", x_sa)):
        x = x.double().cpu().numpy()
        relres[name] = np.linalg.norm(b - A @ x) / normb
        if not np.isfinite(x).all():
            raise AssertionError(f"{name}: non-finite solution")
    it_cg, it_sa = len(res_cg) - 1, len(res_sa) - 1
    below = np.flatnonzero(np.asarray(res_sa) <= 1e-6 * res_sa[0])
    it_1e6 = int(below[0]) if below.size else -1
    print(f"solve(tol=1e-8, accel='cg') float32: iterations {it_cg}  true "
          f"f64 relres {relres['cg']:.3e}  solve_s best of 3 "
          f"{min(runs_cg):.4f}  runs {[round(r, 4) for r in runs_cg]}")
    print(f"solve(tol=1e-8) stand-alone V-cycles float32: iterations {it_sa} "
          f"(maxiter 100; {it_1e6} to a tracked relres of 1e-6)  last "
          f"tracked relres {res_sa[-1] / res_sa[0]:.3e}  "
          f"true f64 relres {relres['cycles']:.3e}  solve_s best of 3 "
          f"{min(runs_sa):.4f}  runs {[round(r, 4) for r in runs_sa]}")
    print(f"dia_matvec launches: setup {launches_setup}, 3 CG solves "
          f"{launches_cg}, whole path {launches}; one V-cycle {per_cycle}; "
          f"plain twin calls on CUDA {twin[0]} (DIA) "
          f"{spgemm_kernel.plain_cuda_calls} (SpGEMM)")

    want = DEFAULT_SA[which]
    if rows != want["rows"] or round(opc, 3) != want["opc"]:
        raise AssertionError(f"levels {rows} opc {opc}, expected "
                             f"{want['rows']} and {want['opc']}")
    if abs(it_cg - want["cg"]) > 1 or abs(it_1e6 - want["cycles"]) > 1:
        raise AssertionError(
            f"iterations CG {it_cg} cycles to 1e-6 {it_1e6}, expected "
            f"{want['cg']}±1 and {want['cycles']}±1")
    if not relres["cg"] <= 5e-7:
        raise AssertionError(f"CG relres {relres['cg']} > 5e-7")
    if it_1e6 < 0 or not relres["cycles"] <= 5e-6:
        raise AssertionError(f"stand-alone cycling stalled at "
                             f"{relres['cycles']}")
    if not (bool(torch.isfinite(z).all()) and float(z.abs().max()) > 0):
        raise AssertionError("aspreconditioner returned nothing finite")
    if launches_cg <= 0 or launches <= launches_cg:
        raise AssertionError("the default path launched no dia_matvec")
    if twin[0] or spgemm_kernel.plain_cuda_calls:
        raise AssertionError(f"a plain twin ran on CUDA: DIA {twin[0]}, "
                             f"SpGEMM {spgemm_kernel.plain_cuda_calls}")
    return ml, launches, worst


def cycles_and_coarse_solvers(torch, ml):
    """On the default structured hierarchy: one W, F and AMLI cycle (each
    must reduce the residual of a random right-hand side, and more than a
    V-cycle leaves), and the V-cycle with every dense coarse solver (lu,
    cholesky and splu must agree with pinv to 1e-4 relative in float32)."""
    phase("12. W, F, AMLI cycles and dense coarse solvers")
    from pyamg_tpu_torch import MultilevelSolver

    A0 = ml.levels[0].A
    b = torch.as_tensor(np.random.default_rng(2).standard_normal(A0.shape[0]),
                        device="cuda", dtype=A0.dtype)
    zero = torch.zeros_like(b)
    normb = float(b.norm())

    def after(y):
        if not bool(torch.isfinite(y).all()):
            raise AssertionError("a cycle returned a non-finite vector")
        return float((b - A0.matvec(y)).norm()) / normb

    left = {}
    for cycle in ("V", "W", "F", "AMLI"):
        launches = _launches_of(lambda: ml.cycle_fn(cycle)(zero, b))
        left[cycle] = after(ml.cycle_fn(cycle)(zero, b))
        print(f"one {cycle:4s} cycle from 0: residual {left[cycle]:.4e} of "
              f"||b||, {launches} dia_matvec launches, cycle_complexity "
              f"{ml.cycle_complexity(cycle):.4f}")
        if not left[cycle] < 0.5:
            raise AssertionError(f"{cycle} cycle left {left[cycle]} of ||b||")
    for cycle in ("W", "F", "AMLI"):
        if not left[cycle] <= left["V"] * 1.001:
            raise AssertionError(f"{cycle} cycle ({left[cycle]}) left more "
                                 f"than the V-cycle ({left['V']})")

    ys = {}
    for solver in ("pinv", "lu", "cholesky", "splu"):
        other = MultilevelSolver(ml.levels, coarse_solver=solver,
                                 device="cuda")
        other._op_dtype = ml._op_dtype
        ys[solver] = other.cycle_fn("V")(zero, b)
        rel = float((ys[solver] - ys["pinv"]).abs().max()
                    / ys["pinv"].abs().max())
        print(f"V-cycle with coarse_solver={solver!r:10s}: residual "
              f"{after(ys[solver]):.4e} of ||b||, max rel difference from "
              f"pinv {rel:.2e}")
        if not (after(ys[solver]) < 0.5 and rel <= 1e-4):
            raise AssertionError(f"coarse solver {solver}: differs from pinv "
                                 f"by {rel}")


def preconditioner_in_scipy(torch):
    """``ml.aspreconditioner()`` handed to ``scipy.sparse.linalg.cg`` on the
    256^2 problem (every application copies the vector to the card and
    back: an interface check, not a timed path), beside the port's own CG
    on the same float64 hierarchy."""
    phase("13. aspreconditioner in scipy's CG, 256^2")
    import scipy.sparse.linalg as spla
    import pyamg_tpu_torch
    from pyamg_tpu_torch.gallery import poisson

    A = poisson((256, 256), format="csr")
    b = A @ np.random.default_rng(3).random(A.shape[0])
    ml = pyamg_tpu_torch.smoothed_aggregation_solver(A, device="cuda")
    its = []
    key = "rtol" if "rtol" in inspect.signature(spla.cg).parameters else "tol"
    x, info = spla.cg(A, b, M=ml.aspreconditioner(),
                      callback=lambda xk: its.append(1), **{key: 1e-8})
    relres = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
    res = []
    ml.solve(b, tol=1e-8, accel="cg", residuals=res)
    print(f"scipy cg with M = ml.aspreconditioner(): info {info}, "
          f"{len(its)} iterations, relres {relres:.3e};  ml.solve(accel='cg')"
          f": {len(res) - 1} iterations (float64 hierarchy, "
          f"{len(ml.levels)} levels)")
    if info != 0 or not relres <= 1e-7:
        raise AssertionError(f"scipy cg: info {info}, relres {relres}")
    if abs(len(its) - (len(res) - 1)) > 1:
        raise AssertionError(f"scipy cg took {len(its)} iterations, the "
                             f"port's CG {len(res) - 1}")


@contextlib.contextmanager
def python_forms():
    """Run the host stages in their Python forms (the compiled library set
    aside) inside the block."""
    from pyamg_tpu_torch import amg_core

    lib, amg_core._lib = amg_core._lib, False
    try:
        yield
    finally:
        amg_core._lib = lib


def native_library():
    """Each binding of the compiled host library against its Python form
    on the 1024^2 Poisson problem and its strength graph: aggregates,
    colors, S and the DIA arrays exactly, the Gauss-Seidel sweeps and
    classical strength to 1e-12 relative; both times per function."""
    phase("14. native host library vs its Python forms")
    import pyamg_tpu_torch.relaxation.relaxation as rel
    from pyamg_tpu_torch import amg_core, graph, strength
    from pyamg_tpu_torch.aggregation import aggregate, aggregation
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.sparse import SparseDIA

    if not amg_core.have_native():
        raise AssertionError("the host library did not load")
    A = poisson(GRID, format="csr")
    n = A.shape[0]
    C = strength.symmetric_strength_of_connection(A)
    rng = np.random.default_rng(14)
    x0, b = rng.standard_normal(n), rng.standard_normal(n)
    order = rng.permutation(n)[:20000]
    # A caches its spectral radius estimate: take it before S is timed
    aggregation.structured_smoother_S(A, "jacobi", {"omega": 4.0 / 3.0},
                                      "hermitian")

    def same_csr(X, Y):
        return (np.array_equal(X.indptr, Y.indptr)
                and np.array_equal(X.indices, Y.indices)
                and np.array_equal(X.data, Y.data))

    def exact_agg(got, ref):
        return same_csr(got[0], ref[0]) and np.array_equal(got[1], ref[1])

    def close(got, ref):
        return np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()

    def relaxed(fn, **kw):
        x = x0.copy()
        fn(A, x, b, **kw)
        return x

    def close_strength(got, ref):
        return (np.array_equal(got.indptr, ref.indptr)
                and np.array_equal(got.indices, ref.indices)
                and close(got.data, ref.data))

    checks = [
        ("standard_aggregation", lambda: aggregate.standard_aggregation(C),
         exact_agg),
        ("naive_aggregation", lambda: aggregate.naive_aggregation(C),
         exact_agg),
        ("first_fit_coloring", lambda: graph.vertex_coloring(C, "FF"),
         np.array_equal),
        ("identity_minus_rowscaled",
         lambda: aggregation.structured_smoother_S(
             A, "jacobi", {"omega": 4.0 / 3.0}, "hermitian")[0], same_csr),
        ("gauss_seidel_sweeps (4 symmetric)",
         lambda: relaxed(rel.gauss_seidel, iterations=4, sweep="symmetric"),
         close),
        ("gauss_seidel_indexed (20,000 rows)",
         lambda: relaxed(rel.gauss_seidel_indexed, indices=order,
                         sweep="symmetric"), close),
        ("classical_strength (theta 0.25)",
         lambda: strength.classical_strength_of_connection(A, theta=0.25),
         close_strength),
        ("csr_to_dia (float32)",
         lambda: SparseDIA.host_diags(A, dtype=np.float32),
         lambda got, ref: got[1] == ref[1] and np.array_equal(got[0],
                                                              ref[0])),
    ]
    for name, fn, agree in checks:
        t0 = time.perf_counter()
        got = fn()
        native_s = time.perf_counter() - t0
        with python_forms():
            t0 = time.perf_counter()
            ref = fn()
            python_s = time.perf_counter() - t0
        print(f"{name:36s} compiled {native_s:8.4f} s   Python form "
              f"{python_s:8.4f} s   ratio {python_s / native_s:7.1f}")
        if not agree(got, ref):
            raise AssertionError(f"{name}: the compiled route and the Python "
                                 f"form disagree")


def _true_relres(A, b, x):
    x = x.cpu().numpy()
    x = x.astype(np.complex128 if np.iscomplexobj(x) else np.float64)
    return float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))


def krylov_accels(torch, ml):
    """Every ``accel`` of ``solve`` (and a callable) on the default
    structured 1024^2 hierarchy in float32 to 1e-6, and ``solve_mp`` with
    BiCGStab and GMRES to a float64 1e-10."""
    phase("15. every accel of solve on the default hierarchy")
    from pyamg_tpu_torch import krylov
    from pyamg_tpu_torch.gallery import poisson

    A = poisson(GRID, format="csr")
    b = A @ np.random.default_rng(0).random(A.shape[0])

    def my_fgmres(A, b, **kw):
        return krylov.fgmres(A, b, restrt=10, **kw)

    for accel in ACCELS + (my_fgmres,):
        name = accel if isinstance(accel, str) else "callable (fgmres(10))"
        res = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = ml.solve(b, tol=1e-6, accel=accel, residuals=res,
                           return_info=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        relres = _true_relres(A, b, x)
        stalls = accel in ACCELS_STALL
        print(f"accel={name:22s} iterations {len(res) - 1:3d}  info {info:3d}"
              f"  tracked relres {res[-1] / res[0]:.3e}  true f64 relres "
              f"{relres:.3e}  {seconds:.4f} s"
              + ("  (stalls, as predicted: recorded, not held to 5e-6)"
                 if stalls else ""))
        if not np.isfinite(relres):
            raise AssertionError(f"accel={name}: non-finite solution")
        if not stalls and not relres <= 5e-6:
            raise AssertionError(f"accel={name}: relres {relres} > 5e-6")
    for accel in ("bicgstab", "gmres"):
        for method in ("pcg", "defect"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, info = ml.solve_mp(b, tol=TOL, accel=accel, method=method,
                                  return_info=True)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            relres = _true_relres(A, b, x)
            print(f"solve_mp(tol=1e-10, accel={accel!r}, method={method!r}): "
                  f"{info}  true f64 relres {relres:.3e}  {seconds:.4f} s")
            if not relres <= 5 * TOL:
                raise AssertionError(f"solve_mp {accel} {method}: relres "
                                     f"{relres} > {5 * TOL}")


def krylov_standalone(torch):
    """The Krylov functions alone, in float64, without a preconditioner:
    GMRES (no restart) and BiCGStab on the 64^2 Poisson problem to 1e-10
    against the JAX package's recorded counts, and GMRES(30), FGMRES(30)
    and BiCGStab on the generated nonsymmetric ``recirc_flow`` example."""
    phase("16. stand-alone Krylov, float64")
    from pyamg_tpu_torch import krylov
    from pyamg_tpu_torch.gallery import load_example, poisson

    def run(fn, A, b, **kw):
        res = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = fn(A, b, residuals=res, device="cuda", **kw)
        torch.cuda.synchronize()
        if x.device.type != "cuda" or x.dtype != torch.float64:
            raise AssertionError(f"{fn.__name__}: x is {x.dtype} on "
                                 f"{x.device}")
        return (len(res) - 1, info, _true_relres(A, b, x),
                time.perf_counter() - t0)

    A = poisson((64, 64), format="csr")
    b = A @ np.random.default_rng(0).random(A.shape[0])
    for name, kw in (("gmres", dict(restrt=None, maxiter=800)),
                     ("bicgstab", dict(maxiter=20000))):
        its, info, relres, seconds = run(getattr(krylov, name), A, b,
                                         tol=TOL, **kw)
        want, slack = KRYLOV_64[name]
        print(f"poisson 64^2 {name:9s} iterations {its} (recorded {want} "
              f"+-{slack})  info {info}  true relres {relres:.3e}  "
              f"{seconds:.4f} s")
        if info != 0 or not relres <= 2 * TOL or abs(its - want) > slack:
            raise AssertionError(f"{name} on poisson 64^2: {its} iterations, "
                                 f"info {info}, relres {relres}")

    ex = load_example("recirc_flow")
    A = ex["A"].tocsr()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    asym = abs(A - A.T).max() / abs(A).max()
    print(f"recirc_flow (generated): {A.shape[0]} rows, nnz {A.nnz}, "
          f"|A - A^T|/|A| {asym:.2f}")
    out = {}
    for name, kw in (("gmres", dict(restrt=30)), ("fgmres", dict(restrt=30)),
                     ("bicgstab", {})):
        out[name] = run(getattr(krylov, name), A, b, tol=1e-8, maxiter=600,
                        **kw)
        its, info, relres, seconds = out[name]
        print(f"recirc_flow {name:9s} iterations {its}  info {info}  true "
              f"relres {relres:.3e}  {seconds:.4f} s")
    if asym <= 0.01:
        raise AssertionError("recirc_flow came out symmetric")
    if out["bicgstab"][1] != 0 or not out["bicgstab"][2] <= 1e-7:
        raise AssertionError(f"bicgstab on recirc_flow: {out['bicgstab']}")
    # without a preconditioner the two GMRES forms are one method; restarted
    # every 30 they stagnate on this operator: held to a 1e4 reduction
    for name in ("gmres", "fgmres"):
        if not out[name][2] <= 1e-4:
            raise AssertionError(f"{name}(30) on recirc_flow: {out[name]}")
    if out["gmres"][0] != out["fgmres"][0]:
        raise AssertionError("gmres and fgmres differ without a "
                             "preconditioner")


def solver_set(torch, ml_a, ml_b):
    """``MultilevelSolverSet`` of the two default hierarchies of the
    1024^2 problem, additive and multiplicative, CG to 1e-8."""
    phase("17. MultilevelSolverSet of the two default hierarchies")
    from pyamg_tpu_torch import MultilevelSolverSet
    from pyamg_tpu_torch.gallery import poisson

    A = poisson(GRID, format="csr")
    b = A @ np.random.default_rng(0).random(A.shape[0])
    for mode in ("additive", "multiplicative"):
        S = MultilevelSolverSet([ml_a, ml_b], mode=mode)
        res = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = S.solve(b, tol=1e-8, accel="cg", residuals=res)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        relres = _true_relres(A, b, x)
        print(f"{mode:14s} CG iterations {len(res) - 1}  true f64 relres "
              f"{relres:.3e}  {seconds:.4f} s")
        if not (relres <= 5e-7 and len(res) - 1 <= DEFAULT_SA["structured"]
                ["cg"] + 1):
            raise AssertionError(f"solver set {mode}: {len(res) - 1} "
                                 f"iterations, relres {relres}")
        z = S.aspreconditioner().matvec(b.astype(np.float32))
        if not (isinstance(z, np.ndarray) and np.isfinite(z).all()):
            raise AssertionError(f"solver set {mode}: aspreconditioner")


def complex_path(torch):
    """A complex Hermitian operator through the default call: the 1024^2
    gauge Laplacian in complex64, CG to 1e-8 and ``solve_mp`` to a
    complex128 1e-10; then the complex kernel entries against the plain
    twin on every DIA operator of that hierarchy.  Returns the two entries'
    launches over the path and the largest kernel-vs-plain difference of
    each."""
    phase("18. complex Hermitian: gauge_laplacian through the default call")
    import pyamg_tpu_torch
    import pyamg_tpu_torch.relaxation.relaxation as rel
    from pyamg_tpu_torch.gallery import gauge_laplacian
    from pyamg_tpu_torch.sparse import dia_kernel
    from profile_general import stage_timer

    A = gauge_laplacian(**GAUGE)
    n = A.shape[0]
    rng = np.random.default_rng(18)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    herm = abs(A - A.conj().T).max()
    for entry in dia_kernel.entry_launches:
        dia_kernel.entry_launches[entry] = 0
    twin, relax_s, relax_calls = [0], {"relax": 0.0}, {"relax": 0}
    with counting_twin_calls(torch, twin):
        t0 = time.perf_counter()
        with stage_timer(torch.device("cuda"), relax_s, relax_calls,
                         [("relax", rel, "gauss_seidel")]):
            ml = pyamg_tpu_torch.smoothed_aggregation_solver(
                A, op_dtype=torch.complex64, device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        res = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = ml.solve(b, tol=1e-8, accel="cg", residuals=res)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        x64, info = ml.solve_mp(b, tol=TOL, return_info=True)
        torch.cuda.synchronize()
    launches = dict(dia_kernel.entry_launches)
    print(ml)
    print(f"gauge_laplacian({GAUGE}): {n} rows, nnz {A.nnz}, |A - A^H| "
          f"{herm:.1e};  setup_s {setup_s:.3f} of which improve_candidates "
          f"(complex: scipy triangular solves, as in the reference) "
          f"{relax_s['relax']:.3f} = "
          f"{100 * relax_s['relax'] / setup_s:.1f}%  A per level "
          f"{[type(lvl.A).__name__ for lvl in ml.levels]}")
    relres, relres64 = _true_relres(A, b, x), _true_relres(A, b, x64)
    print(f"solve(tol=1e-8, accel='cg') complex64: iterations {len(res) - 1}"
          f"  true complex128 relres {relres:.3e}  {solve_s:.4f} s;  "
          f"solve_mp(tol=1e-10): {info}  relres {relres64:.3e};  launches "
          f"{launches};  plain twin calls on CUDA {twin[0]}")
    if x.dtype != torch.complex64 or x64.dtype != torch.complex128:
        raise AssertionError(f"dtypes {x.dtype}, {x64.dtype}")
    if not (relres <= 5e-7 and relres64 <= 5 * TOL):
        raise AssertionError(f"complex relres {relres}, solve_mp {relres64}")
    if min(launches["dia_matvec_c64"], launches["dia_matvec_c128"]) <= 0:
        raise AssertionError(f"a complex entry never launched: {launches}")
    if twin[0]:
        raise AssertionError(f"the plain twin ran on CUDA {twin[0]} times")
    print("complex dia_matvec vs plain on this hierarchy's DIA operators:")
    cases = dia_operators(ml)
    worst = {f"dia_matvec_c{bits}": hold_dia_cases(
        torch, np.random.default_rng(5), cases, (dtype,))
        for bits, dtype in ((64, torch.complex64), (128, torch.complex128))}
    return launches, worst


def time_complex_kernel(torch):
    """The complex entries at 2048^2 (a gauge Laplacian's five diagonals,
    streaming from HBM) beside the plain twin, the bound and, where the
    library takes complex CSR, cuSPARSE's SpMV; their records for the
    kernels line."""
    from pyamg_tpu_torch.benchmarks.dia_spmv_bench import csr_tensor
    from pyamg_tpu_torch.gallery import gauge_laplacian
    from pyamg_tpu_torch.sparse import SparseDIA

    G = BENCH_GRIDS[0]
    A = gauge_laplacian(G, beta=GAUGE["beta"], seed=GAUGE["seed"])
    out = {}
    for bits, dtype, rate in ((64, torch.complex64, F32_FLOP_PER_S),
                              (128, torch.complex128, F64_FLOP_PER_S)):
        op = SparseDIA.from_scipy(A, dtype=dtype, device="cuda")
        x = torch.randn(op.shape[1], device="cuda", dtype=dtype)
        fns = [lambda: op.matvec(x), lambda: op.matvec_plain(x)]
        try:
            csr = csr_tensor(A, "cuda", dtype)
            y_lib = torch.mv(csr, x)
            torch.cuda.synchronize()
            fns.append(lambda: torch.mv(csr, x))
            lib_err = float((y_lib - op.matvec_plain(x)).abs().max())
        except RuntimeError as e:
            print(f"torch.mv on a complex{bits} CSR tensor: {e}")
            lib_err = None
        times = _medians(torch, *fns)
        b_ms, b_by = bound(*dia_work(op, x), rate)
        rec = dict(ms=times[0], plain_ms=times[1], bound_ms=b_ms,
                   bound_by=b_by,
                   library_ms=times[2] if len(times) == 3 else None)
        out[f"dia_matvec_c{bits}"] = rec
        print(f"dia_matvec complex{bits} {G}^2, {op.n_offsets} offsets "
              f"({dia_work(op, x)[0] / 1e6:.1f} MB): kernel "
              f"{rec['ms'] * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us "
              f"({b_by}), kernel/bound {rec['ms'] / b_ms:.2f};  plain "
              f"{rec['plain_ms'] * 1e3:.2f} us, plain/kernel "
              f"{rec['plain_ms'] / rec['ms']:.2f};  cuSPARSE SpMV "
              + (f"{rec['library_ms'] * 1e3:.2f} us (max abs difference "
                 f"{lib_err:.1e})" if rec["library_ms"] else "not available"))
    return out


def _elasticity_stages():
    """``stage_timer`` stages of a blocked setup: the host stages of the
    level loop, the device arrays and the smoothers."""
    import pyamg_tpu_torch.relaxation.relaxation as rel
    from pyamg_tpu_torch.aggregation import aggregation as agg

    return [("improve_candidates", rel, "gauss_seidel"),
            ("strength", agg, "_strength"),
            ("aggregation", agg, "_aggregate"),
            ("fit_candidates", agg, "fit_candidates"),
            ("P smoothing", agg, "_smooth_P"),
            ("Galerkin RAP (BSR)", agg, "galerkin_product"),
            ("BSR twin", agg, "coarse_bsr_twin"),
            ("device arrays", agg, "_finalize_device_operators"),
            ("smoothers", agg, "change_smoothers")]


def _form(op):
    """Short name of a device operator: its class, its DIA offsets or BDIA
    block diagonals, a composed chain's parts, an embedded transfer's
    DIA."""
    if op is None:
        return "-"
    kind = type(op).__name__.replace("Sparse", "")
    if kind == "ComposedOp":
        return "(" + "+".join(_form(o) for o in op.ops) + ")"
    if hasattr(op, "dia"):
        return f"{kind.removesuffix('Op')}(DIA[{op.dia.n_offsets}])"
    if hasattr(op, "n_offsets"):
        return f"{kind}[{op.n_offsets}]"
    return kind


def blocked_setup(torch, A, **kw):
    """``smoothed_aggregation_solver(A, op_dtype=float32, **kw)`` on the
    card, stage by stage; prints the hierarchy (rows, nnz, blocksize, the
    form of A, P and R, the smoother) and returns ``(ml, setup_s)``."""
    import pyamg_tpu_torch
    from profile_general import stage_timer

    stages = _elasticity_stages()
    secs = {label: 0.0 for label, _, _ in stages}
    calls = {label: 0 for label, _, _ in stages}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with stage_timer(torch.device("cuda"), secs, calls, stages):
        ml = pyamg_tpu_torch.smoothed_aggregation_solver(
            A, op_dtype=torch.float32, device="cuda", **kw)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rest = setup_s - sum(secs.values())
    print(f"setup_s {setup_s:.3f}: " + ", ".join(
        f"{label} {secs[label]:.3f} ({calls[label]})" for label in secs)
        + f", rest (level loop, glue) {rest:.3f}")
    for i, lvl in enumerate(ml.levels):
        sm = lvl.presmoother
        smoother = ("-" if sm is None else
                    f"{sm.kind} bs {sm.blocksize} {sm.sweep}, "
                    f"{sm.color_masks.shape[0]} colors"
                    if sm.color_masks is not None else sm.kind)
        print(f"level {i}: rows {lvl.A.shape[0]:8d} nnz {lvl.nnz:9d} "
              f"blocksize {lvl.blocksize}  A {_form(lvl.A)}  P "
              f"{_form(getattr(lvl, 'P', None))}  R "
              f"{_form(getattr(lvl, 'R', None))}  {smoother}")
    print(f"levels {len(ml.levels)}  operator_complexity "
          f"{ml.operator_complexity():.6f}")
    return ml, setup_s


def elasticity_1m(torch):
    """``benchmarks/suite.py``'s ``elasticity_1m_energy_sa`` through the
    port's entry point: 724^2 Q1 elasticity (1,048,352 dofs, BSR 2x2) with
    its rigid-body modes, ``max_coarse=100``, energy-minimization P with 2
    CG iterations, float32 operators, then ``solve_mp`` to 1e-10 (80 inner
    iterations, 8 rounds) on ``b = rng(0).standard_normal(n)``.  Holds the
    float64 relres, the inner iterations, opc, the kernel against its twin
    on every DIA operator of the hierarchy, and times the kernel at the
    level-0 shape beside its twin and cuSPARSE.  Returns the path's
    dia_matvec launches and the largest kernel-vs-plain difference."""
    phase("19. blocked SA: elasticity_1m_energy_sa, 724^2, 1,048,352 dofs")
    from pyamg_tpu_torch.benchmarks.dia_spmv_bench import csr_tensor
    from pyamg_tpu_torch.gallery import linear_elasticity
    from pyamg_tpu_torch.sparse import SparseDIA, dia_kernel, spgemm_kernel

    want = ELASTICITY_1M
    t0 = time.perf_counter()
    A, B = linear_elasticity(want["grid"])
    n = A.shape[0]
    b = np.random.default_rng(0).standard_normal(n)
    print(f"linear_elasticity({want['grid']}): {n} dofs, BSR "
          f"{A.blocksize}, nnz {A.nnz}, B {B.shape}; built in "
          f"{time.perf_counter() - t0:.3f} s")
    dia_kernel.launches = 0
    spgemm_kernel.plain_cuda_calls = 0
    twin = [0]
    with counting_twin_calls(torch, twin):
        ml, setup_s = blocked_setup(torch, A, B=B, **ELASTICITY_KW)
        launches_setup = dia_kernel.launches
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            x, info = ml.solve_mp(b, tol=TOL, inner_maxiter=80, max_rounds=8,
                                  return_info=True)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t1)
        launches = dia_kernel.launches
    opc = ml.operator_complexity()
    relres = _true_relres(A, b, x)
    per_solve = (launches - launches_setup) // 2
    print(f"solve_mp(tol=1e-10, inner_maxiter=80, max_rounds=8): {info}  "
          f"true f64 relres {relres:.3e}  solve_s {runs[0]:.4f} / "
          f"{runs[1]:.4f}  dia_matvec launches: setup {launches_setup}, "
          f"one solve {per_solve}, path {launches};  plain twin calls on "
          f"CUDA {twin[0]} (DIA) {spgemm_kernel.plain_cuda_calls} (SpGEMM)")

    print("dia_matvec vs plain on this hierarchy's DIA operators:")
    worst = hold_dia_cases(torch, np.random.default_rng(19),
                           record_hierarchy("elasticity_1m_energy_sa", ml))
    # the kernel at the level-0 shape (21 diagonals over 1,048,352 rows,
    # float32: 96.4 MB, beyond the 50 MB L2) beside its twin and cuSPARSE
    A0 = ml.levels[0].A
    if not isinstance(A0, SparseDIA):
        raise AssertionError(f"level 0 is {type(A0).__name__}, not DIA")
    xv = torch.rand(n, device="cuda", dtype=torch.float32)
    As = csr_tensor(ml.levels[0].A_csr, "cuda", torch.float32)
    before = dia_kernel.launches
    k_ms, p_ms, l_ms = _medians(torch, lambda: A0.matvec(xv),
                                lambda: A0.matvec_plain(xv),
                                lambda: torch.mv(As, xv))
    dia_kernel.launches = before
    y0 = A0.matvec(xv)
    lib_err = float((torch.mv(As, xv) - y0).abs().max() / y0.abs().max())
    dia_kernel.launches = before
    nbytes, flops = dia_work(A0, xv)
    b_ms, b_by = bound(nbytes, flops)
    print(f"dia_matvec level 0, {A0.n_offsets} offsets, {nbytes / 1e6:.1f} "
          f"MB: kernel {k_ms * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us "
          f"({b_by}), kernel/bound {k_ms / b_ms:.2f};  plain "
          f"{p_ms * 1e3:.2f} us;  cuSPARSE torch.mv(csr int32) "
          f"{l_ms * 1e3:.2f} us (max rel difference {lib_err:.1e})")
    # level 0's transfers: K = 3 candidates on 2 dofs per node, no root
    # embedding, so P and R are padded ELL (plain torch gathers)
    lvl0 = ml.levels[0]
    xc = torch.rand(lvl0.P.shape[1], device="cuda", dtype=torch.float32)
    pr_ms = _medians(torch, lambda: lvl0.P.matvec(xc),
                     lambda: lvl0.R.matvec(xv))
    print(f"level 0 P {_form(lvl0.P)} {tuple(lvl0.P.shape)} matvec "
          f"{pr_ms[0] * 1e3:.2f} us, R {_form(lvl0.R)} matvec "
          f"{pr_ms[1] * 1e3:.2f} us (one each per V-cycle)")

    if not relres <= 5 * TOL:
        raise AssertionError(f"elasticity relres {relres} > {5 * TOL}")
    if abs(info["inner_iterations"] - want["iters"]) > want["iters_tol"]:
        raise AssertionError(f"inner iterations {info['inner_iterations']}, "
                             f"expected {want['iters']} +- "
                             f"{want['iters_tol']}")
    if not opc <= want["opc_max"]:
        raise AssertionError(f"operator complexity {opc} > "
                             f"{want['opc_max']}")
    if per_solve <= 0:
        raise AssertionError("the elasticity solve launched no dia_matvec")
    if twin[0] or spgemm_kernel.plain_cuda_calls:
        raise AssertionError(f"a plain twin ran on CUDA: DIA {twin[0]}, "
                             f"SpGEMM {spgemm_kernel.plain_cuda_calls}")
    return launches, worst


def elasticity_rbm(torch):
    """The ``elasticity_rbm_sa`` size, 100^2 (20,000 dofs): the energy
    call of the cell, the default call (Jacobi P on the structured
    K-candidate path: ``SparseBDIA`` smoothers inside the transfers) and
    the same matrix as plain CSR with B (the scalar chain, K = 3), each
    with float32 operators, CG to 1e-8 and ``solve_mp`` to 1e-10; one
    ``SparseBDIA`` matvec timed.  Returns the phase's dia_matvec launches
    and the largest kernel-vs-plain difference."""
    phase("20. blocked SA at the elasticity_rbm_sa size, 100^2")
    import scipy.sparse as sp
    from pyamg_tpu_torch.gallery import linear_elasticity
    from pyamg_tpu_torch.sparse import SparseBDIA, dia_kernel, spgemm_kernel

    A, B = linear_elasticity(ELASTICITY_RBM)
    n = A.shape[0]
    b = np.random.default_rng(0).standard_normal(n)
    calls = {"energy": (A, dict(B=B, **ELASTICITY_KW)),
             "default (Jacobi P, structured)": (A, dict(B=B)),
             "CSR with B": (sp.csr_matrix(A.tocoo()), dict(B=B))}
    dia_kernel.launches = 0
    spgemm_kernel.plain_cuda_calls = 0
    twin, worst, bdia = [0], 0.0, None
    for name, (M, kw) in calls.items():
        print(f"-- {name}")
        with counting_twin_calls(torch, twin):
            ml, _ = blocked_setup(torch, M, **kw)
            res = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = ml.solve(b, tol=1e-8, accel="cg", maxiter=100, residuals=res)
            torch.cuda.synchronize()
            cg_s = time.perf_counter() - t0
            x64, info = ml.solve_mp(b, tol=TOL, inner_maxiter=80,
                                    max_rounds=8, return_info=True)
            torch.cuda.synchronize()
        relres, relres64 = _true_relres(A, b, x), _true_relres(A, b, x64)
        print(f"CG to 1e-8 float32: iterations {len(res) - 1}  true f64 "
              f"relres {relres:.3e}  {cg_s:.4f} s;  solve_mp(1e-10): {info}"
              f"  relres {relres64:.3e}")
        if not (relres <= 1e-5 and relres64 <= 5 * TOL
                and len(res) - 1 <= 30):
            raise AssertionError(f"{name}: CG {len(res) - 1} iterations, "
                                 f"relres {relres}, solve_mp {relres64}")
        worst = max(worst, hold_dia_cases(
            torch, np.random.default_rng(20),
            record_hierarchy(f"elasticity 100^2, {name}", ml)))
        for lvl in ml.levels:
            for op in getattr(getattr(lvl, "P", None), "ops", ()):
                if isinstance(op, SparseBDIA) and bdia is None:
                    bdia = op
    if bdia is None:
        raise AssertionError("the default call built no SparseBDIA smoother")
    launches = dia_kernel.launches
    time_bdia(torch, bdia)
    print(f"dia_matvec launches over the three calls: {launches};  plain "
          f"twin calls on CUDA {twin[0]} (DIA) "
          f"{spgemm_kernel.plain_cuda_calls} (SpGEMM)")
    if launches <= 0:
        raise AssertionError("the 100^2 elasticity calls launched no "
                             "dia_matvec")
    if twin[0] or spgemm_kernel.plain_cuda_calls:
        raise AssertionError("a plain twin ran on CUDA")
    return launches, worst


def time_bdia(torch, bdia):
    """Print the device time of one ``SparseBDIA`` matvec (plain torch)
    beside its bound."""
    xv = torch.rand(bdia.shape[1], device="cuda", dtype=bdia.dtype)
    (ms,) = _medians(torch, lambda: bdia.matvec(xv))
    nbytes = (bdia.blocks.numel() * bdia.blocks.element_size()
              + 2 * xv.numel() * xv.element_size())
    b_ms, b_by = bound(nbytes, 2 * bdia.blocks.numel())
    print(f"SparseBDIA matvec (plain torch, shifted batched block "
          f"products) {tuple(bdia.shape)}, {bdia.n_offsets} block "
          f"diagonals: {ms * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us "
          f"({b_by}, {nbytes / 1e6:.2f} MB)")


def _classical_stages():
    """``stage_timer`` stages of ``ruge_stuben_solver``: the host stages of
    the level loop, the device arrays and the smoothers."""
    from pyamg_tpu_torch.classical import classical as rs

    return [("strength", rs, "_strength_matrix"),
            ("splitting", rs, "_splitting"),
            ("interpolation", rs, "direct_interpolation"),
            ("interpolation", rs, "standard_interpolation"),
            ("Galerkin R*A*P", rs, "_galerkin"),
            ("device arrays", rs, "device_operator"),
            ("device arrays", rs, "_device_transfers"),
            ("smoothers", rs, "change_smoothers")]


def classical_setup(torch, A, **kw):
    """``ruge_stuben_solver(A, op_dtype=float32, **kw)`` on the card, stage
    by stage; prints the hierarchy (rows, nnz, the form of A, P and R, the
    smoother) and returns ``(ml, setup_s)``."""
    import pyamg_tpu_torch
    from profile_general import stage_timer

    stages = _classical_stages()
    secs = {label: 0.0 for label, _, _ in stages}
    calls = {label: 0 for label, _, _ in stages}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with stage_timer(torch.device("cuda"), secs, calls, stages):
        ml = pyamg_tpu_torch.ruge_stuben_solver(
            A, op_dtype=torch.float32, device="cuda", **kw)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rest = setup_s - sum(secs.values())
    print(f"setup_s {setup_s:.3f}: " + ", ".join(
        f"{label} {secs[label]:.3f} ({calls[label]})" for label in secs)
        + f", rest (level loop, glue) {rest:.3f}")
    for i, lvl in enumerate(ml.levels):
        sm = lvl.presmoother
        smoother = "-" if sm is None else sm.kind + (
            f" {sm.sweep}, {sm.color_masks.shape[0]} colors"
            if sm.color_masks is not None else
            f" {sm.sweep}, gather form, {sm.color_rows.shape[0]} colors"
            if sm.color_rows is not None else
            f" {sm.sweep}, lines along axis {sm.line_axis}"
            if sm.line_tri is not None else "")
        print(f"level {i}: rows {lvl.A.shape[0]:8d} nnz {lvl.nnz:9d}  A "
              f"{_form(lvl.A)}  P {_form(getattr(lvl, 'P', None))}  R "
              f"{_form(getattr(lvl, 'R', None))}  {smoother}")
    print(f"levels {len(ml.levels)}  operator_complexity "
          f"{ml.operator_complexity():.6f}  grid_complexity "
          f"{ml.grid_complexity():.6f}")
    return ml, setup_s


def classical_solve(torch, ml, A, b, repeats=3, **kw):
    """``solve_mp(b, tol=1e-10, **kw)`` once, then best of ``repeats``,
    and one V-cycle's dia_matvec launches; returns ``(info, relres,
    best_s, per_cycle)``."""
    x, info = ml.solve_mp(b, tol=TOL, return_info=True, **kw)
    torch.cuda.synchronize()
    relres = _true_relres(A, b, x)
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ml.solve_mp(b, tol=TOL, **kw)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    b32 = torch.as_tensor(b, device="cuda", dtype=torch.float32)
    cycle = ml.cycle_fn("V")
    per_cycle = _launches_of(lambda: cycle(torch.zeros_like(b32), b32))
    print(f"solve_mp(tol=1e-10{''.join(f', {k}={v}' for k, v in kw.items())}"
          f"): {info}  true f64 relres {relres:.3e}  solve_s best of "
          f"{repeats} "
          f"{min(runs):.4f}  runs {[round(r, 4) for r in runs]} (after the "
          f"first, which also builds the float64 operator);  dia_matvec "
          f"launches a V-cycle {per_cycle}")
    return info, relres, min(runs), per_cycle


def _fingerprint_mismatches(ml, want):
    """Where a classical hierarchy leaves the reference pyamg's fingerprint
    (levels, rows, nnz, sha256 of the splittings and of A's and P's
    patterns, opc, gc, P's sum); an empty list when it holds."""
    import hashlib

    def sha(*arrays):
        h = hashlib.sha256()
        for a in arrays:
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()

    bad = []
    if len(ml.levels) != len(want["levels"]):
        return [f"{len(ml.levels)} levels, want {len(want['levels'])}"]
    for key, got in (("opc", ml.operator_complexity()),
                     ("gc", ml.grid_complexity())):
        if abs(got - want[key]) >= 2e-6:
            bad.append(f"{key} {got} want {want[key]}")
    for i, (lvl, w) in enumerate(zip(ml.levels, want["levels"])):
        A = lvl.A_csr.tocsr()
        A.sort_indices()
        got = [(A.shape[0], A.nnz), sha(A.indptr.astype(np.int64),
                                        A.indices.astype(np.int64))]
        wanted = [(w["n"], w["nnz"]), w["A_struct_sha"]]
        if i < len(ml.levels) - 1:
            P = lvl.P_csr.tocsr()
            P.sort_indices()
            got += [sha(np.asarray(lvl.splitting, np.int32)), P.nnz,
                    sha(P.indptr.astype(np.int64),
                        P.indices.astype(np.int64))]
            wanted += [w["splitting_sha"], w["P_nnz"], w["P_struct_sha"]]
            if abs(float(P.sum()) - w["P_data_sum"]) > \
                    1e-9 * abs(w["P_data_sum"]):
                bad.append(f"level {i} P sum")
        bad += [f"level {i} field {k}" for k, (g, x) in
                enumerate(zip(got, wanted)) if g != x]
    return bad


def classical_poisson(torch):
    """``benchmarks/suite.py``'s ``classical_poisson_500`` through the
    port's entry point: ``ruge_stuben_solver(A, CF="RS", op_dtype=float32)``
    on the 500^2 Poisson problem, ``solve_mp`` to 1e-10 on ``b = A @
    rng(0).random(n)``; with multicolor Gauss-Seidel (the default) and
    with zebra smoothers.  Holds the host hierarchy against the reference
    pyamg's fingerprint, the inner iterations, the relres, the kernel
    against its twin on every DIA operator.  Returns the phase's
    dia_matvec launches and the largest kernel-vs-plain difference."""
    phase("21. classical AMG: classical_poisson_500")
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.sparse import dia_kernel, spgemm_kernel

    want = json.loads(pathlib.Path(__file__).resolve().parent.joinpath(
        *FINGERPRINTS).read_text())["poisson_500"]
    A = poisson(CLASSICAL_500["grid"], format="csr")
    b = A @ np.random.default_rng(0).random(A.shape[0])
    dia_kernel.launches = 0
    spgemm_kernel.plain_cuda_calls = 0
    twin, worst = [0], 0.0
    for smoother in ("gauss_seidel", "zebra"):
        print(f"-- {smoother}")
        kw = {} if smoother == "gauss_seidel" else dict(
            presmoother="zebra", postsmoother="zebra")
        with counting_twin_calls(torch, twin):
            ml, _ = classical_setup(torch, A, CF="RS", **kw)
            info, relres, _, _ = classical_solve(torch, ml, A, b)
        bad = _fingerprint_mismatches(ml, want)
        print(f"reference fingerprint (poisson_500): "
              f"{'held' if not bad else bad}")
        launches = dia_kernel.launches
        worst = max(worst, hold_dia_cases(
            torch, np.random.default_rng(21),
            record_hierarchy(f"classical_poisson_500, {smoother}", ml)))
        if bad:
            raise AssertionError(f"the hierarchy left the reference's "
                                 f"fingerprint: {bad}")
        iters = CLASSICAL_500["iters"][smoother]
        if abs(info["inner_iterations"] - iters) > 1 or not relres <= TOL:
            raise AssertionError(f"{smoother}: {info}, relres {relres}; "
                                 f"expected {iters}+-1 and <= {TOL}")
    print(f"dia_matvec launches over the phase {launches};  plain twin "
          f"calls on CUDA {twin[0]} (DIA) {spgemm_kernel.plain_cuda_calls} "
          f"(SpGEMM)")
    if launches <= 0:
        raise AssertionError("the classical solves launched no dia_matvec")
    if twin[0] or spgemm_kernel.plain_cuda_calls:
        raise AssertionError("a plain twin ran on CUDA")
    return launches, worst


def _aniso(grid):
    from pyamg_tpu_torch.gallery import diffusion_stencil_2d, stencil_grid

    return stencil_grid(diffusion_stencil_2d(**ANISO["stencil"]), grid,
                        format="csr")


def anisotropic_classical(torch):
    """``benchmarks/suite.py``'s ``anisotropic_1024_classical``: the
    rotated anisotropic stencil (epsilon 0.01, theta pi/4, finite
    differences) at 1024^2, ``ruge_stuben_solver`` with evolution strength
    (k 2, epsilon 4), RS splitting, standard interpolation, float32
    operators; ``solve_mp`` to 1e-10 with 60 inner iterations.  Returns
    the hierarchy, the phase's dia_matvec launches and the largest
    kernel-vs-plain difference."""
    phase("22. classical AMG: anisotropic_1024_classical")
    from pyamg_tpu_torch.sparse import dia_kernel, spgemm_kernel

    A = _aniso(ANISO["grid"])
    b = A @ np.random.default_rng(0).random(A.shape[0])
    dia_kernel.launches = 0
    spgemm_kernel.plain_cuda_calls = 0
    twin = [0]
    with counting_twin_calls(torch, twin):
        ml, _ = classical_setup(torch, A, strength=ANISO["strength"],
                                CF="RS", interpolation="standard")
        info, relres, _, _ = classical_solve(torch, ml, A, b,
                                             inner_maxiter=60)
    launches = dia_kernel.launches
    worst = hold_dia_cases(torch, np.random.default_rng(22),
                           record_hierarchy("anisotropic_1024_classical", ml))
    time_level0_dia(torch, ml)
    print(f"dia_matvec launches over the phase {launches};  plain twin "
          f"calls on CUDA {twin[0]} (DIA) {spgemm_kernel.plain_cuda_calls} "
          f"(SpGEMM)")
    if abs(info["inner_iterations"] - ANISO["iters"]) > 1 \
            or not relres <= TOL:
        raise AssertionError(f"{info}, relres {relres}; expected "
                             f"{ANISO['iters']}+-1 and <= {TOL}")
    if launches <= 0:
        raise AssertionError("the anisotropic solve launched no dia_matvec")
    if twin[0] or spgemm_kernel.plain_cuda_calls:
        raise AssertionError("a plain twin ran on CUDA")
    return ml, launches, worst


def time_level0_dia(torch, ml, level=0):
    """dia_matvec on a hierarchy's level-0 operator (or that of ``level``;
    float32) beside its plain version, its bound and cuSPARSE's CSR SpMV;
    the launches made here are taken off the count."""
    from pyamg_tpu_torch.benchmarks.dia_spmv_bench import csr_tensor
    from pyamg_tpu_torch.sparse import SparseDIA, dia_kernel

    A0 = ml.levels[level].A
    A0 = SparseDIA(A0.diags.to(torch.float32), A0.offsets, A0.shape)
    xv = torch.rand(A0.shape[1], device="cuda", dtype=torch.float32)
    As = csr_tensor(ml.levels[level].A_csr, "cuda", torch.float32)
    before = dia_kernel.launches
    k_ms, p_ms, l_ms = _medians(torch, lambda: A0.matvec(xv),
                                lambda: A0.matvec_plain(xv),
                                lambda: torch.mv(As, xv))
    dia_kernel.launches = before
    nbytes, flops = dia_work(A0, xv)
    b_ms, b_by = bound(nbytes, flops)
    print(f"dia_matvec level {level} {tuple(A0.shape)}, {A0.n_offsets} "
          f"offsets, "
          f"{nbytes / 1e6:.1f} MB: kernel {k_ms * 1e3:.2f} us, bound "
          f"{b_ms * 1e3:.2f} us ({b_by}), kernel/bound {k_ms / b_ms:.2f};  "
          f"plain {p_ms * 1e3:.2f} us;  cuSPARSE torch.mv(csr int32) "
          f"{l_ms * 1e3:.2f} us")


def time_classical_products(torch, products,
                            picks=(("masked_spgemm_banded",
                                    "level 0 evolution A~*A~"),
                                   ("masked_spgemm_gather", "level 0 R*AP"))):
    """The SpGEMM kernels at the recorded products ``picks`` names (kernel,
    label; by default two shapes of the classical device setup: level 0's
    evolution squaring, banded, and R*AP, gather), float32, beside the
    plain version, the bound and cuSPARSE SpGEMM."""
    from pyamg_tpu_torch.sparse import spgemm_kernel

    before = dict(spgemm_kernel.launches)
    by_label = {label: (A, B, pat) for label, A, B, pat in products}
    for name, label in picks:
        A, B, pattern = by_label[label]
        slabs, bodies = spgemm_bodies(A, B, pattern)
        kernel = bodies[name][0]
        plain = functools.partial(spgemm_kernel.masked_matmul_vals_plain,
                                  *slabs)
        library, same, rel = spgemm_library(torch, A, B, pattern, kernel())
        k_ms, p_ms, lib_ms = _medians(torch, kernel, plain, library)
        b_ms, b_by, nbytes, needed = spgemm_bound(A, B, slabs)
        print(f"{name} float32: {label} A {tuple(slabs[0].shape)} B "
              f"{tuple(slabs[2].shape)} out {tuple(slabs[4].shape)}  kernel "
              f"{k_ms * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us ({b_by}, "
              f"{nbytes / 1e6:.1f} MB, {needed} products), kernel/bound "
              f"{k_ms / b_ms:.2f};  plain {p_ms * 1e3:.1f} us;  cuSPARSE "
              f"SpGEMM {lib_ms * 1e3:.1f} us (its pattern equals the mask: "
              f"{same}; max rel difference {rel:.1e})")
    spgemm_kernel.launches.update(before)


def classical_sharded(torch, ml_host):
    """``parallel.classical_setup_sharded`` on the anisotropic operator
    with the same strength, splitting and interpolation, float32, then CG
    to 1e-6 (60 iterations at most), as ``benchmarks/suite.py:289-313``
    runs it: the setup stage by stage, every masked product recorded and
    both SpGEMM kernels held against their twin on each.  The same setup in
    float64 must give the levels of the host hierarchy ``ml_host`` of the
    same operator (rows, nnz, splittings; values to 1e-10), the comparison
    of ``tests/test_parallel.py:446-470``; the float32 setup's coarse
    values carry float32 rounding into the next level's strength, and the
    level where it leaves the host build is printed.  Returns the float32
    setup's SpGEMM kernel launches and the largest kernel-vs-plain
    difference per kernel."""
    phase(f"23. classical_setup_sharded, {SHARDED_GRID[0]}^2, one card")
    import pyamg_tpu_torch.classical.split as split
    import pyamg_tpu_torch.parallel.classical_setup as cs
    import pyamg_tpu_torch.strength as strength
    from profile_general import stage_timer
    from pyamg_tpu_torch.sparse import SparseELL, spgemm_kernel

    A = _aniso(SHARDED_GRID)
    b = A @ np.random.default_rng(0).random(A.shape[0])
    kw = dict(strength=ANISO["strength"], CF="RS", interpolation="standard",
              device="cuda")
    if ml_host is None:       # phase 22 ran another size: a host build
        import pyamg_tpu_torch

        ml_host = pyamg_tpu_torch.ruge_stuben_solver(
            A, op_dtype=torch.float32, **kw)
    stages = [("strength (host, with its device squarings)", strength,
               "evolution_strength_of_connection"),
              ("splitting", split, "RS"),
              ("masked products", cs, "masked_spgemm_auto"),
              ("transposes onto patterns", cs, "transpose_onto_mesh"),
              ("symbolic patterns", cs, "_pattern_csr"),
              ("coarse read-back", cs, "host_values"),
              ("ELL slabs from scipy (host) and uploads", cs,
               "upload_rows"),
              ("slot maps (host)", cs, "_enc_csr"),
              ("slot maps (host)", cs, "_slab_from_csr"),
              ("smoothers (coloring)", cs, "_ell_smoother")]
    secs = {label: 0.0 for label, _, _ in stages}
    calls = {label: 0 for label, _, _ in stages}
    products = []
    for name in spgemm_kernel.launches:
        spgemm_kernel.launches[name] = 0
    spgemm_kernel.plain_cuda_calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording_products(products, 10 ** 6, cs,
                            ("evolution A~*A~", "denominators",
                             "distribution", "A*P", "R*AP")):
        with stage_timer(torch.device("cuda"), secs, calls, stages):
            sol = cs.classical_setup_sharded(A, dtype=np.float32, **kw)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    launches = dict(spgemm_kernel.launches)
    plain_calls = spgemm_kernel.plain_cuda_calls
    print(f"setup_s {setup_s:.3f}: " + ", ".join(
        f"{label} {secs[label]:.3f} ({calls[label]})" for label in secs)
        + f", rest (slabs, uploads, glue) "
        f"{setup_s - sum(secs.values()):.3f};  SpGEMM launches {launches};  "
        f"plain twin calls on CUDA {plain_calls}")
    print(sol)

    runs = []
    for _ in range(3):
        res = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = sol.solve(b, tol=1e-6, maxiter=60, accel="cg", residuals=res)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    relres = _true_relres(A, b, x)
    print(f"solve(accel='cg', tol=1e-6, maxiter=60) float32: iterations "
          f"{len(res) - 1}  true f64 relres {relres:.3e}  solve_s best of 3 "
          f"{min(runs):.4f}  runs {[round(r, 4) for r in runs]}")

    def levels(h):
        return [(lvl.A_csr.shape[0], lvl.A_csr.nnz) for lvl in h.levels]

    def same_splits(h):
        return [bool(np.array_equal(ls.splitting, lh.splitting))
                for ls, lh in zip(h.levels[:-1], ml_host.levels[:-1])]

    want = levels(ml_host)
    got32, split32 = levels(sol), same_splits(sol)
    PHASE23.update(levels=got32, opc=sol.inner.operator_complexity(),
                   iters=len(res) - 1)
    equal32 = next((i for i, (g, w, s) in enumerate(
        zip(got32, want, split32 + [True])) if g != w or not s),
        len(want))
    print(f"float32 setup: levels (rows, nnz) {got32};  the host build's "
          f"{want};  equal down to level {equal32 - 1} (splittings "
          f"{split32})")
    t0 = time.perf_counter()
    sol64 = cs.classical_setup_sharded(A, dtype=np.float64, **kw)
    torch.cuda.synchronize()
    setup64_s = time.perf_counter() - t0
    plain_calls += spgemm_kernel.plain_cuda_calls
    got64, split64 = levels(sol64), same_splits(sol64)
    rel64 = [float(abs(ls.A_csr - lh.A_csr).max() / abs(lh.A_csr).max())
             for ls, lh in zip(sol64.levels, ml_host.levels)] \
        if got64 == want else None
    print(f"float64 setup ({setup64_s:.3f} s): levels {got64};  splittings "
          f"equal {split64};  max rel difference of A per level from the "
          f"host build {rel64}")
    if got64 != want or not all(split64) or max(rel64) > 1e-10:
        raise AssertionError("the float64 device setup's levels differ from "
                             "the host build's")
    spgemm_kernel.launches.update(launches)
    print(f"holding both SpGEMM kernels against their twin on the float32 "
          f"setup's {len(products)} masked products:")
    worst = hold_spgemm(torch, products)
    time_classical_products(torch, products)
    if not (np.isfinite(relres) and relres <= 1e-5 and len(res) - 1 < 60):
        raise AssertionError(f"CG: {len(res) - 1} iterations, relres "
                             f"{relres}")
    if len(products) != sum(launches.values()) or not products:
        raise AssertionError(f"recorded {len(products)} masked products, "
                             f"the kernels launched {launches}")
    if plain_calls:
        raise AssertionError(f"the setups ran the plain twin on CUDA "
                             f"{plain_calls} times")
    return launches, worst


def _sa_stages(module=None):
    """``stage_timer`` stages of an SA-family setup whose level loop lives
    in ``module`` (default ``aggregation.aggregation``): the host stages,
    the device arrays and the smoothers."""
    import pyamg_tpu_torch.relaxation.relaxation as rel
    from pyamg_tpu_torch.aggregation import aggregation as agg

    mod = module or agg
    stages = [("improve_candidates", rel, "block_gauss_seidel"),
              ("improve_candidates", rel, "gauss_seidel"),
              ("strength", mod, "_strength"),
              ("aggregation", mod, "_aggregate"),
              ("fit_candidates", mod, "fit_candidates"),
              ("Galerkin RAP", mod, "galerkin_product"),
              ("device arrays", mod, "_finalize_device_operators"),
              ("smoothers", mod, "change_smoothers")]
    if module is None:
        stages += [("grid aggregation", agg, "grid_aggregation"),
                   ("structured S and rho", agg, "structured_smoother_S"),
                   ("P smoothing", agg, "_smooth_P")]
    else:
        stages += [("root-node Cpt_params, scale_T", mod, "get_Cpt_params"),
                   ("root-node Cpt_params, scale_T", mod, "scale_T"),
                   ("energy P", mod, "energy_prolongation_smoother")]
    return stages


def timed_setup(torch, build, stages):
    """``build()`` on the card under ``stage_timer``; prints the setup
    seconds stage by stage and returns ``(result, setup_s)``."""
    from profile_general import stage_timer

    secs = {label: 0.0 for label, _, _ in stages}
    calls = {label: 0 for label, _, _ in stages}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with stage_timer(torch.device("cuda"), secs, calls, stages):
        out = build()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rest = setup_s - sum(secs.values())
    print(f"setup_s {setup_s:.3f}: " + ", ".join(
        f"{label} {secs[label]:.3f} ({calls[label]})" for label in secs)
        + f", rest (level loop, products, glue) {rest:.3f}")
    return out, setup_s


def print_levels(ml):
    """One line per level: rows, nnz, the device form of A, P and R, the
    smoother; then the operator complexity."""
    for i, lvl in enumerate(ml.levels):
        sm = lvl.presmoother
        meta = getattr(lvl, "struct_meta", None)
        print(f"level {i}: rows {lvl.A.shape[0]:8d} nnz {lvl.nnz:9d}  A "
              f"{_form(lvl.A)}  P {_form(getattr(lvl, 'P', None))}  R "
              f"{_form(getattr(lvl, 'R', None))}  "
              f"{'-' if sm is None else sm.kind}"
              + ("" if meta is None else
                 f"  block {meta['block']} {meta['sfn']}"))
    print(f"levels {len(ml.levels)}  operator_complexity "
          f"{ml.operator_complexity():.6f}")


def timed_solve(torch, ml, A, b, accel="cg", tol=1e-8, maxiter=100,
                repeats=3):
    """``solve(b, tol, accel, maxiter)`` best of ``repeats``; returns
    ``(residual history, true f64 relres, best_s)``.  The history is what
    the method tracks: ||M r|| for left-preconditioned GMRES."""
    runs = []
    for _ in range(repeats):
        res = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = ml.solve(b, tol=tol, accel=accel, maxiter=maxiter, residuals=res)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    relres = _true_relres(A, b, x)
    print(f"solve(tol={tol:g}, accel={accel!r}, maxiter={maxiter}): "
          f"iterations {len(res) - 1}  tracked {res[-1] / res[0]:.3e}  true "
          f"f64 relres {relres:.3e}  solve_s best of {repeats} "
          f"{min(runs):.4f}  runs {[round(r, 4) for r in runs]}")
    return res, relres, min(runs)


def _check_front_door(torch, name, launches, worst, twin):
    """Print a front-door phase's dia_matvec launches, its largest
    difference from the twin and the twin calls on CUDA; raise if the
    phase launched no kernel or ran a twin on CUDA."""
    from pyamg_tpu_torch.sparse import spgemm_kernel

    print(f"dia_matvec launches over the phase {launches}, largest "
          f"absolute difference from the twin {worst:.3e};  plain twin "
          f"calls on CUDA {twin[0]} (DIA) {spgemm_kernel.plain_cuda_calls} "
          f"(SpGEMM)")
    if launches <= 0:
        raise AssertionError(f"{name} launched no dia_matvec")
    if twin[0] or spgemm_kernel.plain_cuda_calls:
        raise AssertionError("a plain twin ran on CUDA")


def poisson3d(torch):
    """``benchmarks/suite.py``'s ``poisson3d_64_sa_chebyshev``: the 64^3
    Poisson problem (262,144 unknowns) through
    ``smoothed_aggregation_solver`` with Chebyshev smoothers, no candidate
    improvement, float32 operators and (2, 2, 2) grid blocks, ``solve_mp``
    to 1e-10; then the default call on the same matrix (its 3-D grid
    metadata takes the unstructured chain), CG to 1e-8.  K1' against its
    twin on every DIA operator of both, and timed at the 3-D level-0 and
    widest coarse shapes.  Returns ``(hierarchies, launches, worst)``."""
    phase("24. 3-D SA: poisson3d_64_sa_chebyshev, 64^3")
    import pyamg_tpu_torch
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.sparse import (DenseOp, SparseDIA, dia_kernel,
                                        spgemm_kernel)

    A = poisson(POISSON3D["grid"], format="csr")
    b = A @ np.random.default_rng(0).random(A.shape[0])
    dia_kernel.launches = 0
    spgemm_kernel.plain_cuda_calls = 0
    twin = [0]
    with counting_twin_calls(torch, twin):
        ml, _ = timed_setup(torch, lambda: (
            pyamg_tpu_torch.smoothed_aggregation_solver(
                A, presmoother="chebyshev", postsmoother="chebyshev",
                improve_candidates=None, op_dtype=torch.float32,
                aggregate=("grid", {"block": POISSON3D["block"]}),
                device="cuda")), _sa_stages())
        print_levels(ml)
        info, relres, _, _ = classical_solve(torch, ml, A, b)
    launches = dia_kernel.launches
    worst = hold_dia_cases(torch, np.random.default_rng(24),
                           record_hierarchy("poisson3d_64_sa_chebyshev", ml))
    widest = max(range(len(ml.levels)),
                 key=lambda i: ml.levels[i].A.n_offsets
                 if isinstance(ml.levels[i].A, SparseDIA) else -1)
    time_level0_dia(torch, ml)
    time_level0_dia(torch, ml, widest)
    # gather-free levels: DIA, or dense where a coarse stencil passes
    # device_operator's 512 offsets (level 3 of 64^3: 603), in both
    # packages
    if not all(isinstance(lvl.A, (SparseDIA, DenseOp))
               for lvl in ml.levels):
        raise AssertionError("a level of the 3-D grid hierarchy is neither "
                             "DIA nor dense")
    if abs(info["inner_iterations"] - POISSON3D["iters"]) > 1 \
            or not relres <= 5e-10:
        raise AssertionError(f"{info}, relres {relres}; expected "
                             f"{POISSON3D['iters']}+-1 and <= 5e-10")
    print("-- the default call on the same matrix (3-D grid metadata: the "
          "unstructured chain)")
    dia_kernel.launches = 0
    with counting_twin_calls(torch, twin):
        ml_d, _ = timed_setup(torch, lambda: (
            pyamg_tpu_torch.smoothed_aggregation_solver(
                A, op_dtype=torch.float32, device="cuda")), _sa_stages())
        print_levels(ml_d)
        _, relres_cg, _ = timed_solve(torch, ml_d, A, b)
    launches += dia_kernel.launches
    worst = max(worst, hold_dia_cases(torch, np.random.default_rng(240),
                                      record_hierarchy("64^3 default call",
                                                       ml_d)))
    _check_front_door(torch, "phase 24", launches, worst, twin)
    if hasattr(ml_d.levels[0], "struct_meta") or not relres_cg <= 5e-7:
        raise AssertionError(f"default call on 64^3: relres {relres_cg} "
                             f"(<= 5e-7), or it took the structured path")
    return [("poisson3d_64_sa_chebyshev", ml, dict(
                 smooth=("jacobi", {"omega": 4.0 / 3.0}),
                 presmoother="chebyshev", postsmoother="chebyshev")),
            ("64^3 default call", ml_d, dict(
                improve_candidates=("block_gauss_seidel",
                                    {"sweep": "symmetric",
                                     "iterations": 4})))], launches, worst


def pcr_rounds(torch, ml):
    """Parallel-cyclic-reduction solves and rounds of one V-cycle of a
    line-smoothed hierarchy (float32), of the scalar lines and of the
    node-blocked ones apart: ``{"scalar": {"solves", "rounds"},
    "blocked": {...}}``."""
    from pyamg_tpu_torch.relaxation import device

    count = {kind: {"solves": 0, "rounds": 0}
             for kind in ("scalar", "blocked")}

    def counted(kind, real):
        def run(dl, d, du, B):
            count[kind]["solves"] += 1
            count[kind]["rounds"] += int(np.ceil(np.log2(max(d.shape[-1],
                                                             1))))
            return real(dl, d, du, B)
        return run

    n = ml.levels[0].A.shape[0]
    b = torch.ones(n, device="cuda", dtype=ml.levels[0].A.dtype)
    real = device.batched_tridiag_pcr, device.batched_block_tridiag_pcr
    device.batched_tridiag_pcr = counted("scalar", real[0])
    device.batched_block_tridiag_pcr = counted("blocked", real[1])
    try:
        _launches_of(lambda: ml.cycle_fn("V")(torch.zeros_like(b), b))
    finally:
        device.batched_tridiag_pcr, device.batched_block_tridiag_pcr = real
    return count


def adaptive_aniso(torch):
    """``benchmarks/suite.py``'s ``adaptive_sa_anisotropy_1024``: the
    grid-aligned anisotropic FD stencil (epsilon 0.001) at 1024^2 through
    ``adaptive_sa_solver(A, num_candidates=1, candidate_iters=15,
    max_coarse=100, prepostsmoother="zebra")``, cast to float32, then
    ``solve_mp`` to 1e-10 with 60 inner iterations.  Returns ``(hierarchy
    record, launches, worst)``."""
    phase("25. adaptive SA: adaptive_sa_anisotropy_1024")
    import pyamg_tpu_torch
    import pyamg_tpu_torch.relaxation.relaxation as rel
    from pyamg_tpu_torch.aggregation import adaptive
    from pyamg_tpu_torch.aggregation import aggregation as agg
    from pyamg_tpu_torch.gallery import diffusion_stencil_2d, stencil_grid
    from pyamg_tpu_torch.sparse import dia_kernel, spgemm_kernel

    A = stencil_grid(diffusion_stencil_2d(**ASA["stencil"]), ASA["grid"],
                     format="csr")
    b = A @ np.random.default_rng(0).random(A.shape[0])
    stages = [("host zebra sweeps", rel, "zebra"),
              ("host Gauss-Seidel", rel, "gauss_seidel"),
              ("grid aggregation", agg, "grid_aggregation"),
              ("fit_candidates", agg, "fit_candidates"),
              ("structured S and rho", agg, "structured_smoother_S"),
              ("device arrays", agg, "_finalize_device_operators"),
              ("smoothers", agg, "change_smoothers")]
    dia_kernel.launches = 0
    spgemm_kernel.plain_cuda_calls = 0
    twin = [0]
    with counting_twin_calls(torch, twin):
        (ml, work), setup_s = timed_setup(
            torch, lambda: pyamg_tpu_torch.adaptive_sa_solver(
                A, device="cuda", **ASA["kw"]), stages)
        ml = ml.astype(torch.float32)
        torch.cuda.synchronize()
        print(f"adaptive_sa_solver: work {work:.4f} (fine-level nnz units),"
              f" then astype(float32)")
        print_levels(ml)
        info, relres, _, _ = classical_solve(torch, ml, A, b,
                                             inner_maxiter=60)
    launches = dia_kernel.launches
    pcr = pcr_rounds(torch, ml)["scalar"]
    print(f"zebra line solves a V-cycle {pcr['solves']}, PCR rounds "
          f"{pcr['rounds']}")
    worst = hold_dia_cases(torch, np.random.default_rng(25),
                           record_hierarchy("adaptive_sa_anisotropy_1024",
                                            ml))
    _check_front_door(torch, "phase 25", launches, worst, twin)
    if ml.levels[0].struct_meta["sfn"] != "jacobi_weak" \
            or 1 not in ml.levels[0].struct_meta["block"]:
        raise AssertionError("level 0 was not semicoarsened")
    if abs(info["inner_iterations"] - ASA["iters"]) > ASA["iters_tol"] \
            or not relres <= 5e-10:
        raise AssertionError(f"{info}, relres {relres}; expected "
                             f"{ASA['iters']}+-{ASA['iters_tol']} and "
                             f"<= 5e-10")
    return [("adaptive_sa_anisotropy_1024", ml, dict(
        smooth=("jacobi", {}), presmoother="zebra",
        postsmoother="zebra"))], launches, worst


def rootnode_phase(torch):
    """``rootnode_solver(A)`` with every argument but ``op_dtype=float32``
    at its default, on the 1024^2 Poisson problem with its grid metadata
    and as plain CSR: CG to 1e-8, then ``solve_mp`` to 1e-10.  Returns
    ``(hierarchy records, launches, worst)``."""
    phase("26. rootnode_solver, 1024^2, with A.grid and as plain CSR")
    import scipy.sparse as sp
    import pyamg_tpu_torch
    from pyamg_tpu_torch.aggregation import rootnode
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.sparse import dia_kernel, spgemm_kernel

    launches, worst, out = 0, 0.0, []
    spgemm_kernel.plain_cuda_calls = 0
    twin = [0]
    for which in ("grid", "plain CSR"):
        print(f"-- {which}")
        A = poisson(ROOTNODE_GRID, format="csr")
        if which != "grid":
            A = sp.csr_matrix(A.tocoo())
        b = A @ np.random.default_rng(0).random(A.shape[0])
        dia_kernel.launches = 0
        with counting_twin_calls(torch, twin):
            ml, _ = timed_setup(torch, lambda: pyamg_tpu_torch.rootnode_solver(
                A, op_dtype=torch.float32, device="cuda"),
                _sa_stages(rootnode))
            print_levels(ml)
            print(f"level-0 transfers: P {_form(ml.levels[0].P)}, R "
                  f"{_form(ml.levels[0].R)}")
            _, relres_cg, _ = timed_solve(torch, ml, A, b)
            info, relres, _, _ = classical_solve(torch, ml, A, b)
        launches += dia_kernel.launches
        worst = max(worst, hold_dia_cases(
            torch, np.random.default_rng(26),
            record_hierarchy(f"rootnode_solver, {which}", ml)))
        if not (relres_cg <= 5e-7 and relres <= 5e-10):
            raise AssertionError(f"rootnode {which}: CG relres {relres_cg}"
                                 f" (<= 5e-7), solve_mp {relres} (<= 5e-10)")
        out.append((f"rootnode_solver, {which}", ml, dict(
            smooth=("energy", {"krylov": "cg", "degree": 1, "maxiter": 4}),
            improve_candidates=("block_gauss_seidel",
                                {"sweep": "symmetric", "iterations": 4}))))
    _check_front_door(torch, "phase 26", launches, worst, twin)
    return out, launches, worst


def blackbox_phase(torch, records):
    """``pyamg_tpu_torch.solve(A, b, return_solver=True)`` at its defaults
    on the 1024^2 Poisson problem; then ``setup_complexity`` and
    ``cycle_complexity`` of every hierarchy of phases 24-27.  Returns
    ``(launches, worst)``."""
    phase("27. the black box: pyamg_tpu_torch.solve(A, b), 1024^2")
    import pyamg_tpu_torch
    from pyamg_tpu_torch import blackbox
    from pyamg_tpu_torch.complexity import cycle_complexity, setup_complexity
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.sparse import dia_kernel, spgemm_kernel

    A = poisson(BLACKBOX_GRID, format="csr")
    b = A @ np.random.default_rng(0).random(A.shape[0])
    stages = [("ishermitian", blackbox, "ishermitian")] + _sa_stages()
    dia_kernel.launches = 0
    spgemm_kernel.plain_cuda_calls = 0
    twin = [0]
    with counting_twin_calls(torch, twin):
        (x, ml), total_s = timed_setup(torch, lambda: pyamg_tpu_torch.solve(
            A, b, return_solver=True, device="cuda"), stages)
        relres = _true_relres(A, b, x)
        runs = []
        for _ in range(3):
            res = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pyamg_tpu_torch.solve(A, b, existing_solver=ml, verb=False,
                                  residuals=res, device="cuda")
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
    launches = dia_kernel.launches
    print_levels(ml)
    print(f"solve(A, b): setup and solve {total_s:.3f} s, then with the "
          f"solver: CG iterations {len(res) - 1}, true f64 relres "
          f"{relres:.3e}, solve_s best of 3 {min(runs):.4f}  runs "
          f"{[round(r, 4) for r in runs]}")
    worst = hold_dia_cases(torch, np.random.default_rng(27),
                           record_hierarchy("black box", ml))
    _check_front_door(torch, "phase 27", launches, worst, twin)
    if not relres <= 5e-5:
        raise AssertionError(f"the black box's relres {relres} > 5e-5")
    config = blackbox.solver_configuration(A, verb=False)
    records = records + [("black box", ml, dict(
        strength=config["strength"], smooth=config["smooth"],
        improve_candidates=("block_gauss_seidel",
                            {"sweep": "symmetric", "iterations": 4})))]
    for name, h, kw in records:
        print(f"{name}: setup_complexity {setup_complexity(h, **kw):.4f}  "
              f"cycle_complexity V {cycle_complexity(h, 'V'):.4f} W "
              f"{cycle_complexity(h, 'W'):.4f}  (fine-level nnz units)")
    return launches, worst


def recirc_flow(n, eps=1e-2):
    """The JAX package's ``recirc_flow`` example at any size: -eps Laplacian
    plus b.grad on an n x n grid of the unit square (h = 1/(n + 1)), the
    rotating wind b = (y - 1/2, 1/2 - x), first-order upwinding (|b|/h
    joins the diagonal); 5 diagonals, not symmetric.  At n = 40 it is the
    gallery's matrix entry for entry."""
    import scipy.sparse as sp

    h = 1.0 / (n + 1)
    xs = (np.arange(n) + 1) * h
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    b1 = (Y - 0.5).reshape(-1)
    b2 = (0.5 - X).reshape(-1)
    N = n * n
    idx = np.arange(N)
    ix, iy = idx // n, idx % n
    rows, cols = [idx, idx], [idx, idx]
    vals = [np.full(N, 4.0 * eps / h**2), (np.abs(b1) + np.abs(b2)) / h]
    for mask, shift, v in (
            (ix + 1 < n, n, -eps / h**2 + np.minimum(b1, 0) / h),
            (ix >= 1, -n, -eps / h**2 - np.maximum(b1, 0) / h),
            (iy + 1 < n, 1, -eps / h**2 + np.minimum(b2, 0) / h),
            (iy >= 1, -1, -eps / h**2 - np.maximum(b2, 0) / h)):
        rows.append(idx[mask])
        cols.append(idx[mask] + shift)
        vals.append(v[mask])
    return sp.coo_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                 np.concatenate(cols))),
                         shape=(N, N)).tocsr()


def nonsymmetric_phase(torch):
    """The nonsymmetric chain on ``recirc_flow`` (``NONSYM``): at 1024^2
    nonsymmetric SA (energy-GMRES P, R smoothed on A^H, Jacobi on the
    normal equations A^H A as smoother; float32 operators) setup stage by
    stage, ``solve_mp(accel="gmres")`` to 1e-10, ``solve(accel="gmres")``
    to 1e-8, and the normal-equation accelerators cgnr and cgne; at 256^2
    nonsymmetric root-node SA (``solve_mp``), the black box ``solve(A,
    b)`` and five V-cycles with each of ``NONSYM_SMOOTHERS``.  K1' against
    its twin on every DIA operator of the three hierarchies, and timed on
    the 1024^2 level 0.  Returns ``(launches, worst)``."""
    phase("29. nonsymmetric SA: recirc_flow, 1024^2; root-node, the black "
          "box and the NE/NR and Krylov smoothers at 256^2")
    import pyamg_tpu_torch
    from pyamg_tpu_torch.relaxation.smoothing import change_smoothers
    from pyamg_tpu_torch.sparse import CptProlongOp, dia_kernel, spgemm_kernel

    t_phase = time.perf_counter()
    n = NONSYM["grid"]
    A = recirc_flow(n)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    asym = abs(A - A.T).max() / abs(A).max()
    print(f"recirc_flow {n}^2: {A.shape[0]} rows, nnz {A.nnz}, "
          f"|A - A^T|/|A| {asym:.3e}")
    if asym <= 1e-3:
        raise AssertionError("recirc_flow came out symmetric")
    spgemm_kernel.plain_cuda_calls = 0
    twin = [0]
    shapes_before = dict(SHAPE_LAUNCHES)
    with counting_twin_calls(torch, twin):
        dia_kernel.launches = 0
        ml, _ = timed_setup(
            torch, lambda: pyamg_tpu_torch.smoothed_aggregation_solver(
                A, op_dtype=torch.float32, device="cuda", **NONSYM["kw"]),
            _sa_stages())
        print_levels(ml)
        embedded = [i for i, lvl in enumerate(ml.levels[:-1])
                    if isinstance(lvl.P, CptProlongOp)]
        print(f"levels whose transfers embed at the roots (R its own "
              f"rows): {embedded}")
        _, relres, _, _ = classical_solve(torch, ml, A, b, accel="gmres")
        res, relres8, _ = timed_solve(torch, ml, A, b, accel="gmres",
                                      maxiter=400)
        normal = {accel: timed_solve(torch, ml, A, b, accel=accel, tol=1e-3,
                                     maxiter=400)[1]
                  for accel in ("cgnr", "cgne")}
        n_large = dia_kernel.launches
        print(f"dia_matvec launches at {n}^2: {n_large}")
        if not (relres <= 5e-10 and n_large > 0
                and res[-1] <= 1e-8 * res[0] and len(res) - 1 < 400
                and relres8 <= 1e-2 and normal["cgnr"] < 0.1
                and all(np.isfinite(v) for v in normal.values())):
            raise AssertionError(
                f"nonsymmetric SA at {n}^2: solve_mp relres {relres} "
                f"(<= 5e-10), {n_large} launches, GMRES tracked "
                f"{res[-1] / res[0]} (<= 1e-8) true {relres8} (<= 1e-2), "
                f"{normal} (cgnr < 0.1)")

        small = NONSYM["small"]
        A = recirc_flow(small)
        b = np.random.default_rng(1).standard_normal(A.shape[0])
        mr = pyamg_tpu_torch.rootnode_solver(
            A, symmetry="nonsymmetric",
            smooth=("energy", {"krylov": "gmres"}), op_dtype=torch.float32,
            device="cuda")
        print_levels(mr)
        _, relres_r, _, _ = classical_solve(torch, mr, A, b, accel="gmres")
        res_b = []
        x, mb = pyamg_tpu_torch.solve(A, b, residuals=res_b, verb=False,
                                      return_solver=True, device="cuda")
        relres_b = _true_relres(A, b, x)
        print_levels(mb)
        print(f"the black box solve(A, b): GMRES iterations "
              f"{len(res_b) - 1}  tracked {res_b[-1] / res_b[0]:.3e} "
              f"(tol 1e-5)  true f64 relres {relres_b:.3e}")
        held = [(f"recirc_flow {n}^2, nonsymmetric SA", ml),
                (f"recirc_flow {small}^2, nonsymmetric root-node", mr),
                (f"recirc_flow {small}^2, black box", mb)]
        cases = [record_hierarchy(name, h) for name, h in held]
        reduced = {}
        for name in NONSYM_SMOOTHERS:
            change_smoothers(mr, (name, {}), (name, {}))
            res_s = []
            mr.solve(b, tol=1e-12, maxiter=5, residuals=res_s)
            reduced[name] = res_s[-1] / res_s[0]
        print("five V-cycles on the root-node hierarchy, residual "
              "reduction by smoother: " + ", ".join(
                  f"{k} {v:.3e}" for k, v in reduced.items()))
    launches = dia_kernel.launches
    worst = max(hold_dia_cases(torch, np.random.default_rng(290 + i), c)
                for i, c in enumerate(cases))
    time_level0_dia(torch, ml)
    if not (relres_r <= 5e-10 and res_b[-1] <= 1e-5 * res_b[0]
            and all(v < 1 for v in reduced.values())):
        raise AssertionError(
            f"{small}^2: root-node solve_mp relres {relres_r} (<= 5e-10), the "
            f"black box tracked {res_b[-1] / res_b[0]} (<= 1e-5), smoother "
            f"reductions {reduced} (< 1)")
    _check_front_door(torch, "phase 29", launches, worst, twin)
    for key in sorted(SHAPE_LAUNCHES, key=lambda key: -key[0]):
        count = SHAPE_LAUNCHES[key] - shapes_before.get(key, 0)
        if count:
            print(f"phase 29 launches at {key[0]}x{key[1]} k={key[2]} "
                  f"{key[3]}: {count}")
    print(f"phase 29 seconds {time.perf_counter() - t_phase:.1f}")
    return launches, worst


def off_kernel_levels(ml):
    """The levels whose operator is not a DIA operator (K1' does not run
    their matvecs), by index and form."""
    from pyamg_tpu_torch.sparse import SparseDIA

    return {i: _form(lvl.A) for i, lvl in enumerate(ml.levels)
            if not isinstance(lvl.A, SparseDIA)}


def adaptive_k2(torch):
    """``adaptive_sa_anisotropy_K2_1024`` (``K2``): the grid-aligned
    anisotropic FD stencil (epsilon 0.001) at 1024^2 through
    ``adaptive_sa_solver`` with two candidates, full (3, 3) grid blocks
    and zebra, cast to float32, ``solve_mp`` to 1e-10 with 60 inner
    iterations.  Every level of two dofs a node relaxes along
    block-tridiagonal lines.  Returns ``(launches, worst)``."""
    phase("30. adaptive SA, two candidates, full (3, 3) coarsening: "
          "adaptive_sa_anisotropy_K2_1024")
    import pyamg_tpu_torch
    import pyamg_tpu_torch.relaxation.relaxation as rel
    from pyamg_tpu_torch.aggregation import aggregation as agg
    from pyamg_tpu_torch.gallery import diffusion_stencil_2d, stencil_grid
    from pyamg_tpu_torch.sparse import SparseBDIA, dia_kernel, spgemm_kernel

    t_phase = time.perf_counter()
    A = stencil_grid(diffusion_stencil_2d(**K2["stencil"]), K2["grid"],
                     format="csr")
    b = A @ np.random.default_rng(0).random(A.shape[0])
    stages = [("host zebra sweeps", rel, "zebra"),
              ("host Gauss-Seidel", rel, "gauss_seidel"),
              ("grid aggregation", agg, "grid_aggregation"),
              ("fit_candidates", agg, "fit_candidates"),
              ("structured S and rho", agg, "structured_smoother_S"),
              ("Galerkin RAP", agg, "galerkin_product"),
              ("device arrays", agg, "_finalize_device_operators"),
              ("smoothers", agg, "change_smoothers")]
    dia_kernel.launches = 0
    spgemm_kernel.plain_cuda_calls = 0
    twin = [0]
    with counting_twin_calls(torch, twin):
        (ml, work), _ = timed_setup(
            torch, lambda: pyamg_tpu_torch.adaptive_sa_solver(
                A, device="cuda", **K2["kw"]), stages)
        ml = ml.astype(torch.float32)
        torch.cuda.synchronize()
        print(f"adaptive_sa_solver: work {work:.4f} (fine-level nnz units),"
              f" then astype(float32)")
        print_levels(ml)
        info, relres, _, _ = classical_solve(torch, ml, A, b,
                                             inner_maxiter=60)
    launches = dia_kernel.launches
    pcr = pcr_rounds(torch, ml)
    print(f"PCR a V-cycle: scalar lines {pcr['scalar']}, node-blocked "
          f"lines {pcr['blocked']}")
    blocked = [i for i, lvl in enumerate(ml.levels[:-1])
               if getattr(lvl, "blocksize", 1) == 2]
    flat = [i for i in blocked
            if ml.levels[i].presmoother.line_tri.dim() != 5]
    off = off_kernel_levels(ml)
    print(f"levels of two dofs a node {blocked}; on block-tridiagonal lines "
          f"{[i for i in blocked if i not in flat]}; levels whose A is not "
          f"DIA (no K1') {off}")
    # the node-blocked levels' transfers carry their smoother S as a
    # SparseBDIA (plain torch): the largest one timed
    bdia = [op for lvl in ml.levels[:-1]
            for tr in (lvl.A, lvl.P, lvl.R)
            for op in getattr(tr, "ops", (tr,)) if isinstance(op, SparseBDIA)]
    if bdia:
        time_bdia(torch, max(bdia, key=lambda op: op.shape[0]))
    worst = hold_dia_cases(torch, np.random.default_rng(30),
                           record_hierarchy("adaptive_sa_anisotropy_K2_1024",
                                            ml))
    _check_front_door(torch, "phase 30", launches, worst, twin)
    opc = ml.operator_complexity()
    if not blocked or flat or pcr["blocked"]["solves"] <= 0:
        raise AssertionError(f"levels of two dofs a node {blocked}, of them "
                             f"not block-line relaxed {flat}, blocked PCR "
                             f"{pcr['blocked']}")
    if opc > K2["opc_max"] \
            or abs(info["inner_iterations"] - K2["iters"]) > K2["iters_tol"] \
            or not relres <= 5e-10:
        raise AssertionError(f"opc {opc} (<= {K2['opc_max']}), {info}, "
                             f"relres {relres}; expected {K2['iters']}+-"
                             f"{K2['iters_tol']} and <= 5e-10")
    print(f"phase 30 seconds {time.perf_counter() - t_phase:.1f}")
    return launches, worst


def schwarz_phase(torch):
    """Overlapping Schwarz as the smoother of SA on the 1024^2 Poisson
    problem with its grid metadata (``SCHWARZ_KW``, float32 operators):
    setup stage by stage with ``schwarz_parameters`` apart, the tables'
    bytes by level, CG to 1e-8, ``solve_mp`` to 1e-10, five V-cycles, one
    step twice for the same bits; then ``strength_based_schwarz`` on level
    0 takes the same subdomains.  Returns ``(launches, worst)``."""
    phase("31. overlapping Schwarz smoothers, 1024^2 Poisson")
    import pyamg_tpu_torch
    import pyamg_tpu_torch.relaxation.relaxation as rel
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.relaxation.device import schwarz_step
    from pyamg_tpu_torch.relaxation.smoothing import make_smoother_data
    from pyamg_tpu_torch.sparse import dia_kernel, spgemm_kernel

    t_phase = time.perf_counter()
    A = poisson(GRID, format="csr")
    b = A @ np.random.default_rng(0).random(A.shape[0])
    stages = [st for st in _sa_stages() if st[0] != "smoothers"] \
        + [("schwarz_parameters", rel, "schwarz_parameters")]
    dia_kernel.launches = 0
    spgemm_kernel.plain_cuda_calls = 0
    twin = [0]
    with counting_twin_calls(torch, twin):
        ml, _ = timed_setup(
            torch, lambda: pyamg_tpu_torch.smoothed_aggregation_solver(
                A, op_dtype=torch.float32, device="cuda", **SCHWARZ_KW),
            stages)
        print_levels(ml)
        for i, lvl in enumerate(ml.levels[:-1]):
            sm = lvl.presmoother
            nbytes = sum(t.numel() * t.element_size() for t in (
                sm.subdomain_idx, sm.subdomain_inv, sm.dof_slots,
                sm.dof_weight))
            print(f"level {i}: Schwarz tables (n_dom, L) = "
                  f"{tuple(sm.subdomain_idx.shape)}, dof slots "
                  f"{tuple(sm.dof_slots.shape)}: {nbytes / 1e6:.1f} MB on "
                  f"the card")
        _, relres_cg, _ = timed_solve(torch, ml, A, b)
        info, relres, _, _ = classical_solve(torch, ml, A, b)
        cycles = []
        ml.solve(b, tol=1e-12, maxiter=5, residuals=cycles)
        lvl = ml.levels[0]
        xs = torch.rand(A.shape[0], device="cuda", dtype=torch.float32)
        bs = torch.rand(A.shape[0], device="cuda", dtype=torch.float32)
        same = torch.equal(schwarz_step(lvl.A, lvl.presmoother, xs, bs),
                           schwarz_step(lvl.A, lvl.presmoother, xs, bs))
    launches = dia_kernel.launches
    print(f"five V-cycles: residual reduction {cycles[-1] / cycles[0]:.3e};"
          f"  one Schwarz step twice on level 0, the same bits: {same}")
    t0 = time.perf_counter()
    sb = make_smoother_data(lvl, "strength_based_schwarz", {},
                            dtype=torch.float32, device="cuda")
    agree = torch.equal(sb.subdomain_idx, lvl.presmoother.subdomain_idx) \
        and torch.equal(sb.subdomain_inv, lvl.presmoother.subdomain_inv)
    print(f"strength_based_schwarz on level 0 ({time.perf_counter() - t0:.3f}"
          f" s): the subdomains and inverses of schwarz: {agree}")
    print(f"levels whose A is not DIA (no K1') {off_kernel_levels(ml)};  "
          f"cycle_complexity V {pyamg_tpu_torch.cycle_complexity(ml):.4f} "
          f"(fine-level nnz units, the subdomain solves included)")
    worst = hold_dia_cases(torch, np.random.default_rng(31),
                           record_hierarchy("schwarz SA 1024^2", ml))
    _check_front_door(torch, "phase 31", launches, worst, twin)
    if not (relres_cg <= 5e-7 and relres <= 5e-10
            and cycles[-1] < cycles[0] and same and agree):
        raise AssertionError(f"CG relres {relres_cg} (<= 5e-7), solve_mp "
                             f"{info} relres {relres} (<= 5e-10), five "
                             f"cycles {cycles[0]} -> {cycles[-1]}, same bits "
                             f"{same}, strength_based_schwarz {agree}")
    print(f"phase 31 seconds {time.perf_counter() - t_phase:.1f}")
    return launches, worst


def lloyd_pairwise_phase(torch):
    """``smoothed_aggregation_solver`` with ``aggregate="lloyd"`` and with
    pairwise aggregation (two Drake matchings a level) on the 1024^2
    Poisson problem as plain CSR (float32 operators): setup stage by stage
    with Bellman-Ford, the recentering and the matchings apart, CG to
    1e-8, ``solve_mp`` to 1e-10.  Returns ``(launches, worst)``."""
    phase("32. Lloyd and pairwise aggregation, 1024^2 Poisson as plain CSR")
    import scipy.sparse as sp
    import pyamg_tpu_torch
    from pyamg_tpu_torch import graph
    from pyamg_tpu_torch.aggregation import aggregate, matching
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.sparse import dia_kernel, spgemm_kernel

    t_phase = time.perf_counter()
    A = sp.csr_matrix(poisson(GRID, format="csr").tocoo())
    b = A @ np.random.default_rng(0).random(A.shape[0])
    # the aggregation stage encloses the three below it: left out, its
    # remainder counts under "rest"
    stages = [st for st in _sa_stages() if st[0] != "aggregation"] + [
        ("Bellman-Ford", graph, "bellman_ford"),
        ("recentering", graph, "_recenter"),
        ("matchings", matching, "drake_matching"),
        ("pair labels", aggregate, "_pairs_to_labels")]
    spgemm_kernel.plain_cuda_calls = 0
    twin, launches, worst = [0], 0, 0.0
    for name, flag in AGGREGATIONS.items():
        print(f"-- aggregate={flag!r}")
        dia_kernel.launches = 0
        with counting_twin_calls(torch, twin):
            ml, _ = timed_setup(
                torch, lambda: pyamg_tpu_torch.smoothed_aggregation_solver(
                    A, aggregate=flag, max_coarse=500,
                    op_dtype=torch.float32, device="cuda"), stages)
            print_levels(ml)
            _, relres_cg, _ = timed_solve(torch, ml, A, b, maxiter=400)
            info, relres, _, _ = classical_solve(torch, ml, A, b)
        launches += dia_kernel.launches
        print(f"levels whose A is not DIA (no K1') {off_kernel_levels(ml)}")
        worst = max(worst, hold_dia_cases(
            torch, np.random.default_rng(32),
            record_hierarchy(f"{name} SA 1024^2", ml)))
        if not (relres_cg <= 5e-7 and relres <= 5e-10):
            raise AssertionError(f"{name}: CG relres {relres_cg} (<= 5e-7), "
                                 f"solve_mp {info} relres {relres} "
                                 f"(<= 5e-10)")
    _check_front_door(torch, "phase 32", launches, worst, twin)
    print(f"phase 32 seconds {time.perf_counter() - t_phase:.1f}")
    return launches, worst


def _profiled(torch, fn):
    """``fn()`` under ``torch.profiler``: ``(result, wall_s, device_ms,
    device_launches)``, the device time summed over the CUDA kernels and
    copies the profiler saw (0 when it saw none)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return (out, wall, sum(e.self_device_time_total for e in ops) / 1e3,
            sum(e.count for e in ops))


def _explicit_rap_error(ml):
    """The level-1 operator of a device-built hierarchy against the float64
    scipy product R A P of level 0's operators: max relative difference."""
    lvl = ml.levels[0]
    R, A, P = (op.to_scipy().astype(np.float64)
               for op in (lvl.R, lvl.A, lvl.P))
    want = (R @ (A @ P)).tocsr()
    got = ml.levels[1].A.to_scipy().astype(np.float64)
    return float(abs(got - want).max() / abs(want).max())


def device_structured_phase(torch):
    """``structured_sa_setup_sharded`` on the 1024^2 Poisson problem in
    float32 with ``max_coarse=500``, then ``shard_structured_solver`` and
    CG to 1e-6 (60 iterations at most), as ``benchmarks/suite.py:262-280``
    runs the sharded suite's headline, here on one card; ``solve_mp`` to
    1e-10.  The setup runs every numeric step on the card: 30 power steps
    and 9 comb probes of R A P a level (K1').  Its seconds plain, by stage,
    and under ``torch.profiler`` (the device-busy share); the level-1
    operator against the float64 scipy product R A P; the levels against
    the host structured path's.  Then ``structured_sa_setup`` on 64^3 (27
    probes a level) with CG to 1e-8, and a ``save_hierarchy`` /
    ``load_hierarchy`` round trip of the 1024^2 hierarchy.  Returns
    ``(launches, worst)``."""
    phase("33. device-built structured SA (comb-probe RAP), 1024^2 and 64^3")
    import tempfile

    from pyamg_tpu_torch.aggregation import device_setup as ds
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.parallel import (shard_structured_solver,
                                          structured_sa_setup_sharded)
    from pyamg_tpu_torch.sparse import SparseDIA, dia_kernel, spgemm_kernel
    from pyamg_tpu_torch.util import load_hierarchy, save_hierarchy

    t_phase = time.perf_counter()
    A = poisson(GRID, format="csr")
    b = A @ np.random.default_rng(0).random(A.shape[0])
    kw = dict(dtype=torch.float32, max_coarse=DEVICE_SA["max_coarse"],
              device="cuda")

    def build():
        return structured_sa_setup_sharded(A, GRID, **kw)

    stages = [("fine DIA from scipy (host, upload)", SparseDIA,
               "from_scipy"),
              ("power rho (K1')", ds, "device_power_rho"),
              ("S = I - c D^-1 A", ds, "device_smoothing_factor"),
              ("S^T", ds, "dia_transpose"),
              ("comb-probe RAP (K1')", ds, "device_rap"),
              ("color masks (host, upload)", ds, "_geometric_masks"),
              ("coarsest A to the host", SparseDIA, "to_scipy")]
    dia_kernel.launches = 0
    spgemm_kernel.plain_cuda_calls = 0
    twin = [0]
    with counting_twin_calls(torch, twin):
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n0 = dia_kernel.launches
            ml = build()
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
            setup_launches = dia_kernel.launches - n0
        print(f"setup_s {runs[0]:.3f} (first) {runs[1]:.3f} (second), "
              f"synchronized;  K1' launches of one setup {setup_launches}")
        timed_setup(torch, build, stages)
        _, wall, busy_ms, n_dev = _profiled(torch, build)
        print(f"profiled setup: wall {wall:.3f} s, device kernels and copies "
              f"{busy_ms:.2f} ms in {n_dev} launches: "
              f"{100 * busy_ms / (wall * 1e3):.2f}% busy (of the profiled "
              f"wall), {100 * busy_ms / (runs[1] * 1e3):.2f}% of the second "
              f"plain setup")
        print_levels(ml)
        rows = [lvl.A.shape[0] for lvl in ml.levels]
        sol = shard_structured_solver(ml)
        res, relres_cg, cg_s = timed_solve(torch, sol, A, b, tol=1e-6,
                                           maxiter=DEVICE_SA["maxiter"])
        info, relres, _, per_cycle = classical_solve(torch, ml, A, b)
        with tempfile.TemporaryDirectory() as tmp:
            path = pathlib.Path(tmp) / "device_sa_1024.npz"
            t0 = time.perf_counter()
            save_hierarchy(ml, path)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded = load_hierarchy(path, device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            size_mb = path.stat().st_size / 1e6
        print(f"checkpoint: saved in {save_s:.3f} s ({size_mb:.1f} MB), "
              f"loaded in {load_s:.3f} s;  the loaded hierarchy:")
        print_levels(loaded)
        res_l, relres_l, _ = timed_solve(torch, loaded, A, b, tol=1e-6,
                                         maxiter=DEVICE_SA["maxiter"])
        A3 = poisson(DEVICE_SA["grid3d"], format="csr")
        b3 = A3 @ np.random.default_rng(0).random(A3.shape[0])
        ml3, _ = timed_setup(torch, lambda: ds.structured_sa_setup(
            A3, DEVICE_SA["grid3d"], dtype=torch.float32, device="cuda"),
            stages)
        print_levels(ml3)
        _, relres3, _ = timed_solve(torch, ml3, A3, b3, tol=1e-8)
    launches = dia_kernel.launches
    rap_err = _explicit_rap_error(ml)
    print(f"level-1 operator from the comb probes vs the float64 scipy "
          f"product R A P of level 0's operators: max rel {rap_err:.3e}")
    worst = hold_dia_cases(
        torch, np.random.default_rng(33),
        record_hierarchy("device structured SA 1024^2", ml)
        + record_hierarchy("device structured SA 64^3", ml3))
    _check_front_door(torch, "phase 33", launches, worst, twin)
    iters, iters_l = len(res) - 1, len(res_l) - 1
    PHASE33.update(rows=rows, iters=iters, opc=ml.operator_complexity(),
                   diags=[lvl.A.diags.cpu().numpy() for lvl in ml.levels],
                   offsets=[lvl.A.offsets for lvl in ml.levels])
    if not (rows == DEFAULT_SA["structured"]["rows"] and rap_err <= 1e-5
            and iters <= DEVICE_SA["maxiter"] and relres_cg <= 1e-5
            and relres <= 5e-10 and abs(iters_l - iters) <= 1
            and relres_l <= 1e-5 and relres3 <= 5e-7
            and setup_launches > 0):
        raise AssertionError(
            f"rows {rows} (host structured path "
            f"{DEFAULT_SA['structured']['rows']}), R A P max rel {rap_err} "
            f"(<= 1e-5), CG {iters} iterations relres {relres_cg} (<= 1e-5),"
            f" solve_mp {info} relres {relres} (<= 5e-10), loaded CG "
            f"{iters_l} relres {relres_l}, 64^3 CG relres {relres3} "
            f"(<= 5e-7), setup launches {setup_launches}")
    print(f"phase 33 seconds {time.perf_counter() - t_phase:.1f}")
    return launches, worst


@contextlib.contextmanager
def recording_energy_products(store, name):
    """Keep the operands ``(label, A, B, pattern)`` of every masked
    product of a device SA setup -- the energy CG's A D
    (``parallel.energy``) and the Galerkin products (``parallel.setup``)
    -- labelled by setup, rows and kind, while passing each call on."""
    from pyamg_tpu_torch.parallel import energy, setup

    saved = [(mod, mod.masked_spgemm_auto) for mod in (energy, setup)]

    def recorder(real, kind):
        def record(A, B, pattern, **kw):
            store.append((f"{name} {A.shape[0]} rows {kind}", A, B,
                          pattern))
            return real(A, B, pattern, **kw)
        return record

    energy.masked_spgemm_auto = recorder(saved[0][1], "A*D")
    setup.masked_spgemm_auto = recorder(saved[1][1], "Galerkin")
    try:
        yield
    finally:
        for mod, real in saved:
            mod.masked_spgemm_auto = real


@contextlib.contextmanager
def keeping_candidates(store):
    """Keep in ``store["B"]`` the first candidates that the adaptive setup
    hands the general setup (``parallel.setup``), passing the call on."""
    from pyamg_tpu_torch.parallel import setup

    real = setup.general_sa_setup_sharded

    def keep(A, B=None, **kw):
        if B is not None and "B" not in store:
            store["B"] = np.array(B)
        return real(A, B=B, **kw)

    setup.general_sa_setup_sharded = keep
    try:
        yield
    finally:
        setup.general_sa_setup_sharded = real


def _device_sa_stages():
    """``stage_timer`` stages of the device SA setups: the host integer
    stages, the device CG and candidate relaxation, the products."""
    import pyamg_tpu_torch.aggregation.aggregate as aggregate
    import pyamg_tpu_torch.aggregation.smooth as smooth
    import pyamg_tpu_torch.aggregation.tentative as tentative
    import pyamg_tpu_torch.strength as strength
    import pyamg_tpu_torch.util.utils as utils
    from pyamg_tpu_torch.parallel import energy, setup

    return [("strength (host)", strength,
             "symmetric_strength_of_connection"),
            ("aggregation (host)", aggregate, "standard_aggregation"),
            ("fit_candidates (host)", tentative, "fit_candidates"),
            ("Cpt_params, scale_T (host)", utils, "get_Cpt_params"),
            ("Cpt_params, scale_T (host)", utils, "scale_T"),
            ("energy pattern, BtBinv (host)", smooth, "_grow_pattern"),
            ("energy pattern, BtBinv (host)", utils, "compute_BtBinv"),
            ("energy route (A's offsets read back)", energy, "spgemm_plan"),
            ("energy CG (device, K4'/K5')", energy, "_energy_cg"),
            ("candidate relaxation and rho (device)", setup,
             "_mesh_candidate_relax"),
            ("candidate relaxation and rho (device)", setup,
             "_ell_power_rho"),
            ("Jacobi S values (device)", setup, "_jacobi_smoothing_vals"),
            ("Galerkin products (device, K4'/K5')", setup,
             "masked_spgemm_auto"),
            ("R = P^T (device)", setup, "transpose_onto_mesh"),
            ("symbolic patterns (host)", setup, "_pattern_csr"),
            ("coarse values to the host", setup, "host_values"),
            ("ELL from scipy (host, upload)", setup, "upload_rows"),
            ("coloring (host)", setup, "_ell_smoother")]


def device_energy_phase(torch):
    """The device energy, root-node and adaptive SA setups on the 1024^2
    Poisson problem in float32: ``general_sa_setup_sharded(A,
    smooth=("energy", {"maxiter": 4}))``, ``rootnode_setup_sharded(A)`` and
    ``adaptive_sa_setup_sharded(A)``, each stage by stage (host integer
    stages against the device CG and products) and once more under
    ``torch.profiler`` (its device-busy share), CG to 1e-8 and
    ``solve_mp`` to 1e-10; every masked product of the three setups (the
    energy CG's A D included) recorded and held against the twin, and
    the energy CG's A D timed at levels 0 and 2.  Returns the SpGEMM
    kernels' launches, their largest difference from the twin and the
    dia_matvec launches (``solve_mp``'s float64 residuals)."""
    phase("34. device energy, root-node and adaptive SA setups, 1024^2")
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.parallel import (adaptive_sa_setup_sharded,
                                          general_sa_setup_sharded,
                                          rootnode_setup_sharded)
    from pyamg_tpu_torch.sparse import dia_kernel, spgemm_kernel

    t_phase = time.perf_counter()
    A = poisson(GRID, format="csr")
    b = A @ np.random.default_rng(0).random(A.shape[0])
    setups = {
        "energy SA (device)": lambda: general_sa_setup_sharded(
            A, smooth=("energy", {"maxiter": 4}), dtype=np.float32,
            device="cuda"),
        "root-node SA (device)": lambda: rootnode_setup_sharded(
            A, dtype=np.float32, device="cuda"),
        "adaptive SA (device)": lambda: adaptive_sa_setup_sharded(
            A, dtype=np.float32, device="cuda"),
    }
    launches = dict.fromkeys(spgemm_kernel.launches, 0)
    products, failures = [], []
    spgemm_kernel.plain_cuda_calls = 0
    dia_kernel.launches = 0
    twin = [0]
    for name, build in setups.items():
        print(f"-- {name}")
        before = dict(spgemm_kernel.launches)
        mine = []
        with counting_twin_calls(torch, twin):
            with recording_energy_products(mine, name), \
                    keeping_candidates(PHASE34):
                sol, _ = timed_setup(torch, build, _device_sa_stages())
            got = {k: spgemm_kernel.launches[k] - before[k]
                   for k in launches}
            cg = sum(1 for label, *_ in mine if label.endswith("A*D"))
            print(f"SpGEMM launches {got} ({cg} in the energy CG, "
                  f"{len(mine) - cg} Galerkin)")
            counts = dict(spgemm_kernel.launches)
            _, wall, busy_ms, n_dev = _profiled(torch, build)
            spgemm_kernel.launches.update(counts)
            print(f"profiled setup (again, not counted): wall {wall:.3f} s, "
                  f"device kernels and copies {busy_ms:.2f} ms in {n_dev} "
                  f"launches: {100 * busy_ms / (wall * 1e3):.2f}% busy")
            print_levels(sol.inner)
            res_cg, relres_cg, _ = timed_solve(
                torch, sol, A, b, **DEVICE_SA["cg"].get(name, {}))
            if name == "adaptive SA (device)":
                PHASE34["residuals"] = np.asarray(
                    res_cg[:ELL_RANKS["adaptive_iters"] + 1])
            info, relres, _, _ = classical_solve(
                torch, sol.inner, A, b, **DEVICE_SA["mp"].get(name, {}))
        for k in launches:
            launches[k] += got[k]
        products += mine
        record_hierarchy(name, sol.inner)
        if sum(got.values()) != len(mine):
            failures.append(f"{name}: recorded {len(mine)} products, the "
                            f"kernels launched {got}")
        bar = DEVICE_SA["cg_relres"].get(name, 5e-7)
        if not (relres_cg <= bar and relres <= 5e-10):
            failures.append(f"{name}: CG relres {relres_cg} (<= {bar}), "
                            f"solve_mp {info} relres {relres} (<= 5e-10)")
        del sol
    if not any(label.endswith("A*D") for label, *_ in products):
        failures.append("no energy-CG product ran")
    plain_calls = spgemm_kernel.plain_cuda_calls
    print(f"SpGEMM launches over the three setups {launches};  plain twin "
          f"calls on CUDA {plain_calls} (SpGEMM) {twin[0]} (DIA);  "
          f"dia_matvec launches {dia_kernel.launches}")
    print(f"holding both SpGEMM kernels against their twin on the three "
          f"setups' {len(products)} masked products:")
    worst = hold_spgemm(torch, products)
    n0, n2 = GRID[0] * GRID[1], sorted({A.shape[0] for _, A, _, _ in
                                        products})[-3]
    time_classical_products(
        torch, products,
        (("masked_spgemm_banded", f"energy SA (device) {n0} rows A*D"),
         ("masked_spgemm_gather", f"energy SA (device) {n2} rows A*D")))
    if plain_calls or twin[0]:
        failures.append("a plain twin ran on CUDA")
    if min(launches.values()) <= 0:
        failures.append(f"a SpGEMM kernel never launched: {launches}")
    if failures:
        raise AssertionError("; ".join(failures))
    print(f"phase 34 seconds {time.perf_counter() - t_phase:.1f}")
    return launches, worst, dia_kernel.launches


def _nii_stages():
    """``stage_timer`` stages of ``newideal_solver``."""
    from pyamg_tpu_torch.aggregation import rootnode_nii as nii

    return [("strength", nii, "_strength"),
            ("aggregation", nii, "_aggregate"),
            ("ben_ideal_interpolation", nii, "ben_ideal_interpolation"),
            ("R*A*P", nii, "_galerkin"),
            ("device operators", nii, "device_operator"),
            ("smoothers", nii, "change_smoothers")]


def _asa_stages():
    """``stage_timer`` stages of ``asa_solver``: the recursion's host
    stages, the device arrays of the accepted hierarchy, the smoothers."""
    from pyamg_tpu_torch.aggregation import new_adaptive as asa

    return [("targets", asa, "_relax_targets"),
            ("strength", asa, "_strength"),
            ("aggregation", asa, "_aggregate"),
            ("global Ritz", asa, "global_ritz_process"),
            ("local Ritz", asa, "local_ritz_process"),
            ("P smoothing", asa, "_smooth_P"),
            ("R*A*P", asa, "_galerkin"),
            ("convergence tests", asa, "_test_level_conv"),
            ("device arrays", asa, "_finalize_device_operators"),
            ("smoothers", asa, "change_smoothers")]


F64_LEVEL0 = (GRID[0] * GRID[1], GRID[0] * GRID[1], 5, "float64")


def time_level0_f64(torch, ml):
    """dia_matvec's float64 entry on a hierarchy's level-0 operator
    (1024^2 rows, 5 offsets): warm (L2-resident, back to back on one
    operand) beside the twin and cuSPARSE's float64 CSR SpMV, and cold
    (copies that overflow L2, in turn) beside cuSPARSE on the same copies;
    the bound of its bytes.  The launches made here are taken off the
    counts.  Returns the record."""
    from pyamg_tpu_torch.benchmarks.dia_spmv_bench import L2_BYTES, csr_tensor
    from pyamg_tpu_torch.sparse import SparseDIA, dia_kernel

    A0 = ml.levels[0].A
    op = SparseDIA(A0.diags.to(torch.float64), A0.offsets, A0.shape)
    x = torch.rand(op.shape[1], device="cuda", dtype=torch.float64)
    csr = csr_tensor(op.to_scipy(), "cuda", torch.float64)
    before = dia_kernel.launches, dict(dia_kernel.entry_launches)
    nbytes, flops = dia_work(op, x)
    b_ms, b_by = bound(nbytes, flops, F64_FLOP_PER_S)
    k_ms, p_ms, lib_ms = _medians(torch, lambda: op.matvec(x),
                                  lambda: op.matvec_plain(x),
                                  lambda: torch.mv(csr, x))
    copies = int(2 * L2_BYTES // nbytes) + 2
    ops = [(SparseDIA(op.diags.clone(), op.offsets, op.shape), x.clone(),
            csr_tensor(op.to_scipy(), "cuda", torch.float64))
           for _ in range(copies)]

    def cold():
        for o, xo, _ in ops:
            o.matvec(xo)

    def cold_library():
        for _, xo, c in ops:
            torch.mv(c, xo)

    cold_ms, cold_lib_ms = (t / copies for t in _medians(torch, cold,
                                                         cold_library))
    dia_kernel.launches = before[0]
    dia_kernel.entry_launches.update(before[1])
    rec = dict(shape=f"{op.shape[0]}x{op.shape[1]} k={op.n_offsets} float64",
               warm_ms=k_ms, cold_ms=cold_ms, plain_ms=p_ms,
               library_warm_ms=lib_ms, library_cold_ms=cold_lib_ms,
               bound_ms=b_ms, bound_by=b_by, mbytes=nbytes / 1e6)
    print(f"dia_matvec float64 level 0 {tuple(op.shape)}, {op.n_offsets} "
          f"offsets, {nbytes / 1e6:.1f} MB: warm {k_ms * 1e3:.2f} us, cold "
          f"({copies} copies in turn) {cold_ms * 1e3:.2f} us, bound "
          f"{b_ms * 1e3:.2f} us ({b_by}), cold/bound {cold_ms / b_ms:.2f};  "
          f"plain {p_ms * 1e3:.2f} us (warm);  cuSPARSE torch.mv(csr int32, "
          f"float64) warm {lib_ms * 1e3:.2f} us, cold "
          f"{cold_lib_ms * 1e3:.2f} us")
    print(json.dumps({"dia_matvec_float64_level0": rec}))
    return rec


def newideal_phase(torch):
    """``newideal_solver(A)`` with every argument at its default on the
    1024^2 Poisson problem as plain CSR (float64 operators, symmetric
    Gauss-Seidel): setup stage by stage, the levels and their device
    forms, CG to 1e-8 (best of 3), dia_matvec held against its twin on
    every DIA operator, the hierarchy held to its pin.  Returns
    ``(launches, worst, ml)``."""
    phase("35. newideal_solver, 1024^2 plain CSR, defaults")
    import scipy.sparse as sp
    from pyamg_tpu_torch.aggregation import newideal_solver
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.sparse import dia_kernel, spgemm_kernel

    t_phase = time.perf_counter()
    A = sp.csr_matrix(poisson(GRID, format="csr").tocoo())
    b = A @ np.random.default_rng(0).random(A.shape[0])
    spgemm_kernel.plain_cuda_calls = 0
    dia_kernel.launches = 0
    twin = [0]
    with counting_twin_calls(torch, twin):
        ml, _ = timed_setup(torch, lambda: newideal_solver(A, device="cuda"),
                            _nii_stages())
        print_levels(ml)
        res, relres, _ = timed_solve(torch, ml, A, b, tol=1e-8,
                                     maxiter=NEWIDEAL["maxiter"])
    launches = dia_kernel.launches
    worst = hold_dia_cases(torch, np.random.default_rng(35), record_hierarchy(
        "newideal_solver 1024^2", ml))
    _check_front_door(torch, "phase 35", launches, worst, twin)
    its = len(res) - 1
    if not (its < NEWIDEAL["maxiter"] and relres <= 5e-8):
        raise AssertionError(f"newideal_solver: CG {its} iterations (< "
                             f"{NEWIDEAL['maxiter']}), true relres {relres}"
                             f" (<= 5e-8)")
    print(f"phase 35 seconds {time.perf_counter() - t_phase:.1f}")
    return launches, worst, ml


def asa_phase(torch):
    """``asa_solver(A)`` with every argument at its default on the same
    matrix: setup stage by stage, the targets kept on each level, the
    levels, ``_asa_work``, CG to 1e-8 and ``solve_mp`` to 1e-10,
    dia_matvec held against its twin and the hierarchy pinned; then the
    profiling tools on the card (``profile_cycles``, ``trace`` around a CG
    solve, which must name dia_matvec's kernel, ``solve_timings``,
    ``profile_solver``, ``hierarchy_spectrum`` of the 256^2 hierarchy) and
    ``sparse.rap`` of level 0's host matrices on the card against scipy's
    R A P.  Returns ``(launches, worst, ml)``."""
    phase("36. asa_solver, 1024^2 plain CSR, defaults; profiling; sparse.rap")
    import tempfile

    import scipy.sparse as sp
    from pyamg_tpu_torch.aggregation import asa_solver
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.sparse import dia_kernel, rap, spgemm_kernel
    from pyamg_tpu_torch.util import profile_solver, profiling

    t_phase = time.perf_counter()
    A = sp.csr_matrix(poisson(GRID, format="csr").tocoo())
    b = A @ np.random.default_rng(0).random(A.shape[0])
    spgemm_kernel.plain_cuda_calls = 0
    dia_kernel.launches = 0
    twin = [0]
    failures = []
    with counting_twin_calls(torch, twin):
        ml, _ = timed_setup(torch, lambda: asa_solver(A, device="cuda"),
                            _asa_stages())
        targets = [lvl.B.shape[1] for lvl in ml.levels[:-1]]
        print(f"targets kept per level {targets};  _asa_work "
              f"{ml._asa_work:.3f}")
        print_levels(ml)
        res, relres_cg, _ = timed_solve(torch, ml, A, b, tol=1e-8)
        x, info = ml.solve_mp(b, tol=TOL, return_info=True)
        torch.cuda.synchronize()
        relres_mp = _true_relres(A, b, x)
        print(f"solve_mp(tol=1e-10): {info}  true f64 relres "
              f"{relres_mp:.3e}")
        cyc = profiling.profile_cycles(ml)
        print(f"profile_cycles: {cyc}")
        with tempfile.TemporaryDirectory() as logdir:
            with profiling.trace(logdir):
                ml.solve(b, tol=1e-8, accel="cg")
                torch.cuda.synchronize()
            events = json.loads(pathlib.Path(logdir, "trace.json")
                                .read_text())["traceEvents"]
        kernels = sorted({e["name"] for e in events
                          if "dia_matvec" in str(e.get("name", ""))
                          and e.get("cat") == "kernel"})
        print(f"trace: {len(events)} events; dia_matvec's kernels by name "
              f"{kernels}")
        if not kernels:
            failures.append("the torch.profiler trace names no dia_matvec "
                            "kernel")
        _, timing = profiling.solve_timings(ml, b)
        print(f"solve_timings: iterations {timing['iterations']}, "
              f"{timing['total_seconds']:.4f} s, "
              f"{timing['seconds_per_iteration'] * 1e3:.3f} ms an iteration")
        hist = profile_solver(ml, accel="cg", tol=1e-8)
        print(f"profile_solver(accel='cg'): {hist.size - 1} iterations, "
              f"final relative residual {hist[-1] / hist[0]:.3e}")
    launches = dia_kernel.launches
    worst = hold_dia_cases(torch, np.random.default_rng(36), record_hierarchy(
        "asa_solver 1024^2", ml))
    _check_front_door(torch, "phase 36", launches, worst, twin)
    its = len(res) - 1
    if not (abs(its - ASA_NEW["cg"]) <= ASA_NEW["cg_tol"]
            and relres_cg <= 5e-8 and relres_mp <= 5e-10):
        failures.append(f"asa_solver: CG {its} iterations (12 +- 3), true "
                        f"relres {relres_cg} (<= 5e-8); solve_mp {relres_mp} "
                        f"(<= 5e-10)")
    small = sp.csr_matrix(poisson((ASA_NEW["spectrum_grid"],) * 2,
                                  format="csr").tocoo())
    t0 = time.perf_counter()
    ml_small = asa_solver(small, device="cuda")
    spec = profiling.hierarchy_spectrum(ml_small)
    print(f"hierarchy_spectrum of the {ASA_NEW['spectrum_grid']}^2 "
          f"hierarchy ({time.perf_counter() - t0:.2f} s with its setup): "
          + "; ".join(f"n {s['n']} max {s['max']} min {s['min']}"
                      for s in spec))
    # ARPACK may stop unconverged on a large level (its start vector is
    # random): that level reads None in both packages; the dense levels
    # always have both values
    if not all(s["min"] is not None and s["max"] is not None
               for s in spec if s["n"] <= 200) \
            or len(spec) != len(ml_small.levels):
        failures.append("hierarchy_spectrum: a dense level has no values")
    lvl = ml.levels[0]
    t0 = time.perf_counter()
    Ac = rap(lvl.R_csr, lvl.A_csr, lvl.P_csr, device="cuda")
    torch.cuda.synchronize()
    t_rap = time.perf_counter() - t0
    want = (lvl.R_csr @ lvl.A_csr @ lvl.P_csr).tocsr()
    rel = float(abs(Ac.to_scipy() - want).max() / abs(want).max())
    print(f"sparse.rap(R, A, P) of level 0 on the card: ELL "
          f"{tuple(Ac.data.shape)} on {Ac.device}, {t_rap:.3f} s; max rel "
          f"difference from scipy's R A P {rel:.2e}")
    if not (Ac.device.type == "cuda" and rel <= 1e-12):
        failures.append(f"sparse.rap: rel {rel} (<= 1e-12) on {Ac.device}")
    if failures:
        raise AssertionError("; ".join(failures))
    print(f"phase 36 seconds {time.perf_counter() - t_phase:.1f}")
    return launches, worst, ml


def _rank_headline(torch, mesh, case):
    """One rank's part of the headline: ``structured_sa_setup_sharded`` on
    the 1024^2 (or 512^2) Poisson problem in float32 with
    ``max_coarse=500`` over the mesh, then CG to 1e-6 (60 iterations at
    most), as ``benchmarks/suite.py:262-288``."""
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.parallel import (shard_structured_solver,
                                          structured_sa_setup_sharded)
    from pyamg_tpu_torch.parallel import mesh as mesh_mod
    from pyamg_tpu_torch.sparse import dia_kernel
    from pyamg_tpu_torch.sparse.dia import ShardedDIA

    grid = RANKS["grid_512"] if case == "512" else GRID
    A = poisson(grid, format="csr")
    b = A @ np.random.default_rng(0).random(A.shape[0])

    def setup():
        return structured_sa_setup_sharded(
            A, grid, dtype=torch.float32, max_coarse=DEVICE_SA["max_coarse"])

    def solve(ml, res):
        return ml.solve(b, tol=1e-6, maxiter=DEVICE_SA["maxiter"],
                        accel="cg", residuals=res)

    torch.cuda.synchronize()
    mesh_mod.reset_counters()
    t0 = time.perf_counter()
    ml = setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_exchange = dict(mesh_mod.counters)
    res = []
    mesh_mod.reset_counters()
    n0 = dia_kernel.launches
    t0 = time.perf_counter()
    x = solve(ml, res)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    exchange = dict(mesh_mod.counters)
    solve_launches = dia_kernel.launches - n0
    split = None
    if case in ("headline", "nccl"):
        # the same setup and solve again, rank 0 under torch.profiler: its
        # device-busy ms beside the exchange's seconds; these launches are
        # left out of the counts
        kept = (dia_kernel.launches, dict(SHAPE_LAUNCHES))
        if mesh.rank == 0:
            ml2, setup_wall, setup_dev, _ = _profiled(torch, setup)
        else:
            ml2 = setup()
        mesh_mod.reset_counters()
        if mesh.rank == 0:
            _, solve_wall, solve_dev, _ = _profiled(
                torch, lambda: solve(ml2, []))
            split = dict(setup_wall=setup_wall, setup_device_ms=setup_dev,
                         solve_wall=solve_wall, solve_device_ms=solve_dev,
                         solve_exchange_s=mesh_mod.counters["seconds"])
        else:
            solve(ml2, [])
        del ml2
        dia_kernel.launches = kept[0]
        SHAPE_LAUNCHES.clear()
        SHAPE_LAUNCHES.update(kept[1])
    levels, slabs = [], []
    for lvl in ml.levels:
        lay, op = lvl.layout, lvl.A
        levels.append(dict(
            rows=op.shape[0], sharded=lay.sharded, k=op.n_offsets,
            halo=op.halo.exchange.n_recv if isinstance(op, ShardedDIA) else 0,
            gather=lay.n - lay.nl if lay.sharded else 0))
        for part in (op, *getattr(getattr(lvl, "P", None), "ops", ()),
                     *getattr(getattr(lvl, "R", None), "ops", ())):
            if isinstance(part, ShardedDIA):
                slabs.append(part)
    out = dict(rows=[lvl.A.shape[0] for lvl in ml.levels],
               opc=ml.operator_complexity(), iters=len(res) - 1,
               relres=_true_relres(A, b, x), setup_s=setup_s,
               solve_s=solve_s, exchange=exchange,
               setup_exchange=setup_exchange, split=split,
               solve_launches=solve_launches, levels=levels,
               solver_placement=shard_structured_solver(ml).placement())
    diags = [lvl.A.full_diags() if isinstance(lvl.A, ShardedDIA)
             else lvl.A.diags for lvl in ml.levels]
    if case == "headline" and mesh.rank == 0:
        out["diags"] = [d.cpu().numpy() for d in diags]
    return out, slabs


def _rank_shard_solver(torch, mesh):
    """One rank's part of ``shard_solver`` on the plain-CSR default call
    at 1024^2 (float32 operators, as phase 11): the unsharded CG to 1e-8,
    then the same solve sharded (padded-ELL levels from the host CSR
    matrices, float64)."""
    import scipy.sparse as sp
    import pyamg_tpu_torch
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.parallel import shard_solver
    from pyamg_tpu_torch.parallel import mesh as mesh_mod

    A = sp.csr_matrix(poisson(GRID, format="csr").tocoo())
    b = A @ np.random.default_rng(0).random(A.shape[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ml = pyamg_tpu_torch.smoothed_aggregation_solver(
        A, op_dtype=torch.float32, device=mesh.device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    res1 = []
    ml.solve(b, tol=1e-8, accel="cg", residuals=res1)
    t0 = time.perf_counter()
    sol = shard_solver(ml, mesh=mesh)
    shard_s = time.perf_counter() - t0
    res = []
    mesh_mod.reset_counters()
    t0 = time.perf_counter()
    x = sol.solve(b, tol=1e-8, accel="cg", residuals=res)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    levels = [dict(rows=lvl.A.shape[0], A=type(lvl.A).__name__,
                   P=type(getattr(lvl, "P", None)).__name__,
                   halo=getattr(lvl.A, "halo_width", lvl.A.shape[0]
                                - lvl.layout.nl),
                   gather=lvl.A.shape[0] - lvl.layout.nl)
              for lvl in sol.levels]
    out = dict(rows=[lvl.A.shape[0] for lvl in ml.levels],
               opc=ml.operator_complexity(), iters_one=len(res1) - 1,
               iters=len(res) - 1, relres=_true_relres(A, b, x),
               setup_s=setup_s, shard_s=shard_s, solve_s=solve_s,
               exchange=dict(mesh_mod.counters), levels=levels)
    return out, []


def ranks_cases(mesh, cases):
    """What every rank of phase 37 runs: each case in turn with the DIA
    kernel's launches (by shape) and its plain twin's calls on CUDA
    counted, then, outside the count, the kernel held bitwise against its
    twin on every DIA slab of this rank's hierarchy.  Returns ``{case:
    record}``."""
    import torch
    from pyamg_tpu_torch.sparse import dia_kernel

    records = {}
    for case in cases:
        dia_kernel.launches = 0
        SHAPE_LAUNCHES.clear()
        twin = [0]
        with counting_twin_calls(torch, twin):
            if case == "shard_solver":
                out, slabs = _rank_shard_solver(torch, mesh)
            else:
                out, slabs = _rank_headline(torch, mesh, case)
        out.update(rank=mesh.rank, size=mesh.size, backend=mesh.backend,
                   device=str(mesh.device), launches=dia_kernel.launches,
                   twin=twin[0],
                   shapes={key: (n, SHAPE_OFFSETS[key].tolist())
                           for key, n in SHAPE_LAUNCHES.items()})
        rng = np.random.default_rng(37 + mesh.rank)
        worst = 0.0
        for op in slabs:
            m = op.diags.shape[1]
            x = torch.as_tensor(rng.standard_normal(m), device=op.device,
                                dtype=op.dtype)
            worst = max(worst, float((op.matvec(x) - op.matvec_plain(x))
                                     .abs().max()))
        out["slab_err"], out["slabs"] = worst, len(slabs)
        records[case] = out
        del slabs
        torch.cuda.empty_cache()
    return records


def sharded_phase(torch):
    """The sharded suite's headline built and solved over ranks
    (``torch.distributed``, ``parallel.launch``): (i)
    ``structured_sa_setup_sharded`` on 1024^2 Poisson over 4 gloo ranks
    that share the card (every exchange staged through pinned host
    memory): phase 33's levels and operator complexity, each level's
    diagonals gathered against phase 33's one-card build (1e-5), the JAX
    package's placement (sharded while the rows divide the ranks), CG to
    1e-6 in phase 33's count +- 1; (ii) the same at 512^2 over 8 gloo
    ranks against the JAX package's 8-device record (7 +- 1, relres 1e-6);
    (iii) the 1024^2 headline on one NCCL rank: phase 33's CG count; (iv)
    ``shard_solver`` of the plain-CSR default call over 4 gloo ranks:
    level 0's A and P halo ELL, CG to 1e-8 in the unsharded count +- 1.
    Every rank counts its dia_matvec launches by shape (its slabs of
    (rows / ranks) x (rows / ranks + lo + hi), offsets shifted by lo) and
    its twin's calls on CUDA (none allowed), and holds the kernel
    bitwise against the twin on its slabs.  Each case prints each rank's
    host seconds inside collectives; the 1024^2 headline's cases (4 gloo
    ranks, one NCCL rank) also repeat the setup and solve with rank 0
    under ``torch.profiler``, for the split between exchange, device and
    host.  Returns ``(launches,
    worst)``."""
    phase("37. the structured setup and the solve over ranks "
          "(torch.distributed)")
    from pyamg_tpu_torch.parallel import launch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    groups = [(("headline", "shard_solver"), RANKS["ranks"], "gloo"),
              (("512",), RANKS["ranks_512"], "gloo"),
              (("nccl",), 1, "nccl")]
    titles = {"headline": "1024^2 headline over 4 gloo ranks sharing the "
                          "card",
              "shard_solver": "shard_solver of the plain-CSR default call "
                              "over the same 4 gloo ranks",
              "512": "512^2 headline over 8 gloo ranks sharing the card",
              "nccl": "1024^2 headline on one NCCL rank"}
    runs, failures = {}, []
    for group, nprocs, backend in groups:
        t0 = time.perf_counter()
        outs = launch(ranks_cases, nprocs, backend, "cuda:0",
                      args=(group,), timeout=RANKS["timeout"])
        print(f"{nprocs} {backend} ranks for {', '.join(group)}: launch wall "
              f"{time.perf_counter() - t0:.1f} s (process start and group "
              f"included)")
        for case in group:
            runs[case] = [records[case] for records in outs]
    for case, outs in runs.items():
        print(f"-- {titles[case]}")
        o = outs[0]
        its = max(o["iters"], 1)
        print(f"backend {o['backend']}, {o['size']} ranks on {o['device']}")
        for i, lvl in enumerate(o["levels"]):
            place = ("row-sharded" if lvl.get("sharded", True)
                     else "whole on every rank")
            forms = (f"A {lvl['A']}  P {lvl['P']}  " if "A" in lvl else
                     f"k={lvl['k']}  ")
            print(f"level {i}: rows {lvl['rows']:8d}  {forms}{place}  halo "
                  f"entries a matvec, largest over the ranks "
                  f"{max(r['levels'][i]['halo'] for r in outs)} (a full "
                  f"gather: {lvl['gather']})")
        if "solver_placement" in o:
            print(f"shard_structured_solver (min_shard_rows 4096) places "
                  f"{o['solver_placement']}")
        print(f"setup_s {o['setup_s']:.3f}  solve_s {o['solve_s']:.3f}  CG "
              f"iterations {o['iters']}"
              + (f" (unsharded {o['iters_one']})" if "iters_one" in o
                 else "")
              + f"  true f64 relres {o['relres']:.3e}  opc {o['opc']:.6f}")
        print(f"a CG iteration (rank 0): "
              f"{o['exchange']['collectives'] / its:.1f} collectives, "
              f"{o['exchange']['bytes'] / its:.0f} bytes received")
        secs = {stage: [round(r[key]["seconds"], 3) for r in outs]
                for stage, key in (("setup", "setup_exchange"),
                                   ("solve", "exchange")) if key in o}
        print(f"host seconds in collectives a rank: {secs}")
        split = o.get("split")
        if split:
            print(f"rank 0 again under torch.profiler: setup wall "
                  f"{split['setup_wall']:.3f} s, device-busy "
                  f"{split['setup_device_ms']:.1f} ms;  solve wall "
                  f"{split['solve_wall']:.3f} s, device-busy "
                  f"{split['solve_device_ms']:.1f} ms, in collectives "
                  f"{split['solve_exchange_s']:.3f} s")
        print(f"dia_matvec launches a rank {[r['launches'] for r in outs]};"
              f"  plain twin calls on CUDA a rank "
              f"{[r['twin'] for r in outs]};  kernel vs twin on "
              f"{[r['slabs'] for r in outs]} slabs a rank: max abs "
              f"{max(r['slab_err'] for r in outs):.1e}")
        for r in outs:
            if r["twin"] or r["slab_err"]:
                failures.append(f"{case} rank {r['rank']}: twin calls "
                                f"{r['twin']}, kernel vs twin "
                                f"{r['slab_err']}")
            if r["relres"] != o["relres"]:
                failures.append(f"{case}: ranks disagree on x")

    head, p33 = runs["headline"][0], PHASE33
    want_place = [True] * 4 + [False]
    errs = [float(np.abs(d - d33).max() / np.abs(d33).max())
            for d, d33 in zip(head["diags"], p33["diags"])]
    print(f"(i) levels {head['rows']} opc {head['opc']:.6f} (phase 33: "
          f"{p33['rows']}, {p33['opc']:.6f});  diagonals vs phase 33's, "
          f"max rel by level {[f'{e:.1e}' for e in errs]};  CG "
          f"{head['iters']} (phase 33: {p33['iters']})")
    if not (head["rows"] == p33["rows"]
            and f"{head['opc']:.6f}" == f"{p33['opc']:.6f}"
            and max(errs) <= 1e-5
            and [lvl["sharded"] for lvl in head["levels"]] == want_place
            and abs(head["iters"] - p33["iters"]) <= 1
            and head["relres"] <= 1e-5 and all(r["launches"] > 0
                                               for r in runs["headline"])):
        failures.append(f"(i) headline over 4 ranks: {head['rows']} "
                        f"{head['opc']} diags {errs} placement "
                        f"{[lvl['sharded'] for lvl in head['levels']]} CG "
                        f"{head['iters']} relres {head['relres']}")
    r512 = runs["512"][0]
    if not (abs(r512["iters"] - RANKS["cg_512"]) <= 1
            and r512["relres"] <= 1e-6):
        failures.append(f"(ii) 512^2 over 8 ranks: CG {r512['iters']} "
                        f"(7 +- 1) relres {r512['relres']} (<= 1e-6)")
    nccl = runs["nccl"][0]
    if not (nccl["iters"] == p33["iters"] and nccl["backend"] == "nccl"
            and nccl["relres"] <= 1e-5):
        failures.append(f"(iii) one NCCL rank: CG {nccl['iters']} (phase "
                        f"33: {p33['iters']}) relres {nccl['relres']}")
    sh = runs["shard_solver"][0]
    pins = HIERARCHY_PINS["default call, plain CSR"]
    if not ((len(sh["rows"]), f"{sh['opc']:.6f}") == (pins[0],
                                                       f"{pins[1]:.6f}")
            and sh["levels"][0]["A"] == sh["levels"][0]["P"] == "HaloELL"
            and abs(sh["iters"] - sh["iters_one"]) <= 1
            and sh["relres"] <= 5e-7):
        failures.append(f"(iv) shard_solver: levels {sh['rows']} opc "
                        f"{sh['opc']}, level 0 {sh['levels'][0]}, CG "
                        f"{sh['iters']} (unsharded {sh['iters_one']}) relres "
                        f"{sh['relres']}")

    launches = 0
    for outs in runs.values():
        for r in outs:
            launches += r["launches"]
            for key, (n, offsets) in r["shapes"].items():
                SHAPE_LAUNCHES[key] = SHAPE_LAUNCHES.get(key, 0) + n
                SHAPE_OFFSETS.setdefault(key, torch.tensor(offsets))
                if key[0] != key[1]:        # a slab: lo + nl + hi columns
                    RANK_SLABS.add(key)
    worst = max(r["slab_err"] for outs in runs.values() for r in outs)
    print(f"dia_matvec launches over the ranks of phase 37: {launches};  "
          f"phase 37 seconds {time.perf_counter() - t_phase:.1f}")
    if failures:
        raise AssertionError("phase 37: " + "; ".join(failures))
    return launches, worst


def _ell_rank_stages():
    """``stage_timer`` stages of the ELL-product setups over ranks: the
    host integer stages every rank runs on the whole level, the host
    tables of the exchanges, the products and transposes on the rank's
    slab (their exchanges inside), the read-backs.  A stage that a setup
    module imported by name is wrapped in each such module."""
    import pyamg_tpu_torch.aggregation.aggregate as aggregate
    import pyamg_tpu_torch.aggregation.smooth as smooth
    import pyamg_tpu_torch.aggregation.tentative as tentative
    import pyamg_tpu_torch.classical.split as split
    import pyamg_tpu_torch.parallel.classical_setup as cs
    import pyamg_tpu_torch.strength as strength
    import pyamg_tpu_torch.util.utils as utils
    from pyamg_tpu_torch.parallel import energy, products, setup

    stages = [("evolution strength (host, squarings on the ranks)",
               strength, "evolution_strength_of_connection"),
              ("symmetric strength (host)", strength,
               "symmetric_strength_of_connection"),
              ("RS splitting (host)", split, "RS"),
              ("aggregation (host)", aggregate, "standard_aggregation"),
              ("tentative fit, Cpt_params (host)", tentative,
               "fit_candidates"),
              ("tentative fit, Cpt_params (host)", utils, "get_Cpt_params"),
              ("energy pattern, BtBinv (host)", smooth, "_grow_pattern"),
              ("energy pattern, BtBinv (host)", utils, "compute_BtBinv"),
              ("slot maps (host)", cs, "_enc_csr"),
              ("energy CG (device, K4'/K5', D's rows fetched)", energy,
               "_energy_cg"),
              ("power rho, candidates (device, halo)", setup,
               "_ell_power_rho"),
              ("power rho, candidates (device, halo)", setup,
               "_mesh_candidate_relax"),
              ("halo tables of the solve's operators (host)", products,
               "place_rows"),
              ("coloring (host)", setup, "_ell_smoother")]
    for label, name in (
            ("symbolic patterns (host)", "_pattern_csr"),
            ("fetch tables (host)", "fetch_for"),
            ("row slabs from scipy (host, upload)", "upload_rows"),
            ("masked products (device, B's rows fetched)",
             "masked_spgemm_mesh"),
            ("R = P^T (device, P's rows fetched)", "transpose_onto_mesh"),
            ("read-backs to every rank (all-gather)", "host_values")):
        stages += [(label, mod, name) for mod in (setup, cs, energy, products)
                   if name in vars(mod)]
    return stages


@contextlib.contextmanager
def recording_rank_products(store):
    """Keep ``(kind, A, B, pattern)`` of every masked product a setup over
    ranks runs on this rank's slab -- the operands its kernel sees: A's
    slab on the fetched rows' coordinates, B's fetched rows -- while
    passing each call on."""
    import pyamg_tpu_torch.parallel.classical_setup as cs
    from pyamg_tpu_torch.parallel import energy, setup

    saved = [(mod, mod.masked_spgemm_auto) for mod in (setup, energy, cs)]

    def recorder(real, kind):
        def record(A, B, pattern, **kw):
            store.append((kind, A, B, pattern))
            return real(A, B, pattern, **kw)
        return record

    for (mod, real), kind in zip(saved, ("Galerkin", "A*D", "classical")):
        mod.masked_spgemm_auto = recorder(real, kind)
    try:
        yield
    finally:
        for mod, real in saved:
            mod.masked_spgemm_auto = real


def _ell_case(case):
    """``(build(mesh), A, b, solve keywords)`` of a phase-38 case."""
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.parallel import (adaptive_sa_setup_sharded,
                                          classical_setup_sharded,
                                          general_sa_setup_sharded,
                                          rootnode_setup_sharded)

    f32 = np.float32
    if case.startswith("aniso"):
        A = _aniso(SHARDED_GRID)
        return (lambda m: classical_setup_sharded(
            A, mesh=m, strength=ANISO["strength"], CF="RS",
            interpolation="standard", dtype=f32), A,
            A @ np.random.default_rng(0).random(A.shape[0]),
            dict(tol=1e-6, maxiter=60))
    import scipy.sparse as sp

    A = poisson(GRID, format="csr")
    b = A @ np.random.default_rng(0).random(A.shape[0])
    builds = {
        "general": lambda m: general_sa_setup_sharded(
            sp.csr_matrix(A.tocoo()), mesh=m, dtype=f32),
        "energy": lambda m: general_sa_setup_sharded(
            A, mesh=m, smooth=("energy", {"maxiter": 4}), dtype=f32),
        "rootnode": lambda m: rootnode_setup_sharded(A, mesh=m, dtype=f32),
        "adaptive": lambda m: adaptive_sa_setup_sharded(A, mesh=m,
                                                        dtype=f32),
    }
    solve = dict(tol=1e-8, maxiter=100) if case != "adaptive" else \
        dict(tol=1e-8, maxiter=ELL_RANKS["adaptive_iters"])
    return builds[case], A, b, solve


def _host_copy(E):
    """A SparseELL's slabs on the host (picklable)."""
    return (E.data.cpu(), E.cols.cpu(), E.row_nnz.cpu(), E.shape)


def _rank_ell_case(torch, mesh, case):
    """One rank's part of a phase-38 case: the setup over the ranks stage
    by stage with its exchanges counted, its levels and pattern hashes,
    the rows of each level's operators on this rank's device, its solve
    (aniso: a warm-up and best of 3), and each masked product's kernel
    held against the twin on the same operands (outside the counts)."""
    from profile_general import stage_timer
    from pyamg_tpu_torch.parallel import mesh as mesh_mod, products
    from pyamg_tpu_torch.sparse import spgemm_kernel
    from pyamg_tpu_torch.sparse.spgemm_device import (masked_spgemm_auto,
                                                      sentinel_cols)

    build, A, b, solve_kw = _ell_case(case)
    stages = _ell_rank_stages()
    secs = {label: 0.0 for label, _, _ in stages}
    calls = {label: 0 for label, _, _ in stages}
    store, cands = [], {}
    products.routes.clear()
    spgemm_kernel.plain_cuda_calls = 0
    before = dict(spgemm_kernel.launches)
    twin = [0]
    with counting_twin_calls(torch, twin):
        torch.cuda.synchronize()
        mesh_mod.reset_counters()
        t0 = time.perf_counter()
        with recording_rank_products(store), keeping_candidates(cands), \
                stage_timer(torch.device("cuda"), secs, calls, stages):
            sol = build(mesh)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        setup_exchange = dict(mesh_mod.counters)
        launches = {k: spgemm_kernel.launches[k] - before[k] for k in before}
        routes = list(products.routes)
        runs, res = [], []
        repeats = 3 if case.startswith("aniso") else 1
        if case.startswith("aniso"):
            sol.solve(b, accel="cg", **solve_kw)        # warm-up
        mesh_mod.reset_counters()
        for _ in range(repeats):
            res = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = sol.solve(b, accel="cg", residuals=res, **solve_kw)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        solve_exchange = dict(mesh_mod.counters)
    plain_calls = spgemm_kernel.plain_cuda_calls
    slabs = []
    for lvl in sol.levels:
        row = dict(nl=lvl.layout.nl, A=lvl.A.data.shape[0])
        for name in ("P", "R"):
            op = getattr(lvl, name, None)
            if op is not None:
                row[name] = op.data.shape[0]
        slabs.append(row)
    hashes = mesh.all_gather_object(_pattern_hashes(sol))
    worst, worst_rel = {}, 0.0
    for kind, Ap, Bp, pat in store:
        out = masked_spgemm_auto(Ap, Bp, pat).data
        ref = spgemm_kernel.masked_matmul_vals_plain(
            Ap.data, Ap.cols, Bp.data, Bp.cols, sentinel_cols(pat))
        err = float((out - ref).abs().max())
        scale = max(float(ref.abs().max()), 1e-300)
        worst[kind] = max(worst.get(kind, 0.0), err)
        worst_rel = max(worst_rel, err / scale)
    spgemm_kernel.plain_cuda_calls = 0
    for k, v in launches.items():
        spgemm_kernel.launches[k] = before[k] + v
    out = dict(case=case, rank=mesh.rank, size=mesh.size,
               backend=mesh.backend,
               levels=[(lvl.A_csr.shape[0], lvl.A_csr.nnz)
                       for lvl in sol.levels],
               opc=sol.inner.operator_complexity(), iters=len(res) - 1,
               residuals=np.asarray(res), relres=_true_relres(A, b, x),
               setup_s=setup_s, solve_s=min(runs), runs=runs,
               setup_exchange=setup_exchange, solve_exchange=solve_exchange,
               stages=secs, stage_calls=calls, launches=launches,
               plain_calls=plain_calls, twin=twin[0], slabs=slabs,
               hashes=hashes, routes=routes, held=len(store),
               hold_abs=worst, hold_rel=worst_rel)
    if mesh.rank == 0:
        if "B" in cands:
            out["candidate"] = cands["B"]
        # the largest slab products, for timing on the card alone
        gal = [(Ap, Bp, pat) for kind, Ap, Bp, pat in store
               if kind == "Galerkin"]
        cla = [(Ap, Bp, pat) for kind, Ap, Bp, pat in store
               if kind == "classical"]
        picks = {}
        if case == "general":
            picks = {"level-0 A*P": gal[1], "level-0 R*AP": gal[2]}
        elif case == "aniso":
            picks = {"level-0 evolution squaring": cla[0]}
        out["timing"] = {label: tuple(_host_copy(E) for E in ops)
                         for label, ops in picks.items()}
    del store, sol
    torch.cuda.empty_cache()
    return out


def _pattern_hashes(sol):
    """sha256 of each level's host matrix and splitting (equal on every
    rank when every rank's host stages agree)."""
    import hashlib

    out = []
    for lvl in sol.levels:
        h = hashlib.sha256()
        for a in (lvl.A_csr.indptr, lvl.A_csr.indices, lvl.A_csr.data,
                  getattr(lvl, "splitting", np.zeros(0)),
                  getattr(lvl, "Cpts", np.zeros(0))):
            h.update(np.ascontiguousarray(a).tobytes())
        out.append(h.hexdigest()[:16])
    return out


def ell_ranks_cases(mesh, cases):
    """What every rank of phase 38 runs: each case in turn."""
    import torch

    return {case: _rank_ell_case(torch, mesh, case) for case in cases}


def _slab_product(torch, label, ops):
    """``(label, A, B, pattern)`` on the card from host copies."""
    from pyamg_tpu_torch.sparse import SparseELL

    ells = [SparseELL(*(t.to("cuda") for t in E[:3]), E[3]) for E in ops]
    return (label, *ells)


def ell_sharded_phase(torch):
    """The ELL-product setups built over ranks (``torch.distributed``,
    ``parallel.launch``): (i) the sharded suite's anisotropic classical
    cell (``benchmarks/suite.py:289-311``: evolution strength, RS,
    standard interpolation, float32, CG to 1e-6 in 60) at 1024^2 over 4
    gloo ranks sharing the card, held to phase 23's one-card build
    (levels, nnz, opc to 6 places, CG +- 1, true relres <= 1e-5), and on
    one NCCL rank (phase 23's count exactly); (ii)
    ``general_sa_setup_sharded`` on the plain-CSR 1024^2 Poisson problem
    over the same 4 ranks, held to phase 5's hierarchy (CG to 1e-8 in 9 +-
    1, relres <= 5e-7); (iii) the energy, root-node and adaptive setups
    over the 4 ranks, held to ``HIERARCHY_PINS`` (CG to 1e-8, relres <=
    5e-7; the adaptive setup: its first 20 CG residuals against phase
    34's to 1e-3 and its candidate against phase 34's to 1e-6).  Every
    rank: the same pattern hashes, no level's A, P or R with more rows on
    its device than its slab, both SpGEMM kernels launched on slabs and
    held against the twin (1e-5 rel), no twin call on CUDA; its
    collectives, bytes and host seconds inside them, its host seconds by
    stage, each product's route.  Then K4' and K5' timed at the largest
    slab shapes.  Returns ``(launches, worst)``."""
    phase("38. the ELL-product setups over ranks (torch.distributed)")
    from pyamg_tpu_torch.parallel import launch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    groups = [(("aniso", "general", "energy", "rootnode", "adaptive"),
               ELL_RANKS["ranks"], "gloo"),
              (("aniso_nccl",), 1, "nccl")]
    runs = {}
    for group, nprocs, backend in groups:
        t0 = time.perf_counter()
        outs = launch(ell_ranks_cases, nprocs, backend, "cuda:0",
                      args=(group,), timeout=ELL_RANKS["timeout"])
        print(f"{nprocs} {backend} ranks for {', '.join(group)}: launch wall "
              f"{time.perf_counter() - t0:.1f} s (process start and group "
              f"included)")
        for case in group:
            runs[case] = [records[case] for records in outs]

    failures, launches, worst = [], {}, {}
    for case, outs in runs.items():
        o = outs[0]
        print(f"-- {case}: {o['size']} {o['backend']} ranks")
        for i, (rows, nnz) in enumerate(o["levels"]):
            held = [tuple(r["slabs"][i].get(k, 0) for k in "APR")
                    for r in outs]
            print(f"level {i}: rows {rows:8d} nnz {nnz:9d}  rows on each "
                  f"rank's device (A, P, R) {held} of slabs "
                  f"{o['slabs'][i]['nl']}")
        print(f"opc {o['opc']:.6f}  CG iterations {o['iters']}  true f64 "
              f"relres {o['relres']:.3e}  setup_s a rank "
              f"{[round(r['setup_s'], 3) for r in outs]}  solve_s "
              f"{o['solve_s']:.4f} (runs {[round(t, 3) for t in o['runs']]})")
        for stage in ("setup", "solve"):
            ex = [r[f"{stage}_exchange"] for r in outs]
            print(f"{stage}: collectives a rank "
                  f"{[e['collectives'] for e in ex]}, bytes received "
                  f"{[e['bytes'] for e in ex]}, host seconds in collectives "
                  f"{[round(e['seconds'], 3) for e in ex]}")
        print("host seconds by stage, rank 0: " + ", ".join(
            f"{label} {sec:.3f} ({o['stage_calls'][label]})"
            for label, sec in o["stages"].items() if o["stage_calls"][label])
            + f";  largest over the ranks: setup "
            f"{max(r['setup_s'] for r in outs):.3f}")
        kinds = {}
        for r in o["routes"]:
            key = (r["rows"], r["w_a"], r["b_rows"], r["b_total"],
                   r["fetch"], r["kernel"])
            kinds[key] = kinds.get(key, 0) + 1
        print(f"rank 0's {len(o['routes'])} products by route (rows, A's "
              f"width, B rows on the slab, of all, fetch, kernel): "
              + "; ".join(f"{k} x{n}" for k, n in kinds.items()))
        print(f"SpGEMM launches a rank {[r['launches'] for r in outs]};  "
              f"plain twin calls on CUDA (SpGEMM, DIA) "
              f"{[(r['plain_calls'], r['twin']) for r in outs]};  kernels vs "
              f"twin on {[r['held'] for r in outs]} products a rank: max rel "
              f"{max(r['hold_rel'] for r in outs):.1e}")
        for r in outs:
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
            for k, v in r["hold_abs"].items():
                worst[k] = max(worst.get(k, 0.0), v)
            if r["hashes"] != o["hashes"] or len(set(map(tuple,
                                                         r["hashes"]))) != 1:
                failures.append(f"{case}: pattern hashes differ over the "
                                f"ranks")
            if r["plain_calls"] or r["twin"] or r["hold_rel"] > 1e-5:
                failures.append(f"{case} rank {r['rank']}: twin calls "
                                f"{r['plain_calls']}/{r['twin']}, kernel vs "
                                f"twin {r['hold_rel']}")
            if any(s["A"] > s["nl"] or s.get("P", 0) > s["nl"]
                   or s.get("R", 0) > s["nl"] for s in r["slabs"]):
                failures.append(f"{case} rank {r['rank']}: an operator "
                                f"holds more rows than its slab")
            if r["relres"] != o["relres"]:
                failures.append(f"{case}: ranks disagree on x")

    p23, aniso = PHASE23, runs["aniso"][0]
    print(f"(i) levels {aniso['levels']} opc {aniso['opc']:.6f} CG "
          f"{aniso['iters']};  phase 23's one-card build {p23['levels']} "
          f"{p23['opc']:.6f} CG {p23['iters']};  one NCCL rank "
          f"{runs['aniso_nccl'][0]['levels']} CG "
          f"{runs['aniso_nccl'][0]['iters']}")
    nccl = runs["aniso_nccl"][0]
    if not (aniso["levels"] == p23["levels"]
            and f"{aniso['opc']:.6f}" == f"{p23['opc']:.6f}"
            and abs(aniso["iters"] - p23["iters"]) <= 1
            and aniso["relres"] <= 1e-5):
        failures.append(f"(i) aniso over 4 ranks: {aniso['levels']} "
                        f"{aniso['opc']} CG {aniso['iters']} relres "
                        f"{aniso['relres']}")
    if not (nccl["levels"] == p23["levels"] and nccl["iters"] == p23["iters"]
            and nccl["relres"] <= 1e-5):
        failures.append(f"(i) one NCCL rank: {nccl['levels']} CG "
                        f"{nccl['iters']} relres {nccl['relres']}")
    gen = runs["general"][0]
    opc_gen = sum(z for _, z in GENERAL_LEVELS) / GENERAL_LEVELS[0][1]
    if not (gen["levels"] == [tuple(x) for x in GENERAL_LEVELS]
            and f"{gen['opc']:.6f}" == f"{opc_gen:.6f}"
            and abs(gen["iters"] - 9) <= 1 and gen["relres"] <= 5e-7):
        failures.append(f"(ii) general: {gen['levels']} {gen['opc']} CG "
                        f"{gen['iters']} relres {gen['relres']}")
    for case, pin in (("energy", "energy SA (device)"),
                      ("rootnode", "root-node SA (device)"),
                      ("adaptive", "adaptive SA (device)")):
        r = runs[case][0]
        want = HIERARCHY_PINS[pin]
        if (len(r["levels"]), f"{r['opc']:.6f}") != (want[0],
                                                      f"{want[1]:.6f}"):
            failures.append(f"(iii) {case}: {len(r['levels'])} levels opc "
                            f"{r['opc']} (pin {want})")
        if case != "adaptive" and not r["relres"] <= 5e-7:
            failures.append(f"(iii) {case}: relres {r['relres']}")
    ad = runs["adaptive"][0]
    k = ELL_RANKS["adaptive_iters"] + 1
    ref_res, ref_b = PHASE34.get("residuals"), PHASE34.get("B")
    if ref_res is None or ref_b is None:
        failures.append("(iii) adaptive: phase 34's residuals or candidate "
                        "missing")
    else:
        res_rel = float(np.max(np.abs(ad["residuals"][:k] - ref_res[:k])
                               / ref_res[:k]))
        cand_rel = float(np.abs(ad["candidate"] - ref_b).max()
                         / np.abs(ref_b).max())
        print(f"(iii) adaptive over 4 ranks: first {k - 1} CG residuals "
              f"against phase 34's, max rel {res_rel:.2e};  candidate "
              f"against phase 34's, max rel {cand_rel:.2e}")
        if not (len(ad["residuals"]) == k
                and res_rel <= ELL_RANKS["res_rel"]
                and cand_rel <= ELL_RANKS["cand_rel"]):
            failures.append(f"(iii) adaptive: residuals {res_rel} "
                            f"candidate {cand_rel}")
    if min(launches.get(k, 0) for k in ("masked_spgemm_banded",
                                        "masked_spgemm_gather")) <= 0:
        failures.append(f"a SpGEMM kernel never launched on a slab: "
                        f"{launches}")

    timing = [_slab_product(torch, f"{case} {label}", ops)
              for case in ("general", "aniso")
              for label, ops in runs[case][0]["timing"].items()]
    print("K4' and K5' at the largest slab shapes (rank 0 of 4), on the card "
          "alone:")
    time_classical_products(
        torch, timing,
        (("masked_spgemm_banded", "general level-0 A*P"),
         ("masked_spgemm_gather", "general level-0 R*AP"),
         ("masked_spgemm_banded", "aniso level-0 evolution squaring")))
    print(f"SpGEMM launches over the ranks of phase 38: {launches};  phase "
          f"38 seconds {time.perf_counter() - t_phase:.1f}")
    if failures:
        raise AssertionError("phase 38: " + "; ".join(failures))
    return launches, worst


def dia_shapes(torch, launches):
    """dia_matvec at every DIA shape the smoke ran: the shapes (rows,
    cols, offsets, dtype) of every hierarchy's DIA operators and of every
    launch on the paths, each with its launches there.  At each shape, on
    random diagonals with the shape's offsets: both routes held against
    the twin (bitwise in the real dtypes), the tall route's, the wide
    route's, the twin's, cuSPARSE's SpMV (``torch.mv`` of the same
    operator as CSR with int32 indices) and the bound's times, the route
    the launcher takes and launches x (its time - bound).  ``launches``: the kernels line's counts
    by entry, which the per-shape launches must sum to.  Returns the
    widest launched float32 shape's record for the kernels line, with the
    records of phase 37's rank slabs."""
    phase("28. dia_matvec at every DIA shape of the paths")
    from pyamg_tpu_torch.benchmarks.dia_route_sweep import csr_of
    from pyamg_tpu_torch.sparse import SparseDIA, dia_kernel

    entry = {"float32": "dia_matvec", "float64": "dia_matvec",
             "bfloat16": "dia_matvec", "complex64": "dia_matvec_c64",
             "complex128": "dia_matvec_c128"}
    by_entry = dict.fromkeys(set(entry.values()), 0)
    for key, count in SHAPE_LAUNCHES.items():
        by_entry[entry[key[3]]] += count
    print(f"launches by shape sum to {by_entry}; the paths' counts "
          f"{ {name: launches[name] for name in by_entry} }")
    if any(by_entry[name] != launches[name] for name in by_entry):
        raise AssertionError("the launches by shape do not add up to the "
                             "paths' launch counts")
    keys = sorted(set(SHAPE_LAUNCHES) | set(SHAPE_SOURCES),
                  key=lambda key: (key[3], -key[2], -key[0], key[1]))
    rng = np.random.default_rng(28)
    before = dia_kernel.launches, dict(dia_kernel.entry_launches)
    records = []
    for key in keys:
        n, m, k, name = key
        if key in SHAPE_SOURCES:
            offsets, sources = SHAPE_SOURCES[key]
        else:
            offsets, sources = tuple(SHAPE_OFFSETS[key].tolist()), set()
        dtype = getattr(torch, name)
        x_dtype = torch.float32 if dtype == torch.bfloat16 else dtype

        def rand(*size):
            t = torch.as_tensor(rng.standard_normal(size), device="cuda")
            if dtype.is_complex:
                t = torch.complex(t, torch.as_tensor(
                    rng.standard_normal(size), device="cuda"))
            return t

        op = SparseDIA(rand(k, n).to(dtype), offsets, (n, m))
        x = rand(m).to(x_dtype)
        y_ref = op.matvec_plain(x)
        scale = max(float(y_ref.abs().max()), 1e-300)
        run = {r: functools.partial(dia_kernel._dia_matvec_route, op.diags,
                                    op.offsets_dev, x, m, r)
               for r in ("tall", "wide")}
        errs = {r: float((fn() - y_ref).abs().max()) for r, fn in run.items()}
        if any(err / scale > REL_TOL[name] or (err and not dtype.is_complex)
               for err in errs.values()):
            raise AssertionError(f"dia_matvec {key}: a route differs from "
                                 f"the twin: {errs}")
        fns = [run["tall"], run["wide"], lambda: op.matvec_plain(x)]
        if dtype != torch.bfloat16:
            csr = csr_of(op)
            try:
                torch.mv(csr, x)
                fns.append(lambda: torch.mv(csr, x))
            except RuntimeError as e:       # no such SpMV in the library
                print(f"torch.mv on a {name} CSR tensor: {e}")
        times = _medians(torch, *fns, samples=10)
        chosen = dia_kernel.route(n, k)
        nbytes, flops = dia_work(op, x)
        b_ms, b_by = bound(nbytes, flops, F64_FLOP_PER_S
                           if x_dtype in (torch.float64, torch.complex128)
                           else F32_FLOP_PER_S)
        rec = dict(shape=f"{n}x{m} k={k} {name}", n=n, m=m, k=k, dtype=name,
                   launches=SHAPE_LAUNCHES.get(key, 0), route=chosen,
                   tall_ms=times[0], wide_ms=times[1],
                   ms=times[chosen == "wide"], plain_ms=times[2],
                   library_ms=times[3] if len(times) == 4 else None,
                   bound_ms=b_ms, bound_by=b_by, max_abs_err=max(
                       errs.values()), sources=sorted(sources))
        rec["loss_ms"] = rec["launches"] * (rec["ms"] - b_ms)
        records.append(rec)
        lib = ("-" if rec["library_ms"] is None
               else f"{rec['library_ms'] * 1e3:.2f}")
        print(f"SHAPE {rec['shape']:28s} launches {rec['launches']:6d}  "
              f"route {chosen:4s}  tall {times[0] * 1e3:8.2f} us  wide "
              f"{times[1] * 1e3:8.2f} us  plain {times[2] * 1e3:9.2f} us  "
              f"cuSPARSE {lib:>8s} us  bound {b_ms * 1e3:7.2f} us  err "
              f"{rec['max_abs_err']:.1e}  "
              f"{', '.join(rec['sources']) or 'launched only'}")
        del op, x, y_ref
    dia_kernel.launches = before[0]
    dia_kernel.entry_launches.update(before[1])
    ranked = sorted(records, key=lambda r: -r["loss_ms"])
    print("launches x (time - bound) on the chosen route, largest first:")
    for r in ranked[:12]:
        print(f"  {r['shape']:28s} {r['launches']:6d} x ("
              f"{r['ms'] * 1e3:.2f} - {r['bound_ms'] * 1e3:.2f}) us = "
              f"{r['loss_ms']:.2f} ms")
    slower = [r["shape"] for r in records if r["library_ms"] is not None
              and r["ms"] > r["library_ms"]]
    other = [r["shape"] for r in records
             if min(r["tall_ms"], r["wide_ms"]) < 0.9 * r["ms"]]
    print(f"{len(records)} shapes; the chosen route slower than cuSPARSE at "
          f"{slower or 'none'}; more than 10% slower than the other route at "
          f"{other or 'none'}")
    def total(key):
        return sum(r["launches"] * r[key] for r in records
                   if r[key] is not None)

    print(f"over the {len(records)} shapes, launches x time: "
          f"{total('ms'):.1f} ms on the chosen routes, "
          f"{total('tall_ms'):.1f} ms all on the tall route, "
          f"{total('library_ms'):.1f} ms for cuSPARSE (where it runs), "
          f"{total('bound_ms'):.1f} ms at the bound")
    print(json.dumps({"dia_shapes": records}))
    widest = max((r for r in records
                  if r["launches"] and r["dtype"] == "float32"),
                 key=lambda r: (r["k"], r["launches"]))
    slabs = [{key: r[key] for key in ("shape", "launches", "route", "ms",
                                      "plain_ms", "bound_ms", "library_ms",
                                      "max_abs_err")}
             for r in records if (r["n"], r["m"], r["k"], r["dtype"])
             in RANK_SLABS]
    return dict(rank_slabs=slabs,
                widest_shape=widest["shape"], widest_route=widest["route"],
                widest_ms=widest["ms"], widest_tall_ms=widest["tall_ms"],
                widest_plain_ms=widest["plain_ms"],
                widest_bound_ms=widest["bound_ms"],
                widest_library_ms=widest["library_ms"],
                widest_launches=widest["launches"])


def main():
    import torch

    t_start = time.perf_counter()
    find_card(torch)
    build_kernels()
    rng = np.random.default_rng(0)
    worst = {"dia_matvec": check_kernel(torch, rng)}
    ml, dia_launches = main_path(torch)
    launches, products = general_path(torch)
    launches["dia_matvec"] = dia_launches
    worst.update(check_spgemm(torch, products))
    times = time_kernels(torch, ml, products)
    hpcg_launches, hpcg_worst = hpcg27_phase(torch)
    for name, count in hpcg_launches.items():
        launches[name] += count
        worst[name] = max(worst[name], hpcg_worst.get(name, 0.0))
    from pyamg_tpu_torch.benchmarks import dia_spmv_bench

    bench = dia_spmv_bench.problem(BENCH_GRIDS[0], "cuda")
    variant_worst = check_dia_variants(torch, rng, bench)
    worst["dia_matvec"] = max(worst["dia_matvec"],
                              variant_worst.pop("dia_matvec"))
    worst.update(variant_worst)
    bench_launches, bench_times = dia_bench(torch, bench)
    launches.update(bench_launches)
    times.update(bench_times)
    ml_default, n_structured, err_a = default_sa(torch, "structured")
    ml_plain, n_unstructured, err_b = default_sa(torch, "unstructured")
    worst["dia_matvec"] = max(worst["dia_matvec"], err_a, err_b)
    print(f"dia_matvec launches by path: structured Chebyshev path "
          f"{dia_launches}, default structured {n_structured}, default "
          f"unstructured {n_unstructured}")
    launches["dia_matvec"] += n_structured + n_unstructured
    cycles_and_coarse_solvers(torch, ml_default)
    preconditioner_in_scipy(torch)
    native_library()
    from pyamg_tpu_torch.sparse import dia_kernel

    dia_kernel.launches = 0
    twin = [0]
    with counting_twin_calls(torch, twin):
        krylov_accels(torch, ml_default)
        krylov_standalone(torch)
        solver_set(torch, ml_default, ml_plain)
    print(f"dia_matvec launches over the Krylov phases 15-17: "
          f"{dia_kernel.launches};  plain twin calls on CUDA {twin[0]}")
    if dia_kernel.launches <= 0 or twin[0]:
        raise AssertionError("the Krylov phases launched no dia_matvec, or "
                             "ran its twin on CUDA")
    launches["dia_matvec"] += dia_kernel.launches
    complex_launches, complex_worst = complex_path(torch)
    launches.update({name: complex_launches[name]
                     for name in ("dia_matvec_c64", "dia_matvec_c128")})
    worst.update(complex_worst)
    times.update(time_complex_kernel(torch))
    n_1m, err_1m = elasticity_1m(torch)
    n_rbm, err_rbm = elasticity_rbm(torch)
    launches["dia_matvec"] += n_1m + n_rbm
    worst["dia_matvec"] = max(worst["dia_matvec"], err_1m, err_rbm)
    print(f"dia_matvec launches by the elasticity phases 19-20: 1M "
          f"{n_1m}, 100^2 {n_rbm}")
    n_500, err_500 = classical_poisson(torch)
    ml_aniso, n_aniso, err_aniso = anisotropic_classical(torch)
    sharded_launches, sharded_worst = classical_sharded(
        torch, ml_aniso if SHARDED_GRID == ANISO["grid"] else None)
    launches["dia_matvec"] += n_500 + n_aniso
    worst["dia_matvec"] = max(worst["dia_matvec"], err_500, err_aniso)
    for name, count in sharded_launches.items():
        launches[name] += count
        worst[name] = max(worst[name], sharded_worst.get(name, 0.0))
    print(f"launches by the classical phases 21-23: dia_matvec "
          f"{n_500} + {n_aniso};  {sharded_launches}")
    del ml_aniso
    records, n_3d, err_3d = poisson3d(torch)
    asa, n_asa, err_asa = adaptive_aniso(torch)
    roots, n_root, err_root = rootnode_phase(torch)
    n_bb, err_bb = blackbox_phase(torch, records + asa + roots)
    launches["dia_matvec"] += n_3d + n_asa + n_root + n_bb
    worst["dia_matvec"] = max(worst["dia_matvec"], err_3d, err_asa,
                              err_root, err_bb)
    print(f"dia_matvec launches by the SA front-door phases 24-27: 3-D "
          f"{n_3d}, adaptive {n_asa}, root-node {n_root}, black box "
          f"{n_bb}")
    n_ns, err_ns = nonsymmetric_phase(torch)
    launches["dia_matvec"] += n_ns
    worst["dia_matvec"] = max(worst["dia_matvec"], err_ns)
    print(f"dia_matvec launches by the nonsymmetric phase 29: {n_ns}")
    menu = [adaptive_k2(torch), schwarz_phase(torch),
            lloyd_pairwise_phase(torch)]
    launches["dia_matvec"] += sum(n for n, _ in menu)
    worst["dia_matvec"] = max([worst["dia_matvec"]] + [e for _, e in menu])
    print(f"dia_matvec launches by phases 30-32 (two-candidate adaptive SA, "
          f"Schwarz, Lloyd and pairwise): {[n for n, _ in menu]}")
    n_dev, err_dev = device_structured_phase(torch)
    energy_launches, energy_worst, n_energy = device_energy_phase(torch)
    launches["dia_matvec"] += n_dev + n_energy
    worst["dia_matvec"] = max(worst["dia_matvec"], err_dev)
    for name, count in energy_launches.items():
        launches[name] += count
        worst[name] = max(worst[name], energy_worst.get(name, 0.0))
    print(f"launches by the device-setup phases 33-34: dia_matvec {n_dev} + "
          f"{n_energy};  {energy_launches}")
    f64_before = SHAPE_LAUNCHES.get(F64_LEVEL0, 0)
    n_nii, err_nii, ml_nii = newideal_phase(torch)
    n_asa_new, err_asa_new, _ = asa_phase(torch)
    launches["dia_matvec"] += n_nii + n_asa_new
    worst["dia_matvec"] = max(worst["dia_matvec"], err_nii, err_asa_new)
    print(f"dia_matvec launches by phases 35-36 (newideal_solver, "
          f"asa_solver): {n_nii} + {n_asa_new}, of them "
          f"{SHAPE_LAUNCHES.get(F64_LEVEL0, 0) - f64_before} on the float64 "
          f"level-0 shape {F64_LEVEL0}")
    time_level0_f64(torch, ml_nii)
    del ml_nii
    n_ranks, err_ranks = sharded_phase(torch)
    launches["dia_matvec"] += n_ranks
    worst["dia_matvec"] = max(worst["dia_matvec"], err_ranks)
    ell_launches, ell_worst = ell_sharded_phase(torch)
    for name, count in ell_launches.items():
        launches[name] += count
        worst[name] = max(worst[name], ell_worst.get(name, 0.0))
    times["dia_matvec"].update(dia_shapes(torch, launches))
    print(f"chip_smoke seconds: {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": [dict(
        name=name, **KERNELS[name], launches=launches[name],
        max_abs_err=worst[name], **times[name]) for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
