"""Build the port's CUDA and host sources into shared libraries.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers), so
one nvcc call builds it in seconds; ``csrc/<name>.cpp`` is host code for the
setup phase, built with g++ (:func:`build_host`).  A library lands in
``_build/`` beside this file, keyed by a hash of the source and the flags,
and is loaded with ``ctypes``.  Nothing is built at import time: the kernel
wrappers call :func:`load` at their first launch on a CUDA tensor, the host
bindings call :func:`build_host` at their first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "HOST_FLAGS", "find_nvcc", "host_compilers",
           "build", "build_host", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def find_nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``.  Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of pyamg_tpu_torch "
                       "are built from source at first use")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into ``_build/lib<name>-<hash>.so`` unless
    that file exists; returns its path.  nvcc's messages (register and
    shared-memory use from ``-Xptxas=-v``) go to ``<library>.log``."""
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    out.with_name(out.name + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)            # atomic: concurrent builds agree
    return out


def host_compilers():
    """Command prefixes that compile a C++ host source, in order of
    preference: g++ with OpenMP, g++ without, then nvcc as a host compiler
    (its ``-Xcompiler`` spelling of ``-fPIC``) when no g++ is on the path."""
    gxx = shutil.which("g++")
    if gxx:
        return [(gxx, "-fopenmp", *HOST_FLAGS), (gxx, *HOST_FLAGS)]
    try:
        nvcc = find_nvcc()
    except RuntimeError:
        raise RuntimeError("no host compiler found (g++, or nvcc)") from None
    return [(nvcc, "-x", "c++", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-std=c++17")]


def build_host(name: str) -> Path:
    """Compile ``csrc/<name>.cpp`` into ``_build/lib<name>-<hash>.so`` unless
    that file exists; returns its path.  Raises when no compiler is found
    or every attempt fails."""
    src = CSRC / f"{name}.cpp"
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(HOST_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    errors = []
    for prefix in host_compilers():
        proc = subprocess.run([*prefix, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode == 0:
            os.replace(tmp, out)        # atomic: concurrent builds agree
            return out
        tmp.unlink(missing_ok=True)
        errors.append(f"{' '.join(prefix)}: exit {proc.returncode}\n"
                      f"{proc.stderr}")
    raise RuntimeError(f"host build of {src.name} failed:\n"
                       + "\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as a ctypes library."""
    return ctypes.CDLL(str(build(name)))
