"""Build the port's CUDA sources into shared libraries with nvcc.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers), so
one nvcc call builds it in seconds.  The library lands in ``_build/`` beside
this file, keyed by a hash of the source and the flags, and is loaded with
``ctypes``.  Nothing is built at import time: the kernel wrappers call
:func:`load` at their first launch on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "build", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


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


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as a ctypes library."""
    return ctypes.CDLL(str(build(name)))
