"""Build and load the package's CUDA sources at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, named by the hash of its
source, under ``build/cbfssm_tpu_torch/`` at the repository root, and
loaded with ``ctypes``. A changed source hashes to a new library and is
rebuilt; an unchanged one is loaded from the earlier build.

Nothing here runs at import: a machine without ``nvcc`` (the CPU test
runs) imports the package and never calls :func:`load`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cbfssm_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` as PyTorch resolves
    CUDA_HOME, else ``nvcc`` on PATH. Raises if there is none."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library for this exact source
    exists. Concurrent builds each write a private file and rename it
    into place, so a reader never sees a half-written library."""
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu``, built if needed (one build at
    a time in this process)."""
    with _lock:
        return ctypes.CDLL(str(build(name)))
