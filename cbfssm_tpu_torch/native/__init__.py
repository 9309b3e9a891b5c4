"""ctypes bindings of the native host-pipeline library (port of
``cbfssm_tpu/native``).

``hostloader.cpp`` is compiled with ``g++ -O3 -march=native`` at first
use into ``build/cbfssm_tpu_torch/`` at the repository root (never into
the package), as a library named by this host's CPU tag and the digest
of the source and flags: a library built on another host (a copied
tree) is never loaded, and a changed source is rebuilt. Every entry
point has a numpy fallback with identical results, so the package works
without a toolchain; :func:`available` says which path runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "hostloader.cpp"
# the CUDA libraries' directory (ops/_build.py), without importing torch:
# the data layer that calls this module is numpy only
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cbfssm_tpu_torch"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None
_tried = False


def host_tag() -> str:
    """A short stable tag of this host's CPU (architecture and feature
    flags): the library is built with ``-march=native``, so one built
    on another host could die of an illegal instruction here."""
    feats = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feats = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    raw = f"{platform.machine()}|{feats}"
    return hashlib.sha256(raw.encode()).hexdigest()[:12]


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"hostloader_{host_tag()}_{digest}.so"


def _build(lib: Path) -> bool:
    """Compile the library into ``lib`` (a private file renamed into
    place, so a concurrent reader never sees half of one); False when
    there is no working ``g++``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        res = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                             capture_output=True, timeout=120)
        if res.returncode != 0:
            return False
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def load() -> ctypes.CDLL | None:
    """Compile (once) and load the library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        i64 = ctypes.c_int64
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.window_gather_f64.argtypes = [f64p, i64, i64, i64, i64p, i64, i64, f64p]
        lib.window_gather_f64.restype = None
        lib.unwrap_angles_f64.argtypes = [f64p, i64, i64, ctypes.c_double]
        lib.unwrap_angles_f64.restype = None
        lib.normalize_cast_f32.argtypes = [f64p, i64, i64, f64p, f64p, f32p]
        lib.normalize_cast_f32.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def window_gather(x: np.ndarray, starts: np.ndarray, win_len: int) -> np.ndarray:
    """[E, T, D] x [W'] -> [E*W', win_len, D]: the windows starting at
    ``starts`` of every experiment; native path with a numpy fallback
    (identical results)."""
    x = np.ascontiguousarray(x, dtype=np.float64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    e, t, d = x.shape
    # bounds-check here so both paths fail alike: the C gather validates
    # nothing (an out-of-range start would copy past the input buffer)
    if len(starts) and (starts.min() < 0 or int(starts.max()) + win_len > t):
        raise IndexError(
            f"window [{int(starts.min())}, {int(starts.max())}+{win_len}) "
            f"out of bounds for time axis of length {t}"
        )
    lib = load()
    if lib is None:
        idx = starts[:, None] + np.arange(win_len)[None, :]
        return x[:, idx, :].reshape(-1, win_len, d)
    out = np.empty((e * len(starts), win_len, d), dtype=np.float64)
    lib.window_gather_f64(x, e, t, d, starts, len(starts), win_len, out)
    return out


def unwrap_angles(vec: np.ndarray, threshold: float) -> np.ndarray | None:
    """The sequential euler jump filter of ``vec`` [T, channels] on a
    copy; None without the library (the caller runs its Python loop)."""
    vec = np.array(vec, dtype=np.float64, order="C", copy=True)
    lib = load()
    if lib is None:
        return None
    t, k = vec.shape
    lib.unwrap_angles_f64(vec, t, k, threshold)
    return vec


def normalize_cast(x: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """``(x - mean) / std`` cast to float32 in one pass (a serving-ingest
    utility: raw f64 telemetry to a normalized f32 request batch)."""
    x = np.ascontiguousarray(x, dtype=np.float64)
    mean = np.ascontiguousarray(np.broadcast_to(mean, (x.shape[-1],)), dtype=np.float64)
    std = np.ascontiguousarray(np.broadcast_to(std, (x.shape[-1],)), dtype=np.float64)
    lib = load()
    flat = x.reshape(-1, x.shape[-1])
    if lib is None:
        return ((flat - mean) / std).astype(np.float32).reshape(x.shape)
    out = np.empty(flat.shape, dtype=np.float32)
    lib.normalize_cast_f32(flat, flat.shape[0], flat.shape[1], mean, std, out)
    return out.reshape(x.shape)
