"""Native (C++) host-side collate ops of the port.

Counterpart of ``deformationpyramid_tpu/native``: the same two algorithms
(``native_ops.cpp``, a copy of the JAX package's ``cxx/native_ops.cpp``
behind a plain C interface) bound with ``ctypes``. The library is built
from the source in this directory at first use, with the host C++
compiler and the JAX package's flags (``-O3 -std=c++17``, no fast-math),
into ``<repo>/build/torch_native/``; the file's name carries a hash of the
source and the flags, and the library is written under a temporary name
and renamed into place, so that processes that build at once never load a
half-written file. Nothing is built when the module is imported.

Where the JAX package falls back to numpy when its library is missing, the
port raises: a failed build is an error, never a slower path taken in
silence. ``data/collate.py`` takes the numpy path only when its caller
selects it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lib: ctypes.CDLL | None = None


def _compiler() -> str | None:
    return shutil.which("c++") or shutil.which("g++")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libdp_native_{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library unless this source state is built already;
    raises if the compiler is missing or fails. Returns (library path,
    seconds spent compiling; 0 when it was built)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("native: no C++ compiler (c++ / g++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native: {cxx} failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, time.perf_counter() - t0


def load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        P, I64, D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
        lib.dp_grid_subsample.argtypes = [P, I64, D, P]
        lib.dp_grid_subsample.restype = I64
        lib.dp_radius_neighbors.argtypes = [P, I64, P, I64, D, I64, P]
        lib.dp_radius_neighbors.restype = ctypes.c_int
        _lib = lib
    return _lib


def has_native() -> bool:
    """True where the library is built or a C++ compiler can build it."""
    return library_path().exists() or _compiler() is not None


def _points(a: np.ndarray, name: str) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float32)
    if a.ndim != 2 or a.shape[1] != 3:
        raise ValueError(f"native: {name} must be [N, 3], got {a.shape}")
    return a


def grid_subsample(points: np.ndarray, dl: float) -> np.ndarray:
    """Voxel-grid barycentre subsampling -> [M, 3] float32, voxels in
    first-appearance order."""
    pts = _points(points, "points")
    out = np.empty_like(pts)
    m = load().dp_grid_subsample(pts.ctypes.data, len(pts), float(dl),
                                 out.ctypes.data)
    if m < 0:
        raise MemoryError("native: grid_subsample failed")
    return out[:m].copy()


def radius_neighbors(queries: np.ndarray, supports: np.ndarray,
                     radius: float, max_k: int) -> np.ndarray:
    """Distance-ordered fixed-radius neighbours [Q, max_k] int64, shadow
    index == len(supports)."""
    q = _points(queries, "queries")
    s = _points(supports, "supports")
    max_k = int(max_k)
    if max_k < 0:
        raise ValueError(f"native: max_k {max_k} < 0")
    out = np.empty((len(q), max_k), np.int64)
    err = load().dp_radius_neighbors(q.ctypes.data, len(q), s.ctypes.data,
                                     len(s), float(radius), max_k,
                                     out.ctypes.data)
    if err != 0:
        raise MemoryError("native: radius_neighbors failed")
    return out
