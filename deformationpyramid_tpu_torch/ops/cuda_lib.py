"""Build and bind the port's hand-written CUDA kernels.

Each source in ``deformationpyramid_tpu_torch/csrc/*.cu`` is compiled by
its own ``nvcc`` for ``sm_90a`` (Hopper), all of them at once, and the
objects are linked into one shared library with a plain C interface, at
first use, into ``<repo>/build/torch_kernels/``, and loaded with
``ctypes``. The library's name carries a hash of the sources, so an
edited kernel is rebuilt and a stale build is never loaded. Nothing here
runs when the module is imported: the CPU tests import every module on a
machine without ``nvcc``.

Every C entry point takes device pointers and the CUDA stream as
``void*``, launches on that stream, allocates nothing and returns
``cudaGetLastError()``; :meth:`Kernel.launch` raises if that is not 0 and
only then counts the launch.
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

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libdp_kernels_{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the kernels unless this source state is built already.

    Returns (library path, seconds spent compiling; 0 when it was built).
    The objects and the library are written in a temporary directory and
    the library renamed into place, so a concurrent process never loads a
    half-written file.
    """
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cu = [s for s in _sources() if s.suffix == ".cu"]
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    t0 = time.perf_counter()
    try:
        objs = [work / f"{src.stem}.o" for src in cu]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                                   str(src), "-o", str(obj)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(cu, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        failed = [f"{src.name} ({proc.returncode}):\n{log}"
                  for src, proc, log in zip(cu, procs, logs)
                  if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = work / "lib.so"
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                               *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out, time.perf_counter() - t0


def load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path, _ = build()
        _lib = ctypes.CDLL(str(path))
    return _lib


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


class Kernel:
    """One C entry point of the library, with its launch count.

    ``launches`` rises by one for every launch that the CUDA runtime
    accepted, and nowhere else; a run resets it to 0 to show which
    kernels its path went through.
    """

    def __init__(self, name: str, symbol: str, argtypes: list):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def _bind(self):
        if self._fn is None:
            fn = getattr(load(), self.symbol)
            # The stream comes last; without its argtype ctypes would pass
            # it as a 32-bit int and cut the pointer.
            fn.argtypes = [*self.argtypes, P]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        err = self._bind()(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with "
                               f"error {err}")
        self.launches += 1


def check_cuda(name: str, *tensors: torch.Tensor,
               dtype: torch.dtype | None = torch.float32) -> None:
    """What every wrapper checks before it hands pointers to a kernel."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors on {dev}, but the current CUDA "
                         f"device (where the kernel launches) is "
                         f"{torch.cuda.current_device()}")


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True where a wrapper takes its plain version: every tensor on the
    CPU. A CUDA tensor launches the kernel; any other device raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"tensors on devices {sorted(kinds)}: expected all on "
                     "the CPU or all on one CUDA device")
