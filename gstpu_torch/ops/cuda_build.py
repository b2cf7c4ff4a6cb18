"""Build and load the port's hand-written CUDA kernels.

Every source in ``csrc/`` that holds a kernel is compiled by its own
``nvcc`` for sm_90a into a shared library with a plain C interface, all
started together, into ``build/gstpu_torch/`` at first use (again whenever a
source, a header or the flags change), and loaded with ctypes.  The wrapper
modules set the argument types of their entry points:

- ``rasterize_fwd`` (K1) and ``rasterize_bwd`` (K2): ``ops/cuda_rasterize.py``;
- ``sol_compositing`` (K3): ``sol_model.py``;
- ``binning`` (the duplicate and finish kernels around CUB's radix sort):
  ``ops/cuda_binning.py``;
- ``preprocess`` (cull, projection, covariances, rect and SH colour of each
  Gaussian): ``ops/cuda_preprocess.py``.

Each library also exports ``gstpu_cuda_error_string``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = {"rasterize_fwd": CSRC / "rasterize_fwd.cu",
           "rasterize_bwd": CSRC / "rasterize_bwd.cu",
           "sol_compositing": CSRC / "sol_compositing.cu",
           "binning": CSRC / "binning.cu",
           "preprocess": CSRC / "preprocess.cu"}
HEADERS = (CSRC / "composite_common.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gstpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       + ", ".join(p.name for p in SOURCES.values()))


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(
        SOURCES[name].read_bytes()
        + b"".join(h.read_bytes() for h in HEADERS)
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{digest}.so"


def build() -> dict[str, tuple[Path, str, float]]:
    """Compile every kernel library whose current source has no build yet,
    one ``nvcc`` per source, all started together.

    Returns {name: (library path, compiler output, seconds from the start of
    the builds to the end of this one; 0.0 when an existing build was
    reused)}.  The compiler output (with ptxas's registers, shared memory
    and spills) is kept beside the library and returned for a reused build
    too.  A failed build raises.
    """
    out: dict[str, tuple[Path, str, float]] = {}
    running = []
    t0 = time.perf_counter()
    for name, src in SOURCES.items():
        lib = _library_path(name)
        if lib.exists():
            log = lib.with_suffix(".log")
            out[name] = (lib, log.read_text() if log.exists() else "", 0.0)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, lib, tmp, cmd, proc))
    failed = []
    for name, lib, tmp, cmd, proc in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
        out[name] = (lib, log, seconds)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built first if needed)."""
    path, _, _ = build()[name]
    lib = ctypes.CDLL(str(path))
    lib.gstpu_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gstpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def raise_on_error(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err != 0:
        msg = lib.gstpu_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def check_tensor(name: str, x: torch.Tensor, dtype, device, shape=None,
                 align: int = 1) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor on ``device`` of
    ``shape`` (any shape for None) whose data starts on an ``align``-byte
    boundary: what a kernel's wrapper checks before it passes a pointer."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")
