"""Build the CUDA kernels of ``repro_torch/csrc`` at first use and load them.

Each ``.cu`` source becomes its own shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` (Hopper) and loaded with :mod:`ctypes`.
Libraries are named after a hash of their sources and flags, so an edited
source is rebuilt and a stale library is never loaded.  All missing sources
are compiled at once, one ``nvcc`` process each.  The build directory is
``src/repro_torch/build/`` (git-ignored).

Nothing here runs at import: the CPU tests import every module, and this
module is only reached when a CUDA tensor meets a kernel wrapper.
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

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("sampled_rows.cu", "sampled_cols.cu", "gram_dense.cu")
HEADERS = ("gram_common.cuh", "dense_tile.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (searched PATH, CUDA_HOME, CUDA_PATH and "
            f"{home}); the CUDA kernels cannot be built")
    return str(path)


def _library_path(source: str) -> Path:
    h = hashlib.sha256()
    for name in (source, *HEADERS):
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:12]}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{"seconds": wall time, "log": {source: nvcc output}}``; the log
    holds ptxas's register and spill report of each kernel that was built.
    Raises ``RuntimeError`` with the compiler output if any build fails.
    """
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for source in SOURCES:
        out = _library_path(source)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        procs[source] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    log, failed = {}, []
    for source, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        log[source] = text
        if proc.returncode != 0:
            failed.append(f"{source} (exit {proc.returncode}):\n{text}")
        else:
            os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "log": log}


@functools.cache
def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source`` (building all sources if needed)."""
    path = _library_path(source)
    if not path.exists():
        build_all()
    return ctypes.CDLL(str(path))


@functools.cache
def bind(source: str, symbol: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """One C entry point with its argument types declared (pointers and the
    stream as ``c_void_p``, sizes as ``c_int``/``c_int64``, scalars as
    ``c_double``); every entry returns a ``cudaError_t`` as ``int``."""
    fn = getattr(library(source), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


class KernelInfo:
    """What a hand-written kernel is, and how often the main path ran it.

    ``launches`` is a plain integer that the kernel's wrapper raises by one
    each time it launches the kernel, and nowhere else."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source          # CUDA source, relative to the repo
        self.replaces = replaces      # the TPU kernel, file:line
        self.launches = 0
