"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` source of the package is compiled by ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` process per source, all started
together, and the objects are linked into ONE shared library with a plain
C interface — no PyTorch headers, so a build takes seconds. The
library lands in the package's ``build/`` directory under a name that
carries a hash of the sources and of the headers they include
(``csrc/*.cuh``): an edited source or header builds anew, an unchanged
tree loads the existing file. Pointers and the stream cross the
boundary as ``c_void_p``; each entry point returns ``cudaGetLastError()``
and :func:`check` raises on a nonzero value.

Nothing here runs at import time: the CPU-only test environment imports
every module and has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# the two statistics epilogue entries: counts, ld, s, j, classes_row,
# classes_col, tile, i_off, j_off, n, threshold, w_thresh, row_stats,
# block_hits, hits_ld, stream
_STATS_INTO = [_P, _L, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _L, _P]
# C signature of every exported entry point (all return int: cudaError_t)
_SIGNATURES = {
    "ukc_stats_epilogue_into": _STATS_INTO,
    "ukc_stats_epilogue_traced_into": _STATS_INTO,
    "ukc_popcount_sweep": [_P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "ukc_tri_mxu_sweep": [
        _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P,
    ],
}


def _sources():
    """The translation units: ``csrc/*.cu``."""
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _hashed_files():
    """Everything a build reads: the sources and the ``csrc/*.cuh``
    headers they include."""
    return sorted(_sources() + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _nvcc() -> str:
    cands = [
        os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
        if os.environ.get("CUDA_HOME") else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of uniprot_kmer_based_clustering_tpu_torch are built "
        "from source at first use"
    )


def library_path() -> str:
    """Path of the shared library for the current sources and headers."""
    h = hashlib.sha256()
    for src in _hashed_files():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    flags = " ".join(NVCC_FLAGS).encode()
    h.update(flags)
    return os.path.join(BUILD_DIR, f"libukc_kernels_{h.hexdigest()[:16]}.so")


def _run(cmd, proc) -> str:
    out, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{out}{err}"
        )
    return out + err


def _build(so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in _sources():
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )))
    try:
        # ptxas -v register/shared-memory report, kept beside the library
        log = "".join(_run(cmd, proc) for cmd, _, proc in jobs)
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp,
                *(obj for _, obj, _ in jobs)]
        log += _run(link, subprocess.Popen(
            link, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    finally:
        for _, obj, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(obj):
                os.remove(obj)
    with open(so + ".log", "w") as f:
        f.write(log)
    os.replace(tmp, so)


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    so = library_path()
    if not os.path.exists(so):
        _build(so)
    lib = ctypes.CDLL(so)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
