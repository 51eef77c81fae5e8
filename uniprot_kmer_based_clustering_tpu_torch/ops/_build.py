"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` source of the package is compiled by ``nvcc`` for
Hopper (``sm_90a``) into ONE shared library with a plain C interface —
no PyTorch headers, so a build takes seconds rather than minutes. The
library lands in the package's ``build/`` directory under a name that
carries a hash of the sources: an edited source builds anew, an
unchanged one loads the existing file. Pointers and the stream cross the
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every exported entry point (all return int: cudaError_t)
_SIGNATURES = {
    "ukc_stats_epilogue": [
        _P, ctypes.c_longlong, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
        _P, _P, _P,
    ],
}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


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
    """Path of the shared library for the current sources."""
    h = hashlib.sha256()
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    flags = " ".join(NVCC_FLAGS).encode()
    h.update(flags)
    return os.path.join(BUILD_DIR, f"libukc_kernels_{h.hexdigest()[:16]}.so")


def _build(so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    # ptxas -v register/shared-memory report, kept beside the library
    with open(so + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
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
