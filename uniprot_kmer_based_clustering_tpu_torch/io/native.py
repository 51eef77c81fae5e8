"""ctypes bindings for the native host runtime (native/ukc_native.cpp).

The port's own copy of the JAX package's ``io/native.py``. It binds the
same C++ source, which sits at the repository root, but builds it
itself: ``g++`` with the flags of ``native/Makefile`` compiles it at
first use into the port's ``build/`` directory, under a name that
carries a hash of the source and the flags. The compiler writes a file
private to its process and ``os.replace`` moves it into place, so
processes that load the library at once (``pytest -n``) never see a
half-written one, and an edited source builds anew. Every entry point
returns None when the library is unavailable, and its callers take
their numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "ukc_native.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False

_i64 = ctypes.c_int64
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")


def library_path() -> str:
    """Path of the shared library for the current source and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libukc_native_{h.hexdigest()[:16]}.so")


def _build(so: str) -> None:
    """Compile the source into ``so`` through a file of this process's
    own, moved into place only once it is complete."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    try:
        subprocess.run(
            ["g++", *CXX_FLAGS, "-shared", "-o", tmp, SOURCE, "-lpthread"],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            so = library_path()
            if not os.path.exists(so):
                _build(so)
            lib = ctypes.CDLL(so)
            _bind(lib)
        except (OSError, subprocess.SubprocessError, AttributeError):
            # no compiler, a failed build or a library that does not
            # match these bindings: the callers take their numpy paths
            _build_failed = True
            return None
        _lib = lib
        return _lib


# must equal ukc_abi_version() in ukc_native.cpp; bumped together on any
# exported-signature change
_ABI_VERSION = 3


def _bind(lib: ctypes.CDLL) -> None:
    lib.ukc_abi_version.restype = _i64
    lib.ukc_abi_version.argtypes = []
    got = int(lib.ukc_abi_version())
    if got != _ABI_VERSION:
        raise AttributeError(
            f"native ABI {got} != expected {_ABI_VERSION}"
        )
    lib.ukc_fasta_stats.restype = ctypes.c_int
    lib.ukc_fasta_stats.argtypes = [
        _u8p, _i64, ctypes.POINTER(_i64), ctypes.POINTER(_i64),
        ctypes.POINTER(_i64),
    ]
    lib.ukc_fasta_parse.restype = ctypes.c_int
    lib.ukc_fasta_parse.argtypes = [_u8p, _i64, _u8p, _i64p, _u8p, _i64p]
    lib.ukc_pack_bits.restype = None
    lib.ukc_pack_bits.argtypes = [_i32p, _i32p, _i64, _u32p, _i64]
    lib.ukc_encode.restype = ctypes.c_int
    lib.ukc_encode.argtypes = [_u8p, _i64p, _i64, _i64, _i64p, _i64p]
    lib.ukc_popcount_sweep.restype = _i64
    lib.ukc_popcount_sweep.argtypes = [
        _u64p, _i64, _i64, _i32p, ctypes.c_int32, _i64p, _i64p, _i64,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.ukc_sparse_sweep.restype = _i64
    lib.ukc_sparse_sweep.argtypes = [
        _i32p, _i32p, _i64, _i64, _i64, _i32p, ctypes.c_int32,
        ctypes.c_void_p,  # int8 weights or NULL
        _i64p, _i64p, _i64, ctypes.c_int, ctypes.c_int,
    ]
    lib.ukc_and_popcnt_rows.restype = None
    lib.ukc_and_popcnt_rows.argtypes = [_u64p, _i64, _i64, _u64p, _i64p]
    lib.ukc_index_build.restype = ctypes.c_int
    lib.ukc_index_build.argtypes = [
        _i64p, _i64p, _i64, _i64, _i64p, _i64p, _i32p, _i32p,
        ctypes.POINTER(_i64), ctypes.POINTER(_i64),
        ctypes.POINTER(_i64), ctypes.POINTER(_i64),
    ]


def available() -> bool:
    return _load() is not None


def parse_fasta(
    path: str, data: Optional[bytes] = None
) -> Optional[Tuple[List[str], np.ndarray, np.ndarray]]:
    """Native FASTA parse → (ids, seq_buf, offsets); None when
    unavailable. ``data`` supplies pre-read (e.g. gunzipped) bytes —
    ``path`` is then only used in error messages."""
    lib = _load()
    if lib is None:
        return None
    if data is None:
        with open(path, "rb") as f:
            data = f.read()
    data = np.frombuffer(data, dtype=np.uint8)
    n = _i64(0)
    idb = _i64(0)
    seqb = _i64(0)
    rc = lib.ukc_fasta_stats(
        data, data.shape[0], ctypes.byref(n), ctypes.byref(idb),
        ctypes.byref(seqb),
    )
    if rc != 0:
        raise ValueError(f"malformed FASTA: {path}")
    nn = n.value
    id_buf = np.empty(idb.value, np.uint8)
    id_off = np.zeros(nn + 1, np.int64)
    seq_buf = np.empty(seqb.value, np.uint8)
    seq_off = np.zeros(nn + 1, np.int64)
    rc = lib.ukc_fasta_parse(
        data, data.shape[0], id_buf, id_off, seq_buf, seq_off
    )
    if rc != 0:
        raise ValueError(f"malformed FASTA: {path}")
    ids = [
        id_buf[id_off[i] : id_off[i + 1]].tobytes().decode("ascii")
        for i in range(nn)
    ]
    return ids, seq_buf, seq_off


def pack_bits(
    incidence_protein: np.ndarray,
    incidence_rank: np.ndarray,
    n_pad: int,
    w_pad: int,
) -> Optional[np.ndarray]:
    """Native bitset packing; None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    words = np.zeros((n_pad, w_pad), np.uint32)
    lib.ukc_pack_bits(
        np.ascontiguousarray(incidence_protein, np.int32),
        np.ascontiguousarray(incidence_rank, np.int32),
        incidence_protein.shape[0],
        words.reshape(-1),
        w_pad,
    )
    return words


def index_build(codes: np.ndarray, offsets: np.ndarray, k: int):
    """Native k-mer doc-freq index (radix sorts + linear scans).

    Returns (distinct_codes, doc_freq, inc_protein, inc_rank, nnz) or
    None when the library is unavailable. Semantics bit-identical to
    kmers.index.build_index's numpy path (asserted in tests).
    """
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.int64)
    offsets = np.ascontiguousarray(offsets, np.int64)
    n = offsets.shape[0] - 1
    m_total = int(offsets[-1])
    distinct = np.empty(max(m_total, 1), np.int64)
    freq = np.empty(max(m_total, 1), np.int64)
    inc_p = np.empty(max(m_total, 1), np.int32)
    inc_r = np.empty(max(m_total, 1), np.int32)
    nd = _i64(0)
    nr = _i64(0)
    nnz = _i64(0)
    nnz_r = _i64(0)
    rc = lib.ukc_index_build(
        codes, offsets, n, 21**k, distinct, freq, inc_p, inc_r,
        ctypes.byref(nd), ctypes.byref(nr), ctypes.byref(nnz),
        ctypes.byref(nnz_r),
    )
    if rc != 0:
        return None
    return (
        distinct[: nd.value].copy(),
        freq[: nd.value].copy(),
        inc_p[: nnz_r.value].copy(),
        inc_r[: nnz_r.value].copy(),
        int(nnz.value),
    )


def encode_kmers(
    seq_buf: np.ndarray, offsets: np.ndarray, k: int
):
    """Native base-21 window encoding → (codes int64, kmer_offsets
    int64 [n+1]); semantics of kmers/encode.py::encode_kmers with
    sampling="all". Returns None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    seq = np.ascontiguousarray(seq_buf, np.uint8)
    off = np.ascontiguousarray(offsets, np.int64)
    n = off.shape[0] - 1
    if n < 0:
        # degenerate empty-offsets input: mirror the numpy path's
        # (empty codes, empty offsets) instead of handing C a
        # zero-size kmer_offsets buffer it would write [0] into
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    lengths = np.diff(off)
    total = int(np.maximum(lengths - k + 1, 0).sum())
    codes = np.empty(total, np.int64)
    koff = np.zeros(n + 1, np.int64)
    rc = lib.ukc_encode(seq, off, n, k, codes, koff)
    if rc != 0:
        raise RuntimeError(f"ukc_encode failed: {rc}")
    return codes, koff


def and_popcnt_rows_fn():
    """Bound fused AND+popcount row kernel, or None when unavailable.

    Returns a callable ``f(mat_u64_2d, m, vec_u64, out_i64)`` filling
    ``out[i] = popcount(mat[i] & vec)`` for the first ``m`` rows. The
    caller owns layout discipline (C-contiguous uint64 rows, matching
    widths): this is the tree model's per-insertion hot loop, called
    tens of thousands of times a build, so the wrapper resolves the
    symbol once and adds no per-call checks."""
    lib = _load()
    if lib is None:
        return None
    fn = lib.ukc_and_popcnt_rows

    def call(mat: np.ndarray, m: int, vec: np.ndarray, out: np.ndarray):
        fn(mat, m, mat.shape[1], vec, out)

    return call


def popcount_sweep(
    words: np.ndarray,
    n: int,
    classes: np.ndarray,
    threshold: int,
    pairs_cap: int = 1 << 20,
    include_same: bool = False,
    n_threads: Optional[int] = None,
):
    """Native CPU sweep → (row_stats int64 [n, 8], pairs int64 [m, 3]).

    Returns None when the library is unavailable. `words` is the packed
    uint32 matrix; only the first n rows are swept.
    """
    lib = _load()
    if lib is None:
        return None
    w64 = words.shape[1] // 2
    words64 = np.ascontiguousarray(words[:n]).view(np.uint64)
    row_stats = np.zeros((n, 8), np.int64)
    pairs = np.zeros((pairs_cap, 3), np.int64)
    n_threads = n_threads or (os.cpu_count() or 1)
    classes32 = np.ascontiguousarray(classes[:n], np.int32)
    total = lib.ukc_popcount_sweep(
        words64, n, w64, classes32,
        threshold, row_stats.reshape(-1), pairs.reshape(-1), pairs_cap,
        1 if include_same else 0, n_threads,
    )
    if total > pairs_cap:
        # the first pass told us the exact pair count; resweep into an
        # exact-size buffer (the sweep is cheap relative to a host
        # pipeline run, and stats would double-count if reused)
        pairs_cap = int(total)
        pairs = np.zeros((pairs_cap, 3), np.int64)
        row_stats[:] = 0
        total = lib.ukc_popcount_sweep(
            words64, n, w64, classes32,
            threshold, row_stats.reshape(-1), pairs.reshape(-1), pairs_cap,
            1 if include_same else 0, n_threads,
        )
    found = pairs[:total]
    order = np.lexsort((found[:, 1], found[:, 0]))
    return row_stats, found[order]


def sparse_sweep(
    inc_protein: np.ndarray,
    inc_rank: np.ndarray,
    n: int,
    n_ranks: int,
    classes: np.ndarray,
    threshold: int,
    pairs_cap: int = 1 << 20,
    include_same: bool = False,
    weights: Optional[np.ndarray] = None,
    n_threads: Optional[int] = None,
):
    """Native sparse (Gustavson) sweep over the incidence lists →
    (row_stats int64 [n, 8], pairs int64 [m, 3]).

    Output-identical to popcount_sweep / the device engines, but work
    scales with Σf(f−1)/2 (the reference's multigraph edge count)
    instead of n²·words — the fast path for sparse bitsets. Incidences
    must be sorted by (protein, rank), kmers/index.py's layout.
    `weights` (int8, ≥1 per rank — utils.blosum rank weights, sliced or
    padded to n_ranks) switches scores to weighted mode, matching the
    weighted MXU sweep. Returns None when the library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    nnz = int(inc_rank.shape[0])
    inc_p = np.ascontiguousarray(inc_protein, np.int32)
    inc_r = np.ascontiguousarray(inc_rank, np.int32)
    classes32 = np.ascontiguousarray(classes[:n], np.int32)
    if weights is not None:
        w8 = np.ascontiguousarray(weights[:n_ranks], np.int8)
        if w8.shape[0] != n_ranks:
            raise ValueError(
                f"weights cover {w8.shape[0]} ranks, need {n_ranks}"
            )
        if n_ranks and int(w8.min()) < 1:
            # a zero/negative weight would let a sharing pair score 0 and
            # vanish from the ≥1 'pairs' counter (and the suffix-scan
            # partner recovery); blosum rank weights are ≥ k, so this is
            # a misuse guard, not a real restriction
            raise ValueError("sparse_sweep weights must be ≥ 1")
        wptr = w8.ctypes.data_as(ctypes.c_void_p)
    else:
        w8, wptr = None, None
    row_stats = np.zeros((n, 8), np.int64)
    pairs = np.zeros((pairs_cap, 3), np.int64)
    n_threads = n_threads or (os.cpu_count() or 1)
    total = lib.ukc_sparse_sweep(
        inc_p, inc_r, nnz, n, n_ranks, classes32, threshold, wptr,
        row_stats.reshape(-1), pairs.reshape(-1), pairs_cap,
        1 if include_same else 0, n_threads,
    )
    if total > pairs_cap:
        pairs_cap = int(total)
        pairs = np.zeros((pairs_cap, 3), np.int64)
        row_stats[:] = 0
        total = lib.ukc_sparse_sweep(
            inc_p, inc_r, nnz, n, n_ranks, classes32, threshold, wptr,
            row_stats.reshape(-1), pairs.reshape(-1), pairs_cap,
            1 if include_same else 0, n_threads,
        )
    found = pairs[:total]
    order = np.lexsort((found[:, 1], found[:, 0]))
    return row_stats, found[order]
