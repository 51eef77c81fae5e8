"""Fused triangle sweep: packed words → tensor cores → statistics (K3).

Counterpart of the JAX package's ``ops/tri_mxu.py``. It computes the same
statistics as :func:`ops.bitmul.sweep_mxu` — ``row_stats [N_pad, 8]`` in
the ``ops.popcount.ROW_STAT_NAMES`` lanes and ``tile_hits [nT, 2]`` — over
the upper triangle of (i_tile, j_tile) pairs only, reading the packed
words and never storing the unpacked operands or the counts.

- :func:`tri_mxu_sweep` is the sweep on a device: on a CUDA tensor it
  launches the hand-written kernel ``csrc/tri_mxu.cu`` (K3, the
  counterpart of the Pallas ``sweep_tri_mxu``: an unpack warpgroup
  overlapped with ``wgmma`` int8 or bf16 products, the statistics
  epilogue fused); on
  a CPU tensor it runs the plain MXU sweep, ``bitmul.sweep_mxu`` with
  the plain epilogue (unpack, int8 GEMM, statistics in torch).
- :func:`sweep_tri_mxu` keeps the JAX package's signature and returns
  numpy arrays.

Both dot types compute the same exact integers: int8 products
accumulate in int32 (wrapping like the TPU's), and bf16 is admitted only
where :func:`check_dot_dtype`'s guard keeps every float32 partial sum
an exact integer. So the int8 plain sweep is the plain version of both.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from uniprot_kmer_based_clustering_tpu_torch.ops import _build
from uniprot_kmer_based_clustering_tpu_torch.ops.bitmul import sweep_mxu
from uniprot_kmer_based_clustering_tpu_torch.ops.popcount import (
    to_host,
    upper_triangle_tiles,
)

# the CUDA kernel's granularity: the tile must be a multiple of SUB_TILE;
# a block owns SUB_ROWS stationary x SUB_COLS moving rows
SUB_TILE = 128
SUB_ROWS, SUB_COLS = 256, 128


def permute_weights_bitplane(weights: np.ndarray, wc: int) -> np.ndarray:
    """Per-k-mer int8 weights [W*32] → bit-plane layout [KC*32, wc], the
    JAX package's lane order for its Mosaic unpack.

    Kernel lane ``b*wc + w`` of chunk ``kc`` holds bit ``b`` of word
    ``kc*wc + w``, i.e. k-mer rank ``(kc*wc + w)*32 + b``. The CUDA kernel
    does not use this order (a dot product does not observe the order of
    its contraction axis); see :func:`kernel_weights` for the one it uses.
    """
    k = weights.shape[0]
    w_words = k // 32
    kc_total = w_words // wc
    # [KC, wc, 32] (word-major) → [KC, 32, wc] (bit-plane-major)
    w3 = weights.reshape(kc_total, wc, 32).transpose(0, 2, 1)
    return np.ascontiguousarray(w3.reshape(kc_total * 32, wc)).astype(np.int8)


def kernel_bit_order(dot_dtype: str) -> np.ndarray:
    """Bit of its word that each of the 32 unpacked columns of a word
    holds in the CUDA kernel: int8 register r holds bits r, r+8, r+16,
    r+24 (columns 4r..4r+3), bf16 register r bits r and r+16 (columns
    2r, 2r+1). A 16-byte chunk of an unpacked row holds four consecutive
    registers, so the words' columns follow each other in word order."""
    per_reg = 4 if dot_dtype == "int8" else 2
    c = np.arange(32)
    return c // per_reg + (32 // per_reg) * (c % per_reg)


def kernel_weights(weights: np.ndarray, dot_dtype: str) -> np.ndarray:
    """Column weights [W*32] permuted within each word into the CUDA
    kernel's column order (:func:`kernel_bit_order`)."""
    return np.ascontiguousarray(
        weights.reshape(-1, 32)[:, kernel_bit_order(dot_dtype)]
    ).reshape(-1)


def padded_weights(weights, n_cols: int) -> Optional[np.ndarray]:
    """int8 column weights zero-padded to ``n_cols``, as the JAX sweep
    pads them (columns past the given weights count 0); None stays None."""
    if weights is None:
        return None
    src = np.asarray(
        weights.cpu() if isinstance(weights, torch.Tensor) else weights
    )
    if src.shape[0] > n_cols:
        raise ValueError(
            f"{src.shape[0]} weights for {n_cols} bit columns"
        )
    wts = np.zeros(n_cols, dtype=np.int8)
    wts[: src.shape[0]] = np.asarray(src, np.int8)
    return wts


def check_dot_dtype(dot_dtype: str, weights, w_words: int) -> None:
    """Check ``dot_dtype`` as the JAX sweep does, for ``w_words`` packed
    words padded to the word chunk; raise ``ValueError`` if it is refused.

    ``bfloat16`` is exact only while the float32 running total stays an
    integer below 2²⁴: the worst case ``w_words·32·max|w|`` must be
    smaller, and weights beyond the int8 range are refused."""
    if dot_dtype == "int8":
        return
    if dot_dtype != "bfloat16":
        raise ValueError(dot_dtype)
    maxw = 1
    if weights is not None:
        src = weights.cpu() if isinstance(weights, torch.Tensor) else weights
        maxw = int(np.max(np.abs(np.asarray(src, dtype=np.int64))))
        if maxw > 127:
            raise ValueError(
                f"dot_dtype='bfloat16' takes int8 weights, got |w| = {maxw}"
            )
    worst = w_words * 32 * maxw
    if worst >= 1 << 24:
        raise ValueError(
            f"dot_dtype='bfloat16' cannot accumulate exactly here: "
            f"worst-case count {worst} ≥ 2^24 (float32 integer "
            f"range); use dot_dtype='int8'"
        )


def subtile_grid(n_pad: int, n: int) -> np.ndarray:
    """The (gi0, gj0) row offsets of the kernel's SUB_ROWS x SUB_COLS
    sub-tiles that hold a pair gi < gj < n, row-major, int32 [n_sub, 2].
    The last column block may reach past n_pad: the kernel reads zeros
    there."""
    i0 = np.arange(0, n_pad, SUB_ROWS)
    j0 = np.arange(0, n_pad, SUB_COLS)
    gi, gj = np.meshgrid(i0, j0, indexing="ij")
    keep = (gj < n) & (gi < np.minimum(gj + SUB_COLS - 1, n - 1))
    return np.stack([gi[keep], gj[keep]], axis=1).astype(np.int32)


def tri_mxu_sweep(words, classes, n: int, threshold: int, tile: int = 512,
                  word_chunk_words: int = 128, weights=None,
                  w_thresh: int = 1, dot_dtype: str = "int8"):
    """Fused sweep over every upper-triangle tile pair at protein tile
    ``tile``.

    ``words`` int32 [N_pad, W] (the packed uint32 bits) and ``classes``
    int32 [N_pad] on one device; ``weights`` optional int8 per-k-mer
    weights of the moving operand. As in the JAX sweep, W is padded with
    zero words to a multiple of ``word_chunk_words`` (which counts nothing)
    and the bf16 guard is taken at the padded width. Returns (row_stats
    int32 [N_pad, 8], tile_hits int32 [nT, 2], (ti, tj, tile)) on that
    device. CPU tensors take the plain MXU sweep, for either dot type;
    CUDA tensors launch the kernel once, counted in
    ``tri_mxu_sweep.launches``, and need a tile that is a multiple of 128.
    """
    dev = words.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    n_pad, w_words = words.shape
    if n_pad % tile:
        raise ValueError(
            f"n_pad={n_pad} must be a multiple of tile={tile} (pack with "
            "a matching row_multiple)"
        )
    ti, tj = upper_triangle_tiles(n_pad, tile)
    wc = word_chunk_words
    # zero words up to the word chunk, as the JAX sweep pads them, and on
    # the card on to whole 16-byte loads
    w_pad = w_words + (-w_words % wc)
    check_dot_dtype(dot_dtype, weights, w_pad)
    if dev.type == "cuda":
        if tile % SUB_TILE:
            raise ValueError(
                f"the CUDA triangle sweep takes tiles that are multiples of "
                f"{SUB_TILE}, got {tile}"
            )
        if words.dtype != torch.int32 or not words.is_contiguous():
            raise ValueError("words must be a contiguous int32 tensor")
        w_pad += -w_pad % 4
    if w_pad != w_words:
        words = torch.nn.functional.pad(words, (0, w_pad - w_words))
    wts = padded_weights(weights, w_pad * 32)
    if dev.type == "cpu":
        rs, th, tiles = sweep_mxu(words, classes, n, threshold, block=tile,
                                  weights=wts, w_thresh=w_thresh,
                                  stats_engine="xla")
        return (torch.from_numpy(rs.astype(np.int32)), torch.from_numpy(th),
                tiles)
    if words.data_ptr() % 16:
        raise ValueError("words must start on a 16-byte boundary")
    classes = torch.as_tensor(classes, dtype=torch.int32, device=dev)
    classes = classes.contiguous()
    if classes.shape != (n_pad,):
        raise ValueError("classes must be int32 [N_pad]")
    w_dev = None
    if wts is not None:
        w_dev = torch.from_numpy(kernel_weights(wts, dot_dtype)).to(dev)
        if dot_dtype == "bfloat16":
            w_dev = w_dev.to(torch.bfloat16)
    grid = torch.from_numpy(subtile_grid(n_pad, n)).to(dev)
    row_stats = torch.zeros((n_pad, 8), dtype=torch.int32, device=dev)
    tile_hits = torch.zeros((len(ti), 2), dtype=torch.int32, device=dev)
    lib = _build.load_kernels()
    with torch.cuda.device(dev):
        err = lib.ukc_tri_mxu_sweep(
            words.data_ptr(), w_pad, classes.data_ptr(), grid.data_ptr(),
            grid.shape[0], n_pad, tile, n, threshold, w_thresh,
            None if w_dev is None else w_dev.data_ptr(),
            int(dot_dtype == "bfloat16"), row_stats.data_ptr(),
            tile_hits.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "ukc_tri_mxu_sweep")
    tri_mxu_sweep.launches += 1
    return row_stats, tile_hits, (ti, tj, tile)


tri_mxu_sweep.launches = 0


def sweep_tri_mxu(words, classes, n: int, threshold: int, tile: int = 512,
                  word_chunk_words: int = 128, weights=None,
                  w_thresh: int = 1, dot_dtype: str = "int8"):
    """Upper-triangle fused sweep with the JAX ``sweep_tri_mxu`` contract.

    Args as :func:`tri_mxu_sweep` (``words`` int32 [N_pad, W] on the
    device the sweep runs on). The JAX ``interpret`` flag runs a Pallas
    kernel on the TPU interpreter and is not carried over: here the
    tensors' device decides — the CUDA kernel on a GPU, the plain version
    on the CPU.

    Returns (row_stats int64 [N_pad, 8], tile_hits int32 [nT, 2], tiles
    (ti, tj, tile)) as numpy arrays, after one device→host copy.
    """
    return to_host(*tri_mxu_sweep(
        words, classes, n, threshold, tile=tile,
        word_chunk_words=word_chunk_words, weights=weights,
        w_thresh=w_thresh, dot_dtype=dot_dtype,
    ))
