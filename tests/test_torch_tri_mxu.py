"""Parity of the port's fused triangle sweep (ops/tri_mxu.py) with the JAX
package's ``ops/tri_mxu.py`` on the CPU.

The port's ``sweep_tri_mxu`` on CPU tensors runs its plain version; the
JAX function runs its Pallas kernel in interpret mode. Inputs are seeded
numpy arrays handed to both.

Tolerance: exact equality (integer statistics). The CUDA kernel itself
runs only on a GPU: tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniprot_kmer_based_clustering_tpu.ops import tri_mxu as jtri
from uniprot_kmer_based_clustering_tpu_torch.ops import bitmul as tbm
from uniprot_kmer_based_clustering_tpu_torch.ops import tri_mxu as ttri


def _case(seed, n_pad, w, n, n_classes, sparsify=0, weights=None):
    """Packed words (1/2 density, halved per ``sparsify``), classes with
    −1 past ``n``, and optional int8 weights drawn from ``weights``."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(n_pad, w), dtype=np.uint32)
    for _ in range(sparsify):
        words &= rng.integers(0, 2**32, size=(n_pad, w), dtype=np.uint32)
    words[n:] = 0
    classes = rng.integers(0, n_classes, size=n_pad).astype(np.int32)
    classes[n:] = -1
    wts = None
    if weights is not None:
        wts = rng.integers(*weights, size=w * 32).astype(np.int8)
    return words, classes, wts


def _t(words):
    return torch.from_numpy(words.view(np.int32))


# (case arguments, sweep arguments)
CASES = {
    # tests/test_stats_pallas.py small_case
    "small_case": (dict(seed=7, n_pad=1536, w=64, n=1500, n_classes=4),
                   dict(threshold=10)),
    # several word chunks and a padded W (80 → 96 words)
    "tile128_chunk32_w80": (
        dict(seed=1, n_pad=384, w=80, n=370, n_classes=3, sparsify=2),
        dict(threshold=10, tile=128, word_chunk_words=32)),
    "weighted_signed": (
        dict(seed=2, n_pad=384, w=80, n=370, n_classes=3, sparsify=2,
             weights=(-20, 41)),
        dict(threshold=100, tile=128, word_chunk_words=32, w_thresh=5)),
    "bf16": (
        dict(seed=3, n_pad=384, w=80, n=370, n_classes=3, sparsify=2),
        dict(threshold=10, tile=128, word_chunk_words=32,
             dot_dtype="bfloat16")),
    "bf16_weighted": (
        dict(seed=4, n_pad=384, w=80, n=370, n_classes=3, sparsify=2,
             weights=(-20, 41)),
        dict(threshold=100, tile=128, word_chunk_words=32, w_thresh=5,
             dot_dtype="bfloat16")),
    "threshold0": (
        dict(seed=5, n_pad=384, w=48, n=384, n_classes=3, sparsify=3),
        dict(threshold=0, tile=128, word_chunk_words=16)),
    "n_below_npad": (
        dict(seed=6, n_pad=512, w=32, n=200, n_classes=5, sparsify=2),
        dict(threshold=10, tile=128, word_chunk_words=32)),
    "single_class": (
        dict(seed=8, n_pad=256, w=40, n=250, n_classes=1, sparsify=2),
        dict(threshold=10, tile=128, word_chunk_words=8)),
    # the widest bf16 sum the guard admits: 8,064 words · 32 · 64 < 2^24
    "bf16_guard_edge": (
        dict(seed=9, n_pad=128, w=8064, n=120, n_classes=2, sparsify=1,
             weights=(60, 65)),
        dict(threshold=10_000, tile=128, word_chunk_words=2016,
             dot_dtype="bfloat16")),
}


@pytest.mark.parametrize("name", list(CASES))
def test_sweep_tri_mxu_matches_jax_interpret(name):
    case_kw, kw = CASES[name]
    words, classes, wts = _case(**case_kw)
    n = case_kw["n"]
    rs_j, th_j, (ti_j, tj_j, t_j) = jtri.sweep_tri_mxu(
        jnp.asarray(words), jnp.asarray(classes), n, weights=wts,
        interpret=True, **kw,
    )
    before = ttri.tri_mxu_sweep.launches
    rs_t, th_t, (ti_t, tj_t, t_t) = ttri.sweep_tri_mxu(
        _t(words), torch.from_numpy(classes), n, weights=wts, **kw,
    )
    assert ttri.tri_mxu_sweep.launches == before  # CPU: the plain version
    assert rs_t.dtype == np.int64 and th_t.dtype == np.int32
    assert th_t.shape == (len(ti_t), 2)
    assert rs_t[:, [1, 5]].sum() > 0
    assert np.array_equal(rs_j, rs_t)
    assert np.array_equal(th_j, th_t)
    assert np.array_equal(ti_j, ti_t) and np.array_equal(tj_j, tj_t)
    assert t_j == t_t


@pytest.mark.parametrize("w,maxw", [(4128, 127), (8192, 64)])
def test_bf16_guard_raises_in_both(w, maxw):
    """The worst-case float32 sum w_pad·32·max|w| ≥ 2^24 is refused with
    the same message (8,192 · 32 · 64 is exactly 2^24)."""
    words, classes, _ = _case(seed=0, n_pad=128, w=w, n=128, n_classes=2)
    wts = np.ones(w * 32, np.int8)
    wts[5] = -maxw
    kw = dict(weights=wts, dot_dtype="bfloat16", tile=128)
    with pytest.raises(ValueError) as jerr:
        jtri.sweep_tri_mxu(jnp.asarray(words), jnp.asarray(classes), 128,
                           10, interpret=True, **kw)
    with pytest.raises(ValueError) as terr:
        ttri.sweep_tri_mxu(_t(words), torch.from_numpy(classes), 128, 10,
                           **kw)
    assert str(terr.value) == str(jerr.value)
    assert "2^24" in str(terr.value)


def test_bf16_refuses_weights_beyond_int8():
    words, classes, _ = _case(seed=0, n_pad=128, w=4, n=128, n_classes=2)
    wts = np.full(4 * 32, 200, np.int16)
    with pytest.raises(ValueError, match="int8 weights"):
        ttri.sweep_tri_mxu(_t(words), classes, 128, 10, tile=128,
                           weights=wts, dot_dtype="bfloat16")
    with pytest.raises(ValueError, match="float16"):
        ttri.sweep_tri_mxu(_t(words), classes, 128, 10, tile=128,
                           dot_dtype="float16")


@pytest.mark.parametrize("wc", [2, 4])
def test_permute_weights_bitplane_matches_jax(wc):
    rng = np.random.default_rng(wc)
    wts = rng.integers(-128, 128, size=8 * 32).astype(np.int8)
    want = jtri.permute_weights_bitplane(wts, wc)
    got = ttri.permute_weights_bitplane(wts, wc)
    assert got.dtype == np.int8 and got.shape == (8 // wc * 32, wc)
    assert np.array_equal(want, got)


def _stage_image(x, s, dot_dtype, weights=None):
    """A numpy model of one stage of csrc/tri_mxu.cu's producer: the
    shared-memory image [rows, 128 bytes] of stage ``s`` of the packed
    rows ``x`` (uint32 [rows, W]). 16-byte chunk c of a row holds
    registers 4 (c % cpw) .. +3 of word s·kw + c // cpw (kw = 4 words a
    stage, cpw = 2 chunks a word as int8; 2 and 4 as bf16), register r
    being (x >> r) & 0x01010101 (four int8 0/1 bytes) or (x >> r) &
    0x00010001 times bf16 1.0 (two halves); weights, uint4 8s + c of the
    kernel-ordered array, mask the moving rows; the chunk lands at
    position c ^ (row % 8), the 128-byte swizzle."""
    kw, spread, one, fill = ((4, 0x01010101, 1, 0xFF) if dot_dtype == "int8"
                             else (2, 0x00010001, 0x3F80, 0xFFFF))
    cpw = 8 // kw
    rows = x.shape[0]
    img = np.zeros((rows, 8, 4), np.uint32)
    for c in range(8):
        word = x[:, s * kw + c // cpw]
        regs = np.stack([(word >> (4 * (c % cpw) + j)) & spread
                         for j in range(4)], axis=1).astype(np.uint32)
        if weights is None:
            regs = regs * np.uint32(one)
        else:
            wq = weights.view(np.uint32).reshape(-1, 4)[8 * s + c]
            regs = (regs * np.uint32(fill)) & wq
        for r in range(rows):
            img[r, c ^ (r % 8)] = regs[r]
    return img


def _read_stage(img, dot_dtype):
    """What a K-major operand with the 128-byte swizzle reads from the
    image: logical chunk c of row r sits at position c ^ (r % 8). Values
    as int64 columns [rows, 128 (int8) or 64 (bf16)]."""
    rows = img.shape[0]
    logical = np.stack([img[r, [c ^ (r % 8) for c in range(8)]]
                        for r in range(rows)]).reshape(rows, 32)
    if dot_dtype == "int8":
        return logical.astype("<u4").view(np.int8).astype(np.int64)
    halves = logical.astype("<u4").view("<u2")
    vals = (halves.astype(np.uint32) << 16).view(np.float32)
    return vals.astype(np.int64)


def _a_fragment_columns(x, s, dot_dtype):
    """A numpy model of csrc/tri_mxu.cu's a_frags for stage ``s``: the
    stationary operand's columns as wgmma reads them from the fragment
    registers. In a k-step (32 bytes: one word as int8, half a word as
    bf16, register base rb = 0 or 8), lane tq's registers a0/a2 hold
    columns 4tq..4tq+3 and 16+4tq.. (int8 bytes) or 2tq, 2tq+1 and
    8+2tq.. (bf16 halves) — the mma fragment layout — and are registers
    rb + tq and rb + tq + 4 of the k-step's word: (x >> r) & spread."""
    kw, per, spread = ((4, 4, 0x01010101) if dot_dtype == "int8"
                       else (2, 2, 0x00010001))
    regs_per_word, half_cols = 32 // per, 4 * per
    cols = []
    for k in range(4):
        word = x[:, s * kw + k * 8 // regs_per_word]
        rb = (k * 8) % regs_per_word
        for c in range(2 * half_cols):
            half, tq, j = c // half_cols, (c % half_cols) // per, c % per
            v = (word >> (rb + tq + 4 * half)) & spread
            cols.append((v >> (j * 32 // per)) & 1)
    return np.stack(cols, axis=1).astype(np.int64)


@pytest.mark.parametrize("dot_dtype", ["int8", "bfloat16"])
def test_kernel_weights_follow_the_kernel_unpack(dot_dtype):
    """The model of the kernel's stage unpack puts bit
    kernel_bit_order()[c] of each word in its column c, word after word;
    the stationary operand's register fragments hold the same columns;
    and the swizzled stages read back through the operand layout give,
    with kernel_weights() on the moving rows, the weighted dot products
    of the plain column order."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2**32, size=(12, 8), dtype=np.uint32)
    x[0, 0] = 0x80000001
    wts = rng.integers(-50, 51, size=8 * 32).astype(np.int8)
    kw_w = ttri.kernel_weights(wts, dot_dtype)
    if dot_dtype == "bfloat16":
        kw_w = kw_w.astype(np.float32).view(np.uint32) >> 16
        kw_w = kw_w.astype(np.uint16)
    kw = 4 if dot_dtype == "int8" else 2
    plain = np.unpackbits(x.view(np.uint8), axis=1,
                          bitorder="little").astype(np.int64)
    order = ttri.kernel_bit_order(dot_dtype)
    assert sorted(order) == list(range(32))
    a = np.concatenate([_read_stage(_stage_image(x, s, dot_dtype), dot_dtype)
                        for s in range(8 // kw)], axis=1)
    assert np.array_equal(a, plain.reshape(12, 8, 32)[:, :, order]
                          .reshape(12, 256))
    frags = np.concatenate([_a_fragment_columns(x, s, dot_dtype)
                            for s in range(8 // kw)], axis=1)
    assert np.array_equal(frags, a)
    b = np.concatenate([_read_stage(_stage_image(x, s, dot_dtype, kw_w),
                                    dot_dtype) for s in range(8 // kw)],
                       axis=1)
    want = plain @ (plain * wts.astype(np.int64)).T
    assert np.array_equal(a @ b.T, want)


@pytest.mark.parametrize("n_pad,n", [(384, 370), (640, 601), (1024, 1024),
                                     (1536, 129)])
def test_subtile_grid_covers_every_pair_once(n_pad, n):
    """The kernel's SUB_ROWS x SUB_COLS sub-tiles: every pair gi < gj < n
    lies in exactly one listed sub-tile, and every listed one holds such a
    pair."""
    sr, sc = ttri.SUB_ROWS, ttri.SUB_COLS
    grid = ttri.subtile_grid(n_pad, n)
    assert grid.dtype == np.int32 and grid.shape[1] == 2
    assert np.all(grid[:, 0] % sr == 0) and np.all(grid[:, 1] % sc == 0)
    cover = np.zeros((n_pad + sr, n_pad + sc), np.int64)
    for gi0, gj0 in grid:
        block = np.zeros_like(cover)
        block[gi0 : gi0 + sr, gj0 : gj0 + sc] = 1
        gi, gj = np.nonzero(block)
        assert np.any((gi < gj) & (gj < n))
        cover += block
    gi, gj = np.triu_indices(n, 1)
    assert np.all(cover[gi, gj] == 1)
    assert list(map(tuple, grid)) == sorted(map(tuple, grid))


@pytest.mark.parametrize("weighted", [False, True])
def test_tri_sweep_matches_port_sweep_mxu(weighted):
    """The triangle sweep gives what the port's strip sweep gives, on the
    same words (signed weights, w_thresh 3 when weighted)."""
    words, classes, wts = _case(seed=12, n_pad=512, w=24, n=500,
                                n_classes=3, sparsify=2,
                                weights=(-9, 30) if weighted else None)
    thr, wt = (60, 3) if weighted else (12, 1)
    want = tbm.sweep_mxu(_t(words), torch.from_numpy(classes), 500, thr,
                         block=128, weights=wts, w_thresh=wt)
    got = ttri.sweep_tri_mxu(_t(words), torch.from_numpy(classes), 500, thr,
                             tile=128, weights=wts, w_thresh=wt)
    assert np.array_equal(want[0], got[0])
    assert np.array_equal(want[1], got[1])
    assert np.array_equal(want[2][0], got[2][0])
    assert got[1].sum() > 0


def test_cpu_sweep_stays_on_the_cpu():
    """On CPU tensors the device-level sweep returns CPU int32 tensors of
    the JAX shapes, without a kernel launch."""
    words, classes, _ = _case(seed=14, n_pad=384, w=16, n=380, n_classes=3,
                              sparsify=1)
    before = ttri.tri_mxu_sweep.launches
    rs, th, (ti, tj, tile) = ttri.tri_mxu_sweep(
        _t(words), torch.from_numpy(classes), 380, 20, tile=128,
        word_chunk_words=8,
    )
    assert ttri.tri_mxu_sweep.launches == before
    assert rs.device.type == th.device.type == "cpu"
    assert rs.dtype == th.dtype == torch.int32
    assert rs.shape == (384, 8) and th.shape == (6, 2) and tile == 128
    assert list(zip(ti, tj)) == [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2),
                                 (2, 2)]


def test_tri_sweep_refuses_bad_inputs():
    words, classes, _ = _case(seed=0, n_pad=256, w=8, n=256, n_classes=2)
    with pytest.raises(ValueError, match="multiple of tile"):
        ttri.tri_mxu_sweep(_t(words), classes, 256, 10, tile=96)
    with pytest.raises(ValueError, match="weights for"):
        ttri.tri_mxu_sweep(_t(words), classes, 256, 10, tile=128,
                           weights=np.ones(9 * 32, np.int8),
                           word_chunk_words=8)
    meta = torch.empty((256, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ttri.tri_mxu_sweep(meta, classes, 256, 10, tile=128)
