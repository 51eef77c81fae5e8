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


@pytest.mark.parametrize("dot_dtype", ["int8", "bfloat16"])
def test_kernel_weights_follow_the_kernel_unpack(dot_dtype):
    """A numpy model of csrc/tri_mxu.cu's in-word spread — register r of
    a word is (x >> r) & 0x01010101 (int8, four bytes) or
    (x >> r) & 0x00010001 (bf16, two halves) — puts bit
    kernel_bit_order()[c] in column c, and the permuted weights then give
    the same weighted dot product as the plain column order."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2**32, size=(6, 3), dtype=np.uint32)
    x[0, 0] = 0x80000001
    if dot_dtype == "int8":
        regs = np.stack([(x >> r) & 0x01010101 for r in range(8)], axis=-1)
        cols = regs.astype("<u4").view(np.uint8)
    else:
        regs = np.stack([(x >> r) & 0x00010001 for r in range(16)], axis=-1)
        cols = regs.astype("<u4").view("<u2")
    cols = cols.reshape(6, 3 * 32).astype(np.int64)
    plain = np.unpackbits(x.view(np.uint8), axis=1, bitorder="little")
    order = ttri.kernel_bit_order(dot_dtype)
    assert sorted(order) == list(range(32))
    assert np.array_equal(cols, plain.reshape(6, 3, 32)[:, :, order]
                          .reshape(6, 96))
    wts = rng.integers(-50, 51, size=3 * 32).astype(np.int8)
    kw = ttri.kernel_weights(wts, dot_dtype).astype(np.int64)
    want = plain.astype(np.int64) @ (plain.astype(np.int64) * wts).T
    assert np.array_equal(cols @ (cols * kw).T, want)


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
