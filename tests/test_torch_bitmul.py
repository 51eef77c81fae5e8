"""Parity of the port's int8-GEMM sweep (ops/bitmul.py) with the JAX
package's ``ops/bitmul.py`` on the CPU.

Tolerance: exact equality (integer bits, counts and statistics).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniprot_kmer_based_clustering_tpu.ops import bitmul as jbm
from uniprot_kmer_based_clustering_tpu_torch.ops import bitmul as tbm


@pytest.fixture(scope="module")
def small_case():
    """n_pad 1536, W 64, seed 7 (tests/test_stats_pallas.py), with rows
    thinned to 1/8 density (~32 shared bits a pair)."""
    rng = np.random.default_rng(7)
    n_pad, w = 1536, 64
    n = 1500
    words = rng.integers(0, 2**32, size=(n_pad, w), dtype=np.uint32)
    words &= rng.integers(0, 2**32, size=(n_pad, w), dtype=np.uint32)
    words &= rng.integers(0, 2**32, size=(n_pad, w), dtype=np.uint32)
    words[n:] = 0
    classes = rng.integers(0, 4, size=n_pad).astype(np.int32)
    classes[n:] = -1
    wts = rng.integers(1, 50, size=w * 32).astype(np.int8)
    return words, classes, n, wts


def _t(words):
    return torch.from_numpy(words.view(np.int32))


@pytest.mark.parametrize("weighted", [False, True])
def test_unpack_words_matches_jax(weighted):
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2**32, size=(37, 5), dtype=np.uint32)
    words[0, 0] = 0x80000001  # sign bit of the int32 view
    wts = rng.integers(-127, 128, size=5 * 32).astype(np.int8)
    want = np.asarray(jbm.unpack_words_to_int8(
        jnp.asarray(words), jnp.asarray(wts) if weighted else None
    ))
    got = tbm.unpack_words_to_int8(
        _t(words), torch.from_numpy(wts) if weighted else None
    )
    assert got.dtype == torch.int8
    assert np.array_equal(want, got.numpy())


def test_unpack_word_window_matches_jax():
    """A column window of the words (the word-chunked contraction's
    operand) is not contiguous; it unpacks like the JAX slice."""
    rng = np.random.default_rng(2)
    words = rng.integers(0, 2**32, size=(50, 12), dtype=np.uint32)
    want = np.asarray(jbm.unpack_words_to_int8(jnp.asarray(words[:, 4:8])))
    window = _t(words)[:, 4:8]
    assert not window.is_contiguous()
    assert np.array_equal(want, tbm.unpack_words_to_int8(window).numpy())


@pytest.mark.parametrize("word_chunk", [0, 32])
@pytest.mark.parametrize("weighted", [False, True])
def test_counts_window_matches_jax(small_case, word_chunk, weighted):
    words, _, _, wts = small_case
    ones = np.ones(words.shape[1] * 32, np.int8)
    want = np.asarray(jbm._counts_window(
        jnp.asarray(words), jnp.asarray(wts if weighted else ones),
        512, 0, s=512, jr=1536, word_chunk=word_chunk,
    ))
    got = tbm.counts_window(
        _t(words), torch.from_numpy(wts) if weighted else None,
        512, 0, s=512, jr=1536, word_chunk=word_chunk,
    )
    assert got.dtype == torch.int32
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("strip", [512, 1536])
@pytest.mark.parametrize("weighted", [False, True])
def test_sweep_mxu_matches_jax(small_case, strip, weighted):
    words, classes, n, wts = small_case
    thr = 900 if weighted else 35  # near the mean: the gate splits pairs
    kw = dict(strip=strip, weights=wts if weighted else None)
    rs_j, th_j, (ti_j, tj_j, b_j) = jbm.sweep_mxu(
        jnp.asarray(words), jnp.asarray(classes), n, thr, **kw
    )
    rs_t, th_t, (ti_t, tj_t, b_t) = tbm.sweep_mxu(
        _t(words), torch.from_numpy(classes), n, thr, **kw
    )
    assert 0 < rs_t[:, 2].sum() < rs_t[:, 1].sum()
    assert rs_t.dtype == np.int64
    assert np.array_equal(rs_j, rs_t)
    assert np.array_equal(th_j, th_t)
    assert np.array_equal(ti_j, ti_t) and np.array_equal(tj_j, tj_t)
    assert b_j == b_t


def test_sweep_mxu_word_chunked_matches_unchunked(small_case):
    """Contraction chunking is exact; the automatic chunk follows the JAX
    package's HBM-budget rule (none on the 10,752-row main path)."""
    words, classes, n, wts = small_case
    args = (_t(words), torch.from_numpy(classes), n, 100)
    kw = dict(strip=512, weights=torch.from_numpy(wts))
    ref = tbm.sweep_mxu(*args, word_chunk=0, **kw)
    got = tbm.sweep_mxu(*args, word_chunk=32, **kw)
    assert np.array_equal(ref[0], got[0])
    assert np.array_equal(ref[1], got[1])
    assert tbm.auto_word_chunk(10752, 7680, 1536, 13 << 30) == 0
    assert tbm.auto_word_chunk(10752, 7680, 1536, 2 << 30) == 3840
    assert tbm.auto_word_chunk(100352, 7680, 3584, 13 << 30) == 2560


def test_auto_strip_and_schedule_match_jax():
    for n_pad in list(range(512, 40961, 512)) + [100352, 250368]:
        for block in (128, 512):
            if n_pad % block:
                continue
            assert tbm.auto_strip(n_pad, block) == jbm.auto_strip(
                n_pad, block
            ), (n_pad, block)
            for strip in (None, block):
                assert tbm.resolve_schedule(
                    n_pad, block, strip
                ) == jbm.resolve_schedule(n_pad, block, strip)
    # the main path's corpus: 7 strips of 1536 rows
    assert tbm.resolve_schedule(10752, 512) == ("strips", 1536, 7)


def test_sweep_mxu_refuses_unported_modes(small_case):
    """What sweep_mxu still refuses: unknown schedules and epilogues, and
    fused extraction with an explicit K2 epilogue (the JAX contract)."""
    words, classes, n, _ = small_case
    args = (_t(words), torch.from_numpy(classes), n, 10)
    with pytest.raises(ValueError, match="schedule"):
        tbm.sweep_mxu(*args, strip=512, schedule="ring")
    with pytest.raises(ValueError, match="stats_engine"):
        tbm.sweep_mxu(*args, strip=512, stats_engine="mosaic")
    with pytest.raises(ValueError, match="pallas"):
        tbm.sweep_mxu(*args, strip=512, schedule="scan", fused_k=512,
                      stats_engine="pallas")


@pytest.mark.parametrize("word_chunk", [0, 32])
@pytest.mark.parametrize("weighted", [False, True])
def test_scan_sweep_matches_jax(small_case, word_chunk, weighted):
    """The block-pair scan (3 strips of 512 → 6 steps, K2's plain version
    on the CPU) against the JAX scan with its default epilogue."""
    words, classes, n, wts = small_case
    thr = 900 if weighted else 35
    kw = dict(strip=512, schedule="scan", word_chunk=word_chunk,
              weights=wts if weighted else None)
    rs_j, th_j, tiles_j = jbm.sweep_mxu(
        jnp.asarray(words), jnp.asarray(classes), n, thr, **kw
    )
    rs_t, th_t, tiles_t = tbm.sweep_mxu(
        _t(words), torch.from_numpy(classes), n, thr, **kw
    )
    assert 0 < rs_t[:, 2].sum() < rs_t[:, 1].sum()
    assert np.array_equal(rs_j, rs_t)
    assert np.array_equal(th_j, th_t)
    assert np.array_equal(tiles_j[0], tiles_t[0])
    assert np.array_equal(tiles_j[1], tiles_t[1])


@pytest.mark.parametrize("schedule", ["strips", "scan"])
def test_plain_epilogue_matches_kernel_route(small_case, schedule):
    """stats_engine='xla' (the plain epilogue, the JAX knob) gives the
    same statistics as the kernel route on both schedules, and as the
    JAX package's xla epilogue."""
    words, classes, n, wts = small_case
    args = (_t(words), torch.from_numpy(classes), n, 900)
    kw = dict(strip=512, schedule=schedule, weights=wts)
    plain = tbm.sweep_mxu(*args, stats_engine="xla", **kw)
    kernel = tbm.sweep_mxu(*args, stats_engine="pallas", **kw)
    want = jbm.sweep_mxu(jnp.asarray(words), jnp.asarray(classes), n, 900,
                         stats_engine="xla", **kw)
    for got in (plain, kernel):
        assert np.array_equal(want[0], got[0])
        assert np.array_equal(want[1], got[1])


def test_scan_word_chunk_and_fused_sizing_match_jax():
    """The scan sizes its contraction chunk with j_rows = strip, and the
    fused capacity from the budget, as the JAX package does: the 30k
    corpus (N_pad 32,256, W 28,416, strip 3584) needs no chunk and gets
    k = 32,768; a tight budget chunks both schedules differently."""
    assert tbm.resolve_schedule(32256, 512) == ("scan", 3584, 9)
    assert tbm.fused_capacity(None, 45, 49, 512, 13 << 30) == 32768
    fused = 45 * 49 * 32768 * 12
    assert tbm.auto_word_chunk(32256, 28416, 3584, 13 << 30,
                               j_rows=3584, fused_bytes=fused) == 0
    # strips at the same size: 9.8 GB left for (3584 + 32256) rows →
    # ≤ 8571 words, the largest 128·d with d | 222 is 128·37
    assert tbm.auto_word_chunk(32256, 28416, 3584, 13 << 30) == 4736
    # scan under a 6 GiB budget: 2.7 GB for 7168 rows → 128·74
    assert tbm.auto_word_chunk(32256, 28416, 3584, 6 << 30,
                               j_rows=3584) == 9472
    assert tbm.fused_capacity(10**6, 45, 49, 512, 13 << 30) == 512 * 512
    assert tbm.fused_capacity(None, 10**6, 49, 512, 13 << 30) == 0
    with pytest.raises(ValueError, match="int32"):
        tbm.fused_capacity(1 << 20, 10**4, 49, 1024, 13 << 30)


def test_row_stat_merge_matches_jax():
    """merge_row_stats_at / accumulate_pair_block against the JAX
    functions: max on lanes 3 and 7, sums elsewhere, hits add."""
    rng = np.random.default_rng(4)
    row_stats = rng.integers(-5, 50, (64, 8)).astype(np.int32)
    block_hits = rng.integers(0, 9, (8, 8, 2)).astype(np.int32)
    rs = rng.integers(-5, 50, (16, 8)).astype(np.int32)
    bh = rng.integers(0, 9, (2, 2, 2)).astype(np.int32)
    want = jbm.accumulate_pair_block(
        jnp.asarray(row_stats), jnp.asarray(block_hits), jnp.asarray(rs),
        jnp.asarray(bh), 16, 40, block=8,
    )
    got = tbm.accumulate_pair_block(
        torch.from_numpy(row_stats.copy()), torch.from_numpy(block_hits.copy()),
        torch.from_numpy(rs), torch.from_numpy(bh), 16, 40, block=8,
    )
    assert np.array_equal(np.asarray(want[0]), got[0].numpy())
    assert np.array_equal(np.asarray(want[1]), got[1].numpy())


def test_subtile_candidates_match_jax():
    """subtile_rows is the JAX layout; the topk candidates hold the same
    (i, j, count) survivors per sub-tile (the order within a sub-tile is
    topk's tie order, so the comparison is per sub-tile as sets)."""
    rng = np.random.default_rng(8)
    counts = rng.integers(0, 30, (32, 48)).astype(np.int32)
    mask = (counts > 25).astype(np.int32)
    assert np.array_equal(
        np.asarray(jbm.subtile_rows(jnp.asarray(counts), 16)),
        tbm.subtile_rows(torch.from_numpy(counts), 16).numpy(),
    )
    want = jbm.topk_subtile_candidates(
        jnp.asarray(mask), jnp.asarray(counts), 64, 96, tile=16, k=40
    )
    got = tbm.topk_subtile_candidates(
        torch.from_numpy(mask), torch.from_numpy(counts), 64, 96, tile=16,
        k=40,
    )
    assert all(g.dtype == torch.int32 and g.shape == (6, 40) for g in got)
    for sub in range(6):
        def cands(gi, gj, c):
            gi, gj, c = (np.asarray(x)[sub] for x in (gi, gj, c))
            return sorted(zip(gi[c >= 0], gj[c >= 0], c[c >= 0]))

        assert cands(*want) == cands(*(x.numpy() for x in got))
        assert (np.asarray(got[2][sub]) >= 0).sum() == mask.reshape(
            2, 16, 3, 16).transpose(0, 2, 1, 3).reshape(6, -1)[sub].sum()


@pytest.mark.parametrize("block", [512, 128])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("schedule", ["strips", "scan"])
def test_sweep_loops_write_the_jax_sweep(small_case, schedule, weighted,
                                         block):
    """_strip_sweep (K1 into each strip's rows, one call a strip) and
    _scan_sweep (K2 into the accumulators, one call a step), called
    directly, leave in their sweep-wide buffers what the JAX sweep_mxu
    returns."""
    words, classes, n, wts = small_case
    thr = 900 if weighted else 35
    want = jbm.sweep_mxu(jnp.asarray(words), jnp.asarray(classes), n, thr,
                         strip=512, block=block, schedule=schedule,
                         weights=wts if weighted else None)
    kw = dict(n=n, threshold=thr, block=block, w_thresh=1, word_chunk=0,
              stats_engine="pallas")
    w = torch.from_numpy(wts) if weighted else None
    if schedule == "strips":
        rs, bh = tbm._strip_sweep(_t(words), torch.from_numpy(classes), w,
                                  strip=512, **kw)
    else:
        pairs = (np.stack(np.triu_indices(3), axis=1) * 512).astype(np.int32)
        rs, bh, ys = tbm._scan_sweep(_t(words), torch.from_numpy(classes), w,
                                     pairs, bs=512, fused_k=0,
                                     fused_same=False, **kw)
        assert ys is None
    ti, tj, b = want[2]
    assert b == block and bh.shape == (1536 // block, 1536 // block, 2)
    assert np.array_equal(want[0], rs.numpy().astype(np.int64))
    assert np.array_equal(want[1], bh.numpy()[ti, tj])
    assert want[1][:, 0].sum() > 0
