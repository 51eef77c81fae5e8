"""Parity of the port's K1 statistics epilogue (ops/stats.py) with the
JAX package's Pallas kernel (ops/stats_pallas.py, interpret mode).

Tolerance: exact integer equality of row_stats and tile_hits. The CUDA
kernel itself runs only on a GPU: tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniprot_kmer_based_clustering_tpu.ops.bitmul import _strip_counts
from uniprot_kmer_based_clustering_tpu.ops import stats_pallas as jstats
from uniprot_kmer_based_clustering_tpu_torch.ops import stats as tstats


@pytest.fixture(scope="module")
def small_case():
    """The seeded case of tests/test_stats_pallas.py: n_pad 1536, W 64."""
    rng = np.random.default_rng(7)
    n_pad, w = 1536, 64
    n = 1500
    words = rng.integers(0, 2**32, size=(n_pad, w), dtype=np.uint32)
    words[n:] = 0
    classes = rng.integers(0, 4, size=n_pad).astype(np.int32)
    classes[n:] = -1
    ones = jnp.ones(w * 32, jnp.int8)
    counts = np.asarray(
        _strip_counts(jnp.asarray(words), jnp.asarray(words), ones)
    )
    wts = rng.integers(-30, 31, size=w * 32).astype(np.int8)
    counts_w = np.asarray(
        _strip_counts(jnp.asarray(words), jnp.asarray(words), jnp.asarray(wts))
    )
    return classes, n, counts, counts_w



def _both(counts, crow, ccol, **kw):
    rs_j, th_j, (ti_j, tj_j, _) = jstats.stats_from_counts(
        jnp.asarray(counts), crow, ccol, interpret=True, **kw
    )
    rs_t, th_t, (ti_t, tj_t, _) = tstats.stats_from_counts(
        torch.from_numpy(counts), torch.from_numpy(crow),
        torch.from_numpy(ccol), **kw
    )
    assert np.array_equal(ti_j, ti_t) and np.array_equal(tj_j, tj_t)
    return (np.asarray(rs_j), np.asarray(th_j)), (rs_t.numpy(), th_t.numpy())


def test_stats_square_matches_pallas(small_case):
    classes, n, counts, _ = small_case
    before = tstats.stats_from_counts_into.launches
    (rs_j, th_j), (rs_t, th_t) = _both(
        counts, classes, classes, i_off=0, j_off=0, n=n, threshold=10
    )
    assert rs_t.dtype == np.int32 and rs_t.shape == (1536, 8)
    assert th_t.dtype == np.int32 and th_t.shape == (6, 2)
    assert np.array_equal(rs_j, rs_t)
    assert np.array_equal(th_j, th_t)
    # the CPU route is the plain version: no kernel launch is counted
    assert tstats.stats_from_counts_into.launches == before


@pytest.mark.parametrize("si", [0, 1, 2])
def test_stats_strips_match_pallas(small_case, si):
    classes, n, counts, _ = small_case
    i0 = si * 512
    (rs_j, th_j), (rs_t, th_t) = _both(
        np.ascontiguousarray(counts[i0 : i0 + 512, i0:]),
        classes[i0 : i0 + 512], classes[i0:],
        i_off=i0, j_off=i0, n=n, threshold=10,
    )
    assert np.array_equal(rs_j, rs_t)
    assert np.array_equal(th_j, th_t)


@pytest.mark.parametrize("i0", [0, 512])
def test_stats_weighted_w_thresh_matches_pallas(small_case, i0):
    """Signed weighted scores, w_thresh > 1: the max lanes clamp at 0 and
    the present lanes gate on w_thresh in both implementations."""
    classes, n, _, counts_w = small_case
    assert counts_w.min() < 0
    (rs_j, th_j), (rs_t, th_t) = _both(
        np.ascontiguousarray(counts_w[i0:, i0:]), classes[i0:], classes[i0:],
        i_off=i0, j_off=i0, n=n, threshold=100, w_thresh=7,
    )
    assert np.array_equal(rs_j, rs_t)
    assert np.array_equal(th_j, th_t)


def test_stats_below_diagonal_raises(small_case):
    """A block wholly below the pair diagonal leaves tile rows unvisited:
    both implementations refuse it."""
    classes, n, counts, _ = small_case
    blk = np.ascontiguousarray(counts[1024:, :512])
    kw = dict(i_off=1024, j_off=0, n=n, threshold=10)
    with pytest.raises(ValueError, match="keep no tile"):
        jstats.stats_from_counts(
            jnp.asarray(blk), classes[1024:], classes[:512],
            interpret=True, **kw
        )
    with pytest.raises(ValueError, match="keep no tile"):
        tstats.stats_from_counts(
            torch.from_numpy(blk), torch.from_numpy(classes[1024:]),
            torch.from_numpy(classes[:512]), **kw
        )


def test_stats_refuses_other_devices(small_case):
    """Only CPU tensors take the plain version; anything else launches
    the kernel or raises."""
    classes, n, counts, _ = small_case
    meta = torch.empty((512, 512), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tstats.stats_from_counts(
            meta, classes[:512], classes[:512], i_off=0, j_off=0, n=n,
            threshold=10,
        )


def test_reference_pair_block_stats_matches_jax(small_case):
    """The plain epilogue primitive against the JAX package's on a square
    off-diagonal block."""
    from uniprot_kmer_based_clustering_tpu.ops.bitmul import (
        pair_block_stats as jpbs,
    )

    classes, n, counts, _ = small_case
    blk = np.ascontiguousarray(counts[:1024, 512:])
    ca, cb = classes[:1024], classes[512:]
    rs_j, bh_j, oc_j, os_j = jpbs(
        jnp.asarray(blk), jnp.asarray(ca), jnp.asarray(cb), 0, 512,
        n=n, threshold=10, block=512, w_thresh=1,
    )
    rs_t, bh_t, oc_t, os_t = tstats.pair_block_stats(
        torch.from_numpy(blk), torch.from_numpy(ca), torch.from_numpy(cb),
        0, 512, n=n, threshold=10, block=512, w_thresh=1,
    )
    assert np.array_equal(np.asarray(rs_j), rs_t.numpy())
    assert np.array_equal(np.asarray(bh_j), bh_t.numpy())
    assert np.array_equal(np.asarray(oc_j), oc_t.numpy())
    assert np.array_equal(np.asarray(os_j), os_t.numpy())


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("block", [(0, 512, 512, 1024), (512, 512, 1024, 1024)],
                         ids=["off_diagonal", "diagonal"])
def test_traced_stats_match_pallas(small_case, weighted, block):
    """K2's plain version against the JAX traced-offset kernel (interpret
    mode) on every tile of a block; weighted with signed counts and
    w_thresh 7. On the CPU the wrapper takes the plain version and
    counts no launch."""
    classes, n, counts, counts_w = small_case
    i0, j0, s, j = block
    blk = np.ascontiguousarray(
        (counts_w if weighted else counts)[i0 : i0 + s, j0 : j0 + j]
    )
    kw = dict(n=n, threshold=100 if weighted else 10,
              w_thresh=7 if weighted else 1)
    ca, cb = classes[i0 : i0 + s], classes[j0 : j0 + j]
    rs_j, bh_j = jstats.stats_from_counts_traced(
        jnp.asarray(blk), ca, cb, jnp.int32(i0), jnp.int32(j0),
        interpret=True, **kw
    )
    before = tstats.stats_from_counts_traced_into.launches
    rs_t, bh_t = tstats.stats_from_counts_traced(
        torch.from_numpy(blk), torch.from_numpy(ca), torch.from_numpy(cb),
        i0, j0, **kw
    )
    assert tstats.stats_from_counts_traced_into.launches == before
    assert rs_t.dtype == torch.int32 and rs_t.shape == (s, 8)
    assert bh_t.dtype == torch.int32 and bh_t.shape == (s // 512, j // 512, 2)
    assert int(bh_t.sum()) > 0
    assert np.array_equal(np.asarray(rs_j), rs_t.numpy())
    assert np.array_equal(np.asarray(bh_j), bh_t.numpy())


@pytest.mark.parametrize("tile", [512, 96])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("offsets", [(0, 0), (512, 512), (0, 1024)],
                         ids=["square", "diagonal", "off_diagonal"])
@pytest.mark.parametrize("entry", ["k1", "k2"])
def test_into_matches_pallas_then_merge(small_case, entry, offsets,
                                        weighted, tile):
    """The plain accumulate-into versions (the CPU route of the entries the
    sweeps call) against the JAX kernels (interpret mode) followed by the
    JAX merge: K1 stores the block's rows and adds the kept tiles' hits,
    K2 merges into NON-ZERO accumulators by merge_row_stats_at and adds
    every tile's hits. The block_hits view sits at tile offset (1, 2) of
    a larger buffer. Weighted: signed counts, w_thresh 5."""
    from uniprot_kmer_based_clustering_tpu.ops.bitmul import (
        merge_row_stats_at as jmerge,
    )

    classes, n, counts, counts_w = small_case
    i0, j0 = offsets
    s, j = 512 // tile * tile, (1536 - j0) // tile * tile
    blk = np.ascontiguousarray(
        (counts_w if weighted else counts)[i0 : i0 + s, j0 : j0 + j]
    )
    kw = dict(n=n, threshold=100 if weighted else 10,
              w_thresh=5 if weighted else 1, tile=tile)
    ca, cb = classes[i0 : i0 + s], classes[j0 : j0 + j]
    rng = np.random.default_rng(i0 + j0 + tile + weighted)
    rows0 = rng.integers(0, 1000, (s, 8)).astype(np.int32)
    hits0 = rng.integers(0, 9, (s // tile + 1, j // tile + 2, 2)).astype(
        np.int32)
    want_hits = hits0.copy()
    if entry == "k1":
        rs_j, th_j, (ti, tj, _) = jstats.stats_from_counts(
            jnp.asarray(blk), ca, cb, i_off=i0, j_off=j0, interpret=True,
            **kw
        )
        want_rows = np.asarray(rs_j)
        np.add.at(want_hits, (1 + ti, 2 + tj), np.asarray(th_j))
        fn = tstats.stats_from_counts_into
    else:
        rs_j, bh_j = jstats.stats_from_counts_traced(
            jnp.asarray(blk), ca, cb, jnp.int32(i0), jnp.int32(j0),
            interpret=True, **kw
        )
        want_rows = np.asarray(jmerge(jnp.asarray(rows0), rs_j, 0))
        want_hits[1:, 2:] += np.asarray(bh_j)
        fn = tstats.stats_from_counts_traced_into
    before = fn.launches
    rows, hits = torch.from_numpy(rows0.copy()), torch.from_numpy(hits0.copy())
    out = fn(torch.from_numpy(blk), torch.from_numpy(ca), torch.from_numpy(cb),
             rows, hits[1:, 2:], i_off=i0, j_off=j0, **kw)
    assert fn.launches == before
    assert out[0] is rows
    assert np.array_equal(want_rows, rows.numpy())
    assert np.array_equal(want_hits, hits.numpy())
    assert not np.array_equal(hits0, want_hits)


@pytest.mark.parametrize("tile", [96, 128, 512])
def test_kept_tile_rule_matches_jax(tile):
    """The arithmetic kept-tile rule (first_kept_tile, kept_tile_mask from
    device aranges) lists exactly the JAX stats_tiles over a grid of
    offsets and shapes, the kept tiles' hits are selected from a dense
    block_hits in that order, and the keeps-no-tile refusal fires exactly
    where the JAX tile walk's coverage check does."""
    rng = np.random.default_rng(tile)
    offs = [0, 1, tile // 2, tile - 1, tile, tile + 1, 3 * tile - 5,
            5 * tile, 7 * tile + 3]
    checked = refused = 0
    for nti, ntj in [(1, 1), (2, 3), (4, 2), (3, 7)]:
        s, j = nti * tile, ntj * tile
        bh = torch.from_numpy(
            rng.integers(0, 100, (nti, ntj, 2)).astype(np.int32))
        for i_off in offs:
            for j_off in offs:
                ti, tj = jstats.stats_tiles(s, j, i_off, j_off, tile)
                mask = tstats.kept_tile_mask(nti, ntj, i_off, j_off, tile)
                got_ti, got_tj = np.nonzero(mask.numpy())
                assert np.array_equal(ti, got_ti), (s, j, i_off, j_off)
                assert np.array_equal(tj, got_tj), (s, j, i_off, j_off)
                assert np.array_equal(
                    tstats._kept_hits(bh, i_off, j_off, tile, len(ti)).numpy(),
                    bh.numpy()[ti, tj],
                )
                if len(np.unique(ti)) == nti:
                    tstats._check_kept(s, j, i_off, j_off, tile)
                else:
                    refused += 1
                    with pytest.raises(ValueError, match="keep no tile"):
                        tstats._check_kept(s, j, i_off, j_off, tile)
                checked += 1
    assert checked == 4 * len(offs) ** 2 and 0 < refused < checked
