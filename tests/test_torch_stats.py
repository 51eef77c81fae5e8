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
    before = tstats.stats_from_counts.launches
    (rs_j, th_j), (rs_t, th_t) = _both(
        counts, classes, classes, i_off=0, j_off=0, n=n, threshold=10
    )
    assert rs_t.dtype == np.int32 and rs_t.shape == (1536, 8)
    assert th_t.dtype == np.int32 and th_t.shape == (6, 2)
    assert np.array_equal(rs_j, rs_t)
    assert np.array_equal(th_j, th_t)
    # the CPU route is the plain version: no kernel launch is counted
    assert tstats.stats_from_counts.launches == before


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
    before = tstats.stats_from_counts_traced.launches
    rs_t, bh_t = tstats.stats_from_counts_traced(
        torch.from_numpy(blk), torch.from_numpy(ca), torch.from_numpy(cb),
        i0, j0, **kw
    )
    assert tstats.stats_from_counts_traced.launches == before
    assert rs_t.dtype == torch.int32 and rs_t.shape == (s, 8)
    assert bh_t.dtype == torch.int32 and bh_t.shape == (s // 512, j // 512, 2)
    assert int(bh_t.sum()) > 0
    assert np.array_equal(np.asarray(rs_j), rs_t.numpy())
    assert np.array_equal(np.asarray(bh_j), bh_t.numpy())
