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
    words, classes, n, _ = small_case
    args = (_t(words), torch.from_numpy(classes), n, 10)
    with pytest.raises(NotImplementedError, match="item 8"):
        tbm.sweep_mxu(*args, strip=512, schedule="scan")
    with pytest.raises(NotImplementedError, match="item 8"):
        tbm.sweep_mxu(*args, strip=512, fused_k=512)
    with pytest.raises(NotImplementedError, match="item 8"):
        tbm.sweep_mxu(*args, strip=512, stats_engine="xla")
