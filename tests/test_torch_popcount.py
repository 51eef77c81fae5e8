"""Parity of the port's popcount engines (ops/popcount.py) with the JAX
package's ``ops/popcount.py`` on the CPU: the plain AND + popcount
counts, the plain tile sweep, and the K4 wrapper's CPU route against the
Pallas kernel in interpret mode.

Tolerance: exact equality (integer counts and statistics). The CUDA
kernel itself runs only on a GPU: tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniprot_kmer_based_clustering_tpu.ops import popcount as jpc
from uniprot_kmer_based_clustering_tpu_torch.ops import popcount as tpc


@pytest.fixture(scope="module")
def case():
    """n_pad 96 (n 90), W 8, rows at 1/4 density, 3 classes."""
    rng = np.random.default_rng(11)
    n_pad, w, n = 96, 8, 90
    words = rng.integers(0, 2**32, size=(n_pad, w), dtype=np.uint32)
    words &= rng.integers(0, 2**32, size=(n_pad, w), dtype=np.uint32)
    words[3, 0] |= 0x80000000  # the int32 view's sign bit
    words[n:] = 0
    classes = rng.integers(0, 3, size=n_pad).astype(np.int32)
    classes[n:] = -1
    return words, classes, n


def _t(words):
    return torch.from_numpy(words.view(np.int32))


def test_popcount32_counts_every_bit():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, size=1000, dtype=np.uint32)
    x[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    want = np.unpackbits(x.view(np.uint8)).reshape(-1, 32).sum(axis=1)
    got = tpc.popcount32_(_t(x).clone())
    assert got.dtype == torch.int32
    assert np.array_equal(want, got.numpy())


def test_pairwise_counts_match_jax(case, monkeypatch):
    """Row chunking (forced small here) leaves the counts unchanged."""
    words, _, _ = case
    want = np.asarray(jpc.pairwise_counts_xla(
        jnp.asarray(words[:40]), jnp.asarray(words)
    ))
    monkeypatch.setattr(tpc, "_CHUNK_ELEMS", 96 * 8 * 3)
    got = tpc.pairwise_counts_xla(_t(words)[:40], _t(words))
    assert got.dtype == torch.int32 and got.shape == (40, 96)
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("threshold", [0, 18])
def test_sweep_xla_matches_jax(case, tile, threshold):
    words, classes, n = case
    rs_j, th_j, (ti_j, tj_j, t_j) = jpc.sweep_xla(
        jnp.asarray(words), classes, n, threshold, tile=tile
    )
    rs_t, th_t, (ti_t, tj_t, t_t) = tpc.sweep_xla(
        _t(words), torch.from_numpy(classes), n, threshold, tile=tile
    )
    assert rs_t.dtype == np.int64 and th_t.shape == (len(ti_t), 4)
    assert th_t[:, 0].sum() > 0
    assert np.array_equal(rs_j, rs_t)
    assert np.array_equal(th_j, th_t)
    assert np.array_equal(ti_j, ti_t) and np.array_equal(tj_j, tj_t)
    assert t_j == t_t


def test_k4_cpu_route_matches_pallas_interpret(case):
    """The K4 wrapper on CPU tensors (its plain version) against the
    Pallas kernel run in interpret mode, at the same tile."""
    words, classes, n = case
    rs_j, th_j, (ti_j, tj_j, _) = jpc.sweep_pallas(
        jnp.asarray(words), jnp.asarray(classes), n, 20, tile=32,
        interpret=True,
    )
    before = tpc.popcount_sweep.launches
    rs_t, th_t, (ti_t, tj_t, _) = tpc.popcount_sweep(
        _t(words), torch.from_numpy(classes), n, 20, 32
    )
    assert tpc.popcount_sweep.launches == before
    assert int(th_t[:, 0].sum()) > 0
    assert rs_t.dtype == torch.int32 and th_t.dtype == torch.int32
    assert np.array_equal(np.asarray(rs_j), rs_t.numpy())
    assert np.array_equal(np.asarray(th_j), th_t.numpy())
    assert np.array_equal(ti_j, ti_t) and np.array_equal(tj_j, tj_t)


@pytest.mark.parametrize("tile", [None, 32])
def test_sweep_pallas_entry_matches_pallas_interpret(case, tile):
    """The port's ``sweep_pallas`` (JAX's arguments and return, K4 behind
    it) on host words copied to the CPU, and on a CPU tensor, against the
    Pallas kernel in interpret mode at its default tile (128 rows: one
    tile here) and at 32."""
    words, classes, n = case
    kw = {} if tile is None else dict(tile=tile)
    if tile is None:  # N_pad 128
        words = np.concatenate([words, np.zeros((32, 8), np.uint32)])
        classes = np.concatenate([classes, np.full(32, -1, np.int32)])
    want = jpc.sweep_pallas(jnp.asarray(words), jnp.asarray(classes), n, 20,
                            word_block=256, interpret=True, **kw)
    for got in (tpc.sweep_pallas(words, torch.from_numpy(classes), n, 20,
                                 word_block=256, device="cpu", **kw),
                tpc.sweep_pallas(_t(words), torch.from_numpy(classes), n,
                                 20, **kw)):
        rs, th, (ti, tj, t) = got
        assert rs.dtype == torch.int32 and th.shape == (len(ti), 4)
        assert np.array_equal(np.asarray(want[0]), rs.numpy())
        assert np.array_equal(np.asarray(want[1]), th.numpy())
        assert np.array_equal(want[2][0], ti) and t == want[2][2]
    assert int(th[:, 0].sum()) > 0


def test_sweep_dispatch_matches_jax(case):
    """sweep() on CPU tensors is sweep_xla at the given tile, as the JAX
    dispatcher is off the TPU."""
    words, classes, n = case
    want = jpc.sweep(jnp.asarray(words), jnp.asarray(classes), n, 25,
                     tile=16)
    got = tpc.sweep(_t(words), torch.from_numpy(classes), n, 25, tile=16)
    for a, b in zip(want[:2], got[:2]):
        assert np.array_equal(a, b)
    assert want[2][2] == got[2][2] == 16


def test_sweep_over_listed_tiles(case):
    """A subset of tile pairs (the first two tile rows) gives the full
    sweep's statistics for those rows and those tiles' hits."""
    words, classes, n = case
    full_rs, full_th, (ti, tj, _) = tpc.popcount_sweep(
        _t(words), torch.from_numpy(classes), n, 30, 16
    )
    rows = ti < 2
    rs, th, _ = tpc.popcount_sweep(
        _t(words), torch.from_numpy(classes), n, 30, 16,
        tiles=(ti[rows], tj[rows]),
    )
    assert torch.equal(rs[:32], full_rs[:32])
    assert not rs[32:].any()
    assert torch.equal(th, full_th[torch.from_numpy(np.nonzero(rows)[0])])


def test_sweep_refuses_bad_inputs(case):
    words, classes, n = case
    with pytest.raises(ValueError, match="multiple of tile"):
        tpc.sweep_xla(_t(words), classes, n, 10, tile=64)
    with pytest.raises(ValueError, match="multiple of tile"):
        tpc.popcount_sweep(_t(words), classes, n, 10, 64)
    meta = torch.empty((96, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tpc.popcount_sweep(meta, classes, n, 10, 32)
