"""The port's 2-D (hosts × chips) ring and k-axis layout (``parallel/``)
against the JAX package's on the CPU: the JAX side runs on the 8 virtual
CPU devices of ``tests/conftest.py``, the port on CPU shards
(``make_mesh_2d(H, C, device="cpu")``, ``make_mesh(D, axis="k",
device="cpu")``). Inputs are seeded numpy; tolerance 0 (row_stats row by
row, tile hits, pair lists, labels, bitset words).

The JAX results are computed once per configuration (module cache), and
torch runs on one thread here: at these sizes more threads only contend.
"""

import functools

import numpy as np
import pytest
import torch

from uniprot_kmer_based_clustering_tpu import parallel as jpar
from uniprot_kmer_based_clustering_tpu.kmers.bitset import pack_bitsets
from uniprot_kmer_based_clustering_tpu_torch.ops import stats as tstats
from uniprot_kmer_based_clustering_tpu_torch.ops.bitmul import (
    counts_window_pair,
)
from uniprot_kmer_based_clustering_tpu_torch.parallel import mesh as tmesh
from uniprot_kmer_based_clustering_tpu_torch.parallel import sharded as tsh

THR = 4
SHAPES_2D = [(1, 8), (2, 4), (4, 2), (8, 1), (2, 2), (2, 3), (3, 2)]
KAXIS_N_PAD = 640  # the JAX k-axis tests' padding


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _problem(n_pad, seed=5):
    """The JAX ring tests' problem: 500 proteins over 1,500 k-mers at
    density 0.04, rows padded to ``n_pad``, classes 0..3 and -1 past n."""
    rng = np.random.default_rng(seed)
    n, k = 500, 1500
    rows, cols = np.nonzero(rng.random((n, k)) < 0.04)
    bs = pack_bitsets(
        rows.astype(np.int32), cols.astype(np.int32), n, k,
        row_multiple=n_pad, word_multiple=128,
    )
    classes = np.full(bs.n_pad, -1, np.int32)
    classes[:n] = rng.integers(0, 4, n)
    return bs, classes, n


def _n_pad_2d(hc, cc):
    """The JAX 2-D tests' padding: blocks of 256 rows (split final steps)
    up to 4 shards, of 128 (first-half fallback) past that."""
    d = hc * cc
    return 128 * d * (2 if d <= 4 else 1)


def _weights(bs):
    return np.random.default_rng(17).integers(
        1, 50, size=bs.w_pad * 32).astype(np.int8)


def _tmesh(layout, shape):
    if layout == "2d":
        return tmesh.make_mesh_2d(*shape, device="cpu")
    return tmesh.make_mesh(shape, axis="k", device="cpu")


def _jmesh(layout, shape):
    if layout == "2d":
        return jpar.make_mesh_2d(*shape)
    return jpar.make_mesh(shape, axis="k")


def _case(layout, shape):
    return _problem(_n_pad_2d(*shape) if layout == "2d" else KAXIS_N_PAD)


@functools.lru_cache(maxsize=None)
def _jax_sweep(layout, shape, weighted=False):
    bs, classes, n = _case(layout, shape)
    sweep = (jpar.sharded_pairwise_similarity_2d if layout == "2d"
             else jpar.sharded_pairwise_similarity_kaxis)
    return sweep(_jmesh(layout, shape), bs.words, classes, n,
                 40 if weighted else THR, block_tile=128,
                 weights=_weights(bs) if weighted else None)


@functools.lru_cache(maxsize=None)
def _jax_extract(layout, shape):
    bs, classes, n = _case(layout, shape)
    return jpar.sharded_extract_pairs(
        _jmesh(layout, shape), bs.words, classes, n, THR, block_tile=128)


def _same_sweep(got, want):
    rs, th, (ti, tj, t) = got
    rs_w, th_w, (ti_w, tj_w, t_w) = want
    assert rs.dtype == np.int64 and np.array_equal(rs, rs_w)
    assert np.array_equal(th, th_w)
    assert np.array_equal(ti, ti_w) and np.array_equal(tj, tj_w)
    assert t == t_w


@pytest.mark.parametrize("shape", SHAPES_2D, ids=str)
def test_2d_sweep_matches_jax_row_by_row(shape):
    bs, classes, n = _case("2d", shape)
    got = tsh.sharded_pairwise_similarity_2d(
        _tmesh("2d", shape), bs.words, classes, n, THR, block_tile=128)
    _same_sweep(got, _jax_sweep("2d", shape))
    assert got[1][:, 0].sum() > 0


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_kaxis_sweep_matches_jax_row_by_row(d):
    bs, classes, n = _case("kaxis", d)
    assert bs.w_pad % d == 0
    got = tsh.sharded_pairwise_similarity_kaxis(
        _tmesh("kaxis", d), bs.words, classes, n, THR, block_tile=128)
    _same_sweep(got, _jax_sweep("kaxis", d))
    assert got[1][:, 0].sum() > 0


@pytest.mark.parametrize("layout,shape", [("2d", (2, 4)), ("kaxis", 4)])
def test_weighted_sweep_matches_jax(layout, shape):
    bs, classes, n = _case(layout, shape)
    sweep = (tsh.sharded_pairwise_similarity_2d if layout == "2d"
             else tsh.sharded_pairwise_similarity_kaxis)
    got = sweep(_tmesh(layout, shape), bs.words, classes, n, 40,
                weights=_weights(bs))
    _same_sweep(got, _jax_sweep(layout, shape, weighted=True))


@pytest.mark.parametrize("layout,shape", [
    ("2d", (2, 2)), ("2d", (2, 3)), ("2d", (4, 2)), ("2d", (1, 8)),
    ("kaxis", 1), ("kaxis", 2), ("kaxis", 4), ("kaxis", 8),
], ids=str)
def test_extract_matches_jax(layout, shape):
    bs, classes, n = _case(layout, shape)
    got = tsh.sharded_extract_pairs(_tmesh(layout, shape), bs.words,
                                    classes, n, THR, block_tile=128)
    want = _jax_extract(layout, shape)
    assert got.dtype == np.int32 and len(got) > 1000
    assert np.array_equal(got, want)


@pytest.mark.parametrize("layout,shape", [("2d", (2, 2)), ("kaxis", 4)])
def test_extract_tile_cap_path_and_its_shortfall(layout, shape):
    """tile_cap selects per-sub-tile top-k compaction (the JAX TPU path):
    exact with the densest tile's count; below it a sub-tile is dropped
    whole and expected_total turns the shortfall into a raise."""
    bs, classes, n = _case(layout, shape)
    want = _jax_extract(layout, shape)
    th = _jax_sweep(layout, shape)[1]
    mesh = _tmesh(layout, shape)
    got = tsh.sharded_extract_pairs(
        mesh, bs.words, classes, n, THR, tile_cap=int(th[:, 0].max()),
        expected_total=len(want))
    assert np.array_equal(got, want)
    assert int(th[:, 0].max()) > 128
    with pytest.raises(ValueError, match="sweep stats promised"):
        tsh.sharded_extract_pairs(mesh, bs.words, classes, n, THR,
                                  tile_cap=1, expected_total=len(want))


@pytest.mark.parametrize("layout,shape,k", [
    ("2d", (2, 2), None), ("2d", (3, 2), None), ("2d", (2, 4), 512),
    ("2d", (1, 2), None), ("kaxis", 2, None), ("kaxis", 4, 512),
    ("kaxis", 8, None), ("kaxis", 1, 256),
], ids=str)
def test_fused_matches_jax(layout, shape, k):
    bs, classes, n = _case(layout, shape)
    got = tsh.sharded_pairwise_fused(_tmesh(layout, shape), bs.words,
                                     classes, n, THR, block_tile=128, k=k)
    want = jpar.sharded_pairwise_fused(
        _jmesh(layout, shape), bs.words, classes, n, THR, block_tile=128,
        k=k)
    _same_sweep(got[:3], want[:3])
    assert np.array_equal(got[3], want[3]) and len(got[3]) > 1000


@pytest.mark.parametrize("layout,shape,kw", [
    ("2d", (2, 4), dict(k=4)), ("2d", (2, 2), dict(k=0, cap=64)),
    ("kaxis", 4, dict(k=4)), ("kaxis", 4, dict(k=0, cap=64)),
], ids=str)
def test_fused_fallback_regimes_stay_exact(layout, shape, kw):
    """A sub-tile over k (dropped in the pass) or a cap below the total
    makes the wrapper extract again (JAX
    ``test_fused_2d_and_kaxis_fallback_stay_exact``): the statistics and
    pairs equal the JAX sweep's and extraction's."""
    bs, classes, n = _case(layout, shape)
    got = tsh.sharded_pairwise_fused(_tmesh(layout, shape), bs.words,
                                     classes, n, THR, block_tile=128, **kw)
    _same_sweep(got[:3], _jax_sweep(layout, shape))
    assert np.array_equal(got[3], _jax_extract(layout, shape))


@pytest.mark.parametrize("layout,shape", [("2d", (2, 2)), ("kaxis", 2)])
def test_fused_all_pairs_matches_jax(layout, shape):
    bs, classes, n = _case(layout, shape)
    got = tsh.sharded_pairwise_fused(_tmesh(layout, shape), bs.words,
                                     classes, n, THR, cross_amr_only=False)
    want = jpar.sharded_pairwise_fused(
        _jmesh(layout, shape), bs.words, classes, n, THR, block_tile=128,
        cross_amr_only=False, k=0)
    _same_sweep(got[:3], want[:3])
    assert np.array_equal(got[3], want[3])
    assert len(got[3]) > len(_jax_extract(layout, shape))


@pytest.mark.parametrize("layout,shape", [("2d", (2, 2)), ("kaxis", 4)])
def test_stage_mesh_inputs_layouts_and_pass_through(layout, shape):
    """Row shards in host-major order on the 2-D mesh, column shards and
    whole classes on every device on the k axis; staged inputs pass
    through the wrappers with the results of the raw numpy inputs."""
    bs, classes, n = _case(layout, shape)
    mesh = _tmesh(layout, shape)
    words_s, classes_s = tsh.stage_mesh_inputs(mesh, bs.words, classes)
    words = bs.words.view(np.int32)
    d = mesh.size
    if layout == "2d":
        want_w = np.split(words, d)
        want_c = np.split(classes, d)
    else:
        want_w = np.split(words, d, axis=1)
        want_c = [classes] * d
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(words_s, want_w))
    assert all(np.array_equal(a.numpy(), b)
               for a, b in zip(classes_s, want_c))
    again = tsh.stage_mesh_inputs(mesh, words_s, classes_s)
    assert all(a is b for a, b in zip(again[0] + again[1],
                                      words_s + classes_s))
    sweep = (tsh.sharded_pairwise_similarity_2d if layout == "2d"
             else tsh.sharded_pairwise_similarity_kaxis)
    _same_sweep(sweep(mesh, words_s, classes_s, n, THR),
                _jax_sweep(layout, shape))
    assert np.array_equal(
        tsh.sharded_extract_pairs(mesh, words_s, classes_s, n, THR),
        _jax_extract(layout, shape))


def _csr_case():
    """Incidences with two ranks of one protein in one word and bit 31 of
    a word, in an order shuffled."""
    rng = np.random.default_rng(23)
    n, k = 300, 1000
    rows, cols = np.nonzero(rng.random((n, k)) < 0.05)
    extra_r = np.array([0, 0, 0, 7, 7, 299, 150, 150], np.int32)
    extra_c = np.array([31, 30, 63, 0, 1, 991, 512, 543], np.int32)
    p = np.concatenate([rows.astype(np.int32), extra_r])
    r = np.concatenate([cols.astype(np.int32), extra_c])
    keep = np.unique(np.stack([p, r], 1), axis=0)
    order = rng.permutation(len(keep))
    return keep[order, 0], keep[order, 1], n, k


@pytest.mark.parametrize("layout,shape", [
    ("2d", (2, 2)), ("2d", (1, 3)), ("kaxis", 1), ("kaxis", 2),
    ("kaxis", 4),
], ids=str)
def test_stage_mesh_inputs_csr_equals_host_pack_bitsets(layout, shape):
    """The device-built shards equal the host ``pack_bitsets`` matrix's
    row shards (2-D) or column shards (k axis), both bits set where two
    ranks of one protein share a word (bit 31 included: the JAX k-axis
    staging's ``unique_indices=True`` scatter is not copied), and the
    classes padded with -1; the layout's sweep over them equals the sweep
    over the packed matrix and the JAX package's."""
    p, r, n, k = _csr_case()
    mesh = _tmesh(layout, shape)
    d = mesh.size
    want = pack_bitsets(p, r, n, k, row_multiple=d * 128, word_multiple=32)
    classes = np.arange(n, dtype=np.int32) % 3
    words_s, classes_s = tsh.stage_mesh_inputs_csr(
        mesh, p, r, want.n_pad, want.w_pad, classes)
    got = np.concatenate([w.numpy() for w in words_s],
                         axis=0 if layout == "2d" else 1).view(np.uint32)
    assert np.array_equal(got, want.words)
    for row, bits in ((0, (30, 31)), (7, (0, 1)), (150, (0, 31))):
        word = 0 if row != 150 else 16
        for b in bits:
            assert got[row, word] >> b & 1, (row, word, b)
    full = np.full(want.n_pad, -1, np.int32)
    full[:n] = classes
    if layout == "2d":
        assert np.array_equal(torch.cat(classes_s).numpy(), full)
    else:
        assert all(np.array_equal(c.numpy(), full) for c in classes_s)
    sweep = (tsh.sharded_pairwise_similarity_2d if layout == "2d"
             else tsh.sharded_pairwise_similarity_kaxis)
    a = sweep(mesh, words_s, classes_s, n, 2)
    _same_sweep(a, sweep(mesh, want.words, full, n, 2))
    jsweep = (jpar.sharded_pairwise_similarity_2d if layout == "2d"
              else jpar.sharded_pairwise_similarity_kaxis)
    _same_sweep(a, jsweep(_jmesh(layout, shape), want.words, full, n, 2,
                          block_tile=128))


def test_stage_mesh_inputs_csr_checks_axis_and_width():
    mesh = _tmesh("kaxis", 3)
    with pytest.raises(ValueError, match="must divide over 3 devices"):
        tsh.stage_mesh_inputs_csr(mesh, [0], [0], 256, 4, [0])
    with pytest.raises(ValueError, match="must divide over 3 devices"):
        tsh.sharded_pairwise_similarity_kaxis(
            mesh, np.zeros((256, 4), np.uint32), np.zeros(256, np.int32),
            1, THR)
    with pytest.raises(ValueError, match="not the mesh's axes"):
        tsh.stage_mesh_inputs_csr(mesh, [0], [0], 256, 3, [0], axis="p")
    with pytest.raises(ValueError, match="takes the 2d layout"):
        tsh.sharded_pairwise_similarity_2d(
            mesh, np.zeros((256, 3), np.uint32), np.zeros(256, np.int32),
            1, THR)


def _covered(subs_of_steps, n_pad):
    seen = np.zeros((n_pad, n_pad), np.int64)
    for step in subs_of_steps:
        for subs in step:
            for s in subs:
                gi = s.gi0 + np.arange(s.rows)[:, None]
                gj = s.gj0 + np.arange(s.cols)[None, :]
                keep = np.ones((s.rows, s.cols), bool)
                if s.triangle:
                    keep = gi < gj
                gi, gj = np.broadcast_arrays(gi, gj)
                np.add.at(seen, (np.minimum(gi, gj)[keep],
                                 np.maximum(gi, gj)[keep]), 1)
    return seen


@pytest.mark.parametrize("hc", [1, 2, 3, 4])
@pytest.mark.parametrize("cc", [1, 2, 3, 4])
def test_2d_schedule_covers_each_pair_once(hc, cc):
    """Every pair i<j of N_pad rows lies in exactly one sub-step of the
    2-D schedule (in either orientation), for half blocks on and off the
    tile grid, and the count is the sub-steps'."""
    for tiles in (2, 3):
        bt = 4
        block = tiles * bt
        n_pad = hc * cc * block
        sched = tsh.ring_schedule_2d(hc, cc, block, bt)
        seen = _covered(sched, n_pad)
        assert np.array_equal(seen, np.triu(np.ones_like(seen), 1))
        assert tsh.count_substeps_2d(hc, cc, n_pad, bt) == sum(
            len(subs) for step in sched for subs in step)
        assert len(sched) == len(tsh.steps_2d(hc, cc))


def test_2d_substep_count_at_30k_on_2x2():
    """30,000 proteins on 2 × 2: N_pad 32,256, block 8,064, whose half is
    no whole tile: 4 × 8 diagonal strips, the intra-host final step on
    the first chips (2), the outer final step's two inner steps on the
    first host (4) — 38, the flat D = 4 ring's count."""
    assert tsh.count_substeps_2d(2, 2, 32256) == 38
    assert tsh.count_substeps(4, 32256) == 38
    sched = tsh.ring_schedule_2d(2, 2, 8064, 128)
    assert [sum(map(len, step)) for step in sched] == [32, 2, 2, 2]


@pytest.mark.parametrize("d,budget,heights", [
    (1, None, [640]),
    (4, 5 * KAXIS_N_PAD * 4 * 128, [128] * 5),
    (3, 4 * KAXIS_N_PAD * 4 * 256, [256, 256, 128]),
])
def test_kaxis_strips_cover_the_upper_triangle(d, budget, heights):
    """The strips cover every pair i<j once, each a whole number of tiles
    against its column suffix; the D partial strips and their sum at
    the full width set their height."""
    strips = tsh.kaxis_strips(d, KAXIS_N_PAD, 128, budget)
    seen = _covered([[strips]], KAXIS_N_PAD)
    assert np.array_equal(seen, np.triu(np.ones_like(seen), 1))
    assert [s.rows for s in strips] == heights
    assert all(s.triangle and s.c0 == s.r0 == s.gi0 == s.gj0
               and s.cols == KAXIS_N_PAD - s.r0 for s in strips)


def test_kaxis_multi_strip_and_word_chunks_equal_whole(monkeypatch):
    """Under small budgets the k-axis pass runs 5 strips of one tile, in
    word chunks; the statistics and pairs do not change."""
    bs, classes, n = _case("kaxis", 4)
    monkeypatch.setattr(tsh, "KAXIS_STRIP_BYTES", 5 * KAXIS_N_PAD * 4 * 128)
    monkeypatch.setattr(tsh, "RING_UNPACK_BYTES", 1280 * 32 * 8)
    assert tsh.count_kaxis_strips(4, KAXIS_N_PAD) == 5
    mesh = _tmesh("kaxis", 4)
    got = tsh.sharded_pairwise_fused(mesh, bs.words, classes, n, THR)
    _same_sweep(got[:3], _jax_sweep("kaxis", 4))
    assert np.array_equal(got[3], _jax_extract("kaxis", 4))


@pytest.mark.parametrize("axis", ["h", "c", None])
def test_ring_shift_along_each_axis(axis):
    """On a 2 × 3 mesh: along "c" shard (h, c) receives (h, (c+1) % 3),
    along "h" ((h+1) % 2, c), with no axis the next shard in host-major
    order; every block is a fresh buffer, so an in-place op on one
    touches no other."""
    mesh = tmesh.make_mesh_2d(2, 3, device="cpu")
    assert mesh.shape == {"h": 2, "c": 3} and mesh.size == 6
    want = {"c": [1, 2, 0, 4, 5, 3], "h": [3, 4, 5, 0, 1, 2],
            None: [1, 2, 3, 4, 5, 0]}[axis]
    assert tmesh.ring_sources(mesh, axis) == want
    blocks = [torch.full((4, 2), v, dtype=torch.int32) for v in range(6)]
    old = list(blocks)
    moving = tmesh.ring_shift(list(blocks), mesh, axis)
    assert [int(b[0, 0]) for b in moving] == want
    for m in moving:
        assert all(m.data_ptr() != o.data_ptr() for o in old)
        m.add_(100)
    assert [int(b[0, 0]) for b in old] == list(range(6))


def test_make_mesh_2d_and_layouts():
    m = tmesh.make_mesh_2d(2, 4, device="cpu")
    assert m.axis_names == ("h", "c") and tmesh.mesh_layout(m) == "2d"
    assert tmesh.mesh_layout(tmesh.make_mesh(2, axis="k",
                                             device="cpu")) == "kaxis"
    assert tmesh.mesh_layout(tmesh.make_mesh(2, device="cpu")) == "flat"
    assert tmesh.make_mesh_2d(1, 2, devices=["cpu", "cpu"]).size == 2
    with pytest.raises(ValueError, match="devices listed"):
        tmesh.make_mesh_2d(2, 2, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="do not hold"):
        tmesh.Mesh(["cpu"] * 3, ("h", "c"), (2, 2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tmesh.make_mesh_2d(1, 2)


@pytest.mark.parametrize("shape", [(2, 2), (2, 3)], ids=str)
def test_k1_at_2d_fake_offsets_equals_the_plain_epilogue_at_real_indices(
        shape):
    """On every sub-step of the last shard of a 2-D ring (a diagonal
    strip, wrapped block pairs, split halves), K1's plain version at the
    ring's fake offsets equals the plain masked statistics at the real
    global indices."""
    bs, classes, n = _case("2d", shape)
    hc, cc = shape
    words = torch.from_numpy(bs.words.view(np.int32))
    cls = torch.from_numpy(classes)
    block = bs.n_pad // (hc * cc)
    subs = [s for step in tsh.ring_schedule_2d(hc, cc, block, 128)
            for s in step[-1]]
    assert any(s.triangle for s in subs)
    assert any(s.gj0 < s.gi0 for s in subs)
    for s in subs:
        ia = np.arange(s.gi0, s.gi0 + s.rows)
        ja = np.arange(s.gj0, s.gj0 + s.cols)
        counts = counts_window_pair(words[ia], words[ja])
        i_off, j_off = tsh.fake_offsets(s)
        rs, bh = tstats.stats_from_counts_traced_reference(
            counts, cls[ia], cls[ja], i_off, j_off, n=tsh.FAKE_N,
            threshold=THR, tile=128)
        _same_as_real_indices(rs, bh, counts, cls, ia, ja, n, s.triangle)


def _same_as_real_indices(rs, bh, counts, cls, ia, ja, n, triangle):
    gi, gj = torch.from_numpy(ia)[:, None], torch.from_numpy(ja)[None]
    valid = (gi < n) & (gj < n)
    if triangle:
        valid &= gi < gj
    cross = valid & (cls[ia][:, None] != cls[ja][None, :])
    want, over_c, over_s = tstats.stack_row_stats(counts, cross,
                                                  valid & ~cross, THR)
    assert torch.equal(rs, want)
    nb = len(ia) // 128, 128, len(ja) // 128, 128
    assert torch.equal(bh[..., 0], over_c.reshape(nb).sum((1, 3)).int())
    assert torch.equal(bh[..., 1], over_s.reshape(nb).sum((1, 3)).int())


def test_k1_at_kaxis_real_offsets_equals_the_plain_epilogue():
    """K1's plain version on a k-axis strip (summed partial counts of the
    column shards, real offsets (r0, r0) and n) equals the plain masked
    statistics at the real indices, and the partials sum to the whole
    product."""
    bs, classes, n = _case("kaxis", 4)
    words = torch.from_numpy(bs.words.view(np.int32))
    cls = torch.from_numpy(classes)
    strips = tsh.kaxis_strips(4, KAXIS_N_PAD, 128, 5 * 640 * 4 * 256)
    for s in strips[1:3]:
        ia = np.arange(s.r0, s.r0 + s.rows)
        ja = np.arange(s.c0, KAXIS_N_PAD)
        parts = [counts_window_pair(w[ia], w[ja])
                 for w in words.chunk(4, dim=1)]
        counts = tmesh.sum_to_first(parts, _tmesh("kaxis", 4))
        assert torch.equal(counts, counts_window_pair(words[ia], words[ja]))
        rs = torch.empty((s.rows, 8), dtype=torch.int32)
        bh = torch.zeros((s.rows // 128, s.cols // 128, 2),
                         dtype=torch.int32)
        tstats.stats_from_counts_into_reference(
            counts, cls[ia], cls[ja], rs, bh, i_off=s.r0, j_off=s.r0, n=n,
            threshold=THR, tile=128)
        _same_as_real_indices(rs, bh, counts, cls, ia, ja, n, True)


@pytest.mark.parametrize("layout,shape", [("2d", (2, 3)), ("kaxis", 4)])
def test_components_and_doc_freqs_shard_over_every_device(layout, shape):
    from uniprot_kmer_based_clustering_tpu.models.components import (
        connected_components_sharded as jcc,
    )
    from uniprot_kmer_based_clustering_tpu_torch.models.components import (
        connected_components,
        connected_components_sharded,
    )

    rng = np.random.default_rng(11)
    n = 400
    i = rng.integers(0, n, 250)
    j = rng.integers(0, n, 250)
    pairs = np.stack([np.minimum(i, j), np.maximum(i, j),
                      np.ones_like(i)], 1).astype(np.int32)
    mesh = _tmesh(layout, shape)
    got = connected_components_sharded(mesh, pairs, n)
    assert np.array_equal(got, connected_components(n, pairs))
    assert np.array_equal(got, jcc(_jmesh(layout, shape), pairs, n))
    codes = rng.integers(0, 21 ** 5, (24, 30)).astype(np.int32)
    valid = rng.random((24, 30)) < 0.8
    freq = tsh.doc_freq_psum(mesh, codes, valid, 5).numpy()
    want = np.zeros(21 ** 5, np.int64)
    for row, ok in zip(codes, valid):
        np.add.at(want, np.unique(row[ok]), 1)
    assert np.array_equal(freq, want)


def _synth_fasta(path, n):
    from bench_scale import synth_proteins

    seq_buf, offsets, classes = synth_proteins(n, seed=3)
    with open(path, "w") as f:
        for i in range(n):
            seq = seq_buf[offsets[i] : offsets[i + 1]].tobytes().decode()
            f.write(f">S{i:05d}|FEATURES|UNIPROT|c{classes[i]}|g{i}\n{seq}\n")
    return str(path)


@pytest.fixture(scope="module")
def synth400(tmp_path_factory):
    return _synth_fasta(tmp_path_factory.mktemp("synth") / "s.fasta", 400)


@pytest.mark.parametrize("mode", ["two_pass", "fused", "csr"])
@pytest.mark.parametrize("layout,shape", [("2d", (2, 2)), ("kaxis", 4)])
@pytest.mark.parametrize("corpus", ["toy", "synth"])
def test_run_pipeline_on_a_layout_matches_jax(corpus, layout, shape, mode,
                                              toy_fasta, synth400):
    """run_pipeline(mesh=...) against the JAX pipeline on the same layout:
    pairs, parity counters and component labels. csr is the packless run
    (engine="stream" with the CSR source): both packages stage the shards
    on the devices from the incidence lists, and neither builds the dense
    matrix."""
    from uniprot_kmer_based_clustering_tpu.config import (
        PipelineConfig as JConfig,
    )
    from uniprot_kmer_based_clustering_tpu.pipeline import (
        run_pipeline as jrun,
    )
    from uniprot_kmer_based_clustering_tpu_torch import PipelineConfig
    from uniprot_kmer_based_clustering_tpu_torch.kmers.bitset import (
        VirtualBitsetMatrix,
    )
    from uniprot_kmer_based_clustering_tpu_torch.pipeline import (
        run_pipeline,
    )

    fasta = toy_fasta if corpus == "toy" else synth400
    kw = dict(threshold=3, tile=16, word_block=128, **{
        "two_pass": {}, "fused": dict(extract="fused"),
        "csr": dict(engine="stream", stream_source="csr")}[mode])
    want = jrun(fasta, JConfig(**kw), mesh=_jmesh(layout, shape))
    got = run_pipeline(fasta, PipelineConfig(**kw),
                       mesh=_tmesh(layout, shape))
    assert got.parity_report() == want.parity_report()
    assert np.array_equal(got.pairwise.pairs, want.pairwise.pairs)
    assert np.array_equal(got.cluster_labels, want.cluster_labels)
    assert len(got.pairwise.pairs) > 0
    assert isinstance(got.bitset, VirtualBitsetMatrix) == (mode == "csr")


@pytest.mark.parametrize("layout,shape", [("2d", (2, 2)), ("kaxis", 2)])
def test_stream_engine_with_the_host_source_raises_on_a_layout(
        layout, shape, toy_fasta):
    """The JAX pipeline's ValueError, before any work."""
    from uniprot_kmer_based_clustering_tpu_torch import PipelineConfig
    from uniprot_kmer_based_clustering_tpu_torch.pipeline import (
        run_pipeline,
    )

    with pytest.raises(ValueError, match="requires stream_source='csr'"):
        run_pipeline(toy_fasta, PipelineConfig(engine="stream"),
                     mesh=_tmesh(layout, shape))
