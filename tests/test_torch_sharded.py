"""The port's flat row ring (``parallel/``) against the JAX package's on
the CPU: the JAX side runs on the 8 virtual CPU devices of
``tests/conftest.py``, the port on D CPU shards. Inputs are seeded numpy;
tolerance 0 (row_stats row by row, tile hits, pair lists, labels,
doc-freqs, bitset words).

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
from uniprot_kmer_based_clustering_tpu_torch.parallel import mesh as tmesh
from uniprot_kmer_based_clustering_tpu_torch.parallel import sharded as tsh

THR = 4
SUM_LANES = [0, 1, 2, 4, 5, 6]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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


def _n_pad(d):
    """1024 rows for D dividing 8; D × 256 otherwise (the JAX odd-D
    tests' padding)."""
    return 1024 if 8 % d == 0 else d * 128 * 2


def _cpu_mesh(d):
    return tmesh.make_mesh(d, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_sweep(d, weighted=False):
    bs, classes, n = _problem(_n_pad(d))
    return jpar.sharded_pairwise_similarity(
        jpar.make_mesh(d), bs.words, classes, n, 40 if weighted else THR,
        block_tile=128, weights=_weights(bs) if weighted else None,
    )


@functools.lru_cache(maxsize=None)
def _jax_extract(d):
    bs, classes, n = _problem(_n_pad(d))
    return jpar.sharded_extract_pairs(
        jpar.make_mesh(d), bs.words, classes, n, THR, block_tile=128
    )


def _weights(bs):
    return np.random.default_rng(17).integers(
        1, 50, size=bs.w_pad * 32).astype(np.int8)


def _same_sweep(got, want):
    rs, th, (ti, tj, t) = got
    rs_w, th_w, (ti_w, tj_w, t_w) = want
    assert rs.dtype == np.int64 and np.array_equal(rs, rs_w)
    assert np.array_equal(th, th_w)
    assert np.array_equal(ti, ti_w) and np.array_equal(tj, tj_w)
    assert t == t_w


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 6, 7, 8])
def test_ring_sweep_matches_jax_row_by_row(d):
    bs, classes, n = _problem(_n_pad(d))
    got = tsh.sharded_pairwise_similarity(
        _cpu_mesh(d), bs.words, classes, n, THR, block_tile=128
    )
    _same_sweep(got, _jax_sweep(d))
    assert got[1][:, 0].sum() > 0


def test_ring_sweep_weighted_matches_jax():
    bs, classes, n = _problem(1024)
    got = tsh.sharded_pairwise_similarity(
        _cpu_mesh(4), bs.words, classes, n, 40, block_tile=128,
        weights=_weights(bs),
    )
    _same_sweep(got, _jax_sweep(4, weighted=True))


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_ring_extract_matches_jax(d):
    bs, classes, n = _problem(_n_pad(d))
    got = tsh.sharded_extract_pairs(
        _cpu_mesh(d), bs.words, classes, n, THR, block_tile=128
    )
    want = _jax_extract(d)
    assert got.dtype == np.int32 and len(got) > 1000
    assert np.array_equal(got, want)


def test_ring_extract_tile_cap_path_and_its_shortfall():
    """tile_cap selects per-sub-tile top-k compaction (the JAX TPU path):
    with the densest tile's count it is exact; below it a sub-tile is
    dropped whole and expected_total turns the shortfall into a raise."""
    bs, classes, n = _problem(1024)
    want = _jax_extract(4)
    _, th, _ = _jax_sweep(4)
    mesh = _cpu_mesh(4)
    got = tsh.sharded_extract_pairs(
        mesh, bs.words, classes, n, THR, tile_cap=int(th[:, 0].max()),
        expected_total=len(want),
    )
    assert np.array_equal(got, want)
    # bucket_pow2 floors the width at 128: a tile over it must exist
    assert int(th[:, 0].max()) > 128
    with pytest.raises(ValueError, match="sweep stats promised"):
        tsh.sharded_extract_pairs(
            mesh, bs.words, classes, n, THR, tile_cap=1,
            expected_total=len(want),
        )


def test_ring_extract_overflow_raises():
    bs, classes, n = _problem(1024)
    with pytest.raises(ValueError, match="overflow"):
        tsh.sharded_extract_pairs(
            _cpu_mesh(2), bs.words, classes, n, 0, block_tile=128, cap=64
        )


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_fused_ring_matches_jax(d):
    bs, classes, n = _problem(_n_pad(d))
    rs, th, tiles, pairs = tsh.sharded_pairwise_fused(
        _cpu_mesh(d), bs.words, classes, n, THR, block_tile=128
    )
    _same_sweep((rs, th, tiles), _jax_sweep(d))
    if d == 3:
        # no extraction is cached at D=3's padding: the JAX fused ring
        # is the reference
        want = jpar.sharded_pairwise_fused(
            jpar.make_mesh(3), bs.words, classes, n, THR, block_tile=128
        )[3]
    else:
        want = _jax_extract(d)
    assert np.array_equal(pairs, want)


@pytest.mark.parametrize("kw", [dict(k=4), dict(k=0, cap=64),
                                dict(k=512)])
def test_fused_ring_fallback_regimes_stay_exact(kw):
    """A sub-tile over k (dropped in the pass) or a cap below the total
    makes the wrapper extract again; k=512 holds every sub-tile. Each is
    equal to the JAX ring's sweep and extraction."""
    bs, classes, n = _problem(1024)
    got = tsh.sharded_pairwise_fused(
        _cpu_mesh(4), bs.words, classes, n, THR, block_tile=128, **kw
    )
    _same_sweep(got[:3], _jax_sweep(4))
    assert np.array_equal(got[3], _jax_extract(4))


def test_fused_ring_all_pairs_matches_jax():
    bs, classes, n = _problem(1024)
    got = tsh.sharded_pairwise_fused(
        _cpu_mesh(2), bs.words, classes, n, THR, cross_amr_only=False,
    )
    want = jpar.sharded_pairwise_fused(
        jpar.make_mesh(2), bs.words, classes, n, THR, block_tile=128,
        cross_amr_only=False, k=0,
    )
    _same_sweep(got[:3], want[:3])
    assert np.array_equal(got[3], want[3])
    assert len(got[3]) > len(_jax_extract(2))


def _csr_case():
    """Incidences with two ranks of one protein in one word and bit 31 of
    a word, in protein order shuffled."""
    rng = np.random.default_rng(23)
    n, k = 300, 1000
    rows, cols = np.nonzero(rng.random((n, k)) < 0.05)
    extra_r = np.array([0, 0, 0, 7, 7, 299], np.int32)
    extra_c = np.array([31, 30, 63, 0, 1, 991], np.int32)
    p = np.concatenate([rows.astype(np.int32), extra_r])
    r = np.concatenate([cols.astype(np.int32), extra_c])
    keep = np.unique(np.stack([p, r], 1), axis=0)
    order = rng.permutation(len(keep))
    return keep[order, 0], keep[order, 1], n, k


@pytest.mark.parametrize("d", [1, 3, 4])
def test_stage_mesh_inputs_csr_equals_host_pack_bitsets(d):
    p, r, n, k = _csr_case()
    want = pack_bitsets(p, r, n, k, row_multiple=d * 128, word_multiple=32)
    classes = np.arange(n, dtype=np.int32) % 3
    mesh = _cpu_mesh(d)
    words_s, classes_s = tsh.stage_mesh_inputs_csr(
        mesh, p, r, want.n_pad, want.w_pad, classes
    )
    got = torch.cat(words_s).numpy().view(np.uint32)
    assert np.array_equal(got, want.words)
    assert want.words[0, 0] & (1 << 31) and want.words[0, 0] & (1 << 30)
    full = np.full(want.n_pad, -1, np.int32)
    full[:n] = classes
    assert np.array_equal(torch.cat(classes_s).numpy(), full)
    # the ring over the device-built shards = over the packed matrix
    a = tsh.sharded_pairwise_similarity(mesh, words_s, classes_s, n, 2)
    b = tsh.sharded_pairwise_similarity(mesh, want.words, full, n, 2)
    _same_sweep(a, b)


def test_doc_freq_psum_matches_jax_and_host():
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from uniprot_kmer_based_clustering_tpu.kmers.encode import (
        encode_kmers_device,
    )

    rng = np.random.default_rng(9)
    n_prot, lmax = 32, 40
    seqs = rng.integers(0, 21, (n_prot, lmax)).astype(np.int32)
    lengths = rng.integers(10, lmax + 1, n_prot).astype(np.int32)
    codes, valid = encode_kmers_device(jnp.asarray(seqs),
                                       jnp.asarray(lengths), 5)
    codes, valid = np.asarray(codes), np.asarray(valid)
    jm = jpar.make_mesh(8)
    want = np.asarray(jpar.doc_freq_psum(
        jm, jax.device_put(codes, NamedSharding(jm, P("p", None))),
        jax.device_put(valid, NamedSharding(jm, P("p", None))), 5,
    ))
    for d in (1, 8):
        got = tsh.doc_freq_psum(_cpu_mesh(d), codes, valid, 5)
        assert np.array_equal(got.numpy(), want)
    host = {}
    for i in range(n_prot):
        ks = {int(c) for c, v in zip(codes[i], valid[i]) if v}
        for c in ks:
            host[c] = host.get(c, 0) + 1
    assert {int(c): int(want[c]) for c in np.nonzero(want)[0]} == host


@pytest.mark.parametrize("d", [1, 3, 8])
def test_connected_components_sharded_matches_jax_and_union_find(d):
    from uniprot_kmer_based_clustering_tpu.models.components import (
        connected_components_sharded as jcc,
    )
    from uniprot_kmer_based_clustering_tpu_torch.models.components import (
        connected_components,
        connected_components_sharded,
    )

    rng = np.random.default_rng(d)
    n = 400
    i = rng.integers(0, n, 250)
    j = rng.integers(0, n, 250)
    pairs = np.stack([np.minimum(i, j), np.maximum(i, j),
                      np.ones_like(i)], 1).astype(np.int32)
    got = connected_components_sharded(_cpu_mesh(d), pairs, n)
    assert got.dtype == np.int32
    assert np.array_equal(got, connected_components(n, pairs))
    assert np.array_equal(got, jcc(jpar.make_mesh(d), pairs, n))
    assert len(np.unique(got)) < n


def test_ring_shift_returns_new_buffers_on_the_same_device():
    mesh = tmesh.make_mesh(devices=["cpu"] * 3)
    blocks = [torch.full((4, 2), v, dtype=torch.int32) for v in range(3)]
    old = list(blocks)
    moving = tmesh.ring_shift(list(blocks), mesh)
    assert [int(b[0, 0]) for b in moving] == [1, 2, 0]
    for m in moving:
        assert all(m.data_ptr() != o.data_ptr() for o in old)
    for m in moving:
        m.add_(100)  # an in-place op on a moving block ...
    assert [int(b[0, 0]) for b in old] == [0, 1, 2]  # ... touches no other
    assert int(tmesh.sum_to_first(old, mesh)[0, 0]) == 3
    assert tmesh.gather_to_first(old, mesh).shape == (12, 2)


def test_make_mesh_devices_and_refusals():
    m = tmesh.make_mesh(4, device="cpu")
    assert m.size == 4 and m.axis_names == ("p",)
    assert tmesh.make_mesh(devices=["cpu", "cpu"]).size == 2
    with pytest.raises(ValueError, match="devices listed"):
        tmesh.make_mesh(3, devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tmesh.make_mesh(2)
    assert tmesh.pad_for_mesh(10619, 8, 128) == 11264


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 6, 7, 8])
def test_ring_schedule_covers_each_pair_once(d):
    """Every pair i<j of N_pad rows lies in exactly one sub-step (in
    either orientation), for half blocks on and off the tile grid."""
    for tiles in (2, 3):  # h = block/2 on the grid, and not
        bt = 4
        block = tiles * bt
        n_pad = d * block
        seen = np.zeros((n_pad, n_pad), np.int64)
        for step in tsh.ring_schedule(d, block, bt):
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
        assert np.array_equal(seen, np.triu(np.ones_like(seen), 1))
        assert tsh.count_substeps(d, n_pad, bt) == sum(
            len(subs) for step in tsh.ring_schedule(d, block, bt)
            for subs in step)


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_k1_at_fake_offsets_equals_the_plain_epilogue_at_real_indices(d):
    """On every sub-step of the last device (a diagonal strip, wrapped
    block pairs, split halves), K1's plain version at the ring's fake
    offsets equals the plain masked statistics at the real global
    indices (valid = gi < n, gj < n, and gi < gj on the diagonal)."""
    from uniprot_kmer_based_clustering_tpu_torch.ops.bitmul import (
        counts_window_pair,
    )

    bs, classes, n = _problem(_n_pad(d))
    words = torch.from_numpy(bs.words.view(np.int32))
    cls = torch.from_numpy(classes)
    block = bs.n_pad // d
    dev = d - 1
    subs = [s for step in tsh.ring_schedule(d, block, 128)
            for s in step[dev]]
    assert any(s.triangle for s in subs)
    for s in subs:
        ia = np.arange(s.gi0, s.gi0 + s.rows)
        ja = np.arange(s.gj0, s.gj0 + s.cols)
        counts = counts_window_pair(words[ia], words[ja])
        i_off, j_off = tsh.fake_offsets(s)
        rs, bh = tstats.stats_from_counts_traced_reference(
            counts, cls[ia], cls[ja], i_off, j_off, n=tsh.FAKE_N,
            threshold=THR, tile=128,
        )
        gi, gj = torch.from_numpy(ia)[:, None], torch.from_numpy(ja)[None]
        valid = (gi < n) & (gj < n)
        if s.triangle:
            valid &= gi < gj
        cross = valid & (cls[ia][:, None] != cls[ja][None, :])
        want, over_c, over_s = tstats.stack_row_stats(
            counts, cross, valid & ~cross, THR)
        assert torch.equal(rs, want)
        nb = s.rows // 128, 128, s.cols // 128, 128
        assert torch.equal(bh[..., 0], over_c.reshape(nb).sum((1, 3)).int())
        assert torch.equal(bh[..., 1], over_s.reshape(nb).sum((1, 3)).int())


def test_word_chunked_ring_equals_whole(monkeypatch):
    """Under a small unpack budget the products run in word chunks; the
    statistics and pairs do not change."""
    bs, classes, n = _problem(1024)
    mesh = _cpu_mesh(4)
    assert tsh.ring_word_chunk(256, 128) == 0
    monkeypatch.setattr(tsh, "RING_UNPACK_BYTES", 256 * 2 * 32 * 24)
    assert tsh.ring_word_chunk(256, 128, tsh.RING_UNPACK_BYTES) == 16
    got = tsh.sharded_pairwise_fused(mesh, bs.words, classes, n, THR)
    _same_sweep(got[:3], _jax_sweep(4))
    assert np.array_equal(got[3], _jax_extract(4))


def test_rows_past_n_must_be_zero():
    bs, classes, n = _problem(1024)
    words = bs.words.copy()
    words[n + 3, 0] = 1
    with pytest.raises(ValueError, match="all-zero"):
        tsh.sharded_pairwise_similarity(_cpu_mesh(4), words, classes, n,
                                        THR)


def _synth_fasta(path, n):
    from bench_scale import synth_proteins

    seq_buf, offsets, classes = synth_proteins(n, seed=3)
    with open(path, "w") as f:
        for i in range(n):
            seq = seq_buf[offsets[i] : offsets[i + 1]].tobytes().decode()
            f.write(f">S{i:05d}|FEATURES|UNIPROT|c{classes[i]}|g{i}\n{seq}\n")
    return str(path)


@pytest.mark.parametrize("corpus,d", [("toy", 4), ("synth", 3)])
@pytest.mark.parametrize("mode", ["two_pass", "fused", "csr"])
def test_run_pipeline_on_a_mesh_matches_jax(corpus, d, mode, toy_fasta,
                                            tmp_path):
    """run_pipeline(mesh=...) against the JAX pipeline on its mesh: pairs,
    parity counters and component labels. csr is the packless run: on the
    flat mesh both packages take the out-of-core stream composition
    (``parallel/stream_mesh.py``)."""
    from uniprot_kmer_based_clustering_tpu.config import (
        PipelineConfig as JConfig,
    )
    from uniprot_kmer_based_clustering_tpu.pipeline import (
        run_pipeline as jrun,
    )
    from uniprot_kmer_based_clustering_tpu_torch import PipelineConfig
    from uniprot_kmer_based_clustering_tpu_torch.pipeline import (
        run_pipeline,
    )

    fasta = toy_fasta if corpus == "toy" else _synth_fasta(
        tmp_path / "s.fasta", 400)
    kw = dict(threshold=3, tile=16, word_block=128)
    stream = dict(engine="stream", stream_source="csr")
    want = jrun(fasta, JConfig(**kw, **(stream if mode == "csr" else
                                        {"two_pass": {},
                                         "fused": dict(extract="fused")}[mode])),
                mesh=jpar.make_mesh(d))
    got = run_pipeline(fasta, PipelineConfig(**kw, **(
        stream if mode == "csr" else
        dict(extract="fused") if mode == "fused" else {})),
        mesh=_cpu_mesh(d))
    assert got.parity_report() == want.parity_report()
    pairwise, labels = got.pairwise, got.cluster_labels
    assert np.array_equal(pairwise.pairs, want.pairwise.pairs)
    assert np.array_equal(labels, want.cluster_labels)
    assert len(pairwise.pairs) > 0


@pytest.mark.parametrize("source,exc", [("host", ValueError)])
def test_run_pipeline_refuses_the_stream_engine_on_a_mesh(source, exc,
                                                          toy_fasta):
    """With the host block source the JAX pipeline refuses the stream
    engine on every mesh; so does the port, before any work."""
    from uniprot_kmer_based_clustering_tpu_torch import PipelineConfig
    from uniprot_kmer_based_clustering_tpu_torch.pipeline import (
        run_pipeline,
    )

    with pytest.raises(exc, match="requires stream_source='csr'"):
        run_pipeline(toy_fasta, PipelineConfig(engine="stream",
                                               stream_source=source),
                     mesh=_cpu_mesh(2))
