"""The port's query serving (similarity/query.py, kmers/append.py,
``cli query``) against the JAX package's, on the CPU.

The toy FASTA goes through the JAX pipeline once; its index and bitset
(and numpy weights made from a seed) are handed to the JAX
``QueryServer`` and to the port's (``device="cpu"``: the plain torch
contraction and epilogue in device and stream mode, the rank-CSR walk in
host mode). JAX's device and stream modes run on XLA:CPU.

Tolerance: exact equality (int64 match arrays in their order, int32 and
uint32 arrays, error messages, stdout bytes).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
from uniprot_kmer_based_clustering_tpu.kmers import append as jappend
from uniprot_kmer_based_clustering_tpu.kmers import encode as jencode
from uniprot_kmer_based_clustering_tpu.kmers import index as jindex
from uniprot_kmer_based_clustering_tpu.kmers.bitset import pack_bitsets
from uniprot_kmer_based_clustering_tpu.pipeline import run_pipeline as jrun
from uniprot_kmer_based_clustering_tpu.similarity import query as jq
from uniprot_kmer_based_clustering_tpu.utils.blosum import rank_weights_int8
from uniprot_kmer_based_clustering_tpu_torch import config as tconfig
from uniprot_kmer_based_clustering_tpu_torch.kmers import append as tappend
from uniprot_kmer_based_clustering_tpu_torch.kmers import encode as tencode
from uniprot_kmer_based_clustering_tpu_torch.kmers import index as tindex
from uniprot_kmer_based_clustering_tpu_torch.kmers import bitset as tbitset
from uniprot_kmer_based_clustering_tpu_torch.parallel.mesh import make_mesh
from uniprot_kmer_based_clustering_tpu_torch.pipeline import run_pipeline as trun
from uniprot_kmer_based_clustering_tpu_torch.similarity import query as tq

CPU = "cpu"
CFG = dict(tile=16, strip=32, word_block=128, engine="xla", threshold=2,
           cross_amr_only=False)


class Toy:
    """The toy corpus through the JAX pipeline, its query batch, and the
    JAX answers of the module, each computed on first use."""

    def __init__(self, fasta):
        self.fasta = fasta
        self.res = jrun(fasta, PipelineConfig(**CFG))
        self.index, self.bitset = self.res.index, self.res.bitset
        self.table = self.res.table
        self.batch = [self.table.seq(i) for i in (0, 7, 3)] + ["MKT"]
        self.blosum = rank_weights_int8(self.index.repeated_codes, 5,
                                        self.bitset.w_pad * 32)
        self._cache = {}

    def weights(self, weighted):
        return self.blosum if weighted else None

    def jax(self, weighted=False, threshold=1, mode="host", batch=None,
            top=None, **kw):
        key = (weighted, threshold, mode, repr(batch), top,
               tuple(sorted(kw.items())))
        if key not in self._cache:
            srv = jq.QueryServer(self.index, self.bitset,
                                 weights=self.weights(weighted), mode=mode,
                                 **kw)
            self._cache[key] = srv.query(batch or self.batch,
                                         threshold=threshold, top=top)
        return self._cache[key]

    def torch_server(self, weighted=False, **kw):
        return tq.QueryServer(self.index, self.bitset,
                              weights=self.weights(weighted), device=CPU,
                              **kw)


@pytest.fixture(scope="module")
def toy(toy_fasta):
    return Toy(toy_fasta)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int64 and g.shape[1:] == (2,)
        assert np.array_equal(g, w)


def test_host_helpers_are_the_jax_packages(toy):
    """seqs_to_buffer (latin-1, unknown bytes kept), rank_of, query_ranks
    and pack_query_bitsets."""
    seqs = toy.batch + ["MK@3xZJ\xe9", ""]
    for a, b in zip(tencode.seqs_to_buffer(seqs),
                    jencode.seqs_to_buffer(seqs)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    codes = np.concatenate([toy.index.repeated_codes[::7],
                            toy.index.codes[:50], [0, 21**5 - 1]])
    tidx = tindex.KmerIndex(**{f.name: getattr(toy.index, f.name)
                               for f in dataclasses.fields(toy.index)})
    assert np.array_equal(tidx.rank_of(codes), toy.index.rank_of(codes))
    empty = dataclasses.replace(tidx, repeated_codes=np.zeros(0, np.int64))
    assert np.array_equal(empty.rank_of(codes), np.full(codes.shape, -1))
    for a, b in zip(tq.query_ranks(tidx, seqs),
                    jq.query_ranks(toy.index, seqs)):
        assert np.array_equal(a, b)
    got = tq.pack_query_bitsets(tidx, seqs, toy.bitset.w_pad)
    want = jq.pack_query_bitsets(toy.index, seqs, toy.bitset.w_pad)
    assert got.dtype == np.uint32 and np.array_equal(got, want)
    assert got.any()


@pytest.mark.parametrize("cap", [0, 1, 512])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["host", "device", "auto"])
def test_modes_match_jax(toy, mode, weighted, cap):
    """Every resident mode and capacity against the JAX host answers and
    the JAX device server's (XLA:CPU): cap 1 overflows on every multi-hit
    query (the exact redo), cap 0 and a toy n_pad of 64 (2·512+1 ≥ n_pad)
    take the full counts."""
    got = toy.torch_server(weighted, mode=mode, topk_cap=cap).query(
        toy.batch, threshold=1)
    _same(got, toy.jax(weighted))
    _same(got, toy.jax(weighted, mode="device"))
    assert any(m.shape[0] for m in got)


@pytest.mark.parametrize("sbs,cap", [(16, 512), (16, 1), ("n_pad", 2),
                                     (24, 3)])
@pytest.mark.parametrize("source", ["host", "csr", "auto"])
def test_stream_matches_jax(toy, source, sbs, cap):
    """Stream mode from each block source: several blocks of 16 rows,
    one block of n_pad rows, and 24-row blocks whose last one runs past
    n_pad; the per-block top-k redo at caps 1–3."""
    sbs = toy.bitset.n_pad if sbs == "n_pad" else sbs
    srv = toy.torch_server(mode="stream", stream_bs=sbs, topk_cap=cap,
                           stream_source=source)
    got = srv.query(toy.batch, threshold=1)
    _same(got, toy.jax())
    _same(got, toy.jax(mode="stream", stream_bs=sbs, topk_cap=cap,
                       stream_source=source))
    assert srv.stream_trace["uploads"] >= -(-toy.bitset.n_pad // sbs)


@pytest.mark.parametrize("source", ["host", "csr"])
def test_weighted_stream_matches_jax(toy, source):
    srv = toy.torch_server(True, mode="stream", stream_bs=16, topk_cap=1,
                           stream_source=source)
    _same(srv.query(toy.batch, threshold=1), toy.jax(True))


@pytest.mark.parametrize("threshold", [1, 10, -1, "all"])
@pytest.mark.parametrize("mode", ["device", "stream"])
def test_thresholds_match_jax(toy, mode, threshold):
    """A negative threshold admits count-0 corpus rows but never the
    n_pad padding rows (the epilogue's col < n mask); "all" sits below
    every count of the batch."""
    if threshold == "all":
        hcounts = toy.torch_server(mode="host")._counts_host(toy.batch)
        threshold = int(hcounts.min()) - 1
    kw = dict(stream_bs=24) if mode == "stream" else {}
    got = toy.torch_server(mode=mode, topk_cap=toy.bitset.n_pad,
                           **kw).query(toy.batch, threshold=threshold)
    want = toy.jax(threshold=threshold)
    _same(got, want)
    if threshold < 0:
        assert all(m.shape[0] == toy.table.n for m in got)


@pytest.mark.parametrize("mode", ["device", "stream"])
def test_negative_int8_weights_match_jax(toy, mode):
    """Arbitrary user weights may be negative and thresholds below −1:
    the INT32_MIN sentinel must rank under every real hit. The bitset is
    repacked at 512 rows so that the epilogue runs (2·cap+1 < n_pad) with
    every corpus row a hit and nhits == n ≤ cap."""
    bs512 = pack_bitsets(toy.index.incidence_protein,
                         toy.index.incidence_rank, toy.table.n,
                         toy.index.n_repeated)
    wneg = np.random.default_rng(0).integers(
        -5, 6, size=bs512.w_pad * 32).astype(np.int8)
    jh = jq.QueryServer(toy.index, bs512, weights=wneg, mode="host")
    hcounts = jh._counts_host(toy.batch)
    t_all = int(hcounts.min()) - 1
    assert (hcounts < -1).any()
    cap = bs512.n
    assert 2 * cap + 1 < bs512.n_pad
    kw = dict(stream_bs=bs512.n_pad) if mode == "stream" else {}
    srv = tq.QueryServer(toy.index, bs512, weights=wneg, mode=mode,
                         topk_cap=cap, device=CPU, **kw)
    got = srv.query(toy.batch, threshold=t_all)
    _same(got, jh.query(toy.batch, threshold=t_all))
    _same(got, jq.QueryServer(toy.index, bs512, weights=wneg,
                              mode="device", topk_cap=cap).query(
        toy.batch, threshold=t_all))


@pytest.mark.parametrize("mode", ["host", "device", "stream"])
def test_top_matches_jax(toy, mode):
    kw = dict(stream_bs=16) if mode == "stream" else {}
    srv = toy.torch_server(mode=mode, **kw)
    _same(srv.query(toy.batch, threshold=1, top=2), toy.jax(top=2))
    h = srv.query_async(toy.batch, threshold=1)
    _same(srv.query_wait(h, top=2), toy.jax(top=2))


@pytest.mark.parametrize("kw", [
    dict(mode="device"), dict(mode="device", topk_cap=1),
    dict(mode="device", topk_cap=0), dict(mode="host"),
    dict(mode="stream", stream_bs=16, stream_source="host"),
    dict(mode="stream", stream_bs=16, stream_source="csr", topk_cap=1),
], ids=["device", "cap1", "cap0", "host", "stream-host", "stream-csr"])
def test_async_matches_sync(toy, kw):
    """Several batches in flight through query_async/query_wait answer
    exactly like sequential query() calls and like the JAX server."""
    batches = [
        [toy.table.seq(i) for i in (0, 3)],
        [toy.table.seq(7), "MKT", toy.table.seq(1)],
        ["WWWWWWYYYYYYWWWWWW"],
    ]
    srv = toy.torch_server(**kw)
    seq_ans = [srv.query(b, threshold=1) for b in batches]
    handles = [srv.query_async(b, threshold=1) for b in batches]
    for sa, h, b in zip(seq_ans, handles, batches):
        pa = srv.query_wait(h)
        _same(pa, sa)
        _same(pa, toy.jax(batch=b))
    assert srv.query_wait(srv.query_async([])) == []
    assert srv.query([]) == []


def test_latency_route(toy):
    """Batches of ≤ host_route_max queries take the rank-CSR walk, and the
    walk runs in query_wait (the handle only keeps the sequences); bigger
    batches and explicit device servers keep the device path; weighted
    routing agrees too."""
    seqs = [toy.table.seq(0)]
    routed = toy.torch_server(mode="device", host_route_max=2)
    h = routed.query_async(seqs, threshold=1)
    assert set(h) == {"nq", "threshold", "host_seqs"}
    assert not routed._host_csr_built
    _same(routed.query_wait(h), toy.jax(batch=seqs))
    assert routed._host_csr_built
    batch5 = [toy.table.seq(i) for i in range(5)]
    h2 = routed.query_async(batch5, threshold=1)
    assert "host_seqs" not in h2
    _same(routed.query_wait(h2), toy.jax(batch=batch5))
    dev = toy.torch_server(mode="device")
    assert "host_seqs" not in dev.query_async(seqs, threshold=1)
    auto = tq.QueryServer(toy.index, toy.bitset, device=CPU)
    assert auto._host_mode and auto._host_route_max == 4
    rw = toy.torch_server(True, mode="device", host_route_max=1)
    assert "host_seqs" in rw.query_async(seqs, threshold=1)
    _same(rw.query(seqs, threshold=1), toy.jax(True, batch=seqs))
    dev.set_host_route_max(3)
    assert "host_seqs" in dev.query_async(seqs, threshold=1)
    dev.set_host_route_max(0)
    assert "host_seqs" not in dev.query_async(seqs, threshold=1)


def test_query_shared_kmers_matches_jax(toy):
    for w in (False, True):
        got = tq.query_shared_kmers(toy.index, toy.bitset, toy.batch,
                                    threshold=1, weights=toy.weights(w),
                                    top=3, device=CPU)
        want = jq.query_shared_kmers(toy.index, toy.bitset, toy.batch,
                                     threshold=1, weights=toy.weights(w),
                                     top=3)
        _same(got, want)


def test_self_queries_reproduce_the_pair_list(toy):
    """Every corpus sequence as a query on a device server: the self
    match is the row's popcount, and the i<j matches are the JAX batch
    sweep's pair list exactly."""
    srv = toy.torch_server(mode="device")
    thr = CFG["threshold"]
    allq = srv.query([toy.table.seq(i) for i in range(toy.table.n)],
                     threshold=thr)
    words = np.asarray(toy.bitset.words)
    got = set()
    for i, m in enumerate(allq):
        self_cnt = int(np.bitwise_count(words[i]).sum())
        assert {int(j) for j, _ in m if j == i} == (
            {i} if self_cnt > thr else set())
        got |= {(min(i, int(j)), max(i, int(j)), int(c)) for j, c in m
                if j != i}
    assert got == {tuple(int(v) for v in p) for p in toy.res.pairwise.pairs}


def test_canonical_lane_sort_contract():
    """Count desc, index asc on ties, INT32_MIN sentinels last (bitwise
    NOT keys are overflow-safe where negation is not); and the same lanes
    as the JAX sort on random ties."""
    sent = np.iinfo(np.int32).min
    vals = torch.tensor([[5, 7, sent, 7, 5, sent]], dtype=torch.int32)
    idx = torch.tensor([[9, 4, 0, 2, 3, 1]], dtype=torch.int32)
    v, i = tq.canonical_lane_sort(vals, idx)
    assert v.tolist()[0] == [7, 7, 5, 5, sent, sent]
    assert i.tolist()[0] == [2, 4, 3, 9, 0, 1]
    rng = np.random.default_rng(4)
    rv = rng.integers(-3, 3, (6, 40)).astype(np.int32)
    rv[rng.random(rv.shape) < 0.3] = sent
    ri = np.stack([rng.permutation(1000)[:40] for _ in range(6)]).astype(
        np.int32)
    v, i = tq.canonical_lane_sort(torch.from_numpy(rv), torch.from_numpy(ri))
    jv, ji = jq._canonical_lane_sort(rv, ri)
    assert np.array_equal(v.numpy(), np.asarray(jv))
    assert np.array_equal(i.numpy(), np.asarray(ji))


def test_refusals(toy):
    with pytest.raises(ValueError, match="unknown mode"):
        toy.torch_server(mode="gpu")
    with pytest.raises(ValueError, match="unknown stream_source"):
        toy.torch_server(mode="stream", stream_source="disk")
    with pytest.raises(ValueError, match="single-device"):
        toy.torch_server(mode="stream", mesh=make_mesh(2, device=CPU))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tq.QueryServer(toy.index, toy.bitset)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tq.query_shared_kmers(toy.index, toy.bitset, toy.batch)


def test_device_built_index_refuses_what_needs_incidences(toy):
    """An index without incidence lists (the device build's) serves in
    device and host-words stream mode, and raises the JAX errors for the
    host mode, the csr source, latency routing and appends."""
    j_dev = jindex.KmerIndex.from_sparse_freq(toy.index.codes,
                                              toy.index.doc_freq, 5)
    t_dev = tindex.KmerIndex.from_sparse_freq(toy.index.codes,
                                              toy.index.doc_freq, 5)
    _same(tq.QueryServer(t_dev, toy.bitset, device=CPU).query(
        toy.batch, threshold=1), toy.jax())
    _same(tq.QueryServer(t_dev, toy.bitset, mode="stream", stream_bs=16,
                         device=CPU).query(toy.batch, threshold=1),
          toy.jax())
    def refusals(server, index):
        return [
            lambda: server(index, toy.bitset, mode="host"),
            lambda: server(index, toy.bitset, mode="stream",
                           stream_source="csr"),
            lambda: server(index, toy.bitset, mode="device")
            .set_host_route_max(2),
            lambda: server(index, toy.bitset, mode="device")
            .add_proteins(["MKTAYIAKQR"]),
        ]

    def tserver(*a, **kw):
        return tq.QueryServer(*a, device=CPU, **kw)

    for jcase, tcase in zip(refusals(jq.QueryServer, j_dev),
                            refusals(tserver, t_dev)):
        with pytest.raises(ValueError) as jerr:
            jcase()
        with pytest.raises(ValueError) as terr:
            tcase()
        assert str(terr.value) == str(jerr.value)


# ---- appends ---------------------------------------------------------

def _build(mod_encode, mod_index, mod_bitset, seqs, k=5):
    buf, off = mod_encode.seqs_to_buffer(seqs)
    codes, koff = mod_encode.encode_kmers(buf, off, k, engine="numpy")
    idx = mod_index.build_index(codes, koff, k, engine="numpy")
    bs = mod_bitset.pack_bitsets(idx.incidence_protein, idx.incidence_rank,
                                 len(seqs), idx.n_repeated)
    return idx, bs


def _tbuild(seqs):
    return _build(tencode, tindex, tbitset, seqs)


def _jbuild(seqs):
    from uniprot_kmer_based_clustering_tpu.kmers import bitset as jbitset

    return _build(jencode, jindex, jbitset, seqs)


def _same_index(a, b):
    for f in dataclasses.fields(jindex.KmerIndex):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert np.array_equal(np.asarray(x), np.asarray(y)), f.name


@pytest.fixture(scope="module")
def toy_seqs(toy):
    return [toy.table.seq(i) for i in range(toy.table.n)]


@pytest.mark.parametrize("splits", [(40,), (25, 45), (10, 11, 59)])
def test_append_to_index_matches_jax_and_rebuild(toy_seqs, splits):
    """append(A+B) ≡ rebuild(A∪B) bit for bit, chained too, docfreq
    promotion included; the port's append equals the JAX append."""
    bounds = list(splits) + [len(toy_seqs)]
    t_idx, t_bs = _tbuild(toy_seqs[: bounds[0]])
    j_idx, j_bs = _jbuild(toy_seqs[: bounds[0]])
    promoted = np.intersect1d(t_idx.codes[t_idx.doc_freq == 1],
                              _tbuild(toy_seqs)[0].repeated_codes)
    assert promoted.shape[0] > 0
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        t_idx, t_bs = tappend.append_to_index(t_idx, t_bs, toy_seqs[lo:hi])
        j_idx, j_bs = jappend.append_to_index(j_idx, j_bs, toy_seqs[lo:hi])
        _same_index(t_idx, j_idx)
        assert np.array_equal(t_bs.words, j_bs.words)
    f_idx, f_bs = _tbuild(toy_seqs)
    _same_index(t_idx, f_idx)
    assert (t_bs.n, t_bs.n_bits) == (f_bs.n, f_bs.n_bits)
    assert np.array_equal(t_bs.words, f_bs.words)


def test_append_promotion_explicit():
    """k-mer WWWWW unique to protein 0 becomes repeated when the appended
    protein carries it: protein 0's bit appears in the new rank space."""
    a = ["CCCCCCCCWWWWW", "CCCCCCCCYFYFY"]
    idx, bs = _tbuild(a)
    w = tencode.AMINO_ACIDS.index("W")
    code = np.array([sum(w * 21**p for p in range(5))])
    assert idx.rank_of(code)[0] == -1
    idx2, bs2 = tappend.append_to_index(idx, bs, ["MMWWWWWMM"])
    r = idx2.rank_of(code)[0]
    assert r >= 0 and bs2.row_bits(0)[r] and bs2.row_bits(2)[r]
    assert not bs2.row_bits(1)[r]
    f_idx, f_bs = _tbuild(a + ["MMWWWWWMM"])
    _same_index(idx2, f_idx)
    assert np.array_equal(bs2.words, f_bs.words)


def test_append_errors_are_the_jax_packages(toy_seqs):
    t_idx, t_bs = _tbuild(toy_seqs[:10])
    j_idx, j_bs = _jbuild(toy_seqs[:10])
    same_idx, same_bs = tappend.append_to_index(t_idx, t_bs, [])
    assert same_idx is t_idx and same_bs is t_bs
    cases = [
        lambda i: dataclasses.replace(i, unique_owner=None),
        lambda i: type(i).from_sparse_freq(i.codes, i.doc_freq, i.k),
        lambda i: dataclasses.replace(i, sampling="random10"),
    ]
    for case in cases:
        with pytest.raises(ValueError) as jerr:
            jappend.append_to_index(case(j_idx), j_bs, toy_seqs[10:12])
        with pytest.raises(ValueError) as terr:
            tappend.append_to_index(case(t_idx), t_bs, toy_seqs[10:12])
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("mode", ["host", "device", "stream"])
def test_add_proteins_matches_jax(toy_seqs, mode):
    """The new-vs-all report equals the JAX server's, and the appended
    server answers like a fresh one over the union."""
    t_idx, t_bs = _tbuild(toy_seqs[:40])
    j_idx, j_bs = _jbuild(toy_seqs[:40])
    kw = dict(stream_bs=16) if mode == "stream" else {}
    srv = tq.QueryServer(t_idx, t_bs, mode=mode, device=CPU, **kw)
    report = srv.add_proteins(toy_seqs[40:], threshold=3)
    jsrv = jq.QueryServer(j_idx, j_bs, mode="host")
    want = jsrv.add_proteins(toy_seqs[40:], threshold=3)
    assert report.dtype == np.int64 and len(report) > 0
    assert np.array_equal(report, want)
    probe = [toy_seqs[0], toy_seqs[45], "MKT"]
    f_idx, f_bs = _tbuild(toy_seqs)
    fresh = tq.QueryServer(f_idx, f_bs, mode="host", device=CPU)
    _same(srv.query(probe, threshold=3), fresh.query(probe, threshold=3))
    _same(srv.query(probe, threshold=3), jsrv.query(probe, threshold=3))
    w = np.ones(srv.bitset.w_pad * 32, np.int8)
    wsrv = tq.QueryServer(srv.index, srv.bitset, weights=w, mode=mode,
                          device=CPU, **kw)
    with pytest.raises(ValueError, match="weighted"):
        wsrv.add_proteins(toy_seqs[:2])


_SERVING_STATE = {"host": "_build_host_csr", "device": "_build_device_blocks",
             "stream": "_build_stream_source"}


@pytest.mark.parametrize("mode", ["host", "device", "stream"])
def test_add_proteins_rollback_on_rebuild_failure(toy_seqs, monkeypatch,
                                                  mode):
    """A failing serving rebuild leaves the pre-append state, still
    answering exactly, and a later append succeeds."""
    idx, bs = _tbuild(toy_seqs[:40])
    kw = dict(stream_bs=16, stream_source="csr") if mode == "stream" else {}
    srv = tq.QueryServer(idx, bs, mode=mode, device=CPU, **kw)
    probe = [toy_seqs[0], toy_seqs[5]]
    before = srv.query(probe, threshold=3)
    original = getattr(tq.QueryServer, _SERVING_STATE[mode])
    calls = {"n": 0}

    def boom(self):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected rebuild failure")
        return original(self)

    monkeypatch.setattr(tq.QueryServer, _SERVING_STATE[mode], boom)
    with pytest.raises(RuntimeError, match="injected"):
        srv.add_proteins(toy_seqs[40:], threshold=3)
    monkeypatch.undo()
    assert srv.index is idx and srv.bitset is bs
    assert not srv.needs_rebuild
    _same(srv.query(probe, threshold=3), before)
    srv.add_proteins(toy_seqs[40:42], threshold=3)
    assert srv.bitset.n == 42


@pytest.mark.parametrize("mode", ["host", "device"])
def test_add_proteins_double_failure_flags_server(toy_seqs, monkeypatch,
                                                  mode):
    """When the restore fails too, queries raise until rebuild_serving()
    succeeds, and both errors surface."""
    idx, bs = _tbuild(toy_seqs[:40])
    srv = tq.QueryServer(idx, bs, mode=mode, device=CPU)
    probe = [toy_seqs[0], toy_seqs[5]]
    before = srv.query(probe, threshold=3)
    original = getattr(tq.QueryServer, _SERVING_STATE[mode])
    calls = {"n": 0}

    def boom(self):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise RuntimeError(f"injected failure {calls['n']}")
        return original(self)

    monkeypatch.setattr(tq.QueryServer, _SERVING_STATE[mode], boom)
    with pytest.warns(RuntimeWarning, match="rollback failed"):
        with pytest.raises(RuntimeError, match="injected failure 1") as err:
            srv.add_proteins(toy_seqs[40:], threshold=3)
    assert any("ALSO failed" in n for n in err.value.__notes__)
    monkeypatch.undo()
    assert srv.needs_rebuild
    with pytest.raises(RuntimeError, match="rebuild_serving"):
        srv.query(probe, threshold=3)
    srv.rebuild_serving()
    assert not srv.needs_rebuild
    _same(srv.query(probe, threshold=3), before)


# ---- the pipeline's serving stop and cli query ------------------------

def test_stop_after_pack_is_the_jax_pipelines(toy_fasta):
    for k in (5, 7):
        cfg = dict(CFG, k=k)
        j = jrun(toy_fasta, PipelineConfig(**cfg), stop_after="pack")
        t = trun(toy_fasta, tconfig.PipelineConfig(**cfg), device=CPU,
                 stop_after="pack")
        assert t.pairwise is None and t.cluster_labels is None
        assert j.pairwise is None
        _same_index(t.index, j.index)
        assert np.array_equal(t.bitset.words, j.bitset.words)
        assert list(t.timings) == list(j.timings)
    with pytest.raises(ValueError) as jerr:
        jrun(toy_fasta, PipelineConfig(**CFG), stop_after="sweep")
    with pytest.raises(ValueError) as terr:
        trun(toy_fasta, tconfig.PipelineConfig(**CFG), device=CPU,
             stop_after="sweep")
    assert str(terr.value) == str(jerr.value)


@pytest.fixture(scope="module")
def query_fasta(tmp_path_factory, toy):
    path = tmp_path_factory.mktemp("q") / "queries.fasta"
    with open(path, "w") as f:
        for i in (2, 11, 30):
            f.write(f">Q{i}|x\n{toy.table.seq(i)}\n")
        f.write(">odd\nMK@3xZJMKTAYIAKQRQISFVKSHFSRQ\n")
    return str(path)


def _cli(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("case", ["seq", "query-fasta", "blosum62", "top",
                                  "k7"])
def test_cli_query_matches_jax_cli(toy, toy_fasta, query_fasta, capsys,
                                   case):
    """`cli query` stdout bytes against the JAX CLI's."""
    from uniprot_kmer_based_clustering_tpu.cli import main as jmain
    from uniprot_kmer_based_clustering_tpu_torch.cli import main as tmain

    seqs = ["--seq", toy.table.seq(5), "--seq", "MKT"]
    both = seqs + ["--query-fasta", query_fasta]
    args = ["query", toy_fasta] + {
        "seq": seqs,
        "query-fasta": ["--query-fasta", query_fasta],
        "blosum62": both + ["--weighting", "blosum62"],
        "top": both + ["--top", "2"],
        "k7": both + ["--k", "7", "--threshold", "0"],
    }[case]
    want = _cli(jmain, args + ["--cpu"], capsys)
    got = _cli(tmain, args + ["--device", "cpu"], capsys)
    assert got == want
    assert len(want.splitlines()) > 2


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cli_query_warm_starts_from_either_package(toy, toy_fasta, tmp_path,
                                                   capsys, writer):
    """--checkpoint-dir written by one package's `cli query` is read by
    the other's: no new artifact, the same stdout."""
    from uniprot_kmer_based_clustering_tpu.cli import main as jmain
    from uniprot_kmer_based_clustering_tpu_torch.cli import main as tmain

    ckpt = str(tmp_path / "ckpt")
    args = ["query", toy_fasta, "--seq", toy.table.seq(9), "--checkpoint-dir",
            ckpt, "--threshold", "3"]
    first, second = ((jmain, ["--cpu"]), (tmain, ["--cpu"]))
    if writer == "torch":
        first, second = second, first
    want = _cli(first[0], args + first[1], capsys)
    written = sorted(os.listdir(ckpt))
    assert len(written) == 1
    got = _cli(second[0], args + second[1], capsys)
    assert got == want and sorted(os.listdir(ckpt)) == written


def test_cli_query_refuses_like_the_jax_cli(toy_fasta):
    from uniprot_kmer_based_clustering_tpu_torch.cli import main as tmain

    with pytest.raises(SystemExit, match="no queries"):
        tmain(["query", toy_fasta, "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tmain(["query", toy_fasta, "--seq", "MKTAYIAKQR"])
