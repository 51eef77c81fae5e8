"""The port's row-sharded serving (``QueryServer(mesh=...)``) against the
JAX package's on the CPU: the toy FASTA goes through the JAX pipeline
once; its index and bitset (N_pad 64) serve from the JAX mesh server on
the 8 virtual CPU devices of ``tests/conftest.py`` (as
``tests/test_pipeline.py`` drives it) and from the port's on CPU shards
(``make_mesh(D, device="cpu")``, ``make_mesh_2d(2, 4, device="cpu")``),
and from the port's single-device server.

Tolerance: exact equality of every query's int64 (index, count) rows in
their order, and of the error messages' text.
"""

import functools

import numpy as np
import pytest
import torch

from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
from uniprot_kmer_based_clustering_tpu.parallel import make_mesh as jmesh
from uniprot_kmer_based_clustering_tpu.parallel import make_mesh_2d as jmesh2
from uniprot_kmer_based_clustering_tpu.pipeline import run_pipeline as jrun
from uniprot_kmer_based_clustering_tpu.similarity import query as jq
from uniprot_kmer_based_clustering_tpu.utils.blosum import rank_weights_int8
from uniprot_kmer_based_clustering_tpu_torch.parallel import mesh as tmesh
from uniprot_kmer_based_clustering_tpu_torch.similarity import query as tq

CFG = dict(tile=16, strip=32, word_block=128, engine="xla", threshold=2,
           cross_amr_only=False)
MESHES = {
    "flat2": (lambda: jmesh(2), lambda: tmesh.make_mesh(2, device="cpu")),
    "flat4": (lambda: jmesh(4), lambda: tmesh.make_mesh(4, device="cpu")),
    "2x4": (lambda: jmesh2(2, 4),
            lambda: tmesh.make_mesh_2d(2, 4, device="cpu")),
}
THRESHOLD = {False: 1, True: 12}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class Toy:
    """The toy corpus through the JAX pipeline, its query batches, and
    the JAX mesh servers' answers, each computed on first use."""

    def __init__(self, fasta):
        res = jrun(fasta, PipelineConfig(**CFG))
        self.index, self.bitset, self.table = res.index, res.bitset, res.table
        seqs = [self.table.seq(i) for i in range(self.table.n)]
        extra = ["MKT", seqs[5][::-1], seqs[9][:40] + seqs[2][40:],
                 "ACDEFGHIKLMNPQRSTVWY" * 3]
        self.batches = {1: [seqs[3]], 7: seqs[:6] + ["MKT"],
                        64: (seqs + extra)[:64]}
        assert len(self.batches[64]) == 64
        self.blosum = rank_weights_int8(self.index.repeated_codes, 5,
                                        self.bitset.w_pad * 32)

    def weights(self, weighted):
        return self.blosum if weighted else None

    @functools.lru_cache(maxsize=None)
    def jax(self, mesh, weighted):
        srv = jq.QueryServer(self.index, self.bitset,
                             weights=self.weights(weighted),
                             mesh=MESHES[mesh][0]())
        return {b: srv.query(seqs, threshold=THRESHOLD[weighted])
                for b, seqs in self.batches.items()}

    @functools.lru_cache(maxsize=None)
    def single(self, weighted):
        srv = tq.QueryServer(self.index, self.bitset,
                             weights=self.weights(weighted), mode="device",
                             device="cpu")
        return {b: srv.query(seqs, threshold=THRESHOLD[weighted])
                for b, seqs in self.batches.items()}

    def mesh_server(self, mesh="flat2", weighted=False, **kw):
        return tq.QueryServer(self.index, self.bitset,
                              weights=self.weights(weighted),
                              mesh=MESHES[mesh][1](), **kw)


@pytest.fixture(scope="module")
def toy(toy_fasta):
    return Toy(toy_fasta)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int64 and g.shape[1:] == (2,)
        assert np.array_equal(g, w)


@pytest.mark.parametrize("batch", [1, 7, 64])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mesh", ["flat2", "flat4", "2x4"])
def test_mesh_server_matches_jax_and_one_device(toy, mesh, weighted, batch):
    srv = toy.mesh_server(mesh, weighted)
    assert len(srv._shard_blocks) == {"flat2": 2, "flat4": 4, "2x4": 8}[mesh]
    got = srv.query(toy.batches[batch], threshold=THRESHOLD[weighted])
    _same(got, toy.jax(mesh, weighted)[batch])
    _same(got, toy.single(weighted)[batch])
    assert sum(len(m) for m in got) > 0


def test_mesh_server_top_and_batches_in_flight(toy):
    """query_async makes every batch's counts before any query_wait, and
    ``top`` cuts each answer as on one device."""
    srv = toy.mesh_server("flat4")
    handles = [srv.query_async(toy.batches[b], threshold=1)
               for b in (64, 1, 7)]
    for b, h in zip((64, 1, 7), handles):
        _same(srv.query_wait(h), toy.single(False)[b])
    want = [m[:2] for m in toy.single(False)[7]]
    _same(srv.query(toy.batches[7], threshold=1, top=2), want)


def test_mesh_server_keeps_the_latency_route_off(toy):
    """host_route_max="auto" is 0 on a mesh (JAX's rule); a number still
    forces the route, and the routed walk runs in query_wait."""
    assert toy.mesh_server()._host_route_max == 0
    srv = toy.mesh_server(host_route_max=8)
    h = srv.query_async(toy.batches[7], threshold=1)
    assert "host_seqs" in h
    _same(srv.query_wait(h), toy.single(False)[7])


@pytest.mark.parametrize("what", ["stream", "host", "n_pad"])
def test_mesh_server_refusals(toy, what):
    """JAX's ValueErrors: stream and host modes are single-device, and
    N_pad must divide over the shards (64 rows over 3 do not)."""
    jkw, tkw, msg = {
        "stream": (dict(mode="stream", mesh=jmesh(2)),
                   dict(mode="stream", mesh=tmesh.make_mesh(2, device="cpu")),
                   "mode='stream' is single-device"),
        "host": (dict(mode="host", mesh=jmesh(2)),
                 dict(mode="host", mesh=tmesh.make_mesh(2, device="cpu")),
                 "mode='host' is single-process"),
        "n_pad": (dict(mesh=jmesh(3)),
                  dict(mesh=tmesh.make_mesh(3, device="cpu")),
                  "N_pad=64 must divide over 3 devices"),
    }[what]
    with pytest.raises(ValueError) as jerr:
        jq.QueryServer(toy.index, toy.bitset, **jkw)
    with pytest.raises(ValueError) as terr:
        tq.QueryServer(toy.index, toy.bitset, **tkw)
    assert msg in str(terr.value) and str(terr.value) == str(jerr.value)


def test_mesh_server_device_is_the_first_shard(toy):
    srv = toy.mesh_server(device="cpu")
    assert srv.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            toy.mesh_server(device="cuda")


def test_mesh_server_add_proteins(toy):
    """An append on a mesh server rebuilds every shard's chunks and
    reports the new-vs-all pairs of a single-device server."""
    new = [toy.table.seq(4)[5:], toy.table.seq(11)]
    srv = toy.mesh_server("flat2")
    one = tq.QueryServer(toy.index, toy.bitset, mode="device", device="cpu")
    got, want = srv.add_proteins(new, threshold=1), one.add_proteins(
        new, threshold=1)
    assert np.array_equal(got, want) and len(got) > 0
    assert srv.bitset.n == one.bitset.n == toy.table.n + 2
    _same(srv.query(toy.batches[7], threshold=1),
          one.query(toy.batches[7], threshold=1))
