"""The port's clustering models against the JAX package's: the device
label propagation, the agglomerative rounds (host-looped, strip mode and
the device-state loop), the insertion tree, and `cli run --cluster
tree|agglomerative`.

Inputs are seeded numpy graphs and bitsets or the toy FASTA, handed to
both packages; the port runs on the CPU (its plain torch path). The JAX
tree is held to its numpy path, so no case needs the JAX package's
native runtime. Tolerance: exact equality (labels, merge lists, rounds,
tree structure, file bytes).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniprot_kmer_based_clustering_tpu.models import agglomerative as jagg
from uniprot_kmer_based_clustering_tpu.models import components as jcomp
from uniprot_kmer_based_clustering_tpu.models import tree as jtree
from uniprot_kmer_based_clustering_tpu_torch.kmers.bitset import (
    BitsetMatrix,
    VirtualBitsetMatrix,
    pack_bitsets,
)
from uniprot_kmer_based_clustering_tpu_torch.models import agglomerative as tagg
from uniprot_kmer_based_clustering_tpu_torch.models import components as tcomp
from uniprot_kmer_based_clustering_tpu_torch.models import tree as ttree


@pytest.fixture
def jax_tree_numpy(monkeypatch):
    monkeypatch.setattr(jtree, "_native_rows", None)


def _random_graph(seed, n, m):
    rng = np.random.default_rng(seed)
    i = rng.integers(0, n, m)
    j = rng.integers(0, n, m)
    return np.stack([np.minimum(i, j), np.maximum(i, j)], 1).astype(np.int32)


@pytest.mark.parametrize("seed,n,m", [(0, 50, 30), (1, 200, 150),
                                      (2, 400, 600), (3, 1000, 400)])
def test_components_device_matches_jax_and_union_find(seed, n, m):
    pairs = _random_graph(seed, n, m)
    got = tcomp.connected_components_device(pairs[:, 0], pairs[:, 1], n=n,
                                            device="cpu")
    want = np.asarray(jcomp.connected_components_device(
        jnp.asarray(pairs[:, 0]), jnp.asarray(pairs[:, 1]), n=n))
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert np.array_equal(got, tcomp.connected_components(n, pairs))
    assert len(np.unique(got)) < n


def test_components_device_empty_graph():
    none = np.zeros(0, np.int32)
    got = tcomp.connected_components_device(none, none, n=7, device="cpu")
    assert np.array_equal(got, np.arange(7, dtype=np.int32))
    assert np.array_equal(got, np.asarray(jcomp.connected_components_device(
        jnp.asarray(none), jnp.asarray(none), n=7)))


def test_components_device_self_edge_padding():
    """Padding edges are self-edges (as the JAX sharded path pads): they
    change no label, and a long chain still converges to its minimum."""
    n = 300
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], 1)[::-1]
    pad = np.stack([np.arange(40) % n, np.arange(40) % n], 1)
    pairs = np.concatenate([chain, pad]).astype(np.int32)
    got = tcomp.connected_components_device(pairs[:, 0], pairs[:, 1], n=n,
                                            device="cpu")
    assert np.array_equal(got, np.zeros(n, np.int32))
    assert np.array_equal(got, np.asarray(jcomp.connected_components_device(
        jnp.asarray(pairs[:, 0]), jnp.asarray(pairs[:, 1]), n=n)))
    _, rounds = tcomp._propagate_labels(
        torch.from_numpy(pairs[:, 0].astype(np.int64)),
        torch.from_numpy(pairs[:, 1].astype(np.int64)), n)
    assert rounds < n // 4


def _dense_bitset(seed, n, k, density, families=True):
    rng = np.random.default_rng(seed)
    dense = rng.random((n, k)) < density
    if families:
        dense[1] = dense[0]
        dense[2] = dense[0] | (rng.random(k) < 0.05)
        dense[7] = dense[6]
    rows, cols = np.nonzero(dense)
    return pack_bitsets(rows.astype(np.int32), cols.astype(np.int32), n, k,
                        row_multiple=8, word_multiple=128)


def _same_result(got, want):
    assert np.array_equal(got.labels, np.asarray(want.labels))
    assert got.labels.dtype == np.int32
    assert np.array_equal(got.merges, np.asarray(want.merges))
    assert got.merges.dtype == np.int64 and got.merges.shape[1] == 3
    assert got.rounds == want.rounds


@pytest.mark.parametrize("seed,min_shared", [(1, 1), (2, 3), (3, 2), (4, 8)])
def test_agglomerative_matches_jax(seed, min_shared):
    bs = _dense_bitset(seed, 40, 160, 0.2)
    got = tagg.agglomerative_cluster(bs, 40, min_shared=min_shared,
                                     device="cpu")
    _same_result(got, jagg.agglomerative_cluster(bs, 40,
                                                 min_shared=min_shared))
    assert len(got.merges) > 0


@pytest.mark.parametrize("min_shared", [1, 2])
def test_agglomerative_strip_mode_matches_jax(min_shared):
    """A tiny budget forces the strip plan with a word chunk; n_pad 600 >
    512, so the last strip re-covers the tail. Equal to the one-shot
    rounds and to the JAX strip mode."""
    n, k = 600, 8192
    bs = _dense_bitset(5, n, k, 0.02)
    tiny = 1 << 20
    assert tagg._argmax_plan(bs.n_pad, bs.w_pad, tiny) == (512, 128)
    got = tagg.agglomerative_cluster(bs, n, min_shared=min_shared,
                                     hbm_budget_bytes=tiny, device="cpu")
    _same_result(got, tagg.agglomerative_cluster(bs, n, min_shared=min_shared,
                                                 device="cpu"))
    _same_result(got, jagg.agglomerative_cluster(
        bs, n, min_shared=min_shared, hbm_budget_bytes=tiny))


@pytest.mark.parametrize("n_pad,w,budget", [
    (10752, 7680, 13 << 30), (10752, 7680, 1 << 30), (32256, 28416, 13 << 30),
    (600, 256, 1 << 20),
])
def test_argmax_plan_is_the_jax_packages(n_pad, w, budget):
    want = jagg._argmax_plan(n_pad, w, budget)
    got = tagg._argmax_plan(n_pad, w, budget)
    assert got == (None if want is None else tuple(want[:2]))


@pytest.mark.parametrize("seed,min_shared", [(1, 1), (2, 3), (3, 2)])
def test_agglomerative_device_loop_matches_host_loop(seed, min_shared):
    bs = _dense_bitset(seed, 40, 160, 0.2)
    host = tagg.agglomerative_cluster(bs, 40, min_shared=min_shared,
                                      device="cpu")
    _same_result(tagg.agglomerative_cluster_device(
        bs, 40, min_shared=min_shared, device="cpu"), host)
    _same_result(host, jagg.agglomerative_cluster_device(
        bs, 40, min_shared=min_shared))


def test_agglomerative_device_loop_max_rounds():
    bs = _dense_bitset(6, 64, 256, 0.15)
    full = tagg.agglomerative_cluster(bs, 64, device="cpu")
    assert full.rounds > 2
    for fn in (tagg.agglomerative_cluster, tagg.agglomerative_cluster_device):
        cut = fn(bs, 64, max_rounds=2, device="cpu")
        assert cut.rounds == 2
        assert np.array_equal(cut.merges, full.merges[: len(cut.merges)])


def _structure(node):
    if node.protein is not None:
        return node.protein
    return tuple(_structure(c) for c in node.children)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("density,seed,n,k", [
    (0.05, 0, 80, 400), (0.2, 1, 80, 400), (0.01, 2, 80, 400),
] + [([0.02, 0.08, 0.3][s % 3], s, 150, 300) for s in range(6)])
def test_tree_matches_jax(monkeypatch, jax_tree_numpy, native, density, seed,
                          n, k):
    """The density/seed cases and the fuzz densities of the JAX tree
    tests: labels, depth and the whole ordered structure, on the port's
    native AND+popcount path and on its numpy path."""
    if native and ttree._native_rows_fn() is None:
        pytest.skip("the port's C++ runtime did not build")
    if not native:
        monkeypatch.setattr(ttree, "_native_rows", None)
    rng = np.random.default_rng(seed)
    rows, cols = np.nonzero(rng.random((n, k)) < density)
    bs = pack_bitsets(rows.astype(np.int32), cols.astype(np.int32), n, k,
                      row_multiple=8, word_multiple=128)
    got, want = ttree.build_tree(bs, n), jtree.build_tree(bs, n)
    assert np.array_equal(got.labels(n), want.labels(n))
    assert got.depth() == want.depth()
    assert _structure(got.root) == _structure(want.root)
    assert np.array_equal(ttree.cluster_tree_labels(bs, n), got.labels(n))


def test_tree_uint32_rows_and_single_protein(jax_tree_numpy):
    """Raw uint32 rows take the numpy path (the native kernel's ABI is
    uint64 rows) and build the same tree; one protein is one leaf."""
    bs = _dense_bitset(9, 40, 300, 0.1, families=False)
    t = ttree.ClusterTree(0, bs.words[0])
    for i in range(1, 40):
        t.add_protein(i, bs.words[i])
    assert np.array_equal(t.labels(40), jtree.build_tree(bs, 40).labels(40))
    one = _dense_bitset(0, 1, 64, 0.2, families=False)
    assert ttree.build_tree(one, 1).labels(1).tolist() == [0]


def test_native_and_popcnt_rows():
    from uniprot_kmer_based_clustering_tpu_torch.io import native

    fn = native.and_popcnt_rows_fn()
    if fn is None:
        pytest.skip("the port's C++ runtime did not build")
    rng = np.random.default_rng(4)
    mat = rng.integers(0, 2**63, (9, 6), dtype=np.uint64)
    vec = rng.integers(0, 2**63, 6, dtype=np.uint64)
    out = np.full(9, -1, np.int64)
    fn(mat, 7, vec, out)
    want = np.bitwise_count(mat & vec).sum(axis=1)
    assert np.array_equal(out[:7], want[:7]) and (out[7:] == -1).all()


def _cli_pair(toy_fasta, tmp_path, flags):
    from uniprot_kmer_based_clustering_tpu.cli import main as jmain
    from uniprot_kmer_based_clustering_tpu_torch.cli import main as tmain

    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jmain(["run", toy_fasta, "--cpu", "--out", jout,
                  "--engine", "mxu", "--threshold", "2", *flags]) == 0
    assert tmain(["run", toy_fasta, "--device", "cpu", "--out", tout,
                  "--engine", "mxu", "--threshold", "2", *flags]) == 0
    return jout, tout


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("flags", [
    ["--cluster", "tree"], ["--cluster", "agglomerative"],
    ["--cluster", "agglomerative", "--min-shared", "40"],
], ids=["tree", "agglomerative", "agglomerative-min-shared-40"])
def test_cli_run_cluster_matches_jax_cli(toy_fasta, tmp_path, jax_tree_numpy,
                                         flags):
    jout, tout = _cli_pair(toy_fasta, tmp_path, flags)
    for name in ("clusters.tsv", "dendrogram.tsv", "pairs.tsv"):
        path = os.path.join(jout, name)
        assert os.path.exists(os.path.join(tout, name)) == os.path.exists(path)
        if os.path.exists(path):
            assert _read(os.path.join(tout, name)) == _read(path), name
    clusters = _read(os.path.join(tout, "clusters.tsv")).splitlines()[1:]
    assert len(clusters) == 60
    if flags[1] == "agglomerative":
        rows = _read(os.path.join(tout, "dendrogram.tsv")).splitlines()
        assert rows[0] == b"winner\tloser\tshared_kmers"
        n_clusters = len({r.split(b"\t")[3] for r in clusters})
        assert len(rows) - 1 == 60 - n_clusters


def test_packless_stream_run_keeps_the_pack_for_the_tree(toy_fasta,
                                                         jax_tree_numpy):
    """--engine stream --stream-source csr is packless for components,
    but the tree reads the dense rows: that config keeps the real pack,
    and its labels are the tree's on the host pack."""
    from uniprot_kmer_based_clustering_tpu_torch import PipelineConfig
    from uniprot_kmer_based_clustering_tpu_torch.pipeline import run_pipeline

    kw = dict(engine="stream", stream_source="csr", threshold=2)
    comp = run_pipeline(toy_fasta, PipelineConfig(**kw), device="cpu")
    assert isinstance(comp.bitset, VirtualBitsetMatrix)
    tree = run_pipeline(toy_fasta, PipelineConfig(cluster="tree", **kw),
                        device="cpu")
    assert type(tree.bitset) is BitsetMatrix
    assert np.array_equal(tree.pairwise.pairs, comp.pairwise.pairs)
    assert np.array_equal(tree.cluster_labels, jtree.cluster_tree_labels(
        tree.bitset, tree.table.n))
    assert len(np.unique(tree.cluster_labels)) < tree.table.n
