"""The port's k-mer dumps against the JAX package's: decode_kmer, the
shared k-mers of pairs on both branches (host incidence lists and the
bitset rows of a device-built index), the reference's Rust {:#?} graph
dump, and `cli run --dump-kmers --dump-proteins --dump-debug`.

Inputs are the toy FASTA and small hand-made corpora, handed to both
packages. Tolerance: exact equality (rank arrays, strings, file bytes).
"""

import io
import os

import numpy as np
import pytest

from uniprot_kmer_based_clustering_tpu.io import debug_dump as jdump
from uniprot_kmer_based_clustering_tpu.kmers import encode as jencode
from uniprot_kmer_based_clustering_tpu.similarity import kmers_of_pairs as jkop
from uniprot_kmer_based_clustering_tpu_torch import PipelineConfig
from uniprot_kmer_based_clustering_tpu_torch.io import debug_dump as tdump
from uniprot_kmer_based_clustering_tpu_torch.kmers import encode as tencode
from uniprot_kmer_based_clustering_tpu_torch.pipeline import run_pipeline
from uniprot_kmer_based_clustering_tpu_torch.similarity import (
    kmers_of_pairs as tkop,
)


@pytest.mark.parametrize("k", [5, 7])
def test_decode_kmer_is_the_jax_packages(k):
    rng = np.random.default_rng(k)
    codes = np.concatenate([[0, 21**k - 1], rng.integers(0, 21**k, 200)])
    for c in codes:
        got = tencode.decode_kmer(int(c), k)
        assert got == jencode.decode_kmer(int(c), k) and len(got) == k
    buf, offs = tencode.seqs_to_buffer(["MKTAYIAKQR"])
    first = tencode.encode_kmers(buf, offs, k)[0][0]
    assert tencode.decode_kmer(int(first), k) == "MKTAYIAKQR"[:k]


@pytest.fixture(scope="module", params=["incidences", "bitset"])
def toy_run(request, toy_fasta):
    """The toy corpus at threshold 0: the host index (incidence lists)
    or the device-built index (bitset rows only), on the CPU."""
    engine = "host" if request.param == "incidences" else "device"
    res = run_pipeline(toy_fasta, PipelineConfig(
        engine="mxu", threshold=0, tile=16, strip=32, index_engine=engine),
        device="cpu")
    assert res.index.has_incidences == (request.param == "incidences")
    return res


def test_shared_kmer_ranks_is_the_jax_packages(toy_run):
    pairs = toy_run.pairwise.pairs
    got = tkop.shared_kmer_ranks(toy_run.index, pairs, toy_run.bitset)
    want = jkop.shared_kmer_ranks(toy_run.index, pairs, toy_run.bitset)
    assert len(got) == len(pairs) > 100
    for g, w, row in zip(got, want, pairs):
        assert np.array_equal(g, w) and len(g) == row[2]


def test_shared_and_protein_kmer_strings_are_the_jax_packages(toy_run):
    pairs = toy_run.pairwise.pairs[:40]
    idx, bs = toy_run.index, toy_run.bitset
    assert (tkop.shared_kmer_strings(idx, pairs, bs)
            == jkop.shared_kmer_strings(idx, pairs, bs))
    assert (tkop.protein_kmer_strings(idx, bs)
            == jkop.protein_kmer_strings(idx, bs))
    assert (tkop.protein_kmer_strings(idx, bs, rows=[5, 0])
            == jkop.protein_kmer_strings(idx, bs, rows=[5, 0]))


def test_branches_agree_and_bitset_branch_needs_the_bitset(toy_fasta):
    runs = [run_pipeline(toy_fasta, PipelineConfig(
        engine="mxu", threshold=3, tile=16, strip=32, index_engine=e),
        device="cpu") for e in ("host", "device")]
    pairs = runs[0].pairwise.pairs
    assert np.array_equal(pairs, runs[1].pairwise.pairs)
    a, b = (tkop.shared_kmer_strings(r.index, pairs, r.bitset) for r in runs)
    assert a == b
    with pytest.raises(ValueError, match="pass the bitset"):
        tkop.shared_kmer_ranks(runs[1].index, pairs)


def test_protein_kmer_strings_refuses_a_packless_run(toy_fasta):
    res = run_pipeline(toy_fasta, PipelineConfig(
        engine="stream", stream_source="csr", threshold=2), device="cpu")
    with pytest.raises(RuntimeError, match="never materialized"):
        tkop.protein_kmer_strings(res.index, res.bitset)
    with pytest.raises(RuntimeError, match="never materialized"):
        jkop.protein_kmer_strings(res.index, res.bitset)
    # the pairs' own k-mers come from the incidence lists
    assert tkop.shared_kmer_strings(res.index, res.pairwise.pairs[:3])


def _dump(mod, *args, **kw):
    out = io.StringIO()
    mod.write_rust_debug_dump(out, *args, **kw)
    return out.getvalue()


@pytest.mark.parametrize("case", ["pairs", "no_pairs", "no_proteins",
                                  "no_header"])
def test_rust_debug_dump_bytes_are_the_jax_packages(toy_run, case):
    idx, bs, n = toy_run.index, toy_run.bitset, toy_run.table.n
    pairs = toy_run.pairwise.pairs
    kw = dict(bitset=bs)
    if case == "no_pairs":
        pairs = pairs[:0]
    elif case == "no_proteins":
        pairs, n = pairs[:0], 0
    elif case == "no_header":
        pairs, kw["header"] = pairs[::7], False
    got = _dump(tdump, idx, pairs, n, **kw)
    assert got == _dump(jdump, idx, pairs, n, **kw)
    if case == "no_pairs":
        assert "    Kmers: [],\n" in got
    if case == "no_proteins":
        assert got.endswith("    Kmers: [],\n    Proteins: [],\n}\n")
    assert got.startswith("Graph {" if case == "no_header"
                          else "Graph right now:\nGraph {\n")


DUMPS = ("pair_kmers.tsv", "proteins.tsv", "graph_debug.txt")


def _files(out):
    got = {}
    for name in DUMPS:
        path = os.path.join(out, name)
        if os.path.exists(path):
            with open(path, "rb") as f:
                got[name] = f.read()
    return got


@pytest.mark.parametrize("flags", [
    [], ["--threshold", "0"], ["--threshold", "0", "--index-engine", "device"],
], ids=["default", "threshold-0", "threshold-0-device-index"])
def test_cli_run_dumps_match_jax_cli(toy_fasta, tmp_path, flags):
    from uniprot_kmer_based_clustering_tpu.cli import main as jmain
    from uniprot_kmer_based_clustering_tpu_torch.cli import main as tmain

    dumps = ["--dump-kmers", "--dump-proteins", "--dump-debug"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jmain(["run", toy_fasta, "--cpu", "--engine", "mxu", "--out", jout,
                  *dumps, *flags]) == 0
    assert tmain(["run", toy_fasta, "--device", "cpu", "--engine", "mxu",
                  "--out", tout, *dumps, *flags]) == 0
    got, want = _files(tout), _files(jout)
    assert got == want and set(got) == set(DUMPS)
    assert got["graph_debug.txt"].count(b"Kmer Group") == (
        got["pair_kmers.tsv"].count(b"\n") - 1)
