"""The port's device index build (kmers/index_device.py, the device
encode, doc-freq and pack, the pipeline's ``index_engine="device"``)
against the JAX package's device build and the host build, on CPU
tensors.

The same seeded residue matrices (ragged lengths, sequences shorter than
k, unknown residues) go through the JAX device build (XLA:CPU), the
port's (``device="cpu"``) and the host ``build_index`` + ``pack_bitsets``.

Tolerance: exact equality (uint32 words bit for bit, int codes and
doc-freqs, error messages, file bytes).
"""

import json
import os

import numpy as np
import pytest
import torch

from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
from uniprot_kmer_based_clustering_tpu.kmers import bitset as jbitset
from uniprot_kmer_based_clustering_tpu.kmers import encode as jencode
from uniprot_kmer_based_clustering_tpu.kmers import index as jindex
from uniprot_kmer_based_clustering_tpu.kmers import index_device as jid
from uniprot_kmer_based_clustering_tpu.pipeline import run_pipeline as jrun
from uniprot_kmer_based_clustering_tpu_torch import config as tconfig
from uniprot_kmer_based_clustering_tpu_torch.kmers import bitset as tbitset
from uniprot_kmer_based_clustering_tpu_torch.kmers import encode as tencode
from uniprot_kmer_based_clustering_tpu_torch.kmers import index as tindex
from uniprot_kmer_based_clustering_tpu_torch.kmers import index_device as tid
from uniprot_kmer_based_clustering_tpu_torch.pipeline import run_pipeline as trun

CPU = "cpu"
CFG = dict(tile=16, strip=32, word_block=128, engine="xla", threshold=2)


def _residues(seed, n=50):
    """Seeded sequences over the 20 letters plus X, B and lowercase (the
    '*' catch-all), lengths 2–60 so some are shorter than k, with shared
    runs so that k-mers repeat: (seqs, padded index matrix, lengths)."""
    rng = np.random.default_rng(seed)
    aas = "CSTAGPDEQNHRKMILVWYFXBa"
    seqs = ["".join(aas[i] for i in rng.integers(0, len(aas), int(m)))
            for m in rng.integers(2, 60, n - 12)]
    seqs += [seqs[0][:30] + s[:20] for s in seqs[:12]]
    lengths = np.array([len(s) for s in seqs], np.int32)
    mat = np.zeros((len(seqs), int(lengths.max())), np.int32)
    for i, s in enumerate(seqs):
        mat[i, : len(s)] = jencode.residues_to_indices(
            np.frombuffer(s.encode(), np.uint8))
    return seqs, mat, lengths


def _host(seqs, k, row_multiple=8):
    buf, offs = jencode.seqs_to_buffer(seqs)
    codes, koff = jencode.encode_kmers(buf, offs, k, engine="numpy")
    idx = jindex.build_index(codes, koff, k, engine="numpy")
    bs = jbitset.pack_bitsets(idx.incidence_protein, idx.incidence_rank,
                              len(seqs), idx.n_repeated,
                              row_multiple=row_multiple)
    return idx, bs


def _words(t):
    return t.cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("k", [5, 7])
def test_encode_kmers_device_is_the_jax_packages(k):
    _, mat, lengths = _residues(k)
    tc, tv = tencode.encode_kmers_device(torch.from_numpy(mat),
                                         torch.from_numpy(lengths), k)
    jc, jv = jencode.encode_kmers_device(mat, lengths, k)
    assert tc.dtype == torch.int32 and tv.dtype == torch.bool
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(tv.numpy(), np.asarray(jv))


def test_encode_kmers_device_edges_are_the_jax_packages():
    """k > 7 overflows int32 codes and raises the JAX error; a matrix
    narrower than k pads to one masked window."""
    z = np.zeros((2, 16), np.int32)
    with pytest.raises(ValueError) as jerr:
        jencode.encode_kmers_device(z, np.full(2, 16, np.int32), 8)
    with pytest.raises(ValueError) as terr:
        tencode.encode_kmers_device(torch.from_numpy(z),
                                    torch.full((2,), 16), 8)
    assert str(terr.value) == str(jerr.value)
    narrow = np.ones((3, 4), np.int32)
    tc, tv = tencode.encode_kmers_device(torch.from_numpy(narrow),
                                         torch.full((3,), 4), 7)
    jc, jv = jencode.encode_kmers_device(narrow, np.full(3, 4, np.int32), 7)
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(tv.numpy(), np.asarray(jv)) and not tv.any()


@pytest.mark.parametrize("sent", [21**5, 2**31 - 1])
def test_row_dedup_is_the_jax_packages(sent):
    _, mat, lengths = _residues(3)
    jc, jv = jencode.encode_kmers_device(mat, lengths, 5)
    got = tid._row_dedup(torch.from_numpy(np.array(jc)),
                         torch.from_numpy(np.array(jv)), sent=sent)
    want = jid._row_dedup(jc, jv, sent=np.int32(sent))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_bitset_device_k5_matches_jax_and_host(seed):
    seqs, mat, lengths = _residues(seed)
    n = len(seqs)
    words, freq, n_rep = tid.build_bitset_device(mat, lengths, n,
                                                 row_multiple=8, device=CPU)
    jw, jf, jn = jid.build_bitset_device(mat, lengths, n, row_multiple=8)
    idx, bs = _host(seqs, 5)
    assert n_rep == jn == idx.n_repeated > 0
    assert freq.dtype == torch.int32
    assert np.array_equal(freq.numpy(), np.asarray(jf))
    assert words.dtype == torch.int32
    assert np.array_equal(_words(words), np.asarray(jw))
    assert np.array_equal(_words(words), bs.words)
    assert (bs.words >> 31).any(), "no bit 31 set: the sign bit untested"


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("k", [5, 7])
def test_build_bitset_device_sorted_matches_jax_and_host(k, seed):
    seqs, mat, lengths = _residues(10 * k + seed)
    n = len(seqs)
    words, codes, dfreq, n_rep = tid.build_bitset_device_sorted(
        mat, lengths, n, k, row_multiple=8, device=CPU)
    jw, jc, jd, jn = jid.build_bitset_device_sorted(mat, lengths, n, k,
                                                    row_multiple=8)
    idx, bs = _host(seqs, k)
    assert n_rep == jn == idx.n_repeated > 0
    assert codes.dtype == np.int64 and dfreq.dtype == np.int64
    assert np.array_equal(codes, jc) and np.array_equal(codes, idx.codes)
    assert np.array_equal(dfreq, jd) and np.array_equal(dfreq, idx.doc_freq)
    assert np.array_equal(_words(words), np.asarray(jw))
    assert np.array_equal(_words(words), bs.words)


@pytest.mark.parametrize("width", [6, 4])
def test_sorted_build_empty_universe_is_the_jax_packages(width):
    """k=7 on sequences shorter than 7 (a matrix narrower than k
    included): empty index, all-zero bitset of the JAX shape."""
    mat = np.zeros((4, width), np.int32)
    lengths = np.full(4, width, np.int32)
    words, codes, counts, n_rep = tid.build_bitset_device_sorted(
        mat, lengths, 4, 7, row_multiple=8, device=CPU)
    jw, jc, jd, jn = jid.build_bitset_device_sorted(mat, lengths, 4, 7,
                                                    row_multiple=8)
    assert n_rep == jn == 0
    assert codes.shape == (0,) == counts.shape
    assert tuple(words.shape) == np.asarray(jw).shape
    assert not words.any()


def test_doc_freq_dense_device_is_the_jax_packages():
    _, mat, lengths = _residues(5)
    jc, jv = jencode.encode_kmers_device(mat, lengths, 5)
    tc, tv = torch.from_numpy(np.array(jc)), torch.from_numpy(np.array(jv))
    got = tindex.doc_freq_dense_device(tc, tv, 5)
    want = jindex.doc_freq_dense_device(jc, jv, 5)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError) as jerr:
        jindex.doc_freq_dense_device(jc, jv, 7)
    with pytest.raises(ValueError) as terr:
        tindex.doc_freq_dense_device(tc, tv, 7)
    assert str(terr.value) == str(jerr.value)


def test_index_views_are_the_jax_packages():
    seqs, mat, lengths = _residues(6)
    jw, jf, _ = jid.build_bitset_device(mat, lengths, len(seqs),
                                        row_multiple=8)
    jf = np.asarray(jf)
    idx, _ = _host(seqs, 5)
    pairs = [(tindex.KmerIndex.from_dense_freq(jf, 5),
              jindex.KmerIndex.from_dense_freq(jf, 5)),
             (tindex.KmerIndex.from_sparse_freq(idx.codes, idx.doc_freq, 5),
              jindex.KmerIndex.from_sparse_freq(idx.codes, idx.doc_freq, 5))]
    for t, j in pairs:
        for f in ("k", "codes", "doc_freq", "repeated_codes",
                  "incidence_protein", "incidence_rank", "hash_doc_freq",
                  "nnz_count", "unique_owner", "sampling"):
            assert np.array_equal(np.asarray(getattr(t, f)),
                                  np.asarray(getattr(j, f))), f
        assert t.nnz == j.nnz == idx.nnz and not t.has_incidences
        assert t.multigraph_edge_count() == j.multigraph_edge_count()


@pytest.mark.parametrize("chunk", [37, 1 << 22])
def test_pack_bitsets_device_matches_jax_and_host(monkeypatch, chunk):
    """Two ranks of one protein in one word and bit 31 are both packed
    (the scatter accumulates), in several chunks or one."""
    monkeypatch.setattr(tbitset, "_PACK_CHUNK", chunk)
    seqs, _, _ = _residues(7)
    idx, bs = _host(seqs, 5, row_multiple=512)
    args = (idx.incidence_protein, idx.incidence_rank, len(seqs),
            idx.n_repeated)
    got = tbitset.pack_bitsets_device(*args, device=CPU)
    want = jbitset.pack_bitsets_device(*args)
    assert (got.n, got.n_bits, got.n_pad, got.w_pad) == (
        want.n, want.n_bits, want.n_pad, want.w_pad)
    assert np.array_equal(_words(got.words), np.asarray(want.words))
    assert np.array_equal(_words(got.words), bs.words)
    word = idx.incidence_rank >> 5
    same_word = np.any((np.diff(idx.incidence_protein) == 0)
                       & (np.diff(word) == 0))
    assert same_word and (bs.words >> 31).any()


def test_device_size_refusals_keep_the_jax_conditions():
    """The 13 GB device-pack ceiling and the 2^31 flat-index guard refuse
    where the JAX package refuses (sizes just past the ceiling, so
    neither package allocates)."""
    empty = np.zeros(0, np.int32)
    for n, n_bits in [(100_000, 1_120_000), (30_000, 3_800_000)]:
        with pytest.raises(ValueError) as jerr:
            jbitset.pack_bitsets_device(empty, empty, n, n_bits)
        with pytest.raises(ValueError, match="packed bitset would be") \
                as terr:
            tbitset.pack_bitsets_device(empty, empty, n, n_bits, device=CPU)
        assert (str(terr.value).split(" GB")[0]
                == str(jerr.value).split(" GB")[0])
    tid._check_flat_index_space(100_352, 16_384)
    with pytest.raises(ValueError) as jerr:
        jid._check_flat_index_space(100_352, 62_592)
    with pytest.raises(ValueError) as terr:
        tid._check_flat_index_space(100_352, 62_592)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("k", [5, 7])
def test_pipeline_device_index_matches_jax_and_host(toy_fasta, k):
    cfg = dict(CFG, k=k)
    t_dev = trun(toy_fasta, tconfig.PipelineConfig(**cfg,
                                                   index_engine="device"),
                 device=CPU)
    t_host = trun(toy_fasta, tconfig.PipelineConfig(**cfg), device=CPU)
    j_dev = jrun(toy_fasta, PipelineConfig(**cfg, index_engine="device"))
    assert np.array_equal(t_dev.bitset.words, t_host.bitset.words)
    assert np.array_equal(t_dev.bitset.words, j_dev.bitset.words)
    for f in ("codes", "doc_freq", "repeated_codes", "hash_doc_freq"):
        assert np.array_equal(getattr(t_dev.index, f),
                              getattr(j_dev.index, f)), f
        assert np.array_equal(getattr(t_dev.index, f),
                              getattr(t_host.index, f)), f
    assert not t_dev.index.has_incidences
    assert t_dev.parity_report() == t_host.parity_report()
    assert t_dev.parity_report() == j_dev.parity_report()
    assert np.array_equal(t_dev.pairwise.pairs, t_host.pairwise.pairs)
    assert np.array_equal(t_dev.cluster_labels, j_dev.cluster_labels)
    assert list(t_dev.timings) == ["ingest", "index", "sweep", "cluster"]


def test_pipeline_device_index_refusals_and_empty_fasta(toy_fasta, tmp_path):
    """random10 raises the JAX error; an empty FASTA builds an empty
    index on both packages; stop_after="pack" stops after the index."""
    cfg = dict(CFG, index_engine="device", sampling="random10")
    with pytest.raises(ValueError) as jerr:
        jrun(toy_fasta, PipelineConfig(**cfg))
    with pytest.raises(ValueError) as terr:
        trun(toy_fasta, tconfig.PipelineConfig(**cfg), device=CPU)
    assert str(terr.value) == str(jerr.value)
    empty = tmp_path / "empty.fasta"
    empty.write_text("")
    for k in (5, 7):
        cfg = dict(CFG, index_engine="device", k=k)
        t = trun(str(empty), tconfig.PipelineConfig(**cfg), device=CPU,
                 stop_after="pack")
        j = jrun(str(empty), PipelineConfig(**cfg), stop_after="pack")
        assert t.pairwise is None and t.index.n_distinct == 0
        assert np.array_equal(t.bitset.words, j.bitset.words)


@pytest.mark.parametrize("k", ["5", "7"])
def test_cli_run_device_index_matches_jax_cli(toy_fasta, tmp_path, capsys,
                                              k):
    """`cli run --index-engine device --device cpu` writes the JAX CLI's
    pairs.tsv and clusters.tsv bytes and its parity counters."""
    from uniprot_kmer_based_clustering_tpu.cli import main as jmain
    from uniprot_kmer_based_clustering_tpu_torch.cli import main as tmain

    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    flags = ["--index-engine", "device", "--engine", "mxu", "--k", k,
             "--threshold", "2"]
    assert jmain(["run", toy_fasta, "--cpu", "--out", jout, *flags]) == 0
    assert tmain(["run", toy_fasta, "--device", "cpu", "--out", tout,
                  *flags]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(lines[-2])
    for name in ("pairs.tsv", "clusters.tsv"):
        with open(os.path.join(jout, name), "rb") as a, \
                open(os.path.join(tout, name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(tout, "stats.json")) as f:
        stats = json.load(f)
    assert stats["parity"]["pairs_over_threshold"] > 0
    assert stats["config"]["index_engine"] == "device"
