"""The port's pair alignment (align/) against the JAX package's: the host
Smith-Waterman traceback, the batched device scan (its plain torch run on
the CPU), blastp_output.tsv from align_pairs_sw and from `cli run
--align`, and the diamond orchestration without a diamond binary.

Inputs are seeded numpy residue arrays or the toy FASTA, handed to both
packages. Tolerance: exact equality (integer scores and coordinates,
LocalAlignment fields, file bytes).
"""

import dataclasses
import os
import stat

import numpy as np
import pytest

from uniprot_kmer_based_clustering_tpu.align import diamond as jdiamond
from uniprot_kmer_based_clustering_tpu.align import sw_device as jsw_device
from uniprot_kmer_based_clustering_tpu.align import sw_host as jsw_host
from uniprot_kmer_based_clustering_tpu.align import sw_pairs as jsw_pairs
from uniprot_kmer_based_clustering_tpu.io import read_fasta as jread_fasta
from uniprot_kmer_based_clustering_tpu_torch.align import diamond as tdiamond
from uniprot_kmer_based_clustering_tpu_torch.align import sw_device as tsw_device
from uniprot_kmer_based_clustering_tpu_torch.align import sw_host as tsw_host
from uniprot_kmer_based_clustering_tpu_torch.align import sw_pairs as tsw_pairs
from uniprot_kmer_based_clustering_tpu_torch.io.fasta import read_fasta

TOY = ["--engine", "mxu", "--threshold", "2"]


def _residues(rng, n, alphabet=21):
    return rng.integers(0, alphabet, n).astype(np.int32)


def _random_pairs(seed, count, lo=5, hi=60, alphabet=21):
    """Residue pairs; a small alphabet makes co-optimal ties common, and
    every fourth pair repeats a segment of its query in the subject."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(count):
        q = _residues(rng, int(rng.integers(lo, hi)), alphabet)
        s = _residues(rng, int(rng.integers(lo, hi)), alphabet)
        if r % 4 == 0:
            s = np.concatenate([s[:3], q[2:], q[2:]]).astype(np.int32)
        out.append((q, s))
    return out


def _batch(pairs, pad_value=7):
    """Padded [B, L] matrices; the padding holds a real residue, which
    the scan must mask."""
    b = len(pairs)
    lq = max(max(len(q) for q, _ in pairs), 1)
    ls = max(max(len(s) for _, s in pairs), 1)
    q_idx = np.full((b, lq), pad_value, np.int32)
    s_idx = np.full((b, ls), pad_value, np.int32)
    q_len = np.zeros(b, np.int64)
    s_len = np.zeros(b, np.int64)
    for r, (q, s) in enumerate(pairs):
        q_idx[r, : len(q)] = q
        s_idx[r, : len(s)] = s
        q_len[r], s_len[r] = len(q), len(s)
    return q_idx, q_len, s_idx, s_len


@pytest.mark.parametrize("seed,alphabet", [(0, 21), (1, 21), (2, 3), (3, 2)])
def test_sw_align_host_matches_jax(seed, alphabet):
    for q, s in _random_pairs(seed, 12, alphabet=alphabet):
        got = tsw_host.sw_align_host(q, s)
        want = jsw_host.sw_align_host(q, s)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert got.bitscore() == want.bitscore()
        assert got.evalue(len(q), len(s)) == want.evalue(len(q), len(s))
    for name in ("GAP_OPEN", "GAP_EXTEND", "KA_LAMBDA", "KA_K"):
        assert getattr(tsw_host, name) == getattr(jsw_host, name)


def test_sw_align_host_empty_sequence():
    q = np.array([3, 4, 5], np.int32)
    empty = np.zeros(0, np.int32)
    for a, b in ((q, empty), (empty, q), (empty, empty)):
        got = tsw_host.sw_align_host(a, b)
        assert dataclasses.astuple(got) == dataclasses.astuple(
            jsw_host.sw_align_host(a, b))
        assert got.score == 0 and got.pident == 0.0


@pytest.mark.parametrize("seed,alphabet", [(4, 21), (5, 3), (6, 2)])
def test_sw_scores_device_matches_jax(seed, alphabet):
    pairs = _random_pairs(seed, 24, alphabet=alphabet)
    pairs.append((np.zeros(0, np.int32), pairs[0][1]))  # empty query
    args = _batch(pairs)
    got = tsw_device.sw_scores_device(*args, device="cpu")
    want = jsw_device.sw_scores_device(*args)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and np.array_equal(g, np.asarray(w))
    for r, (q, s) in enumerate(pairs):
        assert got[0][r] == tsw_host.sw_align_host(q, s).score


@pytest.mark.parametrize("seed,alphabet", [(7, 21), (8, 3), (9, 2)])
def test_sw_ends_and_starts_device_matches_jax(seed, alphabet):
    pairs = _random_pairs(seed, 16, lo=8, hi=40, alphabet=alphabet)
    args = _batch(pairs)
    got = tsw_device.sw_ends_and_starts_device(*args, device="cpu")
    want = jsw_device.sw_ends_and_starts_device(*args)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g, np.int64), np.asarray(w, np.int64))
    assert (got[0] > 0).sum() > len(pairs) // 2


@pytest.fixture(scope="module")
def toy_pairs(toy_fasta):
    """The toy corpus's cross-class pairs over 2 shared k-mers, from the
    port's pipeline on the CPU."""
    from uniprot_kmer_based_clustering_tpu_torch import cluster_fasta

    res = cluster_fasta(toy_fasta, device="cpu", engine="mxu", threshold=2,
                        tile=16, strip=32)
    assert len(res.pairwise.pairs) > 3
    return res.pairwise.pairs


@pytest.mark.parametrize("device_scores", [True, False])
@pytest.mark.parametrize("batch", [512, 3, 1])
def test_align_pairs_sw_bytes_match_jax(toy_fasta, toy_pairs, tmp_path,
                                        batch, device_scores):
    # batches of 1 and 3 over the first pairs only: several partly
    # filled batches already, in bucket order, written in input order
    pairs = toy_pairs if batch == 512 else toy_pairs[:10]
    got, want = str(tmp_path / "t.tsv"), str(tmp_path / "j.tsv")
    tsw_pairs.align_pairs_sw(read_fasta(toy_fasta), pairs, got,
                             batch=batch, device_scores=device_scores,
                             device="cpu")
    jsw_pairs.align_pairs_sw(jread_fasta(toy_fasta), pairs, want,
                             batch=batch, device_scores=device_scores)
    data = open(got, "rb").read()
    assert data == open(want, "rb").read()
    assert data.count(b"\n") == len(pairs) + 1


def _zero_score_fasta(tmp_path):
    fa = tmp_path / "z.fasta"
    fa.write_text(
        ">E0|F|U|beta_lactam|g0\n"
        ">P1|F|U|bacitracin|g1\nMKTAYIAKQR\n"
        ">P2|F|U|MLS|g2\nMKTAYIAKQR\n"
    )
    return str(fa)


@pytest.mark.parametrize("device_scores", [True, False])
@pytest.mark.parametrize("case", ["zero_score", "empty"])
def test_zero_score_and_empty_pairs(tmp_path, case, device_scores):
    """A pair with no local alignment (an empty sequence) writes no row;
    an empty pair list writes the header alone."""
    fasta = _zero_score_fasta(tmp_path)
    pairs = (np.array([[0, 1, 1], [1, 2, 5]], np.int64) if case == "zero_score"
             else [])
    got, want = str(tmp_path / "t.tsv"), str(tmp_path / "j.tsv")
    tsw_pairs.align_pairs_sw(read_fasta(fasta), pairs, got,
                             device_scores=device_scores, device="cpu")
    jsw_pairs.align_pairs_sw(jread_fasta(fasta), pairs, want,
                             device_scores=device_scores)
    lines = open(got).read().splitlines()
    assert open(got, "rb").read() == open(want, "rb").read()
    assert len(lines) == (2 if case == "zero_score" else 1)
    assert lines[0] + "\n" == tdiamond.TSV_HEADER
    if case == "zero_score":
        assert "E0|" not in lines[1]


def test_diamond_format_is_the_jax_packages():
    assert tdiamond.TSV_HEADER == jdiamond.TSV_HEADER
    assert tdiamond.OUTFMT == jdiamond.OUTFMT


def test_diamond_missing_binary_raises(toy_fasta, tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert not tdiamond.diamond_available()
    with pytest.raises(RuntimeError, match="diamond binary not found"):
        tdiamond.align_pairs(read_fasta(toy_fasta),
                             np.array([[0, 1, 5]], np.int64),
                             str(tmp_path / "out.tsv"))
    assert not (tmp_path / "out.tsv").exists()


def test_diamond_failure_surfaces_per_pair(toy_fasta, tmp_path, monkeypatch):
    """A failing diamond binary gives one error summary over every pair
    and writes no file."""
    fake = tmp_path / "bin" / "diamond"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho boom >&2\nexit 3\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(fake.parent) + os.pathsep
                       + os.environ["PATH"])
    assert tdiamond.diamond_available()
    out = tmp_path / "out.tsv"
    with pytest.raises(RuntimeError) as exc:
        tdiamond.align_pairs(read_fasta(toy_fasta),
                             np.array([[0, 1, 5], [2, 3, 7]], np.int64),
                             str(out))
    assert "2 / 2 alignments failed" in str(exc.value)
    assert "rc=3" in str(exc.value) and "boom" in str(exc.value)
    assert not out.exists() and not (tmp_path / "out.tsv.tmp").exists()


@pytest.mark.parametrize("flags", [["--align", "sw"], ["--align", "auto"],
                                   ["--align", "diamond"], ["--diamond"]],
                         ids=["sw", "auto", "diamond", "diamond-alias"])
def test_cli_run_align_matches_jax_cli(toy_fasta, tmp_path, monkeypatch,
                                       capsys, flags):
    """With no diamond on PATH, every mode writes the sw aligner's
    blastp_output.tsv, byte-equal to the JAX CLI's; diamond says it
    falls back."""
    from uniprot_kmer_based_clustering_tpu.cli import main as jmain
    from uniprot_kmer_based_clustering_tpu_torch.cli import main as tmain

    monkeypatch.setenv("PATH", "")
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jmain(["run", toy_fasta, "--cpu", "--out", jout, *TOY,
                  *flags]) == 0
    capsys.readouterr()
    assert tmain(["run", toy_fasta, "--device", "cpu", "--out", tout, *TOY,
                  *flags]) == 0
    err = capsys.readouterr().err
    got = open(os.path.join(tout, "blastp_output.tsv"), "rb").read()
    assert got == open(os.path.join(jout, "blastp_output.tsv"), "rb").read()
    assert got.count(b"\n") > 1
    assert "(sw)" in err
    if "diamond" in flags or "--diamond" in flags:
        assert "Smith-Waterman aligner on cpu" in err
