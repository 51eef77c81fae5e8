"""The unique codes' owners from the native index scan.

``kmers.index.build_index`` takes each doc-freq-1 code's protein from
the native ``ukc_index_build``, the scan that counts the doc freqs. Here the
owners are held against a rescan of the raw window stream (what the port
did before) and the whole index against the numpy build; a patched
``_owners_from_incidences`` shows which path gave the owners; and the
port's own copy of the C++ source gives the JAX package's library's
index, plus the owners.
Tolerance: exact equality.
"""

import ctypes
import dataclasses
import os

import numpy as np
import pytest

from uniprot_kmer_based_clustering_tpu.io import native as jnative
from uniprot_kmer_based_clustering_tpu_torch.io import fasta as tfasta
from uniprot_kmer_based_clustering_tpu_torch.io import native as tnative
from uniprot_kmer_based_clustering_tpu_torch.kmers import encode as tencode
from uniprot_kmer_based_clustering_tpu_torch.kmers import index as tindex

pytestmark = pytest.mark.skipif(
    not tnative.available(), reason="native toolchain unavailable"
)


def _encoded(k, sampling):
    def make(fasta):
        table = tfasta.read_fasta(fasta)
        return k, *tencode.encode_kmers(table.seq_buf, table.offsets, k,
                                        sampling=sampling, seed=5)
    return make


def _lists(k, *proteins):
    """(k, codes, offsets) from per-protein lists of window codes."""
    offsets = np.zeros(len(proteins) + 1, np.int64)
    np.cumsum([len(p) for p in proteins], out=offsets[1:])
    codes = np.array([c for p in proteins for c in p], np.int64)
    return lambda fasta: (k, codes, offsets)


CASES = {
    "k5_all": _encoded(5, "all"),
    "k7_all": _encoded(7, "all"),
    "k5_random10": _encoded(5, "random10"),
    # 7 and 11 are each one protein's, in several windows
    "repeated_in_one_protein": _lists(
        5, [7, 7, 7, 3], [3, 9], [9, 11, 11, 11]),
    "no_unique_codes": _lists(5, [1, 2, 3], [3, 2, 1], [2]),
    "every_code_unique": _lists(5, [40, 2], [3], [4, 5, 5], []),
    "one_protein": _lists(5, [4, 4, 8, 1, 21**5 - 1]),
    "empty_corpus": _lists(5),
}


def _rescan_owners(unique_codes, codes, kmer_offsets):
    """Each unique code's protein by a searchsorted of every raw window
    code against the unique codes: the port's owners before the scan
    emitted them."""
    n = kmer_offsets.shape[0] - 1
    owner = np.full(unique_codes.shape[0], -1, np.int32)
    if unique_codes.shape[0] == 0 or codes.shape[0] == 0:
        return owner
    protein_of = np.repeat(np.arange(n, dtype=np.int64),
                           np.diff(kmer_offsets))
    pos = np.searchsorted(unique_codes, codes)
    pos = np.clip(pos, 0, unique_codes.shape[0] - 1)
    hit = unique_codes[pos] == codes
    owner[pos[hit]] = protein_of[hit].astype(np.int32)
    return owner


@pytest.mark.parametrize("case", list(CASES))
def test_scan_owners_are_the_rescans_and_the_numpy_builds(toy_fasta, case):
    k, codes, koff = CASES[case](toy_fasta)
    nat = tindex.build_index(codes, koff, k, engine="native")
    ref = tindex.build_index(codes, koff, k, engine="numpy")
    unique = nat.codes[nat.doc_freq == 1]
    want = _rescan_owners(unique, codes, koff)
    assert nat.unique_owner.dtype == np.int32
    assert np.array_equal(nat.unique_owner, want)
    assert (nat.unique_owner >= 0).all()
    assert nat.unique_owner.shape[0] == nat.n_unique == unique.shape[0]
    for f in dataclasses.fields(tindex.KmerIndex):
        a, b = getattr(nat, f.name), getattr(ref, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
        assert np.array_equal(np.asarray(a), np.asarray(b)), f.name
    expect_unique = {"no_unique_codes": 0, "every_code_unique": 5,
                     "repeated_in_one_protein": 2, "one_protein": 4,
                     "empty_corpus": 0}
    if case in expect_unique:
        assert nat.n_unique == expect_unique[case]
    else:
        assert nat.n_unique > 0 and nat.n_repeated > 0
    if case == "repeated_in_one_protein":
        assert nat.unique_owner.tolist() == [0, 2]


@pytest.mark.parametrize("engine", ["auto", "numpy"])
def test_the_owners_come_from_the_scan_or_the_incidences(toy_fasta,
                                                         monkeypatch, engine):
    """Under ``auto`` the native scan gives the owners: the numpy build's
    ``_owners_from_incidences``, patched to raise, is never reached. Under
    ``numpy`` the owners are what that function takes from the deduped
    incidences, called once."""
    real, calls = tindex._owners_from_incidences, []

    def owners(prot, code):
        if engine == "auto":
            raise AssertionError("the native build read the incidences")
        calls.append(real(prot, code))
        return calls[-1]

    monkeypatch.setattr(tindex, "_owners_from_incidences", owners)
    k, codes, koff = _encoded(5, "all")(toy_fasta)
    index = tindex.build_index(codes, koff, k, engine=engine)
    assert index.n_unique > 0
    if engine == "numpy":
        assert len(calls) == 1 and index.unique_owner is calls[0]
    else:
        assert calls == []


@pytest.mark.parametrize("k", [5, 7])
def test_the_ports_own_source_builds_the_jax_packages_index(toy_fasta, k):
    """The port builds its own copy of the C++ source, at ABI 4, which
    the JAX package's bindings refuse; on one corpus its index build
    gives the arrays of the JAX package's library (ABI 3, built from the
    source at the repository root), plus the owners."""
    port_dir = os.path.dirname(os.path.dirname(tnative.__file__))
    assert os.path.dirname(tnative.SOURCE) == os.path.join(port_dir, "csrc")
    lib = ctypes.CDLL(tnative.library_path())
    assert lib.ukc_abi_version() == tnative._ABI_VERSION == 4
    with pytest.raises(AttributeError, match="native ABI 4 != expected 3"):
        jnative._bind(lib)
    if not jnative.available():
        pytest.skip("the JAX package's native library does not build")
    assert jnative._load().ukc_abi_version() == jnative._ABI_VERSION == 3

    k, codes, koff = _encoded(k, "all")(toy_fasta)
    want = jnative.index_build(codes, koff, k)
    got = tnative.index_build(codes, koff, k)
    assert want is not None and got is not None
    for a, b in zip(want[:4], got[:4]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert want[4] == got[4]
    n_repeated = int((got[1] >= 2).sum())
    assert got[5].shape[0] == got[0].shape[0] - n_repeated > 0
