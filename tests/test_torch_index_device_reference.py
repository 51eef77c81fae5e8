"""The port's device index (``index_engine="device"``) against the
benchmark's plain reference (``benchmark/reference/kmer_pairs.py``: numpy
and scipy, nothing of either package), on seeded synthetic corpora of the
benchmark's generator at 200–600 proteins, k 5 and 7.

The pipeline runs on the CPU with its knobs pinned (``engine="mxu"``,
tile 16, strip 32), as the card runs it. Held against the reference:
the pairs, counters and components; the device words' set bits against
the reference's (protein, column) incidences; the build's counts
(``kmers.index_device.last_trace``). The handoff: the sweep reads the
build's own tensor, copies only the classes, and the bitset's host copy,
made when read, is the host pack bit for bit. The build's phases are its
spans under a profiler.

Tolerance: exact equality.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

from uniprot_kmer_based_clustering_tpu_torch import PipelineConfig
from uniprot_kmer_based_clustering_tpu_torch.kmers import index_device
from uniprot_kmer_based_clustering_tpu_torch.kmers.bitset import (
    DeviceBitsetMatrix,
)
from uniprot_kmer_based_clustering_tpu_torch.pipeline import run_pipeline
from uniprot_kmer_based_clustering_tpu_torch.similarity import pairwise

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
sys.path.insert(0, BENCH)

import corpus  # noqa: E402
from reference import kmer_pairs  # noqa: E402

CPU = "cpu"
PINNED = dict(engine="mxu", tile=16, strip=32, threshold=10,
              cross_amr_only=True, cluster="components")
SEEDS = {2**31 + 1: 200, 2**31 + 2: 400, 2**31 + 3: 600}
CASES = [(seed, k) for seed in SEEDS for k in (5, 7)]
BUILD_SPANS = ("residues", "encode", "sort", "scatter", "fetch")


def _spec(n: int) -> dict:
    """The benchmark configuration's corpus cut to ``n`` proteins: its
    classes in proportion and one family of two classes, so that
    cross-class pairs pass the threshold."""
    import json

    with open(os.path.join(BENCH, "configs",
                           "arg_k7_n10619_devindex.json")) as f:
        spec = json.load(f)["corpus"]
    sizes = [round(n * s / spec["n"]) for s in spec["class_sizes"][:9]]
    sizes[0] += n - sum(sizes)
    spec.update(n=n, class_sizes=sizes, proteins_per_family=6,
                fixed_families=[{"classes": [7, 2], "members": [2, 8],
                                 "length": 300}])
    return spec


@functools.lru_cache(maxsize=None)
def _corpus(seed: int, tmp: str):
    seq_buf, offsets, classes = corpus.synth_proteins(_spec(SEEDS[seed]),
                                                      seed)
    path = os.path.join(tmp, f"corpus.{seed}.fasta")
    corpus.write_fasta(path, seq_buf, offsets, classes)
    return path, seq_buf, offsets, classes


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("device_index_reference"))
    return lambda seed: _corpus(seed, tmp)


def _config(k: int, **kw) -> PipelineConfig:
    return PipelineConfig(k=k, **PINNED, **kw)


@functools.lru_cache(maxsize=None)
def _answer(seed: int, k: int, tmp: str):
    _, seq_buf, offsets, classes = _corpus(seed, tmp)
    return kmer_pairs.answer(seq_buf, offsets, classes, k=k, threshold=10,
                             cross_amr_only=True, with_components=True)


def _device_run(corpora, seed, k, **kw):
    path = corpora(seed)[0]
    res = run_pipeline(path, _config(k, index_engine="device"), device=CPU,
                       **kw)
    return res, dict(index_device.last_trace), dict(pairwise.last_trace)


def _labels_by_smallest(labels: np.ndarray) -> np.ndarray:
    n = len(labels)
    smallest = np.full(n, n, np.int64)
    np.minimum.at(smallest, labels, np.arange(n))
    return smallest[labels]


@pytest.mark.parametrize("seed,k", CASES)
def test_pairs_counters_and_components_equal_the_reference(corpora, seed,
                                                           k):
    res, _, _ = _device_run(corpora, seed, k)
    ref = _answer(seed, k, os.path.dirname(corpora(seed)[0]))
    assert len(ref["pairs"]) > 0
    assert np.array_equal(np.asarray(res.pairwise.pairs, np.int64),
                          ref["pairs"])
    got = np.array([getattr(res.pairwise, f)
                    for f in kmer_pairs.COUNTER_NAMES], np.int64)
    assert np.array_equal(got, ref["counters"])
    assert np.array_equal(_labels_by_smallest(res.cluster_labels),
                          ref["labels"])


@pytest.mark.parametrize("seed,k", CASES)
def test_the_device_words_and_counts_are_the_reference_incidences(
        corpora, seed, k):
    _, seq_buf, offsets, _ = corpora(seed)
    res, build, _ = _device_run(corpora, seed, k, stop_after="pack")
    protein, column, n_repeated = kmer_pairs.kmer_incidences(seq_buf,
                                                             offsets, k)
    words = res.bitset.device_words.numpy().view(np.uint32)
    bits = np.unpackbits(words.view(np.uint8), axis=1, bitorder="little")
    rows, cols = np.nonzero(bits)
    assert np.array_equal(rows, protein) and np.array_equal(cols, column)
    _, code = _windows(seq_buf, offsets, k)
    assert build["k"] == k
    assert build["repeated"] == n_repeated == res.bitset.n_bits
    assert build["distinct"] == len(np.unique(code)) == res.index.n_distinct
    assert build["words_bytes"] == words.nbytes
    assert build["incidence_slots"] == res.bitset.n_pad * (
        int(np.diff(offsets).max()) - k + 1)


def _windows(seq_buf, offsets, k):
    """(protein, code) of every window, coded as the reference codes them
    (its step 1)."""
    lut = np.full(256, len(kmer_pairs.ALPHABET) - 1, np.int64)
    lut[np.frombuffer(kmer_pairs.ALPHABET, np.uint8)] = np.arange(
        len(kmer_pairs.ALPHABET))
    idx = lut[np.asarray(seq_buf, np.uint8)]
    offsets = np.asarray(offsets, np.int64)
    windows = np.maximum(np.diff(offsets) - k + 1, 0)
    start = np.concatenate([np.arange(a, a + w)
                            for a, w in zip(offsets[:-1], windows)])
    code = np.zeros(len(start), np.int64)
    for j in range(k):
        code = code * 21 + idx[start + j]
    return np.repeat(np.arange(len(windows)), windows), code


@pytest.mark.parametrize("k", [5, 7])
def test_the_sweep_reads_the_build_tensor_and_copies_only_the_classes(
        corpora, monkeypatch, k):
    seed = 2**31 + 2
    seen = []
    real = pairwise.sweep_mxu

    def spy(words, *a, **kw):
        seen.append(words)
        return real(words, *a, **kw)

    monkeypatch.setattr(pairwise, "sweep_mxu", spy)
    res, build, sweep = _device_run(corpora, seed, k)
    bitset = res.bitset
    assert isinstance(bitset, DeviceBitsetMatrix)
    assert len(seen) == 1
    assert seen[0].untyped_storage().data_ptr() == \
        bitset.device_words.untyped_storage().data_ptr()
    assert sweep["upload_bytes"] == bitset.n_pad * 4
    # nothing read the host words: no copy of them was made
    assert bitset._host_words is None
    host = run_pipeline(corpora(seed)[0], _config(k), device=CPU,
                        stop_after="pack").bitset
    assert bitset.words.dtype == np.uint32
    assert np.array_equal(bitset.words, host.words)
    assert (bitset.n, bitset.n_bits, bitset.n_pad, bitset.w_pad) == (
        host.n, host.n_bits, host.n_pad, host.w_pad)
    # the build sends the flat residue bytes, the offsets and the
    # 256-byte alphabet table up, the doc-freqs down, and waits twice
    # (k=5: its rank count and the doc-freqs)
    assert build["syncs"] == 2
    _, seq_buf, offsets, _ = corpora(seed)
    up = int(offsets[-1] - offsets[0]) + 8 * len(offsets) + 256
    # k=7 fetches (code, doc-freq) int32 pairs, with the sentinel's when
    # a slot was padding or a repeat within its row
    protein, code = _windows(seq_buf, offsets, k)
    held = len(np.unique(protein * 21**k + code))
    sentinel = int(build["incidence_slots"] > held)
    down = 4 * 21**5 if k == 5 else 2 * 4 * (build["distinct"] + sentinel)
    assert build["host_bytes"] == up + down


@pytest.mark.parametrize("k", [5, 7])
def test_the_build_phases_are_spans_inside_the_build(corpora, k):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _device_run(corpora, 2**31 + 1, k)
    spans = {}
    for e in prof.events():
        if e.name.startswith("ukc.index.device"):
            spans.setdefault(e.name, []).append(e.time_range)
    want = {"ukc.index.device"} | {f"ukc.index.device.{p}"
                                   for p in BUILD_SPANS}
    assert set(spans) == want
    assert all(len(v) == 1 for v in spans.values())
    (outer,) = spans["ukc.index.device"]
    for p in BUILD_SPANS:
        (inner,) = spans[f"ukc.index.device.{p}"]
        assert outer.start <= inner.start <= inner.end <= outer.end, p
