"""The plain reference against the port's CPU path for every entry, and
against a count by Python sets at a tiny size."""

from __future__ import annotations

import itertools

import numpy as np
import pytest
from conftest import harness, run_cpu, small_config, spec

import corpus

ref_impl = harness.load_module("reference", "kmer_pairs")


@pytest.mark.parametrize("workload", [w["name"] for w in spec()["workloads"]])
def test_every_cell_is_correct_on_the_cpu(workload):
    result, info, checks = run_cpu(workload)
    assert result["correct"], (checks, info["failures"])
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(checks) >= {"jobs_failed", "pair_rows_wrong", "counters_wrong"}


@pytest.mark.parametrize("cross_amr_only", [True, False])
def test_the_reference_counts_what_python_sets_count(cross_amr_only):
    spec_ = small_config("arg10k.sweep")["corpus"]
    spec_.update(n=40, class_sizes=[20, 15, 5], proteins_per_family=4,
                 fixed_families=[{"classes": [0, 1], "members": [2, 3],
                                  "length": 40}],
                 length_median=40, length_min=20, length_max=60,
                 substitutions_per_residue=0.05)
    seq_buf, offsets, classes = corpus.synth_proteins(spec_, 7)
    k, threshold = 5, 3
    kmers = []
    for p in range(spec_["n"]):
        s = seq_buf[offsets[p] : offsets[p + 1]].tobytes()
        kmers.append({s[i : i + k] for i in range(len(s) - k + 1)})
    counters = np.zeros(8, np.int64)
    pairs = []
    for i, j in itertools.combinations(range(spec_["n"]), 2):
        v = len(kmers[i] & kmers[j])
        lane = 0 if classes[i] != classes[j] else 4
        counters[lane] += v
        counters[lane + 1] += v >= 1
        counters[lane + 2] += v > threshold
        counters[lane + 3] = max(counters[lane + 3], v)
        if v > threshold and (lane == 0 or not cross_amr_only):
            pairs.append((i, j, v))
    got = ref_impl.answer(seq_buf, offsets, classes, k=k, threshold=threshold,
                          cross_amr_only=cross_amr_only, with_components=True)
    np.testing.assert_array_equal(got["counters"], counters)
    np.testing.assert_array_equal(got["pairs"], np.array(pairs).reshape(-1, 3))
    # components by a union-find over the same pairs
    parent = list(range(spec_["n"]))

    def find(x):
        while parent[x] != x:
            x = parent[x]
        return x

    for i, j, _ in pairs:
        a, b = find(i), find(j)
        parent[max(a, b)] = min(a, b)
    labels = [find(p) for p in range(spec_["n"])]
    np.testing.assert_array_equal(got["labels"], labels)


def test_the_seed_changes_the_residues_not_the_sizes():
    spec_ = small_config("arg10k.sweep")["corpus"]
    a = corpus.synth_proteins(spec_, 1)
    b = corpus.synth_proteins(spec_, 2**33 + 5)
    assert sorted(np.diff(a[1])) == sorted(np.diff(b[1]))
    assert sorted(a[2]) == sorted(b[2])
    assert not np.array_equal(a[0], b[0])
    again = corpus.synth_proteins(spec_, 1)
    for x, y in zip(a, again):
        np.testing.assert_array_equal(x, y)
