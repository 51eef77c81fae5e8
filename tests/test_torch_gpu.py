"""The port's CUDA kernels and its main path on a GPU, against the plain
torch versions on the same inputs.

Every test here needs a CUDA GPU (marker ``gpu``) and skips where torch
sees none. The file imports no jax, so it also runs where jax is not
installed:

    python -m pytest tests/test_torch_gpu.py -q --noconftest

Tolerance: exact equality (integer statistics, pair lists, labels).
"""

import functools

import numpy as np
import pytest
import torch

from uniprot_kmer_based_clustering_tpu_torch import PipelineConfig
from uniprot_kmer_based_clustering_tpu_torch.ops import bitmul, pairlist, stats
from uniprot_kmer_based_clustering_tpu_torch.pipeline import run_pipeline
from uniprot_kmer_based_clustering_tpu_torch.similarity import pairwise as tpw

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def synth_fasta(tmp_path_factory):
    from bench_scale import synth_proteins

    seq_buf, offsets, classes = synth_proteins(1200, seed=3)
    path = tmp_path_factory.mktemp("synth") / "synth.fasta"
    with open(path, "w") as f:
        for i in range(1200):
            seq = seq_buf[offsets[i] : offsets[i + 1]].tobytes().decode()
            f.write(f">S{i:05d}|FEATURES|UNIPROT|c{classes[i]}|g{i}\n{seq}\n")
    return str(path)


@pytest.mark.parametrize("i0", [0, 512])
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("tile", [512, 96])
def test_k1_matches_reference(cuda, i0, signed, tile):
    """Strip blocks at (i0, i0), counts in [0, 40) or signed in [-50, 400)
    with w_thresh 5; tile 96 takes the kernel's scalar-load path."""
    rng = np.random.default_rng(i0 + 7 * signed + tile)
    n, s = 1500, 1536 - i0 - (1536 - i0) % tile
    lo, hi, thr, wt = (-50, 400, 100, 5) if signed else (0, 40, 10, 1)
    counts = torch.from_numpy(
        rng.integers(lo, hi, (tile * 2, s)).astype(np.int32)
    ).to(cuda)
    cls = torch.from_numpy(rng.integers(0, 4, s).astype(np.int32)).to(cuda)
    kw = dict(i_off=i0, j_off=i0, n=n, threshold=thr, w_thresh=wt, tile=tile)
    before = stats.stats_from_counts_into.launches
    rs, th, _ = stats.stats_from_counts(counts, cls[: tile * 2], cls, **kw)
    rs_ref, th_ref, _ = stats.stats_from_counts_reference(
        counts, cls[: tile * 2], cls, **kw
    )
    torch.cuda.synchronize()
    assert stats.stats_from_counts_into.launches == before + 1
    assert torch.equal(rs, rs_ref)
    assert torch.equal(th, th_ref)
    assert int(th.sum()) > 0


def test_k1_refuses_what_it_cannot_take(cuda):
    counts = torch.zeros((64, 64), dtype=torch.int32, device=cuda)
    cls = torch.zeros(64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiples of 32"):
        stats.stats_from_counts(counts, cls, cls, i_off=0, j_off=0, n=64,
                                threshold=1, tile=16)
    with pytest.raises(ValueError, match="contiguous int32"):
        stats.stats_from_counts(counts.t(), cls, cls, i_off=0, j_off=0,
                                n=64, threshold=1, tile=32)


@pytest.mark.parametrize("weighted", [False, True])
def test_sweep_mxu_gpu_matches_cpu(cuda, weighted):
    rng = np.random.default_rng(5)
    n_pad, w, n = 1536, 64, 1500
    words = rng.integers(0, 2**32, size=(n_pad, w), dtype=np.uint32)
    words &= rng.integers(0, 2**32, size=(n_pad, w), dtype=np.uint32)
    words &= rng.integers(0, 2**32, size=(n_pad, w), dtype=np.uint32)
    words[n:] = 0
    cls = rng.integers(0, 4, size=n_pad).astype(np.int32)
    wts = rng.integers(1, 50, size=w * 32).astype(np.int8) if weighted else None
    thr = 900 if weighted else 35
    t = torch.from_numpy(words.view(np.int32))
    for strip in (512, 1536):
        got = bitmul.sweep_mxu(t.to(cuda), torch.from_numpy(cls).to(cuda), n,
                               thr, strip=strip, weights=wts)
        want = bitmul.sweep_mxu(t, torch.from_numpy(cls), n, thr,
                                strip=strip, weights=wts)
        assert np.array_equal(want[0], got[0])
        assert np.array_equal(want[1], got[1])


@pytest.mark.parametrize("weighting", ["none", "blosum62"])
def test_pipeline_gpu_matches_cpu(cuda, synth_fasta, weighting):
    """5 strips of 256 rows, tile 128: K1 launches once per strip."""
    cfg = PipelineConfig(engine="mxu", tile=128, strip=256,
                         weighting=weighting)
    before = stats.stats_from_counts_into.launches
    gpu = run_pipeline(synth_fasta, cfg, device=cuda)
    assert stats.stats_from_counts_into.launches == before + 5
    cpu = run_pipeline(synth_fasta, cfg, device="cpu")
    assert gpu.parity_report() == cpu.parity_report()
    assert gpu.parity_report()["pairs_over_threshold"] > 0
    assert np.array_equal(gpu.pairwise.pairs, cpu.pairwise.pairs)
    assert np.array_equal(gpu.cluster_labels, cpu.cluster_labels)


@pytest.fixture
def launched(monkeypatch):
    """The names of the ``csrc/stats_epilogue.cu`` entries launched
    while the test runs (``ukc_stats_epilogue_append_into`` is K1 with
    the survivor append)."""
    names = []
    real = stats._launch

    def counted(name, *args, **kw):
        names.append(name)
        return real(name, *args, **kw)

    monkeypatch.setattr(stats, "_launch", counted)
    return names


@pytest.mark.parametrize("weighting", ["none", "blosum62"])
def test_pipeline_epilogue_route_matches_two_pass(cuda, synth_fasta,
                                                  launched, weighting):
    """3 strips of 512 rows, tile 512: the default extraction takes the
    survivors K1 appended (no product, one fetch) and gives two-pass's
    pairs, counters and clusters."""
    cfg = PipelineConfig(engine="mxu", tile=512, strip=512,
                         weighting=weighting)
    got = run_pipeline(synth_fasta, cfg, device=cuda)
    trace = dict(tpw.last_trace)
    assert launched == ["ukc_stats_epilogue_append_into"] * 3
    two = run_pipeline(synth_fasta, PipelineConfig(
        engine="mxu", tile=512, strip=512, weighting=weighting,
        extract="two_pass"), device=cuda)
    assert tpw.last_trace["extract_products"] > 0
    assert trace["extract_products"] == 0 and trace["extract_syncs"] == 1
    assert trace["epilogue_pairs"] == len(got.pairwise.pairs) > 0
    assert got.parity_report() == two.parity_report()
    assert np.array_equal(got.pairwise.pairs, two.pairwise.pairs)
    assert np.array_equal(got.cluster_labels, two.cluster_labels)


@pytest.mark.parametrize("i0,j0", [(0, 1024), (512, 512)])
@pytest.mark.parametrize("signed", [False, True])
def test_k2_matches_reference(cuda, i0, j0, signed):
    """Every tile of a [1024, 1024] block, off-diagonal and diagonal."""
    rng = np.random.default_rng(i0 + j0 + signed)
    lo, hi, thr, wt = (-50, 400, 100, 5) if signed else (0, 40, 10, 1)
    counts = torch.from_numpy(
        rng.integers(lo, hi, (1024, 1024)).astype(np.int32)
    ).to(cuda)
    cls = torch.from_numpy(rng.integers(0, 4, 2048).astype(np.int32)).to(cuda)
    ca, cb = cls[i0 : i0 + 1024], cls[j0 : j0 + 1024]
    kw = dict(n=1900, threshold=thr, w_thresh=wt, tile=512)
    before = stats.stats_from_counts_traced_into.launches
    rs, bh = stats.stats_from_counts_traced(counts, ca, cb, i0, j0, **kw)
    rs_ref, bh_ref = stats.stats_from_counts_traced_reference(
        counts, ca, cb, i0, j0, **kw
    )
    torch.cuda.synchronize()
    assert stats.stats_from_counts_traced_into.launches == before + 1
    assert torch.equal(rs, rs_ref)
    assert torch.equal(bh, bh_ref)
    assert int(bh.sum()) > 0


# (s, j, i_off, j_off, n, tile) of the accumulate-into cases: strips 0 and
# 6 of the 10,619-protein sweep, a ragged n, the scalar-load path (tile
# 96, rows above the block's first column), and for K2 a block wholly
# below the pair diagonal
_INTO_CASES = {
    "strip0": (1536, 10752, 0, 0, 10619, 512),
    "strip6": (1536, 1536, 9216, 9216, 10619, 512),
    "ragged": (1024, 2048, 512, 512, 1999, 512),
    "tile96": (480, 960, 96, 192, 1000, 96),
    "below": (512, 512, 1024, 0, 2000, 512),
}


def _into_case(cuda, name, signed):
    """Counts, classes and NON-ZERO accumulators: row stats in [0, 1000)
    (max lanes ≥ 0, as accumulators that start at 0 keep them) and a
    block_hits two tiles wider and one taller than the block, so the view
    handed over sits at tile offset (1, 2)."""
    s, j, i_off, j_off, n, tile = _INTO_CASES[name]
    rng = np.random.default_rng(len(name) + 3 * signed)
    lo, hi, thr, wt = (-50, 400, 100, 5) if signed else (0, 40, 10, 1)

    def dev(x):
        return torch.from_numpy(x.astype(np.int32)).to(cuda)

    counts = dev(rng.integers(lo, hi, (s, j)))
    ca, cb = dev(rng.integers(0, 4, s)), dev(rng.integers(0, 4, j))
    rs0 = dev(rng.integers(0, 1000, (s, 8)))
    bh0 = dev(rng.integers(0, 9, (s // tile + 1, j // tile + 2, 2)))
    kw = dict(n=n, threshold=thr, w_thresh=wt, tile=tile)
    return counts, ca, cb, rs0, bh0, i_off, j_off, kw


@pytest.mark.parametrize("name", ["strip0", "strip6", "ragged", "tile96"])
@pytest.mark.parametrize("signed", [False, True])
def test_k1_into_matches_reference(cuda, name, signed):
    """K1 into a strip stores its rows over whatever row_stats held and
    adds its tile hits into the block_hits view, exactly as its plain
    version does."""
    counts, ca, cb, rs0, bh0, i_off, j_off, kw = _into_case(cuda, name,
                                                            signed)
    got, want = (rs0.clone(), bh0.clone()), (rs0.clone(), bh0.clone())
    before = stats.stats_from_counts_into.launches
    stats.stats_from_counts_into(counts, ca, cb, got[0], got[1][1:, 2:],
                                 i_off=i_off, j_off=j_off, **kw)
    stats.stats_from_counts_into_reference(counts, ca, cb, want[0],
                                           want[1][1:, 2:], i_off=i_off,
                                           j_off=j_off, **kw)
    torch.cuda.synchronize()
    assert stats.stats_from_counts_into.launches == before + 1
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert not torch.equal(got[1], bh0)


@pytest.mark.parametrize("name", list(_INTO_CASES))
@pytest.mark.parametrize("signed", [False, True])
def test_k2_into_matches_reference(cuda, name, signed):
    """K2 merges into non-zero accumulators (sums added, max lanes by
    max) exactly as its plain version; a block wholly below the diagonal
    leaves them as they were."""
    counts, ca, cb, rs0, bh0, i_off, j_off, kw = _into_case(cuda, name,
                                                            signed)
    got, want = (rs0.clone(), bh0.clone()), (rs0.clone(), bh0.clone())
    before = stats.stats_from_counts_traced_into.launches
    stats.stats_from_counts_traced_into(counts, ca, cb, got[0],
                                        got[1][1:, 2:], i_off, j_off, **kw)
    stats.stats_from_counts_traced_into_reference(
        counts, ca, cb, want[0], want[1][1:, 2:], i_off, j_off, **kw)
    torch.cuda.synchronize()
    assert stats.stats_from_counts_traced_into.launches == before + 1
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    if name == "below":
        assert torch.equal(got[0], rs0) and torch.equal(got[1], bh0)
    else:
        assert not torch.equal(got[1], bh0)


def _pair_keys(i, j, c):
    """(i, j, count) tensors as one host array sorted by (i, j)."""
    out = np.stack([x.cpu().numpy().astype(np.int64) for x in (i, j, c)], 1)
    return out[np.lexsort((out[:, 1], out[:, 0]))]


@pytest.mark.parametrize("cap", ["room", "short"])
@pytest.mark.parametrize("include_same", [False, True])
@pytest.mark.parametrize("name", ["strip0", "strip6", "ragged", "tile96"])
def test_k1_appends_the_survivor_mask(cuda, launched, name, include_same,
                                      cap):
    """K1 handed pair buffers (vec4 path at tile 512, scalar path at tile
    96) stores the same row stats and tile hits as without them, and
    appends exactly survivor_mask's pairs (signed counts where same-class
    pairs survive too); with room for a third of them (``short``) the
    cursor still counts all, and the slots it stored are survivors, each
    once."""
    counts, ca, cb, rs0, bh0, i_off, j_off, kw = _into_case(
        cuda, name, signed=include_same)
    plain, got = (rs0.clone(), bh0.clone()), (rs0.clone(), bh0.clone())
    stats.stats_from_counts_into(counts, ca, cb, plain[0], plain[1][1:, 2:],
                                 i_off=i_off, j_off=j_off, **kw)
    mask = stats.survivor_mask(counts, ca, cb, i_off, j_off, n=kw["n"],
                               threshold=kw["threshold"],
                               include_same=include_same)
    r, c = torch.nonzero(mask, as_tuple=True)
    want = _pair_keys(i_off + r, j_off + c, counts[r, c])
    total = len(want)
    room = total + 7 if cap == "room" else total // 3
    pairs = pairlist.new_pair_buffers(room, cuda)
    before = stats.stats_from_counts_into.launches
    stats.stats_from_counts_into(counts, ca, cb, got[0], got[1][1:, 2:],
                                 i_off=i_off, j_off=j_off, pairs=pairs,
                                 include_same=include_same, **kw)
    torch.cuda.synchronize()
    assert stats.stats_from_counts_into.launches == before + 1
    assert launched == ["ukc_stats_epilogue_into",
                        "ukc_stats_epilogue_append_into"]
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    assert total > 0 and int(pairs[3]) == total
    stored = _pair_keys(*(b[: min(room, total)] for b in pairs[:3]))
    if cap == "room":
        assert np.array_equal(stored, want)
        assert bool((pairs[2][total:] == -1).all())
    else:
        key = want[:, 0] * (1 << 32) + want[:, 1]
        got_key = stored[:, 0] * (1 << 32) + stored[:, 1]
        at = np.searchsorted(key, got_key)
        assert len(stored) == room == len(np.unique(got_key))
        assert np.array_equal(want[np.minimum(at, total - 1)], stored)


def test_epilogue_repeats_exactly(cuda):
    """Two identical calls of each entry give identical results: integer
    atomics merge to the same sums in any order."""
    counts, ca, cb, rs0, bh0, i_off, j_off, kw = _into_case(cuda, "ragged",
                                                            True)
    runs = []
    for _ in range(2):
        k1 = (rs0.clone(), bh0.clone())
        k2 = (rs0.clone(), bh0.clone())
        stats.stats_from_counts_into(counts, ca, cb, k1[0], k1[1][1:, 2:],
                                     i_off=i_off, j_off=j_off, **kw)
        stats.stats_from_counts_traced_into(counts, ca, cb, k2[0],
                                            k2[1][1:, 2:], i_off, j_off,
                                            **kw)
        runs.append(k1 + k2)
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_epilogue_wrappers_do_not_synchronise(cuda):
    """Every K1/K2 wrapper, the public ones with fresh outputs included,
    runs under torch.cuda.set_sync_debug_mode("error"): no host copy, no
    .item(), no stream synchronisation."""
    counts, ca, cb, rs0, bh0, i_off, j_off, kw = _into_case(cuda, "ragged",
                                                            False)
    stats.stats_from_counts(counts, ca, cb, i_off=i_off, j_off=j_off, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        k1 = stats.stats_from_counts(counts, ca, cb, i_off=i_off,
                                     j_off=j_off, **kw)
        k2 = stats.stats_from_counts_traced(counts, ca, cb, i_off, j_off,
                                            **kw)
        stats.stats_from_counts_into(counts, ca, cb, rs0, bh0[1:, 2:],
                                     i_off=i_off, j_off=j_off, **kw)
        stats.stats_from_counts_traced_into(counts, ca, cb, rs0, bh0[1:, 2:],
                                            i_off, j_off, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want1 = stats.stats_from_counts_reference(counts, ca, cb, i_off=i_off,
                                              j_off=j_off, **kw)
    want2 = stats.stats_from_counts_traced_reference(counts, ca, cb, i_off,
                                                     j_off, **kw)
    assert torch.equal(k1[0], want1[0]) and torch.equal(k1[1], want1[1])
    assert torch.equal(k2[0], want2[0]) and torch.equal(k2[1], want2[1])


@pytest.mark.parametrize("schedule", ["strips", "scan", "fused",
                                      "appended"])
def test_sweep_loops_do_not_synchronise(cuda, schedule):
    """The strip loop (K1 once a strip) and the scan loop (K2 once a step,
    with fused candidates too) run under
    torch.cuda.set_sync_debug_mode("error") up to the sweep's final
    device→host copy, and give the CPU loops' statistics."""
    rng = np.random.default_rng(12)
    words = rng.integers(0, 2**32, size=(1536, 64), dtype=np.uint32)
    words &= rng.integers(0, 2**32, size=(1536, 64), dtype=np.uint32)
    words &= rng.integers(0, 2**32, size=(1536, 64), dtype=np.uint32)
    words[1500:] = 0
    cls = torch.from_numpy(rng.integers(0, 4, 1536).astype(np.int32))
    w = torch.from_numpy(words.view(np.int32))
    kw = dict(n=1500, threshold=35, block=512, w_thresh=1, word_chunk=0,
              stats_engine="pallas")
    pairs = (np.stack(np.triu_indices(3), axis=1) * 512).astype(np.int32)

    def loop(ww, cc):
        if schedule == "strips":
            return bitmul._strip_sweep(ww, cc, None, strip=512, **kw)
        if schedule == "appended":
            bufs = pairlist.new_pair_buffers(pairlist.EPILOGUE_PAIR_CAP,
                                             ww.device)
            return bitmul._strip_sweep(ww, cc, None, strip=512, pairs=bufs,
                                       **kw)
        return bitmul._scan_sweep(
            ww, cc, None, pairs, bs=512, fused_same=False,
            fused_k=4096 if schedule == "fused" else 0, **kw)[:2]

    want = loop(w, cls)
    ww, cc = w.to(cuda), cls.to(cuda)
    loop(ww, cc)
    torch.cuda.synchronize()
    before = (stats.stats_from_counts_into.launches,
              stats.stats_from_counts_traced_into.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = loop(ww, cc)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launched = (stats.stats_from_counts_into.launches - before[0],
                stats.stats_from_counts_traced_into.launches - before[1])
    assert launched == ((3, 0) if schedule in ("strips", "appended")
                        else (0, 6))
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("schedule", ["strips", "scan"])
def test_sweep_mxu_async_dispatch_does_not_synchronise(cuda, schedule):
    """sweep_mxu_async, with numpy classes and weights (copied up from
    pinned memory), queues three sweeps back to back under
    torch.cuda.set_sync_debug_mode("error"); each launches K1 once a
    strip or K2 once a step, and each finalize equals the CPU sweep."""
    rng = np.random.default_rng(13)
    words = rng.integers(0, 2**32, size=(1536, 64), dtype=np.uint32)
    words &= rng.integers(0, 2**32, size=(1536, 64), dtype=np.uint32)
    words[1500:] = 0
    cls = rng.integers(0, 4, 1536).astype(np.int32)
    wts = rng.integers(1, 30, 64 * 32).astype(np.int8)
    w = torch.from_numpy(words.view(np.int32))
    kw = dict(strip=512, block=512, schedule=schedule, weights=wts)
    want = bitmul.sweep_mxu(w, cls, 1500, 1900, **kw)
    ww = w.to(cuda)
    bitmul.sweep_mxu(ww, cls, 1500, 1900, **kw)
    torch.cuda.synchronize()
    before = (stats.stats_from_counts_into.launches,
              stats.stats_from_counts_traced_into.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        dispatched = [bitmul.sweep_mxu_async(ww, cls, 1500, 1900, **kw)
                      for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launched = (stats.stats_from_counts_into.launches - before[0],
                stats.stats_from_counts_traced_into.launches - before[1])
    assert launched == ((9, 0) if schedule == "strips" else (0, 18))
    for handles, finalize in dispatched:
        rs, th, tiles = finalize(handles)
        assert np.array_equal(rs, want[0]) and np.array_equal(th, want[1])
    assert int(want[1][:, 0].sum()) > 0


def test_headline_bench_on_the_card(cuda, monkeypatch, capsys):
    """benches.headline at 2,000 synthetic proteins on the card: the
    oracle's counters, K1 once a strip of the warm sweep and no K2, the
    card's name and power limit in the line."""
    import json
    import os

    from uniprot_kmer_based_clustering_tpu_torch.benches import (
        common,
        headline,
    )
    from uniprot_kmer_based_clustering_tpu_torch.kmers import (
        build_index,
        encode_kmers,
    )

    for k in [k for k in os.environ if k.startswith("UKC_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("UKC_BENCH_N", "2000")
    monkeypatch.setenv("UKC_BENCH_REPS", "2")
    assert headline.main() == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    seq_buf, offsets, classes = common.synth_proteins(2000, seed=0)
    codes, koff = encode_kmers(seq_buf, offsets, 5)
    want, _ = common.index_oracle(build_index(codes, koff, 5), classes, 2000)
    _, _, ns = bitmul.resolve_schedule(2048, 512)
    assert line["counters"] == want and line["parity"] == "oracle-exact"
    assert line["kernels"] == {"K1": ns, "K2": 0}
    assert line["value"] > 0 and line["vs_baseline"] > 0
    assert line["device"] == torch.cuda.get_device_name(0)
    assert line["power_limit_w"] is None or line["power_limit_w"] > 0


def _bench_on_the_card(monkeypatch, capsys, bench, **knobs):
    """Run ``bench.main()`` on the card with only ``knobs`` set; its one
    JSON line."""
    import json
    import os

    for k in [k for k in os.environ if k.startswith("UKC_")]:
        monkeypatch.delenv(k)
    for k, v in knobs.items():
        monkeypatch.setenv(k, str(v))
    assert bench.main() == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device"] == torch.cuda.get_device_name(0)
    assert line["power_limit_w"] is None or line["power_limit_w"] > 0
    return line


def _synth_oracle(n):
    from uniprot_kmer_based_clustering_tpu_torch.benches import common
    from uniprot_kmer_based_clustering_tpu_torch.kmers import (
        build_index,
        encode_kmers,
    )

    seq_buf, offsets, classes = common.synth_proteins(n, seed=0)
    codes, koff = encode_kmers(seq_buf, offsets, 5)
    return common.index_oracle(build_index(codes, koff, 5), classes, n)


def test_pod_bench_on_the_card(cuda, monkeypatch, capsys):
    """benches.pod at 2,000 synthetic proteins on one card (D = 1): the
    oracle's counters and pairs, K1 once a ring sub-step of a warm sweep
    (``count_substeps``) and no K2, scaling efficiency 1.0."""
    from uniprot_kmer_based_clustering_tpu_torch.benches import pod
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        count_substeps,
    )

    line = _bench_on_the_card(monkeypatch, capsys, pod, UKC_BENCH_N=2000)
    want, pairs = _synth_oracle(2000)
    assert line["counters"] == want and line["parity"] == "oracle-exact"
    assert (line["extracted_pairs"], line["extracted_max"]) == (
        len(pairs), int(pairs[:, 2].max()))
    assert line["kernels"] == {
        "K1": count_substeps(1, line["n_pad"], line["block_tile"]), "K2": 0}
    assert line["devices"] == 1 and line["scaling_efficiency"] == 1.0
    assert line["value"] > 0 and line["fused_seconds"] > 0


def test_cluster_bench_on_the_card(cuda, monkeypatch, capsys):
    """benches.cluster's components at 30,000 proteins (the scan: K2 once
    a block-pair step, no K1) equal to the host union-find, and its
    agglomerative stage at 2,000 with the scipy reference gate."""
    from uniprot_kmer_based_clustering_tpu_torch.benches import cluster

    line = _bench_on_the_card(
        monkeypatch, capsys, cluster, UKC_CLUSTER_COMPONENTS_N=30000,
        UKC_CLUSTER_AGG_N=2000, UKC_CLUSTER_TREE=0)
    sched, _, ns = bitmul.resolve_schedule(32256, 512)
    assert sched == "scan"
    assert line["kernels"] == {"K1": 0, "K2": ns * (ns + 1) // 2}
    assert line["components_pairs"] > 0 and line["value"] > 0
    assert line["components_oracle_checked"] > 0
    assert line["agg_gates"].startswith("reference exact + structural")
    assert line["agg_mode"] == "one-shot matmul"


def test_query_bench_on_the_card(cuda, monkeypatch, capsys):
    """benches.query at 2,000 proteins with the stream point and a
    two-shard CPU mesh probe: host-exact, and no kernel of K1–K4."""
    from uniprot_kmer_based_clustering_tpu_torch.benches import query

    line = _bench_on_the_card(monkeypatch, capsys, query, UKC_BENCH_N=2000,
                              UKC_QUERY_STREAM=1, UKC_QUERY_MESH_D=2)
    assert line["parity"].startswith("host-exact (256/256")
    assert line["kernels"] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    assert line["stream_mode"]["parity"] == "host-exact (256/256)"
    assert "error" not in line["mesh_virtual_cpu"]
    assert line["max_sustained_qps"] > 0


@pytest.mark.parametrize("tile", [128, 96])
def test_k4_matches_reference(cuda, tile):
    """K4 on every tile pair of 384 rows (n 370, W 70: a ragged last word
    chunk) against its plain version."""
    from uniprot_kmer_based_clustering_tpu_torch.ops import popcount

    rng = np.random.default_rng(tile)
    words = rng.integers(0, 2**32, size=(384, 70), dtype=np.uint32)
    words &= rng.integers(0, 2**32, size=(384, 70), dtype=np.uint32)
    words[370:] = 0
    w = torch.from_numpy(words.view(np.int32)).to(cuda)
    cls = torch.from_numpy(rng.integers(0, 3, 384).astype(np.int32)).to(cuda)
    before = popcount.popcount_sweep.launches
    rs, th, _ = popcount.popcount_sweep(w, cls, 370, 150, tile)
    rs_ref, th_ref, _ = popcount.sweep_reference(w, cls, 370, 150, tile)
    torch.cuda.synchronize()
    assert popcount.popcount_sweep.launches == before + 1
    assert torch.equal(rs, rs_ref)
    assert torch.equal(th, th_ref)
    assert int(th[:, 0].sum()) > 0


@pytest.mark.parametrize("weighted", [False, True])
def test_scan_and_fused_gpu_match_cpu(cuda, weighted):
    """The scan (3 strips of 512 → 6 steps, K2 once each) with fused
    extraction, on the GPU and on the CPU."""
    from uniprot_kmer_based_clustering_tpu_torch.similarity import pairwise

    rng = np.random.default_rng(6)
    words = rng.integers(0, 2**32, size=(1536, 64), dtype=np.uint32)
    words &= rng.integers(0, 2**32, size=(1536, 64), dtype=np.uint32)
    words &= rng.integers(0, 2**32, size=(1536, 64), dtype=np.uint32)
    words[1500:] = 0
    cls = rng.integers(0, 4, size=1536).astype(np.int32)
    wts = rng.integers(1, 50, size=64 * 32).astype(np.int8) if weighted else None
    thr = 900 if weighted else 35
    t = torch.from_numpy(words.view(np.int32))
    kw = dict(strip=512, schedule="scan", weights=wts, fused_k=4096)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        before = stats.stats_from_counts_traced_into.launches
        rs, th, tiles, cands = bitmul.sweep_mxu(
            t.to(dev), torch.from_numpy(cls).to(dev), 1500, thr, **kw
        )
        launched = stats.stats_from_counts_traced_into.launches - before
        pairs = pairwise.extract_pairs_fused(
            t.to(dev), cls, th, tiles, cands, n=1500, threshold=thr,
            weights=wts,
        )
        out[dev.type] = (rs, th, pairs, launched)
    assert out["cuda"][3] == 6 and out["cpu"][3] == 0
    for a, b in zip(out["cuda"][:3], out["cpu"][:3]):
        assert np.array_equal(a, b)
    assert len(out["cuda"][2]) > 0


def test_popcount_pipeline_gpu_matches_cpu(cuda, synth_fasta):
    """engine=popcount: K4 once per sweep at tile 128."""
    from uniprot_kmer_based_clustering_tpu_torch.ops import popcount

    cfg = PipelineConfig(engine="popcount", tile=128, strip=256)
    before = popcount.popcount_sweep.launches
    gpu = run_pipeline(synth_fasta, cfg, device=cuda)
    assert popcount.popcount_sweep.launches == before + 1
    cpu = run_pipeline(synth_fasta, cfg, device="cpu")
    assert gpu.parity_report() == cpu.parity_report()
    assert gpu.parity_report()["pairs_over_threshold"] > 0
    assert np.array_equal(gpu.pairwise.pairs, cpu.pairwise.pairs)


@pytest.mark.parametrize("dot_dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("tile", [128, 256, 384])
def test_k3_matches_reference(cuda, dot_dtype, weighted, tile):
    """K3 on every tile pair of 768 rows (n 750; W 70 padded to the
    32-word chunk) against its plain version, the MXU sweep with the
    plain epilogue; signed weights with w_thresh 5 when weighted. Tile
    384 puts a tile boundary inside a 256-row sub-tile."""
    from uniprot_kmer_based_clustering_tpu_torch.ops import tri_mxu

    rng = np.random.default_rng(tile + 2 * weighted)
    words = rng.integers(0, 2**32, size=(768, 70), dtype=np.uint32)
    words &= rng.integers(0, 2**32, size=(768, 70), dtype=np.uint32)
    words &= rng.integers(0, 2**32, size=(768, 70), dtype=np.uint32)
    words[750:] = 0
    w = torch.from_numpy(words.view(np.int32)).to(cuda)
    cls = torch.from_numpy(rng.integers(0, 3, 768).astype(np.int32)).to(cuda)
    wts = rng.integers(-20, 41, 70 * 32).astype(np.int8) if weighted else None
    thr, wt = (300, 5) if weighted else (35, 1)
    before = tri_mxu.tri_mxu_sweep.launches
    got = tri_mxu.sweep_tri_mxu(w, cls, 750, thr, tile, word_chunk_words=32,
                                weights=wts, w_thresh=wt, dot_dtype=dot_dtype)
    assert tri_mxu.tri_mxu_sweep.launches == before + 1
    want = bitmul.sweep_mxu(w, cls, 750, thr, block=tile, weights=wts,
                            w_thresh=wt, stats_engine="xla")
    assert np.array_equal(want[0], got[0])
    assert np.array_equal(want[1], got[1])
    assert got[1].sum() > 0


def test_k3_matches_sweep_mxu(cuda):
    """K3's whole-triangle statistics equal the MXU sweep's (strips + K1)
    at tile 256."""
    from uniprot_kmer_based_clustering_tpu_torch.ops import tri_mxu

    rng = np.random.default_rng(9)
    words = rng.integers(0, 2**32, size=(1024, 64), dtype=np.uint32)
    words &= rng.integers(0, 2**32, size=(1024, 64), dtype=np.uint32)
    words[1000:] = 0
    w = torch.from_numpy(words.view(np.int32)).to(cuda)
    cls = torch.from_numpy(rng.integers(0, 4, 1024).astype(np.int32)).to(cuda)
    got = tri_mxu.sweep_tri_mxu(w, cls, 1000, 140, tile=256)
    want = bitmul.sweep_mxu(w, cls, 1000, 140, block=256)
    assert np.array_equal(want[0], got[0])
    assert np.array_equal(want[1], got[1])
    assert got[1].sum() > 0


@pytest.mark.parametrize("dot_dtype", ["int8", "bfloat16"])
def test_k3_exact_at_the_bf16_guard_edge(cuda, dot_dtype):
    """The widest sums the bf16 guard admits: 8,064 words, weight 64, so
    an all-ones pair counts 8,064 · 32 · 64 = 16,515,072, just under
    2^24. Even rows are all ones, odd rows 1/8 dense (so no row's lane
    sums pass int32); K3 equals the plain version exactly."""
    from uniprot_kmer_based_clustering_tpu_torch.ops import tri_mxu

    rng = np.random.default_rng(11)
    words = rng.integers(0, 2**32, size=(256, 8064), dtype=np.uint32)
    words &= rng.integers(0, 2**32, size=(256, 8064), dtype=np.uint32)
    words &= rng.integers(0, 2**32, size=(256, 8064), dtype=np.uint32)
    words[::2] = 0xFFFFFFFF
    w = torch.from_numpy(words.view(np.int32)).to(cuda)
    cls = torch.from_numpy(rng.integers(0, 2, 256).astype(np.int32)).to(cuda)
    wts = np.full(8064 * 32, 64, np.int8)
    thr = 16_000_000
    got = tri_mxu.sweep_tri_mxu(w, cls, 256, thr, tile=128, weights=wts,
                                dot_dtype=dot_dtype)
    want = bitmul.sweep_mxu(w, cls, 256, thr, block=128, weights=wts,
                            stats_engine="xla")
    assert np.array_equal(want[0], got[0])
    assert np.array_equal(want[1], got[1])
    assert int(got[0][:, 3].max()) == 16_515_072
    assert got[1].sum() > 0


@pytest.mark.parametrize("dot_dtype", ["int8", "bfloat16"])
def test_k3_ragged_rows_and_words(cuda, dot_dtype):
    """n 601 (not a multiple of the 256 x 128 sub-tile; N_pad 640, so the
    last row block reaches past N_pad) and W 69 words at a word chunk of
    1 (not a multiple of a stage's 4 or 2 words: the wrapper pads to 72),
    weighted, against the plain version."""
    from uniprot_kmer_based_clustering_tpu_torch.ops import tri_mxu

    rng = np.random.default_rng(13)
    words = rng.integers(0, 2**32, size=(640, 69), dtype=np.uint32)
    words &= rng.integers(0, 2**32, size=(640, 69), dtype=np.uint32)
    words[601:] = 0
    w = torch.from_numpy(words.view(np.int32)).to(cuda)
    cls = torch.from_numpy(rng.integers(0, 3, 640).astype(np.int32)).to(cuda)
    wts = rng.integers(-20, 41, 69 * 32).astype(np.int8)
    before = tri_mxu.tri_mxu_sweep.launches
    got = tri_mxu.sweep_tri_mxu(w, cls, 601, 1600, tile=128,
                                word_chunk_words=1, weights=wts, w_thresh=5,
                                dot_dtype=dot_dtype)
    assert tri_mxu.tri_mxu_sweep.launches == before + 1
    want = bitmul.sweep_mxu(w, cls, 601, 1600, block=128, weights=wts,
                            w_thresh=5, stats_engine="xla")
    assert np.array_equal(want[0], got[0])
    assert np.array_equal(want[1], got[1])
    assert 0 < got[1].sum() < 601 * 600 // 2


def test_k3_refuses_what_it_cannot_take(cuda):
    from uniprot_kmer_based_clustering_tpu_torch.ops import tri_mxu

    w = torch.zeros((384, 8), dtype=torch.int32, device=cuda)
    cls = torch.zeros(384, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiples of 128"):
        tri_mxu.tri_mxu_sweep(w, cls, 384, 1, tile=192)
    with pytest.raises(ValueError, match="contiguous int32"):
        tri_mxu.tri_mxu_sweep(w.t().contiguous().t(), cls, 384, 1, tile=128,
                              word_chunk_words=8)


def _stream_problem(seed=21, rows=1536, n=1500, w=64):
    """Host words (uint32 [rows, w], ~1/8 dense), classes of length rows
    (−1 past n), the incidence lists of the same bits, and int8 weights."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(rows, w), dtype=np.uint32)
    words &= rng.integers(0, 2**32, size=(rows, w), dtype=np.uint32)
    words &= rng.integers(0, 2**32, size=(rows, w), dtype=np.uint32)
    words[n:] = 0
    cls = rng.integers(0, 4, size=rows).astype(np.int32)
    cls[n:] = -1
    bits = np.unpackbits(words.view(np.uint8), axis=1, bitorder="little")
    inc_p, inc_r = np.nonzero(bits)
    wts = rng.integers(1, 50, size=w * 32).astype(np.int8)
    return words, cls, inc_p.astype(np.int32), inc_r.astype(np.int32), wts


@pytest.mark.parametrize("kw", [
    dict(bs=512), dict(bs=512, max_group=1), dict(bs=1024),
    dict(bs=512, word_chunk=16), dict(bs=512, weighted=True),
    dict(bs=512, csr=True),
], ids=["bs512", "max-group-1", "bs1024-padded", "word-chunk", "weighted",
        "csr"])
def test_stream_sweep_gpu_matches_scan(cuda, kw):
    """The stream sweep on the card equals the in-core scan sweep
    (row_stats, tile_hits), single- and multi-group, with row padding
    (bs 1024 pads 1536 rows to 2048), contraction chunks, weights and the
    CSR block source, and launches K2 exactly once a step."""
    from uniprot_kmer_based_clustering_tpu_torch.ops import stream

    kw = dict(kw)
    words, cls, inc_p, inc_r, wts = _stream_problem()
    weights = wts if kw.pop("weighted", False) else None
    thr = 900 if weights is not None else 35
    source = None
    if kw.pop("csr", False):
        source = stream.CSRBlockSource(inc_p, inc_r, 1536, 64)
    t = torch.from_numpy(words.view(np.int32)).to(cuda)
    want = bitmul.sweep_mxu(t, torch.from_numpy(cls).to(cuda), 1500, thr,
                            strip=512, schedule="scan", weights=weights)
    before = (stats.stats_from_counts_traced_into.launches,
              stats.stats_from_counts_into.launches)
    got = stream.sweep_mxu_stream(
        None if source else words, cls, 1500, thr, block=512,
        weights=weights, block_source=source, device=cuda, **kw)
    trace = stream.last_trace
    nbk = trace["nbk"]
    assert trace["steps"] == nbk * (nbk + 1) // 2
    assert (stats.stats_from_counts_traced_into.launches - before[0]
            == trace["steps"])
    assert stats.stats_from_counts_into.launches == before[1]
    rows = want[0].shape[0]
    assert np.array_equal(got[0][:rows], want[0])
    assert not got[0][rows:].any()
    nb = rows // 512
    keep = (got[2][0] < nb) & (got[2][1] < nb)
    assert np.array_equal(got[1][keep], want[1])
    assert not got[1][~keep].any() and got[1].sum() > 0


@pytest.mark.parametrize("mode", ["host", "csr", "fused", "grouped",
                                  "window", "packed-multigroup"])
def test_stream_extraction_gpu_matches_in_core(cuda, mode):
    """Every stream route to the pair list on the card (one pass from
    either block source, fused, grouped, row windows, packed with several
    groups) equals the in-core two-pass extraction."""
    from uniprot_kmer_based_clustering_tpu_torch.ops import stream
    from uniprot_kmer_based_clustering_tpu_torch.similarity import pairwise

    words, cls, inc_p, inc_r, _ = _stream_problem()
    t = torch.from_numpy(words.view(np.int32)).to(cuda)
    rs, th, tiles = bitmul.sweep_mxu(t, torch.from_numpy(cls).to(cuda), 1500,
                                     35, strip=512, schedule="scan")
    want = pairwise.extract_pairs(t, cls, th, tiles, 1500, 35)
    assert len(want) > 100
    base = dict(n=1500, threshold=35, device=cuda)
    before = stats.stats_from_counts_traced_into.launches
    if mode in ("host", "csr", "packed-multigroup"):
        source = (stream.CSRBlockSource(inc_p, inc_r, 1536, 64)
                  if mode == "csr" else None)
        extra = (dict(pair_format="packed", max_group=1)
                 if mode == "packed-multigroup" else {})
        out = stream.sweep_extract_stream(
            None if source else words, cls, bs=512, block_source=source,
            **base, **extra)
        assert stream.last_onepass_trace["overflow"] is False
        assert stats.stats_from_counts_traced_into.launches - before == 6
        assert np.array_equal(out[0], rs) and np.array_equal(out[1], th)
        got = pairlist.pairs_as_array(out[3])
        assert out[3].ndim == (1 if extra else 2)
    elif mode == "fused":
        k = 1 << 15  # holds the diagonal tiles, truncates the others
        *_, cands = stream.sweep_mxu_stream(words, cls, bs=512, fused_k=k,
                                            **base)
        assert (th[:, 0] > k).any() and (th[:, 0] <= k).any()
        got = stream.extract_pairs_stream_fused(words, cls, th, tiles, cands,
                                                **base)
    elif mode == "grouped":
        got = stream.extract_pairs_stream_grouped(words, cls, th, tiles,
                                                  bs=512, max_group=2, **base)
    else:
        got = stream.extract_pairs_stream(words, cls, th, tiles, **base)
    assert got.dtype == np.int32 and np.array_equal(got, want)


def test_stream_capacity_miss_and_resume_on_gpu(cuda, tmp_path):
    """On the card: a capacity miss is redone exactly, and a run killed
    after one stationary group resumes to the uninterrupted pair list."""
    from uniprot_kmer_based_clustering_tpu_torch.ops import stream
    from uniprot_kmer_based_clustering_tpu_torch.utils.checkpoint import (
        CheckpointStore,
    )

    words, cls, _, _, _ = _stream_problem()
    kw = dict(n=1500, threshold=35, bs=512, max_group=1, device=cuda)
    want = stream.sweep_extract_stream(words, cls, **kw)
    over = stream.sweep_extract_stream(words, cls, cap=128, **kw)
    assert stream.last_onepass_trace["overflow"] is True
    assert np.array_equal(over[3], want[3])
    store = CheckpointStore(str(tmp_path))
    with pytest.raises(RuntimeError, match="fault injection"):
        stream.sweep_extract_stream(words, cls, checkpoint_store=store,
                                    checkpoint_key="k", fail_after_groups=1,
                                    **kw)
    got = stream.sweep_extract_stream(words, cls, checkpoint_store=store,
                                      checkpoint_key="k", **kw)
    assert stream.last_onepass_trace["groups_skipped"] == 1
    for a, b in zip(got[:2], want[:2]):
        assert np.array_equal(a, b)
    assert np.array_equal(got[3], want[3]) and store.load("k") is None


@pytest.mark.parametrize("loop", ["sweep", "fused", "onepass", "onepass-csr"])
def test_stream_loops_do_not_synchronise(cuda, loop):
    """The stream step loops (K2 once a step; the fused candidate drain;
    the one-pass append behind its device cursor), three groups of one
    block with more steps than the in-flight window holds, run under
    torch.cuda.set_sync_debug_mode("error"): uploads go through the pinned
    ring, the window waits on events, and nothing else synchronises up to
    the copies of the results to the host."""
    from uniprot_kmer_based_clustering_tpu_torch.ops import stream

    words, cls, inc_p, inc_r, _ = _stream_problem()
    bs, nbk, inflight = 512, 3, 1
    step_kw = dict(n=1500, threshold=35, block=512, w_thresh=1, word_chunk=0)

    def run(device, checked):
        trace = dict(dispatch_s=0.0, steps=0, launches=0)
        source = None
        if loop == "onepass-csr":
            source = stream.CSRBlockSource(inc_p, inc_r, 1536, 64)
            source.prepare(bs, 1536, device)
        feed = stream._BlockFeed(words, source, bs, device, inflight + 1,
                                 trace)
        window = stream._Window(device, trace)
        cls_dev, _ = stream._device_operands(cls, None, 64, bs, device)
        row_stats = torch.zeros((1536, 8), dtype=torch.int32, device=device)
        block_hits = torch.zeros((3, 3, 2), dtype=torch.int32, device=device)
        # room for every survivor (~221k) and one 512² window of slack
        buffers = pairlist.new_pair_buffers(1 << 19, device)
        cands = []
        if checked:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            if loop in ("sweep", "fused"):
                stream._sweep_loop(
                    feed, window, cls_dev, None, row_stats, block_hits,
                    nbk=nbk, g=1, bs=bs, inflight=inflight,
                    fused_k=4096 if loop == "fused" else 0, trace=trace,
                    on_candidates=lambda a: cands.append(a.copy()),
                    fused_same=False, **step_kw)
            else:
                state = stream._onepass_loop(
                    feed, window, cls_dev, None,
                    (row_stats, block_hits) + buffers, nbk=nbk, g=1, bs=bs,
                    inflight=inflight,
                    dispatch="scan" if source else "steps", scan_chunk=2,
                    done_groups=(), trace=trace,
                    on_group_end=lambda state, s0: None,
                    cross_amr_only=True, **step_kw)
                window.drain(0)
                buffers = state[2:]
        finally:
            if checked:
                torch.cuda.set_sync_debug_mode(0)
        out = [row_stats.cpu(), block_hits.cpu()]
        if loop == "fused":
            got = np.concatenate([c.reshape(3, -1) for c in cands], axis=1)
            got = got[:, got[2] >= 0]
            out.append(torch.from_numpy(
                got[:, np.lexsort((got[1], got[0]))].copy()))
        elif loop.startswith("onepass"):
            count = int(buffers[3])
            out.append(torch.from_numpy(pairlist.fetch_sorted_pairs(
                *buffers[:3], count, "arr3", 1536)))
        assert trace["steps"] == 6
        return out

    want = run(torch.device("cpu"), False)
    run(cuda, False)
    before = stats.stats_from_counts_traced_into.launches
    got = run(cuda, True)
    assert stats.stats_from_counts_traced_into.launches - before == 6
    assert len(got) == len(want) and int(want[1].sum()) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_stream_pipeline_gpu_matches_cpu(cuda, synth_fasta):
    """run_pipeline on the stream engine, host-words two-pass and packless
    csr one-pass, on the card and on the CPU."""
    for extra in (dict(), dict(stream_source="csr"),
                  dict(extract="fused", weighting="blosum62")):
        cfg = PipelineConfig(engine="stream", tile=128, strip=256, **extra)
        before = stats.stats_from_counts_traced_into.launches
        gpu = run_pipeline(synth_fasta, cfg, device=cuda)
        assert stats.stats_from_counts_traced_into.launches - before == 15
        cpu = run_pipeline(synth_fasta, cfg, device="cpu")
        assert gpu.parity_report() == cpu.parity_report()
        assert gpu.parity_report()["pairs_over_threshold"] > 0
        assert np.array_equal(gpu.pairwise.pairs, cpu.pairwise.pairs)
        assert np.array_equal(gpu.cluster_labels, cpu.cluster_labels)


# ---- query serving and the device index build -------------------------

@pytest.fixture(scope="module")
def served(synth_fasta):
    """The 1200-protein corpus up to its bitset (N_pad 1536), its BLOSUM
    weights and a query batch of corpus sequences plus two strangers."""
    from uniprot_kmer_based_clustering_tpu_torch.pipeline import (
        blosum_weights,
    )

    res = run_pipeline(synth_fasta, PipelineConfig(), device="cpu",
                       stop_after="pack")
    weights = blosum_weights(res.index, PipelineConfig(weighting="blosum62"),
                             res.bitset)
    seqs = [res.table.seq(i) for i in range(0, 1200, 7)] + ["MKT", "W" * 40]
    return res, weights, seqs


def _host_answers(res, seqs, weights=None, threshold=10, corpus=None):
    """The CPU rank-CSR walk's answers over res's corpus, or over
    ``corpus`` = (index, bitset)."""
    from uniprot_kmer_based_clustering_tpu_torch.similarity import (
        QueryServer,
    )

    index, bitset = corpus or (res.index, res.bitset)
    return QueryServer(index, bitset, weights=weights, mode="host",
                       device="cpu").query(seqs, threshold=threshold)


def _same_matches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("cap", [512, 1, 0])
@pytest.mark.parametrize("nq", [1, 9, 16, 64, 173])
def test_query_device_matches_host(cuda, served, nq, cap, weighted):
    """The _int_mm shape edges: one query (bucket 8, the query operand's
    8 rows), 9 (bucket 16), 173 (bucket 256); cap 1 redoes every
    multi-hit query through its own bucket, cap 0 fetches full counts."""
    from uniprot_kmer_based_clustering_tpu_torch.similarity import (
        QueryServer,
    )

    res, weights, seqs = served
    w = weights if weighted else None
    batch = seqs[:nq]
    srv = QueryServer(res.index, res.bitset, weights=w, mode="device",
                      topk_cap=cap, device=cuda)
    got = srv.query(batch, threshold=10)
    _same_matches(got, _host_answers(res, batch, w))
    assert sum(m.shape[0] for m in got) >= nq - 2


@pytest.mark.parametrize("source", ["host", "csr"])
@pytest.mark.parametrize("sbs,cap", [(16, 512), (16, 1), (100, 2),
                                     (None, 512)])
def test_query_stream_matches_resident(cuda, served, source, sbs, cap):
    """Stream mode from both block sources: 16-row blocks (the corpus
    operand padded to 24 rows for _int_mm), ragged 100-row blocks, the
    default block, and the per-block redo at caps 1–2, against the
    resident server on the card."""
    from uniprot_kmer_based_clustering_tpu_torch.similarity import (
        QueryServer,
    )

    res, weights, seqs = served
    batch = seqs[:40]
    resident = QueryServer(res.index, res.bitset, mode="device",
                           device=cuda).query(batch, threshold=10)
    srv = QueryServer(res.index, res.bitset, mode="stream", stream_bs=sbs,
                      stream_source=source, topk_cap=cap, device=cuda)
    _same_matches(srv.query(batch, threshold=10), resident)
    nbk = -(-res.bitset.n_pad // srv._stream_bs)
    assert srv.stream_trace["uploads"] >= nbk
    ws = QueryServer(res.index, res.bitset, weights=weights, mode="stream",
                     stream_bs=sbs, stream_source=source, topk_cap=cap,
                     device=cuda)
    _same_matches(ws.query(batch, threshold=10),
                  _host_answers(res, batch, weights))


@pytest.mark.parametrize("mode", ["device", "stream-host", "stream-csr"])
def test_query_async_does_not_synchronise(cuda, served, mode):
    """query_async makes no host synchronisation: two batches dispatched
    under torch.cuda.set_sync_debug_mode("error"), then answered exactly
    by query_wait."""
    from uniprot_kmer_based_clustering_tpu_torch.similarity import (
        QueryServer,
    )

    res, _, seqs = served
    kw = dict(mode="device")
    if mode != "device":
        kw = dict(mode="stream", stream_bs=512,
                  stream_source=mode.split("-")[1])
    srv = QueryServer(res.index, res.bitset, device=cuda, **kw)
    srv.query(seqs[:3], threshold=10)
    torch.cuda.synchronize()
    batches = [seqs[:8], seqs[8:40]]
    torch.cuda.set_sync_debug_mode("error")
    try:
        handles = [srv.query_async(b, threshold=10) for b in batches]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for h, b in zip(handles, batches):
        _same_matches(srv.query_wait(h), _host_answers(res, b))


def test_query_add_proteins_on_card(cuda, served):
    from uniprot_kmer_based_clustering_tpu_torch.kmers.append import (
        append_to_index,
    )
    from uniprot_kmer_based_clustering_tpu_torch.similarity import (
        QueryServer,
    )

    res, _, seqs = served
    new = [res.table.seq(i) + "MKTAYIAKQR" for i in (3, 500)]
    srv = QueryServer(res.index, res.bitset, mode="device", device=cuda)
    report = srv.add_proteins(new, threshold=10)
    host = QueryServer(res.index, res.bitset, mode="host", device="cpu")
    assert np.array_equal(report, host.add_proteins(new, threshold=10))
    _same_matches(srv.query(seqs[:20], threshold=10),
                  _host_answers(res, seqs[:20], corpus=append_to_index(
                      res.index, res.bitset, new)))


@pytest.mark.parametrize("k", [5, 7])
def test_device_index_on_card_matches_host(cuda, synth_fasta, k,
                                           monkeypatch):
    """index_engine="device" on the card: the bitset and doc-freqs equal
    the host build's, and so do the pairs; pack_bitsets_device too."""
    from uniprot_kmer_based_clustering_tpu_torch.kmers import bitset

    monkeypatch.setattr(bitset, "_PACK_CHUNK", 1 << 16)
    cfg = dict(k=k, tile=128, strip=256)
    host = run_pipeline(synth_fasta, PipelineConfig(**cfg), device="cpu")
    dev = run_pipeline(synth_fasta, PipelineConfig(index_engine="device",
                                                   **cfg), device=cuda)
    assert np.array_equal(dev.bitset.words, host.bitset.words)
    assert np.array_equal(dev.index.codes, host.index.codes)
    assert np.array_equal(dev.index.doc_freq, host.index.doc_freq)
    assert np.array_equal(dev.pairwise.pairs, host.pairwise.pairs)
    packed = bitset.pack_bitsets_device(
        host.index.incidence_protein, host.index.incidence_rank,
        host.table.n, host.index.n_repeated, row_multiple=128,
        device=cuda)
    assert np.array_equal(packed.words.cpu().numpy().view(np.uint32),
                          host.bitset.words)


def _bench_modules():
    """The benchmark's corpus generator and plain reference."""
    import os
    import sys

    bench = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmark")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    import corpus
    from reference import kmer_pairs

    return bench, corpus, kmer_pairs


def test_device_index_k7_at_10619_keeps_the_words_on_the_card(cuda,
                                                             tmp_path):
    """The ``arg10k.k7dev`` deployment on the card: ``run_pipeline(k=7,
    index_engine="device")`` on the benchmark's 10,619-protein corpus
    gives the plain reference's pairs, counters and components, and the
    job copies the packed words to the host at no point: no
    device-to-host copy in its trace is as large as the words, and the
    bitset's host copy is never made."""
    import json
    import os

    from uniprot_kmer_based_clustering_tpu_torch.kmers import index_device

    bench, corpus, kmer_pairs = _bench_modules()
    with open(os.path.join(bench, "configs",
                           "arg_k7_n10619_devindex.json")) as f:
        config = json.load(f)
    seq_buf, offsets, classes = corpus.synth_proteins(config["corpus"],
                                                      2**31 + 24)
    fasta = str(tmp_path / "corpus.fasta")
    corpus.write_fasta(fasta, seq_buf, offsets, classes)
    cfg = PipelineConfig(**config["pipeline"])
    assert cfg.k == 7 and cfg.index_engine == "device"
    run_pipeline(fasta, cfg, device=cuda)  # builds the kernels
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        res = run_pipeline(fasta, cfg, device=cuda)
        torch.cuda.synchronize()
    trace_path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dtoh = [e["args"]["bytes"] for e in events
            if e.get("name", "").startswith("Memcpy DtoH")]
    words_bytes = res.bitset.device_words.nbytes
    assert words_bytes == index_device.last_trace["words_bytes"] > 0
    assert dtoh and max(dtoh) < words_bytes // 10
    assert res.bitset._host_words is None
    assert tpw.last_trace["upload_bytes"] == res.bitset.n_pad * 4
    assert index_device.last_trace["host_bytes"] < 60e6

    ref = kmer_pairs.answer(seq_buf, offsets, classes, k=7,
                            threshold=cfg.threshold,
                            cross_amr_only=cfg.cross_amr_only,
                            with_components=True)
    assert np.array_equal(np.asarray(res.pairwise.pairs, np.int64),
                          ref["pairs"])
    got = np.array([getattr(res.pairwise, f)
                    for f in kmer_pairs.COUNTER_NAMES], np.int64)
    assert np.array_equal(got, ref["counters"])
    smallest = np.full(res.table.n, res.table.n, np.int64)
    np.minimum.at(smallest, res.cluster_labels,
                  np.arange(res.table.n))
    assert np.array_equal(smallest[res.cluster_labels], ref["labels"])
    assert index_device.last_trace["repeated"] == res.bitset.n_bits
    assert len(ref["pairs"]) > 0


def _sw_batch(seed, b=96, lo=20, hi=300, alphabet=21):
    rng = np.random.default_rng(seed)
    lq = rng.integers(lo, hi, b)
    ls = rng.integers(lo, hi, b)
    q_idx = rng.integers(0, alphabet, (b, int(lq.max()))).astype(np.int32)
    s_idx = rng.integers(0, alphabet, (b, int(ls.max()))).astype(np.int32)
    # every third subject carries a stretch of its query: long alignments
    for r in range(0, b, 3):
        n = min(int(lq[r]), int(ls[r])) - 4
        s_idx[r, 2 : 2 + n] = q_idx[r, :n]
    return q_idx, lq, s_idx, ls


@pytest.mark.parametrize("seed,alphabet", [(0, 21), (1, 3)])
def test_sw_on_card_matches_cpu(cuda, seed, alphabet):
    """Both Smith-Waterman entries on the card equal their CPU run (ties
    are common with 3 letters), and the scores equal the host DP's."""
    from uniprot_kmer_based_clustering_tpu_torch.align import (
        sw_align_host,
        sw_ends_and_starts_device,
        sw_scores_device,
    )

    args = _sw_batch(seed, alphabet=alphabet)
    got = sw_scores_device(*args, device=cuda)
    want = sw_scores_device(*args, device="cpu")
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    got = sw_ends_and_starts_device(*args, device=cuda)
    want = sw_ends_and_starts_device(*args, device="cpu")
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    q_idx, lq, s_idx, ls = args
    for r in range(0, len(lq), 7):
        host = sw_align_host(q_idx[r, : lq[r]], s_idx[r, : ls[r]])
        assert host.score == got[0][r]


@pytest.fixture(scope="module")
def small_fasta(tmp_path_factory):
    from bench_scale import synth_proteins

    seq_buf, offsets, classes = synth_proteins(300, seed=4)
    path = tmp_path_factory.mktemp("small") / "small.fasta"
    with open(path, "w") as f:
        for i in range(300):
            seq = seq_buf[offsets[i] : offsets[i + 1]].tobytes().decode()
            f.write(f">S{i:05d}|FEATURES|UNIPROT|c{classes[i]}|g{i}\n{seq}\n")
    return str(path)


def test_components_device_on_card(cuda, synth_fasta):
    from uniprot_kmer_based_clustering_tpu_torch.models import (
        connected_components,
        connected_components_device,
    )

    res = run_pipeline(synth_fasta, PipelineConfig(tile=128, strip=256,
                                                   cluster="none"),
                       device=cuda)
    pairs = res.pairwise.pairs
    for p in (pairs, pairs[:0], pairs[::5]):
        got = connected_components_device(p[:, 0], p[:, 1], n=1200,
                                          device=cuda)
        assert np.array_equal(got, connected_components_device(
            p[:, 0], p[:, 1], n=1200, device="cpu"))
        assert np.array_equal(got, connected_components(1200, p))


@pytest.mark.parametrize("budget", [13 << 30, 1 << 20],
                         ids=["one-shot", "strips"])
def test_agglomerative_loops_on_card_match_cpu(cuda, small_fasta, budget):
    """Both loops on the card (N_pad 384 and the words a multiple of 128,
    legal `_int_mm` shapes) equal the host loop on the CPU."""
    from uniprot_kmer_based_clustering_tpu_torch.models import (
        agglomerative_cluster,
        agglomerative_cluster_device,
    )

    res = run_pipeline(small_fasta, PipelineConfig(tile=128, cluster="none"),
                       device="cpu")
    bs, n = res.bitset, res.table.n
    assert bs.n_pad % 128 == 0 and bs.w_pad % 128 == 0
    want = agglomerative_cluster(bs, n, min_shared=2, device="cpu")
    assert len(want.merges) > 0
    for got in (
        agglomerative_cluster(bs, n, min_shared=2, hbm_budget_bytes=budget,
                              device=cuda),
        agglomerative_cluster_device(bs, n, min_shared=2, device=cuda),
    ):
        assert np.array_equal(got.labels, want.labels)
        assert np.array_equal(got.merges, want.merges)
        assert got.rounds == want.rounds


def test_cli_align_agglomerative_dump_on_card_matches_cpu(cuda, small_fasta,
                                                          tmp_path):
    """`cli run --align sw --cluster agglomerative --dump-debug` on the
    card writes the same files as on the CPU."""
    import os

    from uniprot_kmer_based_clustering_tpu_torch.cli import main

    flags = ["--align", "sw", "--cluster", "agglomerative", "--dump-debug",
             "--threshold", "150"]
    outs = {}
    for dev in ("cuda", "cpu"):
        outs[dev] = str(tmp_path / dev)
        assert main(["run", small_fasta, "--device", dev, "--out", outs[dev],
                     *flags]) == 0
    for name in ("pairs.tsv", "clusters.tsv", "dendrogram.tsv",
                 "blastp_output.tsv", "graph_debug.txt"):
        with open(os.path.join(outs["cuda"], name), "rb") as f:
            got = f.read()
        with open(os.path.join(outs["cpu"], name), "rb") as f:
            assert got == f.read(), name
    with open(os.path.join(outs["cuda"], "blastp_output.tsv")) as f:
        assert len(f.read().splitlines()) > 2


def _ring_problem(n_pad):
    """500 proteins over 1,500 k-mers, rows padded to ``n_pad``."""
    from uniprot_kmer_based_clustering_tpu_torch.kmers.bitset import (
        pack_bitsets,
    )

    rng = np.random.default_rng(5)
    rows, cols = np.nonzero(rng.random((500, 1500)) < 0.04)
    bs = pack_bitsets(rows.astype(np.int32), cols.astype(np.int32), 500,
                      1500, row_multiple=n_pad, word_multiple=128)
    classes = np.full(bs.n_pad, -1, np.int32)
    classes[:500] = rng.integers(0, 4, 500)
    return bs, classes, 500


@pytest.mark.parametrize("d", [2, 3])
def test_ring_on_a_shared_card_matches_cpu(cuda, d):
    """The flat ring on D shards of one card (sweep, extraction, fused)
    equals the same ring on D CPU shards; K1 launches once a sub-step of
    each pass and no other kernel runs."""
    from uniprot_kmer_based_clustering_tpu_torch.ops import popcount, tri_mxu
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        count_substeps,
        make_mesh,
        sharded_extract_pairs,
        sharded_pairwise_fused,
        sharded_pairwise_similarity,
    )

    bs, classes, n = _ring_problem(768 if d == 3 else 1024)
    card = make_mesh(devices=[cuda] * d)
    host = make_mesh(d, device="cpu")
    fns = (stats.stats_from_counts_into, stats.stats_from_counts_traced_into,
           tri_mxu.tri_mxu_sweep, popcount.popcount_sweep)
    for fn in fns:
        fn.launches = 0
    got = sharded_pairwise_similarity(card, bs.words, classes, n, 4)
    pairs = sharded_extract_pairs(card, bs.words, classes, n, 4)
    fused = sharded_pairwise_fused(card, bs.words, classes, n, 4)
    steps = count_substeps(d, bs.n_pad)
    assert [fn.launches for fn in fns] == [2 * steps, 0, 0, 0]
    want = sharded_pairwise_similarity(host, bs.words, classes, n, 4)
    want_pairs = sharded_extract_pairs(host, bs.words, classes, n, 4)
    for a, b in zip(got[:2] + fused[:2], want[:2] * 2):
        assert np.array_equal(a, b)
    assert np.array_equal(pairs, want_pairs)
    assert np.array_equal(fused[3], want_pairs)
    assert len(want_pairs) > 1000


def test_k1_on_a_wrapped_ring_block_matches_reference(cuda):
    """K1 at the ring's fake offsets on a block pair whose moving rows lie
    below the stationary ones (D = 4, step 1 on the last device; N_pad
    512, so its rows 384.. hold proteins)."""
    from uniprot_kmer_based_clustering_tpu_torch.parallel import sharded

    bs, classes, n = _ring_problem(512)
    sub = sharded.ring_substeps(1, 4, 3, 128, 128)[0]
    assert sub.gj0 < sub.gi0
    words = torch.from_numpy(bs.words.view(np.int32)).to(cuda)
    cls = torch.from_numpy(classes).to(cuda)
    counts = bitmul.counts_window_pair(
        words[sub.gi0 : sub.gi0 + sub.rows], words[sub.gj0 : sub.gj0 + sub.cols]
    )
    ca = cls[sub.gi0 : sub.gi0 + sub.rows]
    cb = cls[sub.gj0 : sub.gj0 + sub.cols]
    i_off, j_off = sharded.fake_offsets(sub)
    kw = dict(i_off=i_off, j_off=j_off, n=sharded.FAKE_N, threshold=4,
              tile=128)
    before = stats.stats_from_counts_into.launches
    rs, th, _ = stats.stats_from_counts(counts, ca, cb, **kw)
    rs_ref, th_ref, _ = stats.stats_from_counts_reference(counts, ca, cb, **kw)
    torch.cuda.synchronize()
    assert stats.stats_from_counts_into.launches == before + 1
    assert torch.equal(rs, rs_ref) and torch.equal(th, th_ref)
    assert int(rs[:, 0].sum()) > 0


def _ring_substep(shape):
    """A sub-step of a D = 4 ring over 512 rows (128-row blocks; rows
    384.. hold proteins): the diagonal strip of the last device, its
    wrapped block pair (step 1, moving rows 0..), or the first device's
    plain block pair (step 1)."""
    from uniprot_kmer_based_clustering_tpu_torch.parallel import sharded

    step, dev = {"diagonal": (0, 3), "wrapped": (1, 3),
                 "plain": (1, 0)}[shape]
    sub = sharded.ring_substeps(step, 4, dev, 128, 128)[0]
    assert sub.transposed == (shape == "wrapped")
    assert sub.triangle == (shape == "diagonal")
    return sub


@pytest.mark.parametrize("include_same", [False, True])
@pytest.mark.parametrize("shape", ["diagonal", "wrapped", "plain", "strip"])
def test_k1_appends_at_a_pair_origin(cuda, launched, shape, include_same):
    """K1's append at a pair origin, plain and transposed, stores what
    ``append_survivors_reference`` stores: on the ring's diagonal,
    wrapped and plain sub-steps (fake offsets, n = 2^30, the sub-step's
    global (gi0, gj0); every pair (min, max)), and on a strip, whose own
    offsets as the origin store what the launch without one stores."""
    from uniprot_kmer_based_clustering_tpu_torch.parallel import sharded

    if shape == "strip":
        counts, ca, cb, rs, bh, i_off, j_off, kw = _into_case(
            cuda, "strip6", signed=include_same)
        origins = [None, (i_off, j_off)]
        transposed = False
    else:
        bs, classes, n = _ring_problem(512)
        sub = _ring_substep(shape)
        words = torch.from_numpy(bs.words.view(np.int32)).to(cuda)
        cls = torch.from_numpy(classes).to(cuda)
        counts = bitmul.counts_window_pair(
            words[sub.gi0 : sub.gi0 + sub.rows],
            words[sub.gj0 : sub.gj0 + sub.cols])
        ca = cls[sub.gi0 : sub.gi0 + sub.rows]
        cb = cls[sub.gj0 : sub.gj0 + sub.cols]
        i_off, j_off = sharded.fake_offsets(sub)
        kw = dict(n=sharded.FAKE_N, threshold=3, w_thresh=1, tile=128)
        rs = torch.empty((sub.rows, 8), dtype=torch.int32, device=cuda)
        bh = torch.zeros((sub.rows // 128 + 1, sub.cols // 128 + 2, 2),
                         dtype=torch.int32, device=cuda)
        origins = [(sub.gi0, sub.gj0)]
        transposed = sub.transposed
    stored = []
    for origin in origins:
        want = pairlist.new_pair_buffers(counts.numel(), cuda)
        stats.append_survivors_reference(
            counts, ca, cb, want, i_off=i_off, j_off=j_off, n=kw["n"],
            threshold=kw["threshold"], include_same=include_same,
            pair_origin=origin, transposed=transposed)
        m = int(want[3])
        got = pairlist.new_pair_buffers(m + 7, cuda)
        stats.stats_from_counts_into(
            counts, ca, cb, rs, bh[1:, 2:], i_off=i_off, j_off=j_off,
            pairs=got, include_same=include_same, pair_origin=origin,
            transposed=transposed, **kw)
        torch.cuda.synchronize()
        assert m > 0 and int(got[3]) == m
        keys = _pair_keys(*(b[:m] for b in got[:3]))
        assert np.array_equal(keys, _pair_keys(*(b[:m] for b in want[:3])))
        assert bool((got[2][m:] == -1).all())
        if shape != "strip":
            assert (keys[:, 0] < keys[:, 1]).all()
        stored.append(keys)
    assert np.array_equal(stored[0], stored[-1])
    assert launched == ["ukc_stats_epilogue_append_into"] * len(origins)


@pytest.mark.parametrize("layout", ["flat", "2d", "kaxis"])
def test_appended_ring_on_a_shared_card_matches_one_card(cuda, synth_fasta,
                                                         launched, layout):
    """``extract="auto"`` on four shards of one card (flat, 2 × 2, k
    axis): K1 appends on every sub-step or strip of the one pass (the
    append entry and nothing else), no second pass runs, and the pair
    list, counters and clusters equal the one-card pipeline's."""
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        make_mesh,
        make_mesh_2d,
        sharded,
    )

    cfg = PipelineConfig(engine="mxu")
    one = run_pipeline(synth_fasta, cfg, device=cuda)
    mesh = (make_mesh_2d(2, 2, devices=[cuda] * 4) if layout == "2d"
            else make_mesh(devices=[cuda] * 4,
                           axis="k" if layout == "kaxis" else "p"))
    del launched[:]
    got = run_pipeline(synth_fasta, cfg, mesh=mesh)
    trace = dict(sharded.last_trace)
    assert launched == ["ukc_stats_epilogue_append_into"] * trace["substeps"]
    assert trace["second_passes"] == 0
    assert trace["epilogue_pairs"] == trace["pairs"] == len(
        one.pairwise.pairs) > 0
    assert got.parity_report() == one.parity_report()
    assert np.array_equal(got.pairwise.pairs, one.pairwise.pairs)
    assert np.array_equal(got.cluster_labels, one.cluster_labels)


def test_ring_on_the_card_refuses_tiles_k1_cannot_take(cuda):
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        make_mesh,
        sharded_extract_pairs,
    )

    bs, classes, n = _ring_problem(512)
    with pytest.raises(ValueError, match="multiples of 32"):
        sharded_extract_pairs(make_mesh(devices=[cuda] * 2), bs.words,
                              classes, n, 4, block_tile=16)


def test_make_mesh_refuses_more_cards_than_visible(cuda):
    from uniprot_kmer_based_clustering_tpu_torch.parallel import make_mesh

    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"requested {n + 1} devices, "
                                         f"only {n} available"):
        make_mesh(n + 1)
    assert make_mesh(n).size == n


def _layout_meshes(layout, shape, cuda):
    """(the layout on shards of the one card, the same layout on CPU
    shards)."""
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        make_mesh,
        make_mesh_2d,
    )

    if layout == "2d":
        d = shape[0] * shape[1]
        return (make_mesh_2d(*shape, devices=[cuda] * d),
                make_mesh_2d(*shape, device="cpu"))
    return (make_mesh(devices=[cuda] * shape, axis="k"),
            make_mesh(shape, axis="k", device="cpu"))


@pytest.mark.parametrize("layout,shape", [
    ("2d", (2, 2)), ("2d", (2, 3)), ("kaxis", 2), ("kaxis", 4),
], ids=str)
def test_layouts_on_a_shared_card_match_cpu(cuda, layout, shape):
    """The 2-D ring and the k-axis layout on shards of one card (sweep,
    extraction, fused) equal the same layout on CPU shards; K1 launches
    once a sub-step (2-D) or a strip (k axis) of each pass and no other
    kernel runs."""
    from uniprot_kmer_based_clustering_tpu_torch.ops import popcount, tri_mxu
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        count_kaxis_strips,
        count_substeps_2d,
        sharded_extract_pairs,
        sharded_pairwise_fused,
        sharded_pairwise_similarity_2d,
        sharded_pairwise_similarity_kaxis,
    )

    bs, classes, n = _ring_problem(768 if shape == (2, 3) else 1024)
    card, host = _layout_meshes(layout, shape, cuda)
    sweep = (sharded_pairwise_similarity_2d if layout == "2d"
             else sharded_pairwise_similarity_kaxis)
    fns = (stats.stats_from_counts_into, stats.stats_from_counts_traced_into,
           tri_mxu.tri_mxu_sweep, popcount.popcount_sweep)
    for fn in fns:
        fn.launches = 0
    got = sweep(card, bs.words, classes, n, 4)
    pairs = sharded_extract_pairs(card, bs.words, classes, n, 4)
    fused = sharded_pairwise_fused(card, bs.words, classes, n, 4)
    steps = (count_substeps_2d(*shape, bs.n_pad) if layout == "2d"
             else count_kaxis_strips(shape, bs.n_pad))
    assert [fn.launches for fn in fns] == [2 * steps, 0, 0, 0]
    want = sweep(host, bs.words, classes, n, 4)
    want_pairs = sharded_extract_pairs(host, bs.words, classes, n, 4)
    for a, b in zip(got[:2] + fused[:2], want[:2] * 2):
        assert np.array_equal(a, b)
    assert np.array_equal(pairs, want_pairs)
    assert np.array_equal(fused[3], want_pairs)
    assert len(want_pairs) > 1000


def test_k1_on_a_kaxis_strip_matches_reference(cuda):
    """K1 at a k-axis strip's real offsets (rows 256.. against columns
    256.., n = 500) on the card equals its plain version."""
    from uniprot_kmer_based_clustering_tpu_torch.parallel import sharded

    bs, classes, n = _ring_problem(1024)
    sub = sharded.kaxis_strips(4, 1024, 128, 5 * 1024 * 4 * 256)[1]
    assert (sub.r0, sub.rows, sub.cols) == (256, 256, 768)
    words = torch.from_numpy(bs.words.view(np.int32)).to(cuda)
    cls = torch.from_numpy(classes).to(cuda)
    counts = bitmul.counts_window_pair(words[sub.r0 : sub.r0 + sub.rows],
                                       words[sub.c0 :])
    kw = dict(i_off=sub.r0, j_off=sub.r0, n=n, threshold=4, tile=128)
    ca, cb = cls[sub.r0 : sub.r0 + sub.rows], cls[sub.c0 :]
    before = stats.stats_from_counts_into.launches
    rs, th, _ = stats.stats_from_counts(counts, ca, cb, **kw)
    rs_ref, th_ref, _ = stats.stats_from_counts_reference(counts, ca, cb, **kw)
    torch.cuda.synchronize()
    assert stats.stats_from_counts_into.launches == before + 1
    assert torch.equal(rs, rs_ref) and torch.equal(th, th_ref)
    assert int(rs[:, 0].sum()) > 0


def test_make_mesh_2d_refuses_more_cards_than_visible(cuda):
    from uniprot_kmer_based_clustering_tpu_torch.parallel import make_mesh_2d

    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"requested {2 * n + 2} devices, "
                                         f"only {n} available"):
        make_mesh_2d(2, n + 1)
    assert make_mesh_2d(1, n).size == n


@pytest.mark.parametrize("flags", [["--mesh-shape", "1x1"],
                                   ["--shard-axis", "kmers", "--devices",
                                    "1"]], ids=["1x1", "kmers"])
def test_cli_layouts_on_the_card_match_cpu(cuda, synth_fasta, tmp_path,
                                           flags):
    """`cli run --mesh-shape 1x1` and `--shard-axis kmers --devices 1` on
    the card write the CPU run's pairs and clusters."""
    import os

    from uniprot_kmer_based_clustering_tpu_torch.cli import main

    outs = {}
    for dev in ("cuda", "cpu"):
        outs[dev] = str(tmp_path / dev)
        assert main(["run", synth_fasta, "--device", dev, "--out",
                     outs[dev], *flags]) == 0
    for name in ("pairs.tsv", "clusters.tsv"):
        with open(os.path.join(outs["cuda"], name), "rb") as f:
            got = f.read()
        with open(os.path.join(outs["cpu"], name), "rb") as f:
            assert got == f.read(), name


def _kernel_counters():
    from uniprot_kmer_based_clustering_tpu_torch.ops import popcount, tri_mxu

    fns = (stats.stats_from_counts_into, stats.stats_from_counts_traced_into,
           tri_mxu.tri_mxu_sweep, popcount.popcount_sweep)
    for fn in fns:
        fn.launches = 0
    return fns


@pytest.mark.parametrize("d,kw", [(1, dict(bs=512)),
                                  (4, dict(bs=512)),
                                  (4, dict(bs=256, max_group=2, cap=64))])
def test_stream_mesh_on_a_shared_card_matches_single_device(
        cuda, synth_fasta, d, kw):
    """The out-of-core sweep on D shards of one card equals the
    single-device one-pass engine on the card at the same bs (and the
    same mesh on CPU shards); K2 launches once a step, summed over the
    shards, and no other kernel runs. The last case is multi-group with
    a per-shard capacity that overflows (the grouped redo)."""
    from uniprot_kmer_based_clustering_tpu_torch.ops.stream import (
        CSRBlockSource,
        sweep_extract_stream,
    )
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        make_mesh,
        stream_mesh,
        sweep_extract_stream_mesh,
    )

    res = run_pipeline(synth_fasta, PipelineConfig(), device="cpu",
                       stop_after="pack")
    idx, bitset, cls = res.index, res.bitset, res.table.amr_class_ids

    def src():
        return CSRBlockSource(idx.incidence_protein, idx.incidence_rank,
                              bitset.n_pad, bitset.w_pad)

    common = dict(block=128, **kw)
    fns = _kernel_counters()
    got = sweep_extract_stream_mesh(make_mesh(devices=[cuda] * d), cls,
                                    res.table.n, 10, block_source=src(),
                                    **common)
    trace = dict(stream_mesh.last_mesh_trace)
    assert [fn.launches for fn in fns] == [0, trace["steps"], 0, 0]
    assert trace["steps"] == trace["nbk"] * (trace["nbk"] + 1) // 2
    assert trace["overflow"] == ("cap" in kw)
    single = {k: v for k, v in common.items() if k != "cap"}
    one = sweep_extract_stream(None, cls, res.table.n, 10, device=cuda,
                               block_source=src(), **single)
    host = sweep_extract_stream_mesh(make_mesh(d, device="cpu"), cls,
                                     res.table.n, 10, block_source=src(),
                                     **common)
    for want in (one, host):
        for a, b in zip(got[:2] + got[3:], want[:2] + want[3:]):
            assert np.array_equal(a, b)
    assert len(got[3]) > 1000


@pytest.mark.parametrize("weighted", [False, True])
def test_query_mesh_on_a_shared_card_matches_single_device(cuda, served,
                                                           weighted):
    """QueryServer(mesh=...) on four shards of one card answers as the
    single-device server on the card (batches 1, 9 and the whole batch)
    and launches none of K1–K4."""
    from uniprot_kmer_based_clustering_tpu_torch.parallel import make_mesh
    from uniprot_kmer_based_clustering_tpu_torch.similarity import (
        QueryServer,
    )

    res, weights, seqs = served
    w = weights if weighted else None
    fns = _kernel_counters()
    mesh = QueryServer(res.index, res.bitset, weights=w,
                       mesh=make_mesh(devices=[cuda] * 4))
    one = QueryServer(res.index, res.bitset, weights=w, mode="device",
                      device=cuda)
    for batch in (seqs[:1], seqs[:9], seqs):
        _same_matches(mesh.query(batch, threshold=10),
                      one.query(batch, threshold=10))
    assert [fn.launches for fn in fns] == [0, 0, 0, 0]
    assert len(mesh._shard_blocks) == 4
    assert all(b.is_cuda for b in mesh._shard_blocks)


def test_stream_mesh_loop_does_not_synchronise(cuda, monkeypatch):
    """The out-of-core mesh loop on four shards of the card — three
    groups, one moving block a round, an in-flight window of one —
    runs under torch.cuda.set_sync_debug_mode("error") from the end of
    the staging to the first merge: the stacks, the steps and the window
    make no host synchronisation. The result then equals the CPU mesh's."""
    from uniprot_kmer_based_clustering_tpu_torch.ops.stream import (
        CSRBlockSource,
    )
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        make_mesh,
        stream_mesh,
    )

    _, cls, inc_p, inc_r, _ = _stream_problem()
    kw = dict(bs=512, block=512, max_group=1, scan_chunk=1, inflight=1)

    def run(mesh):
        return stream_mesh.sweep_extract_stream_mesh(
            mesh, cls, 1500, 35,
            block_source=CSRBlockSource(inc_p, inc_r, 1536, 64), **kw)

    want = run(make_mesh(4, device="cpu"))
    stage, merge = stream_mesh._stage, stream_mesh.lane_merge_to_first

    def checked_stage(*a):
        shards = stage(*a)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        return shards

    def unchecked_merge(*a):
        torch.cuda.set_sync_debug_mode(0)
        return merge(*a)

    monkeypatch.setattr(stream_mesh, "_stage", checked_stage)
    monkeypatch.setattr(stream_mesh, "lane_merge_to_first", unchecked_merge)
    fns = _kernel_counters()
    try:
        got = run(make_mesh(devices=[cuda] * 4))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    tr = stream_mesh.last_mesh_trace
    assert (tr["steps"], tr["g"], tr["launches"]) == (6, 1, 6)
    assert [fn.launches for fn in fns] == [0, 6, 0, 0]
    for a, b in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert np.array_equal(a, b)
    assert len(want[3]) > 1000


# -- the multi-process mesh over gloo on a shared card ------------------------

@functools.lru_cache(maxsize=None)
def _dist_tests():
    """tests/test_torch_distributed.py, loaded by its path: a ``tests``
    package installed elsewhere may shadow this directory's name."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "test_torch_distributed.py")
    spec = importlib.util.spec_from_file_location("_torch_dist_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _gloo_card_scenarios(rank, world, shards, out_dir, fasta):
    """The scenarios of a gloo world whose ranks share cuda:0, ``shards``
    of it a rank: the collectives on CUDA tensors (staged through the
    pinned host buffer), the flat ring and the out-of-core mesh, with the
    kernels' launch counters."""
    from uniprot_kmer_based_clustering_tpu_torch.ops.stream import (
        CSRBlockSource,
    )
    from uniprot_kmer_based_clustering_tpu_torch.parallel import mesh as tmesh
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        sharded_extract_pairs,
        sharded_pairwise_similarity,
        stream_mesh,
    )

    dt = _dist_tests()
    _collectives, _problem = dt._collectives, dt._problem
    _stream_problem = dt._stream_problem
    card = torch.device("cuda", 0)

    def mesh():
        return tmesh.make_mesh(devices=[card] * shards)

    def collectives():
        m = mesh()
        out = {}
        for name, v in _collectives(m, tmesh, card).items():
            for i in m.local if isinstance(v, list) else ():
                assert v[i].device == card
                out[f"{name}/{i}"] = v[i].cpu().numpy()
            if not isinstance(v, list):
                # the ring's fresh-buffer flags are host booleans
                assert v.device == card or name.endswith("_fresh")
                out[name] = v.cpu().numpy()
        out["pinned"] = bool(tmesh._staging["buf"].is_pinned())
        out["transport_bytes"] = tmesh.reset_transport_stats()["bytes"]
        return out

    def ring():
        bs, classes, n = _problem(1024)
        fns = _kernel_counters()
        for fn in fns:
            fn.launches = 0
        rs, th, _ = sharded_pairwise_similarity(mesh(), bs.words, classes,
                                                n, 4)
        pairs = sharded_extract_pairs(mesh(), bs.words, classes, n, 4)
        return dict(row_stats=rs, tile_hits=th, pairs=pairs,
                    launches=np.array([fn.launches for fn in fns]))

    def stream():
        rows, cols, n, n_pad, w_pad, classes = _stream_problem()
        fns = _kernel_counters()
        for fn in fns:
            fn.launches = 0
        rs, th, _, pairs = stream_mesh.sweep_extract_stream_mesh(
            mesh(), classes, n, 4, block=32, bs=64,
            block_source=CSRBlockSource(rows, cols, n_pad, w_pad))
        return dict(row_stats=rs, tile_hits=th, pairs=pairs,
                    steps=stream_mesh.last_mesh_trace["steps"],
                    launches=np.array([fn.launches for fn in fns]))

    return [("collectives", collectives), ("ring", ring),
            ("stream", stream)]


@pytest.fixture(scope="module")
def gloo_card_world(tmp_path_factory):
    """Two gloo ranks sharing cuda:0 with two shards each (D = 4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return _dist_tests()._launch(tmp_path_factory.mktemp("gloo_card"), 2, 2,
                                 "-", script=__file__)


def _rank_values(world, key):
    for r in world:
        scen = key.split("/")[0]
        assert f"{scen}/error" not in r, r[f"{scen}/error"]
    return [r[key] for r in world]


@pytest.mark.parametrize("name", ["ring_flat", "ring_h", "ring_c", "gather",
                                  "sum", "min", "lane", "all_gather",
                                  "broadcast"])
def test_gloo_transport_on_cuda_tensors(gloo_card_world, name):
    """Each collective on CUDA tensors of two gloo ranks sharing the card
    (staged through a pinned host buffer, results fresh tensors on the
    card) equals the one-process CPU mesh's."""
    from uniprot_kmer_based_clustering_tpu_torch.parallel import mesh as tmesh

    want = _dist_tests()._collectives(tmesh.make_mesh(4, device="cpu"), tmesh)[name]
    for r, ranks in enumerate(gloo_card_world):
        assert "collectives/error" not in ranks, ranks["collectives/error"]
        assert ranks["collectives/pinned"]
        assert ranks["collectives/transport_bytes"] > 0
        if isinstance(want, list):
            for i in (2 * r, 2 * r + 1):
                assert np.array_equal(ranks[f"collectives/{name}/{i}"],
                                      want[i].numpy())
        else:
            assert np.array_equal(ranks[f"collectives/{name}"],
                                  want.numpy())
        if name.startswith("ring"):
            assert ranks[f"collectives/{name}_fresh"]


@pytest.mark.parametrize("scenario", ["ring", "stream"])
def test_distributed_mesh_on_a_shared_card_matches_cpu(gloo_card_world,
                                                       scenario):
    """The flat ring (sweep, extraction) and the out-of-core one pass on
    two gloo ranks × two shards of the card equal the one-process CPU
    mesh on every rank; K1 (the ring's sub-steps) or K2 (the steps)
    launches summed over the ranks equal the one-process counts, and no
    other kernel runs."""
    from uniprot_kmer_based_clustering_tpu_torch.ops.stream import (
        CSRBlockSource,
    )
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        count_substeps,
        make_mesh,
        sharded_extract_pairs,
        sharded_pairwise_similarity,
        stream_mesh,
    )

    dt = _dist_tests()
    host = make_mesh(4, device="cpu")
    if scenario == "ring":
        bs, classes, n = dt._problem(1024)
        rs, th, _ = sharded_pairwise_similarity(host, bs.words, classes, n,
                                                4)
        want = dict(row_stats=rs, tile_hits=th, pairs=sharded_extract_pairs(
            host, bs.words, classes, n, 4))
        launches = [count_substeps(4, 1024), 0, 0, 0]
    else:
        rows, cols, n, n_pad, w_pad, classes = dt._stream_problem()
        rs, th, _, pairs = stream_mesh.sweep_extract_stream_mesh(
            host, classes, n, 4, block=32, bs=64,
            block_source=CSRBlockSource(rows, cols, n_pad, w_pad))
        want = dict(row_stats=rs, tile_hits=th, pairs=pairs)
        steps = stream_mesh.last_mesh_trace["steps"]
        assert sum(_rank_values(gloo_card_world, "stream/steps")) == steps
        launches = [0, steps, 0, 0]
    for key, value in want.items():
        for got in _rank_values(gloo_card_world, f"{scenario}/{key}"):
            assert np.array_equal(got, value), key
    assert len(want["pairs"]) > 100
    total = sum(_rank_values(gloo_card_world, f"{scenario}/launches"))
    assert total.tolist() == launches



# -- the dry run (dryrun.py) ---------------------------------------------------

# the root dry run's figures at four devices (its printed line on the
# JAX package's virtual CPU devices)
DRYRUN_FIGURES = {"stats_sum": 622733, "pairs": 36690,
                  "stream_mesh_pairs": 36690, "docfreq_nnz": 896,
                  "clusters": 496, "kaxis_pairs": 176}


def test_entry_kernel_matches_plain(cuda):
    """entry()'s step on the card: one K2 launch, equal to its plain
    version on the same inputs."""
    from uniprot_kmer_based_clustering_tpu_torch import dryrun

    fn, args = dryrun.entry(device=cuda)
    fns = _kernel_counters()
    rs, bh = fn(*args)
    assert [f.launches for f in fns] == [0, 1, 0, 0]
    plain_rs, plain_bh = fn(*[a.cpu() for a in args])
    assert rs.shape == (256, 8) and bh.shape == (2, 2, 2)
    assert torch.equal(rs.cpu(), plain_rs) and torch.equal(bh.cpu(), plain_bh)


def _dryrun_checked(devices):
    from uniprot_kmer_based_clustering_tpu_torch import dryrun

    fns = _kernel_counters()
    res = dryrun.dryrun_multichip(4, devices=devices)
    k1, k2, k3, k4 = (f.launches for f in fns)
    assert k1 > 0 and k2 > 0 and (k3, k4) == (0, 0)
    assert {k: res[k] for k in DRYRUN_FIGURES} == DRYRUN_FIGURES
    assert res["block_tile"] == 32
    return res


def test_dryrun_on_one_shared_card(cuda):
    """dryrun_multichip(4) with its four shards on one card gives the
    root dry run's figures, with K1 and K2 launched."""
    res = _dryrun_checked([torch.device("cuda", 0)] * 4)
    assert res["distinct_devices"] == 1
    assert "1 distinct card(s)" in res["line"]


def test_dryrun_on_four_distinct_cards(cuda):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    res = _dryrun_checked(None)
    assert res["distinct_devices"] == 4
    assert "4 distinct card(s)" in res["line"]


def test_stream_server_on_a_second_card(cuda, served, monkeypatch):
    """A stream server on cuda:1 while cuda:0 is current answers as the
    device server on cuda:0, and every stream it records on is cuda:1's
    (its in-flight window used to record on the current card's), from
    either block source."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from uniprot_kmer_based_clustering_tpu_torch.similarity import (
        QueryServer,
    )

    res, _, seqs = served
    torch.cuda.set_device(0)
    one = QueryServer(res.index, res.bitset, mode="device",
                      device="cuda:0")
    for source in ("host", "csr"):
        srv = QueryServer(res.index, res.bitset, mode="stream",
                          stream_bs=512, stream_source=source,
                          device="cuda:1")
        recorded = []
        real = torch.cuda.Event.record

        def spy(event, stream=None):
            on = torch.cuda.current_stream() if stream is None else stream
            recorded.append(on.device)
            return real(event, stream)

        monkeypatch.setattr(torch.cuda.Event, "record", spy)
        got = srv.query(seqs, threshold=10)
        monkeypatch.setattr(torch.cuda.Event, "record", real)
        _same_matches(got, one.query(seqs, threshold=10))
        assert recorded and set(recorded) == {torch.device("cuda", 1)}, (
            source, recorded)
        assert torch.cuda.current_device() == 0



def _htod(prof, tmp_path):
    """(name, bytes) of every host-to-device copy in a profile."""
    import json

    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["args"]["bytes"]) for e in events
            if e.get("name", "").startswith("Memcpy HtoD")]


def test_sweep_at_10619_uploads_the_words_from_pinned_memory(cuda,
                                                             tmp_path):
    """The ``arg10k.sweep`` job on the card: the pipeline packs the
    benchmark's 10,619-protein corpus into page-locked memory, and one
    profiled ``pairwise_similarity`` sends the words by a pinned DMA, with
    no pageable host-to-device copy a tenth of their size; every byte of
    the upload leaves page-locked memory, and the pairs and counters are
    the plain reference's."""
    import json
    import os

    bench, corpus, kmer_pairs = _bench_modules()
    with open(os.path.join(bench, "configs", "arg_k5_n10619.json")) as f:
        config = json.load(f)
    seq_buf, offsets, classes = corpus.synth_proteins(config["corpus"],
                                                      2**31 + 25)
    fasta = str(tmp_path / "corpus.fasta")
    corpus.write_fasta(fasta, seq_buf, offsets, classes)
    cfg = PipelineConfig(**config["pipeline"])
    pre = run_pipeline(fasta, cfg, stop_after="pack", device=cuda)
    bitset = pre.bitset
    assert bitset.pinned is not None and bitset.pinned.is_pinned()
    assert bitset.pinned.data_ptr() == bitset.words.ctypes.data
    tpw.pairwise_similarity(bitset, pre.table.amr_class_ids, cfg,
                            index=pre.index, device=cuda)  # warm
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        # a profile that follows another in one process may drop its
        # first device activity (seen after the k = 7 test's profile), so
        # a throwaway fill goes first and the job's copies come after it
        torch.ones(1, device=cuda).add_(1)
        torch.cuda.synchronize()
        r = tpw.pairwise_similarity(bitset, pre.table.amr_class_ids, cfg,
                                    index=pre.index, device=cuda)
        torch.cuda.synchronize()
    copies = _htod(prof, tmp_path)
    words_bytes = bitset.words.nbytes
    assert words_bytes == 313_786_368
    assert (("Memcpy HtoD (Pinned -> Device)", words_bytes) in copies), (
        copies)
    assert not [b for name, b in copies
                if "Pageable" in name and b >= words_bytes // 10], copies
    t = tpw.last_trace
    assert t["pinned_bytes"] == t["upload_bytes"] == 313_829_376

    ref = kmer_pairs.answer(seq_buf, offsets, classes, k=cfg.k,
                            threshold=cfg.threshold,
                            cross_amr_only=cfg.cross_amr_only,
                            with_components=False)
    assert np.array_equal(np.asarray(r.pairs, np.int64), ref["pairs"])
    got = np.array([getattr(r, f) for f in kmer_pairs.COUNTER_NAMES],
                   np.int64)
    assert np.array_equal(got, ref["counters"])
    assert len(ref["pairs"]) > 0


@pytest.mark.parametrize("weighting", ["none", "blosum62"])
def test_pinned_upload_does_not_synchronise(cuda, synth_fasta, weighting):
    """The sweep stage's upload of page-locked words, the classes and the
    weights queues its DMAs and never waits for the card."""
    from uniprot_kmer_based_clustering_tpu_torch.pipeline import (
        blosum_weights,
    )
    from uniprot_kmer_based_clustering_tpu_torch.state import (
        bitset_to_torch,
        classes_to_torch,
        weights_to_torch,
    )

    cfg = PipelineConfig(weighting=weighting)
    pre = run_pipeline(synth_fasta, cfg, stop_after="pack", device=cuda)
    bitset = pre.bitset
    assert bitset.pinned is not None
    weights = blosum_weights(pre.index, cfg, bitset)
    assert (weights is None) == (weighting == "none")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        words = bitset_to_torch(bitset, cuda)
        classes = classes_to_torch(pre.table.amr_class_ids, bitset.n_pad,
                                   cuda)
        wts = None if weights is None else weights_to_torch(weights, cuda)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(words.cpu(), bitset.pinned)
    assert np.array_equal(classes.cpu().numpy()[: bitset.n],
                          pre.table.amr_class_ids)
    assert (classes.cpu().numpy()[bitset.n:] == -1).all()
    if wts is not None:
        assert np.array_equal(wts.cpu().numpy(), weights)


def test_back_to_back_corpora_reuse_the_pinned_block(cuda, synth_fasta,
                                                     tmp_path):
    """Two corpora of one shape packed and swept one after the other: the
    second pack takes the first's freed page-locked block, left dirty on
    purpose, and each sweep gives the CPU run's pairs and counters."""
    import gc

    from bench_scale import synth_proteins

    seq_buf, offsets, classes = synth_proteins(1200, seed=4)
    other = str(tmp_path / "other.fasta")
    with open(other, "w") as f:
        for i in range(1200):
            seq = seq_buf[offsets[i] : offsets[i + 1]].tobytes().decode()
            f.write(f">S{i:05d}|FEATURES|UNIPROT|c{classes[i]}|g{i}\n"
                    f"{seq}\n")
    cfg = PipelineConfig()
    blocks = []
    for fasta in (synth_fasta, other):
        pre = run_pipeline(fasta, cfg, stop_after="pack", device=cuda)
        bitset = pre.bitset
        assert bitset.pinned is not None
        blocks.append(bitset.pinned.data_ptr())
        r = tpw.pairwise_similarity(bitset, pre.table.amr_class_ids, cfg,
                                    index=pre.index, device=cuda)
        assert tpw.last_trace["pinned_bytes"] == (
            tpw.last_trace["upload_bytes"])
        want = run_pipeline(fasta, cfg, device="cpu").pairwise
        assert np.array_equal(r.pairs, want.pairs) and len(r.pairs) > 0
        assert r.parity_counters() == want.parity_counters()
        torch.cuda.synchronize()
        bitset.pinned.fill_(-1)  # what the next pack must not keep
        del pre, bitset
        gc.collect()
    assert blocks[0] == blocks[1]


def test_four_card_ring_stages_from_pinned_memory(cuda, synth_fasta):
    """``cli run --devices 4``'s sweep stage on four distinct cards: every
    words shard is staged by DMA from the page-locked words, and the
    ring's pairs and counters are byte-equal to one card's."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    from uniprot_kmer_based_clustering_tpu_torch.parallel import make_mesh
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        sharded as tsh,
    )
    from uniprot_kmer_based_clustering_tpu_torch.pipeline import (
        _sharded_similarity,
    )

    cfg = PipelineConfig()
    mesh = make_mesh(4)
    pre = run_pipeline(synth_fasta, cfg, stop_after="pack", device=mesh.home)
    bitset = pre.bitset
    assert bitset.pinned is not None
    r = _sharded_similarity(bitset, pre.table, cfg, mesh, index=pre.index)
    t = tsh.last_trace
    assert t["stage_pinned_bytes"] == bitset.words.nbytes
    assert t["stage_bytes"] == bitset.words.nbytes + bitset.n_pad * 4
    one = tpw.pairwise_similarity(bitset, pre.table.amr_class_ids, cfg,
                                  index=pre.index, device=mesh.home)
    assert r.pairs.tobytes() == one.pairs.tobytes() and len(r.pairs) > 0
    assert r.parity_counters() == one.parity_counters()

if __name__ == "__main__":
    import sys

    r, w, p, s, out, fasta = sys.argv[1:7]
    _dist_tests()._worker(int(r), int(w), int(p), int(s), out, fasta,
                          scenarios=_gloo_card_scenarios)
