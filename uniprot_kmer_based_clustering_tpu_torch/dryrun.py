"""The flagship one-strip step and the multi-device dry run.

Counterpart of the repository root's ``__graft_entry__.py`` (its
``entry()`` and ``dryrun_multichip(n)``), for the PyTorch port:

- :func:`entry` returns ``(fn, example_args)``: one 256-row strip of the
  MXU sweep (unpack, int8 product, the masked pair statistics), with the
  root file's example arguments as tensors on ``device``;
- :func:`dryrun_multichip` runs every mesh composition of the port over
  one ``n_devices`` mesh on the root file's data, section by section in
  its order, and holds each against the flat ring or the single-device
  engine. Every check raises.

Run it on N cards::

    python -m uniprot_kmer_based_clustering_tpu_torch.dryrun N

With ``device="cuda"`` every mesh takes distinct cards and too few cards
raise ``make_mesh``'s ``ValueError``; nothing falls back to fewer cards,
to a shared card or to the CPU. A shared card is asked for explicitly
with ``devices=["cuda:0"] * N``; ``device="cpu"`` gives CPU shards.

On a CUDA mesh the ring tile (``block_tile``) is 32, the least tile the
CUDA epilogue takes, where the root file uses 16; on CPU shards it is 16.
The printed figures do not depend on it; the tile hits' grid does.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from uniprot_kmer_based_clustering_tpu_torch.device import resolve_device
from uniprot_kmer_based_clustering_tpu_torch.ops.bitmul import counts_window
from uniprot_kmer_based_clustering_tpu_torch.ops.stats import (
    stats_from_counts_traced,
)

# the root file's ring tile; CUDA meshes take the epilogue's least tile
CPU_BLOCK_TILE = 16
CUDA_BLOCK_TILE = 32


def strip_stats(words, classes_a, classes_b, weights, *, i0: int,
                strip: int, n: int, threshold: int, block: int,
                w_thresh: int):
    """One stationary strip against its column suffix (the JAX package's
    ``ops/bitmul._strip_stats``): the int32 counts of rows
    ``i0..i0+strip`` against rows ``i0..N_pad`` (``ops.bitmul.
    counts_window``: unpack and ``torch._int_mm``), then K2
    (``ops.stats.stats_from_counts_traced``: the CUDA kernel on a CUDA
    tensor, its plain version on a CPU one). Returns (row_stats int32
    [strip, 8], block_hits int32 [strip/block, (N_pad−i0)/block, 2])."""
    counts = counts_window(words, weights, i0, i0, s=strip,
                           jr=words.shape[0] - i0)
    return stats_from_counts_traced(
        counts, classes_a, classes_b, i0, i0, n=n, threshold=threshold,
        w_thresh=w_thresh, tile=block,
    )


def entry(device="cuda"):
    """(fn, example_args): the port's one-strip step with the root
    ``entry()``'s arguments, made from ``default_rng(0)`` as it makes
    them (words [256, 128] as int32 bit patterns, classes twice, all-ones
    int8 weights), on ``device``."""
    dev = resolve_device(device)
    s, w = 256, 128
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, (s, w), dtype=np.uint64).astype(np.uint32)
    classes = torch.from_numpy(rng.integers(0, 4, s).astype(np.int32)).to(dev)
    words = torch.from_numpy(words.view(np.int32)).to(dev)
    weights = torch.ones(w * 32, dtype=torch.int8, device=dev)
    fn = functools.partial(
        strip_stats, i0=0, strip=s, n=s, threshold=10, block=128,
        w_thresh=1,
    )
    return fn, (words, classes, classes, weights)


def _agg(rs):
    """The engine-independent aggregate of row statistics: the sum lanes
    summed, the max lanes maxed."""
    rs = np.asarray(rs)
    return np.concatenate(
        [rs[:, [0, 1, 2, 4, 5, 6]].sum(axis=0), rs[:, [3, 7]].max(axis=0)]
    )


def _check(ok, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def _words_host(shards, dim: int) -> np.ndarray:
    """Staged int32 word shards concatenated on the host, as uint32."""
    return torch.cat([s.cpu() for s in shards], dim=dim).numpy().view(
        np.uint32)


def _ring_balance(d: int):
    """(min, max) active work units a device of a D-ring does: step 0 is
    the diagonal strips (0.5 units), the even-D final step is split over
    the two devices that see each block pair (0.5 each), the middle steps
    one unit each (``parallel.sharded.ring_schedule``)."""
    work = []
    for _ in range(d):
        u = 0.5
        for s in range(1, d // 2 + 1):
            u += 0.5 if (d % 2 == 0 and 2 * s == d) else 1.0
        work.append(u)
    return min(work), max(work)


def _card_label(mesh) -> str:
    """The D-sweep's label: the CPU, or the card's name, power limit and
    the mesh's distinct cards."""
    from uniprot_kmer_based_clustering_tpu_torch.utils.artifact import (
        nvidia_smi,
    )

    if mesh.home.type == "cpu":
        return "CPU mesh"
    smi = nvidia_smi("name,power.limit") or torch.cuda.get_device_name(
        mesh.home)
    return f"{smi}, {len(set(mesh.devices))} distinct card(s)"


def dryrun_multichip(n_devices: int, *, device="cuda",
                     devices: Optional[Sequence] = None) -> dict:
    """Run every mesh composition over one ``n_devices`` mesh (the root
    ``dryrun_multichip(n)``, section by section, on its data) and print
    its line.

    ``devices`` lists the mesh's devices (it may repeat one card); every
    mesh, the D-sweep's too, takes its first entries, and a list shorter
    than ``n_devices`` raises. Otherwise the meshes take the first cards
    of ``device``'s type, and too few raise. Returns the line's figures
    (``stats_sum``, ``pairs``, ``stream_mesh_pairs``, ``docfreq_nnz``,
    ``clusters``, ``kaxis_pairs``, ``dsweep``, ``distinct_devices``,
    ``line``) and the arrays behind them (``row_stats``, ``tile_hits``,
    ``pr``, ``pr_m``, ``freq``, ``labels``, ``lab_tree``,
    ``agg_labels``, ``query``, ``pr_big``)."""
    from uniprot_kmer_based_clustering_tpu_torch.kmers.bitset import (
        pack_bitsets,
    )
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        doc_freq_psum,
        make_mesh,
        make_mesh_2d,
        sharded_extract_pairs,
        sharded_pairwise_fused,
        sharded_pairwise_similarity,
        sharded_pairwise_similarity_2d,
        sharded_pairwise_similarity_kaxis,
        stage_mesh_inputs_csr,
        sweep_extract_stream_mesh,
    )

    if devices is not None and len(devices) < n_devices:
        raise ValueError(
            f"requested {n_devices} devices, only {len(devices)} listed"
        )

    def mesh_kw(dd):
        return dict(device=device,
                    devices=None if devices is None else list(devices[:dd]))

    mesh = make_mesh(n_devices, **mesh_kw(n_devices))
    dev = mesh.home
    cuda = any(d.type == "cuda" for d in mesh.devices)
    block_tile = CUDA_BLOCK_TILE if cuda else CPU_BLOCK_TILE
    # n ≥ 512 (a real tile grid per device) and a threshold inside the
    # intersection distribution (density 0.08 on 512 bits → E[shared]
    # ≈ 3.3, so threshold 3 mixes hits and misses)
    n = max(512, n_devices * 64)
    k_bits = 512
    rng = np.random.default_rng(0)
    rows, cols = np.nonzero(rng.random((n, k_bits)) < 0.08)
    rows, cols = rows.astype(np.int32), cols.astype(np.int32)
    bitset = pack_bitsets(rows, cols, n, k_bits, row_multiple=n,
                          word_multiple=128)
    classes = rng.integers(0, 3, n).astype(np.int32)
    words_dev = torch.from_numpy(bitset.words.view(np.int32)).to(dev)

    threshold = 3
    row_stats, tile_hits, _ = sharded_pairwise_similarity(
        mesh, bitset.words, classes, n, threshold=threshold,
        block_tile=block_tile,
    )
    _check(row_stats.shape == (n, 8), f"row_stats shape {row_stats.shape}")
    _check((row_stats >= 0).all(), "negative row statistics")

    # CSR mesh staging: row shards built on each device from the sparse
    # incidences must equal the packed matrix and drive the same sweep
    words_csr, cls_csr = stage_mesh_inputs_csr(
        mesh, rows, cols, bitset.n_pad, bitset.w_pad, classes,
    )
    _check(np.array_equal(_words_host(words_csr, 0), bitset.words),
           "CSR row staging != the packed matrix")
    rs_c, th_c, _ = sharded_pairwise_similarity(
        mesh, words_csr, cls_csr, n, threshold=threshold,
        block_tile=block_tile,
    )
    _check(np.array_equal(th_c, tile_hits), "CSR-staged ring tile hits")
    _check(np.array_equal(_agg(rs_c), _agg(row_stats)),
           "CSR-staged ring aggregates")

    # hierarchical (hosts × chips) 2-D ring: parity with the flat ring
    two_d = n_devices % 2 == 0 and n_devices >= 4
    if two_d:
        mesh2 = make_mesh_2d(2, n_devices // 2, **mesh_kw(n_devices))
        rs2, th2, _ = sharded_pairwise_similarity_2d(
            mesh2, bitset.words, classes, n, threshold=threshold,
            block_tile=block_tile,
        )
        _check(np.array_equal(th2, tile_hits), "2-D ring tile hits")
        # per-row attribution is engine-specific (the ring credits the
        # stationary row): the cross-engine invariant is the aggregate
        _check(np.array_equal(_agg(rs2), _agg(row_stats)),
               "2-D ring aggregates")

    # contraction-axis (k-mer) sharded sweep: parity with the flat ring
    mesh_k = make_mesh(n_devices, axis="k", **mesh_kw(n_devices))
    rs_k, th_k, _ = sharded_pairwise_similarity_kaxis(
        mesh_k, bitset.words, classes, n, threshold=threshold,
        block_tile=block_tile,
    )
    _check(np.array_equal(th_k, tile_hits), "k-axis tile hits")
    _check(np.array_equal(_agg(rs_k), _agg(row_stats)), "k-axis aggregates")

    # mesh-parallel ring extraction against the plain sweep's extraction
    from uniprot_kmer_based_clustering_tpu_torch.ops.popcount import sweep_xla
    from uniprot_kmer_based_clustering_tpu_torch.ops.pairlist import (
        unpack_pairs,
    )
    from uniprot_kmer_based_clustering_tpu_torch.similarity.pairwise import (
        extract_pairs,
    )

    pr = sharded_extract_pairs(
        mesh, bitset.words, classes, n, threshold, block_tile=block_tile
    )
    _, thx, tx = sweep_xla(words_dev, classes, n, threshold, tile=block_tile)
    _check(np.array_equal(pr, extract_pairs(
        words_dev, classes, thx, tx, n=n, threshold=threshold,
    )), "ring extraction != the plain sweep's extraction")

    # fused ring: stats + compacted survivors in one pass over the block
    # pairs, equal to the two passes exactly, on all three layouts
    fused_k = block_tile * block_tile
    rs_f, th_f, _, pr_f = sharded_pairwise_fused(
        mesh, bitset.words, classes, n, threshold, block_tile=block_tile,
        k=fused_k,
    )
    _check(np.array_equal(th_f, tile_hits), "fused ring tile hits")
    _check(np.array_equal(_agg(rs_f), _agg(row_stats)),
           "fused ring aggregates")
    _check(np.array_equal(pr_f, pr), "fused ring pairs")
    _, th_fk, _, pr_fk = sharded_pairwise_fused(
        mesh_k, bitset.words, classes, n, threshold, block_tile=block_tile,
        k=fused_k,
    )
    _check(np.array_equal(th_fk, tile_hits), "fused k-axis tile hits")
    _check(np.array_equal(pr_fk, pr), "fused k-axis pairs")
    if two_d:
        _, th_f2, _, pr_f2 = sharded_pairwise_fused(
            mesh2, bitset.words, classes, n, threshold,
            block_tile=block_tile, k=fused_k,
        )
        _check(np.array_equal(th_f2, tile_hits), "fused 2-D tile hits")
        _check(np.array_equal(pr_f2, pr), "fused 2-D pairs")

    # the out-of-core stream engine on the first device: host-resident
    # matrix, the same pair list
    from uniprot_kmer_based_clustering_tpu_torch.ops.stream import (
        CSRBlockSource,
        extract_pairs_stream,
        extract_pairs_stream_grouped,
        sweep_extract_stream,
        sweep_mxu_stream,
    )

    rs_s, th_s, tl_s = sweep_mxu_stream(
        bitset.words, classes, n=n, threshold=threshold, bs=256, block=64,
        device=dev,
    )
    pr_s = extract_pairs_stream(
        bitset.words, classes, th_s, tl_s, n=n, threshold=threshold,
        device=dev,
    )
    _check(np.array_equal(_agg(rs_s), _agg(row_stats)), "stream aggregates")
    _check(np.array_equal(pr_s, pr), "stream two-pass pairs")
    # ... its grouped extractor and the one-pass engine at max_group=1 /
    # small bs, so the multi-group re-streaming schedule runs
    pr_g = extract_pairs_stream_grouped(
        bitset.words, classes, th_s, tl_s, n=n, threshold=threshold,
        bs=128, max_group=1, device=dev,
    )
    _check(np.array_equal(pr_g, pr), "stream grouped pairs")
    rs_o, th_o, _, pr_o = sweep_extract_stream(
        bitset.words, classes, n=n, threshold=threshold, bs=128, block=64,
        max_group=1, device=dev,
    )
    _check(np.array_equal(_agg(rs_o), _agg(row_stats)),
           "one-pass aggregates")
    _check(np.array_equal(th_o, th_s), "one-pass tile hits")
    _check(np.array_equal(pr_o, pr), "one-pass pairs")
    # ... the CSR block source (blocks built on the device from the
    # incidence lists; the dense matrix never uploaded)
    src = CSRBlockSource(rows, cols, bitset.n_pad, bitset.w_pad)
    rs_c2, th_c2, _, pr_c2 = sweep_extract_stream(
        None, classes, n=n, threshold=threshold, bs=128, block=64,
        block_source=src, device=dev,
    )
    _check(np.array_equal(_agg(rs_c2), _agg(row_stats)),
           "CSR-source aggregates")
    _check(np.array_equal(th_c2, th_s), "CSR-source tile hits")
    _check(np.array_equal(pr_c2, pr), "CSR-source pairs")
    # ... and the packed int64 pair format
    _, _, _, pr_p = sweep_extract_stream(
        bitset.words, classes, n=n, threshold=threshold, bs=128, block=64,
        pair_format="packed", device=dev,
    )
    _check(pr_p.ndim == 1 and np.array_equal(unpack_pairs(pr_p), pr),
           "packed pairs")

    # the out-of-core stream engine on the mesh: max_group=1 forces the
    # multi-group schedule, the tiny budget caps each shard's residency
    src_m = CSRBlockSource(rows, cols, bitset.n_pad, bitset.w_pad)
    rs_m, th_m, _, pr_m = sweep_extract_stream_mesh(
        mesh, classes, n, threshold, block_source=src_m, bs=128,
        block=64, max_group=1, scan_chunk=3, hbm_budget_bytes=1 << 24,
    )
    _check(np.array_equal(_agg(rs_m), _agg(row_stats)),
           "stream-mesh aggregates")
    _check(np.array_equal(pr_m, pr), "stream-mesh pairs")
    _, _, _, pr_mp = sweep_extract_stream_mesh(
        mesh, classes, n, threshold, block_source=src_m, bs=128,
        block=64, pair_format="packed",
    )
    _check(pr_mp.ndim == 1 and np.array_equal(unpack_pairs(pr_mp), pr),
           "stream-mesh packed pairs")

    # k-axis CSR staging: column-range shards built on each device
    words_kc, cls_kc = stage_mesh_inputs_csr(
        mesh_k, rows, cols, bitset.n_pad, bitset.w_pad, classes, axis="k",
    )
    _check(np.array_equal(_words_host(words_kc, 1), bitset.words),
           "CSR k-axis staging != the packed matrix")
    rs_kc, th_kc, _ = sharded_pairwise_similarity_kaxis(
        mesh_k, words_kc, cls_kc, n, threshold=threshold,
        block_tile=block_tile,
    )
    _check(np.array_equal(th_kc, tile_hits), "CSR k-axis tile hits")
    _check(np.array_equal(_agg(rs_kc), _agg(row_stats)),
           "CSR k-axis aggregates")

    # distributed doc-freq over the dense 5-mer universe
    from uniprot_kmer_based_clustering_tpu_torch.kmers.encode import (
        encode_kmers,
        encode_kmers_device,
        seqs_to_buffer,
    )

    lmax = 32
    n_prot = n_devices * 8
    seqs = rng.integers(0, 21, (n_prot, lmax)).astype(np.int32)
    lengths = np.full(n_prot, lmax, np.int32)
    codes, valid = encode_kmers_device(torch.from_numpy(seqs).to(dev),
                                       torch.from_numpy(lengths).to(dev), 5)
    freq = doc_freq_psum(mesh, codes, valid, 5).cpu().numpy()
    expect = sum(
        len(set(map(tuple, np.lib.stride_tricks.sliding_window_view(s, 5))))
        for s in seqs
    )
    _check(int(freq.sum()) == expect, f"doc-freq total {int(freq.sum())} "
                                      f"!= {expect}")

    # collective cluster merge (min-label propagation over sharded edges)
    from uniprot_kmer_based_clustering_tpu_torch.models.components import (
        connected_components,
        connected_components_sharded,
    )

    pairs = rng.integers(0, n, size=(4 * n_devices, 2)).astype(np.int64)
    labels = connected_components_sharded(mesh, pairs, n)
    _check(np.array_equal(labels, connected_components(n, pairs)),
           "sharded components != the union-find")

    # the clustering models on the first rows: valid, deterministic
    # labelings (their parity with the reference is pinned in the tests)
    from uniprot_kmer_based_clustering_tpu_torch.models.agglomerative import (
        agglomerative_cluster,
    )
    from uniprot_kmer_based_clustering_tpu_torch.models.tree import (
        cluster_tree_labels,
    )

    n_cl = 128
    bs_cl = dataclasses.replace(bitset, words=bitset.words[:n_cl], n=n_cl)
    lab_tree = cluster_tree_labels(bs_cl, n_cl)
    _check(lab_tree.shape == (n_cl,) and (lab_tree >= 0).all(),
           "tree labels")
    _check(np.array_equal(lab_tree, cluster_tree_labels(bs_cl, n_cl)),
           "tree labels are not deterministic")
    agg = agglomerative_cluster(bs_cl, n_cl, min_shared=threshold,
                                device=dev)
    _check(agg.labels.shape == (n_cl,) and (agg.labels >= 0).all(),
           "agglomerative labels")
    for lbl in np.unique(agg.labels):
        _check(np.nonzero(agg.labels == lbl)[0].min() == lbl,
               f"agglomerative label {lbl} is not its least member")

    # mesh-sharded query serving answers as the single-device server
    from uniprot_kmer_based_clustering_tpu_torch.kmers.index import (
        build_index,
    )
    from uniprot_kmer_based_clustering_tpu_torch.similarity import (
        QueryServer,
    )

    alpha = np.array(list("CSTAGPDEQNHRKMILVWYF"))
    prots = ["".join(rng.choice(alpha, 24)) for _ in range(n_prot)]
    buf, offs = seqs_to_buffer(prots)
    codes_h, koff_h = encode_kmers(buf, offs, 5)
    idx_q = build_index(codes_h, koff_h, 5)
    bs_q = pack_bitsets(
        idx_q.incidence_protein, idx_q.incidence_rank, len(prots),
        idx_q.n_repeated, row_multiple=8,
    )
    ans = QueryServer(idx_q, bs_q, mesh=mesh).query(
        [prots[0]], threshold=0)[0]
    ref = QueryServer(idx_q, bs_q, mode="device", device=dev).query(
        [prots[0]], threshold=0)[0]
    _check(np.array_equal(ans, ref), "mesh query != the single-device one")

    # k-axis sharding at the 7-mer design point: K = 2^20 rank columns,
    # each device holding K/D of them; parity with the plain sweep
    k_big = 1 << 20
    n_big = 64
    m_row = 60_000  # bits a row → E[shared] ≈ m²/K ≈ 3.3k
    rng_b = np.random.default_rng(7)
    rows_b = np.repeat(np.arange(n_big, dtype=np.int32), m_row)
    cols_b = rng_b.integers(0, k_big, n_big * m_row).astype(np.int32)
    bs_big = pack_bitsets(rows_b, cols_b, n_big, k_big, row_multiple=n_big,
                          word_multiple=128)
    cls_big = rng_b.integers(0, 3, n_big).astype(np.int32)
    thr_big = 3_300  # inside the intersection distribution
    rs_big, th_big, t_big = sharded_pairwise_similarity_kaxis(
        mesh_k, bs_big.words, cls_big, n_big, threshold=thr_big,
        block_tile=block_tile,
    )
    w_big = torch.from_numpy(bs_big.words.view(np.int32)).to(dev)
    rs_ref, th_ref, t_ref = sweep_xla(w_big, cls_big, n_big, thr_big,
                                      tile=block_tile)
    _check(np.array_equal(_agg(rs_big), _agg(rs_ref)),
           "7-mer k-axis aggregates")
    pr_big = extract_pairs(w_big, cls_big, th_big, t_big, n=n_big,
                           threshold=thr_big)
    pr_bref = extract_pairs(w_big, cls_big, th_ref, t_ref, n=n_big,
                            threshold=thr_big)
    _check(np.array_equal(pr_big, pr_bref), "7-mer k-axis pairs")
    _check(0 < pr_big.shape[0] < n_big * (n_big - 1) // 2,
           f"7-mer point has no mix of hits ({pr_big.shape[0]} pairs)")

    # the flat ring at every divisor device count, same data: a tiny-n
    # trend and balance check of the triangle schedule, not a scaling
    # figure
    dsweep = []
    for dd in (1, 2, 4, 8):
        if n_devices % dd or n % (dd * block_tile):
            continue
        m_d = make_mesh(dd, **mesh_kw(dd))

        def _run(m=m_d):
            return sharded_pairwise_similarity(
                m, bitset.words, classes, n, threshold=threshold,
                block_tile=block_tile,
            )

        rs_d, th_d, _ = _run()  # first execution
        _check(np.array_equal(th_d, tile_hits), f"D={dd} tile hits")
        _check(np.array_equal(_agg(rs_d), _agg(row_stats)),
               f"D={dd} aggregates")
        t0 = time.perf_counter()
        _run()  # returns host arrays: the devices have finished
        dt = time.perf_counter() - t0
        lo, hi = _ring_balance(dd)
        dsweep.append({"d": dd, "seconds": dt, "balance": (lo, hi)})

    nnz = int((freq > 0).sum())
    clusters = len(np.unique(labels))
    label = _card_label(mesh)
    line = (
        f"dryrun_multichip({n_devices}): ring + 2-D ring + k-axis sweeps "
        f"+ CSR mesh staging (row + k-axis column-range) + ring "
        f"extraction + fused ring (flat, "
        f"k-axis, 2-D) + stream engine (two-pass, grouped extract, "
        f"onepass sweep+extract, CSR block source, packed pair "
        f"format) + SHARDED out-of-core stream composition "
        f"(pairs={pr_m.shape[0]}, multi-group + packed) + "
        f"doc-freq psum + cluster merge + tree/agglomerative "
        f"labels + mesh query OK (n={n}, threshold={threshold}, "
        f"stats sum={int(row_stats.sum())}, pairs={pr.shape[0]}, "
        f"docfreq nnz={nnz}, "
        f"clusters={clusters}); "
        f"kaxis@K={k_big} cols OK (n={n_big}, pairs over {thr_big}: "
        f"{pr_big.shape[0]}); "
        f"ring D-sweep [{label}, balance=min/max active work units, "
        f"a tiny-n trend, not a scaling figure]: "
        + ", ".join(f"D={e['d']} {e['seconds']:.3f}s "
                    f"bal={e['balance'][0]:.1f}/{e['balance'][1]:.1f}"
                    for e in dsweep)
    )
    print(line, flush=True)
    return {
        "n": n, "threshold": threshold, "block_tile": block_tile,
        "stats_sum": int(row_stats.sum()), "pairs": int(pr.shape[0]),
        "stream_mesh_pairs": int(pr_m.shape[0]), "docfreq_nnz": nnz,
        "clusters": clusters, "kaxis_pairs": int(pr_big.shape[0]),
        "dsweep": dsweep, "distinct_devices": len(set(mesh.devices)),
        "line": line,
        "row_stats": row_stats, "tile_hits": tile_hits, "pr": pr,
        "pr_m": pr_m, "freq": freq, "labels": labels, "lab_tree": lab_tree,
        "agg_labels": agg.labels, "query": ans, "pr_big": pr_big,
    }


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
