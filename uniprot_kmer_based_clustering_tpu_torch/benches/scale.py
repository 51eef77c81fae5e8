"""Scale benchmark of the port: the UniProt-scale synthetic run.

    python -m uniprot_kmer_based_clustering_tpu_torch.benches.scale

The port's ``bench_scale.py``, all of it. It synthesizes N proteins
(``UKC_SCALE_N``, default 30,000) as point-mutated copies of shared
templates (:func:`common.synth_proteins`), builds the index on the host,
packs the bitset on the device, and times the sweep (``ops.bitmul.
sweep_mxu``: the block-pair scan with K2 at 30k; the line's ``kernels``
are the K1 and K2 launches of one warm sweep), two-pass extraction
and, unless ``UKC_SCALE_FUSED=0``, the fused sweep and its extraction,
which must equal two-pass. ``UKC_SCALE_STREAM=1`` adds the out-of-core
stream engine on the host-packed matrix (pair list equal to the in-core
one). ``UKC_SCALE_K=7`` takes the 7-mer universe; on a card it also
times the sorted device index build and gates it against the host
index. ``UKC_SCALE_STREAM_ONLY=1`` skips every in-core path and runs
the one-pass stream engine alone (:func:`_stream_only_run`, with its
budget, checkpoint and ``UKC_SCALE_STREAM_MESH`` knobs).

Every run is gated by :func:`oracle_gate`: sampled pairs re-counted
exactly from the host incidence lists, in both directions. The device
is ``UKC_BENCH_DEVICE`` (``cuda``); without a card the bench prints its
failure line and exits 1. Prints ONE JSON line (metric
``pairwise_similarity_scale``) and mirrors it to
``BENCH_torch_scale…_r<NN>.json`` when ``UKC_BENCH_ROUND`` is set.
"""

from __future__ import annotations

import gc
import os
import sys
import time

import numpy as np

from uniprot_kmer_based_clustering_tpu_torch.benches import common
from uniprot_kmer_based_clustering_tpu_torch.benches.common import (
    BenchFailure,
    synth_proteins,
)

METRIC = "pairwise_similarity_scale"
UNIT = "pairs/s/chip"


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise BenchFailure(msg)


def oracle_gate(
    idx, classes, pairs, n: int, threshold: int, samples: int = 512,
    seed: int = 7,
) -> int:
    """CPU-verifiable subset oracle for the extracted pair list.

    Re-counts sampled pairs exactly from the host incidence lists (an
    independent structure from the packed bitset the device swept) by
    per-protein sorted-rank intersection, in both directions:

      * ``samples`` uniform random pairs: membership in the extracted
        list must equal (count > threshold and cross-AMR), and the stored
        count must match exactly;
      * ``samples`` pairs drawn from the list: count, gate and class test
        re-verified.

    ``pairs`` is packed int64 [M] or int32 [M, 3]. Returns the number of
    pairs checked; raises :class:`BenchFailure` (an AssertionError) on any
    mismatch.
    """
    from uniprot_kmer_based_clustering_tpu_torch.ops.pairlist import (
        packed_key,
        packed_pair,
    )

    rng = np.random.default_rng(seed)
    off = np.zeros(n + 1, np.int64)
    np.cumsum(
        np.bincount(idx.incidence_protein, minlength=n), out=off[1:]
    )
    ir = idx.incidence_rank

    def count(i: int, j: int) -> int:
        # per-protein rank lists are sorted unique
        return int(
            np.intersect1d(
                ir[off[i]: off[i + 1]],
                ir[off[j]: off[j + 1]],
                assume_unique=True,
            ).shape[0]
        )

    is_packed = pairs.ndim == 1
    if not is_packed:
        keys = (
            pairs[:, 0].astype(np.int64) * n
            + pairs[:, 1].astype(np.int64)
        )

    def lookup(i: int, j: int):
        """(member, stored_count) for pair (i, j)."""
        if is_packed:
            p = int(np.searchsorted(pairs, packed_key(i, j)))
            if p < len(pairs):
                pi, pj, pc = packed_pair(pairs[p])
                if (pi, pj) == (i, j):
                    return True, pc
            return False, -1
        key = i * n + j
        p = int(np.searchsorted(keys, key))
        if p < len(keys) and keys[p] == key:
            return True, int(pairs[p, 2])
        return False, -1

    checked = 0
    for i, j in rng.integers(0, n, size=(samples, 2)):
        if i == j:
            continue
        i, j = (int(i), int(j)) if i < j else (int(j), int(i))
        c = count(i, j)
        expect = c > threshold and classes[i] != classes[j]
        member, stored = lookup(i, j)
        _check(member == expect, (
            f"oracle gate: pair ({i},{j}) count={c} "
            f"cross={classes[i] != classes[j]} expect_member={expect} "
            f"but list_member={member}"
        ))
        if member:
            _check(stored == c, (
                f"oracle gate: pair ({i},{j}) list count "
                f"{stored} != exact {c}"
            ))
        checked += 1
    if len(pairs):
        for s in np.unique(
            rng.integers(0, len(pairs), min(samples, len(pairs)))
        ):
            if is_packed:
                i, j, c = packed_pair(pairs[s])
            else:
                i, j, c = (int(v) for v in pairs[s])
            _check(count(i, j) == c and c > threshold, (
                f"oracle gate: listed pair ({i},{j},{c}) exact count "
                f"{count(i, j)}"
            ))
            _check(classes[i] != classes[j], (
                f"oracle gate: listed pair ({i},{j}) is same-class"
            ))
            checked += 1
    return checked


def _device_index_gate(idx, seq_buf, offsets, n: int, dev) -> dict:
    """Time the sorted device index build and gate it against the host.

    ``kmers.index_device.build_bitset_device_sorted`` (the any-k device
    path) must give the host index's distinct codes, doc-freqs and
    repeated count, per-row popcounts of its words equal to the host
    incidence counts, and a 64-row word sample equal to the bits rebuilt
    from the host incidence lists. Raises :class:`BenchFailure` on any
    mismatch. Runs before the sweep's bitset is packed, so the words can
    be dropped before the sweep claims the memory.
    """
    import torch

    from uniprot_kmer_based_clustering_tpu_torch.kmers.encode import (
        residues_to_indices,
    )
    from uniprot_kmer_based_clustering_tpu_torch.kmers.index_device import (
        build_bitset_device_sorted,
    )
    from uniprot_kmer_based_clustering_tpu_torch.ops.popcount import (
        popcount32_,
    )

    lengths = np.diff(offsets).astype(np.int32)
    # padded [N, Lmax] residue matrix via one offsets-based scatter
    res = residues_to_indices(seq_buf)
    lmax = int(lengths.max()) if n else 1
    res_idx = np.zeros((n, lmax), np.int32)
    rows = np.repeat(np.arange(n, dtype=np.int64), lengths)
    cols = np.arange(res.shape[0], dtype=np.int64) - np.repeat(
        np.asarray(offsets[:-1], np.int64), lengths
    )
    res_idx[rows, cols] = res

    def rowsum(words):
        out = [popcount32_(words[r0 : r0 + 4096].clone()).sum(
                   dim=1, dtype=torch.int32)
               for r0 in range(0, words.shape[0], 4096)]
        return torch.cat(out).cpu().numpy()

    def build(keep_words: bool):
        # at most one words matrix is alive at a time
        t0 = time.perf_counter()
        words, dc, df, nr = build_bitset_device_sorted(
            res_idx, lengths, n, idx.k, device=dev
        )
        pc = rowsum(words)  # sync + full-matrix parity vector
        if not keep_words:
            words = None
        return time.perf_counter() - t0, words, (dc, df, nr), pc

    t_cold, dwords, (dcodes, dfreq, dnrep), pc = build(keep_words=True)

    _check(dnrep == idx.n_repeated, f"device index repeated k-mers {dnrep} "
           f"!= host {idx.n_repeated}")
    _check(np.array_equal(dcodes, idx.codes), "device index codes != host")
    _check(np.array_equal(dfreq, idx.doc_freq),
           "device index doc-freqs != host")
    row_counts = np.bincount(idx.incidence_protein, minlength=n)
    _check(np.array_equal(pc[:n], row_counts.astype(np.int32))
           and not pc[n:].any(), "device words' row popcounts != host")

    # 64-row word-level sample, expected words rebuilt host-side
    off = np.zeros(n + 1, np.int64)
    np.cumsum(row_counts, out=off[1:])
    rng = np.random.default_rng(3)
    rows = np.sort(rng.choice(n, min(64, n), replace=False))
    w_pad = int(dwords.shape[1])
    exp = np.zeros((rows.shape[0], w_pad), np.uint32)
    for a, r in enumerate(rows):
        rk = idx.incidence_rank[off[r]: off[r + 1]].astype(np.int64)
        np.bitwise_or.at(
            exp[a], rk >> 5, np.uint32(1) << (rk & 31).astype(np.uint32)
        )
    got = dwords[torch.from_numpy(rows).to(dev)].cpu().numpy().view(
        np.uint32)
    _check(np.array_equal(got, exp), "device index words != host bits")
    del dwords  # release the words before the warm rebuilds

    t_warm = float("inf")
    for _ in range(2):
        dt, _, (dcodes2, dfreq2, dnrep2), pc2 = build(keep_words=False)
        t_warm = min(t_warm, dt)
        _check(dnrep2 == dnrep and np.array_equal(pc2, pc),
               "device index rebuild differs")

    return {
        "dev_index_cold_seconds": round(t_cold, 3),
        "dev_index_warm_seconds": round(t_warm, 3),
        "dev_index_parity": (
            "host-exact (codes+doc_freq+row-popcounts+64-row words)"
        ),
    }


def _trace(trace: dict, digits: int = 3) -> dict:
    return {k: (round(v, digits) if isinstance(v, float) else v)
            for k, v in dict(trace or {}).items()}


def _memory_note(matrix_gib: float, dev) -> str:
    import torch

    if dev.type != "cuda":
        return (f"stream-only mode at {matrix_gib:.2f} GiB on the CPU "
                "(smoke scale)")
    card_gib = torch.cuda.get_device_properties(dev).total_memory / 2**30
    if matrix_gib > card_gib:
        return (f"{matrix_gib:.1f} GiB packed matrix > the card's "
                f"{card_gib:.1f} GiB: the out-of-core stream engine is the "
                "only single-card path")
    return (f"stream-only mode at {matrix_gib:.2f} GiB (below the card's "
            f"{card_gib:.1f} GiB)")


def _stream_only_run(n: int, kk: int, blk: int, dev) -> dict:
    """Beyond-memory design point: only the out-of-core one-pass stream
    engine (``ops.stream.sweep_extract_stream``: stationary row-block
    groups resident under the budget, moving blocks streamed through),
    gated by :func:`oracle_gate` alone. ``UKC_SCALE_STREAM_SOURCE``
    ``csr`` (default) materializes every block on the device from the
    incidence lists, ``host`` packs on the host and streams dense blocks.
    ``UKC_SCALE_STREAM_MESH=D`` runs the same design point again through
    ``parallel.sweep_extract_stream_mesh`` on a D-device flat mesh and
    requires its pair list to equal the single-device one.
    """
    from uniprot_kmer_based_clustering_tpu_torch.kmers import (
        build_index,
        encode_kmers,
        pack_bitsets,
    )
    from uniprot_kmer_based_clustering_tpu_torch.ops import (
        stream as stream_mod,
    )
    from uniprot_kmer_based_clustering_tpu_torch.ops.stream import (
        CSRBlockSource,
        sweep_extract_stream,
    )

    t0 = time.perf_counter()
    seq_buf, offsets, classes = synth_proteins(n)
    t_synth = time.perf_counter() - t0

    t0 = time.perf_counter()
    codes, koff = encode_kmers(seq_buf, offsets, kk)
    idx = build_index(codes, koff, kk)
    t_index = time.perf_counter() - t0

    # UKC_SCALE_THRESHOLD: the alignment gate (default 10); a higher gate
    # keeps a large corpus's survivors inside the one-pass pair buffers
    thr = int(os.environ.get("UKC_SCALE_THRESHOLD", "10"))
    src_mode = os.environ.get("UKC_SCALE_STREAM_SOURCE", "csr")

    t0 = time.perf_counter()
    if src_mode == "csr":
        w_words = -(-idx.n_repeated // 32)
        w_pad = -(-w_words // 128) * 128
        source = CSRBlockSource(
            idx.incidence_protein, idx.incidence_rank, n, w_pad
        )
        words_arg = None
        n_pad0 = -(-n // (7 * blk)) * (7 * blk)
        matrix_gib = n_pad0 * w_pad * 4 / 2**30  # virtual: never built
        t_pack = time.perf_counter() - t0  # CSR prep only
    else:
        source = None
        bs_host = pack_bitsets(
            idx.incidence_protein, idx.incidence_rank, n,
            idx.n_repeated, row_multiple=7 * blk,
        )
        words_arg = bs_host.words
        t_pack = time.perf_counter() - t0
        matrix_gib = bs_host.words.nbytes / 2**30

    budget_gib = float(os.environ.get("UKC_SCALE_STREAM_BUDGET", "0"))
    # UKC_SCALE_STREAM_BS: stream row-block override
    sbs = int(os.environ.get("UKC_SCALE_STREAM_BS", "0")) or 7 * blk
    sweep_kw = dict(block=blk, bs=sbs)
    if budget_gib:
        sweep_kw["hbm_budget_bytes"] = int(budget_gib * (1 << 30))
    # UKC_SCALE_CAP: explicit pair-buffer rows
    cap_env = int(os.environ.get("UKC_SCALE_CAP", "0"))
    if cap_env:
        sweep_kw["cap"] = cap_env
    # UKC_SCALE_STREAM_CKPT=dir: group-boundary checkpoints on, so the
    # line records the snapshot overhead (stream_trace.ckpt_s)
    ckpt_dir = os.environ.get("UKC_SCALE_STREAM_CKPT")
    if ckpt_dir:
        from uniprot_kmer_based_clustering_tpu_torch.utils.checkpoint import (
            CheckpointStore,
        )

        sweep_kw["checkpoint_store"] = CheckpointStore(ckpt_dir)
        sweep_kw["checkpoint_key"] = "bench-stream-progress"

    if source is not None:
        sweep_kw["block_source"] = source
        cls_np = classes  # the engine pads rows itself
        w_report = source.w_words
    else:
        cls_np = np.full(bs_host.n_pad, -1, np.int32)
        cls_np[:n] = classes
        w_report = bs_host.words.shape[1]

    # one cold pass of the one-pass engine: statistics and survivor
    # compaction into device pair buffers, one sorted fetch at the end
    t0 = time.perf_counter()
    rs, th, tl, pairs = sweep_extract_stream(
        words_arg, cls_np, n, thr, pair_format="packed", device=dev,
        **sweep_kw
    )
    t_sweep = time.perf_counter() - t0  # sweep AND extraction: one pass
    trace = dict(stream_mod.last_onepass_trace or {})
    t_extract = float(trace.get("fetch_s", 0.0))

    tot = rs.sum(axis=0)
    _check(len(pairs) == int(tot[2]),
           f"pair list {len(pairs)} != the sweep's {int(tot[2])}")
    t0 = time.perf_counter()
    n_checked = oracle_gate(idx, classes, pairs, n, thr)
    t_oracle = time.perf_counter() - t0

    mesh_stats = {}
    mesh_d = int(os.environ.get("UKC_SCALE_STREAM_MESH", "0"))
    if mesh_d and src_mode == "csr":
        from uniprot_kmer_based_clustering_tpu_torch.parallel import (
            make_mesh,
            stream_mesh,
        )
        from uniprot_kmer_based_clustering_tpu_torch.parallel.stream_mesh import (
            sweep_extract_stream_mesh,
        )

        mesh = make_mesh(mesh_d, device=dev.type)
        t0 = time.perf_counter()
        rs_m, _, _, pairs_m = sweep_extract_stream_mesh(
            mesh, classes, n, thr,
            block_source=CSRBlockSource(
                idx.incidence_protein, idx.incidence_rank, n,
                source.w_words,
            ),
            pair_format="packed", **{
                k: v for k, v in sweep_kw.items()
                if k not in (
                    "block_source", "checkpoint_store", "checkpoint_key",
                )
            },
        )
        t_mesh = time.perf_counter() - t0
        _check(np.array_equal(pairs_m, pairs),
               "stream-mesh pair list != single-device one-pass")
        _check(np.array_equal(rs_m.sum(axis=0), tot),
               "stream-mesh totals != single-device one-pass")
        mesh_stats = {
            "stream_mesh_devices": mesh_d,
            "stream_mesh_seconds": round(t_mesh, 3),
            "stream_mesh_value": round(
                n * (n - 1) / 2.0 / t_mesh / mesh_d, 1
            ),
            "stream_mesh_trace": _trace(stream_mesh.last_mesh_trace),
            "stream_mesh_parity": (
                "pair-list identical to the single-device one-pass "
                "engine (exact np.array_equal on the packed lists)"
            ),
        }

    rec = {
        "metric": METRIC,
        "value": round(n * (n - 1) / 2.0 / t_sweep, 1),
        "unit": UNIT,
        "engine": "stream one-pass (out-of-core)",
        "n_proteins": n,
        "k": kk,
        "threshold": thr,
        "repeated_kmers": idx.n_repeated,
        "bitset_gb": round(matrix_gib, 2),
        "hbm_budget_gib": budget_gib or 13.0,
        "sweep_seconds": round(t_sweep, 3),
        "first_run_seconds": round(t_sweep, 3),
        "extract_seconds": round(t_extract, 3),
        "pack_host_seconds": round(t_pack, 3),
        "capacity_overflow_redone": bool(trace.get("overflow", False)),
        "pair_format": (
            "packed-int64" if pairs.ndim == 1 else "arr3-int32"
        ),
        "block_source": (
            "csr-device-materialized" if source is not None
            else "host-words"
        ),
        # with the CSR source the volume materialized on the device; with
        # host words the volume copied to it
        "streamed_gib": round(
            trace.get("uploads", 0) * sbs * w_report * 4 / 2**30, 3
        ),
        "stream_trace": _trace(trace),
        "timing_note": (
            "one-pass engine: sweep_seconds includes exact pair "
            "compaction (extract_seconds is the final device-sort fetch); "
            "one cold pass"
        ),
        "index_seconds": round(t_index, 3),
        "synth_seconds": round(t_synth, 3),
        "cross_amr_pairs": int(tot[1]),
        "pairs_over_threshold": int(tot[2]),
        "oracle_checked_pairs": n_checked,
        "oracle_seconds": round(t_oracle, 3),
        "oracle": (
            "sampled-pair exact counts from host incidence lists: "
            "membership+count gated both directions (the only gate)"
        ),
        "note": _memory_note(matrix_gib, dev),
        **common.device_fields(dev),
        **mesh_stats,
    }
    _write(f"torch_scale7mer{n // 1000}k" if kk == 7
           else f"torch_scale{n // 1000}k_stream", rec)
    return rec


def _write(name: str, rec: dict) -> None:
    from uniprot_kmer_based_clustering_tpu_torch.utils.artifact import (
        write_bench_artifact,
    )

    write_bench_artifact(name, rec)


def measure() -> dict:
    dev = common.bench_device()
    import torch

    from uniprot_kmer_based_clustering_tpu_torch.kmers import (
        build_index,
        encode_kmers,
        pack_bitsets_device,
    )
    from uniprot_kmer_based_clustering_tpu_torch.ops.bitmul import (
        resolve_schedule,
        sweep_mxu,
    )
    from uniprot_kmer_based_clustering_tpu_torch.similarity.pairwise import (
        extract_pairs,
        extract_pairs_fused,
    )
    from uniprot_kmer_based_clustering_tpu_torch.state import (
        classes_to_torch,
    )

    n = int(os.environ.get("UKC_SCALE_N", "30000"))
    kk = int(os.environ.get("UKC_SCALE_K", "5"))
    # UKC_SCALE_BLOCK: tile size (default 512); UKC_SCALE_STRIP: strip
    # (default from the budget). Small values engage the scan schedule,
    # and so the fused branch, at CPU smoke scale.
    blk = int(os.environ.get("UKC_SCALE_BLOCK", "512"))
    strip = int(os.environ.get("UKC_SCALE_STRIP", "0")) or None
    if os.environ.get("UKC_SCALE_STREAM_ONLY", "0") != "0":
        return _stream_only_run(n, kk, blk, dev)
    thr = common.THRESHOLD
    t0 = time.perf_counter()
    seq_buf, offsets, classes = synth_proteins(n)
    t_synth = time.perf_counter() - t0

    t0 = time.perf_counter()
    codes, koff = encode_kmers(seq_buf, offsets, kk)
    idx = build_index(codes, koff, kk)
    t_index_host = time.perf_counter() - t0

    # the sorted device index build (the k=7 path), timed and gated
    # against the host build; on a card only, UKC_SCALE_DEVIDX=0 skips
    dev_idx_stats = {}
    if (
        kk == 7
        and os.environ.get("UKC_SCALE_DEVIDX", "1") != "0"
        and dev.type == "cuda"
    ):
        dev_idx_stats = _device_index_gate(idx, seq_buf, offsets, n, dev)

    t0 = time.perf_counter()
    bitset = pack_bitsets_device(
        idx.incidence_protein, idx.incidence_rank, n, idx.n_repeated,
        row_multiple=7 * blk, device=dev,
    )
    t_index = t_index_host + time.perf_counter() - t0

    words = bitset.words
    cls = classes_to_torch(classes, bitset.n_pad, dev)
    sweep_kw = dict(strip=strip, block=blk)

    # a first call, one warm-up, then the best of 2 (each sweep ends in
    # its host copy, so the host clock times the device work)
    t0 = time.perf_counter()
    sweep_mxu(words, cls, n, thr, **sweep_kw)
    t_first = time.perf_counter() - t0
    sweep_mxu(words, cls, n, thr, **sweep_kw)
    t_sweep, kernels = float("inf"), None
    for _ in range(2):
        before = common.kernel_launches()
        t0 = time.perf_counter()
        rs, th, tl = sweep_mxu(words, cls, n, thr, **sweep_kw)
        t_sweep = min(t_sweep, time.perf_counter() - t0)
        kernels = kernels or common.launches_since(before)

    # exact pair recovery, the same discipline
    t0 = time.perf_counter()
    pairs = extract_pairs(words, cls, th, tl, n=n, threshold=thr)
    t_extract_first = time.perf_counter() - t0
    extract_pairs(words, cls, th, tl, n=n, threshold=thr)
    t_extract = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        pairs = extract_pairs(words, cls, th, tl, n=n, threshold=thr)
        t_extract = min(t_extract, time.perf_counter() - t0)

    # fused extraction (in-sweep top-k compaction): the synthetic corpus
    # is dense-homology, the regime --extract fused exists for; it must
    # equal two-pass. UKC_SCALE_FUSED=0 skips it.
    fused_stats = {}
    if os.environ.get("UKC_SCALE_FUSED", "1") != "0":
        t0 = time.perf_counter()
        out = sweep_mxu(words, cls, n, thr, fused_k=None, **sweep_kw)
        t_fused_first = time.perf_counter() - t0
        if out[3] is None:
            sched, _, _ = resolve_schedule(words.shape[0], blk, strip)
            why = (
                "strip schedule" if sched == "strips"
                else "memory budget (candidate buffers do not fit)"
            )
            fused_stats = {"fused": f"unavailable ({why})"}
        else:
            sweep_mxu(words, cls, n, thr, fused_k=None, **sweep_kw)
            t_sweep_f = float("inf")
            for _ in range(2):
                t0 = time.perf_counter()
                rs_f, th_f, tl_f, cands = sweep_mxu(
                    words, cls, n, thr, fused_k=None, **sweep_kw
                )
                t_sweep_f = min(t_sweep_f, time.perf_counter() - t0)
            # extraction only reads the candidate buffers, so the timed
            # sweep's candidates serve every repeat
            t_extract_f = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                pairs_f = extract_pairs_fused(
                    words, cls, th_f, tl_f, cands, n=n, threshold=thr,
                )
                t_extract_f = min(t_extract_f, time.perf_counter() - t0)
                _check(np.array_equal(pairs_f, pairs), "fused != two_pass")
            fused_stats = {
                "fused_k": cands.k,
                "sweep_fused_seconds": round(t_sweep_f, 3),
                "extract_fused_seconds": round(t_extract_f, 3),
                "fused_first_run_seconds": round(t_fused_first, 3),
                "e2e_speedup_fused": round(
                    (t_sweep + t_extract) / (t_sweep_f + t_extract_f), 2
                ),
            }
            del rs_f, th_f, tl_f, cands
        del out

    # the out-of-core stream engine (UKC_SCALE_STREAM=1) on the host-
    # packed matrix: its overhead beside the in-core scan at the same
    # scale; pair-list equality is gated
    bitset_gb = round(words.numel() * 4 / 2**30, 2)
    stream_stats = {}
    if os.environ.get("UKC_SCALE_STREAM", "0") != "0":
        from uniprot_kmer_based_clustering_tpu_torch.kmers.bitset import (
            pack_bitsets,
        )
        from uniprot_kmer_based_clustering_tpu_torch.ops import (
            stream as stream_mod,
        )
        from uniprot_kmer_based_clustering_tpu_torch.ops.stream import (
            extract_pairs_stream_fused,
            sweep_mxu_stream,
        )

        # the stream engine budgets the card as if it owned it: free the
        # in-core tensors first
        del words, cls
        bitset = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        # UKC_SCALE_STREAM_BUDGET: the engine's budget in GiB (0 = its
        # default 13 GiB); a budget below the matrix is the out-of-core
        # design point
        budget_gib = float(os.environ.get("UKC_SCALE_STREAM_BUDGET", "0"))

        t0 = time.perf_counter()
        bs_host = pack_bitsets(
            idx.incidence_protein, idx.incidence_rank, n, idx.n_repeated,
            row_multiple=7 * blk,
        )
        t_pack_host = time.perf_counter() - t0
        cls_np = np.full(bs_host.n_pad, -1, np.int32)
        cls_np[:n] = classes

        # fused_k from the in-core sweep's tile hits: the stream sweep
        # visits the same tiles, so no sub-tile overflows
        max_hits = int(th[:, 0].max()) if len(th) else 1
        fused_k = 1 << max(8, int(np.ceil(np.log2(max(max_hits, 1)))))
        fused_k = min(fused_k, blk * blk)

        stream_kw = dict(block=blk, bs=7 * blk, fused_k=fused_k)
        if budget_gib:
            stream_kw["hbm_budget_bytes"] = int(budget_gib * (1 << 30))

        t0 = time.perf_counter()
        rs_s, th_s, tl_s, cands = sweep_mxu_stream(
            bs_host.words, cls_np, n, thr, device=dev, **stream_kw
        )
        t_sweep_s = time.perf_counter() - t0
        trace = dict(stream_mod.last_trace or {})
        tot_s = rs_s.sum(axis=0)

        t0 = time.perf_counter()
        pairs_s = extract_pairs_stream_fused(
            bs_host.words, cls_np, th_s, tl_s, cands, n=n, threshold=thr,
            device=dev,
        )
        t_extract_s = time.perf_counter() - t0
        _check(np.array_equal(pairs_s, pairs), "stream != in-core")
        _check(int(tot_s[2]) == int(rs.sum(axis=0)[2]),
               "stream totals != in-core")
        streamed_gib = (
            trace.get("uploads", 0)
            * (7 * blk) * bs_host.words.shape[1] * 4 / 2**30
        )
        stream_stats = {
            "stream_sweep_seconds": round(t_sweep_s, 3),
            "stream_extract_seconds": round(t_extract_s, 3),
            "stream_pack_host_seconds": round(t_pack_host, 3),
            "stream_value": round(n * (n - 1) / 2.0 / t_sweep_s, 1),
            "stream_fused_k": fused_k,
            "stream_streamed_gib": round(streamed_gib, 3),
            "stream_trace": _trace(trace),
            "stream_parity": "pair-list identical to the in-core engine",
        }
        if budget_gib:
            stream_stats["stream_hbm_budget_gib"] = budget_gib
            stream_stats["stream_note"] = (
                f"out-of-core design point: "
                f"{bs_host.words.nbytes / 2**30:.1f} GiB matrix streamed "
                f"under a {budget_gib:.1f} GiB budget"
            )

    n_pairs = n * (n - 1) / 2.0
    tot = rs.sum(axis=0)
    _check(len(pairs) == int(tot[2]),
           f"pair list {len(pairs)} != the sweep's {int(tot[2])}")

    t0 = time.perf_counter()
    n_checked = oracle_gate(idx, classes, pairs, n, thr)
    t_oracle = time.perf_counter() - t0

    rec = {
        "metric": METRIC,
        "value": round(n_pairs / t_sweep, 1),
        "unit": UNIT,
        "n_proteins": n,
        "k": kk,
        "repeated_kmers": idx.n_repeated,
        "bitset_gb": bitset_gb,
        "sweep_seconds": round(t_sweep, 6),
        "first_run_seconds": round(t_first, 3),
        "index_seconds": round(t_index, 3),
        "synth_seconds": round(t_synth, 3),
        "cross_amr_pairs": int(tot[1]),
        "pairs_over_threshold": int(tot[2]),
        "extract_seconds": round(t_extract, 6),
        "extract_first_run_seconds": round(t_extract_first, 3),
        "oracle_checked_pairs": n_checked,
        "oracle_seconds": round(t_oracle, 3),
        "oracle": (
            "sampled-pair exact counts from host incidence lists: "
            "membership+count gated both directions"
        ),
        "kernels": kernels,
        **common.device_fields(dev),
        **dev_idx_stats,
        **fused_stats,
        **stream_stats,
    }
    _write("torch_scale7mer" if kk == 7 else f"torch_scale{n // 1000}k", rec)
    return rec


def main() -> int:
    return common.run_bench(METRIC, UNIT, measure)


if __name__ == "__main__":
    sys.exit(main())
