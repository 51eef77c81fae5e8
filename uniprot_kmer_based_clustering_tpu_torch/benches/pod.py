"""Mesh scaling benchmark of the port: ring-sweep pairs/s/chip at any
device count.

    python -m uniprot_kmer_based_clustering_tpu_torch.benches.pod
    UKC_POD_DEVICES=4 python -m ...benches.pod    # the first 4 cards
    UKC_POD_MESH=2x4 python -m ...benches.pod     # hosts × chips, 2-D ring
    UKC_POD_DISTRIBUTED=1 torchrun --nproc-per-node 4 -m ...benches.pod

The port's ``bench_pod.py``. It packs the corpus with the mesh's
padding (the largest tile of 512/256/128 whose padding stays within 7%,
unless ``UKC_POD_TILE`` sets it), stages it on the mesh once
(``parallel.stage_mesh_inputs``), and times the ring sweep: two warm
sweeps, each ended by a fetch of its statistics, then five dispatched
back to back and fetched once. The sweep runs K1 on every ring
sub-step; the line's ``kernels`` are the K1 and K2 launches of one warm
sweep in this process (``parallel.count_substeps`` of the mesh on one
process). Then ``sharded_extract_pairs`` and, on a flat mesh unless
``UKC_POD_FUSED=0``, ``sharded_pairwise_fused``, best of 2 after 2 warm
calls each.

Gates: the sweep's four counters equal ``bench_pod.py``'s golden
counters when ``UKC_BENCH_FASTA`` names a file, else the scipy oracle's
on ``synth_proteins(UKC_BENCH_N, seed=0)`` (10,619); the extraction's
count and largest score equal the oracle's (its whole list, on the
synthetic corpus); the fused pass's counters and pairs equal the
two-pass ones.

The one-card reference runs the same sweep on ``make_mesh(1)`` when the
mesh has more than one device and one process; ``UKC_1CHIP_PAIRS_PER_S``
overrides it. ``scaling_efficiency`` = mesh pairs/s / (D × one-card
pairs/s), 1.0 by construction at D = 1. ``UKC_POD_DISTRIBUTED=1`` joins
the torchrun world first (``parallel.init_distributed``: NCCL, gloo on
the CPU); every rank runs the bench and only rank 0 prints the line and
writes the artifact (``torch_pod``). The device is ``UKC_BENCH_DEVICE``
(``cuda``); without a card the bench prints its failure line and exits
1, and a mesh of more cards than are visible fails likewise.
"""

from __future__ import annotations

import contextlib
import io
import os
import sys
import time

import numpy as np

from uniprot_kmer_based_clustering_tpu_torch.benches import common
from uniprot_kmer_based_clustering_tpu_torch.benches.common import (
    BenchFailure,
)

METRIC = "ring_sweep_scaling"
UNIT = "pairs/s/chip"
N_DEFAULT = 10_619
REPS = 5
# bench_pod.py's gate: the bundled uniprot_arg.fasta's counters
GOLDEN = {
    "edges_after_amr_filter": 5_300_233,
    "pairs_after_merge": 4_350_628,
    "pairs_over_threshold": 465,
    "max_shared_kmers": 567,
}


def pick_tile(n: int, d: int) -> int:
    """``UKC_POD_TILE``, else the largest of 512/256/128 whose mesh
    padding stays within 7% of ``n`` (128 when none does), as
    ``bench_pod.py`` picks it."""
    from uniprot_kmer_based_clustering_tpu_torch.parallel import pad_for_mesh

    tile = int(os.environ.get("UKC_POD_TILE", "0"))
    if not tile:
        for tile in (512, 256, 128):
            if pad_for_mesh(n, d, tile) <= n * 1.07:
                break
    return tile


def build_mesh(dev):
    """The bench's mesh: ``UKC_POD_MESH=HxC`` gives the 2-D ring, else the
    flat ring over ``UKC_POD_DEVICES`` devices (all visible cards, or one
    CPU shard). Across processes each rank gives its own card (the one
    ``UKC_BENCH_DEVICE`` names, else ``cuda:LOCAL_RANK``), as ``cli
    --distributed`` does. (mesh, label)."""
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        make_mesh,
        make_mesh_2d,
    )
    from uniprot_kmer_based_clustering_tpu_torch.parallel.mesh import world

    if world()[1] > 1:
        dev = os.environ.get("UKC_BENCH_DEVICE", "cuda")
    spec = os.environ.get("UKC_POD_MESH")
    try:
        if spec:
            hc, cc = (int(x) for x in spec.lower().split("x"))
            return make_mesh_2d(hc, cc, device=dev), spec
        nd = os.environ.get("UKC_POD_DEVICES")
        mesh = make_mesh(int(nd) if nd else None, device=dev)
    except ValueError as e:
        raise BenchFailure(f"mesh: {e}") from e
    return mesh, f"{mesh.size}"


def _steady(sweep, fetch, reps: int = REPS):
    """Two warm sweeps, each ended by a fetch, then ``reps`` back to back
    and one fetch: (seconds a sweep, the fetched result, the launches of
    the second warm sweep)."""
    for _ in range(2):
        before = common.kernel_launches()
        fetch(sweep())
        kernels = common.launches_since(before)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = sweep()
    got = fetch(out)
    return (time.perf_counter() - t0) / reps, got, kernels


def run_mesh(mesh, words, classes, n: int, block_tile: int):
    """The timed ring sweep on ``mesh`` (staged shards, or the host
    words): (seconds, counters, kernels)."""
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        sharded_sweep_async,
    )

    dispatch, finalize = sharded_sweep_async(mesh, words, classes, n,
                                             common.THRESHOLD, block_tile)
    dt, (row_stats, _, _), kernels = _steady(dispatch, finalize)
    return dt, common.counters_of(row_stats), kernels


def _best_of_2(fn):
    """Two warm calls (each ends in its host fetch), then the best of 2:
    (seconds, the last result)."""
    for _ in range(2):
        out = fn()
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def measure() -> dict:
    from uniprot_kmer_based_clustering_tpu_torch.kmers import (
        build_index,
        encode_kmers,
        pack_bitsets,
    )
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        make_mesh,
        mesh as mesh_mod,
        pad_for_mesh,
        sharded_extract_pairs,
        sharded_pairwise_fused,
        stage_mesh_inputs,
    )

    # join the world before the device is resolved: NCCL makes each
    # rank's own card (LOCAL_RANK) current, which "cuda" then names
    dev = common.bench_device(resolve=False)
    if os.environ.get("UKC_POD_DISTRIBUTED"):
        mesh_mod.init_distributed(
            backend="gloo" if dev.type == "cpu" else None)
    dev = common.bench_device()
    corpus = common.load_corpus(N_DEFAULT)
    n, thr = corpus.n, common.THRESHOLD
    codes, koff = encode_kmers(corpus.seq_buf, corpus.offsets, 5)
    idx = build_index(codes, koff, 5)
    mesh, label = build_mesh(dev)
    d = mesh.size
    flat = len(mesh.axis_names) == 1

    block_tile = pick_tile(n, d)
    n_pad = pad_for_mesh(n, d, block_tile)
    bitset = pack_bitsets(idx.incidence_protein, idx.incidence_rank, n,
                          idx.n_repeated, row_multiple=n_pad,
                          word_multiple=128)
    classes = np.full(bitset.n_pad, -1, np.int32)
    classes[:n] = corpus.classes
    n_pairs = n * (n - 1) / 2.0
    if corpus.fasta is not None:
        want, want_pairs, parity = GOLDEN, None, "golden-exact"
    else:
        want, want_pairs = common.index_oracle(idx, corpus.classes, n, thr)
        parity = "oracle-exact"

    # stage the packed matrix onto the mesh once: every call below takes
    # the staged shards as they are
    words_st, classes_st = stage_mesh_inputs(mesh, bitset.words, classes)
    dt_mesh, got, kernels = run_mesh(mesh, words_st, classes_st, n,
                                     block_tile)
    if got != want:
        raise BenchFailure(f"golden parity FAILED: {got} != {want}")

    # mesh-parallel extraction; tile_cap=None is what the port's pipeline
    # runs (and JAX off the TPU): each survivor mask appended whole
    t_extract, pairs = _best_of_2(lambda: sharded_extract_pairs(
        mesh, words_st, classes_st, n, thr, block_tile=block_tile,
        tile_cap=None))
    top = int(pairs[:, 2].max()) if len(pairs) else 0
    if (len(pairs), top) != (want["pairs_over_threshold"],
                             want["max_shared_kmers"]) or (
            want_pairs is not None
            and not np.array_equal(pairs.astype(np.int64), want_pairs)):
        raise BenchFailure(f"extraction parity FAILED: {len(pairs)} pairs, "
                           f"max {top}")

    # the fused ring (flat meshes): statistics and survivors in one pass
    fused_stats = {}
    if flat and os.environ.get("UKC_POD_FUSED", "1") != "0":
        t_fused, out = _best_of_2(lambda: sharded_pairwise_fused(
            mesh, words_st, classes_st, n, thr, block_tile=block_tile, k=0))
        rs_f, _, _, pairs_f = out
        if common.counters_of(rs_f) != want or not np.array_equal(
                pairs_f, pairs):
            raise BenchFailure("fused ring parity FAILED")
        speedup = (dt_mesh + t_extract) / t_fused
        fused_stats = {
            "fused_seconds": round(t_fused, 6),
            "fused_speedup": round(speedup, 2),
            "fused_speedup_note": (
                f"fused {'wins' if speedup >= 1 else 'loses'} at this "
                f"scale ({speedup:.2f}x vs sweep+extract)"),
        }

    # the one-card reference: the same sweep on a one-device mesh (one
    # process only; across processes UKC_1CHIP_PAIRS_PER_S carries it)
    rank, world = mesh_mod.world()
    env_ref = os.environ.get("UKC_1CHIP_PAIRS_PER_S")
    if env_ref:
        one_chip = float(env_ref)
    elif d == 1:
        one_chip = n_pairs / dt_mesh
    elif world == 1:
        dt_one = run_mesh(make_mesh(1, device=dev), bitset.words, classes,
                          n, block_tile)[0]
        one_chip = n_pairs / dt_one
    else:
        one_chip = None

    per_chip = n_pairs / dt_mesh / d
    rec = {
        "metric": METRIC,
        "value": round(per_chip, 1),
        "unit": UNIT,
        "devices": d,
        "hosts": world,
        "mesh": label,
        "pairs_per_s": round(n_pairs / dt_mesh, 1),
        "pairs_per_s_per_chip": round(per_chip, 1),
        "sweep_seconds": round(dt_mesh, 6),
        "extract_seconds": round(t_extract, 6),
        "block_tile": block_tile,
        "parity": parity,
        **fused_stats,
    }
    if one_chip:
        rec["one_chip_pairs_per_s"] = round(one_chip, 1)
        rec["scaling_efficiency"] = round(
            n_pairs / dt_mesh / (d * one_chip), 4)
    rec.update(n_pad=n_pad, counters=got, extracted_pairs=len(pairs),
               extracted_max=top, dataset=corpus.label,
               n_proteins=n, kernels=kernels, **common.device_fields(dev))
    if rank == 0:
        from uniprot_kmer_based_clustering_tpu_torch.utils.artifact import (
            write_bench_artifact,
        )

        write_bench_artifact("torch_pod", rec)
    return rec


def main() -> int:
    """Run the bench; only rank 0 of a distributed run prints its line
    (an H-host run would otherwise print H copies)."""
    from uniprot_kmer_based_clustering_tpu_torch.parallel.mesh import world

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = common.run_bench(METRIC, UNIT, measure)
    if world()[0] == 0:
        sys.stdout.write(out.getvalue())
        sys.stdout.flush()
    return rc


if __name__ == "__main__":
    sys.exit(main())
