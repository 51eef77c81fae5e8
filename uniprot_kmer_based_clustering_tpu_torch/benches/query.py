"""Serving benchmark of the port: shared-k-mer queries/s against a
standing corpus.

    python -m uniprot_kmer_based_clustering_tpu_torch.benches.query

The port's ``bench_query.py``. A resident ``QueryServer(mode="device")``
(the packed corpus on the card, each batch answered by blocked int8
products and the top-k epilogue) and a ``mode="host"`` server (the
rank-CSR walk, an independent structure over the same index) are built
on the corpus, and the bench measures:

* the batch-size curve: 1 / 16 / 64 / 256 queries a request,
  synchronous (two warm calls, then the best of 4);
* pipelined throughput: 64 × 8 and 256 × 4 batches in flight through
  ``query_async`` / ``query_wait`` (the best of 3);
* the latency route: batch 1 on the host walk, and on the device server
  with ``set_host_route_max(4)`` (its routed handles carry
  ``"host_seqs"``), beside the device path and the measured break-even
  batch;
* with ``UKC_QUERY_STREAM=1``, a ``mode="stream"`` server on the same
  corpus, batch 256, cold and warm;
* unless ``UKC_QUERY_MESH=0`` (and never with ``UKC_QUERY_N``), a
  row-sharded ``QueryServer(mesh=...)`` on ``UKC_QUERY_MESH_D`` (8) CPU
  shards, in a subprocess of this module (``--mesh-probe``):
  correctness and overhead evidence, no hardware claim. A probe that
  fails is recorded as ``{"error": ...}``.

Gates, each fatal: the 256 spread probes answer exactly as the host
walk; protein 0's self count equals its row's popcount; every pipelined
and routed answer equals the synchronous one; the stream server's
answers equal the host walk's; and no kernel of K1–K4 launches (serving
runs none: the line's ``kernels`` read 0).

Corpus: ``UKC_QUERY_N`` > 0 gives ``synth_proteins(UKC_QUERY_N)`` (the
serving-at-scale point; artifact ``torch_queryscale<N/1000>k``, or
``torch_queryscale`` at 30,000); otherwise ``UKC_BENCH_FASTA`` where
that file exists, else ``synth_proteins(UKC_BENCH_N, seed=0)`` (10,619;
artifact ``torch_query``). ``UKC_QUERY_TOPK`` sets the top-k capacity
(512). The device is ``UKC_BENCH_DEVICE`` (``cuda``); without a card the
bench prints its failure line and exits 1.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

from uniprot_kmer_based_clustering_tpu_torch.benches import common
from uniprot_kmer_based_clustering_tpu_torch.benches.common import (
    BenchFailure,
)

METRIC = "query_serving"
UNIT = "queries/s"
N_DEFAULT = 10_619
THRESHOLD = common.THRESHOLD
ROUTE_MAX = 4  # the latency route's break-even batch (the JAX package's)
PROBE_TIMEOUT = 1800  # seconds the mesh probe may take before it is killed
MODULE = "uniprot_kmer_based_clustering_tpu_torch.benches.query"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def all_launches() -> dict:
    """The launch counters of K1–K4: serving must launch none."""
    from uniprot_kmer_based_clustering_tpu_torch.ops import popcount, tri_mxu

    return {**common.kernel_launches(),
            "K3": tri_mxu.tri_mxu_sweep.launches,
            "K4": popcount.popcount_sweep.launches}


def build_servers(dev, mesh_devices: int = 0):
    """(corpus, bitset, the device server, the host server), or with
    ``mesh_devices`` the mesh server on that many shards of ``dev`` in
    place of the device server."""
    from uniprot_kmer_based_clustering_tpu_torch.kmers import (
        build_index,
        encode_kmers,
        pack_bitsets,
    )
    from uniprot_kmer_based_clustering_tpu_torch.similarity import (
        QueryServer,
    )

    qn = int(os.environ.get("UKC_QUERY_N", "0"))
    if qn:
        corpus = common.Corpus(*common.synth_proteins(qn),
                               f"synthetic-{qn}", None)
    else:
        corpus = common.load_corpus(N_DEFAULT)
    codes, koff = encode_kmers(corpus.seq_buf, corpus.offsets, 5)
    idx = build_index(codes, koff, 5)
    bitset = pack_bitsets(idx.incidence_protein, idx.incidence_rank,
                          corpus.n, idx.n_repeated, row_multiple=512)
    if mesh_devices:
        from uniprot_kmer_based_clustering_tpu_torch.parallel import (
            make_mesh,
        )

        srv = QueryServer(idx, bitset,
                          mesh=make_mesh(mesh_devices, device=dev))
    else:
        srv = QueryServer(idx, bitset, mode="device", topk_cap=_topk(),
                          device=dev)
    host = QueryServer(idx, bitset, mode="host", device=dev)
    return corpus, bitset, srv, host


def _topk() -> int:
    # serving hit-lane capacity: a dense corpus at scale has hundreds of
    # over-gate matches a query, which the default 512 would send through
    # the exact full-counts redo
    return int(os.environ.get("UKC_QUERY_TOPK", "512"))


def _probes(n: int, count: int) -> list:
    """``count`` corpus rows spread over the corpus."""
    return list(range(0, n, max(1, n // count)))[:count]


def _same(got, want) -> bool:
    return len(got) == len(want) and all(
        np.array_equal(g, w) for g, w in zip(got, want))


def mesh_probe() -> dict:
    """The mesh-sharded server on ``UKC_QUERY_MESH_D`` CPU shards: 64
    spread probes host-exact, then the best of 3 batches."""
    import torch

    d = int(os.environ.get("UKC_QUERY_MESH_D", "8"))
    corpus, _, srv, host = build_servers(torch.device("cpu"),
                                        mesh_devices=d)
    qis = _probes(corpus.n, 64)
    seqs = [corpus.seq(i) for i in qis]
    got = srv.query(seqs, threshold=THRESHOLD)
    want = host.query(seqs, threshold=THRESHOLD)
    for qi, g, w in zip(qis, got, want):
        if not np.array_equal(g, w):
            return {"error": f"mesh/host mismatch on {qi}"}
    srv.query(seqs, threshold=THRESHOLD)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        srv.query(seqs, threshold=THRESHOLD)
        best = min(best, time.perf_counter() - t0)
    return {
        "devices": d,
        "batch": len(seqs),
        "batch_seconds": round(best, 4),
        "parity": f"host-exact ({len(seqs)}/{len(seqs)} queries)",
        "label": "CPU mesh (parallel.make_mesh(D, device='cpu')) — "
                 "sharded-serving correctness + overhead evidence, NOT a "
                 "hardware perf claim",
    }


def _run_mesh_probe() -> dict:
    """:func:`mesh_probe` in a subprocess on the CPU; its failure is
    recorded, not raised (the probe is evidence, not a gate)."""
    env = dict(os.environ, UKC_BENCH_DEVICE="cpu",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    try:
        p = subprocess.run(
            [sys.executable, "-m", MODULE, "--mesh-probe"],
            capture_output=True, text=True, timeout=PROBE_TIMEOUT, env=env,
            cwd=ROOT,
        )
        lines = p.stdout.strip().splitlines()
        if p.returncode != 0 or not lines:
            return {"error": f"exit {p.returncode}: {p.stderr[-200:]}"}
        return json.loads(lines[-1])
    except (OSError, subprocess.SubprocessError, ValueError) as e:
        return {"error": str(e)[:200]}


def measure() -> dict:
    dev = common.bench_device()
    corpus, bitset, srv, host = build_servers(dev)
    launches0 = all_launches()

    # 256 corpus members spread over the corpus, every answer checked
    # against the independent host CSR walk
    qis = _probes(corpus.n, 256)
    seqs = [corpus.seq(i) for i in qis]
    got = srv.query(seqs, threshold=THRESHOLD)
    want = host.query(seqs, threshold=THRESHOLD)
    for qi, g, w in zip(qis, got, want):
        if not np.array_equal(g, w):
            raise BenchFailure(f"device/host mismatch on corpus query {qi}")

    # protein 0's self count is its row's popcount
    row0 = int(np.unpackbits(
        np.ascontiguousarray(bitset.words[qis[0]]).view(np.uint8)).sum())
    self_hit = [int(c) for j, c in got[0] if j == qis[0]]
    if self_hit != [row0]:
        raise BenchFailure(f"self-count mismatch: {self_hit} != {row0} for "
                           f"corpus protein {qis[0]}")

    def steady(batch, reps):
        # two warm calls (each ends in its fetch), then the best of reps
        srv.query(batch, threshold=THRESHOLD)
        srv.query(batch, threshold=THRESHOLD)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            srv.query(batch, threshold=THRESHOLD)
            best = min(best, time.perf_counter() - t0)
        return best

    # the batch-size curve (synchronous); rates use the actual batch
    # length, which a small corpus may cut below b
    curve = {}
    for b in (1, 16, 64, 256):
        batch = seqs[:b]
        t = steady(batch, reps=4)
        curve[str(b)] = {"batch_seconds": round(t, 6),
                         "queries_per_s": round(len(batch) / t, 1)}
    t1 = curve["1"]["batch_seconds"]

    # pipelined: `depth` batches in flight, every answer held to the
    # synchronous one
    pipeline = {}
    best_qps = max(v["queries_per_s"] for v in curve.values())
    for b, depth in ((64, 8), (256, 4)):
        batch = seqs[:b]
        sync_ans = srv.query(batch, threshold=THRESHOLD)
        srv.query_wait(srv.query_async(batch, threshold=THRESHOLD))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            handles = [srv.query_async(batch, threshold=THRESHOLD)
                       for _ in range(depth)]
            answers = [srv.query_wait(h) for h in handles]
            best = min(best, time.perf_counter() - t0)
            if not all(_same(a, sync_ans) for a in answers):
                raise BenchFailure(f"pipelined/sync mismatch at batch {b}")
        qps = depth * len(batch) / best
        pipeline[f"{b}x{depth}"] = {"batch": len(batch), "depth": depth,
                                    "total_seconds": round(best, 6),
                                    "queries_per_s": round(qps, 1)}
        best_qps = max(best_qps, qps)

    # the latency route: batch 1 on the host walk, then on the device
    # server with the route on (its handle carries the sequences to the
    # walk, "host_seqs"), the answers held equal
    one = seqs[:1]
    host.query(one, threshold=THRESHOLD)
    t_host1 = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        host_one = host.query(one, threshold=THRESHOLD)
        t_host1 = min(t_host1, time.perf_counter() - t0)
    srv.set_host_route_max(ROUTE_MAX)
    try:
        h_r = srv.query_async(one, threshold=THRESHOLD)
        if "host_seqs" not in h_r:
            raise BenchFailure("latency route did not engage at batch 1")
        routed_one = srv.query_wait(h_r)
        if not (_same(routed_one, host_one) and _same(routed_one, got[:1])):
            raise BenchFailure("latency-routed answer != device/host answer")
        t_routed = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            srv.query(one, threshold=THRESHOLD)
            t_routed = min(t_routed, time.perf_counter() - t0)
    finally:
        srv.set_host_route_max(0)
    break_even = next((b for b in sorted(int(x) for x in curve)
                       if curve[str(b)]["batch_seconds"] / b < t_host1),
                      None)
    route_stats = {"latency_route": {
        "single_query_device_ms": round(t1 * 1e3, 3),
        "single_query_hostwalk_ms": round(t_host1 * 1e3, 3),
        "single_query_routed_ms": round(t_routed * 1e3, 3),
        "route_speedup": round(t1 / t_routed, 2),
        "measured_break_even_batch": break_even,
        "policy": (f"auto-mode servers route batches <= {ROUTE_MAX} to "
                   "the host CSR walk (host_route_max; device kernels "
                   "above)"),
        "parity": "routed answer == device answer == host answer",
    }}

    # stream serving (opt-in): the corpus's row blocks go through the
    # device every batch, built on it from the incidence lists (csr) or
    # copied from the host words
    stream_stats = {}
    if os.environ.get("UKC_QUERY_STREAM") == "1":
        from uniprot_kmer_based_clustering_tpu_torch.similarity import (
            QueryServer,
        )

        srv_s = QueryServer(srv.index, srv.bitset, mode="stream",
                            topk_cap=_topk(), device=dev)
        batch = seqs[:256]
        t0 = time.perf_counter()
        ans_s = srv_s.query(batch, threshold=THRESHOLD)
        t_cold = time.perf_counter() - t0
        if not _same(ans_s, want[: len(batch)]):
            raise BenchFailure("stream-mode serving mismatch vs host CSR")
        t0 = time.perf_counter()
        srv_s.query(batch, threshold=THRESHOLD)
        t_warm = time.perf_counter() - t0
        stream_stats = {"stream_mode": {
            "batch": len(batch),
            "cold_seconds": round(t_cold, 4),
            "warm_seconds": round(t_warm, 4),
            "queries_per_s_warm": round(len(batch) / t_warm, 2),
            "block_source": ("csr-device-materialized" if srv_s._use_csr
                             else "host-words"),
            "corpus_gib_per_batch": round(bitset.words.nbytes / 2**30, 3),
            "stream_bs_rows": int(srv_s._stream_bs),
            "parity": f"host-exact ({len(batch)}/{len(batch)})",
            "label": (
                "beyond-memory serving path: corpus blocks "
                + ("built on the device from the once-uploaded incidence "
                   "lists every batch" if srv_s._use_csr else
                   "copied host->device every batch")
                + "; prefer resident or mesh serving where the bitset "
                  "fits"),
        }}
        del srv_s

    kernels = {k: v - launches0[k] for k, v in all_launches().items()}
    if any(kernels.values()):
        raise BenchFailure(f"serving launched kernels: {kernels}")

    qn = int(os.environ.get("UKC_QUERY_N", "0"))
    mesh_stats = {}
    if os.environ.get("UKC_QUERY_MESH", "1") != "0" and not qn:
        mesh_stats = {"mesh_virtual_cpu": _run_mesh_probe()}

    rec = {
        "metric": METRIC,
        "value": round(best_qps, 1),
        "unit": UNIT,
        "corpus": corpus.label,
        "corpus_proteins": int(corpus.n),
        "curve": curve,
        "pipelined": pipeline,
        "max_sustained_qps": round(best_qps, 1),
        "single_query_latency_ms": round(t1 * 1e3, 3),
        "batch64_seconds": curve["64"]["batch_seconds"],
        "parity": ("host-exact (256/256 sync + every pipelined answer)"
                   if len(seqs) == 256 else
                   f"host-exact ({len(seqs)}/{len(seqs)} sync + every "
                   "pipelined answer)"),
        **common.device_fields(dev),
        "kernels": kernels,
        **route_stats,
        **stream_stats,
        **mesh_stats,
    }
    name = "torch_query"
    if qn:
        name = ("torch_queryscale" if qn == 30000
                else f"torch_queryscale{qn // 1000}k")
    from uniprot_kmer_based_clustering_tpu_torch.utils.artifact import (
        write_bench_artifact,
    )

    write_bench_artifact(name, rec)
    return rec



def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--mesh-probe" in argv:
        print(json.dumps(mesh_probe()), flush=True)
        return 0
    return common.run_bench(METRIC, UNIT, measure)


if __name__ == "__main__":
    sys.exit(main())
