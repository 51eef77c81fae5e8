#!/usr/bin/env python3
"""The port's mesh entry points on four distinct cards, each held to one
card.

    python scripts/four_cards.py [OUT_JSON]

Needs four visible CUDA cards and exits 1 otherwise: nothing falls back
to fewer cards, to a shared card or to the CPU. On ``cuda:0..3``, with
every kernel launch counter set to 0 just before each run and read just
after (summed over the shards, and over the ranks of the distributed
run):

1. ``dryrun.dryrun_multichip(4)``: its line, K1 and K2 launches (both
   must be > 0), seconds;
2. ``cli run`` on 30,000 synthetic proteins (``chip_smoke.write_fasta``,
   the JAX package's scale point): on one card (``--device cuda``), then
   ``--devices 4``, ``--mesh-shape 2x2``, ``--devices 4 --shard-axis
   kmers`` and ``--devices 4 --engine stream --stream-source csr``. Each
   mesh run's pairs.tsv and clusters.tsv must be byte-equal to the one
   card's, and its K1 and K2 launches equal to its schedule's count
   (``parallel.count_substeps``, ``count_substeps_2d``,
   ``count_kaxis_strips``; the out-of-core trace's steps). Wall and
   sweep seconds, and the peak memory of each card;
3. ``QueryServer(mesh=make_mesh(4))`` on the 10,619 corpus, batches 1
   and 256 of its own sequences, against the one-card device server; and
   a stream server on ``cuda:1`` (not the current card) against the same
   answers;
4. ``cli run --distributed`` on the 30k corpus under ``torchrun
   --nproc-per-node 4`` (NCCL, one rank a card): rank 0's files
   byte-equal to the one card's, K1 summed over the ranks.

Prints the cards' names and power limits (nvidia-smi), one line a run,
and writes every figure to OUT_JSON (default ``four_cards.json`` in the
working directory). Exits nonzero when a check fails.
"""

from __future__ import annotations

import filecmp
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the corpus writer and kernel counters)

D = 4
N_SCALE = chip_smoke.N_SCALE
N_QUERY = chip_smoke.N_PROTEINS
FILES = ("pairs.tsv", "clusters.tsv")


def _peaks(torch) -> list:
    return [torch.cuda.max_memory_allocated(i) for i in range(D)]


def _reset_peaks(torch) -> None:
    for i in range(D):
        torch.cuda.synchronize(i)
        torch.cuda.reset_peak_memory_stats(i)


def _launches(fns) -> dict:
    return {k: fn.launches for k, fn in fns.items()}


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def dryrun_run(torch) -> dict:
    from uniprot_kmer_based_clustering_tpu_torch.dryrun import (
        dryrun_multichip,
    )

    fns = chip_smoke.reset_counters()
    t0 = time.perf_counter()
    res = dryrun_multichip(D)
    secs = time.perf_counter() - t0
    launches = _launches(fns)
    _check(launches["K1"] > 0 and launches["K2"] > 0,
           f"dry run launches {launches}: K1 and K2 must both launch")
    _check(res["distinct_devices"] == D, "the dry run shared a card")
    print(f"dry run on {D} distinct cards: {secs:.3f} s, launches "
          f"{launches}", flush=True)
    return {"seconds": secs, "launches": launches,
            "figures": {k: res[k] for k in (
                "stats_sum", "pairs", "stream_mesh_pairs", "docfreq_nnz",
                "clusters", "kaxis_pairs", "dsweep", "distinct_devices")}}


def cli_runs(torch, fasta: str, tmp: str) -> dict:
    """The one-card run and the four mesh runs of ``cli run``."""
    from uniprot_kmer_based_clustering_tpu_torch import cli
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        count_kaxis_strips,
        count_substeps,
        count_substeps_2d,
        pad_for_mesh,
    )
    from uniprot_kmer_based_clustering_tpu_torch.parallel import stream_mesh

    _, _, bitset = chip_smoke.host_state(fasta)
    n_pad = pad_for_mesh(bitset.n_pad, D, 128)
    runs = [
        ("one card", [], None),
        ("flat", ["--devices", str(D)],
         {"K1": count_substeps(D, n_pad), "K2": 0}),
        ("2x2", ["--mesh-shape", "2x2"],
         {"K1": count_substeps_2d(2, 2, n_pad), "K2": 0}),
        ("k axis", ["--devices", str(D), "--shard-axis", "kmers"],
         {"K1": count_kaxis_strips(D, n_pad), "K2": 0}),
        ("stream csr", ["--devices", str(D), "--engine", "stream",
                        "--stream-source", "csr"], "trace"),
    ]
    out = {}
    ref = os.path.join(tmp, "one card")
    for label, flags, want in runs:
        dest = os.path.join(tmp, label)
        fns = chip_smoke.reset_counters()
        _reset_peaks(torch)
        t0 = time.perf_counter()
        rc = cli.main(["run", fasta, "--out", dest, "--device", "cuda",
                       *flags])
        wall = time.perf_counter() - t0
        launches = _launches(fns)
        peaks = _peaks(torch)
        _check(rc == 0, f"cli run {label} returned {rc}")
        with open(os.path.join(dest, "stats.json")) as f:
            timings = json.load(f)["timings_s"]
        if want == "trace":
            want = {"K1": 0, "K2": stream_mesh.last_mesh_trace["steps"]}
        same = all(filecmp.cmp(os.path.join(ref, f), os.path.join(dest, f),
                               shallow=False) for f in FILES)
        print(f"cli run {label} {' '.join(flags)}: wall {wall:.3f} s, sweep "
              f"{timings.get('sweep')} s, launches {launches}, peak bytes "
              f"by card {peaks}, files equal to one card: {same}",
              flush=True)
        _check(same, f"cli run {label}: {FILES} differ from one card's")
        if want is not None:
            got = {k: launches[k] for k in want}
            _check(got == want, f"cli run {label}: launches {got} != the "
                                f"schedule's {want}")
        out[label] = {"flags": flags, "wall_s": wall, "timings_s": timings,
                      "launches": launches, "expected": want,
                      "peak_bytes": peaks}
    return out


def serving(torch, fasta: str) -> dict:
    import numpy as np

    from uniprot_kmer_based_clustering_tpu_torch.parallel import make_mesh
    from uniprot_kmer_based_clustering_tpu_torch.similarity import (
        QueryServer,
    )

    table, index, bitset = chip_smoke.host_state(fasta)
    seqs = [table.seq(i) for i in range(table.n)]
    one = QueryServer(index, bitset, mode="device", device="cuda:0")
    cards = make_mesh(D)
    _check(len(set(cards.devices)) == D, f"a mesh of {cards.devices}")
    mesh = QueryServer(index, bitset, mesh=cards)
    stream = QueryServer(index, bitset, mode="stream", device="cuda:1",
                         stream_source="csr")
    _check(torch.cuda.current_device() == 0, "the current card moved")
    out = {}
    for batch in (1, 256):
        qs = seqs[:batch]
        want = one.query(qs, threshold=chip_smoke.THRESHOLD)
        for label, srv in (("mesh", mesh), ("stream cuda:1", stream)):
            srv.query(qs, threshold=chip_smoke.THRESHOLD)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = srv.query(qs, threshold=chip_smoke.THRESHOLD)
            secs = time.perf_counter() - t0
            _check(len(got) == len(want) and all(
                np.array_equal(g, w) for g, w in zip(got, want)),
                f"{label} server, batch {batch}: answers differ from one "
                f"card's")
            out[f"{label} batch {batch}"] = {"seconds": secs,
                                             "queries_s": batch / secs}
        one.query(qs, threshold=chip_smoke.THRESHOLD)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one.query(qs, threshold=chip_smoke.THRESHOLD)
        secs = time.perf_counter() - t0
        out[f"one card batch {batch}"] = {"seconds": secs,
                                          "queries_s": batch / secs}
    print(f"serving on the {N_QUERY} corpus, answers equal to one card's: "
          f"{json.dumps(out)}", flush=True)
    return out


def rank_worker(fasta: str, dest: str) -> int:
    """One torchrun rank of ``cli run --distributed``: its launches,
    seconds and peak memory to ``dest/rank<R>.json``."""
    import torch

    from uniprot_kmer_based_clustering_tpu_torch import cli

    rank = int(os.environ["RANK"])
    fns = chip_smoke.reset_counters()
    t0 = time.perf_counter()
    rc = cli.main(["run", fasta, "--out", os.path.join(dest, "out"),
                   "--distributed", "--device", "cuda"])
    wall = time.perf_counter() - t0
    card = torch.cuda.current_device()
    with open(os.path.join(dest, f"rank{rank}.json"), "w") as f:
        json.dump({"rc": rc, "wall_s": wall, "card": card,
                   "launches": _launches(fns),
                   "peak_bytes": torch.cuda.max_memory_allocated(card)}, f)
    return rc


def distributed(fasta: str, tmp: str, ref: str) -> dict:
    dest = os.path.join(tmp, "distributed")
    os.makedirs(dest)
    t0 = time.perf_counter()
    proc = subprocess.run(
        ["torchrun", "--standalone", f"--nproc-per-node={D}",
         os.path.abspath(__file__), "--rank-worker", fasta, dest],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    _check(proc.returncode == 0, f"torchrun exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}{proc.stderr[-6000:]}")
    ranks = []
    for r in range(D):
        with open(os.path.join(dest, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    _check(sorted(x["card"] for x in ranks) == list(range(D)),
           f"ranks on cards {[x['card'] for x in ranks]}")
    k1 = sum(x["launches"]["K1"] for x in ranks)
    with open(os.path.join(dest, "out", "stats.json")) as f:
        timings = json.load(f)["timings_s"]
    same = all(filecmp.cmp(os.path.join(ref, f),
                           os.path.join(dest, "out", f), shallow=False)
               for f in FILES)
    print(f"cli run --distributed, {D} NCCL ranks: torchrun wall {wall:.3f} "
          f"s, rank walls {[round(x['wall_s'], 3) for x in ranks]}, sweep "
          f"{timings.get('sweep')} s, K1 summed {k1}, peak bytes by card "
          f"{[x['peak_bytes'] for x in ranks]}, files equal to one card: "
          f"{same}", flush=True)
    _check(same, f"--distributed: {FILES} differ from one card's")
    return {"torchrun_wall_s": wall, "timings_s": timings, "K1_summed": k1,
            "ranks": ranks}


def main() -> int:
    if sys.argv[1:2] == ["--rank-worker"]:
        return rank_worker(*sys.argv[2:4])
    import torch

    seen = torch.cuda.device_count()
    if seen < D:
        print(f"needs {D} CUDA cards; torch sees {seen}", file=sys.stderr)
        return 1
    dest = sys.argv[1] if len(sys.argv) > 1 else "four_cards.json"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    for line in smi:
        print(line, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} cards", flush=True)
    from uniprot_kmer_based_clustering_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_kernels()
    print(f"kernels built in {time.perf_counter() - t0:.3f} s", flush=True)
    result = {"cards": smi}
    tmp = tempfile.mkdtemp(prefix="ukc_four_cards_")
    try:
        result["dryrun"] = dryrun_run(torch)
        fasta30 = os.path.join(tmp, "synth30k.fasta")
        fasta10 = os.path.join(tmp, "synth10k.fasta")
        chip_smoke.write_fasta(fasta30, N_SCALE)
        chip_smoke.write_fasta(fasta10, N_QUERY)
        result["cli"] = cli_runs(torch, fasta30, tmp)
        result["serving"] = serving(torch, fasta10)
        torch.cuda.empty_cache()
        result["distributed"] = distributed(fasta30, tmp,
                                            os.path.join(tmp, "one card"))
    finally:
        os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
        with open(dest, "w") as f:
            json.dump(result, f, indent=1)
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"four-card runs passed; figures in {dest}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
