#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Builds the port's CUDA kernels from ``uniprot_kmer_based_clustering_tpu_torch/
csrc`` with nvcc, then:

1. kernel phase — each kernel's wrapper against its plain PyTorch
   version on the card, at the main path's shapes; exact equality;
2. pipeline phase — the port's ``cli run --device cuda`` on a synthetic
   corpus of 10,619 proteins (``bench_scale.synth_proteins``, seed 0),
   with every kernel launch counter reset just before the run and read
   just after; the pair list and the four parity counters must equal an
   independent scipy ``B·Bᵀ`` oracle exactly;
3. timing phase — warm sweep, extraction, per-layer and per-kernel times,
   peak device memory.

Prints the card's name and power limit (nvidia-smi), a JSON line
describing each kernel, and as the last line
``{"ok": true, "device": {...}}``. Exits nonzero, printing no result, when
no CUDA GPU is visible, when run outside a checkout, or when any phase
fails. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "uniprot_kmer_based_clustering_tpu_torch"
N_PROTEINS = 10619
THRESHOLD = 10
TOL = 0  # integer statistics: kernel and plain version must agree exactly


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `reps` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def best_seconds(fn, reps: int = 3, warmup: int = 2):
    """Best host wall time of fn() bracketed by synchronize(); returns
    (seconds, last result)."""
    import torch

    out = None
    for _ in range(warmup):
        out = fn()
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best, out


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def kernel_phase(dev, stats):
    """K1 against its plain version at the strip shapes of the main path
    (N_pad 10,752, strip 1536, tile 512): strip 0 at (0, 0) and strip 3
    at (4608, 4608), unweighted and weighted (negative counts,
    w_thresh > 1)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    n, n_pad, strip = N_PROTEINS, 10752, 1536
    cls = rng.integers(0, 15, n_pad).astype(np.int32)
    cls[n:] = -1
    worst = 0
    for i0, lo, hi, thr, w_thresh in [
        (0, 0, 40, THRESHOLD, 1),
        (4608, 0, 40, THRESHOLD, 1),
        (0, -50, 400, 100, 5),
        (4608, -50, 400, 100, 5),
    ]:
        counts = torch.from_numpy(
            rng.integers(lo, hi, (strip, n_pad - i0)).astype(np.int32)
        ).to(dev)
        crow = torch.from_numpy(cls[i0 : i0 + strip]).to(dev)
        ccol = torch.from_numpy(cls[i0:]).to(dev)
        kw = dict(i_off=i0, j_off=i0, n=n, threshold=thr,
                  w_thresh=w_thresh, tile=512)
        rs, th, _ = stats.stats_from_counts(counts, crow, ccol, **kw)
        rs_ref, th_ref, _ = stats.stats_from_counts_reference(
            counts, crow, ccol, **kw
        )
        torch.cuda.synchronize()
        err = max(max_abs_err(rs, rs_ref), max_abs_err(th, th_ref))
        print(f"kernel K1 counts[{strip}, {n_pad - i0}] at ({i0}, {i0}) "
              f"values [{lo}, {hi}) threshold {thr} w_thresh {w_thresh}: "
              f"max_abs_err {err} (tolerance {TOL}), "
              f"tile hits {int(th.sum())}", flush=True)
        if err > TOL:
            raise AssertionError("K1 disagrees with its plain version")
        worst = max(worst, err)
    return worst


def write_fasta(path: str) -> None:
    """The synthetic corpus, with headers in the reference's format
    ``>ID|FEATURES|UNIPROT|<class>|gene`` so the class parses."""
    for k in [k for k in os.environ if k.startswith("UKC_SCALE_")]:
        del os.environ[k]
    from bench_scale import synth_proteins

    seq_buf, offsets, classes = synth_proteins(N_PROTEINS, seed=0)
    with open(path, "w") as f:
        for i in range(N_PROTEINS):
            seq = seq_buf[offsets[i] : offsets[i + 1]].tobytes().decode()
            f.write(f">SYN{i:06d}|FEATURES|UNIPROT|class{classes[i]}|"
                    f"gene{i}\n{seq}\n")


def scipy_oracle(index, class_ids, n: int):
    """Independent pairwise stage: triu(B·Bᵀ, 1) from the incidence
    lists, split by class. Returns (counters, cross pairs over threshold
    as int64 [M, 3] sorted by (i, j))."""
    import numpy as np
    import scipy.sparse as sp

    b = sp.csr_matrix(
        (np.ones(index.nnz, np.int32),
         (index.incidence_protein, index.incidence_rank)),
        shape=(n, index.n_repeated),
    )
    c = sp.triu(b @ b.T, k=1).tocoo()
    i, j, v = c.row.astype(np.int64), c.col.astype(np.int64), c.data
    cross = class_ids[i] != class_ids[j]
    vc = v[cross]
    counters = {
        "edges_after_amr_filter": int(vc.sum()),
        "pairs_after_merge": int(cross.sum()),
        "pairs_over_threshold": int((vc > THRESHOLD).sum()),
        "max_shared_kmers": int(vc.max()),
    }
    keep = cross & (v > THRESHOLD)
    pairs = np.stack([i[keep], j[keep], v[keep].astype(np.int64)], axis=1)
    pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    return counters, pairs


def read_pairs_tsv(path: str):
    import numpy as np

    with open(path) as f:
        next(f)
        rows = [line.split("\t") for line in f]
    return np.array(
        [(int(r[0]), int(r[1]), int(r[6])) for r in rows], dtype=np.int64
    ).reshape(-1, 3)


def pipeline_phase(dev, tmp, stats):
    """The port's `cli run --device cuda`, held against the oracle."""
    import numpy as np

    from uniprot_kmer_based_clustering_tpu_torch import PipelineConfig, cli
    from uniprot_kmer_based_clustering_tpu_torch.ops.bitmul import (
        resolve_schedule,
    )
    from uniprot_kmer_based_clustering_tpu_torch.pipeline import run_pipeline

    fasta = os.path.join(tmp, "synth.fasta")
    out = os.path.join(tmp, "out")
    t0 = time.perf_counter()
    write_fasta(fasta)
    print(f"corpus: {N_PROTEINS} proteins written in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    stats.stats_from_counts.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["run", fasta, "--out", out, "--device", dev.type])
    cli_s = time.perf_counter() - t0
    launches = stats.stats_from_counts.launches
    if rc != 0:
        raise AssertionError(f"cli run returned {rc}")

    with open(os.path.join(out, "stats.json")) as f:
        run_stats = json.load(f)
    pairs = read_pairs_tsv(os.path.join(out, "pairs.tsv"))

    # the host stages again for the oracle's incidence lists, plus the
    # geometry and device state the timing phase needs
    res = run_pipeline(fasta, PipelineConfig(cluster="none"), device=dev)
    n_pad = res.bitset.n_pad
    _, strip, ns = resolve_schedule(n_pad, 512)
    print(f"N_pad {n_pad} x W_pad {res.bitset.w_pad}, strip {strip}, "
          f"{ns} strips; K1 launches in the cli run: {launches}",
          flush=True)
    if launches != ns:
        raise AssertionError(
            f"K1 launched {launches} times in the main path, expected {ns}"
        )

    t0 = time.perf_counter()
    want, want_pairs = scipy_oracle(
        res.index, res.table.amr_class_ids, res.table.n
    )
    print(f"scipy oracle {time.perf_counter() - t0:.3f} s: {want}",
          flush=True)
    got = {k: run_stats["parity"][k] for k in want}
    print(f"cli run {cli_s:.3f} s: parity {got}, pairs {len(pairs)}",
          flush=True)
    if got != want:
        raise AssertionError(f"parity counters {got} != oracle {want}")
    if not np.array_equal(pairs, want_pairs):
        raise AssertionError("pairs.tsv differs from the oracle pair list")
    expected = {"edges_after_amr_filter": 74753766,
                "pairs_after_merge": 2075330,
                "pairs_over_threshold": 491781, "max_shared_kmers": 275}
    print(f"oracle equals the documented corpus counters: "
          f"{want == expected}", flush=True)
    if res.parity_report() != run_stats["parity"]:
        raise AssertionError("a second run disagrees with the cli run")
    return res, run_stats, launches


def timing_phase(dev, res, stats):
    """Warm sweep/extraction, per-layer times of one sweep, K1 vs its
    plain version on strip 0 of the corpus."""
    import numpy as np
    import torch

    from uniprot_kmer_based_clustering_tpu_torch.ops import bitmul
    from uniprot_kmer_based_clustering_tpu_torch.similarity.pairwise import (
        _tile_runs,
        extract_pairs,
    )
    from uniprot_kmer_based_clustering_tpu_torch.state import (
        bitset_to_torch,
        classes_to_torch,
    )

    n, n_pad = res.table.n, res.bitset.n_pad
    words = bitset_to_torch(res.bitset, dev)
    classes = classes_to_torch(res.table.amr_class_ids, n_pad, dev)
    torch.cuda.reset_peak_memory_stats(dev)

    def sweep():
        return bitmul.sweep_mxu(words, classes, n=n, threshold=THRESHOLD)

    sweep_s, (rs, th, tiles) = best_seconds(sweep)
    extract_s, pairs = best_seconds(
        lambda: extract_pairs(words, classes, th, tiles, n=n,
                              threshold=THRESHOLD)
    )
    peak = torch.cuda.max_memory_allocated(dev)
    if not np.array_equal(pairs, res.pairwise.pairs):
        raise AssertionError("warm extraction differs from the run")
    pair_count = n * (n - 1) // 2
    print(f"warm sweep_mxu {sweep_s:.6f} s (best of 3 after 2 warm-ups) "
          f"= {pair_count / sweep_s:.6e} pairs/s; warm extract_pairs "
          f"{extract_s:.6f} s for {len(pairs)} pairs; peak device memory "
          f"{peak} bytes", flush=True)

    # per-layer device times of one sweep (CUDA events)
    _, strip, ns = bitmul.resolve_schedule(n_pad, 512)
    unpack_ms = cuda_ms(lambda: bitmul.unpack_words_to_int8(words), reps=3)
    bits = bitmul.unpack_words_to_int8(words)
    gemm_ms = k1_ms = 0.0
    for si in range(ns):
        i0 = si * strip
        a, b = bits[i0 : i0 + strip], bits[i0:]
        gemm_ms += cuda_ms(lambda: bitmul.int8_gemm(a, b), reps=3)
        counts = bitmul.int8_gemm(a, b)
        kw = dict(i_off=i0, j_off=i0, n=n, threshold=THRESHOLD, tile=512)
        k1_ms += cuda_ms(lambda: stats.stats_from_counts(
            counts, classes[i0 : i0 + strip], classes[i0:], **kw))
    macs = sum(strip * (n_pad - si * strip) for si in range(ns)) * bits.shape[1]
    print(f"sweep layers (device ms): unpack {unpack_ms:.4f}, int8 GEMM "
          f"{gemm_ms:.4f} ({2 * macs / gemm_ms / 1e9:.1f} TOP/s), K1 "
          f"epilogue {k1_ms:.4f} over {ns} strips", flush=True)

    # the extraction's share spent in its recompute products (one per
    # run of adjacent hit tiles in a tile row)
    ti, tj, tile = tiles
    hit = np.nonzero(th[:, 0] > 0)[0]
    runs = [(int(a) * tile, int(b) * tile, int(k) * tile)
            for a, b, k in _tile_runs(ti[hit], tj[hit])]

    def hit_run_gemms():
        for i0, j0, width in runs:
            bitmul.int8_gemm(bits[i0 : i0 + tile], bits[j0 : j0 + width])

    xg_ms = cuda_ms(hit_run_gemms, reps=1, warmup=1)
    print(f"extraction layers (device ms): {len(runs)} products over "
          f"{len(hit)} hit tiles {xg_ms:.4f} of the {extract_s * 1e3:.4f} "
          f"ms warm extraction", flush=True)

    # K1 against its plain version on strip 0 of the corpus
    counts = bitmul.int8_gemm(bits[:strip], bits)
    kw = dict(i_off=0, j_off=0, n=n, threshold=THRESHOLD, tile=512)
    crow, ccol = classes[:strip], classes
    rs_k, th_k, _ = stats.stats_from_counts(counts, crow, ccol, **kw)
    rs_p, th_p, _ = stats.stats_from_counts_reference(counts, crow, ccol, **kw)
    err = max(max_abs_err(rs_k, rs_p), max_abs_err(th_k, th_p))
    if err > TOL:
        raise AssertionError("K1 disagrees with its plain version on strip 0")
    plain_a = cuda_ms(lambda: stats.stats_from_counts_reference(
        counts, crow, ccol, **kw))
    k1_a = cuda_ms(lambda: stats.stats_from_counts(counts, crow, ccol, **kw))
    k1_b = cuda_ms(lambda: stats.stats_from_counts(counts, crow, ccol, **kw))
    plain_b = cuda_ms(lambda: stats.stats_from_counts_reference(
        counts, crow, ccol, **kw))
    k1_ms0, plain_ms0 = min(k1_a, k1_b), min(plain_a, plain_b)
    print(f"K1 on strip 0 counts[{strip}, {n_pad}] ({counts.numel() * 4} "
          f"bytes): kernel {k1_ms0:.4f} ms ({k1_a:.4f}, {k1_b:.4f}), plain "
          f"torch {plain_ms0:.4f} ms ({plain_a:.4f}, {plain_b:.4f}); "
          f"max_abs_err {err}", flush=True)
    return dict(sweep_s=sweep_s, extract_s=extract_s, peak=peak,
                k1_ms=k1_ms0, plain_ms=plain_ms0, err=err)


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, PKG)):
        print(f"chip_smoke.py must run from a checkout holding {PKG}/",
              file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("no CUDA GPU visible to torch", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda", 0)

    from uniprot_kmer_based_clustering_tpu_torch.ops import _build, stats

    t0 = time.perf_counter()
    _build.load_kernels()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.3f} s: "
          f"{os.path.relpath(_build.library_path(), ROOT)}", flush=True)
    with open(_build.library_path() + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip(), flush=True)

    err = kernel_phase(dev, stats)
    tmp = tempfile.mkdtemp(prefix="ukc_chip_smoke_")
    try:
        res, run_stats, launches = pipeline_phase(dev, tmp, stats)
        print("cli run stage seconds: " + json.dumps(run_stats["timings_s"]),
              flush=True)
        t = timing_phase(dev, res, stats)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if "jax" in sys.modules:
        raise AssertionError("the port's main path imported jax")

    kernels = [{
        "name": "stats_from_counts",
        "route": "cuda",
        "source": f"{PKG}/csrc/stats_epilogue.cu",
        "replaces": "uniprot_kmer_based_clustering_tpu/ops/stats_pallas.py:275",
        "launches": launches,
        "max_abs_err": max(err, t["err"]),
        "ms": t["k1_ms"],
        "plain_ms": t["plain_ms"],
    }]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
