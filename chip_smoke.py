#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Builds the port's CUDA kernels from ``uniprot_kmer_based_clustering_tpu_torch/
csrc`` with nvcc (one process per source, in parallel), then:

1. kernel phase — K1 against its plain PyTorch version on the card at the
   strip shapes of the 10,619-protein path; exact equality;
2. pipeline phase — the port's ``cli run --device cuda`` on synthetic
   corpora (``benches.common.synth_proteins``, the repository's
   ``bench_scale.synth_proteins``, seed 0), each run with every
   kernel launch counter reset just before it and read just after; the
   pair list and the four parity counters must equal an independent
   scipy ``B·Bᵀ`` oracle (taken in row chunks) exactly:
   a. 10,619 proteins, default engine (strip schedule, K1 once a strip);
   b. the same corpus with ``--engine popcount`` (K4 once);
   c. 30,000 proteins (9 strips → block-pair scan, K2 once a step) with
      ``--extract two_pass`` and with ``--extract fused``;
   then K4 against its plain version on the first two tile rows of the
   10,619 corpus and against the MXU sweep's statistics on all of it, and
   K2 against its plain version on a diagonal and an off-diagonal
   3,584² block of the 30k corpus, unweighted and weighted;
3. timing phase — warm sweeps and extractions of both corpora, per-layer
   and per-kernel times against the plain versions, peak device memory;
   K1's survivor append on every strip of the 10,619 corpus against its
   plain version, exactly (the stored (i, j, count) triples and the
   cursor, with room for every survivor and in the main path's
   65,536 slots), and the extraction of what it appended beside pass 2;
   K1 (strip 0, with and without the append) and K2 (the (0, 3584)
   block) kernel-only with L2 cold beside back-to-back calls and their
   needed-bytes bound, and the epilogue of one sweep: what the strip
   sweep launches on its 7 strips (K1 with the append, and without it as
   the ring launches it) and the scan on its 45 steps, summed;
4. stream phase — the out-of-core stream engine at 30,000 proteins:
   ``cli run --engine stream`` (two-pass) and ``cli run --engine stream
   --stream-source csr`` (packless, one-pass), each against the scipy
   oracle with K2 launched once a stream step and no other kernel; then,
   through the library entries on the host state, the warm stream sweep
   beside the in-core scan, the fused mode, the grouped extractor, one
   pass from both block sources, a sweep under a 2 GiB budget (the 3.67
   GB matrix cannot be resident: several stationary groups, peak device
   memory below the matrix's bytes) and a kill and resume of the one-pass
   sweep under that budget, each equal to the in-core scan's statistics
   and the oracle's pair list; K2 against its plain version on one
   stream-step block; upload, dispatch, drain and fetch seconds, the
   bytes uploaded and the host→device rates;
5. query phase — query serving (``similarity.query.QueryServer``) on the
   10,619 corpus, every kernel counter reset before it and 0 after it:
   all corpus sequences as self-queries on a resident device server in
   batches of 256, whose i<j cross-class matches must equal the scipy
   oracle's pairs and whose self matches the rows' popcounts; device
   answers equal to the host rank-CSR walk's at batches of 1, 16, 64 and
   256 (unweighted and BLOSUM62; caps 512, 1 and 0) and for batches in
   flight through ``query_async``/``query_wait``; ``cli query --device
   cuda`` with ``--seq`` and ``--query-fasta``, its TSV equal to the host
   server's; stream serving on the 30k corpus from the host and the csr
   block source, at the default block and at 4,096 rows (8 blocks), equal
   to a resident server; queries/s by batch, single-query latency with
   and without the latency route, pipelined queries/s, one batch's device
   times by layer, peak device memory (the resident server must hold one
   corpus copy and a few unpacked chunks), stream seconds and GB
   uploaded a batch;
6. index phase — ``cli run --index-engine device`` on the 10,619 corpus
   against the scipy oracle, and the device index and bitset equal to
   the host build at k 5 and 7 (no kernel launched by the build), the
   device index stage's seconds beside the host encode + index + pack;
7. K3 phase — the fused triangle sweep through its library entry
   ``ops.tri_mxu.sweep_tri_mxu`` (counters reset before each call and
   read after it: K3 once): at 10,619 proteins int8 and bf16, unweighted
   and BLOSUM-weighted (the bf16 guard's verdict printed; a refusal must
   raise), each equal to its plain version (``sweep_mxu`` with the plain
   epilogue) and to ``sweep_mxu`` with K1; at
   30,000 proteins int8 equal to the scan sweep; device times beside
   their bound and share, the plain version, ``sweep_mxu`` and a
   products-only yardstick (``torch._int_mm`` over the triangle's tile
   rows on operands unpacked beforehand, never called by the port); peak
   device memory.
8. post-processing phase — on the corpora above and
   ``synth_proteins(2000, seed=0)``, every `cli run` with the counters
   reset before it (K1 once a strip, no other kernel) and every library
   step required to launch none:
   a. ``connected_components_device`` on the card over the 10,619 and
      30k oracle pairs, equal to the host union-find (seconds, rounds);
   b. ``cli run --cluster agglomerative`` at 10,619 and 2,000 proteins:
      clusters.tsv and dendrogram.tsv equal to
      ``agglomerative_cluster_device`` and to the strip mode (forced by a
      budget below the one-shot plan) on the card, and at 2,000 to an
      independent scipy-sparse transcription of the rounds; one round's
      device ms by layer, rounds, merges, seconds and peak memory;
   c. ``cli run --cluster tree`` at 2,000 proteins equal to the tree on
      its numpy path;
   d. T, the smallest threshold leaving at most 500 oracle pairs at
      10,619: ``cli run --threshold T --align sw``, ``auto`` and
      ``diamond`` (no diamond on PATH: the sw fallback) byte-equal to
      ``align_pairs_sw(device_scores=False)``; ``sw_scores_device`` equal
      to ``sw_align_host`` on every pair; device and host seconds;
   e. ``cli run --threshold T --dump-kmers --dump-proteins --dump-debug``
      with the host index and with ``--index-engine device``: the three
      files equal to each other and to the dump functions on the
      oracle's pairs.
9. mesh phase — the flat row ring (``parallel/``) on meshes whose D
   shards all sit on this one card (``make_mesh(devices=[dev] * D)``;
   their launches share one stream, so a ring's time is the sum over its
   shards, not a scaling figure):
   a. ``run_pipeline(mesh=D4)`` at 30,000 proteins with the default
      extraction (K1 appends on every sub-step; at 30,000 the survivors
      pass a card's slots, so the second pass runs) and with
      ``extract="fused"``, counters reset before each: K1 once a ring
      sub-step (``parallel.count_substeps``) and no other kernel; pairs
      and parity counters equal to the oracle, component labels equal to
      the host union-find's, stage seconds, peak device memory under
      two corpus copies plus one sub-step's working set;
   b. the warm ring sweep (beside the in-core scan), extraction and
      fused pass on staged shards, with their peaks and the counters
      reset before and read after every call (K1 once a sub-step of the
      sweep and the fused pass, none in the extraction); then the
      packless staging (``stage_mesh_inputs_csr``: shards built on the
      card from the incidence lists) equal to the packed shards, and its
      sweep and extraction equal to the oracle;
   c. K1 on a wrapped block pair and a diagonal strip of that ring at
      its fake offsets, equal to its plain version and to the plain
      statistics at the real indices; kernel-only time beside its bound;
   d. 10,619 proteins at D = 1, 2, 3 and 8: the sweep's totals equal to
      D = 1's and to ``sweep_mxu``'s (its rows too at D = 1), extraction
      and the fused pass equal to the oracle, ``doc_freq_psum`` equal to
      the host doc-freqs;
   e. K1's survivor append as ``extract="auto"``'s sweep launches it, on
      the 10,619 D = 4 ring's diagonal strip, plain block pair and
      wrapped block pair (fake offsets, stored from the
      sub-step's pair origin, transposed where wrapped), with room for
      every survivor: stored triples, cursor and untouched slots equal
      to ``ops.stats.append_survivors_reference``, every pair (min, max)
      and in the oracle's list with its count, row stats and tile hits
      equal to K1 without the append; kernel-only and back-to-back times
      beside K1 without the append, and the needed-bytes bound with 12 B
      a survivor;
   f. ``run_pipeline`` at 2,000 proteins (36,380 survivors, within one
      card's ``EPILOGUE_PAIR_CAP`` slots) on flat D = 4, 2 × 2 and k
      axis D = 4 with the default extraction: pairs and parity counters
      equal to the oracle, K1 once a sub-step or strip and no other
      kernel, and ``parallel.sharded.last_trace`` showing no second pass
      and ``epilogue_pairs`` = ``pairs``;
   g. ``cli run --devices <cards + 1>`` must exit nonzero with JAX's
      "requested N devices, only M available" and write nothing; with
      more than one card visible, the 10,619 ring also runs on two
      distinct cards.
10. layouts phase — the 2-D (hosts × chips) ring and the k-axis layout
   (``parallel/``), again on meshes whose shards share this one card
   (``make_mesh_2d(H, C, devices=[dev] * H·C)``, ``make_mesh(devices=
   [dev] * D, axis="k")``):
   a. ``run_pipeline`` at 30,000 proteins on 2 × 2 and on a D = 4 k
      mesh, auto (as in phase 9) and fused, counters reset before each:
      K1 once a 2-D sub-step (``parallel.count_substeps_2d``) or k-axis strip
      (``parallel.count_kaxis_strips``) and no other kernel; pairs and
      parity counters equal to the oracle, labels to the union-find's,
      stage seconds, peak device memory under each layout's gate;
   b. the warm sweep, extraction and fused pass of each layout on staged
      inputs (counters reset before, read after, every call) beside
      phase 9's flat ring and the scan; the packless
      ``stage_mesh_inputs_csr`` of each equal to the packed staging, its
      sweep and extraction equal to the oracle;
   c. K1 on a 2-D wrapped block pair (a 3 × 2 mesh, fake offsets) and on
      a k-axis strip (real offsets) equal to its plain version and to
      the plain statistics at the real indices; kernel-only time beside
      its bound;
   d. 10,619 proteins on 2-D 1 × 2, 2 × 1, 2 × 3, 3 × 2, 2 × 4 (every
      branch of the 2-D schedule) and k-axis D = 1, 2, 3, 8: totals
      equal to ``sweep_mxu``'s (k axis: its rows too), extraction and
      the fused pass equal to the oracle, K1 = the schedule's count;
   e. ``cli run --shard-axis kmers`` (one card: a one-device k mesh) and
      ``--mesh-shape 1x1`` at 10,619 against the oracle with K1 counted;
      ``--mesh-shape 2x2`` and ``--devices 2 --shard-axis kmers`` (past
      the visible cards) must exit nonzero with JAX's message and write
      nothing; with more than one card visible, both layouts also run
      the 10,619 corpus on two distinct cards.
11. stream-mesh phase — the out-of-core sweep on a flat mesh
   (``parallel.stream_mesh.sweep_extract_stream_mesh``) and row-sharded
   serving (``QueryServer(mesh=...)``), every mesh's shards on this one
   card (``make_mesh(devices=[dev] * D)``), the kernel counters set to 0
   before and read after every call:
   a. 30,000 proteins from the CSR source on D = 4 shards, (i) under the
      default 13 GiB a shard at bs 2,048 (one group of 16 blocks, a
      cooperative stack of 4 a shard; a first call and a warm one) and
      (ii) under ``STREAM_SMALL_BUDGET`` a shard (bs 1,024, groups of one
      block, the stack at its floor of D blocks): pairs and parity
      counters equal to the oracle, row_stats, tile hits and pairs equal
      to the single-device ``sweep_extract_stream`` at the same bs, K2
      once a step summed over the shards (the trace's ``steps``) and no
      other kernel, the partition's balance, stage / dispatch / drain /
      fetch seconds beside the single-device pass, phase 4's one pass
      and the in-core scan; peak device memory under D × (the budget a
      shard + a shard's staging) + (D − g) stream blocks where g < D
      (staging: the per-block incidence split, rows and ranks int32 and
      a valid byte a lane, and the classes); a kill after 2 groups under
      (ii) resumed exactly on the mesh, and a single-device kill resumed
      on the mesh with (bs, g) aligned through ``max_group``; a cap of
      2^16 pairs a shard forcing the capacity-miss redo, equal to the
      oracle;
   b. ``run_pipeline(engine="stream", stream_source="csr",
      extract="onepass", mesh=D4)`` at 30,000: pairs, parity counters
      and labels equal to the oracle and the union-find, K2 once a step;
   c. 10,619 proteins at D = 1, 2, 3 and 8 equal to the oracle;
   d. ``cli run --devices <cards + 1> --engine stream --stream-source
      csr --extract onepass`` must exit nonzero with JAX's "requested N
      devices, only M available" and write nothing; with more than one
      card visible it runs ``--devices 2`` on two distinct cards against
      the oracle;
   e. ``QueryServer(mesh=D4)`` on the 10,619 corpus: answers equal to the
      single-device server's at batches 1, 64 and 256, the self-queries'
      cross-class i<j pairs equal to the oracle, queries/s of both at
      each batch, peak memory over the build and one batch under one
      corpus + four unpacked 4,096-column chunks a shard, and none of
      K1–K4 launched.
12. distributed phase — the multi-process mesh (``cli run
   --distributed``, ``parallel.init_distributed``): worker processes of
   this script (``--dist-worker``), started with the torchrun environment
   and killed after ``DIST_TIMEOUT``, each printing one ``DIST`` JSON
   line (pairs and labels digests, parity counters, its launches,
   seconds and transport bytes); the launch counters and the transport
   counters are set to 0 in every rank just before its main path and
   read just after:
   a. NCCL, one rank: ``cli run --distributed`` at 30,000 proteins;
      pairs.tsv and clusters.tsv byte-equal to phase 2's single-device
      run; one NCCL ``all_reduce``;
   b. gloo, 4 ranks sharing the card: ``cli run --distributed --device
      cuda:0`` at 30,000 (flat ring, D = 4): K1 summed over the ranks =
      ``count_substeps`` (38), rank 0's files = (a)'s, ranks 1–3 write
      nothing;
   c. gloo, 2 ranks × 2 local shards: ``run_pipeline`` at 30,000 on
      ``make_mesh_2d(2, 2, devices=[card] * 2)``, the host axis across
      the ranks: K1 summed = ``count_substeps_2d`` (38);
   d. gloo, 4 ranks: ``--engine stream --stream-source csr --extract
      onepass`` at 30,000: K2 summed = phase 11's pipeline steps (36);
      then the library's kill after 2 of 4 groups and a resume from rank
      0's snapshot, read by every rank;
   e. gloo, 4 ranks: ``--shard-axis kmers`` at 10,619: K1 summed =
      ``count_kaxis_strips``; files equal to the oracle and the
      union-find; beside it one process's D = 4 k mesh;
   every rank's pairs, parity counters and labels equal the oracle and
   the union-find; per case the wall seconds, the slowest rank's sweep
   stage, the transport's bytes and seconds, and the one-process mesh's
   seconds beside them. The cases run in the waves of ``DIST_WAVES``,
   (a, d) and then (b, c, e), each wave's ranks all at once. The ranks
   share one card, so no time is a scaling figure, and NCCL with more
   than one rank does not run here.
13. benches phase — the port's three benches, each a subprocess on the
   card (killed after ``BENCH_TIMEOUT``) whose last line is its JSON
   result, printed here; the eight subprocesses of phases 13 and 14 run
   ``BENCH_PARALLEL`` (4) at a time, so each one's figures are taken
   beside the others' and only its gates are compared with earlier
   runs: ``cli bench`` (the headline, 10,619 synthetic
   proteins) must report the scipy oracle's counters of phase 2a and K1
   launched once a strip (7) by a warm sweep, K2 not at all;
   ``benches.engines`` at 10,619 must have every row exact (``value ==
   engines_total``, no row skipped but the C++ engine where it is not
   built); ``benches.scale`` at 30,000 with its default stages must pass
   its oracle gate, report phase 2c's pairs over threshold and cross
   pairs, and K2 once a scan step (45) by a warm sweep, K1 not at all.
   Each must exit 0 with no ``error``.
14. more benches phase — the port's query, cluster and pod benches, each
   a subprocess as in phase 13 with only the knobs named here:
   a. ``benches.query`` on the 10,619 corpus with ``UKC_QUERY_STREAM=1``:
      host-exact parity, queries/s above 0 on the card, no launch of
      K1–K4, the stream point host-exact and the CPU mesh probe without
      an error;
   b. ``benches.cluster`` with components at 30,000, agglomerative at
      10,619 and the tree at 5,000: phase 2's 30k pair count, the
      clusters and largest component of phase 9's 30k labels, K2 once a
      scan step (45) and no K1, phase 8's agglomerative rounds, merges
      and clusters at 10,619, the 2,000-protein scipy reference gate and
      the tree's gate;
   c. ``benches.pod`` at 10,619 three times: the flat ring on one card
      (``UKC_POD_DEVICES=1``), the 2-D ring on ``UKC_POD_MESH=1x1`` and
      under ``UKC_POD_DISTRIBUTED=1`` as one NCCL rank: each with phase
      2's oracle counters, pair count and largest score, K1 7
      (``parallel.count_substeps``) and no K2 a warm sweep, on one
      device; the line carries ``scaling_efficiency`` (1.0 by
      construction at D = 1, so that check is of the field alone).
15. dry-run phase — ``dryrun.entry()`` (the one-strip step, K2 once)
   on the card against its plain version on the same inputs, exact; then
   ``dryrun.dryrun_multichip(4)`` (every mesh composition, each held to
   the flat ring or the single-device engine) on four distinct cards
   where four are visible, else on four shards of the one card, with the
   launch counters set to 0 just before and read just after: the root
   dry run's figures (stats sum 622,733, 36,690 pairs, ...) and K1 and K2
   launched; its line, launches, distinct cards and seconds are printed.

Prints the card's name, power limit and maximum SM clock (nvidia-smi), a
JSON line describing each kernel (``ms``: one launch with L2 cold,
``call_ms``: back-to-back calls, beside its bound: the larger of its
bytes over the HBM rate and its operations over the card's peak for
their type), and as the last line ``{"ok": true, "device": {...}}``.
Exits nonzero, printing no result, when no CUDA GPU is visible, when run
outside a checkout, or when any phase fails. Imports nothing of JAX or
of the JAX package, and checks at the end that neither was loaded.
Every process the run starts carries ``UKC_CHIP_SMOKE_RUN`` in its
environment; whether the run passes or fails, it ends by stopping
multiprocessing's resource tracker (started by phase 8's spawn pool, it
would outlive the script for a moment) and any such process still alive.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "uniprot_kmer_based_clustering_tpu_torch"
N_PROTEINS = 10619
N_SCALE = 30000  # the JAX package's scale point (bench_scale.py)
THRESHOLD = 10
TOL = 0  # integer statistics: kernel and plain version must agree exactly
# the H100 SXM's published HBM rate in bytes/s; dense tensor-core
# operations a clock on each SM by operand type (a multiply-add counts 2),
# and __popc issues a clock on each SM. Operation peaks are worked out
# from the SM clock that nvidia-smi reads, so every operation bound of
# one run rests on the same clock.
HBM_BYTES_S = 3.35e12
TC_OPS_PER_CLOCK_SM = {"int8": 8192, "bfloat16": 4096}
SPEC_PEAK_OPS_S = {"int8": 1979e12, "bfloat16": 989e12}  # spec sheet, dense
POPC_PER_CLOCK_SM = 16
# the stream phase's small budget: less than the 30k corpus's packed
# matrix (3.67 GB), so the matrix cannot be resident
STREAM_SMALL_BUDGET = 2 << 30


def nvidia_smi_line(fields: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bytes_bound_ms(*tensors) -> float:
    """Least time to read or write each tensor once at the HBM rate."""
    return sum(t.numel() * t.element_size() for t in tensors) / HBM_BYTES_S * 1e3


def tc_peak_ops_s(dot: str, sm_mhz: float) -> float:
    """The tensor cores' dense peak for `dot` operands at `sm_mhz`."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * TC_OPS_PER_CLOCK_SM[dot] * sm_mhz * 1e6


def tri_bound_ms(n: int, k_bits: int, dot: str, sm_mhz: float) -> float:
    """Least time for the products of every pair gi < gj < n over k_bits
    columns: 2 operations a multiply-add at the tensor cores' peak."""
    return n * (n - 1) * k_bits / tc_peak_ops_s(dot, sm_mhz) * 1e3


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


L2_FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2


def kernel_only_ms(launch, reps: int = 50, prepare=None,
                   flush: str = "read") -> float:
    """Median device time of one launch() with L2 cold. Before each
    launch and outside the timed window: ``prepare()`` (if given), an L2
    flush, and a ~0.1 ms device sleep so that the host has enqueued the
    launch before the first event fires; CUDA events bracket the launch
    alone. The flush reads a 256 MB scratch tensor written once (``read``,
    the default), or writes it (``write``): that leaves L2 full of dirty
    lines, whose write-back the timed launch then pays for."""
    import torch

    scratch = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                         device="cuda")
    launch()
    pairs = []
    for _ in range(reps):
        if prepare is not None:
            prepare()
        if flush == "read":
            scratch.max()
        else:
            scratch.fill_(1)
        torch.cuda._sleep(200_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        launch()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    times = sorted(e0.elapsed_time(e1) for e0, e1 in pairs)
    return times[len(times) // 2]


def needed_pairs(s: int, j: int, i_off: int, j_off: int, n: int) -> int:
    """Counts of an [s, j] block at (i_off, j_off) with gi < gj < n: the
    only elements the statistics epilogue has to read."""
    import numpy as np

    lo = np.maximum(i_off + np.arange(s, dtype=np.int64) + 1, j_off)
    return int(np.clip(min(n, j_off + j) - lo, 0, None).sum())


def epilogue_bound_ms(s: int, j: int, i_off: int, j_off: int, n: int,
                      out_ints: int) -> float:
    """Needed-bytes bound of the epilogue on one block: each needed count,
    the block's row and column classes and ``out_ints`` output int32s
    (row stats and tile hits), once each, at the HBM rate."""
    ints = needed_pairs(s, j, i_off, j_off, n) + s + j + out_ints
    return 4 * ints / HBM_BYTES_S * 1e3


def epilogue_times(into, public, plain, bound: float) -> dict:
    """One statistics epilogue entry on one block, in turns: the plain
    version, the accumulate-into entry kernel-only (L2 cold) and in
    back-to-back calls (what a sweep pays a strip or step), the public
    wrapper (fresh outputs), and again in reverse order."""
    plain_a, ko_a, call_a = cuda_ms(plain), kernel_only_ms(into), cuda_ms(into)
    public_ms = cuda_ms(public)
    call_b, ko_b, plain_b = cuda_ms(into), kernel_only_ms(into), cuda_ms(plain)
    return dict(ms=min(ko_a, ko_b), ms_ab=(ko_a, ko_b),
                call_ms=min(call_a, call_b), call_ab=(call_a, call_b),
                public_ms=public_ms, plain_ms=min(plain_a, plain_b),
                plain_ab=(plain_a, plain_b), bound_ms=bound)


def epilogue_line(t: dict) -> str:
    return (f"kernel-only {t['ms']:.4f} ms ({t['ms_ab'][0]:.4f}, "
            f"{t['ms_ab'][1]:.4f}; L2 cold), bound {t['bound_ms']:.4f} ms "
            f"(needed bytes), share {t['bound_ms'] / t['ms']:.3f}; "
            f"back-to-back calls: accumulate-into entry {t['call_ms']:.4f} ms "
            f"({t['call_ab'][0]:.4f}, {t['call_ab'][1]:.4f}), public wrapper "
            f"{t['public_ms']:.4f} ms; plain torch {t['plain_ms']:.4f} ms "
            f"({t['plain_ab'][0]:.4f}, {t['plain_ab'][1]:.4f})")


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


def write_fasta(path: str, n: int) -> None:
    """The synthetic corpus of n proteins, with headers in the
    reference's format ``>ID|FEATURES|UNIPROT|<class>|gene`` so the class
    parses."""
    for k in [k for k in os.environ if k.startswith("UKC_SCALE_")]:
        del os.environ[k]
    from uniprot_kmer_based_clustering_tpu_torch.benches.common import (
        synth_proteins,
    )

    seq_buf, offsets, classes = synth_proteins(n, seed=0)
    with open(path, "w") as f:
        for i in range(n):
            seq = seq_buf[offsets[i] : offsets[i + 1]].tobytes().decode()
            f.write(f">SYN{i:06d}|FEATURES|UNIPROT|class{classes[i]}|"
                    f"gene{i}\n{seq}\n")


def read_pairs_tsv(path: str):
    import numpy as np

    with open(path) as f:
        next(f)
        rows = [line.split("\t") for line in f]
    return np.array(
        [(int(r[0]), int(r[1]), int(r[6])) for r in rows], dtype=np.int64
    ).reshape(-1, 3)


def kernel_counters():
    """The launch counter of each kernel wrapper, by kernel id."""
    from uniprot_kmer_based_clustering_tpu_torch.ops import (
        popcount,
        stats,
        tri_mxu,
    )

    return {"K1": stats.stats_from_counts_into,
            "K2": stats.stats_from_counts_traced_into,
            "K3": tri_mxu.tri_mxu_sweep,
            "K4": popcount.popcount_sweep}


def reset_counters():
    """Set every kernel's launch counter to 0; returns the wrappers."""
    fns = kernel_counters()
    for fn in fns.values():
        fn.launches = 0
    return fns


def host_state(fasta: str):
    """The port pipeline's host stages (ingest, encode, index, pack) with
    its default config: (table, index, bitset)."""
    from uniprot_kmer_based_clustering_tpu_torch import PipelineConfig
    from uniprot_kmer_based_clustering_tpu_torch import pipeline as pl

    cfg = PipelineConfig()
    table = pl.read_fasta(fasta)
    codes, koff = pl.encode_kmers(table.seq_buf, table.offsets, cfg.k)
    index = pl.build_index(codes, koff, cfg.k)
    bitset = pl.pack_bitsets(
        index.incidence_protein, index.incidence_rank, table.n,
        index.n_repeated, row_multiple=pl._row_multiple(cfg, table.n),
    )
    return table, index, bitset


def oracle(state, label: str):
    table, index, _ = state
    t0 = time.perf_counter()
    from uniprot_kmer_based_clustering_tpu_torch.benches.common import (
        index_oracle,
    )

    want, want_pairs = index_oracle(index, table.amr_class_ids, table.n)
    print(f"scipy oracle ({label}) {time.perf_counter() - t0:.3f} s: "
          f"{want}", flush=True)
    return want, want_pairs


def cli_run(dev, fasta, out, flags, want, want_pairs, expect):
    """One `cli run --device cuda` of the main path: every launch counter
    is set to 0 just before it and read just after; each kernel must have
    launched exactly as ``expect`` says (a dict, or a function read after
    the run, for counts the run's own trace reports), and pairs.tsv and
    the parity counters must equal the oracle. Returns the launch
    counts; ``cli_run.last_s`` keeps the run's seconds (the CLI call
    alone)."""
    import numpy as np

    from uniprot_kmer_based_clustering_tpu_torch import cli

    fns = reset_counters()
    t0 = time.perf_counter()
    rc = cli.main(["run", fasta, "--out", out, "--device", dev.type, *flags])
    cli_s = cli_run.last_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in fns.items()}
    if rc != 0:
        raise AssertionError(f"cli run {flags} returned {rc}")
    if callable(expect):
        expect = expect()
    with open(os.path.join(out, "stats.json")) as f:
        run_stats = json.load(f)
    pairs = read_pairs_tsv(os.path.join(out, "pairs.tsv"))
    got = {k: run_stats["parity"][k] for k in want}
    name = " ".join(flags) or "(default flags)"
    print(f"cli run {name}: {cli_s:.3f} s; kernel launches {launches}; "
          f"parity {got}, pairs {len(pairs)}; stage seconds "
          f"{json.dumps(run_stats['timings_s'])}", flush=True)
    if launches != expect:
        raise AssertionError(
            f"cli run {name}: kernel launches {launches}, expected {expect}"
        )
    if got != want:
        raise AssertionError(f"parity counters {got} != oracle {want}")
    if not np.array_equal(pairs, want_pairs):
        raise AssertionError(f"pairs.tsv of {name} differs from the oracle")
    return launches


def pipeline_phase(dev, tmp):
    """The main paths on the card, each against the scipy oracle: the
    10,619-protein corpus on the default engine (strips, K1) and on
    --engine popcount (K4); the 30,000-protein corpus on the scan (K2)
    with two-pass and with fused extraction."""
    from uniprot_kmer_based_clustering_tpu_torch.ops.bitmul import (
        resolve_schedule,
    )

    fasta10 = os.path.join(tmp, "synth10619.fasta")
    fasta30 = os.path.join(tmp, "synth30000.fasta")
    t0 = time.perf_counter()
    write_fasta(fasta10, N_PROTEINS)
    write_fasta(fasta30, N_SCALE)
    print(f"corpora: {N_PROTEINS} and {N_SCALE} proteins written in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    out = os.path.join(tmp, "out")

    state10 = host_state(fasta10)
    n_pad = state10[2].n_pad
    sched, strip, ns = resolve_schedule(n_pad, 512)
    print(f"{N_PROTEINS}: N_pad {n_pad} x W_pad {state10[2].w_pad}; "
          f"resolve_schedule -> {sched}, strip {strip}, {ns} strips",
          flush=True)
    want10, pairs10 = oracle(state10, f"{N_PROTEINS}")
    expected = {"edges_after_amr_filter": 74753766,
                "pairs_after_merge": 2075330,
                "pairs_over_threshold": 491781, "max_shared_kmers": 275}
    print(f"oracle equals the documented corpus counters: "
          f"{want10 == expected}", flush=True)
    launches = {}
    ns10 = ns
    launches["K1"] = cli_run(dev, fasta10, out, [], want10, pairs10,
                             {"K1": ns, "K2": 0, "K3": 0, "K4": 0})["K1"]
    launches["K4"] = cli_run(dev, fasta10, out, ["--engine", "popcount"],
                             want10, pairs10,
                             {"K1": 0, "K2": 0, "K3": 0, "K4": 1})["K4"]

    state30 = host_state(fasta30)
    n_pad = state30[2].n_pad
    sched, strip, ns = resolve_schedule(n_pad, 512)
    steps = ns * (ns + 1) // 2
    print(f"{N_SCALE}: N_pad {n_pad} x W_pad {state30[2].w_pad}, "
          f"repeated k-mers {state30[1].n_repeated}; resolve_schedule -> "
          f"{sched}, strip {strip}, {ns} strips, {steps} block-pair steps",
          flush=True)
    if sched != "scan":
        raise AssertionError(f"{N_SCALE} proteins resolved to {sched}")
    want30, pairs30 = oracle(state30, f"{N_SCALE}")
    cli30_s = {}
    for extract in ("two_pass", "fused"):
        got = cli_run(dev, fasta30, out, ["--extract", extract], want30,
                      pairs30, {"K1": 0, "K2": steps, "K3": 0, "K4": 0})
        cli30_s[extract] = cli_run.last_s
        launches["K2"] = got["K2"]
    # the single-device files that phase 12's distributed run must equal
    single30 = os.path.join(tmp, "single30")
    os.makedirs(single30)
    for f in ("pairs.tsv", "clusters.tsv"):
        shutil.copy(os.path.join(out, f), single30)
    return (state10, pairs10, state30, pairs30, launches,
            dict(fasta=fasta30, fasta10=fasta10, out=out, want=want30,
                 want10=want10, ns10=ns10, single30=single30,
                 cli30_s=cli30_s["two_pass"]))


def popc_bound_ms(pairs: int, words: int, sm_mhz: float) -> float:
    """Least time for one __popc a word of every pair, at 16 a clock on
    each SM at the card's maximum SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return pairs * words / (POPC_PER_CLOCK_SM * sms * sm_mhz * 1e6) * 1e3


def k4_phase(dev, state, sm_mhz):
    """K4 against its plain version on the first two tile rows of the
    10,619 corpus, and its whole-corpus statistics against the MXU
    sweep's (all 8 row lanes; the over-threshold tile hits); times beside
    the __popc issue bound of the words the bits need."""
    import numpy as np
    import torch

    from uniprot_kmer_based_clustering_tpu_torch.ops import bitmul, popcount
    from uniprot_kmer_based_clustering_tpu_torch.state import (
        bitset_to_torch,
        classes_to_torch,
    )

    table, _, bitset = state
    n, n_pad = table.n, bitset.n_pad
    words = bitset_to_torch(bitset, dev)
    classes = classes_to_torch(table.amr_class_ids, n_pad, dev)
    ti, tj = popcount.upper_triangle_tiles(n_pad, 512)
    sub = (ti[ti < 2], tj[ti < 2])
    args = (words, classes, n, THRESHOLD, 512)
    rs_k, th_k, _ = popcount.popcount_sweep(*args, tiles=sub)
    t0 = time.perf_counter()
    rs_p, th_p, _ = popcount.sweep_reference(*args, tiles=sub)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = max(max_abs_err(rs_k, rs_p), max_abs_err(th_k, th_p))
    print(f"kernel K4 on tile rows 0-1 ({len(sub[0])} tile pairs of 512 x "
          f"512 x {bitset.w_pad} words): max_abs_err {err} (tolerance "
          f"{TOL}), over-threshold hits {int(th_k[:, 0].sum())}; plain "
          f"version {plain_s:.3f} s", flush=True)
    if err > TOL:
        raise AssertionError("K4 disagrees with its plain version")

    rs_f, th_f, _ = popcount.popcount_sweep(*args)
    rs_m, th_m, _ = bitmul.sweep_mxu(words, classes, n, THRESHOLD)
    torch.cuda.synchronize()
    err_m = max(
        int(np.abs(rs_f.cpu().numpy().astype(np.int64) - rs_m).max()),
        int(np.abs(th_f[:, :2].cpu().numpy() - th_m).max()),
    )
    print(f"kernel K4 whole corpus vs the MXU sweep (row_stats, 8 lanes; "
          f"tile_hits[:, :2]): max_abs_err {err_m}", flush=True)
    if err_m > TOL:
        raise AssertionError("K4 disagrees with the MXU sweep")

    k4_a = cuda_ms(lambda: popcount.popcount_sweep(*args, tiles=sub),
                   reps=5, warmup=1)
    k4_b = cuda_ms(lambda: popcount.popcount_sweep(*args, tiles=sub),
                   reps=5, warmup=1)
    plain_ms = cuda_ms(lambda: popcount.sweep_reference(*args, tiles=sub),
                       reps=1, warmup=0)
    full_ms = cuda_ms(lambda: popcount.popcount_sweep(*args), reps=3,
                      warmup=1)
    k4_ms = min(k4_a, k4_b)
    k4_only = kernel_only_ms(lambda: popcount.popcount_sweep(*args, tiles=sub),
                             reps=5)
    words_needed = -(-bitset.n_bits // 32)
    rows = min(2 * 512, n)
    pairs_sub = rows * (n - 1) - rows * (rows - 1) // 2  # gi < rows, gi < gj < n
    bound = popc_bound_ms(pairs_sub, words_needed, sm_mhz)
    bound_full = popc_bound_ms(n * (n - 1) // 2, words_needed, sm_mhz)
    print(f"K4 on tile rows 0-1: kernel {k4_ms:.4f} ms ({k4_a:.4f}, "
          f"{k4_b:.4f}), bound {bound:.4f} ms (operations: {pairs_sub} "
          f"pairs x {words_needed} words of __popc at {sm_mhz:.0f} MHz), "
          f"share {bound / k4_ms:.3f}; plain torch {plain_ms:.4f} ms; K4 "
          f"whole corpus ({len(ti)} tile pairs) {full_ms:.4f} ms, bound "
          f"{bound_full:.4f} ms, share {bound_full / full_ms:.3f}",
          flush=True)
    print(f"K4 on tile rows 0-1, one call with L2 cold (kernel-only "
          f"{k4_only:.4f} ms, share {bound / k4_only:.3f})", flush=True)
    return dict(err=max(err, err_m), ms=k4_only, call_ms=k4_ms,
                plain_ms=plain_ms, full_ms=full_ms, bound_ms=bound)


def k2_phase(dev, state):
    """K2 against its plain version on the diagonal block (0, 0) and the
    off-diagonal block (0, 3584) of the 30k corpus, unweighted and with
    signed weights (w_thresh 5)."""
    import numpy as np
    import torch

    from uniprot_kmer_based_clustering_tpu_torch.ops import bitmul, stats
    from uniprot_kmer_based_clustering_tpu_torch.state import (
        bitset_to_torch,
        classes_to_torch,
    )

    table, _, bitset = state
    n, n_pad, bs = table.n, bitset.n_pad, 3584
    words = bitset_to_torch(bitset, dev)
    classes = classes_to_torch(table.amr_class_ids, n_pad, dev)
    rng = np.random.default_rng(0)
    wts = torch.from_numpy(
        rng.integers(-30, 31, bitset.w_pad * 32).astype(np.int8)
    ).to(dev)
    worst = 0
    timed = None
    for i0, j0 in ((0, 0), (0, bs)):
        for weighted in (False, True):
            counts = bitmul.counts_window(words, wts if weighted else None,
                                          i0, j0, s=bs, jr=bs)
            kw = dict(n=n, threshold=100 if weighted else THRESHOLD,
                      w_thresh=5 if weighted else 1, tile=512)
            ca, cb = classes[i0 : i0 + bs], classes[j0 : j0 + bs]
            rs, bh = stats.stats_from_counts_traced(counts, ca, cb, i0, j0,
                                                    **kw)
            rs_p, bh_p = stats.stats_from_counts_traced_reference(
                counts, ca, cb, i0, j0, **kw)
            torch.cuda.synchronize()
            err = max(max_abs_err(rs, rs_p), max_abs_err(bh, bh_p))
            print(f"kernel K2 counts[{bs}, {bs}] at ({i0}, {j0}) "
                  f"{'weighted' if weighted else 'unweighted'} (min count "
                  f"{int(counts.min())}): max_abs_err {err} (tolerance "
                  f"{TOL}), block hits {int(bh.sum())}", flush=True)
            if err > TOL:
                raise AssertionError("K2 disagrees with its plain version")
            worst = max(worst, err)
            if (i0, j0, weighted) == (0, bs, False):
                timed = (counts, ca, cb, i0, j0, kw)
            else:
                del counts
    counts, ca, cb, i0, j0, kw = timed
    s = counts.shape[0]
    rs = torch.zeros((s, 8), dtype=torch.int32, device=dev)
    bh = torch.zeros((s // 512, s // 512, 2), dtype=torch.int32, device=dev)
    t = epilogue_times(
        lambda: stats.stats_from_counts_traced_into(counts, ca, cb, rs, bh,
                                                    i0, j0, **kw),
        lambda: stats.stats_from_counts_traced(counts, ca, cb, i0, j0, **kw),
        lambda: stats.stats_from_counts_traced_reference(counts, ca, cb, i0,
                                                         j0, **kw),
        epilogue_bound_ms(s, s, i0, j0, n, 8 * s + 2 * (s // 512) ** 2),
    )
    print(f"K2 on the ({i0}, {j0}) block [{s}, {s}] "
          f"({needed_pairs(s, s, i0, j0, n)} needed counts): "
          f"{epilogue_line(t)}", flush=True)
    return dict(err=worst, **t)


def stream_phase(dev, tmp, state, want_pairs, run30, scan_s):
    """The out-of-core stream engine at 30,000 proteins (see the module
    docstring, phase 4). ``run30`` carries the corpus's FASTA, the output
    directory and the oracle's counters; ``scan_s`` is the warm in-core
    scan sweep's seconds, printed beside the stream sweep's. Returns K2's
    launches on the stream path and its worst error against the plain
    version."""
    import numpy as np
    import torch

    from uniprot_kmer_based_clustering_tpu_torch.ops import (
        bitmul,
        stats,
        stream,
    )
    from uniprot_kmer_based_clustering_tpu_torch.state import (
        bitset_to_torch,
        classes_to_torch,
    )
    from uniprot_kmer_based_clustering_tpu_torch.utils.checkpoint import (
        CheckpointStore,
    )

    t_phase = time.perf_counter()
    table, index, bitset = state
    n, n_pad = table.n, bitset.n_pad
    words_host = bitset.words
    matrix_bytes = words_host.nbytes
    classes = np.full(n_pad, -1, np.int32)
    classes[:n] = table.amr_class_ids
    want_counters = run30["want"]

    # the two `cli run`s: K2 once a stream step, nothing else
    def expect_steps(trace_of):
        def expect():
            tr = trace_of()
            if tr["steps"] != tr["nbk"] * (tr["nbk"] + 1) // 2:
                raise AssertionError(f"stream steps {tr['steps']} are not "
                                     f"one full sweep of {tr['nbk']} blocks")
            return {"K1": 0, "K2": tr["steps"], "K3": 0, "K4": 0}
        return expect

    launches = {}
    for flags, trace_of in (
        (["--engine", "stream"], lambda: stream.last_trace),
        (["--engine", "stream", "--stream-source", "csr"],
         lambda: stream.last_onepass_trace),
    ):
        got = cli_run(dev, run30["fasta"], run30["out"], flags, want_counters,
                      want_pairs, expect_steps(trace_of))
        tr = trace_of()
        print(f"  stream blocking of that run: bs {tr['bs']}, nbk "
              f"{tr['nbk']}, g {tr['g']}, word_chunk {tr['word_chunk']}, "
              f"steps {tr['steps']}, uploads {tr['uploads']}"
              + (f", one-pass capacity {tr['vcap']} rows, overflow "
                 f"{tr['overflow']}" if "vcap" in tr else ""), flush=True)
        launches[" ".join(flags[2:]) or "host"] = got["K2"]

    # the in-core scan's statistics, the yardstick of every stream run
    words = bitset_to_torch(bitset, dev)
    rs_ref, th_ref, tiles_ref = bitmul.sweep_mxu(
        words, classes_to_torch(table.amr_class_ids, n_pad, dev), n,
        THRESHOLD)
    del words
    torch.cuda.empty_cache()
    nb_ref = n_pad // 512

    def stats_err(rs, th, tiles):
        """max_abs_err of a stream sweep's statistics against the scan's;
        the stream's rows and tiles past the scan's N_pad must be 0."""
        keep = (tiles[0] < nb_ref) & (tiles[1] < nb_ref)
        return max(
            int(np.abs(rs[:n_pad] - rs_ref).max()), int(np.abs(rs[n_pad:]).max())
            if rs.shape[0] > n_pad else 0,
            int(np.abs(th[keep].astype(np.int64) - th_ref).max()),
            int(np.abs(th[~keep]).max()) if (~keep).any() else 0,
        )

    def check(label, err, pairs=None):
        ok = err <= TOL and (pairs is None
                             or np.array_equal(pairs, want_pairs))
        print(f"stream {label}: max_abs_err {err} against the in-core scan "
              f"(tolerance {TOL})"
              + ("" if pairs is None else
                 f", {len(pairs)} pairs equal the oracle: "
                 f"{np.array_equal(pairs, want_pairs)}"), flush=True)
        if not ok:
            raise AssertionError(f"stream {label} disagrees")

    def trace_line(tr, seconds):
        rate = tr["upload_bytes"] / seconds / 1e9 if seconds else 0.0
        return (f"upload {tr['upload_s']:.4f} s ({tr['uploads']} blocks, "
                f"{tr['upload_bytes']} bytes = "
                f"{tr['upload_bytes'] / matrix_bytes:.2f} x the matrix, "
                f"{rate:.2f} GB/s host->device over the run), dispatch "
                f"{tr['dispatch_s']:.4f} s, drain {tr['drain_s']:.4f} s, "
                f"fetch {tr.get('fetch_s', tr.get('finalize_s', 0.0)):.4f} s; "
                f"bs {tr['bs']}, nbk {tr['nbk']}, g {tr['g']}, word_chunk "
                f"{tr['word_chunk']}, {tr['steps']} steps")

    def counted(fn):
        """(fn(), the kernel launches it made): every launch counter is
        set to 0 just before and read just after."""
        fns = reset_counters()
        out = fn()
        got = {k: f.launches for k, f in fns.items()}
        return out, got

    def peak_of(fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        out = fn()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated(dev),
                     torch.cuda.max_memory_reserved(dev))

    # the copy rates the sweep's uploads can reach: one [4096, W] block
    # staged into pinned memory (host memcpy), and its copy to the card
    blk = words_host[:4096].view(np.int32)
    pinned = torch.empty(blk.shape, dtype=torch.int32, pin_memory=True)
    t0 = time.perf_counter()
    for _ in range(3):
        pinned.numpy()[:] = blk
    stage_gbs = 3 * blk.nbytes / (time.perf_counter() - t0) / 1e9
    copy_ms = cuda_ms(lambda: pinned.to(dev, non_blocking=True), reps=5,
                      warmup=1)
    print(f"stream copy rates: staging one {blk.nbytes}-byte block into "
          f"pinned memory {stage_gbs:.2f} GB/s (host memcpy), pinned->device "
          f"copy {copy_ms:.3f} ms = {blk.nbytes / copy_ms / 1e6:.2f} GB/s",
          flush=True)
    del pinned

    # warm sweep, default budget: single group, K2 once a step
    def sweep(**kw):
        return stream.sweep_mxu_stream(words_host, classes, n, THRESHOLD,
                                       device=dev, **kw)

    (rs, th, tiles), got = counted(sweep)
    tr = stream.last_trace
    if got != {"K1": 0, "K2": tr["steps"], "K3": 0, "K4": 0}:
        raise AssertionError(f"stream sweep kernel launches {got}")
    check("sweep (13 GiB budget)", stats_err(rs, th, tiles))
    default_blocking = dict(tr)
    (sweep_s, _), peak = peak_of(lambda: best_seconds(sweep, reps=2, warmup=0))
    tr = stream.last_trace
    print(f"{N_SCALE} warm stream sweep {sweep_s:.6f} s (best of 2 after a "
          f"warm-up) beside the in-core scan's {scan_s:.6f} s "
          f"({sweep_s / scan_s:.2f} x); {trace_line(tr, sweep_s)}; peak "
          f"device memory {peak[0]} bytes allocated, {peak[1]} reserved "
          f"(matrix {matrix_bytes} bytes)", flush=True)

    # two-pass: the grouped extractor on the stream sweep's tile hits
    t0 = time.perf_counter()
    pairs = stream.extract_pairs_stream_grouped(
        words_host, classes, th, tiles, n=n, threshold=THRESHOLD, device=dev)
    torch.cuda.synchronize()
    grouped_s = time.perf_counter() - t0
    check("grouped extractor", 0, pairs)
    gtr = stream.last_grouped_trace
    print(f"stream grouped extraction {grouped_s:.6f} s: "
          f"{trace_line(gtr, grouped_s)} of {gtr['block_pairs_total']} "
          f"block pairs", flush=True)

    # fused: candidates drained inside the in-flight window
    t0 = time.perf_counter()
    rs_f, th_f, tiles_f, cands = sweep(fused_k=512)
    torch.cuda.synchronize()
    fsweep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pairs = stream.extract_pairs_stream_fused(
        words_host, classes, th_f, tiles_f, cands, n=n, threshold=THRESHOLD,
        device=dev)
    fext_s = time.perf_counter() - t0
    h = th_f[:, 0]
    check("fused sweep + extraction", stats_err(rs_f, th_f, tiles_f), pairs)
    print(f"stream fused sweep {fsweep_s:.6f} s + fused extraction "
          f"{fext_s:.6f} s (capacity k {cands.k}: {len(cands.pairs)} "
          f"candidates drained, {int((h > cands.k).sum())} of "
          f"{int((h > 0).sum())} hit tiles redone); "
          f"{trace_line(stream.last_trace, fsweep_s)}", flush=True)
    del cands

    # one pass, from both block sources
    source = stream.CSRBlockSource(index.incidence_protein,
                                   index.incidence_rank, n_pad, bitset.w_pad)
    onepass_s = {}
    for label, kw in (("host words", dict()),
                      ("CSR source", dict(block_source=source))):
        def onepass():
            return stream.sweep_extract_stream(
                None if kw else words_host, classes, n, THRESHOLD,
                device=dev, **kw)

        t0 = time.perf_counter()
        (out, got), peak = peak_of(lambda: counted(onepass))
        one_s = time.perf_counter() - t0
        tr = stream.last_onepass_trace
        onepass_s[label] = one_s
        if got != {"K1": 0, "K2": tr["steps"], "K3": 0, "K4": 0}:
            raise AssertionError(f"one-pass kernel launches {got}")
        check(f"one pass, {label}", stats_err(*out[:3]), out[3])
        print(f"stream one pass ({label}) {one_s:.6f} s: "
              f"{trace_line(tr, one_s)}; dispatch {tr['dispatch']}, "
              f"{tr['launches']} probes, capacity {tr['vcap']} rows, "
              f"overflow {tr['overflow']}; peak device memory {peak[0]} "
              f"bytes allocated, {peak[1]} reserved", flush=True)
    del source, out

    # a budget the matrix cannot fit: several stationary groups, and the
    # peak device memory stays under the matrix's bytes
    budget = STREAM_SMALL_BUDGET
    ((rs, th, tiles), got), peak = peak_of(
        lambda: counted(lambda: sweep(hbm_budget_bytes=budget)))
    tr = stream.last_trace
    t_small = tr["upload_s"] + tr["dispatch_s"] + tr["drain_s"] + tr["fetch_s"]
    if got != {"K1": 0, "K2": tr["steps"], "K3": 0, "K4": 0}:
        raise AssertionError(f"small-budget sweep kernel launches {got}")
    check(f"sweep under a {budget}-byte budget", stats_err(rs, th, tiles))
    print(f"stream sweep under a {budget}-byte budget (matrix {matrix_bytes} "
          f"bytes) {t_small:.6f} s: {trace_line(tr, t_small)}; "
          f"{-(-tr['nbk'] // tr['g'])} stationary groups; peak device memory "
          f"{peak[0]} bytes allocated, {peak[1]} reserved", flush=True)
    if tr["g"] >= tr["nbk"] or peak[0] >= matrix_bytes:
        raise AssertionError(
            "the small-budget sweep did not stream: one group, or a peak "
            "not below the matrix's bytes")

    # kill after one stationary group, then resume, under that budget
    store = CheckpointStore(os.path.join(tmp, "stream_ckpt"))
    kw = dict(hbm_budget_bytes=budget, checkpoint_store=store,
              checkpoint_key="smoke", device=dev)
    t0 = time.perf_counter()
    try:
        stream.sweep_extract_stream(words_host, classes, n, THRESHOLD,
                                    fail_after_groups=1, **kw)
    except RuntimeError as e:
        if "fault injection" not in str(e):
            raise
        killed_s = time.perf_counter() - t0
    else:
        raise AssertionError("the fault injection did not fire")
    snap = store.load("smoke")
    if snap is None or len(snap["groups_done"]) != 1:
        raise AssertionError("the killed run left no one-group snapshot")
    t0 = time.perf_counter()
    out = stream.sweep_extract_stream(words_host, classes, n, THRESHOLD, **kw)
    resumed_s = time.perf_counter() - t0
    tr = stream.last_onepass_trace
    check("kill and resume (one pass)", stats_err(*out[:3]), out[3])
    print(f"stream kill after 1 group {killed_s:.6f} s, resume "
          f"{resumed_s:.6f} s: {tr.get('groups_skipped')} of "
          f"{-(-tr['nbk'] // tr['g'])} groups skipped, snapshot removed: "
          f"{store.load('smoke') is None}; {trace_line(tr, resumed_s)}",
          flush=True)
    if tr.get("groups_skipped") != 1 or store.load("smoke") is not None:
        raise AssertionError("the resume did not skip the completed group "
                             "or left its snapshot")
    del out

    # K2 against its plain version on one stream-step block, at the
    # stream's own block shape
    bs = default_blocking["bs"]
    i0, j0 = 0, bs
    wa = torch.from_numpy(words_host[i0 : i0 + bs].view(np.int32)).to(dev)
    wb = torch.from_numpy(words_host[j0 : j0 + bs].view(np.int32)).to(dev)
    counts = bitmul.counts_window_pair(
        wa, wb, word_chunk=default_blocking["word_chunk"])
    del wa, wb
    cls_dev = torch.from_numpy(classes).to(dev)
    ca, cb = cls_dev[i0 : i0 + bs], cls_dev[j0 : j0 + bs]
    kw = dict(n=n, threshold=THRESHOLD, w_thresh=1, tile=512)
    rs_k, bh_k = stats.stats_from_counts_traced(counts, ca, cb, i0, j0, **kw)
    rs_p, bh_p = stats.stats_from_counts_traced_reference(counts, ca, cb, i0,
                                                          j0, **kw)
    torch.cuda.synchronize()
    err = max(max_abs_err(rs_k, rs_p), max_abs_err(bh_k, bh_p))
    rs_acc = torch.zeros((bs, 8), dtype=torch.int32, device=dev)
    bh_acc = torch.zeros((bs // 512, bs // 512, 2), dtype=torch.int32,
                         device=dev)
    k2_ms = kernel_only_ms(lambda: stats.stats_from_counts_traced_into(
        counts, ca, cb, rs_acc, bh_acc, i0, j0, **kw))
    plain_ms = cuda_ms(lambda: stats.stats_from_counts_traced_reference(
        counts, ca, cb, i0, j0, **kw), reps=5)
    bound = epilogue_bound_ms(bs, bs, i0, j0, n, 8 * bs + 2 * (bs // 512) ** 2)
    print(f"kernel K2 on the stream-step block counts[{bs}, {bs}] at "
          f"({i0}, {j0}): max_abs_err {err} (tolerance {TOL}), block hits "
          f"{int(bh_k.sum())}; kernel-only {k2_ms:.4f} ms, bound "
          f"{bound:.4f} ms (needed bytes), share {bound / k2_ms:.3f}; plain "
          f"torch {plain_ms:.4f} ms", flush=True)
    if err > TOL:
        raise AssertionError("K2 disagrees with its plain version on a "
                             "stream-step block")
    print(f"stream phase: K2 launches {launches}; "
          f"{time.perf_counter() - t_phase:.3f} s", flush=True)
    return dict(launches=launches["host"], err=err, onepass_s=onepass_s)


def k3_phase(dev, state10, state30, sm_mhz):
    """K3, the fused triangle sweep, through its library entry
    ``ops.tri_mxu.sweep_tri_mxu``, with every launch counter set to 0 just
    before each call and read just after (K3 once, nothing else). At
    10,619 proteins it must equal its plain version (the MXU sweep with
    the plain epilogue) and the MXU sweep (strips + K1) for int8 and bf16, unweighted and with the BLOSUM
    weights and threshold of ``cli run --weighting blosum62``; bf16
    weighted runs where the exactness guard admits it and must raise where
    it does not. At 30,000 proteins (int8) it must equal the scan sweep.
    Then device times beside their bound (2 n(n-1)/2 K operations at the
    tensor cores' peak) and share, against the plain version, the MXU
    sweep and the products-only yardstick, and peak device memory of one
    call of each."""
    import numpy as np
    import torch

    from uniprot_kmer_based_clustering_tpu_torch import PipelineConfig
    from uniprot_kmer_based_clustering_tpu_torch import pipeline as pl
    from uniprot_kmer_based_clustering_tpu_torch.ops import bitmul, tri_mxu
    from uniprot_kmer_based_clustering_tpu_torch.state import (
        bitset_to_torch,
        classes_to_torch,
    )

    t_phase = time.perf_counter()
    launches = 0

    def entry(words, classes, n, threshold, **kw):
        nonlocal launches
        fns = reset_counters()
        out = tri_mxu.sweep_tri_mxu(words, classes, n, threshold, **kw)
        got = {k: fn.launches for k, fn in fns.items()}
        if got != {"K1": 0, "K2": 0, "K3": 1, "K4": 0}:
            raise AssertionError(f"sweep_tri_mxu kernel launches {got}")
        launches += 1
        return out

    def err(a, b):
        return max(int(np.abs(a[0] - b[0]).max()),
                   int(np.abs(a[1] - b[1]).max()))

    def peak(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(dev), base

    def yardstick(words, tile=512):
        """torch._int_mm over the upper triangle's tile rows on operands
        unpacked beforehand: the products alone, in one library call a
        tile row. Returns its time and the line that sets it beside the
        triangle's bound and beside the bound of its own operations
        (whole tile rows: diagonal tiles' lower halves, padded rows and
        all W_pad * 32 columns)."""
        bits = bitmul.unpack_words_to_int8(words)
        n_pad, k_pad = bits.shape

        def run():
            for i0 in range(0, n_pad, tile):
                bitmul.int8_gemm(bits[i0 : i0 + tile], bits[i0:])

        ms = cuda_ms(run, reps=2, warmup=1)
        del bits
        torch.cuda.empty_cache()
        own_ops = sum(2 * min(tile, n_pad - i0) * (n_pad - i0) * k_pad
                      for i0 in range(0, n_pad, tile))
        own_bound = own_ops / tc_peak_ops_s("int8", sm_mhz) * 1e3
        return ms, own_ops, own_bound

    def yard_line(yard, bound, n, k_bits):
        ms, own_ops, own_bound = yard
        return (f"{timed(ms, bound)} of the triangle's; it computes "
                f"{own_ops} operations, {own_ops / (n * (n - 1) * k_bits):.3f}"
                f" x the triangle's, bound {own_bound:.4f} ms, share of its "
                f"own bound {own_bound / ms:.3f}")

    def timed(ms, bound):
        return f"{ms:.4f} ms, bound {bound:.4f} ms, share {bound / ms:.3f}"

    table, index, bitset = state10
    n, n_pad = table.n, bitset.n_pad
    words = bitset_to_torch(bitset, dev)
    classes = classes_to_torch(table.amr_class_ids, n_pad, dev)
    cfg = PipelineConfig(weighting="blosum62")
    wts = pl.blosum_weights(index, cfg, bitset)
    w_thr = cfg.effective_weighted_threshold(wts)
    worst = (bitset.w_pad + (-bitset.w_pad % 128)) * 32 * int(
        np.abs(wts.astype(np.int64)).max())
    admitted = worst < 1 << 24
    print(f"K3 bf16 guard, BLOSUM-weighted {N_PROTEINS}: worst-case sum "
          f"{worst} against 2^24 = {1 << 24}: "
          f"{'admitted' if admitted else 'refused'}", flush=True)
    worst_err = 0
    for dot, weights, thr in (("int8", None, THRESHOLD),
                              ("bfloat16", None, THRESHOLD),
                              ("int8", wts, w_thr),
                              ("bfloat16", wts, w_thr)):
        label = (f"{N_PROTEINS} {dot} " + (
            f"BLOSUM-weighted (threshold {thr})" if weights is not None
            else "unweighted"))
        if dot == "bfloat16" and weights is not None and not admitted:
            try:
                entry(words, classes, n, thr, weights=weights, dot_dtype=dot)
            except ValueError as e:
                print(f"K3 {label}: refused by the guard: {e}", flush=True)
                continue
            raise AssertionError("the bf16 guard admitted a sum past 2^24")
        got = entry(words, classes, n, thr, weights=weights, dot_dtype=dot)
        plain = bitmul.sweep_mxu(words, classes, n, thr, weights=weights,
                                 stats_engine="xla")
        mxu = bitmul.sweep_mxu(words, classes, n, thr, weights=weights)
        e_p, e_m = err(got, plain), err(got, mxu)
        print(f"kernel K3 {label}: max_abs_err against the plain version "
              f"{e_p}, against sweep_mxu {e_m} (tolerance {TOL}); "
              f"over-threshold hits {int(got[1].sum())}, cross weight "
              f"{int(got[0][:, 0].sum())}", flush=True)
        if max(e_p, e_m) > TOL:
            raise AssertionError(f"K3 {label} disagrees")
        worst_err = max(worst_err, e_p, e_m)

    def k3(dot):
        return lambda: tri_mxu.tri_mxu_sweep(words, classes, n, THRESHOLD,
                                             dot_dtype=dot)

    def plain():
        return bitmul.sweep_mxu(words, classes, n, THRESHOLD,
                                stats_engine="xla")

    def mxu10():
        return bitmul.sweep_mxu(words, classes, n, THRESHOLD)

    plain_a = cuda_ms(plain, reps=1, warmup=0)
    k3_a = cuda_ms(k3("int8"), reps=5, warmup=1)
    bf_a = cuda_ms(k3("bfloat16"), reps=5, warmup=1)
    bf_b = cuda_ms(k3("bfloat16"), reps=5, warmup=1)
    k3_b = cuda_ms(k3("int8"), reps=5, warmup=1)
    plain_b = cuda_ms(plain, reps=1, warmup=0)
    mxu_ms = cuda_ms(mxu10, reps=3, warmup=1)
    k3_ms, plain_ms = min(k3_a, k3_b), min(plain_a, plain_b)
    bf_ms = min(bf_a, bf_b)
    bound, bound_bf = (tri_bound_ms(n, bitset.n_bits, d, sm_mhz)
                       for d in ("int8", "bfloat16"))
    spec, spec_bf = (n * (n - 1) * bitset.n_bits / SPEC_PEAK_OPS_S[d] * 1e3
                     for d in ("int8", "bfloat16"))
    yard = yardstick(words)
    pk_k3, base = peak(k3("int8"))
    pk_mxu, _ = peak(mxu10)
    print(f"K3 bounds at {sm_mhz:.0f} MHz: tensor-core peak int8 "
          f"{tc_peak_ops_s('int8', sm_mhz):.4e} ops/s, bf16 "
          f"{tc_peak_ops_s('bfloat16', sm_mhz):.4e} ops/s (spec sheet, "
          f"dense: {SPEC_PEAK_OPS_S['int8']:.4e}, "
          f"{SPEC_PEAK_OPS_S['bfloat16']:.4e}; at the spec figure the "
          f"bounds would be int8 {spec:.4f} ms, bf16 {spec_bf:.4f} ms)",
          flush=True)
    print(f"K3 {N_PROTEINS} whole triangle, K = {bitset.n_bits} (device "
          f"ms): int8 {timed(k3_ms, bound)} ({k3_a:.4f}, {k3_b:.4f}); "
          f"bf16 {timed(bf_ms, bound_bf)} ({bf_a:.4f}, {bf_b:.4f}); "
          f"plain version {plain_ms:.4f} ({plain_a:.4f}, {plain_b:.4f}); "
          f"warm sweep_mxu {mxu_ms:.4f}; products-only yardstick "
          f"(torch._int_mm, {-(-n_pad // 512)} tile rows) "
          f"{yard_line(yard, bound, n, bitset.n_bits)}; peak device memory "
          f"of one call: "
          f"K3 {pk_k3} bytes, sweep_mxu {pk_mxu} bytes ({base} resident "
          f"before)", flush=True)
    k3_only = kernel_only_ms(k3("int8"), reps=5)
    del words

    table, _, bitset = state30
    n, n_pad = table.n, bitset.n_pad
    words = bitset_to_torch(bitset, dev)
    classes = classes_to_torch(table.amr_class_ids, n_pad, dev)
    got = entry(words, classes, n, THRESHOLD)
    mxu = bitmul.sweep_mxu(words, classes, n, THRESHOLD)
    e_m = err(got, mxu)
    print(f"kernel K3 {N_SCALE} int8 unweighted: max_abs_err against the "
          f"scan sweep_mxu {e_m} (tolerance {TOL}); over-threshold hits "
          f"{int(got[1].sum())}", flush=True)
    if e_m > TOL:
        raise AssertionError("K3 disagrees with the scan sweep at 30k")
    worst_err = max(worst_err, e_m)
    k3_30 = cuda_ms(lambda: tri_mxu.tri_mxu_sweep(words, classes, n,
                                                  THRESHOLD),
                    reps=2, warmup=0)
    mxu_30 = cuda_ms(lambda: bitmul.sweep_mxu(words, classes, n, THRESHOLD),
                     reps=1, warmup=0)
    pk_k3, base = peak(lambda: tri_mxu.tri_mxu_sweep(words, classes, n,
                                                     THRESHOLD))
    pk_mxu, _ = peak(lambda: bitmul.sweep_mxu(words, classes, n, THRESHOLD))
    bound30 = tri_bound_ms(n, bitset.n_bits, "int8", sm_mhz)
    yard30 = yardstick(words)
    print(f"K3 {N_SCALE} whole triangle, K = {bitset.n_bits} (device ms): "
          f"int8 {timed(k3_30, bound30)}; warm scan sweep_mxu "
          f"{mxu_30:.4f}; products-only yardstick "
          f"{yard_line(yard30, bound30, n, bitset.n_bits)}"
          f"; peak device memory of one call: K3 {pk_k3} bytes, sweep_mxu "
          f"{pk_mxu} bytes ({base} resident before)", flush=True)
    print(f"K3 phase: {launches} library calls, one K3 launch each; "
          f"{time.perf_counter() - t_phase:.3f} s", flush=True)
    print(f"K3 {N_PROTEINS} int8, one call with L2 cold (kernel-only "
          f"{k3_only:.4f} ms, share {bound / k3_only:.3f})", flush=True)
    return dict(err=worst_err, ms=k3_only, call_ms=k3_ms, plain_ms=plain_ms,
                launches=launches, bound_ms=bound)


def scan_timing_phase(dev, state, want_pairs):
    """30k proteins: warm scan sweep, two-pass against fused extraction,
    per-layer times of one scan step, peak device memory of each."""
    import numpy as np
    import torch

    from uniprot_kmer_based_clustering_tpu_torch.ops import bitmul, stats
    from uniprot_kmer_based_clustering_tpu_torch.similarity.pairwise import (
        extract_pairs,
        extract_pairs_fused,
    )
    from uniprot_kmer_based_clustering_tpu_torch.state import (
        bitset_to_torch,
        classes_to_torch,
    )

    table, _, bitset = state
    n, n_pad = table.n, bitset.n_pad
    words = bitset_to_torch(bitset, dev)
    classes = classes_to_torch(table.amr_class_ids, n_pad, dev)
    pair_count = n * (n - 1) // 2

    torch.cuda.reset_peak_memory_stats(dev)
    sweep_s, (rs, th, tiles) = best_seconds(
        lambda: bitmul.sweep_mxu(words, classes, n, THRESHOLD),
        reps=2, warmup=1,
    )
    two_s, pairs = best_seconds(
        lambda: extract_pairs(words, classes, th, tiles, n, THRESHOLD),
        reps=2, warmup=1,
    )
    peak_two = torch.cuda.max_memory_allocated(dev)
    del th
    torch.cuda.reset_peak_memory_stats(dev)
    fsweep_s, out = best_seconds(
        lambda: bitmul.sweep_mxu(words, classes, n, THRESHOLD, fused_k=None),
        reps=2, warmup=1,
    )
    cands = out[3]
    fext_s, fpairs = best_seconds(
        lambda: extract_pairs_fused(words, classes, out[1], out[2], cands,
                                    n, THRESHOLD),
        reps=2, warmup=1,
    )
    peak_fused = torch.cuda.max_memory_allocated(dev)
    if not (np.array_equal(pairs, want_pairs)
            and np.array_equal(fpairs, want_pairs)):
        raise AssertionError("warm 30k extraction differs from the oracle")
    print(f"{N_SCALE} warm scan sweep {sweep_s:.6f} s (best of 2 after a "
          f"warm-up) = {pair_count / sweep_s:.6e} pairs/s; two-pass "
          f"extraction {two_s:.6f} s (sweep + extraction "
          f"{sweep_s + two_s:.6f} s, peak device memory {peak_two} bytes); "
          f"fused sweep {fsweep_s:.6f} s + fused extraction {fext_s:.6f} s "
          f"= {fsweep_s + fext_s:.6f} s (capacity k {cands.k}, peak "
          f"{peak_fused} bytes); {len(pairs)} pairs", flush=True)
    del out, cands

    # per-layer device times of one scan step
    bs = 3584
    _, _, ns = bitmul.resolve_schedule(n_pad, 512)
    steps = ns * (ns + 1) // 2
    unpack_ms = cuda_ms(lambda: bitmul.unpack_words_to_int8(words[:bs]),
                        reps=3, warmup=1)
    a = bitmul.unpack_words_to_int8(words[:bs])
    b = bitmul.unpack_words_to_int8(words[bs : 2 * bs])
    gemm_ms = cuda_ms(lambda: bitmul.int8_gemm(a, b), reps=3, warmup=1)
    del a, b
    ops = 2 * bs * bs * bitset.w_pad * 32
    print(f"scan step layers (device ms): unpack of one {bs}-row window "
          f"{unpack_ms:.4f}, int8 GEMM {gemm_ms:.4f} ({ops / gemm_ms / 1e9:.1f} "
          f"TOP/s); x{steps} steps (+{ns} stationary unpacks): GEMM "
          f"{gemm_ms * steps:.1f}, unpack {unpack_ms * (steps + ns):.1f}",
          flush=True)

    # the scan's epilogue: what it launches on each step's counts (one
    # K2 call into its accumulators), back to back, summed over the steps
    nb = n_pad // 512
    row_stats = torch.zeros((n_pad, 8), dtype=torch.int32, device=dev)
    block_hits = torch.zeros((nb, nb, 2), dtype=torch.int32, device=dev)
    kw = dict(n=n, threshold=THRESHOLD, tile=512)
    epi_ms = 0.0
    a_row = None
    for i0, j0 in (np.stack(np.triu_indices(ns), axis=1) * bs).tolist():
        if a_row != i0:
            a = bitmul.unpack_words_to_int8(words[i0 : i0 + bs])
            a_row = i0
        counts = bitmul.int8_gemm(
            a, a if i0 == j0 else bitmul.unpack_words_to_int8(
                words[j0 : j0 + bs]))
        epi_ms += cuda_ms(lambda: stats.stats_from_counts_traced_into(
            counts, classes[i0 : i0 + bs], classes[j0 : j0 + bs],
            row_stats[i0 : i0 + bs], block_hits[i0 // 512 :, j0 // 512 :],
            i0, j0, **kw))
    del a, counts
    print(f"scan epilogue: K2 over the {steps} steps {epi_ms:.4f} ms (one "
          f"accumulate-into call a step, back-to-back device time)",
          flush=True)
    return dict(sweep_s=sweep_s, two_s=two_s, fsweep_s=fsweep_s,
                fext_s=fext_s, epi_ms=epi_ms)


def timing_phase(dev, state, want_pairs, stats):
    """10,619 proteins: warm sweeps (without and with K1's survivor
    append) and extractions (pass 2, and the sort and fetch of what K1
    appended), per-layer times of one sweep, K1's append against its
    plain version on every strip, K1 with and without the append against
    its plain version on strip 0 of the corpus."""
    import numpy as np
    import torch

    from uniprot_kmer_based_clustering_tpu_torch.ops import bitmul
    from uniprot_kmer_based_clustering_tpu_torch.ops.pairlist import (
        EPILOGUE_PAIR_CAP,
        new_pair_buffers,
    )
    from uniprot_kmer_based_clustering_tpu_torch.similarity.pairwise import (
        _tile_runs,
        extract_pairs,
    )
    from uniprot_kmer_based_clustering_tpu_torch.state import (
        bitset_to_torch,
        classes_to_torch,
    )

    table, _, bitset = state
    n, n_pad = table.n, bitset.n_pad
    words = bitset_to_torch(bitset, dev)
    classes = classes_to_torch(table.amr_class_ids, n_pad, dev)
    torch.cuda.reset_peak_memory_stats(dev)

    def sweep(**kw):
        return bitmul.sweep_mxu(words, classes, n=n, threshold=THRESHOLD,
                                **kw)

    sweep_s, (rs, th, tiles) = best_seconds(sweep)
    # what the main path's sweep launches: every strip's K1 appends into
    # EPILOGUE_PAIR_CAP slots
    asweep_s, res = best_seconds(lambda: sweep(append=True))
    total = int(th[:, 0].sum())
    if (not np.array_equal(res.row_stats, rs)
            or not np.array_equal(res.tile_hits, th)
            or int(res.pairs[3]) != total):
        raise AssertionError("the sweep with K1's append differs from the "
                             "sweep without it")
    extract_s, pairs = best_seconds(
        lambda: extract_pairs(words, classes, th, tiles, n=n,
                              threshold=THRESHOLD)
    )
    # the main path's extraction: the appended pairs when they fit the
    # buffers, else pass 2
    mextract_s, mpairs = best_seconds(
        lambda: extract_pairs(words, classes, th, tiles, n=n,
                              threshold=THRESHOLD, appended=res.pairs))
    peak = torch.cuda.max_memory_allocated(dev)
    if not (np.array_equal(pairs, want_pairs)
            and np.array_equal(mpairs, want_pairs)):
        raise AssertionError("warm extraction differs from the run")
    pair_count = n * (n - 1) // 2
    fits = total <= EPILOGUE_PAIR_CAP
    print(f"warm sweep_mxu {sweep_s:.6f} s (best of 3 after 2 warm-ups) "
          f"= {pair_count / sweep_s:.6e} pairs/s; with K1's append "
          f"{asweep_s:.6f} s; warm extract_pairs (pass 2) "
          f"{extract_s:.6f} s for {len(pairs)} pairs; the main path's "
          f"extraction of the appended buffers ({total} survivors, "
          f"{EPILOGUE_PAIR_CAP} slots: "
          f"{'sort and fetch' if fits else 'pass 2'}) {mextract_s:.6f} s; "
          f"peak device memory {peak} bytes", flush=True)

    # per-layer device times of one sweep (CUDA events); K1's append
    # against its plain version on every strip: with room for every
    # survivor (the stored triples and the cursor equal the plain
    # append's) and in the main path's EPILOGUE_PAIR_CAP slots (the
    # cursor counts every survivor, the stored slots are survivors, each
    # once)
    _, strip, ns = bitmul.resolve_schedule(n_pad, 512)
    unpack_ms = cuda_ms(lambda: bitmul.unpack_words_to_int8(words), reps=3)
    bits = bitmul.unpack_words_to_int8(words)
    nb = n_pad // 512

    def sweep_buffers():
        return (torch.empty((n_pad, 8), dtype=torch.int32, device=dev),
                torch.zeros((nb, nb, 2), dtype=torch.int32, device=dev))

    plain_rs, plain_bh = sweep_buffers()
    app_rs, app_bh = sweep_buffers()
    ref_rs, ref_bh = sweep_buffers()
    junk = sweep_buffers()  # the timed calls' outputs
    room = new_pair_buffers(total + 7, dev)
    short = new_pair_buffers(EPILOGUE_PAIR_CAP, dev)
    ref = new_pair_buffers(total + 7, dev)
    # room for every survivor of the timed calls of the biggest strip
    timed = new_pair_buffers(24 * total, dev)
    gemm_ms = epi_ms = app_ms = 0.0
    strip_survivors = []
    for si in range(ns):
        i0, gb = si * strip, si * strip // 512
        a, b = bits[i0 : i0 + strip], bits[i0:]
        gemm_ms += cuda_ms(lambda: bitmul.int8_gemm(a, b), reps=3)
        counts = bitmul.int8_gemm(a, b)
        kw = dict(i_off=i0, j_off=i0, n=n, threshold=THRESHOLD, tile=512)
        ca, cb = classes[i0 : i0 + strip], classes[i0:]

        def k1(rs_, bh_, pairs=None):
            return stats.stats_from_counts_into(
                counts, ca, cb, rs_[i0 : i0 + strip], bh_[gb:, gb:],
                pairs=pairs, **kw)

        # what the ring and every path but the strip sweep launch
        epi_ms += cuda_ms(lambda: k1(*junk))
        # what the strip sweep launches: K1 storing every survivor, as on
        # the ARG corpus
        timed[3].zero_()
        app_ms += cuda_ms(lambda: k1(*junk, timed))
        k1(plain_rs, plain_bh)
        k1(app_rs, app_bh, room)
        k1(*junk, short)
        before = int(ref[3])
        stats.stats_from_counts_into_reference(
            counts, ca, cb, ref_rs[i0 : i0 + strip], ref_bh[gb:, gb:],
            pairs=ref, **kw)
        strip_survivors.append(int(ref[3]) - before)
    del counts, a, b
    torch.cuda.synchronize()

    def stored(bufs, count):
        return _sorted_pair_rows(*(t[:count] for t in bufs[:3]))

    want = stored(ref, total)
    got = stored(room, total)
    kept = stored(short, min(total, EPILOGUE_PAIR_CAP))
    key = want[:, 0] * (1 << 32) + want[:, 1]
    kept_key = kept[:, 0] * (1 << 32) + kept[:, 1]
    at = np.minimum(np.searchsorted(key, kept_key), max(total - 1, 0))
    checks = {
        "cursor = survivors (room)": int(room[3]) == total,
        "cursor = survivors (main path's slots)": int(short[3]) == total,
        "plain cursor = tile hits": int(ref[3]) == total,
        "stored = plain append (room)": np.array_equal(got, want),
        "unused slots untouched (room)": bool(
            (room[2][total:] == -1).all()),
        "stored are survivors, each once (main path's slots)": (
            len(np.unique(kept_key)) == len(kept)
            and np.array_equal(want[at], kept)),
        "row stats and tile hits = K1 without the append = plain": (
            torch.equal(app_rs, ref_rs) and torch.equal(app_bh, ref_bh)
            and torch.equal(plain_rs, ref_rs)
            and torch.equal(plain_bh, ref_bh)),
    }
    print(f"K1's append on the {ns} strips of the corpus ({total} "
          f"survivors, {strip_survivors} a strip) against its plain "
          f"version: {checks}", flush=True)
    if not all(checks.values()):
        raise AssertionError("K1's append disagrees with its plain version")
    appended_s, apairs = best_seconds(
        lambda: extract_pairs(words, classes, th, tiles, n=n,
                              threshold=THRESHOLD,
                              appended=room[:3] + (room[3].cpu(),)))
    if not np.array_equal(apairs, want_pairs):
        raise AssertionError("the appended pairs differ from the run")
    del room, short, ref, timed, junk
    macs = sum(strip * (n_pad - si * strip) for si in range(ns)) * bits.shape[1]
    print(f"sweep layers (device ms): unpack {unpack_ms:.4f}, int8 GEMM "
          f"{gemm_ms:.4f} ({2 * macs / gemm_ms / 1e9:.1f} TOP/s), K1 "
          f"epilogue over {ns} strips (one accumulate-into call a strip, "
          f"back-to-back device time): with the survivor append, as the "
          f"strip sweep launches it, {app_ms:.4f}; without, as the ring "
          f"launches it, {epi_ms:.4f} ({app_ms / epi_ms:.3f}x); "
          f"extraction of the {total} appended survivors (sort and "
          f"fetch) {appended_s * 1e3:.4f} ms host wall, beside pass 2's "
          f"{extract_s * 1e3:.4f}", flush=True)

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
    print(f"pass-2 extraction layers (device ms): {len(runs)} products "
          f"over {len(hit)} hit tiles {xg_ms:.4f} of the "
          f"{extract_s * 1e3:.4f} ms warm pass 2", flush=True)

    # K1 against its plain version on strip 0 of the corpus, and its
    # times, without and with the survivor append
    counts = bitmul.int8_gemm(bits[:strip], bits)
    del bits
    kw = dict(i_off=0, j_off=0, n=n, threshold=THRESHOLD, tile=512)
    crow, ccol = classes[:strip], classes
    rs_k, th_k, _ = stats.stats_from_counts(counts, crow, ccol, **kw)
    rs_p, th_p, _ = stats.stats_from_counts_reference(counts, crow, ccol, **kw)
    err = max(max_abs_err(rs_k, rs_p), max_abs_err(th_k, th_p))
    if err > TOL:
        raise AssertionError("K1 disagrees with its plain version on strip 0")
    rs = torch.empty((strip, 8), dtype=torch.int32, device=dev)
    bh = torch.zeros((strip // 512, n_pad // 512, 2), dtype=torch.int32,
                     device=dev)
    out_ints = 8 * strip + 2 * len(th_k)
    t = epilogue_times(
        lambda: stats.stats_from_counts_into(counts, crow, ccol, rs, bh, **kw),
        lambda: stats.stats_from_counts(counts, crow, ccol, **kw),
        lambda: stats.stats_from_counts_reference(counts, crow, ccol, **kw),
        epilogue_bound_ms(strip, n_pad, 0, 0, n, out_ints),
    )
    print(f"K1 on strip 0 counts[{strip}, {n_pad}] "
          f"({needed_pairs(strip, n_pad, 0, 0, n)} needed counts): "
          f"{epilogue_line(t)}; max_abs_err {err}", flush=True)
    # with the append: every call stores its survivors (room for the
    # ~170 calls epilogue_times makes), the bound adds their 12 bytes
    # each and the cursor's 8
    m0 = strip_survivors[0]
    app = new_pair_buffers(176 * m0 + 1, dev)
    app_ref = new_pair_buffers(48 * m0 + 1, dev)
    rs_r, bh_r = rs.clone(), bh.clone()
    ta = epilogue_times(
        lambda: stats.stats_from_counts_into(counts, crow, ccol, rs, bh,
                                             pairs=app, **kw),
        lambda: stats.stats_from_counts(counts, crow, ccol, **kw),
        lambda: stats.stats_from_counts_into_reference(
            counts, crow, ccol, rs_r, bh_r, pairs=app_ref, **kw),
        epilogue_bound_ms(strip, n_pad, 0, 0, n, out_ints + 3 * m0 + 2),
    )
    del app, app_ref
    print(f"K1 with the survivor append on strip 0 ({m0} survivors): "
          f"{epilogue_line(ta)}; {ta['ms'] / t['ms']:.3f}x K1 without "
          f"(kernel-only)", flush=True)
    return dict(sweep_s=sweep_s, extract_s=extract_s, peak=peak, err=err,
                epi_ms=epi_ms, app_ms=app_ms, asweep_s=asweep_s,
                appended_s=appended_s, survivors=total,
                append={k: ta[k] for k in ("ms", "call_ms", "plain_ms",
                                           "bound_ms")},
                **t)


def _sorted_pair_rows(i, j, c):
    """(i, j, count) device tensors as one int64 host array sorted by
    (i, j)."""
    import numpy as np

    out = np.stack([x.cpu().numpy().astype(np.int64) for x in (i, j, c)], 1)
    return out[np.lexsort((out[:, 1], out[:, 0]))]


QUERY_BATCH = 256  # the self-query batch of the query phase
QUERY_STREAM_BS = 4096  # a stream block that makes the 30k corpus 8 blocks


def _query_batches(seqs, size):
    return [seqs[i : i + size] for i in range(0, len(seqs), size)]


def _same_answers(got, want, what):
    import numpy as np

    if len(got) != len(want) or not all(
            np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{what}: the answers differ")


def _zero_launches(fns, what):
    launches = {k: fn.launches for k, fn in fns.items()}
    if any(launches.values()):
        raise AssertionError(f"{what}: kernel launches {launches}, "
                             "expected none")
    return launches


def query_phase(dev, tmp, state10, pairs10, state30):
    """Query serving (docstring, phase 5) on the 10,619 corpus, and stream
    serving on the 30k corpus, every answer against an oracle that does
    not share the code under test; the per-layer device times, rates and
    peak memory of a resident server."""
    import contextlib
    import io

    import numpy as np
    import torch

    from uniprot_kmer_based_clustering_tpu_torch import PipelineConfig, cli
    from uniprot_kmer_based_clustering_tpu_torch.ops.bitmul import (
        int8_gemm,
        unpack_words_to_int8,
    )
    from uniprot_kmer_based_clustering_tpu_torch.pipeline import (
        blosum_weights,
    )
    from uniprot_kmer_based_clustering_tpu_torch.similarity import query as q

    t_phase = time.perf_counter()
    fns = reset_counters()
    table, index, bitset = state10
    n = table.n
    seqs = [table.seq(i) for i in range(n)]
    strangers = ["MKT", "W" * 60, "MK@3xZJMKTAYIAKQRQISFVKSHFSRQ"]
    corpus_bytes = bitset.words.nbytes

    # a resident server: its build, one batch, and the peak memory
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    srv = q.QueryServer(index, bitset, mode="device", device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    srv.query(seqs[:QUERY_BATCH], threshold=THRESHOLD)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    chunk_bytes = bitset.n_pad * 4096
    print(f"query server {N_PROTEINS}: built in {build_s:.3f} s; peak "
          f"device memory over the build and one batch of {QUERY_BATCH} "
          f"{peak:,} bytes (packed corpus {corpus_bytes:,}, one unpacked "
          f"chunk {chunk_bytes:,})", flush=True)
    if peak > corpus_bytes + 4 * chunk_bytes:
        raise AssertionError("the resident server holds more than one "
                             "corpus copy and a few chunks")

    # every corpus sequence as a query: the i<j cross-class matches are
    # the scipy oracle's pairs, and each self match the row's popcount
    t0 = time.perf_counter()
    answers = []
    for b in _query_batches(seqs, QUERY_BATCH):
        answers += srv.query(b, threshold=THRESHOLD)
    self_s = time.perf_counter() - t0
    popcount = np.bincount(index.incidence_protein, minlength=n)
    cls = table.amr_class_ids
    rows = []
    for i, m in enumerate(answers):
        js, cs = m[:, 0], m[:, 1]
        own = cs[js == i]
        want_own = [popcount[i]] if popcount[i] > THRESHOLD else []
        if list(own) != want_own:
            raise AssertionError(f"self match of {i}: {own}, popcount "
                                 f"{popcount[i]}")
        keep = (js > i) & (cls[js] != cls[i])
        rows.append(np.stack([np.full(int(keep.sum()), i), js[keep],
                              cs[keep]], axis=1))
    got = np.concatenate(rows)
    got = got[np.lexsort((got[:, 1], got[:, 0]))]
    if not np.array_equal(got, pairs10):
        raise AssertionError("self-queries differ from the scipy oracle")
    print(f"self-queries: {n} in batches of {QUERY_BATCH} in "
          f"{self_s:.3f} s ({n / self_s:.1f} queries/s): {len(got)} "
          f"cross-class i<j pairs equal the scipy oracle, every self match "
          f"the row's popcount", flush=True)

    # device against host (the rank-CSR walk), unweighted and weighted,
    # caps 512, 1 and 0, and async batches in flight
    weights = blosum_weights(index, PipelineConfig(weighting="blosum62"),
                             bitset)
    sample = seqs[7::41][:253] + strangers
    host = {w: q.QueryServer(index, bitset, weights=weights if w else None,
                             mode="host", device="cpu")
            for w in (False, True)}
    servers = {(False, 512): srv}
    for w, cap in ((True, 512), (False, 1), (False, 0), (True, 1)):
        servers[(w, cap)] = q.QueryServer(
            index, bitset, weights=weights if w else None, mode="device",
            topk_cap=cap, device=dev)
    checked = 0
    for size in (1, 16, 64, 256):
        batch = sample[:size]
        for (w, cap), s in servers.items():
            want = host[w].query(batch, threshold=THRESHOLD)
            _same_answers(s.query(batch, threshold=THRESHOLD), want,
                          f"batch {size}, weighted {w}, cap {cap}")
            checked += 1
    batches = _query_batches(sample, 64)
    handles = [srv.query_async(b, threshold=THRESHOLD) for b in batches]
    for h, b in zip(handles, batches):
        _same_answers(srv.query_wait(h), host[False].query(
            b, threshold=THRESHOLD), "async batch of 64")
    print(f"device = host (rank-CSR walk) on {checked} batches of 1, 16, "
          f"64 and 256 (unweighted and BLOSUM62, caps 512, 1, 0) and "
          f"{len(batches)} async batches of 64 in flight", flush=True)

    # cli query --device cuda with --seq and --query-fasta
    qfasta = os.path.join(tmp, "queries.fasta")
    qrows = list(range(0, n, n // 62))[:62]
    with open(qfasta, "w") as f:
        for i in qrows:
            f.write(f">Q{i}|query\n{seqs[i]}\n")
    cli_seqs = [seqs[5], strangers[2]]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["query", os.path.join(tmp, "synth10619.fasta"),
                       "--device", dev.type, "--seq", cli_seqs[0], "--seq",
                       cli_seqs[1], "--query-fasta", qfasta])
    cli_s = time.perf_counter() - t0
    names = ["query0", "query1"] + [f"Q{i}|query" for i in qrows]
    qseqs = cli_seqs + [seqs[i] for i in qrows]
    lines = ["query\tprotein\tid\tamr_class\tshared_kmers"]
    for name, m in zip(names, host[False].query(qseqs,
                                                 threshold=THRESHOLD)):
        lines += [f"{name}\t{j}\t{table.ids[j]}\t{table.amr_classes[j]}\t{c}"
                  for j, c in m]
    if rc != 0 or buf.getvalue() != "\n".join(lines) + "\n":
        raise AssertionError("cli query's TSV differs from the host server")
    print(f"cli query --device {dev.type} --seq x2 --query-fasta (62): "
          f"{cli_s:.3f} s, {len(lines) - 1} TSV rows equal the host "
          f"server's", flush=True)

    # rates: sync queries/s by batch, the latency route, pipelining
    routed = q.QueryServer(index, bitset, mode="device", host_route_max=4,
                           device=dev)
    routed.query(seqs[:1], threshold=THRESHOLD)
    rates = {}
    for size in (1, 16, 64, 256):
        s, _ = best_seconds(lambda: srv.query(seqs[:size],
                                              threshold=THRESHOLD))
        rates[size] = size / s
    lat_dev, _ = best_seconds(lambda: srv.query(seqs[3:4],
                                                threshold=THRESHOLD), reps=5)
    lat_route, _ = best_seconds(lambda: routed.query(
        seqs[3:4], threshold=THRESHOLD), reps=5)
    pipe = _query_batches(seqs[:16 * 64], 64)

    def pipelined():
        hs = [srv.query_async(b, threshold=THRESHOLD) for b in pipe]
        return [srv.query_wait(h) for h in hs]

    pipe_s, _ = best_seconds(pipelined, reps=2, warmup=1)
    print(f"sync queries/s: " + ", ".join(
        f"batch {k} {v:.1f}" for k, v in rates.items())
        + f"; single query {lat_dev * 1e3:.3f} ms on the device, "
        f"{lat_route * 1e3:.3f} ms through the latency route (rank-CSR "
        f"walk); pipelined {len(pipe)} batches of 64 in flight "
        f"{len(pipe) * 64 / pipe_s:.1f} queries/s", flush=True)

    # per-layer device times of one batch of 256 (CUDA events)
    batch = seqs[:QUERY_BATCH]
    t0 = time.perf_counter()
    qwords = q.pack_query_bitsets(index, batch, bitset.w_pad)
    pack_ms = (time.perf_counter() - t0) * 1e3
    qp = srv._upload_queries(qwords, QUERY_BATCH)
    chunks = list(srv._blocks)
    unpack_ms = cuda_ms(lambda: [unpack_words_to_int8(c) for c in chunks],
                        reps=5)
    a_all = [unpack_words_to_int8(c) for c in chunks]
    q_all = [unpack_words_to_int8(qp[:, k0 : k0 + 128])
             for k0 in range(0, bitset.w_pad, 128)]
    mm_ms = cuda_ms(lambda: [int8_gemm(a, b) for a, b in zip(a_all, q_all)],
                    reps=5)
    del a_all, q_all
    ops = 2 * bitset.n_pad * QUERY_BATCH * bitset.w_pad * 32
    counts_ms = cuda_ms(lambda: srv._resident_counts(qp), reps=5)
    counts = srv._resident_counts(qp)
    epi_ms = cuda_ms(lambda: q.topk_epilogue(counts, THRESHOLD, n, 512),
                     reps=20)
    packed = q.topk_epilogue(counts, THRESHOLD, n, 512)
    torch.cuda.synchronize()
    fetch_s, _ = best_seconds(lambda: packed.cpu(), reps=5)
    print(f"one batch of {QUERY_BATCH} on the resident {N_PROTEINS} corpus "
          f"({bitset.w_pad // 128} chunks): host encode + pack "
          f"{pack_ms:.3f} ms; device: counts {counts_ms:.4f} ms = unpack "
          f"of the corpus {unpack_ms:.4f} + _int_mm products {mm_ms:.4f} "
          f"({ops / mm_ms / 1e9:.1f} TOP/s) + the rest; top-k epilogue "
          f"{epi_ms:.4f} ms; fetch of [{QUERY_BATCH}, 1025] lanes "
          f"{fetch_s * 1e3:.4f} ms", flush=True)
    del srv, servers, routed, counts, packed, chunks
    torch.cuda.empty_cache()

    # stream serving on the 30k corpus against a resident server
    table30, index30, bitset30 = state30
    batch = [table30.seq(i) for i in range(0, table30.n, 469)][:64]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    res30 = q.QueryServer(index30, bitset30, mode="device", device=dev)
    want = res30.query(batch, threshold=THRESHOLD)
    res_s, _ = best_seconds(lambda: res30.query(batch, threshold=THRESHOLD),
                            reps=2, warmup=0)
    peak30 = torch.cuda.max_memory_allocated() - base
    print(f"resident server {N_SCALE} (packed {bitset30.words.nbytes:,} "
          f"bytes): batch of 64 in {res_s:.3f} s; peak {peak30:,} bytes",
          flush=True)
    if peak30 > bitset30.words.nbytes * 1.25:
        raise AssertionError("the resident 30k server exceeds one corpus "
                             "copy by more than a quarter")
    del res30
    torch.cuda.empty_cache()
    stream_s = {}
    for source in ("host", "csr"):
        for sbs in (None, QUERY_STREAM_BS):
            t0 = time.perf_counter()
            s = q.QueryServer(index30, bitset30, mode="stream",
                              stream_source=source, stream_bs=sbs,
                              device=dev)
            set_up = time.perf_counter() - t0
            nbk = -(-bitset30.n_pad // s._stream_bs)
            _same_answers(s.query(batch, threshold=THRESHOLD), want,
                          f"stream {source} bs {s._stream_bs}")
            before = dict(s.stream_trace)
            sec, _ = best_seconds(lambda: s.query(batch,
                                                  threshold=THRESHOLD),
                                  reps=2, warmup=0)
            up = (s.stream_trace["upload_bytes"]
                  - before["upload_bytes"]) / 2
            stream_s[(source, s._stream_bs)] = sec
            print(f"stream {source} bs {s._stream_bs} ({nbk} blocks): "
                  f"set-up {set_up:.3f} s; a batch of 64 in {sec:.3f} s "
                  f"({64 / sec:.1f} queries/s), {up / 1e9:.3f} GB uploaded "
                  f"a batch; answers equal the resident server's",
                  flush=True)
            if sbs and nbk < 8:
                raise AssertionError(f"bs {sbs} gives {nbk} blocks")
            del s
            torch.cuda.empty_cache()
    launches = _zero_launches(fns, "query phase")
    print(f"query phase: kernel launches {launches}; "
          f"{time.perf_counter() - t_phase:.3f} s", flush=True)
    return launches


def index_phase(dev, tmp, state10, pairs10, want10, ns):
    """The device index build (docstring, phase 6): `cli run --index-engine
    device` on the 10,619 corpus against the scipy oracle, and the device
    index and bitset against the host build at k 5 and 7."""
    import numpy as np
    import torch

    from uniprot_kmer_based_clustering_tpu_torch import PipelineConfig
    from uniprot_kmer_based_clustering_tpu_torch import pipeline as pl

    t_phase = time.perf_counter()
    fasta = os.path.join(tmp, "synth10619.fasta")
    cli_run(dev, fasta, os.path.join(tmp, "out"),
            ["--index-engine", "device"], want10, pairs10,
            {"K1": ns, "K2": 0, "K3": 0, "K4": 0})
    table = state10[0]
    fns = reset_counters()
    for k in (5, 7):
        cfg = PipelineConfig(k=k)

        def host():
            codes, koff = pl.encode_kmers(table.seq_buf, table.offsets, k)
            index = pl.build_index(codes, koff, k)
            return index, pl.pack_bitsets(
                index.incidence_protein, index.incidence_rank, table.n,
                index.n_repeated, row_multiple=pl._row_multiple(cfg, table.n))

        host_s, (h_index, h_bitset) = best_seconds(host, reps=2, warmup=0)
        dev_s, (d_index, d_bitset) = best_seconds(
            lambda: pl._device_index(table, cfg, dev), reps=2, warmup=1)
        for f in ("codes", "doc_freq", "repeated_codes", "hash_doc_freq"):
            if not np.array_equal(getattr(d_index, f), getattr(h_index, f)):
                raise AssertionError(f"k={k}: device index {f} differs")
        if not np.array_equal(d_bitset.words, h_bitset.words):
            raise AssertionError(f"k={k}: device bitset differs")
        torch.cuda.synchronize()
        print(f"device index k={k}: {d_index.n_repeated} repeated, "
              f"bitset {d_bitset.words.shape[0]} x {d_bitset.words.shape[1]}"
              f" equal to the host build bit for bit; device index stage "
              f"{dev_s:.3f} s, host encode + index + pack {host_s:.3f} s",
              flush=True)
    launches = _zero_launches(fns, "device index")
    print(f"index phase: kernel launches in the direct builds {launches}; "
          f"{time.perf_counter() - t_phase:.3f} s", flush=True)
    return launches


N_SMALL = 2000  # the post-processing phase's scipy-transcription corpus
ALIGN_MAX_PAIRS = 500  # the alignment step's pair budget


# kernel launches of the post-processing phase's library steps, summed
POST_LAUNCHES = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}


def _library_step(what, fn):
    """fn() with every kernel counter set to 0 just before and required
    to be 0 just after (a library step of the post-processing phase),
    bracketed by synchronize(): (seconds, result)."""
    import torch

    fns = reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for k, v in _zero_launches(fns, what).items():
        POST_LAUNCHES[k] += v
    return seconds, out


def _tsv_labels(path):
    import numpy as np

    with open(path) as f:
        next(f)
        return np.array([int(line.split("\t")[3]) for line in f], np.int32)


def _tsv_merges(path):
    import numpy as np

    if not os.path.exists(path):  # no merge: the CLI writes no file
        return np.zeros((0, 3), np.int64)
    with open(path) as f:
        next(f)
        return np.array([[int(x) for x in line.split("\t")] for line in f],
                        np.int64).reshape(-1, 3)


def _same_clustering(what, got, labels, merges, rounds=None):
    import numpy as np

    if not (np.array_equal(got.labels, labels)
            and np.array_equal(got.merges, merges)
            and (rounds is None or got.rounds == rounds)):
        raise AssertionError(f"{what} differs from the cli run's clusters")


def _strip_budget(bitset):
    """A budget below the one-shot plan's, so the rounds go through the
    strips with a word chunk: 1 GiB, halved until it forces them."""
    from uniprot_kmer_based_clustering_tpu_torch.models import agglomerative

    budget = 1 << 30
    while agglomerative._argmax_plan(bitset.n_pad, bitset.w_pad,
                                     budget) is None:
        budget //= 2
    plan = agglomerative._argmax_plan(bitset.n_pad, bitset.w_pad, budget)
    if agglomerative._argmax_plan(bitset.n_pad, bitset.w_pad,
                                  13 << 30) is not None or not plan[1]:
        raise AssertionError(f"plans {plan} do not cover both paths")
    return budget, plan


def _agglomerative_checks(dev, label, fasta, state, out, want, want_pairs,
                          ns, scipy_ref=False):
    """`cli run --cluster agglomerative` (the strips' K1 and nothing
    else), then both library loops on the card, one-shot and strips,
    each equal to the cli run's clusters.tsv and dendrogram.tsv, and
    optionally to the scipy transcription. Returns the times."""
    import torch

    from uniprot_kmer_based_clustering_tpu_torch.models import agglomerative

    table, index, bitset = state
    n = table.n
    cli_run(dev, fasta, out, ["--cluster", "agglomerative"],
            want, want_pairs, {"K1": ns, "K2": 0, "K3": 0, "K4": 0})
    with open(os.path.join(out, "stats.json")) as f:
        stage_s = json.load(f)["timings_s"]["cluster"]
    labels = _tsv_labels(os.path.join(out, "clusters.tsv"))
    merges = _tsv_merges(os.path.join(out, "dendrogram.tsv"))
    torch.cuda.reset_peak_memory_stats(dev)
    dev_s, dres = _library_step(
        "agglomerative_cluster_device",
        lambda: agglomerative.agglomerative_cluster_device(bitset, n,
                                                           device=dev))
    dev_peak = torch.cuda.max_memory_allocated(dev)
    _same_clustering(f"{label}: agglomerative_cluster_device", dres, labels,
                     merges)
    budget, plan = _strip_budget(bitset)
    torch.cuda.reset_peak_memory_stats(dev)
    strip_s, sres = _library_step(
        "agglomerative_cluster (strips)",
        lambda: agglomerative.agglomerative_cluster(
            bitset, n, hbm_budget_bytes=budget, device=dev))
    strip_peak = torch.cuda.max_memory_allocated(dev)
    _same_clustering(f"{label}: strip mode", sres, labels, merges,
                     dres.rounds)
    line = (f"agglomerative {label}: {dres.rounds} rounds, {len(merges)} "
            f"merges, {len(set(labels.tolist()))} clusters; cli cluster "
            f"stage {stage_s:.4f} s; device loop {dev_s:.3f} s (peak "
            f"{dev_peak} bytes); strips {plan} under {budget} bytes "
            f"{strip_s:.3f} s (peak {strip_peak} bytes); equal")
    if scipy_ref:
        from uniprot_kmer_based_clustering_tpu_torch.benches.common import (
            scipy_agglomerative,
        )

        t0 = time.perf_counter()
        ref = scipy_agglomerative(index, n)
        ref_s = time.perf_counter() - t0
        _same_clustering(f"{label}: scipy transcription",
                         dres, ref[0], ref[1], ref[2])
        line += f"; scipy transcription {ref_s:.3f} s, equal"
    print(line, flush=True)
    return dict(stage_s=stage_s, device_s=dev_s, strip_s=strip_s,
                rounds=dres.rounds, merges=len(merges),
                clusters=len(set(labels.tolist())), peak=dev_peak)


def _round_times(dev, bitset, n):
    """Device ms of one agglomerative round on the full corpus, by layer
    (CUDA events): the unpack, the `_int_mm` product, the mask and
    argmax."""
    import torch

    from uniprot_kmer_based_clustering_tpu_torch.models import agglomerative
    from uniprot_kmer_based_clustering_tpu_torch.ops import bitmul
    from uniprot_kmer_based_clustering_tpu_torch.state import bitset_to_torch

    fns = reset_counters()
    sigs = bitset_to_torch(bitset, dev)
    n_pad = sigs.shape[0]
    active = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    active[:n] = True
    iota = torch.arange(n_pad, device=dev)
    a = bitmul.unpack_words_to_int8(sigs)
    counts = bitmul.int8_gemm(a, a)
    unpack_ms = cuda_ms(lambda: bitmul.unpack_words_to_int8(sigs), reps=5,
                        warmup=1)
    mm_ms = cuda_ms(lambda: bitmul.int8_gemm(a, a), reps=5, warmup=1)
    argmax_ms = cuda_ms(lambda: agglomerative._best_of(
        counts, active[None, :] & active[:, None]
        & (iota[:, None] != iota[None, :])), reps=5, warmup=1)
    ops = 2 * n_pad * n_pad * a.shape[1]
    del a, counts
    torch.cuda.empty_cache()
    _zero_launches(fns, "agglomerative round timing")
    print(f"agglomerative round at N_pad {n_pad} x K {bitset.w_pad * 32}: "
          f"unpack {unpack_ms:.4f} ms, _int_mm {mm_ms:.4f} ms "
          f"({ops / mm_ms / 1e9:.1f} TOP/s), mask + argmax {argmax_ms:.4f} "
          f"ms", flush=True)
    return dict(unpack_ms=unpack_ms, mm_ms=mm_ms, argmax_ms=argmax_ms)


def _no_diamond_path():
    """PATH without any directory that holds a diamond executable."""
    keep = [d for d in os.environ.get("PATH", "").split(os.pathsep)
            if not shutil.which("diamond", path=d)]
    return os.pathsep.join(keep)


def _host_align_reference(table, pairs, path):
    """The host DP's blastp_output.tsv (``align_pairs_sw`` with
    ``device_scores=False``); run in a worker process. Its seconds."""
    from uniprot_kmer_based_clustering_tpu_torch.align.sw_pairs import (
        align_pairs_sw,
    )

    t0 = time.perf_counter()
    align_pairs_sw(table, pairs, path, device_scores=False)
    return time.perf_counter() - t0


def _host_scores(table, pairs):
    """``sw_align_host``'s score of every (i, j) pair (query j, subject
    i, as ``align_pairs_sw`` aligns them); run in a worker process."""
    from uniprot_kmer_based_clustering_tpu_torch.align.sw_host import (
        sw_align_host,
    )
    from uniprot_kmer_based_clustering_tpu_torch.kmers.encode import (
        residues_to_indices,
    )

    res = residues_to_indices(table.seq_buf).astype("int32")
    off = table.offsets
    return [sw_align_host(res[off[j] : off[j + 1]], res[off[i] : off[i + 1]]).score
            for i, j in ((int(r[0]), int(r[1])) for r in pairs)]


def _align_checks(dev, tmp, fasta, state10, want10, pairs10, ns10):
    """Step d: T from the oracle's counts, `cli run --threshold T --align
    sw|auto|diamond` (no diamond on PATH) against the host DP's TSV, the
    device scores against the host DP's on every pair, the align stage's
    device and host seconds. The two host references run in two worker
    processes meanwhile. Returns (T, pairsT, wantT, times)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from uniprot_kmer_based_clustering_tpu_torch.align import (
        sw_pairs,
        sw_scores_device,
    )
    from uniprot_kmer_based_clustering_tpu_torch.kmers.encode import (
        residues_to_indices,
    )

    table = state10[0]
    counts = np.sort(pairs10[:, 2])[::-1]
    t = int(counts[ALIGN_MAX_PAIRS]) if len(counts) > ALIGN_MAX_PAIRS else 10
    pairs_t = pairs10[pairs10[:, 2] > t]
    want_t = dict(want10, pairs_over_threshold=len(pairs_t))
    print(f"alignment threshold T = {t}: {len(pairs_t)} oracle pairs with "
          f"count > T (T - 1 would give {(pairs10[:, 2] > t - 1).sum()})",
          flush=True)
    expect = {"K1": ns10, "K2": 0, "K3": 0, "K4": 0}
    ref = os.path.join(tmp, "blastp_host.tsv")
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=2, mp_context=spawn) as pool:
        ref_job = pool.submit(_host_align_reference, table, pairs_t, ref)
        scores_job = pool.submit(_host_scores, table, pairs_t)
        outs = {}
        path = os.environ.get("PATH", "")
        os.environ["PATH"] = _no_diamond_path()
        try:
            for mode in ("sw", "auto", "diamond"):
                outs[mode] = os.path.join(tmp, f"align_{mode}")
                cli_run(dev, fasta, outs[mode], ["--threshold", str(t),
                                                  "--align", mode],
                        want_t, pairs_t, expect)
        finally:
            os.environ["PATH"] = path
        # the align stage alone, then its device passes batch by batch
        stage_s, _ = _library_step(
            "align_pairs_sw", lambda: sw_pairs.align_pairs_sw(
                table, pairs_t, os.path.join(tmp, "blastp_dev.tsv"),
                device=dev))
        res = residues_to_indices(table.seq_buf).astype(np.int32)
        dev_s = 0.0
        shapes = []
        dev_scores = np.full(len(pairs_t), -1, np.int64)
        for sel, _, q_idx, q_len, s_idx, s_len, nv in sw_pairs._pair_batches(
                table, pairs_t, 512, res):
            s, _ = _library_step(
                "sw passes", lambda: sw_pairs.sw_ends_and_starts_device(
                    q_idx, q_len, s_idx, s_len, device=dev))
            dev_s += s
            shapes.append((nv, q_idx.shape[1], s_idx.shape[1]))
            _, scores = _library_step("sw scores", lambda: sw_scores_device(
                q_idx, q_len, s_idx, s_len, device=dev))
            dev_scores[sel] = scores[0][:nv]
        host_full_s = ref_job.result()
        host_scores = np.asarray(scores_job.result(), np.int64)
    if not np.array_equal(dev_scores, host_scores):
        bad = int(np.nonzero(dev_scores != host_scores)[0][0])
        raise AssertionError(f"sw_scores_device on pair {pairs_t[bad]}: "
                             f"{dev_scores[bad]} != host {host_scores[bad]}")
    with open(ref, "rb") as f:
        want = f.read()
    for mode, out in outs.items():
        with open(os.path.join(out, "blastp_output.tsv"), "rb") as f:
            if f.read() != want:
                raise AssertionError(f"--align {mode}: blastp_output.tsv "
                                     "differs from the host DP's")
    print(f"alignment of {len(pairs_t)} pairs: cli --align sw, auto and "
          f"diamond (no binary on PATH) byte-equal to the host DP's TSV "
          f"({host_full_s:.3f} s in a worker process); sw_scores_device = "
          f"sw_align_host on every pair (scores {host_scores.min()}.."
          f"{host_scores.max()}); align stage {stage_s:.3f} s = device "
          f"passes {dev_s:.3f} s over {len(shapes)} batches (real rows, Lq, "
          f"Ls) {shapes} + host {stage_s - dev_s:.3f} s (window tracebacks, "
          f"batching)", flush=True)
    return t, pairs_t, want_t, dict(stage_s=stage_s, device_s=dev_s,
                                    host_s=stage_s - dev_s,
                                    host_full_s=host_full_s,
                                    batches=shapes, threshold=t)


def _dump_checks(dev, tmp, fasta, state10, t, pairs_t, want_t, ns10):
    """Step e: the three dumps of `cli run --threshold T` with the host
    index and with --index-engine device, equal to each other and to the
    port's dump functions on the oracle's pairs."""
    from types import SimpleNamespace

    from uniprot_kmer_based_clustering_tpu_torch import cli

    names = ("pair_kmers.tsv", "proteins.tsv", "graph_debug.txt")
    flags = ["--threshold", str(t), "--dump-kmers", "--dump-proteins",
             "--dump-debug"]
    expect = {"K1": ns10, "K2": 0, "K3": 0, "K4": 0}
    files = {}
    for label, extra in (("host index", []),
                         ("device index", ["--index-engine", "device"])):
        out = os.path.join(tmp, "dump_" + label.split()[0])
        cli_run(dev, fasta, out, flags + extra, want_t, pairs_t, expect)
        files[label] = {}
        for name in names:
            with open(os.path.join(out, name), "rb") as f:
                files[label][name] = f.read()
    table, index, bitset = state10
    ref = os.path.join(tmp, "dump_ref")
    os.makedirs(ref)
    t0 = time.perf_counter()
    cli._write_dumps(
        SimpleNamespace(out=ref, dump_kmers=True, dump_proteins=True,
                        dump_debug=True),
        SimpleNamespace(table=table, index=index, bitset=bitset,
                        pairwise=SimpleNamespace(pairs=pairs_t)))
    ref_s = time.perf_counter() - t0
    for name in names:
        with open(os.path.join(ref, name), "rb") as f:
            want = f.read()
        for label in files:
            if files[label][name] != want:
                raise AssertionError(f"{name} of the {label} run differs")
    sizes = {k: len(v) for k, v in files["host index"].items()}
    print(f"dumps at T = {t}: the host-index and device-index runs and the "
          f"dump functions on the oracle's pairs give the same bytes "
          f"{sizes}; writing them {ref_s:.3f} s", flush=True)
    return ref_s


def post_phase(dev, tmp, state10, pairs10, want10, ns10, state30, pairs30):
    """Post-processing (docstring, phase 8) on the corpora the earlier
    phases built: components, agglomerative, tree, alignment, dumps."""
    import numpy as np
    import torch

    from uniprot_kmer_based_clustering_tpu_torch.models import (
        components,
        tree,
    )
    from uniprot_kmer_based_clustering_tpu_torch.ops.bitmul import (
        resolve_schedule,
    )

    t_phase = time.perf_counter()
    fasta10 = os.path.join(tmp, f"synth{N_PROTEINS}.fasta")
    times = {}
    # a. components
    for label, state, pairs in ((N_PROTEINS, state10, pairs10),
                                (N_SCALE, state30, pairs30)):
        n = state[0].n
        t0 = time.perf_counter()
        host = components.connected_components(n, pairs)
        host_s = time.perf_counter() - t0
        # the second call is timed: the first one pays the launches' and
        # the allocator's start-up
        for _ in range(2):
            dev_s, got = _library_step(
                "connected_components_device",
                lambda: components.connected_components_device(
                    pairs[:, 0], pairs[:, 1], n=n, device=dev))
        _, (labels, rounds) = _library_step(
            "label propagation", lambda: components._propagate_labels(
                torch.from_numpy(pairs[:, 0]).to(dev),
                torch.from_numpy(pairs[:, 1]).to(dev), n))
        if not (np.array_equal(got, host)
                and np.array_equal(labels.cpu().numpy(), host)):
            raise AssertionError(f"{label}: device components differ")
        print(f"components {label} ({len(pairs)} pairs): device "
              f"{dev_s:.4f} s, {rounds} rounds; host union-find "
              f"{host_s:.4f} s; {len(np.unique(host))} components, equal",
              flush=True)
        times[f"components_{label}"] = (dev_s, rounds, host_s)

    # b. agglomerative, 10,619 and the 2,000-protein corpus
    small = os.path.join(tmp, f"synth{N_SMALL}.fasta")
    write_fasta(small, N_SMALL)
    state2 = host_state(small)
    want2, pairs2 = oracle(state2, f"{N_SMALL}")
    ns2 = resolve_schedule(state2[2].n_pad, 512)[2]
    times["round"] = _round_times(dev, state10[2], state10[0].n)
    times["agg10"] = _agglomerative_checks(
        dev, f"{N_PROTEINS}", fasta10, state10, os.path.join(tmp, "agg10"),
        want10, pairs10, ns10)
    times["agg2"] = _agglomerative_checks(
        dev, f"{N_SMALL}", small, state2, os.path.join(tmp, "agg2"), want2,
        pairs2, ns2, scipy_ref=True)

    # c. tree, 2,000 proteins
    out = os.path.join(tmp, "tree2")
    cli_run(dev, small, out, ["--cluster", "tree"], want2, pairs2,
            {"K1": ns2, "K2": 0, "K3": 0, "K4": 0})
    with open(os.path.join(out, "stats.json")) as f:
        tree_s = json.load(f)["timings_s"]["cluster"]
    saved = tree._native_rows
    tree._native_rows = None
    try:
        numpy_s, want = _library_step("tree (numpy)", lambda: (
            tree.cluster_tree_labels(state2[2], N_SMALL)))
    finally:
        tree._native_rows = saved
    if not np.array_equal(_tsv_labels(os.path.join(out, "clusters.tsv")),
                          want):
        raise AssertionError("cli run --cluster tree differs from the tree")
    print(f"tree {N_SMALL}: cli cluster stage {tree_s:.4f} s (native AND + "
          f"popcount), numpy path {numpy_s:.3f} s, {len(np.unique(want))} "
          f"clusters, equal", flush=True)
    times["tree"] = (tree_s, numpy_s)

    # d. alignment, e. dumps, 10,619 proteins at T
    t, pairs_t, want_t, times["align"] = _align_checks(
        dev, tmp, fasta10, state10, want10, pairs10, ns10)
    times["dumps_s"] = _dump_checks(dev, tmp, fasta10, state10, t, pairs_t,
                                    want_t, ns10)
    times["phase_s"] = time.perf_counter() - t_phase
    print(f"post-processing phase: every cli run launched K1 once a strip "
          f"and no other kernel; library steps {POST_LAUNCHES}; "
          f"{times['phase_s']:.3f} s", flush=True)
    return times


MESH_D = 4  # shards of the 30k ring, all on the one card
MESH_DS = (1, 2, 3, 8)  # shards of the 10,619 rings


def _ring_counts(words, sub, wc):
    """The counts of one ring sub-step from the whole matrix on the card
    (stationary rows against the moving rows it holds)."""
    from uniprot_kmer_based_clustering_tpu_torch.ops import bitmul

    return bitmul.counts_window_pair(
        words[sub.gi0 : sub.gi0 + sub.rows],
        words[sub.gj0 : sub.gj0 + sub.cols], word_chunk=wc)


def _k1_ring_block(dev, label, words, classes, n, sub, wc, real=False):
    """K1 at the ring's fake offsets (``real``: at the block's own global
    offsets and ``n``, as a k-axis strip runs it) on one sub-step's
    counts, against its plain version at the same offsets and against
    the plain masked statistics at the real global indices (gi < n,
    gj < n, and gi < gj on a diagonal strip); then its kernel-only time
    (L2 cold), its back-to-back call, the plain version and the
    needed-bytes bound of what it is given (every count of the block at
    those offsets)."""
    import torch

    from uniprot_kmer_based_clustering_tpu_torch.ops import stats
    from uniprot_kmer_based_clustering_tpu_torch.parallel import sharded

    counts = _ring_counts(words, sub, wc)
    ca = classes[sub.gi0 : sub.gi0 + sub.rows]
    cb = classes[sub.gj0 : sub.gj0 + sub.cols]
    i_off, j_off = ((sub.gi0, sub.gj0) if real
                    else sharded.fake_offsets(sub))
    n_k1 = n if real else sharded.FAKE_N
    kw = dict(i_off=i_off, j_off=j_off, n=n_k1, threshold=THRESHOLD,
              tile=128)
    nbi, nbj = sub.rows // 128, sub.cols // 128

    def fresh():
        return (torch.empty((sub.rows, 8), dtype=torch.int32, device=dev),
                torch.zeros((nbi, nbj, 2), dtype=torch.int32, device=dev))

    rs, bh = fresh()
    stats.stats_from_counts_into(counts, ca, cb, rs, bh, **kw)
    rs_p, bh_p = fresh()
    stats.stats_from_counts_into_reference(counts, ca, cb, rs_p, bh_p, **kw)
    gi = torch.arange(sub.gi0, sub.gi0 + sub.rows, device=dev)[:, None]
    gj = torch.arange(sub.gj0, sub.gj0 + sub.cols, device=dev)[None, :]
    valid = (gi < n) & (gj < n)
    if sub.triangle:
        valid &= gi < gj
    cross = valid & (ca[:, None] != cb[None, :])
    rs_r, over_c, over_s = stats.stack_row_stats(counts, cross,
                                                 valid & ~cross, THRESHOLD)
    shape = (nbi, 128, nbj, 128)
    bh_r = torch.stack([over_c.reshape(shape).sum((1, 3)),
                        over_s.reshape(shape).sum((1, 3))], -1).int()
    torch.cuda.synchronize()
    err = max(max_abs_err(rs, rs_p), max_abs_err(bh, bh_p),
              max_abs_err(rs, rs_r), max_abs_err(bh, bh_r))
    out_rs, out_bh = fresh()

    def launch():
        stats.stats_from_counts_into(counts, ca, cb, out_rs, out_bh, **kw)

    def plain():
        stats.stats_from_counts_into_reference(counts, ca, cb, out_rs,
                                               out_bh, **kw)

    bound = epilogue_bound_ms(sub.rows, sub.cols, i_off, j_off, n_k1,
                              sub.rows * 8 + nbi * nbj * 2)
    t = dict(err=err, ms=kernel_only_ms(launch), call_ms=cuda_ms(launch),
             plain_ms=cuda_ms(plain, reps=5, warmup=1), bound_ms=bound)
    print(f"K1 on the {label} (rows {sub.gi0}.., columns {sub.gj0}.., "
          f"[{sub.rows}, {sub.cols}], offsets ({i_off}, {j_off}), n {n_k1}): "
          f"max_abs_err {err} against its plain version and against the "
          f"plain statistics at the real indices (tolerance {TOL}), "
          f"{int(bh.sum())} tile hits; kernel-only {t['ms']:.4f} ms (L2 "
          f"cold), bound {bound:.4f} ms (needed bytes), share "
          f"{bound / t['ms']:.3f}; back-to-back call {t['call_ms']:.4f} ms; "
          f"plain torch {t['plain_ms']:.4f} ms", flush=True)
    if err > TOL:
        raise AssertionError(f"K1 on the {label} disagrees")
    return t


def _pair_keys(rows):
    import numpy as np

    rows = np.asarray(rows, np.int64)
    return rows[:, 0] * (1 << 32) + rows[:, 1]


def _k1_ring_append(dev, label, words, classes, n, sub, wc, want_pairs):
    """K1's survivor append on one ring sub-step's counts, as the mesh's
    sweep launches it under ``extract="auto"``: at the ring's fake
    offsets, storing from the sub-step's pair origin (gi0, gj0),
    transposed on a wrapped block pair. With room for every survivor it
    must store what ``append_survivors_reference`` stores (cursor,
    triples, untouched slots), every pair (min, max) and in the oracle's
    list ``want_pairs`` with its count, and leave the row stats and tile
    hits of K1 without the append. Then, in turns, the kernel-only (L2
    cold; the cursor reset before each launch) and back-to-back times of
    K1 without and with the append, and the needed-bytes bound of the
    append's launch (K1's, plus 12 B a survivor and the cursor's 8)."""
    import numpy as np
    import torch

    from uniprot_kmer_based_clustering_tpu_torch.ops import stats
    from uniprot_kmer_based_clustering_tpu_torch.ops.pairlist import (
        new_pair_buffers,
    )
    from uniprot_kmer_based_clustering_tpu_torch.parallel import sharded

    counts = _ring_counts(words, sub, wc)
    ca = classes[sub.gi0 : sub.gi0 + sub.rows]
    cb = classes[sub.gj0 : sub.gj0 + sub.cols]
    i_off, j_off = sharded.fake_offsets(sub)
    kw = dict(i_off=i_off, j_off=j_off, n=sharded.FAKE_N,
              threshold=THRESHOLD)
    app = dict(include_same=False, pair_origin=(sub.gi0, sub.gj0),
               transposed=sub.transposed)
    nbi, nbj = sub.rows // 128, sub.cols // 128

    def fresh():
        return (torch.empty((sub.rows, 8), dtype=torch.int32, device=dev),
                torch.zeros((nbi, nbj, 2), dtype=torch.int32, device=dev))

    m = int(stats.survivor_mask(counts, ca, cb, i_off, j_off,
                                n=sharded.FAKE_N, threshold=THRESHOLD,
                                include_same=False).sum())
    ref = new_pair_buffers(m + 7, dev)
    stats.append_survivors_reference(counts, ca, cb, ref, **kw, **app)
    room = new_pair_buffers(m + 7, dev)
    rs, bh = fresh()
    stats.stats_from_counts_into(counts, ca, cb, rs, bh, tile=128,
                                 pairs=room, **kw, **app)
    rs0, bh0 = fresh()
    stats.stats_from_counts_into(counts, ca, cb, rs0, bh0, tile=128, **kw)
    torch.cuda.synchronize()
    want = _sorted_pair_rows(*(t[:m] for t in ref[:3]))
    got = _sorted_pair_rows(*(t[:m] for t in room[:3]))
    oracle_keys = _pair_keys(want_pairs)
    at = np.minimum(np.searchsorted(oracle_keys, _pair_keys(got)),
                    max(len(want_pairs) - 1, 0))
    checks = {
        "survivors": m > 0,
        "cursor = survivors": int(room[3]) == int(ref[3]) == m,
        "stored = plain append": np.array_equal(got, want),
        "unused slots untouched": bool((room[2][m:] == -1).all()),
        "(min, max)": bool((got[:, 0] < got[:, 1]).all()),
        "in the oracle's list": bool(
            np.array_equal(oracle_keys[at], _pair_keys(got))
            and np.array_equal(np.asarray(want_pairs)[at, 2], got[:, 2])),
        "row stats and tile hits = K1 without the append": (
            torch.equal(rs, rs0) and torch.equal(bh, bh0)),
    }
    out_rs, out_bh = fresh()
    timed = new_pair_buffers(24 * m + 1, dev)

    def plain_k1():
        stats.stats_from_counts_into(counts, ca, cb, out_rs, out_bh,
                                     tile=128, **kw)

    def append_k1():
        stats.stats_from_counts_into(counts, ca, cb, out_rs, out_bh,
                                     tile=128, pairs=timed, **kw, **app)

    def reset():
        timed[3].zero_()

    plain_ms = kernel_only_ms(plain_k1)
    ms = kernel_only_ms(append_k1, prepare=reset)
    plain_call_ms = cuda_ms(plain_k1)
    reset()
    call_ms = cuda_ms(append_k1)  # 23 calls: room for every survivor
    out_ints = sub.rows * 8 + nbi * nbj * 2
    plain_bound = epilogue_bound_ms(sub.rows, sub.cols, i_off, j_off,
                                    sharded.FAKE_N, out_ints)
    bound = epilogue_bound_ms(sub.rows, sub.cols, i_off, j_off,
                              sharded.FAKE_N, out_ints + 3 * m + 2)
    print(f"K1's append on the {label} (rows {sub.gi0}.., columns "
          f"{sub.gj0}.., [{sub.rows}, {sub.cols}], offsets ({i_off}, "
          f"{j_off}), origin ({sub.gi0}, {sub.gj0}), transposed "
          f"{sub.transposed}; {m} survivors): {checks}; kernel-only "
          f"{ms:.4f} ms (L2 cold), bound {bound:.4f} ms (needed bytes), "
          f"share {bound / ms:.3f}; back-to-back call {call_ms:.4f} ms; "
          f"without the append kernel-only {plain_ms:.4f} ms, bound "
          f"{plain_bound:.4f} ms, call {plain_call_ms:.4f} ms "
          f"({ms / plain_ms:.3f}x)", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"K1's append on the {label} disagrees")
    return dict(survivors=m, ms=ms, call_ms=call_ms, bound_ms=bound,
                plain_ms=plain_ms, plain_call_ms=plain_call_ms,
                plain_bound_ms=plain_bound)


N_FIT = 2000  # a corpus whose survivors fit one card's appended slots


def _appended_mesh_runs(dev, tmp):
    """``run_pipeline`` with the default extraction at ``N_FIT`` proteins
    on flat D = 4, 2 × 2 and k axis D = 4 meshes of this card: the one
    pass's appended pairs, with no second pass, against the oracle."""
    import numpy as np
    import torch

    from uniprot_kmer_based_clustering_tpu_torch import PipelineConfig
    from uniprot_kmer_based_clustering_tpu_torch.ops.pairlist import (
        EPILOGUE_PAIR_CAP,
    )
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        count_kaxis_strips,
        count_substeps,
        count_substeps_2d,
        make_mesh,
        make_mesh_2d,
        pad_for_mesh,
        sharded,
    )
    from uniprot_kmer_based_clustering_tpu_torch.pipeline import run_pipeline

    fasta = os.path.join(tmp, f"synth{N_FIT}.fasta")
    write_fasta(fasta, N_FIT)
    state = host_state(fasta)
    want, want_pairs = oracle(state, f"{N_FIT}")
    if len(want_pairs) > EPILOGUE_PAIR_CAP:
        raise AssertionError(f"{len(want_pairs)} survivors at {N_FIT} "
                             f"pass a card's {EPILOGUE_PAIR_CAP} slots")
    n_pad = pad_for_mesh(state[2].n_pad, 4, 128)
    meshes = {
        "flat D=4": (make_mesh(devices=[dev] * 4),
                     count_substeps(4, n_pad)),
        "2d 2x2": (make_mesh_2d(2, 2, devices=[dev] * 4),
                   count_substeps_2d(2, 2, n_pad)),
        "kaxis D=4": (make_mesh(devices=[dev] * 4, axis="k"),
                      count_kaxis_strips(4, n_pad)),
    }
    out = {}
    for name, (mesh, steps) in meshes.items():
        fns = reset_counters()
        t0 = time.perf_counter()
        res = run_pipeline(fasta, PipelineConfig(), mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in fns.items()}
        trace = dict(sharded.last_trace)
        got = {k: res.parity_report()[k] for k in want}
        checks = {
            "pairs = oracle": np.array_equal(res.pairwise.pairs,
                                             want_pairs),
            "parity = oracle": got == want,
            "launches": launches == {"K1": steps, "K2": 0, "K3": 0,
                                     "K4": 0},
            "one pass": trace["substeps"] == steps,
            "second_passes 0": trace["second_passes"] == 0,
            "epilogue_pairs = pairs": (trace["epilogue_pairs"]
                                       == trace["pairs"]
                                       == len(want_pairs)),
        }
        print(f"run_pipeline(mesh={name}) auto at {N_FIT} proteins: "
              f"{wall:.3f} s; launches {launches}; trace {trace}; checks "
              f"{checks}", flush=True)
        if not all(checks.values()):
            raise AssertionError(f"auto at {N_FIT} on {name}: {checks}")
        out[name] = dict(wall=wall, trace=trace)
    return out


def _doc_freq_inputs(dev, table, multiple):
    """Window codes and validity [N', L-4] of the corpus on the card, rows
    padded to a multiple of ``multiple`` with invalid windows."""
    import numpy as np
    import torch

    from uniprot_kmer_based_clustering_tpu_torch.kmers.encode import (
        encode_kmers_device,
        residues_to_indices,
    )

    lengths = table.lengths.astype(np.int32)
    n_rows = -(-table.n // multiple) * multiple
    mat = np.zeros((n_rows, int(lengths.max())), np.int32)
    res = residues_to_indices(table.seq_buf).astype(np.int32)
    starts = np.asarray(table.offsets[:-1], np.int64)
    rows = np.repeat(np.arange(table.n, dtype=np.int64), lengths)
    mat[rows, np.arange(res.shape[0]) - np.repeat(starts, lengths)] = res
    full = np.zeros(n_rows, np.int32)
    full[: table.n] = lengths
    return encode_kmers_device(torch.from_numpy(mat).to(dev),
                               torch.from_numpy(full).to(dev), 5)


def mesh_phase(dev, tmp, state10, pairs10, run30, state30, pairs30, scan_s,
               smi):
    """The flat row ring (docstring, phase 9) on meshes whose shards share
    the one card."""
    import numpy as np
    import torch

    from uniprot_kmer_based_clustering_tpu_torch import PipelineConfig
    from uniprot_kmer_based_clustering_tpu_torch.models.components import (
        connected_components,
    )
    from uniprot_kmer_based_clustering_tpu_torch.ops import bitmul
    from uniprot_kmer_based_clustering_tpu_torch.ops.pairlist import (
        append_window,
    )
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        count_substeps,
        doc_freq_psum,
        make_mesh,
        pad_for_mesh,
        sharded,
        sharded_extract_pairs,
        sharded_pairwise_fused,
        sharded_pairwise_similarity,
        stage_mesh_inputs,
        stage_mesh_inputs_csr,
    )
    from uniprot_kmer_based_clustering_tpu_torch.pipeline import run_pipeline
    from uniprot_kmer_based_clustering_tpu_torch.state import (
        bitset_to_torch,
        classes_to_torch,
    )

    t_phase = time.perf_counter()
    print(f"mesh phase on {smi}: every mesh's shards share this one card, "
          f"so their launches queue on one stream and a ring's time is the "
          f"sum over its shards (no scaling figure)", flush=True)
    table30, _, bitset30 = state30
    n30 = table30.n
    want30 = run30["want"]
    n_pad30 = pad_for_mesh(bitset30.n_pad, MESH_D, 128)
    block30 = n_pad30 // MESH_D
    steps30 = count_substeps(MESH_D, n_pad30)
    wc30 = sharded.ring_word_chunk(block30, bitset30.w_pad)
    corpus = bitset30.n_pad * bitset30.w_pad * 4
    print(f"{N_SCALE} on a D={MESH_D} mesh: N_pad {n_pad30}, {block30} rows "
          f"a shard ({corpus // MESH_D} bytes), {steps30} sub-steps a pass, "
          f"word chunk {wc30} of {bitset30.w_pad} words", flush=True)
    # the peak a 30k ring pass may reach: the stationary shards, the D
    # moving copies, and one sub-step's working set (the two unpacked
    # operand chunks, the counts and one chunk's partial counts, one
    # compaction window at 64 bytes a lane, and each shard's pair-buffer
    # slack of one window at 12 bytes a lane)
    window = append_window(block30)
    step_bytes = (sharded.RING_UNPACK_BYTES + 2 * 4 * block30 * block30
                  + 64 * window + MESH_D * 12 * window)
    mem_limit = 2 * corpus + step_bytes
    t0 = time.perf_counter()
    labels30 = connected_components(n30, pairs30)
    print(f"host union-find on the oracle's pairs "
          f"{time.perf_counter() - t0:.3f} s; peak memory limit of a pass "
          f"{mem_limit} bytes (2 x {corpus} + {step_bytes})", flush=True)
    mesh4 = make_mesh(devices=[dev] * MESH_D)
    want_launches = {"K1": steps30, "K2": 0, "K3": 0, "K4": 0}
    runs = {}
    for name, cfg in (
        ("auto", PipelineConfig()),
        ("fused", PipelineConfig(extract="fused")),
    ):
        fns = reset_counters()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = run_pipeline(run30["fasta"], cfg, mesh=mesh4)
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in fns.items()}
        peak = torch.cuda.max_memory_allocated(dev)
        got = {k: res.parity_report()[k] for k in want30}
        print(f"run_pipeline(mesh=D{MESH_D}) {name}: {wall:.3f} s; kernel "
              f"launches {launches}; parity {got}, pairs "
              f"{len(res.pairwise.pairs)}, clusters "
              f"{res.cluster_summary()}; peak device memory {peak} bytes; "
              f"stage seconds {json.dumps(res.timings)}", flush=True)
        if launches != want_launches:
            raise AssertionError(f"mesh {name}: launches {launches}, "
                                 f"expected {want_launches}")
        if got != want30:
            raise AssertionError(f"mesh {name}: parity {got} != {want30}")
        if not np.array_equal(res.pairwise.pairs, pairs30):
            raise AssertionError(f"mesh {name}: pairs differ from the oracle")
        if not np.array_equal(res.cluster_labels, labels30):
            raise AssertionError(f"mesh {name}: labels differ from the "
                                 f"union-find's")
        if peak > mem_limit:
            raise AssertionError(f"mesh {name}: peak {peak} bytes over "
                                 f"{mem_limit}")
        runs[name] = dict(wall=wall, peak=peak, timings=res.timings)
        del res
    if len(pairs30) > 1 << 20:
        print(f"(the fused run's default cap 1,048,576 is below the "
              f"{len(pairs30)} pairs, so, as in the JAX package, it "
              f"extracted again after its pass)", flush=True)

    # warm library passes on staged shards; the kernel counters are set
    # to 0 before, and read after, every call
    cls30 = np.full(n_pad30, -1, np.int32)
    cls30[:n30] = table30.amr_class_ids
    t0 = time.perf_counter()
    words_s, classes_s = stage_mesh_inputs(mesh4, bitset30.words, cls30)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    total = len(pairs30)
    counted = {}

    def count(name, fn):
        def run():
            fns = reset_counters()
            out = fn()
            counted.setdefault(name, []).append(
                {k: f.launches for k, f in fns.items()})
            return out
        return run

    torch.cuda.reset_peak_memory_stats(dev)
    sweep_s, (rs, th, _) = best_seconds(count(
        "sweep", lambda: sharded_pairwise_similarity(
            mesh4, words_s, classes_s, n30, THRESHOLD)),
        reps=2, warmup=1)
    peak_sweep = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ext_s, pairs = best_seconds(count(
        "extraction", lambda: sharded_extract_pairs(
            mesh4, words_s, classes_s, n30, THRESHOLD,
            cap=max(1 << 18, total), expected_total=total)),
        reps=2, warmup=1)
    peak_ext = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fused_s, fused = best_seconds(count(
        "fused", lambda: sharded_pairwise_fused(
            mesh4, words_s, classes_s, n30, THRESHOLD, cap=1 << 21)),
        reps=2, warmup=1)
    peak_fused = torch.cuda.max_memory_allocated(dev)
    if max(peak_sweep, peak_ext, peak_fused) > mem_limit:
        raise AssertionError("a warm 30k ring pass went over the peak "
                             "memory limit")
    if not (np.array_equal(pairs, pairs30)
            and np.array_equal(fused[3], pairs30)
            and np.array_equal(fused[0], rs) and np.array_equal(fused[1], th)
            and int(th[:, 0].sum()) == total):
        raise AssertionError("warm 30k ring passes differ from the oracle")
    pair_count = n30 * (n30 - 1) // 2
    print(f"{N_SCALE} D={MESH_D} warm ring (best of 2 after a warm-up): "
          f"staging {stage_s:.6f} s; sweep {sweep_s:.6f} s = "
          f"{pair_count / sweep_s:.6e} pairs/s (in-core scan "
          f"{scan_s:.6f} s, ratio {sweep_s / scan_s:.3f}), peak "
          f"{peak_sweep} bytes; extraction {ext_s:.6f} s, peak {peak_ext} "
          f"bytes; fused pass (cap 2^21, no second pass) {fused_s:.6f} s, "
          f"peak {peak_fused} bytes; corpus {corpus} bytes", flush=True)
    del fused, pairs

    # the packless staging: each shard built on the card from the
    # incidence lists, equal to the packed shards, then swept and
    # extracted
    index30 = state30[1]
    t0 = time.perf_counter()
    words_c, classes_c = stage_mesh_inputs_csr(
        mesh4, index30.incidence_protein, index30.incidence_rank, n_pad30,
        bitset30.w_pad, table30.amr_class_ids)
    torch.cuda.synchronize()
    stage_csr_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(words_c, words_s)) and all(
        torch.equal(a, b) for a, b in zip(classes_c, classes_s))
    del words_s, classes_s
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    rs_c, th_c, _ = count("packless sweep", lambda: (
        sharded_pairwise_similarity(mesh4, words_c, classes_c, n30,
                                    THRESHOLD)))()
    pairs_c = count("packless extraction", lambda: sharded_extract_pairs(
        mesh4, words_c, classes_c, n30, THRESHOLD,
        cap=max(1 << 18, total), expected_total=total))()
    packless_s = time.perf_counter() - t0
    peak_csr = torch.cuda.max_memory_allocated(dev)
    print(f"packless staging (stage_mesh_inputs_csr) {stage_csr_s:.6f} s, "
          f"shards = the packed staging's {same}; its sweep + extraction "
          f"{packless_s:.6f} s (single calls), peak {peak_csr} bytes",
          flush=True)
    if not (same and np.array_equal(rs_c, rs) and np.array_equal(th_c, th)
            and np.array_equal(pairs_c, pairs30) and peak_csr <= mem_limit):
        raise AssertionError("the packless staging's ring differs from "
                             "the oracle or went over the memory limit")
    del words_c, classes_c
    want_k1 = {"sweep": steps30, "extraction": 0, "fused": steps30,
               "packless sweep": steps30, "packless extraction": 0}
    ring_launches = {}
    for name, logs in counted.items():
        for got in logs:
            if got != {"K1": want_k1[name], "K2": 0, "K3": 0, "K4": 0}:
                raise AssertionError(f"warm ring {name}: launches {got}, "
                                     f"expected K1 = {want_k1[name]} and "
                                     f"no other kernel")
        ring_launches[name] = logs[-1]["K1"]
    print(f"K1 launches of each warm 30k D={MESH_D} call (counters reset "
          f"before each): {ring_launches}", flush=True)

    # K1 on the ring's own blocks: a wrapped block pair and a diagonal strip
    words30 = bitset_to_torch(bitset30, dev)
    classes30 = classes_to_torch(table30.amr_class_ids, n_pad30, dev)
    wrapped = sharded.ring_substeps(1, MESH_D, MESH_D - 1, block30, 128)[0]
    strip = sharded.ring_substeps(0, MESH_D, 1, block30, 128)[0]
    k1 = _k1_ring_block(dev, "ring's wrapped block pair", words30,
                        classes30, n30, wrapped, wc30)
    k1_strip = _k1_ring_block(dev, "ring's diagonal strip", words30,
                              classes30, n30, strip, wc30)
    del words30, classes30

    # b. 10,619 proteins at D = 1, 2, 3, 8
    table10, index10, bitset10 = state10
    n10 = table10.n
    words10 = bitset_to_torch(bitset10, dev)
    classes10 = classes_to_torch(table10.amr_class_ids, bitset10.n_pad, dev)
    rs_mxu, th_mxu, _ = bitmul.sweep_mxu(words10, classes10, n10, THRESHOLD)
    codes, valid = _doc_freq_inputs(dev, table10, 24)
    ref_totals = None
    for d in MESH_DS:
        mesh = make_mesh(devices=[dev] * d)
        n_pad = pad_for_mesh(bitset10.n_pad, d, 128)
        words = np.zeros((n_pad, bitset10.w_pad), np.uint32)
        words[: bitset10.n_pad] = bitset10.words
        cls = np.full(n_pad, -1, np.int32)
        cls[:n10] = table10.amr_class_ids
        ws, cs = stage_mesh_inputs(mesh, words, cls)
        fns = reset_counters()
        t0 = time.perf_counter()
        rs, th, _ = sharded_pairwise_similarity(mesh, ws, cs, n10, THRESHOLD)
        t_sweep = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in fns.items()}
        t0 = time.perf_counter()
        pairs = sharded_extract_pairs(mesh, ws, cs, n10, THRESHOLD)
        t_ext = time.perf_counter() - t0
        t0 = time.perf_counter()
        fused = sharded_pairwise_fused(mesh, ws, cs, n10, THRESHOLD)
        t_fused = time.perf_counter() - t0
        freq = doc_freq_psum(mesh, codes, valid, 5)
        totals = (rs[:, [0, 1, 2, 4, 5, 6]].sum(0), rs[:, [3, 7]].max(0),
                  th.sum(0))
        if ref_totals is None:
            ref_totals = totals
        mxu = (rs_mxu[:, [0, 1, 2, 4, 5, 6]].sum(0), rs_mxu[:, [3, 7]].max(0),
               th_mxu.sum(0))
        dense = freq.cpu().numpy()
        checks = {
            "launches": launches == {"K1": count_substeps(d, n_pad),
                                     "K2": 0, "K3": 0, "K4": 0},
            "totals = D1": all(np.array_equal(a, b)
                               for a, b in zip(totals, ref_totals)),
            "totals = sweep_mxu": all(np.array_equal(a, b)
                                      for a, b in zip(totals, mxu)),
            "rows = sweep_mxu": d != 1 or np.array_equal(rs, rs_mxu),
            "extract = oracle": np.array_equal(pairs, pairs10),
            "fused = oracle": np.array_equal(fused[3], pairs10)
            and np.array_equal(fused[0], rs) and np.array_equal(fused[1], th),
            "doc_freq = host": np.array_equal(dense[index10.codes],
                                              index10.doc_freq)
            and int(dense.sum()) == int(index10.doc_freq.sum()),
        }
        print(f"{N_PROTEINS} D={d} (N_pad {n_pad}): sweep {t_sweep:.4f} s, "
              f"extraction {t_ext:.4f} s, fused {t_fused:.4f} s (single "
              f"calls); launches {launches}; {len(pairs)} pairs; checks "
              f"{checks}", flush=True)
        if not all(checks.values()):
            raise AssertionError(f"10,619 ring at D={d}: {checks}")
        del ws, cs, fused
    del codes, valid

    # K1's append on the 10,619 four-shard ring's own sub-steps, as
    # extract="auto" launches it
    n_pad4 = pad_for_mesh(bitset10.n_pad, MESH_D, 128)
    block4 = n_pad4 // MESH_D
    words4 = torch.zeros((n_pad4, words10.shape[1]), dtype=words10.dtype,
                         device=dev)
    words4[: words10.shape[0]] = words10
    classes4 = classes_to_torch(table10.amr_class_ids, n_pad4, dev)
    del words10, classes10
    wc4 = sharded.ring_word_chunk(block4, bitset10.w_pad)
    appends = {}
    for label, (s, d) in (
        ("diagonal strip", (0, 1)),
        ("plain block pair", (1, 0)),
        ("wrapped block pair", (1, MESH_D - 1)),
    ):
        sub = sharded.ring_substeps(s, MESH_D, d, block4, 128)[0]
        appends[label] = _k1_ring_append(
            dev, f"10,619 D={MESH_D} ring's {label}", words4, classes4,
            n10, sub, wc4, pairs10)
    del words4, classes4
    fit = _appended_mesh_runs(dev, tmp)

    # no fallback: --devices 2 where the machine has fewer cards
    out = os.path.join(tmp, "mesh_refused")
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.cli", "run", run30["fasta10"],
         "--device", "cuda", "--devices", str(torch.cuda.device_count() + 1),
         "--out", out],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    msg = proc.stderr.strip().splitlines()[-1] if proc.stderr else ""
    want_msg = (f"requested {torch.cuda.device_count() + 1} devices, only "
                f"{torch.cuda.device_count()} available")
    print(f"cli run --device cuda --devices "
          f"{torch.cuda.device_count() + 1}: exit {proc.returncode}, "
          f"stderr {msg!r}, output written: {os.path.exists(out)}",
          flush=True)
    if proc.returncode == 0 or want_msg not in msg or os.path.exists(out):
        raise AssertionError("--devices beyond the visible cards did not "
                             "fail loudly")
    if torch.cuda.device_count() > 1:
        cls = np.full(bitset10.n_pad, -1, np.int32)
        cls[:n10] = table10.amr_class_ids
        pairs = sharded_extract_pairs(make_mesh(2), bitset10.words, cls, n10,
                                      THRESHOLD)
        print(f"{N_PROTEINS} ring on 2 distinct cards: pairs = oracle "
              f"{np.array_equal(pairs, pairs10)}", flush=True)
        if not np.array_equal(pairs, pairs10):
            raise AssertionError("the ring on distinct cards differs")
    phase_s = time.perf_counter() - t_phase
    print(f"mesh phase: K1 {steps30} launches a 30k D={MESH_D} pass, no "
          f"other kernel; {phase_s:.3f} s", flush=True)
    return dict(launches=ring_launches, k1=k1, k1_strip=k1_strip, runs=runs,
                sweep_s=sweep_s, ext_s=ext_s, fused_s=fused_s,
                phase_s=phase_s, labels30=labels30, appends=appends,
                fit=fit)

MESH_2D = (2, 2)  # the 30k 2-D ring: two hosts of two chips, all on one card
KAXIS_D = 4  # column shards of the 30k k-axis pass, all on one card
SHAPES_2D_10 = ((1, 2), (2, 1), (2, 3), (3, 2), (2, 4))  # every 2-D branch
KAXIS_DS_10 = (1, 2, 3, 8)  # W_pad 7,680 divides over each


def _layout_sweep(layout):
    from uniprot_kmer_based_clustering_tpu_torch import parallel

    return (parallel.sharded_pairwise_similarity_2d if layout == "2d"
            else parallel.sharded_pairwise_similarity_kaxis)


def _totals(rs, th):
    """Sum lanes summed, max lanes maxed, tile hits summed."""
    return (rs[:, [0, 1, 2, 4, 5, 6]].sum(0), rs[:, [3, 7]].max(0),
            th.sum(0))


def layouts_phase(dev, tmp, state10, pairs10, run30, state30, pairs30,
                  scan_s, ring, smi):
    """The 2-D ring and the k-axis layout (docstring, phase 10) on meshes
    whose shards share the one card."""
    import numpy as np
    import torch

    from uniprot_kmer_based_clustering_tpu_torch import PipelineConfig
    from uniprot_kmer_based_clustering_tpu_torch.ops import bitmul
    from uniprot_kmer_based_clustering_tpu_torch.ops.pairlist import (
        append_window,
    )
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        count_kaxis_strips,
        count_substeps_2d,
        kaxis_strips,
        make_mesh,
        make_mesh_2d,
        pad_for_mesh,
        sharded,
        sharded_extract_pairs,
        sharded_pairwise_fused,
        stage_mesh_inputs,
        stage_mesh_inputs_csr,
    )
    from uniprot_kmer_based_clustering_tpu_torch.pipeline import run_pipeline
    from uniprot_kmer_based_clustering_tpu_torch.state import (
        bitset_to_torch,
        classes_to_torch,
    )

    t_phase = time.perf_counter()
    print(f"layouts phase on {smi}: every mesh's shards share this one "
          f"card, so a pass's time is the sum over its shards (no scaling "
          f"figure)", flush=True)
    table30, index30, bitset30 = state30
    n30 = table30.n
    want30 = run30["want"]
    hc, cc = MESH_2D
    d2 = hc * cc
    n_pad30 = pad_for_mesh(bitset30.n_pad, d2, 128)
    if n_pad30 != pad_for_mesh(bitset30.n_pad, KAXIS_D, 128):
        raise AssertionError("the two 30k meshes pad differently")
    block30 = n_pad30 // d2
    corpus = bitset30.n_pad * bitset30.w_pad * 4
    strips30 = kaxis_strips(KAXIS_D, n_pad30)
    s_rows = strips30[0].rows
    # peak gates, from the prediction: the 2-D ring holds the stationary
    # shards, the moving copy and the chip-axis copy, plus phase 9's
    # sub-step working set; the k-axis pass the column shards, the D
    # partial strips and their sum, one unpacked operand chunk, a strip's
    # masks (4 bytes a lane) and one compaction window (76 bytes a lane)
    window = append_window(block30)
    kwindow = append_window(n_pad30)
    limits = {
        "2d": 3 * corpus + sharded.RING_UNPACK_BYTES
        + 2 * 4 * block30 * block30 + 64 * window + d2 * 12 * window,
        "kaxis": corpus + sharded.KAXIS_STRIP_BYTES
        + sharded.RING_UNPACK_BYTES + 4 * s_rows * n_pad30 + 76 * kwindow,
    }
    meshes = {"2d": make_mesh_2d(hc, cc, devices=[dev] * d2),
              "kaxis": make_mesh(devices=[dev] * KAXIS_D, axis="k")}
    steps = {"2d": count_substeps_2d(hc, cc, n_pad30),
             "kaxis": count_kaxis_strips(KAXIS_D, n_pad30)}
    print(f"{N_SCALE}: N_pad {n_pad30}; 2-D {hc}x{cc}: block {block30}, "
          f"{steps['2d']} sub-steps a pass; k axis D={KAXIS_D}: "
          f"{bitset30.w_pad // KAXIS_D} words a shard, {steps['kaxis']} "
          f"strips of {s_rows} rows; peak limits {limits}", flush=True)
    labels30 = ring["labels30"]
    runs = {}
    for layout, mesh in meshes.items():
        want_launches = {"K1": steps[layout], "K2": 0, "K3": 0, "K4": 0}
        for name, cfg in (("auto", PipelineConfig()),
                          ("fused", PipelineConfig(extract="fused"))):
            fns = reset_counters()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            res = run_pipeline(run30["fasta"], cfg, mesh=mesh)
            wall = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in fns.items()}
            peak = torch.cuda.max_memory_allocated(dev)
            got = {k: res.parity_report()[k] for k in want30}
            print(f"run_pipeline(mesh={layout} {mesh.shape}) {name}: "
                  f"{wall:.3f} s; kernel launches {launches}; parity "
                  f"{got}, pairs {len(res.pairwise.pairs)}; peak device "
                  f"memory {peak} bytes (limit {limits[layout]}); stage "
                  f"seconds {json.dumps(res.timings)}", flush=True)
            if launches != want_launches:
                raise AssertionError(f"{layout} {name}: launches "
                                     f"{launches}, expected {want_launches}")
            if got != want30 or not np.array_equal(res.pairwise.pairs,
                                                   pairs30):
                raise AssertionError(f"{layout} {name}: differs from the "
                                     f"oracle")
            if not np.array_equal(res.cluster_labels, labels30):
                raise AssertionError(f"{layout} {name}: labels differ from "
                                     f"the union-find's")
            if peak > limits[layout]:
                raise AssertionError(f"{layout} {name}: peak {peak} bytes "
                                     f"over {limits[layout]}")
            runs[f"{layout} {name}"] = dict(wall=wall, peak=peak,
                                            timings=res.timings)
            del res

    # warm library passes on staged inputs, the counters set to 0 before,
    # and read after, every call; then the packless staging
    cls30 = np.full(n_pad30, -1, np.int32)
    cls30[:n30] = table30.amr_class_ids
    total = len(pairs30)
    counted = {}
    warm = {}

    def count(name, fn):
        def run():
            fns = reset_counters()
            out = fn()
            counted.setdefault(name, []).append(
                {k: f.launches for k, f in fns.items()})
            return out
        return run

    for layout, mesh in meshes.items():
        sweep = _layout_sweep(layout)
        t0 = time.perf_counter()
        ws, cs = stage_mesh_inputs(mesh, bitset30.words, cls30)
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        sweep_s, (rs, th, _) = best_seconds(count(
            f"{layout} sweep", lambda: sweep(mesh, ws, cs, n30, THRESHOLD)),
            reps=2, warmup=0)
        peak_sweep = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ext_s, pairs = best_seconds(count(
            f"{layout} extraction", lambda: sharded_extract_pairs(
                mesh, ws, cs, n30, THRESHOLD, cap=max(1 << 18, total),
                expected_total=total)), reps=2, warmup=0)
        peak_ext = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fused_s, fused = best_seconds(count(
            f"{layout} fused", lambda: sharded_pairwise_fused(
                mesh, ws, cs, n30, THRESHOLD, cap=1 << 21)),
            reps=2, warmup=0)
        peak_fused = torch.cuda.max_memory_allocated(dev)
        pair_count = n30 * (n30 - 1) // 2
        print(f"{N_SCALE} {layout} {mesh.shape} warm (best of 2): staging "
              f"{stage_s:.6f} s; sweep {sweep_s:.6f} s = "
              f"{pair_count / sweep_s:.6e} pairs/s (flat ring D=4 "
              f"{ring['sweep_s']:.6f} s, in-core scan {scan_s:.6f} s), peak "
              f"{peak_sweep} bytes; extraction {ext_s:.6f} s (flat "
              f"{ring['ext_s']:.6f}), peak {peak_ext} bytes; fused pass "
              f"(cap 2^21) {fused_s:.6f} s (flat {ring['fused_s']:.6f}), "
              f"peak {peak_fused} bytes", flush=True)
        if max(peak_sweep, peak_ext, peak_fused) > limits[layout]:
            raise AssertionError(f"a warm 30k {layout} pass went over its "
                                 f"peak memory limit")
        if not (np.array_equal(pairs, pairs30)
                and np.array_equal(fused[3], pairs30)
                and np.array_equal(fused[0], rs)
                and np.array_equal(fused[1], th)
                and int(th[:, 0].sum()) == total):
            raise AssertionError(f"warm 30k {layout} passes differ from the "
                                 f"oracle")
        del fused, pairs
        t0 = time.perf_counter()
        wc_, cc_ = stage_mesh_inputs_csr(
            mesh, index30.incidence_protein, index30.incidence_rank,
            n_pad30, bitset30.w_pad, table30.amr_class_ids)
        torch.cuda.synchronize()
        stage_csr_s = time.perf_counter() - t0
        same = all(torch.equal(a, b) for a, b in zip(wc_ + cc_, ws + cs))
        del ws, cs
        t0 = time.perf_counter()
        rs_c, th_c, _ = count(f"{layout} packless sweep", lambda: sweep(
            mesh, wc_, cc_, n30, THRESHOLD))()
        pairs_c = count(f"{layout} packless extraction",
                        lambda: sharded_extract_pairs(
                            mesh, wc_, cc_, n30, THRESHOLD,
                            cap=max(1 << 18, total),
                            expected_total=total))()
        packless_s = time.perf_counter() - t0
        print(f"{layout} packless staging (stage_mesh_inputs_csr) "
              f"{stage_csr_s:.6f} s, shards = the packed staging's {same}; "
              f"its sweep + extraction {packless_s:.6f} s", flush=True)
        if not (same and np.array_equal(rs_c, rs)
                and np.array_equal(th_c, th)
                and np.array_equal(pairs_c, pairs30)):
            raise AssertionError(f"the {layout} packless staging differs")
        del wc_, cc_
        warm[layout] = dict(stage_s=stage_s, sweep_s=sweep_s, ext_s=ext_s,
                            fused_s=fused_s, peak=max(peak_sweep, peak_ext,
                                                      peak_fused),
                            stage_csr_s=stage_csr_s, packless_s=packless_s)
    launches = {}
    for name, logs in counted.items():
        layout = name.split()[0]
        want_k1 = 0 if name.endswith("extraction") else steps[layout]
        for got in logs:
            if got != {"K1": want_k1, "K2": 0, "K3": 0, "K4": 0}:
                raise AssertionError(f"warm {name}: launches {got}, "
                                     f"expected K1 = {want_k1} and no other "
                                     f"kernel")
        launches[name] = logs[-1]["K1"]
    print(f"K1 launches of each warm 30k call (counters reset before each): "
          f"{launches}", flush=True)

    # K1 on a 2-D wrapped block pair (host 2's last chip against host 0
    # on a 3 x 2 mesh of the 30k corpus) and on a k-axis strip
    words30 = bitset_to_torch(bitset30, dev)
    classes30 = classes_to_torch(table30.amr_class_ids, n_pad30, dev)
    block32 = n_pad30 // 6
    wrapped = sharded.ring_substeps_2d(1, 1, 3, 2, 2, 1, block32, 128)[0]
    if not wrapped.gj0 < wrapped.gi0:
        raise AssertionError("the 3 x 2 sub-step is not wrapped")
    k1_2d = _k1_ring_block(
        dev, "2-D ring's wrapped block pair (3 x 2)", words30, classes30,
        n30, wrapped, sharded.ring_word_chunk(block32, bitset30.w_pad))
    strip = strips30[1]
    k1_k = _k1_ring_block(
        dev, "k-axis strip 1", words30, classes30, n30, strip,
        sharded._word_chunk(strip.rows + strip.cols, bitset30.w_pad,
                            sharded.RING_UNPACK_BYTES), real=True)
    del words30, classes30

    # 10,619 proteins on every branch of both layouts
    table10, index10, bitset10 = state10
    n10 = table10.n
    words10 = bitset_to_torch(bitset10, dev)
    classes10 = classes_to_torch(table10.amr_class_ids, bitset10.n_pad, dev)
    rs_mxu, th_mxu, _ = bitmul.sweep_mxu(words10, classes10, n10, THRESHOLD)
    del words10, classes10
    mxu = _totals(rs_mxu, th_mxu)
    cases = ([("2d", sh) for sh in SHAPES_2D_10]
             + [("kaxis", k) for k in KAXIS_DS_10])
    for layout, shape in cases:
        if layout == "2d":
            dd = shape[0] * shape[1]
            mesh = make_mesh_2d(*shape, devices=[dev] * dd)
        else:
            dd = shape
            mesh = make_mesh(devices=[dev] * dd, axis="k")
        n_pad = pad_for_mesh(bitset10.n_pad, dd, 128)
        words = np.zeros((n_pad, bitset10.w_pad), np.uint32)
        words[: bitset10.n_pad] = bitset10.words
        cls = np.full(n_pad, -1, np.int32)
        cls[:n10] = table10.amr_class_ids
        ws, cs = stage_mesh_inputs(mesh, words, cls)
        fns = reset_counters()
        t0 = time.perf_counter()
        rs, th, _ = _layout_sweep(layout)(mesh, ws, cs, n10, THRESHOLD)
        t_sweep = time.perf_counter() - t0
        got_launches = {k: fn.launches for k, fn in fns.items()}
        t0 = time.perf_counter()
        pairs = sharded_extract_pairs(mesh, ws, cs, n10, THRESHOLD)
        t_ext = time.perf_counter() - t0
        fused = sharded_pairwise_fused(mesh, ws, cs, n10, THRESHOLD)
        want_k1 = (count_substeps_2d(*shape, n_pad) if layout == "2d"
                   else count_kaxis_strips(dd, n_pad))
        checks = {
            "launches": got_launches == {"K1": want_k1, "K2": 0, "K3": 0,
                                         "K4": 0},
            "totals = sweep_mxu": all(
                np.array_equal(a, b) for a, b in zip(_totals(rs, th), mxu)),
            "rows = sweep_mxu": layout == "2d" or np.array_equal(
                rs[: bitset10.n_pad], rs_mxu),
            "extract = oracle": np.array_equal(pairs, pairs10),
            "fused = oracle": np.array_equal(fused[3], pairs10)
            and np.array_equal(fused[0], rs) and np.array_equal(fused[1], th),
        }
        print(f"{N_PROTEINS} {layout} {mesh.shape} (N_pad {n_pad}): sweep "
              f"{t_sweep:.4f} s, extraction {t_ext:.4f} s; launches "
              f"{got_launches}; checks {checks}", flush=True)
        if not all(checks.values()):
            raise AssertionError(f"10,619 {layout} {shape}: {checks}")
        del ws, cs, fused

    # the CLI on the card: a one-card k mesh and a 1 x 1 2-D mesh against
    # the oracle; meshes past the visible cards exit nonzero
    n_pad10 = bitset10.n_pad
    cli_launches = {}
    for flags, k1 in ((["--shard-axis", "kmers"],
                       count_kaxis_strips(1, n_pad10)),
                      (["--mesh-shape", "1x1"],
                       count_substeps_2d(1, 1, n_pad10))):
        cli_launches[" ".join(flags)] = cli_run(
            dev, run30["fasta10"], run30["out"], flags, run30["want10"],
            pairs10, {"K1": k1, "K2": 0, "K3": 0, "K4": 0})["K1"]
    cards = torch.cuda.device_count()
    shape_flag = "2x2" if cards < 4 else f"2x{cards // 2 + 1}"
    need = 4 if cards < 4 else 2 * (cards // 2 + 1)
    for flags, n_need in ((["--mesh-shape", shape_flag], need),
                          (["--devices", str(cards + 1), "--shard-axis",
                            "kmers"], cards + 1)):
        out = os.path.join(tmp, "layout_refused")
        proc = subprocess.run(
            [sys.executable, "-m", f"{PKG}.cli", "run", run30["fasta10"],
             "--device", "cuda", *flags, "--out", out],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
        )
        msg = proc.stderr.strip().splitlines()[-1] if proc.stderr else ""
        want_msg = f"requested {n_need} devices, only {cards} available"
        print(f"cli run --device cuda {' '.join(flags)}: exit "
              f"{proc.returncode}, stderr {msg!r}, output written: "
              f"{os.path.exists(out)}", flush=True)
        if proc.returncode == 0 or want_msg not in msg or os.path.exists(out):
            raise AssertionError(f"{flags} beyond the visible cards did not "
                                 f"fail loudly")
    if cards > 1:
        cls = np.full(bitset10.n_pad, -1, np.int32)
        cls[:n10] = table10.amr_class_ids
        for mesh in (make_mesh_2d(1, 2), make_mesh(2, axis="k")):
            pairs = sharded_extract_pairs(mesh, bitset10.words, cls, n10,
                                          THRESHOLD)
            print(f"{N_PROTEINS} on 2 distinct cards {mesh.shape}: pairs = "
                  f"oracle {np.array_equal(pairs, pairs10)}", flush=True)
            if not np.array_equal(pairs, pairs10):
                raise AssertionError("a layout on distinct cards differs")
    phase_s = time.perf_counter() - t_phase
    print(f"layouts phase: K1 {steps['2d']} launches a 30k 2-D pass, "
          f"{steps['kaxis']} a 30k k-axis pass, no other kernel; "
          f"{phase_s:.3f} s", flush=True)
    return dict(steps=steps, launches=launches, runs=runs, warm=warm,
                k1_2d=k1_2d, k1_k=k1_k, cli_launches=cli_launches,
                phase_s=phase_s)


STREAM_MESH_D = 4  # shards of the 30k out-of-core mesh pass, all on one card
STREAM_MESH_BS = 2048  # (i)'s stream block: one group, four blocks a shard
STREAM_MESH_DS_10 = (1, 2, 3, 8)


def _stream_mesh_run(dev, label, mesh, src, classes, n, want, want_pairs,
                     **kw):
    """One ``sweep_extract_stream_mesh`` call with the kernel counters set
    to 0 just before and read just after (K2 once a step, summed over the
    shards, and nothing else) and the peak device memory over it; its
    pairs and parity counters must equal the oracle's. Returns (out,
    seconds, trace, peak)."""
    import numpy as np
    import torch

    from uniprot_kmer_based_clustering_tpu_torch.ops.pairlist import (
        pairs_as_array,
    )
    from uniprot_kmer_based_clustering_tpu_torch.parallel import stream_mesh
    from uniprot_kmer_based_clustering_tpu_torch.similarity.pairwise import (
        PairwiseResult,
    )

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    fns = reset_counters()
    t0 = time.perf_counter()
    out = stream_mesh.sweep_extract_stream_mesh(
        mesh, classes, n, THRESHOLD, block_source=src, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in fns.items()}
    peak = torch.cuda.max_memory_allocated(dev) - base
    tr = dict(stream_mesh.last_mesh_trace)
    pairs = pairs_as_array(out[3]).astype(np.int64)
    got = {k: v for k, v in PairwiseResult.from_row_stats(
        out[0], out[3]).parity_counters().items() if k in want}
    print(f"stream mesh {label}: {secs:.6f} s; launches {launches}; bs "
          f"{tr['bs']}, nbk {tr['nbk']}, g {tr['g']}, gpd {tr['gpd']}, "
          f"{-(-tr['nbk'] // tr['g'])} groups, {tr['steps']} steps, uploads "
          f"{tr['uploads']}, word_chunk {tr['word_chunk']}, vcap "
          f"{tr['vcap']}, overflow {tr['overflow']}, balance "
          f"{tr['balance']:.4f}; stage {tr['stage_s']:.6f} s, dispatch "
          f"{tr['dispatch_s']:.6f} s, drain {tr['drain_s']:.6f} s, fetch "
          f"{tr['fetch_s']:.6f} s, checkpoints {tr.get('ckpt_s', 0.0):.6f} "
          f"s, grouped redo {tr.get('redo_s', 0.0):.6f} s; peak device "
          f"memory {peak} bytes; parity "
          f"{got}, {len(pairs)} pairs", flush=True)
    if launches != {"K1": 0, "K2": tr["steps"], "K3": 0, "K4": 0}:
        raise AssertionError(f"stream mesh {label}: launches {launches}, "
                             f"expected K2 = {tr['steps']} steps only")
    if got != want or not np.array_equal(pairs, want_pairs):
        raise AssertionError(f"stream mesh {label}: differs from the oracle")
    return out, secs, tr, peak


def stream_mesh_phase(dev, tmp, state10, pairs10, run30, state30, pairs30,
                      scan_s, onepass_s, labels30, smi):
    """The out-of-core sweep on a flat mesh and row-sharded serving
    (docstring, phase 11), every mesh's shards on the one card."""
    import numpy as np
    import torch

    from uniprot_kmer_based_clustering_tpu_torch import PipelineConfig
    from uniprot_kmer_based_clustering_tpu_torch.ops.stream import (
        CSRBlockSource,
        split_incidence_blocks,
        sweep_extract_stream,
    )
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        make_mesh,
        stream_mesh,
    )
    from uniprot_kmer_based_clustering_tpu_torch.pipeline import run_pipeline
    from uniprot_kmer_based_clustering_tpu_torch.similarity import query as q
    from uniprot_kmer_based_clustering_tpu_torch.utils.checkpoint import (
        CheckpointStore,
    )

    t_phase = time.perf_counter()
    print(f"stream-mesh phase on {smi}: every mesh's shards share this one "
          f"card, so their launches queue on one stream and a pass's time "
          f"is the sum over its shards (no scaling figure)", flush=True)
    d = STREAM_MESH_D
    table30, index30, bitset30 = state30
    n30 = table30.n
    want30 = run30["want"]
    cls30 = np.asarray(table30.amr_class_ids, np.int32)
    mesh4 = make_mesh(devices=[dev] * d)

    def src30():
        # a fresh source: its staging estimate enters the blocking
        return CSRBlockSource(index30.incidence_protein,
                              index30.incidence_rank, bitset30.n_pad,
                              bitset30.w_pad)

    def gate(tr, budget):
        """D × (budget + a shard's staging) + (D − g) blocks when g < D."""
        rows, ranks, valid = split_incidence_blocks(
            index30.incidence_protein, index30.incidence_rank, tr["bs"],
            tr["nbk"])
        staging = (rows.nbytes + ranks.nbytes + valid.nbytes
                   + tr["nbk"] * tr["bs"] * 4)
        block_bytes = tr["bs"] * bitset30.w_pad * 4
        return (d * (budget + staging)
                + max(0, d - tr["g"]) * block_bytes), staging

    stream_launches = {}
    mesh_s = {}
    # a. (i) the default 13 GiB a shard at bs 2,048: one group, gpd 4
    budget = 13 << 30
    kw = dict(bs=STREAM_MESH_BS, hbm_budget_bytes=budget)
    out, cold_s, tr, peak = _stream_mesh_run(
        dev, f"D={d} 13 GiB bs {STREAM_MESH_BS} (first call)", mesh4,
        src30(), cls30, n30, want30, pairs30, **kw)
    out, warm_s, tr, peak = _stream_mesh_run(
        dev, f"D={d} 13 GiB bs {STREAM_MESH_BS} (warm)", mesh4, src30(),
        cls30, n30, want30, pairs30, **kw)
    limit, staging = gate(tr, budget)
    if tr["g"] <= d or tr["gpd"] < 2 or -(-tr["nbk"] // tr["g"]) != 1:
        raise AssertionError("(i) is not one group with a cooperative stack")
    fns = reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = sweep_extract_stream(None, cls30, n30, THRESHOLD, device=dev,
                               block_source=src30(), **kw)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    one_k2 = fns["K2"].launches
    same = all(np.array_equal(a, b) for a, b in zip(
        out[:2] + out[3:], one[:2] + one[3:]))
    print(f"{N_SCALE} D={d} 13 GiB a shard, bs {STREAM_MESH_BS}: warm "
          f"{warm_s:.6f} s (first call {cold_s:.6f} s) beside the "
          f"single-device one pass at that bs {one_s:.6f} s (K2 {one_k2}), "
          f"phase 4's one pass from the CSR source "
          f"{onepass_s.get('CSR source', 0.0):.6f} s (bs 4096) and the "
          f"in-core scan {scan_s:.6f} s; stage {tr['stage_s']:.6f} s; "
          f"row_stats, tile hits and pairs = the single-device engine's "
          f"{same}; peak {peak} bytes (gate {limit} = {d} x ({budget} + "
          f"staging {staging}))", flush=True)
    if not same or peak > limit:
        raise AssertionError("(i) differs from the single-device engine or "
                             "went over its peak gate")
    stream_launches["13GiB"] = tr["steps"]
    mesh_s["13GiB"] = warm_s
    del out, one

    # (ii) STREAM_SMALL_BUDGET a shard: several groups, g < D
    budget = STREAM_SMALL_BUDGET
    out, small_s, tr, peak = _stream_mesh_run(
        dev, f"D={d} {budget} bytes a shard", mesh4, src30(), cls30, n30,
        want30, pairs30, hbm_budget_bytes=budget)
    limit, staging = gate(tr, budget)
    bs_small, g_small = tr["bs"], tr["g"]
    if g_small >= d or tr["nbk"] // g_small < 2:
        raise AssertionError("(ii) is not several groups with g < D")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = sweep_extract_stream(None, cls30, n30, THRESHOLD, device=dev,
                               bs=bs_small, hbm_budget_bytes=budget,
                               block_source=src30())
    torch.cuda.synchronize()
    one_small_s = time.perf_counter() - t0
    same = all(np.array_equal(a, b) for a, b in zip(
        out[:2] + out[3:], one[:2] + one[3:]))
    print(f"{N_SCALE} D={d} {budget} bytes a shard: {small_s:.6f} s beside "
          f"the single-device one pass at bs {bs_small} {one_small_s:.6f} "
          f"s; = its results {same}; peak {peak} bytes (gate {limit} = {d} "
          f"x ({budget} + staging {staging}) + {d - g_small} blocks)",
          flush=True)
    if not same or peak > limit:
        raise AssertionError("(ii) differs from the single-device engine or "
                             "went over its peak gate")
    stream_launches["2GiB"] = tr["steps"]
    mesh_s["2GiB"] = small_s
    ref_small = out
    del one

    # kill after 2 groups under (ii), resume on the mesh; then a
    # single-device kill resumed on the mesh, (bs, g) aligned by max_group
    store = CheckpointStore(os.path.join(tmp, "stream_mesh_ckpt"))
    resumes = {}
    for writer in ("mesh", "single device"):
        # the writer's own blocking arguments (an explicit bs changes the
        # budget's slack, and so the snapshot's geometry)
        key = writer.replace(" ", "-")
        kw = dict(hbm_budget_bytes=budget, checkpoint_store=store,
                  checkpoint_key=key)
        if writer != "mesh":
            kw.update(bs=bs_small, max_group=g_small)
        t0 = time.perf_counter()
        try:
            if writer == "mesh":
                stream_mesh.sweep_extract_stream_mesh(
                    mesh4, cls30, n30, THRESHOLD, block_source=src30(),
                    fail_after_groups=2, **kw)
            else:
                sweep_extract_stream(None, cls30, n30, THRESHOLD, device=dev,
                                     block_source=src30(),
                                     fail_after_groups=2, **kw)
        except RuntimeError as e:
            if "fault injection" not in str(e):
                raise
        else:
            raise AssertionError("the fault injection did not fire")
        killed_s = time.perf_counter() - t0
        snap = store.load(key)
        if snap is None or len(snap["groups_done"]) != 2:
            raise AssertionError(f"{writer}: no two-group snapshot")
        out, res_s, tr, _ = _stream_mesh_run(
            dev, f"resume of a {writer} snapshot", mesh4, src30(), cls30,
            n30, want30, pairs30, **kw)
        same = all(np.array_equal(a, b) for a, b in zip(
            out[:2] + out[3:], ref_small[:2] + ref_small[3:]))
        print(f"kill of the {writer} after 2 groups {killed_s:.6f} s, mesh "
              f"resume {res_s:.6f} s: {tr.get('groups_skipped')} groups "
              f"skipped, = the uninterrupted run {same}, snapshot removed "
              f"{store.load(key) is None}", flush=True)
        if (tr.get("groups_skipped") != 2 or not same
                or store.load(key) is not None):
            raise AssertionError(f"the resume of a {writer} snapshot")
        resumes[writer] = res_s
    del ref_small, out

    # a capacity miss: 2^16 pairs a shard, the grouped redo
    out, miss_s, tr, _ = _stream_mesh_run(
        dev, f"D={d} cap 65536 a shard", mesh4, src30(), cls30, n30, want30,
        pairs30, bs=STREAM_MESH_BS, cap=1 << 16)
    if not tr["overflow"]:
        raise AssertionError("the capacity miss did not redo")
    del out

    # b. the pipeline: cli run's route for --devices 4 --engine stream
    # --stream-source csr --extract onepass
    fns = reset_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = run_pipeline(run30["fasta"], PipelineConfig(
        engine="stream", stream_source="csr", extract="onepass"),
        mesh=mesh4)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in fns.items()}
    tr = dict(stream_mesh.last_mesh_trace)
    mesh_s["pipeline"] = wall
    got = {k: res.parity_report()[k] for k in want30}
    print(f"run_pipeline(mesh=D{d}, engine='stream', stream_source='csr', "
          f"extract='onepass'): {wall:.3f} s; launches {launches}; bs "
          f"{tr['bs']}, g {tr['g']}, gpd {tr['gpd']}, {tr['steps']} steps; "
          f"parity {got}, {len(res.pairwise.pairs)} pairs, clusters "
          f"{res.cluster_summary()}; peak {torch.cuda.max_memory_allocated(dev)} "
          f"bytes; stage seconds {json.dumps(res.timings)}", flush=True)
    if (launches != {"K1": 0, "K2": tr["steps"], "K3": 0, "K4": 0}
            or got != want30
            or not np.array_equal(res.pairwise.pairs, pairs30)
            or not np.array_equal(res.cluster_labels, labels30)):
        raise AssertionError("the stream mesh pipeline differs from the "
                             "oracle or the union-find, or launched "
                             "another kernel")
    stream_launches["pipeline"] = tr["steps"]
    del res

    # c. 10,619 at D = 1, 2, 3, 8
    table10, index10, bitset10 = state10
    n10 = table10.n
    want10 = run30["want10"]
    for dd in STREAM_MESH_DS_10:
        _stream_mesh_run(
            dev, f"{N_PROTEINS} D={dd}", make_mesh(devices=[dev] * dd),
            CSRBlockSource(index10.incidence_protein,
                           index10.incidence_rank, bitset10.n_pad,
                           bitset10.w_pad),
            np.asarray(table10.amr_class_ids, np.int32), n10, want10,
            pairs10)

    # d. the CLI: past the visible cards it fails loudly, before output
    cards = torch.cuda.device_count()
    flags = ["--engine", "stream", "--stream-source", "csr", "--extract",
             "onepass"]
    out = os.path.join(tmp, "stream_mesh_refused")
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.cli", "run", run30["fasta10"],
         "--device", "cuda", "--devices", str(cards + 1), *flags,
         "--out", out],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    msg = proc.stderr.strip().splitlines()[-1] if proc.stderr else ""
    want_msg = f"requested {cards + 1} devices, only {cards} available"
    print(f"cli run --devices {cards + 1} {' '.join(flags)}: exit "
          f"{proc.returncode}, stderr {msg!r}, output written: "
          f"{os.path.exists(out)}", flush=True)
    if proc.returncode == 0 or want_msg not in msg or os.path.exists(out):
        raise AssertionError("--devices beyond the visible cards did not "
                             "fail loudly")
    if cards > 1:
        cli_run(dev, run30["fasta10"], os.path.join(tmp, "stream_mesh_2"),
                ["--devices", "2", *flags], want10, pairs10,
                lambda: {"K1": 0, "K2": stream_mesh.last_mesh_trace["steps"],
                         "K3": 0, "K4": 0})

    # e. row-sharded serving of the 10,619 corpus on four shards
    fns = reset_counters()
    seqs = [table10.seq(i) for i in range(n10)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    msrv = q.QueryServer(index10, bitset10, mesh=mesh4)
    msrv.query(seqs[:QUERY_BATCH], threshold=THRESHOLD)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    limit = bitset10.words.nbytes + 4 * bitset10.n_pad * 4096
    srv = q.QueryServer(index10, bitset10, mode="device", device=dev)
    rates = {}
    answers = {}
    for name, s in (("mesh", msrv), ("single", srv)):
        for size, batch in ((1, seqs[:32]), (64, seqs[:512]),
                            (QUERY_BATCH, seqs)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = []
            for b in _query_batches(batch, size):
                got += s.query(b, threshold=THRESHOLD)
            torch.cuda.synchronize()
            rates[(name, size)] = len(batch) / (time.perf_counter() - t0)
            answers[(name, size)] = got
    for size in (1, 64, QUERY_BATCH):
        _same_answers(answers[("mesh", size)], answers[("single", size)],
                      f"mesh server, batch {size}")
    cls10 = table10.amr_class_ids
    rows = []
    for i, m in enumerate(answers[("mesh", QUERY_BATCH)]):
        js, cs = m[:, 0], m[:, 1]
        keep = (js > i) & (cls10[js] != cls10[i])
        rows.append(np.stack([np.full(int(keep.sum()), i), js[keep],
                              cs[keep]], axis=1))
    got = np.concatenate(rows)
    got = got[np.lexsort((got[:, 1], got[:, 0]))]
    if not np.array_equal(got, pairs10):
        raise AssertionError("the mesh server's self-queries differ from "
                             "the scipy oracle")
    launches = _zero_launches(fns, "mesh serving")
    print(f"QueryServer(mesh=D{d}) on {N_PROTEINS}: built + one batch "
          f"{build_s:.3f} s, peak {peak} bytes (gate {limit}: one corpus + "
          f"four unpacked chunks a shard); answers = the single-device "
          f"server's at batches 1, 64, {QUERY_BATCH}, and its {len(got)} "
          f"cross-class i<j self-query pairs = the oracle; queries/s mesh "
          f"/ single device: "
          + ", ".join(f"batch {b} {rates[('mesh', b)]:.1f} / "
                      f"{rates[('single', b)]:.1f}"
                      for b in (1, 64, QUERY_BATCH))
          + f"; launches {launches}", flush=True)
    if peak > limit:
        raise AssertionError("the mesh server went over its peak gate")
    del msrv, srv

    phase_s = time.perf_counter() - t_phase
    print(f"stream-mesh phase: K2 {stream_launches} launches (one a step, "
          f"summed over the shards), no other kernel; {phase_s:.3f} s",
          flush=True)
    return dict(launches=stream_launches, mesh_s=mesh_s, resumes=resumes,
                miss_s=miss_s, qps=rates, phase_s=phase_s)


# -- phase 12: the multi-process mesh (cli run --distributed) -----------------

DIST_RANKS = 4  # gloo ranks sharing the one card in cases (b), (d), (e)
DIST_TIMEOUT = 240  # seconds a case's workers may take before they are killed
DIST_WAVES = ("ad", "bce")  # cases whose ranks run at once (8 CPU cores)
DIST_RESUME_GROUP = 2  # max_group of the kill-and-resume: 4 groups at 30k


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _digest(arr) -> str:
    """sha256 of an integer array as contiguous int64."""
    import hashlib

    import numpy as np

    return hashlib.sha256(
        np.ascontiguousarray(arr, dtype=np.int64).tobytes()).hexdigest()


def _launch_ranks(jobs: list) -> list:
    """Start ``world`` worker processes of this script (``--dist-worker``)
    for each ``(spec, world)`` of ``jobs``, all at once, with the torchrun
    environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK;
    a port for each job) and wait for them; each prints one ``DIST`` JSON
    line. A worker that exits nonzero, or that outlives ``DIST_TIMEOUT``,
    fails the phase (all workers are killed first). Returns, for each
    job, (the lines by rank, the seconds from launch to its last exit)."""
    ports = set()
    while len(ports) < len(jobs):
        ports.add(_free_port())
    started = []
    t0 = time.perf_counter()
    for (spec, world), port in zip(jobs, sorted(ports)):
        procs = []
        for r in range(world):
            env = dict(os.environ, MASTER_ADDR="localhost",
                       MASTER_PORT=str(port), RANK=str(r),
                       WORLD_SIZE=str(world), LOCAL_RANK=str(r))
            env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dist-worker",
                 json.dumps(spec)], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        started.append((spec, procs))
    def wait(procs):
        logs = [p.communicate(timeout=max(
            1.0, DIST_TIMEOUT - (time.perf_counter() - t0)))[0]
            for p in procs]
        return logs, time.perf_counter() - t0

    try:
        with ThreadPoolExecutor(len(started)) as pool:
            done = [f.result() for f in [pool.submit(wait, procs)
                                         for _, procs in started]]
    except subprocess.TimeoutExpired:
        for _, procs in started:
            for p in procs:
                p.kill()
        for _, procs in started:
            for p in procs:
                p.wait()
        raise AssertionError(f"distributed cases "
                             f"{[x['case'] for x, _ in started]}: a worker "
                             f"outlived {DIST_TIMEOUT} s")
    out = []
    for (spec, procs), (logs, wall) in zip(started, done):
        lines = []
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(
                    f"distributed case {spec['case']}: rank {r} exited "
                    f"{p.returncode}:\n{log[-6000:]}")
            found = [json.loads(x[5:]) for x in log.splitlines()
                     if x.startswith("DIST ")]
            if len(found) != 1:
                raise AssertionError(f"rank {r} printed {len(found)} result "
                                     f"lines:\n{log[-6000:]}")
            lines.append(found[0])
        out.append((lines, wall))
    return out


def _dist_worker(spec: dict) -> int:
    """One rank of a phase-12 case (``spec["case"]``): joins the world
    from the torchrun environment, runs the case's main path with the
    launch counters and the transport counters set to 0 just before,
    and prints one ``DIST`` JSON line: the pairs and labels digests, the
    parity counters, its launches, seconds and transport bytes."""
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from uniprot_kmer_based_clustering_tpu_torch import (
        PipelineConfig,
        cli,
        pipeline,
    )
    from uniprot_kmer_based_clustering_tpu_torch.ops import _build
    from uniprot_kmer_based_clustering_tpu_torch.parallel import mesh as pmesh
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        init_distributed,
        make_mesh_2d,
    )

    case = spec["case"]
    _build.load_kernels()
    init_distributed(backend=spec["backend"])
    rank, world = pmesh.world()
    got = {}
    real = pipeline.run_pipeline

    def capture(*a, **kw):
        got["res"] = real(*a, **kw)
        return got["res"]

    pipeline.run_pipeline = capture
    fns = reset_counters()
    pmesh.reset_transport_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if "cli" in spec:
        out = os.path.join(spec["out"], f"rank{rank}")
        rc = cli.main(["run", spec["fasta"], "--out", out, "--distributed",
                       *spec["cli"]])
        if rc != 0:
            raise AssertionError(f"cli run returned {rc}")
    else:
        dev = spec["device"]
        mesh = make_mesh_2d(*spec["mesh_2d"], devices=[dev] * spec["local"])
        out = None
        capture(spec["fasta"], PipelineConfig(), mesh=mesh)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in fns.items()}
    transport = pmesh.reset_transport_stats()
    res = got["res"]
    line = dict(
        case=case, rank=rank, world=world, seconds=seconds,
        sweep_s=res.timings.get("sweep"), launches=launches,
        transport_bytes=transport["bytes"],
        transport_s=transport["seconds"], transport_calls=transport["calls"],
        pairs=len(res.pairwise.pairs), pairs_digest=_digest(
            res.pairwise.pairs),
        labels_digest=_digest(res.cluster_labels),
        parity=res.parity_report(),
        wrote=bool(out) and os.path.exists(out),
    )
    if case == "a":
        # the mesh of one rank moves nothing between ranks; one NCCL
        # all_reduce shows the library runs on this card
        t = torch.full((4,), rank + 1.0, device="cuda")
        dist.all_reduce(t)
        line["nccl_all_reduce"] = t.tolist()
    if case == "d":
        line["resume"] = _dist_resume(spec, res)
    dist.barrier()
    print("DIST " + json.dumps(line), flush=True)
    dist.destroy_process_group()
    return 0


def _dist_resume(spec, res) -> dict:
    """Case (d)'s kill and resume through the library: the out-of-core
    mesh pass at the pipeline's blocking with ``max_group`` 2 (4 groups),
    killed after 2 groups on every rank, then resumed from rank 0's
    snapshot, which every rank reads."""
    import numpy as np
    import torch

    from uniprot_kmer_based_clustering_tpu_torch.ops.stream import (
        CSRBlockSource,
    )
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        make_mesh,
        sweep_extract_stream_mesh,
        stream_mesh,
    )
    from uniprot_kmer_based_clustering_tpu_torch.utils.checkpoint import (
        CheckpointStore,
    )

    mesh = make_mesh(device=spec["device"])
    store = CheckpointStore(os.path.join(spec["out"], "ckpt"))
    src = CSRBlockSource(res.index.incidence_protein,
                         res.index.incidence_rank, res.bitset.n_pad,
                         res.bitset.w_pad)
    kw = dict(block_source=src, max_group=DIST_RESUME_GROUP,
              checkpoint_store=store, checkpoint_key="resume")
    classes = np.asarray(res.table.amr_class_ids, np.int32)
    t0 = time.perf_counter()
    try:
        sweep_extract_stream_mesh(mesh, classes, res.table.n, THRESHOLD,
                                  fail_after_groups=2, **kw)
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    kill_s = time.perf_counter() - t0
    snap = store.load("resume")
    fns = reset_counters()
    t0 = time.perf_counter()
    out = sweep_extract_stream_mesh(mesh, classes, res.table.n, THRESHOLD,
                                    **kw)
    torch.cuda.synchronize()
    tr = stream_mesh.last_mesh_trace
    return dict(raised=raised, kill_s=kill_s,
                snapshot_groups=(None if snap is None
                                 else snap["groups_done"].tolist()),
                seconds=time.perf_counter() - t0,
                skipped=tr.get("groups_skipped"), g=tr["g"], bs=tr["bs"],
                steps=tr["steps"], redo_s=tr.get("redo_s"),
                k2=fns["K2"].launches, pairs_digest=_digest(out[3]))


def distributed_phase(dev, tmp, state10, pairs10, ref, pairs30, labels30,
                      single, smi):
    """Phase 12 (module doc): ``cli run --distributed`` and
    ``run_pipeline`` on a multi-process mesh, in worker processes of
    this script. ``ref`` holds the corpora, the oracle's counters, the
    30k N_pad, the single-device run's output directory and phase 11's
    pipeline steps; ``single`` the one-process seconds of phases 2 and
    9–11, printed beside."""
    import numpy as np
    import torch

    from uniprot_kmer_based_clustering_tpu_torch import PipelineConfig
    from uniprot_kmer_based_clustering_tpu_torch.models.components import (
        connected_components,
    )
    from uniprot_kmer_based_clustering_tpu_torch.parallel import (
        count_kaxis_strips,
        count_substeps,
        count_substeps_2d,
        make_mesh,
        pad_for_mesh,
    )
    from uniprot_kmer_based_clustering_tpu_torch.pipeline import run_pipeline

    t_phase = time.perf_counter()
    print(f"distributed phase on {smi}: NCCL with one rank, and gloo ranks "
          f"that all share this one card (NCCL refuses two ranks on one "
          f"card), so no time here is a scaling figure", flush=True)
    torch.cuda.empty_cache()  # the workers need the card's memory
    table10 = state10[0]
    n10 = table10.n
    want10, want30 = ref["want10"], ref["want30"]
    n_pad30 = pad_for_mesh(ref["n_pad30"], DIST_RANKS, 128)
    cards = torch.cuda.device_count()  # case (a)'s one rank spans them
    n_pad10 = pad_for_mesh(state10[2].n_pad, DIST_RANKS, 128)
    labels10 = connected_components(n10, pairs10)
    # one process's D = 4 k mesh at 10,619, beside case (e)
    fns = reset_counters()
    t0 = time.perf_counter()
    res = run_pipeline(ref["fasta10"], PipelineConfig(),
                       mesh=make_mesh(devices=[dev] * DIST_RANKS, axis="k"))
    single["kaxis 10619"] = time.perf_counter() - t0
    single["kaxis 10619 sweep"] = res.timings["sweep"]
    if (not np.array_equal(res.pairwise.pairs, pairs10)
            or fns["K1"].launches != count_kaxis_strips(DIST_RANKS,
                                                        n_pad10)):
        raise AssertionError("the one-process k mesh at 10,619 differs")
    del res
    want = {
        "30k": (_digest(pairs30), _digest(labels30), want30),
        "10k": (_digest(pairs10), _digest(labels10), want10),
    }
    dev_name = f"{dev.type}:{dev.index}"
    cases = [
        ("a", 1, dict(backend=None, fasta=ref["fasta30"], cli=[]), "30k",
         {"K1": count_substeps(cards, pad_for_mesh(ref["n_pad30"], cards,
                                                   128))},
         "single device (phase 2)"),
        ("b", DIST_RANKS, dict(backend="gloo", fasta=ref["fasta30"],
                               cli=["--device", dev_name]), "30k",
         {"K1": count_substeps(DIST_RANKS, n_pad30)}, "flat D=4 (phase 9)"),
        ("c", 2, dict(backend="gloo", fasta=ref["fasta30"], device=dev_name,
                      mesh_2d=[2, 2], local=2), "30k",
         {"K1": count_substeps_2d(2, 2, n_pad30)}, "2-D 2x2 (phase 10)"),
        ("d", DIST_RANKS, dict(backend="gloo", fasta=ref["fasta30"],
                               device=dev_name,
                               cli=["--device", dev_name, "--engine",
                                    "stream", "--stream-source", "csr",
                                    "--extract", "onepass"]), "30k",
         {"K2": ref["stream_steps"]}, "out of core D=4 "
         "(phase 11)"),
        ("e", DIST_RANKS, dict(backend="gloo", fasta=ref["fasta10"],
                               cli=["--device", dev_name, "--shard-axis",
                                    "kmers"]), "10k",
         {"K1": count_kaxis_strips(DIST_RANKS, n_pad10)},
         "k axis D=4 at 10,619 (this phase, one process)"),
    ]
    beside = {"a": single["single 30k"], "b": single["flat"],
              "c": single["2d"], "d": single["stream"],
              "e": single["kaxis 10619"]}
    cases = [(case, world, dict(spec, case=case,
                                out=os.path.join(tmp, f"dist_{case}")),
              corpus, expect, single_name)
             for case, world, spec, corpus, expect, single_name in cases]
    ran = {}
    for wave in DIST_WAVES:
        jobs = [c for c in cases if c[0] in wave]
        for c, res in zip(jobs, _launch_ranks([(c[2], c[1]) for c in jobs])):
            ran[c[0]] = res
    launches = {}
    summary = {}
    for case, world, spec, corpus, expect, single_name in cases:
        lines, wall = ran[case]
        pd, ld, parity_want = want[corpus]
        totals = {k: sum(x["launches"][k] for x in lines)
                  for k in ("K1", "K2", "K3", "K4")}
        for k in ("K1", "K2", "K3", "K4"):
            if totals[k] != expect.get(k, 0):
                raise AssertionError(
                    f"case {case}: launches summed over the ranks {totals}, "
                    f"expected {expect}")
        for x in lines:
            got = {k: x["parity"][k] for k in parity_want}
            if (x["pairs_digest"] != pd or x["labels_digest"] != ld
                    or got != parity_want):
                raise AssertionError(
                    f"case {case} rank {x['rank']}: pairs, labels or parity "
                    f"{got} differ from the oracle and the union-find")
        if "cli" in spec:
            wrote = [x["wrote"] for x in lines]
            if wrote != [True] + [False] * (world - 1):
                raise AssertionError(f"case {case}: ranks wrote {wrote}")
            rank0 = os.path.join(spec["out"], "rank0")
            same_as = {"a": ref["single30"], "e": None}.get(
                case, os.path.join(tmp, "dist_a", "rank0"))
            for f in ("pairs.tsv", "clusters.tsv"):
                with open(os.path.join(rank0, f), "rb") as fh:
                    mine = fh.read()
                if same_as is not None:
                    with open(os.path.join(same_as, f), "rb") as fh:
                        if fh.read() != mine:
                            raise AssertionError(
                                f"case {case}: rank 0's {f} differs from "
                                f"{same_as}")
            if case == "e":
                if not np.array_equal(read_pairs_tsv(
                        os.path.join(rank0, "pairs.tsv")), pairs10):
                    raise AssertionError("case e: pairs.tsv != the oracle")
                if not np.array_equal(_tsv_labels(
                        os.path.join(rank0, "clusters.tsv")), labels10):
                    raise AssertionError("case e: clusters.tsv != the "
                                         "union-find")
        if case == "a" and lines[0]["nccl_all_reduce"] != [1.0] * 4:
            raise AssertionError("case a: the NCCL all_reduce is wrong")
        if case == "d":
            for x in lines:
                rs = x["resume"]
                if ("fault injection" not in rs["raised"]
                        or rs["snapshot_groups"] is None
                        or len(rs["snapshot_groups"]) != 2
                        or rs["skipped"] != 2 or rs["pairs_digest"] != pd):
                    raise AssertionError(f"case d rank {x['rank']}: the kill "
                                         f"and resume failed: {rs}")
            rs = [x["resume"] for x in lines]
            print(f"  case d kill and resume (max_group "
                  f"{DIST_RESUME_GROUP}: bs {rs[0]['bs']}, g {rs[0]['g']}): "
                  f"every rank raised after 2 groups and read rank 0's "
                  f"snapshot of groups {rs[0]['snapshot_groups']}; killed run "
                  f"{max(r['kill_s'] for r in rs):.3f} s, resume "
                  f"{max(r['seconds'] for r in rs):.3f} s (redo on rank 0 "
                  f"{rs[0]['redo_s']}), K2 on the resume "
                  f"{sum(r['k2'] for r in rs)} = steps "
                  f"{sum(r['steps'] for r in rs)}, groups skipped "
                  f"{rs[0]['skipped']}; pairs = the oracle on every rank",
                  flush=True)
        sweep = max(x["sweep_s"] for x in lines)
        tb = sum(x["transport_bytes"] for x in lines)
        ts = max(x["transport_s"] for x in lines)
        print(f"case {case} ({world} rank(s), {spec['backend'] or 'nccl'}, "
              f"{corpus}): wall {wall:.3f} s from launch to the last exit; "
              f"ranks' own seconds {[round(x['seconds'], 3) for x in lines]}; "
              f"slowest rank's sweep stage {sweep:.3f} s; transport "
              f"{tb} bytes handed over by all ranks, {ts:.3f} s on the "
              f"slowest rank ({sum(x['transport_calls'] for x in lines)} "
              f"calls); launches summed over the ranks {totals} (per rank "
              f"{[x['launches'] for x in lines]}); {lines[0]['pairs']} pairs, "
              f"identical on every rank and equal to the oracle; one "
              f"process's {single_name}: {beside[case]:.3f} s", flush=True)
        launches[case] = totals
        summary[case] = dict(wall=wall, sweep_s=sweep, transport_bytes=tb,
                             transport_s=ts, single_s=beside[case])
    phase_s = time.perf_counter() - t_phase
    print(f"distributed phase: every rank's result identical and equal to "
          f"the oracle; {phase_s:.3f} s", flush=True)
    return dict(launches=launches, summary=summary, phase_s=phase_s)


# -- phase 13: the benches ----------------------------------------------------

BENCH_TIMEOUT = 420  # seconds a bench subprocess may take before it is killed
BENCH_PARALLEL = 4  # bench subprocesses of phases 13-14 sharing the card at once


BENCH_KNOBS = ("UKC_BENCH_", "UKC_SCALE_", "UKC_ENGINES_", "UKC_QUERY_",
               "UKC_CLUSTER_", "UKC_POD_", "UKC_1CHIP_")


def _bench_line(label: str, argv: list, smi: str, knobs=None) -> dict:
    """Run ``python -m *argv`` on the card as a user would (no bench knob
    of this environment passed on; ``knobs`` set) and return its last
    line, the JSON result; exit 0 and no ``error`` required."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(BENCH_KNOBS)}
    env.update(knobs or {})
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT, env=env,
                          capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT)
    secs = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(
            f"bench {label} exited {proc.returncode}: "
            f"{proc.stdout[-1500:]} {proc.stderr[-3000:]}")
    line = json.loads(lines[-1])
    print(f"bench {label} ({secs:.3f} s, {smi}): {lines[-1]}", flush=True)
    if "error" in line:
        raise AssertionError(f"bench {label}: {line['error']}")
    line["_seconds"] = secs
    return line


def bench_runs(smi) -> dict:
    """The eight bench subprocesses of phases 13 and 14, each as
    :func:`_bench_line` runs it, ``BENCH_PARALLEL`` at a time on the one
    card (longest first), so each one's figures are taken beside the
    others'. Returns their lines by label."""
    import torch

    torch.cuda.empty_cache()  # the subprocesses need the card's memory
    runs = [
        ("cluster", [f"{PKG}.benches.cluster"], {
            "UKC_CLUSTER_COMPONENTS_N": str(N_SCALE),
            "UKC_CLUSTER_AGG_N": str(N_PROTEINS),
            "UKC_CLUSTER_N": "5000"}),
        ("scale", [f"{PKG}.benches.scale"], None),
        ("query", [f"{PKG}.benches.query"], {"UKC_QUERY_STREAM": "1"}),
        ("engines", [f"{PKG}.benches.engines"], None),
        ("cli bench", [f"{PKG}.cli", "bench"], None),
        ("pod flat", [f"{PKG}.benches.pod"], {"UKC_POD_DEVICES": "1"}),
        ("pod 1x1", [f"{PKG}.benches.pod"], {"UKC_POD_MESH": "1x1"}),
        ("pod nccl", [f"{PKG}.benches.pod"], {
            "UKC_POD_DISTRIBUTED": "1", "MASTER_ADDR": "localhost",
            "MASTER_PORT": str(_free_port()), "RANK": "0",
            "WORLD_SIZE": "1", "LOCAL_RANK": "0"}),
    ]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(BENCH_PARALLEL) as pool:
        futures = [(label, pool.submit(_bench_line, label, argv, smi, knobs))
                   for label, argv, knobs in runs]
        lines = {label: f.result() for label, f in futures}
    print(f"bench subprocesses of phases 13-14: {len(runs)}, "
          f"{BENCH_PARALLEL} at a time on the one card, "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    return lines


def benches_phase(lines, want10, want30, steps30):
    """The port's three benches (docstring, phase 13), each against the
    oracle of phase 2. Returns their lines."""
    head = lines["cli bench"]
    if head["counters"] != want10:
        raise AssertionError(f"cli bench counters {head['counters']} != "
                             f"the oracle's {want10}")
    if head["kernels"] != {"K1": 7, "K2": 0}:
        raise AssertionError(f"cli bench kernels {head['kernels']}, "
                             "expected K1 7 and K2 0 a sweep")
    if not head["value"] > 0 or head["device"] == "cpu":
        raise AssertionError("cli bench measured nothing on the card")
    eng = lines["engines"]
    bad = {k: v["parity"] for k, v in eng["engines"].items()
           if v["parity"].startswith(("ERROR", "MISMATCH"))
           or (v["parity"].startswith("skipped") and k != "native_cpp")}
    if bad or eng["value"] != eng["engines_total"]:
        raise AssertionError(f"engines bench: {eng['value']} of "
                             f"{eng['engines_total']} exact; {bad}")
    scale = lines["scale"]
    got30 = (scale["pairs_over_threshold"], scale["cross_amr_pairs"])
    want = (want30["pairs_over_threshold"], want30["pairs_after_merge"])
    if scale["n_proteins"] != N_SCALE or got30 != want:
        raise AssertionError(f"scale bench (pairs over threshold, cross "
                             f"pairs) {got30} != the oracle's {want}")
    if not scale["oracle_checked_pairs"] > 0:
        raise AssertionError("scale bench checked no pair")
    if scale["kernels"] != {"K1": 0, "K2": steps30}:
        raise AssertionError(f"scale bench kernels {scale['kernels']}, "
                             f"expected K2 {steps30} a sweep and no K1")
    print(f"benches phase: headline {head['value']} pairs/s "
          f"(sweep {head['sweep_seconds']} s, K1 {head['kernels']['K1']} a "
          f"sweep), engines {eng['value']:.0f}/{eng['engines_total']} exact, "
          f"scale {scale['value']} pairs/s (sweep {scale['sweep_seconds']} "
          f"s, oracle gate {scale['oracle_checked_pairs']} pairs)",
          flush=True)
    return {"headline": head, "engines": eng, "scale": scale}


# -- phase 14: more benches ---------------------------------------------------

def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def more_benches_phase(lines, want10, pairs10, steps30, n_pairs30, labels30,
                       agg10):
    """The port's query, cluster and pod benches (docstring, phase 14),
    each held to the oracles of phases 2, 8 and 9. Returns their lines."""
    import numpy as np

    # (a) serving on the 10,619 corpus, with the stream server
    q = lines["query"]
    _check(q["parity"].startswith("host-exact")
           and q["max_sustained_qps"] > 0 and q["device"] != "cpu",
           f"query bench: parity {q['parity']!r}, "
           f"{q['max_sustained_qps']} queries/s on {q['device']}")
    _check(q["kernels"] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0},
           f"query bench launched {q['kernels']}")
    _check(q["stream_mode"]["parity"].startswith("host-exact"),
           f"query bench stream point: {q['stream_mode']['parity']}")
    _check("error" not in q["mesh_virtual_cpu"],
           f"query bench CPU mesh probe: {q['mesh_virtual_cpu']}")

    # (b) clustering: components at 30k, agglomerative at 10,619, tree
    c = lines["cluster"]
    _, counts = np.unique(labels30, return_counts=True)
    got = (c["components_pairs"], c["components_clusters"],
           c["components_largest"])
    want = (n_pairs30, int(counts.shape[0]), int(counts.max()))
    _check(got == want, f"cluster bench components (pairs, clusters, "
                        f"largest) {got} != phases 2 and 9's {want}")
    _check(c["kernels"] == {"K1": 0, "K2": steps30},
           f"cluster bench kernels {c['kernels']}, expected K2 {steps30} "
           "a scan and no K1")
    got = (c["agg_rounds"], c["agg_merges"], c["agg_clusters"])
    want = (agg10["rounds"], agg10["merges"], agg10["clusters"])
    _check(got == want, f"cluster bench agglomerative (rounds, merges, "
                        f"clusters) {got} != phase 8's {want}")
    _check("agg_reference_gate" in c and "tree_gates" in c
           and c["tree_n"] == 5000, "cluster bench skipped a gate")

    # (c) the pod bench at 10,619: flat, 2-D 1x1, one NCCL rank
    top = int(pairs10[:, 2].max())
    pods = {}
    for label in ("flat", "1x1", "nccl"):
        pod = lines[f"pod {label}"]
        _check(pod["counters"] == want10
               and (pod["extracted_pairs"], pod["extracted_max"]) == (
                   len(pairs10), top),
               f"pod bench {label}: counters {pod['counters']}, "
               f"{pod['extracted_pairs']} pairs (max "
               f"{pod['extracted_max']}) != the oracle's {want10}, "
               f"{len(pairs10)} pairs (max {top})")
        _check(pod["kernels"] == {"K1": 7, "K2": 0},
               f"pod bench {label} kernels {pod['kernels']}, expected K1 7 "
               "a sweep")
        # at D = 1 the bench's one-card rate is its own, so efficiency
        # reads 1.0 by construction: a check that the field is there
        _check(pod["devices"] == 1 and "scaling_efficiency" in pod,
               f"pod bench {label}: D {pod['devices']}, no efficiency")
        pods[label] = pod
    print(f"more benches phase: query {q['max_sustained_qps']} queries/s "
          f"(batch 1 {q['single_query_latency_ms']} ms, stream warm "
          f"{q['stream_mode']['warm_seconds']} s); cluster components "
          f"{c['value']} proteins/s (K2 {c['kernels']['K2']}), "
          f"agglomerative {c['agg_seconds']} s, tree {c['tree_seconds']} s; "
          f"pod " + ", ".join(f"{k} {v['value']} pairs/s/chip (sweep "
                               f"{v['sweep_seconds']} s)"
                               for k, v in pods.items()), flush=True)
    return {"query": q, "cluster": c, "pod": pods}


# -- phase 15: the dry run ---------------------------------------------------

# the root dry run's figures at four devices (__graft_entry__.py's line)
DRYRUN_D = 4
DRYRUN_FIGURES = {"stats_sum": 622733, "pairs": 36690,
                  "stream_mesh_pairs": 36690, "docfreq_nnz": 896,
                  "clusters": 496, "kaxis_pairs": 176}


def dryrun_phase(dev, smi) -> dict:
    """``dryrun.entry()`` against its plain version and
    ``dryrun.dryrun_multichip(4)`` on four distinct cards, or on four
    shards of the one card (docstring, phase 15). Returns the entry's
    error and K2 launches, and the dry run's launches."""
    import torch

    from uniprot_kmer_based_clustering_tpu_torch import dryrun

    t_phase = time.perf_counter()
    fn, args = dryrun.entry(device=dev)
    fns = reset_counters()
    rs, bh = fn(*args)
    entry_launches = fns["K2"].launches
    plain_rs, plain_bh = fn(*[a.cpu() for a in args])
    err = max(max_abs_err(rs.cpu(), plain_rs), max_abs_err(bh.cpu(), plain_bh))
    print(f"entry(): one strip of 256 rows, K2 launches {entry_launches}, "
          f"row_stats {tuple(rs.shape)} and block_hits {tuple(bh.shape)} "
          f"against the plain version: max_abs_err {err} (tolerance {TOL})",
          flush=True)
    _check(err <= TOL and {k: f.launches for k, f in fns.items()} == {
        "K1": 0, "K2": 1, "K3": 0, "K4": 0},
        "entry(): the kernel disagrees or did not launch once")

    distinct = torch.cuda.device_count() >= DRYRUN_D
    devices = None if distinct else [dev] * DRYRUN_D
    where = ("four distinct cards" if distinct
             else "four shards of the one card")
    print(f"dry run on {where} ({smi})", flush=True)
    fns = reset_counters()
    t0 = time.perf_counter()
    res = dryrun.dryrun_multichip(DRYRUN_D, devices=devices)
    secs = time.perf_counter() - t0
    launches = {k: f.launches for k, f in fns.items()}
    got = {k: res[k] for k in DRYRUN_FIGURES}
    print(f"dry run: {secs:.3f} s, launches {launches}, "
          f"{res['distinct_devices']} distinct card(s), figures {got}",
          flush=True)
    _check(got == DRYRUN_FIGURES,
           f"dry run figures {got} != the root dry run's {DRYRUN_FIGURES}")
    _check(launches["K1"] > 0 and launches["K2"] > 0,
           f"dry run launches {launches}: K1 and K2 must both launch")
    _check(res["distinct_devices"] == (DRYRUN_D if distinct else 1),
           f"dry run on {res['distinct_devices']} distinct cards")
    print(f"dry-run phase: {time.perf_counter() - t_phase:.3f} s",
          flush=True)
    return {"entry_err": err, "entry_launches": entry_launches,
            "launches": launches, "seconds": secs}


RUN_TOKEN = "UKC_CHIP_SMOKE_RUN"  # environment mark of this run's processes


def _stop_resource_tracker() -> None:
    """Stop the resource tracker that a spawn pool starts: closing its pipe
    ends it (it ignores SIGTERM), and it is reaped here rather than left
    to exit after this script does."""
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    with tracker._lock:
        if tracker._fd is not None:
            os.close(tracker._fd)
            tracker._fd = None
        if tracker._pid is not None:
            os.waitpid(tracker._pid, 0)
            tracker._pid = None


def _marked_pids() -> list:
    """Live processes other than this one whose environment carries this
    run's ``RUN_TOKEN``: what the run started, at any depth."""
    mark = f"{RUN_TOKEN}={os.environ[RUN_TOKEN]}".encode()
    pids = []
    for name in os.listdir("/proc"):
        if not name.isdigit() or int(name) == os.getpid():
            continue
        try:
            with open(f"/proc/{name}/environ", "rb") as f:
                if mark in f.read().split(b"\0"):
                    pids.append(int(name))
        except OSError:
            continue
    return pids


def stop_leftovers(wait_s: float = 10.0) -> None:
    """Stop every process this run started that is still alive, naming
    each on stderr, and reap this script's children."""
    _stop_resource_tracker()
    pids = _marked_pids()
    for pid in pids:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
            os.kill(pid, signal.SIGKILL)
        except OSError:
            continue
        print(f"stopped a leftover process {pid}: {cmd[:300]}",
              file=sys.stderr, flush=True)
    deadline = time.monotonic() + wait_s
    while True:
        try:
            if os.waitpid(-1, os.WNOHANG)[0] != 0:
                continue
        except ChildProcessError:
            pass
        if not _marked_pids() or time.monotonic() > deadline:
            return
        time.sleep(0.05)


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, PKG)):
        print(f"chip_smoke.py must run from a checkout holding {PKG}/",
              file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("no CUDA GPU visible to torch", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--dist-worker"]:
        return _dist_worker(json.loads(sys.argv[2]))
    os.environ[RUN_TOKEN] = f"{os.getpid()}.{time.time_ns()}"
    try:
        return smoke()
    finally:
        stop_leftovers()


def smoke() -> int:
    """Phases 1-15 (docstring); raises on the first failure."""
    import torch

    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    clocks = nvidia_smi_line("name,power.limit,clocks.max.sm")
    print(clocks, flush=True)
    sm_mhz = float(clocks.rsplit(",", 1)[1].split()[0])
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
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                print("  ptxas:", line.strip(), flush=True)

    err = kernel_phase(dev, stats)
    tmp = tempfile.mkdtemp(prefix="ukc_chip_smoke_")
    try:
        state10, pairs10, state30, pairs30, launches, run30 = (
            pipeline_phase(dev, tmp))
        k4 = k4_phase(dev, state10, sm_mhz)
        k2 = k2_phase(dev, state30)
        t = timing_phase(dev, state10, pairs10, stats)
        scan = scan_timing_phase(dev, state30, pairs30)
        st = stream_phase(dev, tmp, state30, pairs30, run30,
                          scan["sweep_s"])
        q_launches = query_phase(dev, tmp, state10, pairs10, state30)
        i_launches = index_phase(dev, tmp, state10, pairs10,
                                 run30["want10"], run30["ns10"])
        k3 = k3_phase(dev, state10, state30, sm_mhz)
        post = post_phase(dev, tmp, state10, pairs10, run30["want10"],
                          run30["ns10"], state30, pairs30)
        mesh = mesh_phase(dev, tmp, state10, pairs10, run30, state30,
                          pairs30, scan["sweep_s"], smi)
        lay = layouts_phase(dev, tmp, state10, pairs10, run30, state30,
                            pairs30, scan["sweep_s"], mesh, smi)
        smesh = stream_mesh_phase(dev, tmp, state10, pairs10, run30, state30,
                                  pairs30, scan["sweep_s"], st["onepass_s"],
                                  mesh["labels30"], smi)
        dph = distributed_phase(
            dev, tmp, state10, pairs10,
            dict(fasta30=run30["fasta"], fasta10=run30["fasta10"],
                 want30=run30["want"], want10=run30["want10"],
                 n_pad30=state30[2].n_pad, single30=run30["single30"],
                 stream_steps=smesh["launches"]["pipeline"]),
            pairs30, mesh["labels30"],
            {"single 30k": run30["cli30_s"],
             "flat": mesh["runs"]["auto"]["wall"],
             "2d": lay["runs"]["2d auto"]["wall"],
             "stream": smesh["mesh_s"]["pipeline"]}, smi)
        lines = bench_runs(smi)
        bench = benches_phase(lines, run30["want10"], run30["want"],
                              launches["K2"])
        more = more_benches_phase(lines, run30["want10"], pairs10,
                                  launches["K2"], len(pairs30),
                                  mesh["labels30"], post["agg10"])
        dry = dryrun_phase(dev, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "uniprot_kmer_based_clustering_tpu")]
    if loaded:
        raise AssertionError(f"the port loaded {loaded[:5]}")

    replaces = "uniprot_kmer_based_clustering_tpu/ops/"
    kernels = [
        {
            "name": "stats_from_counts",
            "route": "cuda",
            "source": f"{PKG}/csrc/stats_epilogue.cu",
            "replaces": replaces + "stats_pallas.py:275",
            "launches": launches["K1"],
            "max_abs_err": max(err, t["err"], mesh["k1"]["err"],
                               mesh["k1_strip"]["err"], lay["k1_2d"]["err"],
                               lay["k1_k"]["err"]),
            "ms": t["ms"],
            "call_ms": t["call_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes",
            "append_ms": t["append"]["ms"],
            "append_call_ms": t["append"]["call_ms"],
            "append_plain_ms": t["append"]["plain_ms"],
            "append_bound_ms": t["append"]["bound_ms"],
            "library_ms": None,
            "query_launches": q_launches["K1"],
            "device_index_launches": i_launches["K1"],
            "post_library_launches": POST_LAUNCHES["K1"],
            "ring_launches": {k: mesh["launches"][k]
                              for k in ("sweep", "extraction", "fused")},
            "ring_max_abs_err": max(mesh["k1"]["err"],
                                    mesh["k1_strip"]["err"]),
            "ring_ms": mesh["k1"]["ms"],
            "ring_call_ms": mesh["k1"]["call_ms"],
            "ring_plain_ms": mesh["k1"]["plain_ms"],
            "ring_bound_ms": mesh["k1"]["bound_ms"],
            "layout_launches": lay["launches"],
            "ring2d_ms": lay["k1_2d"]["ms"],
            "ring2d_plain_ms": lay["k1_2d"]["plain_ms"],
            "ring2d_bound_ms": lay["k1_2d"]["bound_ms"],
            "kaxis_ms": lay["k1_k"]["ms"],
            "kaxis_plain_ms": lay["k1_k"]["plain_ms"],
            "kaxis_bound_ms": lay["k1_k"]["bound_ms"],
            "ring_strip_ms": mesh["k1_strip"]["ms"],
            "ring_strip_plain_ms": mesh["k1_strip"]["plain_ms"],
            "ring_strip_bound_ms": mesh["k1_strip"]["bound_ms"],
            "ring_append": {k: {f: v[f] for f in ("survivors", "ms",
                                                  "call_ms", "bound_ms",
                                                  "plain_ms")}
                            for k, v in mesh["appends"].items()},
            "stream_mesh_launches": 0,
            "distributed_launches": {c: v["K1"] for c, v
                                     in dph["launches"].items()},
            "bench_launches": bench["headline"]["kernels"]["K1"],
            "pod_bench_launches": {k: v["kernels"]["K1"]
                                   for k, v in more["pod"].items()},
            "cluster_bench_launches": more["cluster"]["kernels"]["K1"],
            "query_bench_launches": more["query"]["kernels"]["K1"],
            "dryrun_launches": dry["launches"]["K1"],
        },
        {
            "name": "stats_from_counts_traced",
            "route": "cuda",
            "source": f"{PKG}/csrc/stats_epilogue.cu",
            "replaces": replaces + "stats_pallas.py:172",
            "launches": launches["K2"],
            "stream_launches": st["launches"],
            "max_abs_err": max(k2["err"], st["err"], dry["entry_err"]),
            "ms": k2["ms"],
            "call_ms": k2["call_ms"],
            "plain_ms": k2["plain_ms"],
            "bound_ms": k2["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "query_launches": q_launches["K2"],
            "device_index_launches": i_launches["K2"],
            "post_library_launches": POST_LAUNCHES["K2"],
            "ring_launches": 0,
            "layout_launches": 0,
            "stream_mesh_launches": smesh["launches"],
            "distributed_launches": {c: v["K2"] for c, v
                                     in dph["launches"].items()},
            "bench_launches": bench["scale"]["kernels"]["K2"],
            "pod_bench_launches": {k: v["kernels"]["K2"]
                                   for k, v in more["pod"].items()},
            "cluster_bench_launches": more["cluster"]["kernels"]["K2"],
            "query_bench_launches": more["query"]["kernels"]["K2"],
            "entry_launches": dry["entry_launches"],
            "dryrun_launches": dry["launches"]["K2"],
        },
        {
            "name": "sweep_tri_mxu",
            "route": "cuda",
            "source": f"{PKG}/csrc/tri_mxu.cu",
            "replaces": replaces + "tri_mxu.py:136",
            "launches": k3["launches"],
            "max_abs_err": k3["err"],
            "ms": k3["ms"],
            "call_ms": k3["call_ms"],
            "plain_ms": k3["plain_ms"],
            "bound_ms": k3["bound_ms"],
            "bound_by": "operations",
            "library_ms": None,
            "query_launches": q_launches["K3"],
            "dryrun_launches": dry["launches"]["K3"],
            "device_index_launches": i_launches["K3"],
            "post_library_launches": POST_LAUNCHES["K3"],
            "ring_launches": 0,
            "layout_launches": 0,
            "stream_mesh_launches": 0,
        },
        {
            "name": "popcount_sweep",
            "route": "cuda",
            "source": f"{PKG}/csrc/popcount_sweep.cu",
            "replaces": replaces + "popcount.py:189",
            "launches": launches["K4"],
            "max_abs_err": k4["err"],
            "ms": k4["ms"],
            "call_ms": k4["call_ms"],
            "plain_ms": k4["plain_ms"],
            "bound_ms": k4["bound_ms"],
            "bound_by": "operations",
            "library_ms": None,
            "query_launches": q_launches["K4"],
            "dryrun_launches": dry["launches"]["K4"],
            "device_index_launches": i_launches["K4"],
            "post_library_launches": POST_LAUNCHES["K4"],
            "ring_launches": 0,
            "layout_launches": 0,
            "stream_mesh_launches": 0,
        },
    ]
    print(f"chip_smoke.py total {time.perf_counter() - t_start:.3f} s",
          flush=True)
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
