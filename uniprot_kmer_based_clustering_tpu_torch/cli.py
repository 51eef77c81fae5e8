"""Command-line interface of the PyTorch port.

  python -m uniprot_kmer_based_clustering_tpu_torch.cli run <fasta>
      [--device {cuda,cuda:N,cpu}] [--k {5,7}] [--threshold N]
      [--weighted-threshold N] [--sampling {all,random10}] [--seed N]
      [--weighting {none,blosum62}]
      [--cluster {components,tree,agglomerative,none}] [--min-shared N]
      [--engine {auto,mxu,popcount,xla,native,stream}]
      [--extract {auto,two_pass,fused,onepass}] [--extract-k N]
      [--stream-source {host,csr}] [--index-engine {host,device}]
      [--devices N] [--mesh-shape HxC] [--shard-axis {rows,kmers}]
      [--distributed] [--all-pairs] [--align {none,diamond,sw,auto}]
      [--diamond] [--dump-kmers] [--dump-proteins] [--dump-debug]
      [--checkpoint-dir DIR] [--out DIR] [--profile DIR] [--cpu]
      [--verbose]

  python -m uniprot_kmer_based_clustering_tpu_torch.cli query <fasta>
      [--seq AASEQ ...] [--query-fasta FASTA] [--device {cuda,cpu}]
      [--k {5,7}] [--threshold N] [--weighting {none,blosum62}] [--top N]
      [--checkpoint-dir DIR] [--cpu]

``run`` writes to --out, in the same format as the JAX package's ``cli
run``: pairs.tsv, clusters.tsv, stats.json, dendrogram.tsv
(agglomerative), blastp_output.tsv (--align), pair_kmers.tsv and
proteins.tsv (--dump-kmers, --dump-proteins) and graph_debug.txt
(--dump-debug, the reference's stdout Debug dump). The sweep, extraction
and components run on a mesh as in the JAX CLI: ``--devices N`` the flat
row ring over the first N cards (or N CPU shards with --device cpu),
``--mesh-shape HxC`` the 2-D (hosts × chips) ring, ``--shard-axis
kmers`` the k-axis layout over --devices N (all visible cards, or one
CPU shard, by default); ``--devices N --engine stream --stream-source
csr`` runs the out-of-core sweep on the flat mesh.

``--distributed`` runs the same mesh over several processes, one rank a
card, as the JAX CLI runs one process a host::

  torchrun --nproc-per-node N -m uniprot_kmer_based_clustering_tpu_torch.cli \\
      run FASTA --out DIR --distributed

Each rank joins the world from the torchrun environment
(``parallel.init_distributed``: NCCL, or gloo with ``--device cpu``) and
the mesh spans every rank's card (``cuda:LOCAL_RANK``, or the card
``--device cuda:N`` names), or ``--devices N`` shards of the world;
``--mesh-shape HxC`` and ``--shard-axis kmers`` lay it out as in one
process. Every rank runs the whole pipeline; only rank 0 writes files.
``query`` prints the JAX package's ``cli query`` TSV to stdout.

  python -m uniprot_kmer_based_clustering_tpu_torch.cli bench [fasta]

``bench`` runs the port's headline benchmark (``benches.headline``) in
this process and prints its one JSON line; an explicit ``fasta`` wins
over an exported ``UKC_BENCH_FASTA``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import sys


def _device_name(name: str) -> str:
    """argparse type of ``--device``: ``cuda``, ``cuda:N`` or ``cpu``."""
    if name == "cpu" or re.fullmatch(r"cuda(:\d+)?", name):
        return name
    raise argparse.ArgumentTypeError(
        f"invalid device {name!r} (cuda, cuda:N or cpu)"
    )


def _make_mesh(args, device):
    """The mesh of the JAX CLI's flags on ``device``'s type, else None:
    ``--mesh-shape HxC`` the 2-D ring's; ``--shard-axis kmers`` a k-axis
    mesh over ``--devices N`` (every visible card when no count is given;
    one CPU shard on the CPU); ``--devices N`` (N > 1) or
    ``--distributed`` the flat ring's. Under ``--distributed`` the mesh
    spans the world (``parallel.make_mesh``): each rank's card, the one
    ``--device`` names, or ``--devices N`` shards in all. Too few cards
    exit with JAX's message."""
    from uniprot_kmer_based_clustering_tpu_torch.parallel.mesh import (
        make_mesh,
        make_mesh_2d,
    )

    # one process: the first cards of the type; several: each rank's own
    # card unless --device names one
    device = device.type if args.cpu or not args.distributed else args.device
    try:
        if args.mesh_shape:
            if args.shard_axis == "kmers":
                raise SystemExit(
                    "--mesh-shape (2-D ring) and --shard-axis kmers are "
                    "mutually exclusive sharding layouts"
                )
            hc, cc = (int(x) for x in args.mesh_shape.lower().split("x"))
            return make_mesh_2d(hc, cc, device=device)
        if args.shard_axis == "kmers" or args.distributed:
            return make_mesh(args.devices if args.devices >= 1 else None,
                             axis="k" if args.shard_axis == "kmers" else "p",
                             device=device)
        if args.devices > 1:
            return make_mesh(args.devices, device=device)
    except ValueError as e:
        flag = (f"--mesh-shape {args.mesh_shape}" if args.mesh_shape
                else f"--devices {args.devices}")
        raise SystemExit(f"{flag}: {e}") from e
    return None


@contextlib.contextmanager
def _profile(directory, device):
    """Run the body under ``torch.profiler`` (CPU activity, and CUDA
    activity on a CUDA device) and write ``trace.json``, a Chrome trace,
    into ``directory``; no profiler when ``directory`` is None."""
    if not directory:
        yield
        return
    from torch import profiler

    activities = [profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(profiler.ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    with profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(directory, "trace.json"))


def cmd_run(args) -> int:
    import torch

    from uniprot_kmer_based_clustering_tpu_torch.config import PipelineConfig
    from uniprot_kmer_based_clustering_tpu_torch.device import resolve_device
    from uniprot_kmer_based_clustering_tpu_torch.pipeline import run_pipeline

    device = resolve_device("cpu" if args.cpu else args.device)
    rank = 0
    if args.distributed:
        from uniprot_kmer_based_clustering_tpu_torch.parallel.mesh import (
            init_distributed,
            world,
        )

        init_distributed(backend="gloo" if device.type == "cpu" else None)
        rank = world()[0]
    mesh = _make_mesh(args, device)
    if mesh is not None:
        device = mesh.home
    config = PipelineConfig(
        k=args.k,
        threshold=args.threshold,
        weighted_threshold=args.weighted_threshold,
        sampling=args.sampling,
        seed=args.seed,
        cross_amr_only=not args.all_pairs,
        weighting=args.weighting,
        cluster=args.cluster,
        min_shared=args.min_shared,
        engine=args.engine,
        index_engine=args.index_engine,
        extract=args.extract,
        extract_k=args.extract_k,
        stream_source=args.stream_source,
        run_diamond=args.diamond,
    )
    with _profile(args.profile if rank == 0 else None, device):
        result = run_pipeline(
            args.fasta,
            config,
            checkpoint_dir=args.checkpoint_dir,
            device=device,
            echo_timings=args.verbose,
            mesh=mesh,
        )
    if rank != 0:
        # every rank computed the replicated result; only rank 0 writes
        # (ranks on a shared filesystem would race on the same files)
        return 0

    os.makedirs(args.out, exist_ok=True)
    table = result.table
    pairs = result.pairwise.pairs

    with open(os.path.join(args.out, "pairs.tsv"), "w") as f:
        score_col = "weighted_score" if config.weighting != "none" else "shared_kmers"
        f.write(f"protein_i\tprotein_j\tid_i\tid_j\tclass_i\tclass_j\t{score_col}\n")
        for i, j, c in pairs:
            f.write(
                f"{i}\t{j}\t{table.ids[i]}\t{table.ids[j]}\t"
                f"{table.amr_classes[i]}\t{table.amr_classes[j]}\t{c}\n"
            )

    if result.cluster_labels is not None:
        with open(os.path.join(args.out, "clusters.tsv"), "w") as f:
            f.write("protein\tid\tamr_class\tcluster\n")
            for i in range(table.n):
                f.write(
                    f"{i}\t{table.ids[i]}\t{table.amr_classes[i]}\t"
                    f"{result.cluster_labels[i]}\n"
                )

    if result.dendrogram is not None and len(result.dendrogram):
        with open(os.path.join(args.out, "dendrogram.tsv"), "w") as f:
            f.write("winner\tloser\tshared_kmers\n")
            for w, l, c in result.dendrogram:
                f.write(f"{w}\t{l}\t{c}\n")

    stats = {
        "config": {
            k: v for k, v in vars(args).items()
            if k not in ("func", "out", "verbose")
        },
        "parity": result.parity_report(),
        "clusters": result.cluster_summary(),
        "timings_s": {k: round(v, 4) for k, v in result.timings.items()},
        "device": str(device),
        "device_name": (
            torch.cuda.get_device_name(device)
            if device.type == "cuda" else "cpu"
        ),
        "n_devices": mesh.size if mesh is not None else 1,
    }
    with open(os.path.join(args.out, "stats.json"), "w") as f:
        json.dump(stats, f, indent=2)

    _write_dumps(args, result)
    _align(args, config, result, device)
    print(json.dumps(stats["parity"]))
    return 0


def _write_dumps(args, result) -> None:
    """pair_kmers.tsv, proteins.tsv and graph_debug.txt, as the JAX CLI
    writes them."""
    table = result.table
    pairs = result.pairwise.pairs
    if args.dump_kmers and len(pairs):
        from uniprot_kmer_based_clustering_tpu_torch.similarity.kmers_of_pairs import (
            shared_kmer_strings,
        )

        with open(os.path.join(args.out, "pair_kmers.tsv"), "w") as f:
            f.write("protein_i\tprotein_j\tshared_kmers\n")
            for row, kmers in zip(
                pairs,
                shared_kmer_strings(result.index, pairs, result.bitset),
            ):
                f.write(f"{row[0]}\t{row[1]}\t{','.join(kmers)}\n")

    if args.dump_proteins:
        # the reference's protein Debug dump (decoded k-mer strings,
        # src/protein.rs:65-74) + vertex degree (src/graph/vertex.rs:159-166)
        from uniprot_kmer_based_clustering_tpu_torch.similarity.kmers_of_pairs import (
            protein_kmer_strings,
        )

        degree = [0] * table.n
        for i, j, _ in pairs:
            degree[int(i)] += 1
            degree[int(j)] += 1
        with open(os.path.join(args.out, "proteins.tsv"), "w") as f:
            f.write(
                "protein\tid\tamr_class\tlength\tdegree\trepeated_kmers\n"
            )
            for i, kmers in enumerate(
                protein_kmer_strings(result.index, result.bitset)
            ):
                f.write(
                    f"{i}\t{table.ids[i]}\t{table.amr_classes[i]}\t"
                    f"{table.lengths[i]}\t{degree[i]}\t{','.join(kmers)}\n"
                )

    if args.dump_debug:
        # the reference's stdout Debug dump (src/main.rs:235) in the
        # literal Rust {:#?} format; the reference-equivalent full dump
        # is a --threshold 0 run (io/debug_dump.py)
        from uniprot_kmer_based_clustering_tpu_torch.io.debug_dump import (
            rust_debug_dump_to_path,
        )

        rust_debug_dump_to_path(
            os.path.join(args.out, "graph_debug.txt"),
            result.index, pairs, table.n, bitset=result.bitset,
        )


def _align(args, config, result, device) -> None:
    """blastp_output.tsv for ``--align``/``--diamond``, as the JAX CLI
    writes it: ``--diamond`` is ``--align diamond``, ``auto`` takes
    diamond when it is on PATH, and diamond without the binary falls back
    to the device Smith-Waterman aligner."""
    pairs = result.pairwise.pairs
    align_mode = args.align
    if config.run_diamond and align_mode == "none":
        align_mode = "diamond"
    if align_mode == "none" or not len(pairs):
        return
    from uniprot_kmer_based_clustering_tpu_torch.align import (
        align_pairs,
        align_pairs_sw,
        diamond_available,
    )

    tsv = os.path.join(args.out, "blastp_output.tsv")
    if align_mode == "auto":
        align_mode = "diamond" if diamond_available() else "sw"
    if align_mode == "diamond" and not diamond_available():
        print(
            "diamond not found on PATH — falling back to the batched "
            f"Smith-Waterman aligner on {device.type} (--align sw)",
            file=sys.stderr,
        )
        align_mode = "sw"
    if align_mode == "diamond":
        out = align_pairs(result.table, pairs, tsv)
    else:
        out = align_pairs_sw(result.table, pairs, tsv, device=device)
    print(f"wrote {out} ({align_mode})", file=sys.stderr)


def cmd_query(args) -> int:
    """Serve shared-k-mer searches against a corpus index.

    The corpus pipeline runs up to the bitset (resuming from
    --checkpoint-dir when given, written by either package), then the
    queries go through one :class:`QueryServer` on the device; matches
    print as TSV (query, corpus row, id, AMR class, shared k-mers).
    """
    from uniprot_kmer_based_clustering_tpu_torch.config import PipelineConfig
    from uniprot_kmer_based_clustering_tpu_torch.device import resolve_device
    from uniprot_kmer_based_clustering_tpu_torch.pipeline import run_pipeline
    from uniprot_kmer_based_clustering_tpu_torch.similarity.query import (
        query_shared_kmers,
    )

    device = resolve_device("cpu" if args.cpu else args.device)
    seqs = list(args.seq or [])
    names = [f"query{i}" for i in range(len(seqs))]
    if args.query_fasta:
        from uniprot_kmer_based_clustering_tpu_torch.io.fasta import (
            _read_file_bytes,
            parse_fasta_bytes,
        )

        # gzip handled as on the corpus path; latin-1 round-trips any
        # residue byte (those outside the alphabet hit the '*' catch-all)
        qids, qbuf, qoff = parse_fasta_bytes(
            _read_file_bytes(args.query_fasta)
        )
        for qi, qid in enumerate(qids):
            names.append(qid)
            seqs.append(
                qbuf[qoff[qi] : qoff[qi + 1]].tobytes().decode("latin-1")
            )
    if not seqs:
        raise SystemExit("no queries: pass --seq and/or --query-fasta")

    config = PipelineConfig(
        k=args.k, threshold=args.threshold, cluster="none",
        weighting=args.weighting,
    )
    res = run_pipeline(
        args.fasta, config, checkpoint_dir=args.checkpoint_dir,
        device=device, stop_after="pack",
    )
    weights = None
    threshold = args.threshold
    if args.weighting == "blosum62":
        from uniprot_kmer_based_clustering_tpu_torch.pipeline import (
            blosum_weights,
        )

        weights = blosum_weights(res.index, config, res.bitset)
        # the weighted batch sweep's gate scaling (a raw 10 on BLOSUM
        # scores would pass any pair sharing one k-mer)
        threshold = config.effective_weighted_threshold(weights)
    matches = query_shared_kmers(
        res.index, res.bitset, seqs, threshold=threshold, weights=weights,
        top=args.top, device=device,
    )
    print("query\tprotein\tid\tamr_class\tshared_kmers")
    for name, m in zip(names, matches):
        for j, c in m:
            print(
                f"{name}\t{j}\t{res.table.ids[j]}\t"
                f"{res.table.amr_classes[j]}\t{c}"
            )
    return 0


def cmd_bench(args) -> int:
    if args.fasta is not None:
        if not os.path.exists(args.fasta):
            print(f"bench: no such FASTA {args.fasta!r}", file=sys.stderr)
            return 2
        # an explicitly passed path wins over an exported UKC_BENCH_FASTA
        os.environ["UKC_BENCH_FASTA"] = args.fasta
    from uniprot_kmer_based_clustering_tpu_torch.benches import headline

    return headline.main()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="uniprot-kmer-cluster-torch",
        description="protein k-mer clustering on one torch device",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run the full pipeline")
    r.add_argument("fasta")
    r.add_argument("--device", default="cuda", type=_device_name,
                   help="cuda, cuda:N or cpu; cuda raises when no GPU is "
                        "visible; the CPU runs the kernels' plain "
                        "versions. With --distributed, cuda:N pins every "
                        "rank to card N (ranks sharing a card need gloo)")
    r.add_argument("--k", type=int, default=5, choices=(5, 7))
    r.add_argument("--threshold", type=int, default=10,
                   help="keep pairs sharing > threshold k-mers")
    r.add_argument("--weighted-threshold", type=int, default=None)
    r.add_argument("--sampling", default="all", choices=("all", "random10"))
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--weighting", default="none", choices=("none", "blosum62"))
    r.add_argument("--min-shared", type=int, default=1,
                   help="agglomerative merge gate: min shared k-mers "
                        "between cluster signatures")
    r.add_argument("--cluster", default="components",
                   choices=("components", "tree", "agglomerative", "none"),
                   help="agglomerative = batched mutual-argmax signature "
                        "merges on the device; tree = the reference's "
                        "insertion tree on the host")
    r.add_argument("--engine", default="auto",
                   choices=("auto", "mxu", "popcount", "xla", "native",
                            "stream"),
                   help="auto = mxu on CUDA; native (C++ host sweep) on "
                        "the CPU when built, else mxu. popcount and xla "
                        "both run the popcount sweep (its CUDA kernel on "
                        "the card); stream keeps the packed matrix on the "
                        "host and streams row blocks through the device")
    r.add_argument("--extract", default="auto",
                   choices=("auto", "two_pass", "fused", "onepass"),
                   help="fused: the mxu scan sweep keeps its survivors "
                        "(two-pass on the strip schedule); onepass: the "
                        "stream engine's single pass")
    r.add_argument("--extract-k", type=int, default=0,
                   help="fused: candidate capacity per tile; onepass: "
                        "rows of the device pair buffers; 0 = auto")
    r.add_argument("--stream-source", default="host", choices=("host", "csr"),
                   help="--engine stream: upload row blocks from the host "
                        "matrix, or (csr) rebuild them on the device from "
                        "the incidence lists and never build the matrix")
    r.add_argument("--index-engine", default="host",
                   choices=("host", "device"))
    r.add_argument("--all-pairs", action="store_true",
                   help="keep same-AMR-class pairs too")
    r.add_argument("--devices", type=int, default=0,
                   help="N > 1: the sweep on the flat row ring over N "
                        "devices of --device's type (N CPU shards on the "
                        "CPU); more cards than are visible is an error")
    r.add_argument("--shard-axis", default="rows", choices=("rows", "kmers"),
                   help="kmers: shard the bitset's k-mer columns over "
                        "--devices N (all visible cards by default)")
    r.add_argument("--mesh-shape", default=None, metavar="HxC",
                   help="the 2-D (hosts x chips) ring over H*C devices")
    r.add_argument("--distributed", action="store_true",
                   help="join a torch.distributed world (the torchrun "
                        "environment; NCCL, gloo with --device cpu) and "
                        "shard the sweep over every rank's card")
    r.add_argument("--checkpoint-dir", default=None)
    r.add_argument("--out", default="ukc_out")
    r.add_argument("--diamond", action="store_true",
                   help="alias for --align diamond")
    r.add_argument("--align", default="none",
                   choices=("none", "diamond", "sw", "auto"),
                   help="alignment of the surviving pairs: diamond "
                        "subprocesses, sw = batched Smith-Waterman on "
                        "the device, auto = diamond if installed else sw")
    r.add_argument("--dump-kmers", action="store_true",
                   help="write each pair's shared k-mers (decoded)")
    r.add_argument("--dump-proteins", action="store_true",
                   help="write per-protein decoded repeated k-mers and "
                        "pair degree")
    r.add_argument("--dump-debug", action="store_true",
                   help="write graph_debug.txt, the reference's stdout "
                        "graph dump (use --threshold 0 for the full dump)")
    r.add_argument("--cpu", action="store_true",
                   help="the same as --device cpu")
    r.add_argument("--profile", default=None, metavar="DIR",
                   help="run the pipeline under torch.profiler and write "
                        "DIR/trace.json (a Chrome trace)")
    r.add_argument("-v", "--verbose", action="store_true")
    r.set_defaults(func=cmd_run)

    q = sub.add_parser(
        "query",
        help="search new sequences against a corpus index (serving)",
    )
    q.add_argument("fasta", help="corpus FASTA (the standing index)")
    q.add_argument("--seq", action="append", metavar="AASEQ",
                   help="query amino-acid sequence (repeatable)")
    q.add_argument("--query-fasta", default=None,
                   help="FASTA of query sequences")
    q.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda raises when no GPU is visible; the CPU walks "
                        "the corpus's rank-CSR")
    q.add_argument("--k", type=int, default=5, choices=(5, 7))
    q.add_argument("--threshold", type=int, default=10)
    q.add_argument("--weighting", default="none",
                   choices=("none", "blosum62"))
    q.add_argument("--top", type=int, default=None,
                   help="keep only the best N matches per query")
    q.add_argument("--checkpoint-dir", default=None,
                   help="reuse/persist the corpus index (warm startup)")
    q.add_argument("--cpu", action="store_true",
                   help="the same as --device cpu")
    q.set_defaults(func=cmd_query)

    b = sub.add_parser("bench", help="run the headline benchmark")
    b.add_argument("fasta", nargs="?", default=None,
                   help="dataset (default: $UKC_BENCH_FASTA, else the "
                        "synthetic corpus of $UKC_BENCH_N proteins)")
    b.set_defaults(func=cmd_bench)

    args = p.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
