"""PyTorch/CUDA port of uniprot_kmer_based_clustering_tpu.

The same pipeline as the JAX package — FASTA → k-mer index → packed
bitsets → pairwise sweep → exact pair list → clusters, alignments and
dumps — on one torch device, or with the sweep on a mesh of devices
(``parallel/``). The host stages are the port's own copies
of the JAX package's numpy/C++ modules; the device stages are PyTorch,
with each TPU kernel rewritten by hand for Hopper. This package imports neither jax nor the
JAX package.

Layout:
  config.py   PipelineConfig (the JAX package's fields and cache keys)
  io/, kmers/, utils/
              host stages: FASTA ingest, the C++ runtime's binding (built
              into build/ at first use), k-mer encode, doc-freq index, bit
              packing, corpus append, BLOSUM weights, timers, checkpoints;
              kmers/index_device.py builds the index and bitset on the
              device instead
  device.py   explicit device selection (no silent CPU fallback)
  state.py    packed words / classes / weights onto a torch device
  csrc/       CUDA C++ kernels, built at first use by ops/_build.py
  ops/        int8-GEMM sweep (bitmul), the statistics epilogues (stats),
              the fused triangle sweep (tri_mxu), the popcount engines
              (popcount), each kernel beside its plain PyTorch version, and
              the out-of-core stream engine (stream)
  parallel/   the mesh engines: the flat row ring (--devices N), the
              2-D ring (--mesh-shape HxC), the k-axis layout
              (--shard-axis kmers) and the out-of-core sweep on a flat
              mesh (stream_mesh.py), with the collectives as device
              copies
  similarity/ sweep + exact pair extraction (two-pass, fused, one-pass);
              query serving (QueryServer); the shared k-mers of pairs
  models/     connected components (host union-find, device label
              propagation), agglomerative rounds, the insertion tree
  align/      batched Smith-Waterman on the device, host traceback,
              diamond orchestration
  io/debug_dump.py  the reference's Rust {:#?} graph dump
  pipeline.py run_pipeline; cli.py the `run` and `query` commands
"""

__version__ = "0.1.0"

from uniprot_kmer_based_clustering_tpu_torch.config import PipelineConfig  # noqa: F401


def cluster_fasta(fasta_path: str, device="cuda", **config_kwargs):
    """One-call library entry point: FASTA → similarity pairs + clusters
    on ``device`` ("cuda" raises when no GPU is visible; "cpu" runs the
    plain versions).

    ``config_kwargs`` are :class:`PipelineConfig` fields. Returns the
    :class:`~uniprot_kmer_based_clustering_tpu_torch.pipeline.PipelineResult`.
    """
    from uniprot_kmer_based_clustering_tpu_torch.pipeline import run_pipeline

    return run_pipeline(
        fasta_path, PipelineConfig(**config_kwargs), device=device
    )
