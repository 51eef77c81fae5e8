"""BLOSUM62 weights, stage timers, checkpoints and bench artifacts."""

from uniprot_kmer_based_clustering_tpu_torch.utils.timing import StageTimers  # noqa: F401
from uniprot_kmer_based_clustering_tpu_torch.utils.artifact import write_bench_artifact  # noqa: F401
