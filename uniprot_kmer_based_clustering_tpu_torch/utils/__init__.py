"""BLOSUM62 weights, stage timers and checkpoints."""

from uniprot_kmer_based_clustering_tpu_torch.utils.timing import StageTimers  # noqa: F401
