"""Device sweep engines and their kernels (PyTorch + CUDA)."""

from uniprot_kmer_based_clustering_tpu_torch.ops.popcount import (  # noqa: F401
    ROW_STAT_NAMES,
    pairwise_counts_xla,
    sweep,
    sweep_pallas,
    sweep_xla,
    upper_triangle_tiles,
)
from uniprot_kmer_based_clustering_tpu_torch.ops.bitmul import (  # noqa: F401
    sweep_mxu,
    sweep_mxu_async,
)
