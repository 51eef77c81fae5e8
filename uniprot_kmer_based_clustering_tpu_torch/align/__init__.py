"""Pair alignment: the device Smith-Waterman aligner and diamond."""

from uniprot_kmer_based_clustering_tpu_torch.align.diamond import (  # noqa: F401
    align_pairs,
    diamond_available,
)
from uniprot_kmer_based_clustering_tpu_torch.align.sw_host import (  # noqa: F401
    LocalAlignment,
    sw_align_host,
)
from uniprot_kmer_based_clustering_tpu_torch.align.sw_device import (  # noqa: F401
    sw_ends_and_starts_device,
    sw_scores_device,
)
from uniprot_kmer_based_clustering_tpu_torch.align.sw_pairs import (  # noqa: F401
    align_pairs_sw,
)
