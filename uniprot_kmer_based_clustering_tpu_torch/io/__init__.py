"""Host FASTA ingest and the ctypes binding of the C++ host runtime."""

from uniprot_kmer_based_clustering_tpu_torch.io.fasta import (  # noqa: F401
    ProteinTable,
    read_fasta,
)
