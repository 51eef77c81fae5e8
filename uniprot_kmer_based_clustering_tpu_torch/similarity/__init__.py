"""Pairwise similarity sweep, exact pair extraction, query serving and
the shared k-mers of pairs."""

from uniprot_kmer_based_clustering_tpu_torch.similarity.kmers_of_pairs import (  # noqa: F401
    protein_kmer_strings,
    shared_kmer_ranks,
    shared_kmer_strings,
)
from uniprot_kmer_based_clustering_tpu_torch.similarity.pairwise import (  # noqa: F401
    PairwiseResult,
    extract_pairs,
    extract_pairs_fused,
    packed_key,
    packed_pair,
    pairs_as_array,
    pairwise_similarity,
    unpack_pairs,
)
from uniprot_kmer_based_clustering_tpu_torch.similarity.query import (  # noqa: F401
    QueryServer,
    pack_query_bitsets,
    query_ranks,
    query_shared_kmers,
)
