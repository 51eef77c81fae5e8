"""Pairwise similarity sweep, exact pair extraction and query serving."""

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
