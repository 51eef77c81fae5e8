"""Clustering models: connected components, agglomerative rounds and the
reference's insertion tree."""

from uniprot_kmer_based_clustering_tpu_torch.models.agglomerative import (  # noqa: F401
    AgglomerativeResult,
    agglomerative_cluster,
    agglomerative_cluster_device,
)
from uniprot_kmer_based_clustering_tpu_torch.models.components import (  # noqa: F401
    connected_components,
    connected_components_device,
    connected_components_sharded,
)
