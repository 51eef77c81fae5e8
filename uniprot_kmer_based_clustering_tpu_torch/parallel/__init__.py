"""Multi-device sweeps: the flat row ring over a mesh of torch devices
(the JAX package's ``parallel/`` for its default ``--devices N`` layout).
The 2-D ring, the k-axis layout, ``stream_mesh.py`` and the multi-process
``--distributed`` path are not ported yet (ROADMAP queue 1, item 14)."""

from uniprot_kmer_based_clustering_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    pad_for_mesh,
)
from uniprot_kmer_based_clustering_tpu_torch.parallel.sharded import (  # noqa: F401
    count_substeps,
    doc_freq_psum,
    ring_schedule,
    sharded_extract_pairs,
    sharded_pairwise_fused,
    sharded_pairwise_similarity,
    stage_mesh_inputs,
    stage_mesh_inputs_csr,
)
