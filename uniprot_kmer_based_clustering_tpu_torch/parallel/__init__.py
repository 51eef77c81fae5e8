"""Multi-device sweeps over a mesh of torch devices (the JAX package's
``parallel/``): the flat row ring (``--devices N``), the 2-D (hosts ×
chips) ring (``--mesh-shape HxC``), the k-axis layout
(``--shard-axis kmers``) and the out-of-core sweep on a flat mesh
(``stream_mesh.py``: ``--devices N --engine stream --stream-source
csr``). The JAX package's memoised ``make_ring_*`` and ``make_kaxis_*``
closures have no counterpart: nothing here is compiled ahead. Every
mesh also spans several processes (``--distributed``): after
:func:`init_distributed` each rank runs the same program on its own
shards, the collectives cross ranks through ``torch.distributed``, and
every rank returns the same result."""

from uniprot_kmer_based_clustering_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    init_distributed,
    make_mesh,
    make_mesh_2d,
    mesh_layout,
    pad_for_mesh,
)
from uniprot_kmer_based_clustering_tpu_torch.parallel.sharded import (  # noqa: F401
    count_kaxis_strips,
    count_substeps,
    count_substeps_2d,
    doc_freq_psum,
    kaxis_strips,
    ring_schedule,
    ring_schedule_2d,
    sharded_extract_pairs,
    sharded_pairwise_fused,
    sharded_pairwise_similarity,
    sharded_pairwise_similarity_2d,
    sharded_pairwise_similarity_kaxis,
    stage_mesh_inputs,
    stage_mesh_inputs_csr,
)
from uniprot_kmer_based_clustering_tpu_torch.parallel.stream_mesh import (  # noqa: F401
    sweep_extract_stream_mesh,
)
