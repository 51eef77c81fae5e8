"""The port's benches, counterparts of the repository's JAX bench scripts:
``headline`` (``bench.py``: pairs/s, also ``cli bench``), ``engines``
(``bench_engines.py``: every engine gated on one pass), ``scale``
(``bench_scale.py``: the 30k synthetic corpus and beyond), ``query``
(``bench_query.py``: serving queries/s), ``cluster``
(``bench_cluster.py``: components, agglomerative and the tree at scale)
and ``pod`` (``bench_pod.py``: ring pairs/s/chip and scaling
efficiency). Each runs as ``python -m
uniprot_kmer_based_clustering_tpu_torch.benches.<name>`` on
``UKC_BENCH_DEVICE`` (``cuda``) and prints one JSON line; they read the
JAX scripts' environment knobs under the same names."""
