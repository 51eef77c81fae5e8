"""The port's benches, counterparts of the repository's JAX bench scripts
(``bench.py``, ``bench_engines.py``, ``bench_scale.py``): ``headline``
(pairs/s, also ``cli bench``), ``engines`` (every engine gated on one
pass) and ``scale`` (the 30k synthetic corpus and beyond). Each runs as
``python -m uniprot_kmer_based_clustering_tpu_torch.benches.<name>`` on
``UKC_BENCH_DEVICE`` (``cuda``) and prints one JSON line; they read the
JAX scripts' environment knobs under the same names."""
