"""The benchmark of uniprot_kmer_based_clustering_tpu_torch on the card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` once, from the root of a checkout,
and prints as its last line of standard output one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each number that
decided ``correct`` beside its limit), and those numbers again as the
last lines of standard error. Without a CUDA card, or with fewer cards
than the cell asks for, it prints no result and exits 2.
"""

import time

T_START = time.perf_counter()

if __name__ == "__main__":
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from harness import main

    sys.exit(main(t_start=T_START))
