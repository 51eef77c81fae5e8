"""``peer_gbps.ring4``: the rate of the ring shifts between the cards
(``parallel.mesh.ring_shift``): the bytes a job shifts
(``parallel.sharded.last_trace``'s ``shift_bytes``, the window's last
job; every job of the cell shifts the same) times the jobs, over the
device seconds of the window's peer-to-peer copies summed over the
cards, in GB/s. The gathers onto the first card are peer copies too
(under 1 MB a job beside the shifts' hundreds), so the rate is a little
low. A checkout whose port keeps no such count, or a run with no peer
copy (one card, the CPU), reads None."""

import importlib

SHARDED = "uniprot_kmer_based_clustering_tpu_torch.parallel.sharded"
PEER_COPY = "Memcpy PtoP"


def read(run):
    counts = getattr(importlib.import_module(SHARDED), "last_trace", None)
    if not counts or run.trace is None or not run.jobs:
        return None
    seconds = run.trace.device_seconds(name_has=(PEER_COPY,))
    if seconds <= 0:
        return None
    return counts["shift_bytes"] * run.jobs / seconds / 1e9
