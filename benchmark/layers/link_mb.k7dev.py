"""``link_mb.k7dev``: the megabytes a pipeline job moves over the host
link for the device index and the sweep: what the build sent and
fetched (``kmers.index_device.last_trace``'s ``host_bytes``) plus what
the sweep stage copied to the card (``similarity.pairwise.last_trace``'s
``upload_bytes``), of the window's last job (every job moves the same).
A checkout whose port keeps no count of the build reads None."""

import importlib

from _spans import pairwise_counts

INDEX_DEVICE = "uniprot_kmer_based_clustering_tpu_torch.kmers.index_device"


def read(run):
    build = getattr(importlib.import_module(INDEX_DEVICE), "last_trace",
                    None)
    sweep = pairwise_counts()
    if not build or sweep is None or not run.jobs:
        return None
    return (build["host_bytes"] + sweep["upload_bytes"]) / 1e6
