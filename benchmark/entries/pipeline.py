"""Entry ``pipeline``: a whole ``cli run`` on one card.

Set-up only writes the corpus (done by the harness). Each job is
``pipeline.run_pipeline(fasta, config)`` with no checkpoint directory:
FASTA ingest, k-mer encode, document-frequency index, bit packing, the
sweep stage and the configuration's clustering, with the stage seconds
of its ``StageTimers`` (``PipelineResult.timings``). The answer holds
the dendrogram (``merges``) where the clustering makes one.
"""

from __future__ import annotations

from _common import counters


class Entry:
    def __init__(self, fasta: str, config, traffic: dict, device: str):
        from uniprot_kmer_based_clustering_tpu_torch.device import (
            resolve_device,
        )

        self.fasta, self.config = fasta, config
        self.device = resolve_device(device)
        self.setup_timings = {}
        self.cards = [self.device]
        self.device_type = self.device.type

    def job(self) -> dict:
        from uniprot_kmer_based_clustering_tpu_torch.pipeline import (
            run_pipeline,
        )

        r = run_pipeline(self.fasta, self.config, device=self.device)
        out = {"pairs": r.pairwise.pairs, "counters": counters(r.pairwise),
               "labels": r.cluster_labels, "timings": r.timings}
        if r.dendrogram is not None:
            out["merges"] = r.dendrogram
        return out

    def close(self) -> None:
        pass
