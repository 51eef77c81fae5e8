"""Entry ``sweep_stage``: the sweep stage of ``cli run`` on one card.

Set-up builds the protein table, the k-mer index and the packed matrix
with ``run_pipeline(fasta, config, stop_after="pack")``. Each job is the
call that the pipeline's sweep stage makes,
``similarity.pairwise.pairwise_similarity``: the upload of the packed
matrix, the sweep on the schedule the corpus takes (strips with K1,
which appends the survivors, or the block-pair scan with K2) and the
extraction of the pairs (on the strips, one sort and fetch of what K1
appended).
"""

from __future__ import annotations

from _common import counters


class Entry:
    def __init__(self, fasta: str, config, traffic: dict, device: str):
        from uniprot_kmer_based_clustering_tpu_torch.device import (
            resolve_device,
        )
        from uniprot_kmer_based_clustering_tpu_torch.pipeline import (
            run_pipeline,
        )

        self.config = config
        self.device = resolve_device(device)
        pre = run_pipeline(fasta, config, stop_after="pack",
                           device=self.device)
        self.table, self.index, self.bitset = pre.table, pre.index, pre.bitset
        self.setup_timings = pre.timings
        self.cards = [self.device]
        self.device_type = self.device.type

    def job(self) -> dict:
        from uniprot_kmer_based_clustering_tpu_torch.similarity.pairwise import (
            pairwise_similarity,
        )

        r = pairwise_similarity(self.bitset, self.table.amr_class_ids,
                                self.config, index=self.index,
                                device=self.device)
        return {"pairs": r.pairs, "counters": counters(r)}

    def close(self) -> None:
        self.table = self.index = self.bitset = None
