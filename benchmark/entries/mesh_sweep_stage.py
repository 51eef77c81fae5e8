"""Entry ``mesh_sweep_stage``: the sweep stage of ``cli run --devices N``
on a mesh of N cards.

The traffic's ``mesh`` block names the layout and the cards
(``{"layout": "flat", "devices": 4}``); set-up makes the mesh with
``parallel.make_mesh(devices, device=...)`` (N CPU shards on the CPU),
checks that its layout is the one named, and builds the protein table,
the k-mer index and the packed matrix with ``run_pipeline(fasta, config,
stop_after="pack")`` on the mesh's first card. Each job is the call that
the pipeline's sweep stage makes on a mesh,
``pipeline._sharded_similarity(bitset, table, config, mesh, index=)``:
the packed rows staged to all the cards at once, the layout's sweep
(under ``auto`` K1 appends each sub-step's survivors on its card), one
read of the cards' cursors and the pairs gathered on the first card. ``cards`` are all the mesh's cards, so that the peak memory and
the trace cover each.
"""

from __future__ import annotations

from _common import counters


class Entry:
    def __init__(self, fasta: str, config, traffic: dict, device: str):
        from uniprot_kmer_based_clustering_tpu_torch.parallel import (
            make_mesh,
            mesh_layout,
        )
        from uniprot_kmer_based_clustering_tpu_torch.pipeline import (
            run_pipeline,
        )

        want = traffic["mesh"]
        self.config = config
        self.mesh = make_mesh(want["devices"], device=device)
        if mesh_layout(self.mesh) != want["layout"]:
            raise ValueError(f"the mesh {self.mesh} is not a "
                             f"{want['layout']} layout")
        pre = run_pipeline(fasta, config, stop_after="pack",
                           device=self.mesh.home)
        self.table, self.index, self.bitset = pre.table, pre.index, pre.bitset
        self.setup_timings = pre.timings
        self.cards = list(self.mesh.devices)
        self.device_type = self.mesh.home.type

    def job(self) -> dict:
        from uniprot_kmer_based_clustering_tpu_torch.pipeline import (
            _sharded_similarity,
        )

        r = _sharded_similarity(self.bitset, self.table, self.config,
                                self.mesh, index=self.index)
        return {"pairs": r.pairs, "counters": counters(r)}

    def close(self) -> None:
        self.table = self.index = self.bitset = self.mesh = None
